"""The arithmetic of the top-k kernel's tensor-core product, emulated in
plain numpy at the recommender's D = 128: 3xTF32 for an fp32 corpus
(operands split into two tf32 parts, mantissas rounded to 10 bits as
``cvt.rna.tf32.f32`` does, a_lo.b_hi + a_hi.b_lo + a_hi.b_hi summed in
fp32) and the bf16x3 route for a bf16 corpus (the normalised query split
into three bf16 parts, the corpus exact in bf16).  Both stay within 1e-6
of fp64 on unit vectors, far inside the kernel's 1e-5 score tolerance
(``TOPK_ATOL`` in ``chip_smoke.py``); a one-pass TF32 product does not.
On rows of +-1 (norm 8) every part, product and sum is exact, so both
routes give the plain version's scores bit for bit: the exact-tie case
that the card holds with ``torch.equal``.  The kernel itself runs only on
the card, where ``chip_smoke.py`` holds it against the plain version."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import topk_similarity as t_tk

TOPK_ATOL = 1e-5
D = 128


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tf32(x: np.ndarray) -> np.ndarray:
    """Round fp32 to tf32 (10 mantissa bits), to nearest, ties away from
    zero (the magnitude bits round up at half)."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def bf16(x: np.ndarray) -> np.ndarray:
    """Round fp32 to bf16 (to nearest even), back as fp32."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def accumulate(terms) -> np.ndarray:
    """Sum ``terms(d)`` (a list of (Q, N) fp32 products for column d) in
    fp32, column by column, as the MMA accumulator does."""
    acc = None
    for d in range(D):
        for t in terms(d):
            acc = t if acc is None else np.float32(acc + t)
    return acc


def scores(dot: np.ndarray, c: np.ndarray) -> np.ndarray:
    """The kernel's score: dot / max(|c|, 1e-9), |c| summed in fp32."""
    n2 = np.zeros(len(c), np.float32)
    for d in range(D):
        n2 = np.float32(n2 + c[:, d] * c[:, d])
    return dot / np.maximum(np.sqrt(n2), np.float32(1e-9))[None, :]


def three_tf32(qn, c):
    qh, ch = tf32(qn), tf32(c)
    ql, cl = tf32(qn - qh), tf32(c - ch)
    return scores(accumulate(lambda d: [
        np.outer(ql[:, d], ch[:, d]), np.outer(qh[:, d], cl[:, d]),
        np.outer(qh[:, d], ch[:, d])]), c)


def one_tf32(qn, c):
    qh, ch = tf32(qn), tf32(c)
    return scores(accumulate(lambda d: [np.outer(qh[:, d], ch[:, d])]), c)


def three_bf16(qn, c):
    h = bf16(qn)
    m = bf16(qn - h)
    lo = bf16(qn - h - m)
    return scores(accumulate(lambda d: [
        np.outer(lo[:, d], c[:, d]), np.outer(m[:, d], c[:, d]),
        np.outer(h[:, d], c[:, d])]), c)


def _unit(rng, n):
    x = rng.normal(size=(n, D))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _fp64(qn, c):
    q64, c64 = qn.astype(np.float64), c.astype(np.float64)
    return (q64 @ c64.T) / np.linalg.norm(c64, axis=1)[None, :]


@pytest.mark.parametrize("route", ["3xtf32", "bf16x3"])
def test_three_part_products_stay_within_1e6_of_fp64(route):
    rng = np.random.default_rng(11)
    qn, c = _unit(rng, 16), _unit(rng, 400)
    if route == "bf16x3":
        c = bf16(c)                   # the bf16 corpus: exact in bf16
        got = three_bf16(qn, c)
    else:
        got = three_tf32(qn, c)
    err = np.abs(got - _fp64(qn, c)).max()
    assert err < 1e-6, err


def test_one_pass_tf32_misses_the_score_tolerance():
    rng = np.random.default_rng(11)
    qn, c = _unit(rng, 16), _unit(rng, 400)
    err = np.abs(one_tf32(qn, c) - _fp64(qn, c)).max()
    assert err > TOPK_ATOL, err


def sign_rows(rng, n):
    """Rows of 64 entries of +-1 (norm 8): normalising, every tf32 and bf16
    part, every product and every partial sum are exact."""
    x = np.zeros((n, D), np.float32)
    for r in range(n):
        cols = rng.choice(D, 64, replace=False)
        x[r, cols] = rng.choice([-1.0, 1.0], 64)
    return x


@pytest.mark.parametrize("route", ["3xtf32", "bf16x3"])
def test_sign_rows_give_the_plain_scores_bit_for_bit(route):
    rng = np.random.default_rng(5)
    uniq = sign_rows(rng, 40)
    c = np.concatenate([uniq, uniq[::-1], uniq])    # every row three times
    q = np.concatenate([sign_rows(rng, 6), uniq[3:5]])
    qt = torch.from_numpy(q)
    qn = torch.nn.functional.normalize(qt, dim=-1, eps=1e-9).numpy()
    got = (three_tf32 if route == "3xtf32" else three_bf16)(qn, c)
    ct = torch.from_numpy(c)
    if route == "bf16x3":
        ct = ct.to(torch.bfloat16)
    plain = (torch.nn.functional.normalize(qt, dim=-1, eps=1e-9)
             @ torch.nn.functional.normalize(ct.float(), dim=-1,
                                             eps=1e-9).mT).numpy()
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got[:, :40], got[:, 80:])  # repeats tie
    ws, wi = t_tk.topk_similarity_ref(qt, ct, 12)
    assert (np.diff(ws.numpy(), axis=1) == 0).sum() > 8, "too few ties"
