"""The split-K plan of the paged-decode kernel, in plain PyTorch, against
the unsplit plain partial and the JAX reference's oracle, on the same
numpy inputs.  Each case cuts the key axis where the kernel's splits can
go wrong: an empty slot, a one-key slot, a length that fills whole spans,
a hole page, a window edge inside a span, and spans with no valid key.
The CUDA kernel itself runs only on the card (``chip_smoke.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import paged_decode as j_paged
from repro_torch.kernels import paged_decode as t_paged
from repro_torch.kernels import ref as t_ref

TOL = dict(atol=1e-5, rtol=1e-5)     # fp32; only the summation order differs
B, H, HKV, DH, PS, MAXP, SPAN = 4, 4, 2, 16, 4, 6, 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads; one thread keeps
    these tests from crowding timing-sensitive tests on other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(lengths, holes=()):
    """Seeded fp32 pool; slot b holds ``lengths[b]`` tokens on its own
    pages (0 = empty slot, cur 0 and no page); ``holes`` are (slot, page)
    entries set to -1."""
    rng = np.random.default_rng(sum(lengths) + 7 * len(holes))
    P = B * MAXP
    q = rng.normal(size=(B, H, DH)).astype(np.float32)
    kpool = rng.normal(size=(P + 1, PS, HKV, DH)).astype(np.float32)
    vpool = rng.normal(size=(P + 1, PS, HKV, DH)).astype(np.float32)
    perm = rng.permutation(P)
    pages = np.full((B, MAXP), -1, np.int32)
    cur = np.zeros(B, np.int32)
    used = 0
    for b, n in enumerate(lengths):
        k = -(-n // PS)
        pages[b, :k] = perm[used:used + k]
        used += k
        cur[b] = max(n - 1, 0)
    for b, lp in holes:
        pages[b, lp] = -1
    return q, kpool, vpool, pages, cur


CASES = {
    # name: (lengths, holes, window)
    "empty_slot": ((0, 5, 13, 24), (), None),
    "one_key_slot": ((1, 9, 1, 17), (), None),
    "exact_span_multiple": ((8, 16, 24, 8), (), None),
    "hole_page": ((24, 21, 10, 7), ((0, 2), (1, 0), (2, 1)), None),
    "window_edge_in_span": ((24, 19, 13, 6), (), 7),
    "window_edge_on_span": ((24, 17, 16, 9), (), 8),
    "empty_span_by_window": ((24, 23, 21, 2), (), 3),
    "empty_span_by_holes": ((20, 16, 12, 24), ((0, 2), (0, 3), (3, 4),
                                               (3, 5)), None),
}


@pytest.mark.parametrize("name", list(CASES))
def test_split_ref_matches_unsplit_and_jax(name):
    lengths, holes, window = CASES[name]
    arrays = _case(lengths, holes)
    t = [torch.from_numpy(a) for a in arrays]
    got = t_paged.paged_decode_partial_split_ref(*t, span=SPAN,
                                                 window=window)
    unsplit = t_paged.paged_decode_partial_ref(*t, window=window)
    jax_ref = j_paged.paged_decode_partial_ref(
        *(jnp.asarray(a) for a in arrays), window=window)
    for want in (unsplit, jax_ref):
        for a, w in zip(got, want):
            assert a.dtype == torch.float32 and tuple(a.shape) == w.shape
            np.testing.assert_allclose(a.numpy(), np.asarray(w), **TOL)
    acc, l, m = got
    assert torch.isfinite(acc).all() and torch.isfinite(l).all()
    for b, n in enumerate(lengths):
        if n == 0:                    # the empty-slot convention
            assert float(acc[b].abs().max()) == 0.0
            assert float(l[b].abs().max()) == 0.0
            assert bool((m[b] == t_ref.NEG_INF).all())


def test_empty_split_partial_leaves_merge_unchanged():
    """A split with no valid key is (acc 0, l 0, m -1e30): merging it in
    changes nothing, and merging only such splits stays empty, with no
    NaN."""
    gen = torch.Generator().manual_seed(0)
    acc = torch.randn(3, H, DH, generator=gen)
    l = torch.rand(3, H, generator=gen) + 0.5
    m = torch.randn(3, H, generator=gen)
    empty = (torch.zeros(1, H, DH), torch.zeros(1, H),
             torch.full((1, H), t_ref.NEG_INF))
    base = t_ref.merge_partials(acc, l, m)
    more = t_ref.merge_partials(*(torch.cat([x, e])
                                  for x, e in zip((acc, l, m), empty)))
    for a, b in zip(more, base):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    none = t_ref.merge_partials(*(e.expand(4, *e.shape[1:]) for e in empty))
    assert float(none[0].abs().max()) == 0.0
    assert float(none[1].abs().max()) == 0.0
    assert bool((none[2] == t_ref.NEG_INF).all())


@pytest.mark.parametrize("shape, serve", [
    # (batch, kv heads, max pages): yi-9b's and gemma3-12b's serve pools,
    # a short table, a one-page table
    ((8, 4, 64), True), ((8, 8, 128), True), ((8, 4, 3), False),
    ((2, 1, 1), False)])
def test_split_plan_fills_the_card_from_shapes(shape, serve):
    """Spans hold at least SPAN_FLOOR pages (or the whole table) and cover
    every page exactly once; there are as many as the floor allows up to
    BLOCKS_PER_SM blocks an SM; the serve pools put at least two blocks on
    each of 132 SMs."""
    batch, kv_heads, maxp = shape
    span, n_split = t_paged.split_plan(batch, kv_heads, maxp, 132)
    assert (n_split - 1) * span < maxp <= n_split * span
    assert span >= min(t_paged.SPAN_FLOOR, maxp)
    target = -(-t_paged.BLOCKS_PER_SM * 132 // (batch * kv_heads))
    assert n_split >= min(target, -(-maxp // t_paged.SPAN_FLOOR))
    if serve:
        assert batch * kv_heads * n_split >= 2 * 132
