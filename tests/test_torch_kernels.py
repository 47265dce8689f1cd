"""The port's plain attention paths (repro_torch.kernels) against the JAX
reference: its jnp oracles and its Pallas kernels in interpret mode, on the
same numpy inputs.  The CUDA kernels themselves run only on the card and
are held against these plain versions by ``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as j_flash
from repro.kernels import paged_decode as j_paged
from repro.kernels import ref as j_ref
from repro_torch.kernels import build as t_build
from repro_torch.kernels import flash_attention as t_flash
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import paged_decode as t_paged
from repro_torch.kernels import ref as t_ref

# fp32: summation order differs between XLA and PyTorch; bf16 inputs are
# identical in both, so only the fp32 partials' rounding differs
PAGED_TOL = {"float32": dict(atol=5e-6, rtol=5e-6),
             "bfloat16": dict(atol=2e-2, rtol=2e-2)}
FLASH_TOL = {"float32": dict(atol=3e-5, rtol=3e-5),
             "bfloat16": dict(atol=5e-2, rtol=5e-2)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads; one thread keeps
    these tests from crowding timing-sensitive tests on other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(x: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(x, jnp.dtype(dtype))
    t = torch.from_numpy(np.array(j, np.float32)).to(getattr(torch, dtype))
    return j, t


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _random_pool(rng, B, Hkv, dh, P, ps, maxp):
    """The case generator of tests/test_paged_decode.py::_random_pool:
    random non-overlapping page tables with ragged fill levels."""
    kpool = rng.normal(size=(P + 1, ps, Hkv, dh))
    vpool = rng.normal(size=(P + 1, ps, Hkv, dh))
    perm = rng.permutation(P)
    tables, cur, used = [], [], 0
    for _ in range(B):
        n_alloc = int(rng.integers(0, min(maxp, P - used) + 1))
        row = np.full(maxp, -1, np.int32)
        row[:n_alloc] = perm[used: used + n_alloc]
        used += n_alloc
        tables.append(row)
        hi = n_alloc * ps - 1
        cur.append(int(rng.integers(0, hi + 1)) if hi >= 0 else 0)
    return kpool, vpool, np.stack(tables), np.asarray(cur, np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 11])
def test_paged_decode_ref_matches_jax(rng, dtype, window):
    B, H, Hkv, dh, ps, P, maxp = 3, 8, 4, 16, 8, 12, 5
    q = rng.normal(size=(B, H, dh))
    kpool, vpool, pages, cur = _random_pool(rng, B, Hkv, dh, P, ps, maxp)
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype) for a in (q, kpool, vpool))
    jpages, jcur = jnp.asarray(pages), jnp.asarray(cur)
    tpages, tcur = torch.from_numpy(pages), torch.from_numpy(cur)
    got = t_paged.paged_decode_partial_ref(tq, tk, tv, tpages, tcur,
                                           window=window)
    want_ref = j_paged.paged_decode_partial_ref(jq, jk, jv, jpages, jcur,
                                                window=window)
    want_pallas = j_paged.paged_decode_partial(jq, jk, jv, jpages, jcur,
                                               window=window, interpret=True)
    for want in (want_ref, want_pallas):
        for a, b in zip(got, want):
            assert a.dtype == torch.float32
            np.testing.assert_allclose(_np(a), _np(b), **PAGED_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [
    # (B, Sq, Skv, H, Hkv, dh, window, q_offset)
    (2, 64, 64, 4, 2, 16, None, 0),        # GQA g=2
    (1, 100, 100, 4, 4, 8, None, 0),       # Sq not a multiple of the block
    (2, 96, 96, 4, 1, 16, 32, 0),          # sliding window, g=4
    (1, 40, 72, 4, 2, 16, None, 32),       # q_offset
])
def test_flash_plain_matches_jax(rng, dtype, shape):
    B, Sq, Skv, H, Hkv, dh, win, qoff = shape
    (jq, tq), (jk, tk), (jv, tv) = (
        _both(rng.normal(size=s), dtype)
        for s in ((B, Sq, H, dh), (B, Skv, Hkv, dh), (B, Skv, Hkv, dh)))
    got = t_flash.flash_attention_ref(tq, tk, tv, window=win, q_offset=qoff,
                                      q_chunk=32, kv_chunk=32)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    want_ref = j_ref.chunked_attention(jq, jk, jv, window=win, q_offset=qoff,
                                       q_chunk=32, kv_chunk=32)
    want_pallas = j_flash.flash_attention(jq, jk, jv, window=win,
                                          q_offset=qoff, q_block=32,
                                          kv_block=32, interpret=True)
    for want in (want_ref, want_pallas):
        np.testing.assert_allclose(_np(got), _np(want), **FLASH_TOL[dtype])


def test_naive_attention_matches_jax(rng):
    B, S, H, Hkv, dh = 2, 24, 4, 2, 16
    (jq, tq), (jk, tk), (jv, tv) = (
        _both(rng.normal(size=s), "float32")
        for s in ((B, S, H, dh), (B, S, Hkv, dh), (B, S, Hkv, dh)))
    for win in (None, 7):
        np.testing.assert_allclose(
            _np(t_ref.naive_attention(tq, tk, tv, window=win)),
            _np(j_ref.naive_attention(jq, jk, jv, window=win)),
            atol=3e-5, rtol=3e-5)


def test_decode_partial_and_combine_match_jax(rng):
    """Per-slot masked decode partials and their combine, incl. a slot
    with no valid key (m = -1e30, l = 0, output 0 — not NaN)."""
    B, S, H, Hkv, dh = 3, 20, 4, 2, 16
    (jq, tq), (jk, tk), (jv, tv) = (
        _both(rng.normal(size=s), "float32")
        for s in ((B, H, dh), (B, S, Hkv, dh), (B, S, Hkv, dh)))
    kpos = np.where(rng.random((B, S)) < 0.8, np.arange(S)[None], -1)
    kpos[2] = -1
    kpos = kpos.astype(np.int32)
    cur = np.asarray([15, 19, 4], np.int32)
    for win in (None, 6):
        got = t_ref.decode_partial_masked(tq, tk, tv, torch.from_numpy(kpos),
                                          torch.from_numpy(cur), window=win)
        want = j_ref.decode_partial_masked(jq, jk, jv, jnp.asarray(kpos),
                                           jnp.asarray(cur), window=win)
        for a, b in zip(got, want):
            np.testing.assert_allclose(_np(a), _np(b), atol=5e-6, rtol=5e-6)
        assert float(got[1][2].abs().max()) == 0.0
        assert float(got[2][2].max()) == pytest.approx(t_ref.NEG_INF)
        out_t = t_ref.combine_partials(*(x[None] for x in got))
        out_j = j_ref.combine_partials(*(x[None] for x in want))
        np.testing.assert_allclose(_np(out_t), _np(out_j), atol=5e-6,
                                   rtol=5e-6)
        assert torch.isfinite(out_t).all() and float(out_t[2].abs().max()) == 0


def test_dispatch_routes_cpu_tensors_to_plain_paths(rng):
    """A CPU tensor takes the plain version and launches nothing; the
    kernel wrappers refuse anything that is not on a CUDA device."""
    B, H, Hkv, dh, ps, P, maxp = 2, 4, 2, 16, 4, 8, 4
    kpool, vpool, pages, cur = _random_pool(rng, B, Hkv, dh, P, ps, maxp)
    q = torch.from_numpy(rng.normal(size=(B, H, dh))).float()
    kp, vp = (torch.from_numpy(a).float() for a in (kpool, vpool))
    pg, cu = torch.from_numpy(pages), torch.from_numpy(cur)
    t_ops.reset_launch_counts()
    got = t_ops.paged_decode_partial(q, kp, vp, pg, cu)
    want = t_paged.paged_decode_partial_ref(q, kp, vp, pg, cu)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    qf = torch.from_numpy(rng.normal(size=(1, 20, H, dh))).float()
    kf = torch.from_numpy(rng.normal(size=(1, 20, Hkv, dh))).float()
    assert torch.equal(t_ops.flash_attention(qf, kf, kf, q_chunk=8,
                                             kv_chunk=8),
                       t_ref.chunked_attention(qf, kf, kf, q_chunk=8,
                                               kv_chunk=8))
    assert t_ops.launch_counts() == {n: 0 for n in t_build.KERNELS}
    with pytest.raises(ValueError):
        t_paged.paged_decode_partial(q, kp, vp, pg, cu)
    with pytest.raises(ValueError):
        t_flash.flash_attention(qf, kf, kf)
    with pytest.raises(ValueError):
        t_ops.flash_attention(qf.to("meta"), kf.to("meta"), kf.to("meta"))


def test_build_keys_libraries_by_source_and_needs_nvcc(monkeypatch, tmp_path):
    """Each kernel's library name carries a hash of its source and flags;
    a machine without nvcc gets a clear error, not a silent plain path."""
    names = {n: t_build._target(n) for n in t_build.KERNELS}
    assert len(set(names.values())) == len(names)
    assert all(p.parent == t_build.BUILD_DIR and p.suffix == ".so"
               for p in names.values())
    monkeypatch.setattr(t_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        t_build.build()
    assert not (tmp_path / "kernels").exists()
