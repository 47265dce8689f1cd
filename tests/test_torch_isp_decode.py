"""The port's dense-strip decode partial (repro_torch.kernels.isp_decode and
ops.decode_partial) against the JAX reference on the same numpy inputs:
the Pallas kernel in interpret mode for the shared-track layout (the cases
of test_kernels.py::test_pallas_decode_partial) and the jnp oracle
``decode_partial_masked`` for the serve engine's per-slot ring layout.

Tolerances: float32 5e-6 (both sides accumulate in fp32, in another
order); bfloat16 inputs are identical on both sides and the partials are
fp32, so 2e-2 covers the reference kernel's own bf16 tolerance.  The CUDA
kernel runs only on the card, where ``chip_smoke.py`` holds it against
this plain path."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import decode_attention as j_da
from repro.kernels import isp_decode as j_isp
from repro.kernels import ref as j_ref
from repro_torch.core import decode_attention as t_da
from repro_torch.kernels import build as t_build
from repro_torch.kernels import isp_decode as t_isp
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref

TOL = {"float32": dict(atol=5e-6, rtol=5e-6),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}


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


def _ring_tracks(B: int, S: int, cur: np.ndarray,
                 empty: tuple = ()) -> np.ndarray:
    """Per-slot ring tracks (B, S): slot b holds positions
    max(0, cur[b] - S + 1) .. cur[b] at row pos % S, -1 elsewhere; slots in
    ``empty`` hold nothing."""
    kpos = np.full((B, S), -1, np.int32)
    for b in range(B):
        if b in empty:
            continue
        for p in range(max(0, int(cur[b]) - S + 1), int(cur[b]) + 1):
            kpos[b, p % S] = p
    return kpos


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 16])
def test_decode_partial_plain_matches_pallas(rng, dtype, window):
    """Shared kpos (S,) and a scalar cur: the Pallas kernel's own layout."""
    B, S, H, Hkv, dh = 2, 70, 8, 4, 16
    (jq, tq), (jk, tk), (jv, tv) = (
        _both(rng.normal(size=s), dtype)
        for s in ((B, H, dh), (B, S, Hkv, dh), (B, S, Hkv, dh)))
    kpos = np.r_[np.arange(50), -np.ones(20)].astype(np.int32)
    got = t_ops.decode_partial(tq, tk, tv, torch.from_numpy(kpos),
                               torch.tensor(49, dtype=torch.int32),
                               window=window)
    want_pallas = j_isp.decode_partial(jq, jk, jv, jnp.asarray(kpos),
                                       jnp.int32(49), window=window,
                                       kv_block=32, interpret=True)
    want_ref = j_ref.decode_partial_masked(jq, jk, jv, jnp.asarray(kpos),
                                           jnp.int32(49), window=window)
    for want in (want_pallas, want_ref):
        for a, b in zip(got, want):
            assert a.dtype == torch.float32
            np.testing.assert_allclose(_np(a), _np(b), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 16])
def test_decode_partial_per_slot_ring_matches_jax(rng, dtype, window):
    """Per-slot ring tracks kpos (B, S) with cur (B,): wrapped rings, a
    slot with fewer keys than the ring, and an empty slot (m = -1e30,
    l = 0, acc = 0)."""
    B, S, H, Hkv, dh = 4, 32, 4, 2, 16
    cur = np.asarray([75, 10, 40, 0], np.int32)
    kpos = _ring_tracks(B, S, cur, empty=(3,))
    (jq, tq), (jk, tk), (jv, tv) = (
        _both(rng.normal(size=s), dtype)
        for s in ((B, H, dh), (B, S, Hkv, dh), (B, S, Hkv, dh)))
    got = t_ops.decode_partial(tq, tk, tv, torch.from_numpy(kpos),
                               torch.from_numpy(cur), window=window)
    want = j_ref.decode_partial_masked(jq, jk, jv, jnp.asarray(kpos),
                                       jnp.asarray(cur), window=window)
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), _np(b), **TOL[dtype])
    assert float(got[0][3].abs().max()) == 0.0
    assert float(got[1][3].abs().max()) == 0.0
    assert bool((got[2][3] == t_ref.NEG_INF).all())


@pytest.mark.parametrize("layout", ["shared", "per_slot"])
def test_decode_attention_matches_jax(rng, layout):
    """core.decode_attention (partial + combine) against the reference's
    local branch, in both position layouts, with a window."""
    B, S, H, Hkv, dh = 3, 24, 4, 2, 16
    (jq, tq), (jk, tk), (jv, tv) = (
        _both(rng.normal(size=s), "float32")
        for s in ((B, H, dh), (B, S, Hkv, dh), (B, S, Hkv, dh)))
    if layout == "shared":
        kpos = _ring_tracks(1, S, np.asarray([30]))[0]
        cur = np.int32(30)
    else:
        cur = np.asarray([30, 5, 23], np.int32)
        kpos = _ring_tracks(B, S, cur)
    got = t_da.decode_attention(tq, tk, tv, torch.from_numpy(kpos),
                                torch.as_tensor(cur), window=9)
    want = j_da.decode_attention(jq, jk, jv, jnp.asarray(kpos),
                                 jnp.asarray(cur), window=9, plan=None)
    assert got.dtype == tq.dtype
    np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])


def test_kernel_wrapper_refuses_cpu_tensors_and_counts_nothing(rng):
    """A CPU tensor reaching ops.decode_partial takes the plain version and
    launches nothing; the kernel wrapper itself refuses it."""
    B, S, H, Hkv, dh = 2, 16, 4, 2, 16
    q = torch.from_numpy(rng.normal(size=(B, H, dh))).float()
    k = torch.from_numpy(rng.normal(size=(B, S, Hkv, dh))).float()
    kpos = torch.arange(S, dtype=torch.int32)
    t_ops.reset_launch_counts()
    got = t_ops.decode_partial(q, k, k, kpos, torch.tensor(9))
    for a, b in zip(got, t_ref.decode_partial_masked(q, k, k, kpos,
                                                     torch.tensor(9))):
        assert torch.equal(a, b)
    assert t_ops.launch_counts() == {n: 0 for n in t_build.KERNELS}
    assert "isp_decode" in t_build.KERNELS
    with pytest.raises(ValueError):
        t_isp.decode_partial(q, k, k, kpos, torch.tensor(9))
