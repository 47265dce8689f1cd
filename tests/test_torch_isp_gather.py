"""The port's ISP row gather (repro_torch.kernels.isp_gather and
ops.isp_gather) against the JAX reference on the same numpy inputs: the
jnp oracle ``ref.isp_gather`` and the Pallas kernel in interpret mode (as
test_kernels.py::test_pallas_gather runs it).

Tolerances: the plain version is a copy of the jnp oracle and agrees with
it exactly.  Against the Pallas kernel it agrees exactly without weights
and in float32; with weights in bfloat16 the Pallas kernel multiplies in
fp32 and rounds once where the oracle multiplies in bf16, so the two
differ by at most one bf16 ulp (2**-7 relative).  The CUDA kernel runs
only on the card, where ``chip_smoke.py`` holds it against this plain
path."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import isp_gather as j_ig
from repro.kernels import ref as j_ref
from repro_torch.kernels import build as t_build
from repro_torch.kernels import isp_gather as t_ig
from repro_torch.kernels import ops as t_ops

EXACT = dict(atol=0, rtol=0)
ONE_BF16_ULP = dict(atol=0, rtol=2.0 ** -7)


def _both(x: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(x, jnp.dtype(dtype))
    t = torch.from_numpy(np.array(j, np.float32)).to(getattr(torch, dtype))
    return j, t


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _ids(rng, n: int, v_loc: int, off: int) -> np.ndarray:
    """Ids below, inside and above the shard [off, off + v_loc), and -1
    pads."""
    ids = rng.integers(0, off + v_loc + 40, n).astype(np.int32)
    ids[::7] = -1
    ids[1::11] = off + v_loc + 3                       # above
    ids[2::13] = max(off - 1, -1)                      # just below
    ids[3::5] = off + rng.integers(0, v_loc, len(ids[3::5]))   # inside
    return ids


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("n,v_loc,d,off,blocks", [
    (300, 64, 40, 0, {}),                      # default blocks (256, 512)
    (300, 48, 40, 96, {}),
    (37, 32, 72, 16, dict(idx_block=8, d_block=16)),
])
def test_plain_gather_matches_reference(rng, dtype, weighted, n, v_loc, d,
                                        off, blocks):
    """n not a multiple of 256, D not a multiple of 512, offsets 0 and > 0,
    ids below, inside and above the shard and -1 pads, with and without
    weights: the plain version against the jnp oracle (exact) and the
    Pallas kernel in interpret mode."""
    jt, tt = _both(rng.normal(size=(v_loc, d)), dtype)
    ids = _ids(rng, n, v_loc, off)
    ids = ids[:, None] if n % 2 else ids.reshape(-1, 2)    # (..., ) ids
    w = rng.normal(size=ids.shape).astype(np.float32) if weighted else None
    jw = None if w is None else jnp.asarray(w)
    tw = None if w is None else torch.from_numpy(w)
    got = t_ops.isp_gather(tt, torch.from_numpy(ids), shard_offset=off,
                           weights=tw)
    assert got.dtype == tt.dtype and got.shape == ids.shape + (d,)
    want = j_ref.isp_gather(jt, jnp.asarray(ids), shard_offset=off,
                            weights=jw)
    np.testing.assert_allclose(_np(got), _np(want), **EXACT)
    pallas = j_ig.isp_gather(jt, jnp.asarray(ids), shard_offset=off,
                             weights=jw, interpret=True, **blocks)
    tol = ONE_BF16_ULP if weighted and dtype == "bfloat16" else EXACT
    np.testing.assert_allclose(_np(got), _np(pallas), **tol)
    out = (ids < off) | (ids >= off + v_loc)
    assert not _np(got)[out].any(), "rows outside the shard must be zero"


def test_shards_sum_to_full_lookup(rng):
    """ISP invariant (test_kernels.py::test_gather_shards_psum_to_full): the
    shards' masked gathers sum to the dense lookup, exactly."""
    V, D, shards = 64, 16, 4
    table = torch.from_numpy(rng.normal(size=(V, D)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, V, (5, 4)).astype(np.int32))
    vloc = V // shards
    got = sum(t_ops.isp_gather(table[i * vloc:(i + 1) * vloc], ids,
                               shard_offset=i * vloc) for i in range(shards))
    assert torch.equal(got, table[ids.long()])


def test_ops_takes_the_plain_version_on_cpu(rng):
    """A CPU tensor takes the plain version and counts no launch; the
    kernel wrapper itself refuses a CPU tensor rather than fall back."""
    table = torch.from_numpy(rng.normal(size=(32, 8)).astype(np.float32))
    ids = torch.tensor([[0, 5, 40, -1]], dtype=torch.int32)
    t_ops.reset_launch_counts()
    got = t_ops.isp_gather(table, ids, shard_offset=0)
    assert torch.equal(got, t_ig.isp_gather_ref(table, ids))
    assert t_ops.launch_counts()["isp_gather"] == 0
    assert "isp_gather" in t_build.KERNELS
    with pytest.raises(ValueError, match="CUDA kernel got a tensor on cpu"):
        t_ig.isp_gather(table, ids)


@pytest.mark.parametrize("n,d,itemsize,vec,num_sms", [
    (8, 3840, 2, True, 132),      # gemma3-12b decode step: 8 rows spread
    (8192, 3840, 2, True, 132),   # gemma3-12b prefill: 4 units a thread
    (1, 3840, 2, True, 132),
    (100, 1048, 2, True, 132),    # 131 units a row: no tile divides it
    (1001, 3841, 2, False, 132),  # unaligned rows: the scalar path
    (37, 72, 4, True, 4),
])
def test_gather_plan_covers_every_unit_once(n, d, itemsize, vec, num_sms):
    """The kernel's grid-stride walk over (row, tile) items, emulated:
    every 16-byte vector (or element, on the scalar path) of every row is
    written by exactly one thread; every SM gets an item unless a thread
    already takes a single unit; the grid stays within
    GATHER_BLOCKS_PER_SM blocks an SM."""
    plan = t_ig.gather_plan(n, d, itemsize, vec, num_sms)
    assert plan.per * plan.units == d
    assert n * plan.tiles >= num_sms or plan.u == 1
    assert plan.grid <= t_ig.GATHER_BLOCKS_PER_SM * num_sms
    threads = t_ig.GATHER_THREADS
    hits = np.zeros((n, plan.units), np.int64)
    items = n * plan.tiles
    lanes = np.arange(threads)
    for b in range(plan.grid):
        it = np.arange(b, items, plan.grid)
        base = (it % plan.tiles) * threads * plan.u
        for k in range(plan.u):
            j = base[:, None] + lanes[None, :] + k * threads
            rows = np.broadcast_to((it // plan.tiles)[:, None], j.shape)
            keep = j < plan.units
            np.add.at(hits, (rows[keep], j[keep]), 1)
    assert (hits == 1).all()
