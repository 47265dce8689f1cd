"""The block decomposition of the port's pool kernel
(``csrc/isp_gather_pool.cu``, planned by ``isp_gather.pool_plan``),
emulated in plain numpy on the CPU and held against the port's plain
version, the JAX oracle ``ref.isp_gather_pool`` and the Pallas kernel in
interpret mode on the same numpy inputs.

The emulation follows the kernel: the output zero-filled first; contiguous
ranges of ``span`` ids taken by the blocks grid-stride; each range's valid
ids (in the shard, segment in [0, num_segments)) staged in order; each
group of lanes taking an equal contiguous share of them and each lane
``cols`` columns of a row, slab by slab; a run of equal segment ids summed
in fp32 (each row scaled in fp32 first) and added once.  The cases cut
where the plan can go wrong: unsorted segments, runs across range edges, a
range with no valid id, segments -1 and num_segments, segments no id
touches (exactly zero), n not a multiple of the range, D = 40, 64 and 512.

Tolerances: the emulation sums in another order than the oracle (runs,
then atomics), so the two agree within fp32 rounding of sums of a few
terms: atol 1e-5, as tests/test_torch_gather_pool.py holds the plain
version.  With weights in bfloat16 the emulation (like the Pallas kernel
and the CUDA kernel) scales in fp32 where the oracle scales in bf16, so each
term may differ by one bf16 ulp (2**-7 of the pooled absolute terms).  The
CUDA kernel itself runs only on the card (``chip_smoke.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import isp_gather as j_ig
from repro.kernels import ref as j_ref
from repro_torch.kernels import isp_gather as t_ig

ATOL = 1e-5
BF16_ULP = 2.0 ** -7


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads; one thread keeps
    these tests from crowding timing-sensitive tests on other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def emulate_pool(table, idx, seg, nseg, off, w, plan, grid):
    """The kernel's pool on numpy fp32 ``table`` (V_loc, D): returns the
    output, the visits of each (id, lane) and the atomic adds made."""
    v_loc, d = table.shape
    n = len(idx)
    groups = t_ig.POOL_THREADS // plan.group
    out = np.zeros((nseg, d), np.float32)            # 1. the zero-fill
    visits = np.zeros((n, plan.lanes), np.int64)
    adds = 0
    for b in range(grid):
        for r in range(b, plan.ranges, grid):
            i = np.arange(r * plan.span, min(n, (r + 1) * plan.span))
            rows = idx[i].astype(np.int64) - off
            ok = (rows >= 0) & (rows < v_loc) & (seg[i] >= 0) & (seg[i] < nseg)
            staged = i[ok]                           # 2. in order
            m = len(staged)
            per = -(-m // groups)
            for g in range(groups):                  # 3. shares, runs
                share = staged[min(m, g * per):min(m, g * per + per)]
                for sl in range(plan.slabs):
                    lanes = sl * plan.group + np.arange(plan.group)
                    lanes = lanes[lanes < plan.lanes]
                    cols = (lanes[:, None] * plan.cols
                            + np.arange(plan.cols)).ravel()
                    acc, cur = None, -1
                    for j in share:
                        visits[j, lanes] += 1
                        x = table[idx[j] - off, cols]
                        if w is not None:
                            x = x * np.float32(w[j])
                        if seg[j] != cur:
                            if cur >= 0:
                                out[cur, cols] += acc
                                adds += len(lanes)
                            cur, acc = seg[j], np.zeros_like(x)
                        acc = acc + x
                    if cur >= 0:
                        out[cur, cols] += acc
                        adds += len(lanes)
    return out, visits, adds


def _runs(plan, idx, seg, nseg, v_loc, off):
    """Runs of equal segments in every share of every range, counted
    apart from the emulation's loop."""
    groups = t_ig.POOL_THREADS // plan.group
    total = 0
    for r in range(plan.ranges):
        i = np.arange(r * plan.span, min(len(idx), (r + 1) * plan.span))
        rows = idx[i].astype(np.int64) - off
        ok = (rows >= 0) & (rows < v_loc) & (seg[i] >= 0) & (seg[i] < nseg)
        s = seg[i][ok]
        per = -(-len(s) // groups)
        for g in range(groups):
            part = s[g * per:g * per + per]
            total += int(len(part) > 0) + int((part[1:] != part[:-1]).sum())
    return total


def _case(rng, layout, n, d, v_loc, off, nseg):
    """ids and segment ids of one case (see the parametrisation)."""
    idx = (off + rng.integers(0, v_loc, n)).astype(np.int32)
    if layout == "reviews":          # runs of 12, across range edges
        seg = np.repeat(np.arange(-(-n // 12)), 12)[:n].astype(np.int32)
        idx[::9] = off + v_loc + 5                   # other shards
    elif layout == "unsorted":       # one segment's ids in many ranges
        seg = rng.permutation(
            np.repeat(np.arange(-(-n // 5)), 5)[:n]).astype(np.int32)
        idx[1::7] = -1
    else:                            # "bad": holes, dropped segments
        seg = rng.integers(0, nseg - 8, n).astype(np.int32)   # 8 untouched
        idx[:150] = -1                               # ranges with no id
        seg[3::11] = -1
        seg[4::13] = nseg
    return idx, seg


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("layout,n,d,cols,nseg,num_sms", [
    ("reviews", 700, 64, 4, 70, 8),
    ("unsorted", 451, 40, 4, 100, 4),
    ("bad", 333, 512, 4, 40, 4),
    ("bad", 1500, 67, 1, 60, 8),
])
def test_pool_emulation_matches_reference(dtype, weighted, layout, n, d,
                                          cols, nseg, num_sms):
    """The emulated kernel against the plain version, the JAX oracle and
    the Pallas kernel, at every grid from one block to one a range."""
    rng = np.random.default_rng(n + d)
    v_loc, off = 96, 32
    table = np.array(jnp.asarray(rng.normal(size=(v_loc, d)),
                                 jnp.dtype(dtype)), np.float32)
    idx, seg = _case(rng, layout, n, d, v_loc, off, nseg)
    w = rng.normal(size=n).astype(np.float32) if weighted else None
    plan = t_ig.pool_plan(n, d, cols, num_sms)
    assert plan.ranges > 2 and n % plan.span, plan
    tt = torch.from_numpy(table).to(getattr(torch, dtype))
    tw = None if w is None else torch.from_numpy(w)
    plain = t_ig.isp_gather_pool_ref(tt, torch.from_numpy(idx),
                                     torch.from_numpy(seg), nseg,
                                     shard_offset=off, weights=tw).numpy()
    jt = jnp.asarray(table, jnp.dtype(dtype))
    jw = None if w is None else jnp.asarray(w)
    oracle = np.asarray(j_ref.isp_gather_pool(
        jt, jnp.asarray(idx), jnp.asarray(seg), nseg, shard_offset=off,
        weights=jw))
    pallas = np.asarray(j_ig.isp_gather_pool(
        jt, jnp.asarray(idx), jnp.asarray(seg), nseg, shard_offset=off,
        weights=jw, idx_block=128, d_block=min(d, 128), interpret=True))
    mag = np.asarray(j_ref.isp_gather_pool(
        jnp.abs(jt), jnp.asarray(idx), jnp.asarray(seg), nseg,
        shard_offset=off, weights=None if w is None else jnp.abs(jw)))
    slack = BF16_ULP * mag if weighted and dtype == "bfloat16" else 0.0
    valid = ((idx >= off) & (idx < off + v_loc) & (seg >= 0)
             & (seg < nseg))
    untouched = np.setdiff1d(np.arange(nseg), seg[valid])
    assert len(untouched) > 0 and (~valid).sum() > 0
    for grid in sorted({1, 3, plan.ranges}):
        got, visits, adds = emulate_pool(table, idx, seg, nseg, off, w,
                                         plan, grid)
        assert (np.abs(got - plain) <= ATOL + slack).all()
        assert (np.abs(got - oracle) <= ATOL + slack).all()
        np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=0)
        assert not got[untouched].any(), "untouched segments must be 0"
        assert (visits[valid] == 1).all() and not visits[~valid].any()
        assert adds == plan.lanes * _runs(plan, idx, seg, nseg, v_loc, off)


def test_pool_adds_once_a_run():
    """The sentiment layout (reviews of 12 ids) at its path plan: the
    kernel adds about once a review a lane, not once an id; a share's edge
    inside a review costs one add more."""
    n_rev, v = 400, 64
    rng = np.random.default_rng(5)
    idx = rng.integers(0, v, n_rev * 12).astype(np.int32)
    seg = np.repeat(np.arange(n_rev), 12).astype(np.int32)
    table = rng.normal(size=(v, 64)).astype(np.float32)
    plan = t_ig.pool_plan(len(idx), 64, 4, 2)
    groups = t_ig.POOL_THREADS // plan.group
    got, _, adds = emulate_pool(table, idx, seg, n_rev, 0, None, plan,
                                plan.ranges)
    assert n_rev * plan.lanes <= adds <= (n_rev + plan.ranges * groups) \
        * plan.lanes < len(idx) * plan.lanes / 4
    want = table[idx].reshape(n_rev, 12, 64).sum(1)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("n,d,itemsize,ptr,num_sms", [
    (480_000 // 40, 64, 4, 0, 132),   # sentiment, thinned
    (8192, 512, 4, 0, 132),           # one shard of the sharded pool
    (999, 67, 2, 0, 132),             # odd D: the scalar path
    (999, 64, 2, 4, 132),             # bf16 rows 4-byte aligned: scalars
    (77, 1028, 4, 0, 4),              # a row wider than a block: slabs
    (5, 40, 4, 0, 132),               # fewer ids than a range
    (0, 64, 4, 0, 132),               # no ids: the zero-fill alone
])
def test_pool_plan_covers_every_id_and_column_once(n, d, itemsize, ptr,
                                                   num_sms):
    """Every id of every range is staged by exactly one block (and by one
    thread of it), and every column of a row by exactly one lane of every
    group, at several grids; the span is a power of two in
    [POOL_SPAN_MIN, POOL_SPAN_MAX]."""
    cols = t_ig.pool_cols(d, ptr, itemsize)
    assert cols == (4 if d % 4 == 0 and ptr % (4 * itemsize) == 0 else 1)
    plan = t_ig.pool_plan(n, d, cols, num_sms)
    assert plan.cols * plan.lanes == d
    assert t_ig.POOL_SPAN_MIN <= plan.span <= t_ig.POOL_SPAN_MAX
    assert plan.span & (plan.span - 1) == 0
    assert plan.ranges * plan.span >= n > (plan.ranges - 1) * plan.span \
        or n == plan.ranges == 0
    for grid in sorted({1, 7, max(1, plan.ranges)}):
        staged = np.zeros(n, np.int64)
        for b in range(grid):
            for r in range(b, plan.ranges, grid):
                staged[r * plan.span:(r + 1) * plan.span] += 1
        assert (staged == 1).all()
    threads = t_ig.POOL_THREADS          # thread t stages t * per + k
    per = plan.span // threads if plan.span > threads else 1
    pos = (np.arange(threads)[:, None] * per + np.arange(per)).ravel()
    assert np.array_equal(np.sort(pos[pos < plan.span]),
                          np.arange(plan.span))
    cols = np.zeros(d, np.int64)
    for sl in range(plan.slabs):
        for lane in range(plan.group):
            lc = sl * plan.group + lane
            if lc < plan.lanes:
                cols[lc * plan.cols:(lc + 1) * plan.cols] += 1
    assert (cols == 1).all()
    assert plan.group <= t_ig.POOL_THREADS
