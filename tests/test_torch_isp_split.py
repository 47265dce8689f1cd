"""The split-K plan of the dense-strip decode kernel (``isp_decode``), in
plain PyTorch, against the unsplit plain partial and the JAX reference on
the same numpy inputs: the Pallas kernel in interpret mode for the shared
track ``kpos (S,)``, the reference's ``decode_partial_masked`` for the
per-slot rings ``kpos (B, S)``.  Each case cuts the strip where the
kernel's spans can go wrong: a window, an empty slot, a span with no valid
row, and wrapped rings whose valid rows cross a span edge.  The CUDA
kernel itself runs only on the card (``chip_smoke.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import isp_decode as j_isp
from repro.kernels import ref as j_ref
from repro_torch.kernels import isp_decode as t_isp
from repro_torch.kernels import paged_decode as t_paged
from repro_torch.kernels import ref as t_ref

TOL = dict(atol=1e-5, rtol=1e-5)     # fp32; only the summation order differs
B, H, HKV, DH, S = 4, 4, 2, 16, 40


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads; one thread keeps
    these tests from crowding timing-sensitive tests on other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(seed: int):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, H, DH)).astype(np.float32),
            rng.normal(size=(B, S, HKV, DH)).astype(np.float32),
            rng.normal(size=(B, S, HKV, DH)).astype(np.float32))


def _ring_tracks(cur, empty=()) -> np.ndarray:
    """Per-slot rings (B, S): slot b holds positions max(0, cur[b] - S + 1)
    .. cur[b] at row pos % S, -1 elsewhere; slots in ``empty`` hold
    nothing."""
    kpos = np.full((len(cur), S), -1, np.int32)
    for b, c in enumerate(cur):
        if b not in empty:
            for p in range(max(0, c - S + 1), c + 1):
                kpos[b, p % S] = p
    return kpos


def _hold(got, wants):
    for want in wants:
        for a, w in zip(got, want):
            assert a.dtype == torch.float32 and tuple(a.shape) == w.shape
            np.testing.assert_allclose(a.numpy(), np.asarray(w), **TOL)
    assert all(torch.isfinite(x).all() for x in got)


@pytest.mark.parametrize("window", [None, 13])
@pytest.mark.parametrize("span", [8, 12])
def test_split_ref_matches_pallas_shared_track(window, span):
    """kpos (S,) with a scalar cur: rows 30..39 empty, so the last span(s)
    hold no valid row (and with the window, the first ones neither)."""
    q, k, v = _qkv(span + (window or 0))
    kpos = np.r_[np.arange(30), -np.ones(10)].astype(np.int32)
    t = [torch.from_numpy(x) for x in (q, k, v, kpos)]
    got = t_isp.decode_partial_split_ref(*t, torch.tensor(29), span=span,
                                         window=window)
    unsplit = t_isp.decode_partial_ref(*t, torch.tensor(29), window=window)
    j = [jnp.asarray(x) for x in (q, k, v, kpos)]
    pallas = j_isp.decode_partial(*j, jnp.int32(29), window=window,
                                  kv_block=16, interpret=True)
    _hold(got, (unsplit, pallas))


RING_CASES = {
    # name: (cur per slot, empty slots, window, span)
    "wrapped_rings_cross_span_edges": ((75, 52, 41, 90), (), None, 16),
    "window_inside_ring": ((75, 52, 41, 90), (), 9, 16),
    "empty_slot": ((75, 0, 41, 33), (1,), None, 16),
    "short_slot_leaves_spans_empty": ((3, 60, 7, 44), (), None, 8),
    "window_empties_whole_spans": ((39, 39, 39, 39), (), 5, 8),
    "span_not_dividing_rows": ((61, 17, 88, 40), (2,), 11, 12),
}


@pytest.mark.parametrize("name", list(RING_CASES))
def test_split_ref_matches_jax_on_rings(name):
    cur, empty, window, span = RING_CASES[name]
    q, k, v = _qkv(len(name))
    kpos = _ring_tracks(cur, empty)
    cur = np.asarray(cur, np.int32)
    t = [torch.from_numpy(x) for x in (q, k, v, kpos, cur)]
    got = t_isp.decode_partial_split_ref(*t, span=span, window=window)
    unsplit = t_isp.decode_partial_ref(*t, window=window)
    jax_ref = j_ref.decode_partial_masked(*(jnp.asarray(x) for x in
                                            (q, k, v, kpos, cur)),
                                          window=window)
    _hold(got, (unsplit, jax_ref))
    acc, l, m = got
    for b in empty:                   # the empty-slot convention, exactly
        assert float(acc[b].abs().max()) == 0.0
        assert float(l[b].abs().max()) == 0.0
        assert bool((m[b] == t_ref.NEG_INF).all())
    if name == "wrapped_rings_cross_span_edges":
        # slot 0 (positions 36..75) wraps at row 75 % 40 = 35, inside a
        # span, and its oldest row 36 sits in the same span
        assert kpos[0, 35] == 75 and kpos[0, 36] == 36
        assert 35 // span == 36 // span


@pytest.mark.parametrize("shape, serve", [
    # (batch, kv heads, rows): gemma3-12b's window rings and yi-9b's strip,
    # a sequence-sharded rank's rows, one slot of one head, a long strip
    # the cap splits, a short strip, one row, no row
    ((8, 8, 1024), True), ((8, 4, 1024), True), ((8, 4, 256), False),
    ((1, 1, 100_000), False), ((8, 8, 200_000), False), ((2, 1, 10), False),
    ((3, 2, 1), False), ((8, 8, 0), False)])
def test_split_plan_covers_the_strip_from_shapes(shape, serve):
    """Spans hold at least ROW_FLOOR rows (or the whole strip) and at most
    SPAN_MAX, and cover every row exactly once; there are as many as the
    floor allows up to BLOCKS_PER_SM blocks an SM; the serve strips put at
    least two blocks on each of 132 SMs."""
    batch, kv_heads, rows = shape
    span, n_split = t_isp.split_plan(batch, kv_heads, rows, 132)
    assert 1 <= span <= t_isp.SPAN_MAX and n_split >= 1
    assert (n_split - 1) * span < max(rows, 1) <= n_split * span
    assert span >= min(t_isp.ROW_FLOOR, max(rows, 1))
    target = -(-t_isp.BLOCKS_PER_SM * 132 // (batch * kv_heads))
    assert n_split >= min(target, -(-rows // t_isp.ROW_FLOOR))
    if serve:
        assert batch * kv_heads * n_split >= 2 * 132


@pytest.mark.parametrize("kernel", ["paged_decode", "isp_decode"])
def test_shared_split_plan_cuts_any_unit_count(kernel):
    """The one plan both split-K decode kernels take (``ref.split_plan``,
    with paged decode's page floor or isp decode's row floor and cap):
    over a sweep of units, slots x kv heads and SM counts its spans cover
    every unit exactly once, hold at least the floor (or every unit) and
    at most the cap, and the kernel's own binding gives the same plan."""
    mod = t_paged if kernel == "paged_decode" else t_isp
    floor, cap = ((t_paged.SPAN_FLOOR, None) if kernel == "paged_decode"
                  else (t_isp.ROW_FLOOR, t_isp.SPAN_MAX))
    for units in [*range(0, 3000, 37), 4096, 65_536, 200_000]:
        for batch, kv_heads in ((1, 1), (8, 1), (8, 4), (8, 8)):
            for sms in (114, 132):
                span, n_split = t_ref.split_plan(
                    batch, kv_heads, units, sms, floor=floor, cap=cap)
                assert (span, n_split) == mod.split_plan(batch, kv_heads,
                                                         units, sms)
                assert (n_split - 1) * span < max(units, 1) <= n_split * span
                assert min(floor, max(units, 1)) <= span
                assert cap is None or span <= cap
