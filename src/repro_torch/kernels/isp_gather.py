"""Masked shard-local row gather of a vocabulary table, and its fused
pooling form: the CUDA kernels (``csrc/isp_gather.cu``,
``csrc/isp_gather_pool.cu``) and their plain PyTorch versions.

Port of ``repro/kernels/isp_gather.py::isp_gather``.  For global ids the
gather returns ``table[id - shard_offset]`` where the id falls in this
shard's rows and zeros where it does not, so that summing the shards'
results over the model axis completes the lookup: indexes travel, table
rows do not.

``isp_gather`` launches the kernel and takes CUDA tensors only;
``kernels/ops.py`` sends CPU tensors to ``isp_gather_ref``.  The two differ
only with weights in bfloat16 or float16: the kernel multiplies in fp32
and rounds once, as the Pallas kernel does, where the plain version (a
copy of the reference's ``ref.isp_gather``) multiplies in the table's
dtype; they agree within one ulp of that dtype there, and exactly
everywhere else.  ``shard_rows`` (the reference's plain path's argument)
narrows the shard to its first rows; the kernel takes it as its row
count.

Port of ``repro/kernels/isp_gather.py::isp_gather_pool`` too: the same
masked gather summed per segment into (num_segments, D) fp32, segments
outside [0, num_segments) dropped (the RecSSD embedding bag).  The kernel
sums with fp32 atomics, in an order that changes from run to run, so it
agrees with the plain version within fp32 rounding of the sums; with
weights in a 16-bit dtype each term may differ by one ulp as above.  It
writes every element of its output itself (one device operation a call).

Both launches follow a plan computed here from shapes and the SM count
only (``gather_plan``, ``pool_plan``); the CPU tests sweep both for exact
cover.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import build, ref

isp_gather_ref = ref.isp_gather
isp_gather_pool_ref = ref.isp_gather_pool

# csrc/isp_gather.cu: THREADS, MIN_BLOCKS
GATHER_THREADS = 128
GATHER_BLOCKS_PER_SM = 8
# csrc/isp_gather_pool.cu: THREADS, SPAN_MAX
POOL_THREADS = 256
POOL_SPAN_MAX = 1024
POOL_SPAN_MIN = 64


class GatherPlan(NamedTuple):
    per: int      # elements a unit: 16 // itemsize (vectors) or 1 (scalars)
    units: int    # units a row
    u: int        # units a thread an item
    tiles: int    # items a row; an item is GATHER_THREADS * u units
    grid: int     # blocks, walking the n * tiles items grid-stride


def gather_plan(n: int, d: int, itemsize: int, vec: bool,
                num_sms: int) -> GatherPlan:
    """Launch plan of the gather: the most units a thread (4, 2, 1) that
    still gives every SM an item, so that a decode step's few rows spread
    over many SMs and a prefill's many rows keep 64 bytes a thread in
    flight."""
    per = 16 // itemsize if vec else 1
    units = d // per
    for u in (4, 2, 1):
        tiles = -(-units // (GATHER_THREADS * u))
        if n * tiles >= num_sms:
            break
    return GatherPlan(per, units, u, tiles,
                      max(1, min(n * tiles, GATHER_BLOCKS_PER_SM * num_sms)))


class PoolPlan(NamedTuple):
    cols: int     # columns a lane: 4 (vectors) or 1 (scalars)
    lanes: int    # lanes a row needs, d // cols
    group: int    # lanes a group; POOL_THREADS // group groups a block
    slabs: int    # slabs of group lanes that cover a row
    span: int     # ids a range; a block stages one range at a time
    ranges: int   # ceil(n / span)


def pool_cols(d: int, table_ptr: int, itemsize: int) -> int:
    """Columns a lane of the pool takes: 4 (one 16-byte fp32 or 8-byte
    bf16 load) where rows start four elements aligned, else 1 (the scalar
    path)."""
    return 4 if d % 4 == 0 and table_ptr % (4 * itemsize) == 0 else 1


def pool_plan(n: int, d: int, cols: int, num_sms: int) -> PoolPlan:
    """Launch plan of the pool: a group of lanes spans a row (up to
    POOL_THREADS lanes, slabs beyond), and ranges are as long as gives every
    SM one (a power of two in [POOL_SPAN_MIN, POOL_SPAN_MAX]).  The kernel
    picks its grid: a block a range, or more where the zero-fill needs
    them, never more than fit on the card at once."""
    lanes = d // cols
    group = min(lanes, POOL_THREADS)
    want = -(-n // num_sms)
    span = min(POOL_SPAN_MAX,
               max(POOL_SPAN_MIN, 1 << max(0, want - 1).bit_length()))
    return PoolPlan(cols, lanes, group, -(-lanes // group), span,
                    -(-n // span))


def _num_sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check_table(name: str, table) -> int:
    """Raise unless ``table`` is a contiguous (V, D) matrix of a kernel
    dtype on an sm_90 device; returns the dtype's code."""
    code = build.dtype_code(name, table)
    build.check_device(table)
    if table.dim() != 2 or not table.is_contiguous():
        raise ValueError(f"{name}: table must be a contiguous (V, D) "
                         f"matrix, got shape {tuple(table.shape)} strides "
                         f"{table.stride()}")
    return code


def _ids32(name: str, what: str, t, device):
    """``t`` flattened to contiguous int32 on ``device``."""
    if t.dtype.is_floating_point or t.dtype == torch.bool:
        raise TypeError(f"{name}: {what} must be integers, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name}: {what} must be on {device}")
    return t.reshape(-1).to(torch.int32).contiguous()


def _weights32(name: str, weights, indices, device):
    """Optional per-index weights flattened to contiguous fp32."""
    if weights is None:
        return None
    if weights.shape != indices.shape:
        raise ValueError(f"{name}: weights {tuple(weights.shape)} must match "
                         f"indices {tuple(indices.shape)}")
    if weights.device != device:
        raise ValueError(f"{name}: weights must be on {device}")
    return weights.reshape(-1).to(torch.float32).contiguous()


def isp_gather(table, indices, *, shard_offset: int = 0, weights=None,
               shard_rows=None):
    """Launch the CUDA kernel.  table: (V_loc, D) float32, bfloat16 or
    float16, contiguous, on an sm_90 device; indices: (...) integer global
    ids; weights: optional (...) per-index scale; shard_rows: the shard's
    rows, ``V_loc`` by default (ids at or past ``shard_offset +
    shard_rows`` give zeros).  Returns (..., D) in the table's dtype."""
    code = _check_table("isp_gather", table)
    d = table.shape[1]
    v_loc = ref.shard_rows_of(table, shard_rows)
    ids = _ids32("isp_gather", "indices", indices, table.device)
    w = _weights32("isp_gather", weights, indices, table.device)
    n = ids.numel()
    out = torch.empty((n, d), dtype=table.dtype, device=table.device)
    if n == 0 or d == 0:
        return out.reshape(tuple(indices.shape) + (d,))
    vec = (d * table.element_size()) % 16 == 0 \
        and table.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    plan = gather_plan(n, d, table.element_size(), vec,
                       _num_sms(table.device))
    stream = torch.cuda.current_stream(table.device).cuda_stream
    status = build.entry("isp_gather")(
        table.data_ptr(), ids.data_ptr(), None if w is None else w.data_ptr(),
        out.data_ptr(), n, v_loc, d, int(shard_offset), int(vec), plan.u,
        plan.tiles, plan.grid, code, stream)
    build.check_status("isp_gather", status)
    return out.reshape(tuple(indices.shape) + (d,))


def isp_gather_pool(table, indices, segment_ids, num_segments: int, *,
                    shard_offset: int = 0, weights=None):
    """Launch the CUDA kernel.  table: (V_loc, D) float32, bfloat16 or
    float16, contiguous, on an sm_90 device; indices, segment_ids: (N,)
    integers; weights: optional (N,) per-index scale.  Returns
    (num_segments, D) float32."""
    code = _check_table("isp_gather_pool", table)
    v_loc, d = table.shape
    if segment_ids.shape != indices.shape:
        raise ValueError(f"isp_gather_pool: segment_ids "
                         f"{tuple(segment_ids.shape)} must match indices "
                         f"{tuple(indices.shape)}")
    if num_segments < 0:
        raise ValueError(f"isp_gather_pool: num_segments={num_segments} < 0")
    ids = _ids32("isp_gather_pool", "indices", indices, table.device)
    segs = _ids32("isp_gather_pool", "segment_ids", segment_ids,
                  table.device)
    w = _weights32("isp_gather_pool", weights, indices, table.device)
    # the kernel writes every element, zeros included
    out = torch.empty((num_segments, d), dtype=torch.float32,
                      device=table.device)
    n = ids.numel()
    if d == 0 or num_segments == 0:
        return out
    cols = pool_cols(d, table.data_ptr(), table.element_size()) \
        if out.data_ptr() % 16 == 0 else 1
    plan = pool_plan(n, d, cols, _num_sms(table.device))
    stream = torch.cuda.current_stream(table.device).cuda_stream
    status = build.entry("isp_gather_pool")(
        table.data_ptr(), ids.data_ptr(), segs.data_ptr(),
        None if w is None else w.data_ptr(), out.data_ptr(), n, v_loc, d,
        int(shard_offset), int(num_segments), plan.span, plan.group,
        plan.cols, code, stream)
    build.check_status("isp_gather_pool", status)
    return out
