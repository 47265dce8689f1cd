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
only with weights in bfloat16: the kernel multiplies in fp32 and rounds
once, as the Pallas kernel does, where the plain version (a copy of the
reference's ``ref.isp_gather``) multiplies in the table's dtype; they agree
within one bf16 ulp there, and exactly everywhere else.

Port of ``repro/kernels/isp_gather.py::isp_gather_pool`` too: the same
masked gather summed per segment into (num_segments, D) fp32, segments
outside [0, num_segments) dropped (the RecSSD embedding bag).  The kernel
sums with fp32 atomics, in an order that changes from run to run, so it
agrees with the plain version within fp32 rounding of the sums; with
weights in bfloat16 each term may differ by one bf16 ulp as above.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

isp_gather_ref = ref.isp_gather
isp_gather_pool_ref = ref.isp_gather_pool


def _check_table(name: str, table) -> None:
    build.check_device(table)
    if table.dtype not in _DTYPES:
        raise TypeError(f"{name}: table dtype must be one of "
                        f"{list(_DTYPES)}, got {table.dtype}")
    if table.dim() != 2 or not table.is_contiguous():
        raise ValueError(f"{name}: table must be a contiguous (V, D) "
                         f"matrix, got shape {tuple(table.shape)} strides "
                         f"{table.stride()}")


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


def isp_gather(table, indices, *, shard_offset: int = 0, weights=None):
    """Launch the CUDA kernel.  table: (V_loc, D) float32 or bfloat16,
    contiguous, on an sm_90 device; indices: (...) integer global ids;
    weights: optional (...) per-index scale.  Returns (..., D) in the
    table's dtype."""
    _check_table("isp_gather", table)
    v_loc, d = table.shape
    ids = _ids32("isp_gather", "indices", indices, table.device)
    w = _weights32("isp_gather", weights, indices, table.device)
    n = ids.numel()
    out = torch.empty((n, d), dtype=table.dtype, device=table.device)
    if n == 0 or d == 0:
        return out.reshape(tuple(indices.shape) + (d,))
    stream = torch.cuda.current_stream(table.device).cuda_stream
    status = build.entry("isp_gather")(
        table.data_ptr(), ids.data_ptr(), None if w is None else w.data_ptr(),
        out.data_ptr(), n, v_loc, d, int(shard_offset), _DTYPES[table.dtype],
        stream)
    build.check_status("isp_gather", status)
    return out.reshape(tuple(indices.shape) + (d,))


def isp_gather_pool(table, indices, segment_ids, num_segments: int, *,
                    shard_offset: int = 0, weights=None):
    """Launch the CUDA kernel.  table: (V_loc, D) float32 or bfloat16,
    contiguous, on an sm_90 device; indices, segment_ids: (N,) integers;
    weights: optional (N,) per-index scale.  Returns (num_segments, D)
    float32."""
    _check_table("isp_gather_pool", table)
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
    out = torch.zeros((num_segments, d), dtype=torch.float32,
                      device=table.device)
    n = ids.numel()
    if n == 0 or d == 0 or num_segments == 0:
        return out
    stream = torch.cuda.current_stream(table.device).cuda_stream
    status = build.entry("isp_gather_pool")(
        table.data_ptr(), ids.data_ptr(), segs.data_ptr(),
        None if w is None else w.data_ptr(), out.data_ptr(), n, v_loc, d,
        int(shard_offset), int(num_segments), _DTYPES[table.dtype], stream)
    build.check_status("isp_gather_pool", status)
    return out
