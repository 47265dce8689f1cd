"""Masked shard-local row gather of a vocabulary table: the CUDA kernel
(``csrc/isp_gather.cu``) and its plain PyTorch version.

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
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

isp_gather_ref = ref.isp_gather


def isp_gather(table, indices, *, shard_offset: int = 0, weights=None):
    """Launch the CUDA kernel.  table: (V_loc, D) float32 or bfloat16,
    contiguous, on an sm_90 device; indices: (...) integer global ids;
    weights: optional (...) per-index scale.  Returns (..., D) in the
    table's dtype."""
    build.check_device(table)
    if table.dtype not in _DTYPES:
        raise TypeError(f"isp_gather: table dtype must be one of "
                        f"{list(_DTYPES)}, got {table.dtype}")
    if table.dim() != 2 or not table.is_contiguous():
        raise ValueError(f"isp_gather: table must be a contiguous (V, D) "
                         f"matrix, got shape {tuple(table.shape)} strides "
                         f"{table.stride()}")
    if indices.dtype.is_floating_point or indices.dtype == torch.bool:
        raise TypeError(f"isp_gather: indices must be integers, got "
                        f"{indices.dtype}")
    v_loc, d = table.shape
    ids = indices.reshape(-1).to(torch.int32).contiguous()
    w = None
    if weights is not None:
        if weights.shape != indices.shape:
            raise ValueError(f"isp_gather: weights {tuple(weights.shape)} "
                             f"must match indices {tuple(indices.shape)}")
        w = weights.reshape(-1).to(torch.float32).contiguous()
    for name, t in (("indices", ids), ("weights", w)):
        if t is not None and t.device != table.device:
            raise ValueError(f"isp_gather: {name} must be on {table.device}")
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
