"""Forward blocked attention: the CUDA kernel (``csrc/flash_attention.cu``)
and its plain PyTorch version.

Port of ``repro/kernels/flash_attention.py``: causal attention with an
optional sliding window, ``q_offset`` and GQA (q head ``h`` reads kv head
``h // g``), online softmax with fp32 accumulation, output in q's dtype.
The plain version is ``ref.chunked_attention`` (the forward of the
reference's chunked path).  The kernel runs bfloat16 on the tensor cores
(``mma.sync``) and float32 on the CUDA cores, so that fp32 keeps fp32
products.

``flash_attention`` launches the kernel and takes CUDA tensors only;
``kernels/ops.py`` sends CPU tensors to the plain version.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

flash_attention_ref = ref.chunked_attention


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None, q_offset: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Launch the CUDA kernel.  q: (B, Sq, H, dh); k/v: (B, Skv, Hkv, dh),
    contiguous CUDA tensors of one dtype (float32 or bfloat16) on an sm_90
    device, dh 64, 128 or 240.  Returns (B, Sq, H, dh) in q's dtype."""
    B, Sq, H, dh = q.shape
    Bk, Skv, Hkv, dhk = k.shape
    build.check_device(q)
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q/k/v must share one dtype of "
                        f"{list(_DTYPES)}, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if v.shape != k.shape or Bk != B or dhk != dh or H % Hkv:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if dh not in (64, 128, 240):
        raise ValueError(f"flash_attention: head dim {dh} not supported by "
                         f"the kernel")
    if window is not None and window <= 0:
        raise ValueError(f"flash_attention: window must be positive, got "
                         f"{window}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"flash_attention: {name} must be contiguous on "
                             f"{q.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must start on a "
                             f"16-byte boundary (the kernel copies 16-byte "
                             f"vectors)")
    scale = dh ** -0.5 if scale is None else scale
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = build.entry("flash_attention")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Sq, Skv, H, Hkv, dh, int(causal),
        -1 if window is None else int(window), int(q_offset), float(scale),
        _DTYPES[q.dtype], stream)
    build.check_status("flash_attention", status)
    return out
