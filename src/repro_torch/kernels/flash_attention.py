"""Forward blocked attention: the CUDA kernel (``csrc/flash_attention.cu``)
and its plain PyTorch version.

Port of ``repro/kernels/flash_attention.py``: causal attention with an
optional sliding window, ``q_offset`` and GQA (q head ``h`` reads kv head
``h // g``), online softmax with fp32 accumulation, output in q's dtype.
The plain version is ``ref.chunked_attention`` (the forward of the
reference's chunked path).  The kernel runs bfloat16 on the tensor cores
(``mma.sync``) and float32 on the CUDA cores, so that fp32 keeps fp32
products.

The q/k head dim and the v head dim may differ (``HEAD_DIMS``): MLA's
prefill attends at qk 192 / v 128.  With ``return_lse`` the kernel also
writes each row's log-sum-exp (fp32, natural log), which the training
path's backward recomputes the probabilities from; a row that sees no key
gets +inf there (its output is 0, and so is its gradient), where the plain
version keeps the reference's -1e30.  ``flash_attention`` launches the
kernel and takes CUDA tensors only; ``kernels/ops.py`` sends CPU tensors to
the plain version.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# (q/k head dim, v head dim) pairs the kernel is instantiated for: the GQA
# families' uniform head dims, deepseek-v2's MLA prefill (128 nope + 64
# rope dims of q/k against 128 value dims), and the reduced (smoke)
# configs' head dim 16 and reduced MLA (16 nope + 8 rope against 16)
HEAD_DIMS = ((16, 16), (24, 16), (64, 64), (128, 128), (240, 240),
             (192, 128))

flash_attention_ref = ref.chunked_attention


def check_shapes(q, k, v) -> None:
    """Raise unless q (B, Sq, H, dh), k (B, Skv, Hkv, dh) and v (B, Skv,
    Hkv, dv) fit the kernel: one batch, H a multiple of Hkv, and (dh, dv)
    one of ``HEAD_DIMS``.  Reads only shapes, so it runs on any device."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_attention: q/k/v must be 4-D, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, H, dh = q.shape
    if (k.shape[0] != B or k.shape[-1] != dh
            or v.shape[:3] != k.shape[:3] or H % k.shape[2]):
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if (dh, v.shape[-1]) not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dims (qk {dh}, v "
                         f"{v.shape[-1]}) not supported by the kernel "
                         f"(supported: {HEAD_DIMS})")


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None, q_offset: int = 0,
                    scale: Optional[float] = None, return_lse: bool = False):
    """Launch the CUDA kernel.  q: (B, Sq, H, dh); k: (B, Skv, Hkv, dh);
    v: (B, Skv, Hkv, dv), contiguous CUDA tensors of one dtype (float32 or
    bfloat16) on an sm_90 device, (dh, dv) one of ``HEAD_DIMS``.  Returns
    (B, Sq, H, dv) in q's dtype, or with ``return_lse`` (out, lse (B, Sq,
    H) float32); ``scale`` defaults to dh ** -0.5."""
    check_shapes(q, k, v)
    B, Sq, H, dh = q.shape
    Skv, Hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    build.check_device(q)
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q/k/v must share one dtype of "
                        f"{list(_DTYPES)}, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
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
    out = q.new_empty((B, Sq, H, dv))
    lse = q.new_empty((B, Sq, H), dtype=torch.float32) if return_lse \
        else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = build.entry("flash_attention")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        B, Sq, Skv, H, Hkv, dh, dv, int(causal),
        -1 if window is None else int(window), int(q_offset), float(scale),
        _DTYPES[q.dtype], stream)
    build.check_status("flash_attention", status)
    return (out, lse) if return_lse else out
