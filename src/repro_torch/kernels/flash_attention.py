"""Forward blocked attention: the CUDA kernel (``csrc/flash_attention.cu``)
and its plain PyTorch version.

Port of ``repro/kernels/flash_attention.py``: causal attention with an
optional sliding window, ``q_offset`` and GQA (q head ``h`` reads kv head
``h // g``), online softmax with fp32 accumulation, output in q's dtype.
The plain version is ``ref.chunked_attention`` (the forward of the
reference's chunked path).  The kernel runs bfloat16 and float16 on the
tensor cores (``mma.sync``, one template over the element type) and
float32 on the CUDA cores, so that fp32 keeps fp32 products.

The kernel takes every uniform head dim from 1 to ``MAX_HEAD_DIM`` (256),
as the reference's kernel takes any: the GQA families' dims and the smoke
configs' 16 on instantiations of their own, every other dim on the least
class width that holds it, its columns past dh zero in shared memory.  The
q/k head dim and the v head dim may differ only in ``UNEQUAL_DIMS``: MLA's
prefill attends at qk 192 / v 128, the reduced MLA at 24 / 16; the
reference refuses every other unequal pair.  With ``return_lse`` the kernel also
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

# the widest uniform head dim the kernel's tiles take (its largest class)
MAX_HEAD_DIM = 256
# the (q/k head dim, v head dim) pairs that differ: deepseek-v2's MLA
# prefill (128 nope + 64 rope dims of q/k against 128 value dims) and the
# reduced MLA (16 nope + 8 rope against 16)
UNEQUAL_DIMS = ((24, 16), (192, 128))

flash_attention_ref = ref.chunked_attention


def check_shapes(q, k, v) -> None:
    """Raise unless q (B, Sq, H, dh), k (B, Skv, Hkv, dh) and v (B, Skv,
    Hkv, dv) fit the kernel: one batch, H a multiple of Hkv, and either
    dh == dv with 1 <= dh <= ``MAX_HEAD_DIM`` or (dh, dv) one of
    ``UNEQUAL_DIMS``.  Reads only shapes, so it runs on any device."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_attention: q/k/v must be 4-D, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, H, dh = q.shape
    if (k.shape[0] != B or k.shape[-1] != dh
            or v.shape[:3] != k.shape[:3] or H % k.shape[2]):
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    dv = v.shape[-1]
    if dh != dv and (dh, dv) not in UNEQUAL_DIMS:
        raise ValueError(f"flash_attention: head dims (qk {dh}, v {dv}) "
                         f"differ; the kernel takes equal dims or one of "
                         f"{UNEQUAL_DIMS}")
    if not 1 <= dh <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {dh} is past the "
                         f"kernel's limit of {MAX_HEAD_DIM}")


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None, q_offset: int = 0,
                    scale: Optional[float] = None, return_lse: bool = False):
    """Launch the CUDA kernel.  q: (B, Sq, H, dh); k: (B, Skv, Hkv, dh);
    v: (B, Skv, Hkv, dv), contiguous CUDA tensors of one dtype (float32,
    bfloat16 or float16) on an sm_90 device, (dh, dv) as ``check_shapes``
    takes them.  Returns (B, Sq, H, dv) in q's dtype, or with
    ``return_lse`` (out, lse (B, Sq, H) float32); ``scale`` defaults to
    dh ** -0.5."""
    check_shapes(q, k, v)
    B, Sq, H, dh = q.shape
    Skv, Hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    code = build.dtype_code("flash_attention", q, k, v)
    build.check_device(q)
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
        code, stream)
    build.check_status("flash_attention", status)
    return (out, lse) if return_lse else out
