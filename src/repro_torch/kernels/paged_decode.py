"""Ragged decode attention over a paged KV pool: the CUDA kernel
(``csrc/paged_decode.cu``) and its plain PyTorch version.

Port of ``repro/kernels/paged_decode.py``.  Each batch slot owns a page
table mapping logical pages to physical pool pages, and slots sit at
different positions; the kernel walks each slot's table and computes its
masked single-query GQA attention as combinable fp32 partials.

``paged_decode_partial`` launches the kernel and takes CUDA tensors only;
``kernels/ops.py`` sends CPU tensors to ``paged_decode_partial_ref``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import kv_pages
from repro_torch.kernels import build, ref

NEG_INF = ref.NEG_INF
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def paged_decode_partial_ref(q, kpool, vpool, pages, cur_pos, *,
                             window: Optional[int] = None,
                             scale: Optional[float] = None):
    """Plain version: gather the paged pool into the per-slot strip view
    and run the strip-path partial on it.

    q: (B, H, dh); kpool/vpool: (P(+scratch), ps, Hkv, dh); pages:
    (B, maxp) int32; cur_pos: (B,) or scalar int32.
    Returns (acc (B,H,dhv) f32, l (B,H) f32, m (B,H) f32).
    """
    ps = kpool.shape[1]
    k, v, kpos = kv_pages.pages_to_strips((kpool, vpool), pages, ps)
    cur = torch.as_tensor(cur_pos, dtype=torch.int32, device=q.device)
    if cur.dim() == 0:
        cur = cur.expand(q.shape[0])
    return ref.decode_partial_masked(q, k, v, kpos, cur, window=window,
                                     scale=scale)


def paged_decode_partial(q, kpool, vpool, pages, cur_pos, *,
                         window: Optional[int] = None,
                         scale: Optional[float] = None):
    """Launch the CUDA kernel.  Same arguments and results as
    ``paged_decode_partial_ref``; every tensor must be a contiguous CUDA
    tensor on an sm_90 device (q and pools float32 or bfloat16, pages and
    cur_pos int32).  The pools are read in place, by their layout."""
    B, H, dh = q.shape
    P1, ps, Hkv, dhk = kpool.shape
    build.check_device(q)
    if q.dtype not in _DTYPES or kpool.dtype != q.dtype \
            or vpool.dtype != q.dtype:
        raise TypeError(f"paged_decode: q/kpool/vpool must share one dtype "
                        f"of {list(_DTYPES)}, got {q.dtype}, {kpool.dtype}, "
                        f"{vpool.dtype}")
    if vpool.shape != kpool.shape or dhk != dh or H % Hkv:
        raise ValueError(f"paged_decode: shapes q {tuple(q.shape)}, kpool "
                         f"{tuple(kpool.shape)}, vpool {tuple(vpool.shape)}")
    if dh not in (32, 64, 128, 256) or H // Hkv > 32:
        raise ValueError(f"paged_decode: head dim {dh} / group "
                         f"{H // Hkv} not supported by the kernel")
    if 2 * ps * dh * 4 > 48 * 1024:
        raise ValueError(f"paged_decode: page_size {ps} too large for the "
                         f"kernel's shared-memory page buffer")
    cur = torch.as_tensor(cur_pos, dtype=torch.int32, device=q.device)
    if cur.dim() == 0:
        cur = cur.expand(B)
    cur = cur.contiguous()
    if pages.dtype != torch.int32 or pages.dim() != 2 or pages.shape[0] != B:
        raise ValueError(f"paged_decode: pages must be (B, maxp) int32, got "
                         f"{tuple(pages.shape)} {pages.dtype}")
    if window is not None and window <= 0:
        raise ValueError(f"paged_decode: window must be positive, got "
                         f"{window}")
    for name, t in (("q", q), ("kpool", kpool), ("vpool", vpool),
                    ("pages", pages)):
        if not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"paged_decode: {name} must be contiguous on "
                             f"{q.device}")
    scale = dh ** -0.5 if scale is None else scale
    acc = torch.empty((B, H, dh), dtype=torch.float32, device=q.device)
    l = torch.empty((B, H), dtype=torch.float32, device=q.device)
    m = torch.empty((B, H), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = build.entry("paged_decode")(
        q.data_ptr(), kpool.data_ptr(), vpool.data_ptr(), pages.data_ptr(),
        cur.data_ptr(), acc.data_ptr(), l.data_ptr(), m.data_ptr(),
        B, H, Hkv, dh, ps, pages.shape[1],
        -1 if window is None else int(window), float(scale),
        _DTYPES[q.dtype], stream)
    build.check_status("paged_decode", status)
    return acc, l, m
