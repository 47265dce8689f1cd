"""Decode attention over a paged KV pool, single device (port of the local
branch of ``repro/core/decode_attention.py::paged_decode_attention``)."""
from __future__ import annotations

from typing import Optional

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref


def paged_decode_attention(q, kpool, vpool, pages, cur_pos, *,
                           window: Optional[int],
                           scale: Optional[float] = None):
    """q: (B, H, dh); kpool/vpool: (P(+scratch), page_size, Hkv, dh);
    pages: (B, maxp) int32 per-slot page tables; cur_pos: (B,) int32.
    Returns (B, H, dhv) in q's dtype."""
    acc, l, m = kops.paged_decode_partial(q, kpool, vpool, pages, cur_pos,
                                          window=window, scale=scale)
    return ref.combine_partials(acc[None], l[None], m[None],
                                axis=0).to(q.dtype)
