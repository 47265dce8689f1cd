"""Decode attention on one device (port of the local branches of
``repro/core/decode_attention.py``): over a dense KV strip with explicit
key positions (``decode_attention``) and over a paged KV pool
(``paged_decode_attention``)."""
from __future__ import annotations

from typing import Optional

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref


def decode_attention(q, k_cache, v_cache, kpos, cur_pos, *,
                     window: Optional[int],
                     scale: Optional[float] = None):
    """q: (B, H, dh); k/v_cache: (B, S, Hkv, dh); kpos (S,) with a scalar
    cur_pos, or per-slot kpos (B, S) with cur_pos (B,) (continuous
    batching).  Returns (B, H, dhv) in q's dtype."""
    acc, l, m = kops.decode_partial(q, k_cache, v_cache, kpos, cur_pos,
                                    window=window, scale=scale)
    return ref.combine_partials(acc[None], l[None], m[None],
                                axis=0).to(q.dtype)


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
