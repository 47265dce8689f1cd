"""Decode attention (port of ``repro/core/decode_attention.py``): over a
dense KV strip with explicit key positions (``decode_attention``), over
a paged KV pool (``paged_decode_attention``), a prefill chunk over a
paged KV pool (``chunk_prefill_attention``), and MLA's absorbed decode
over the compressed cache (``mla_decode_attention``).

ISP decode under a sequence-sharded plan: each rank holds its own
contiguous block of the strip's rows (of the compressed strip for MLA; of
the strip view of a paged pool), and the per-step query goes to where the
KV span lives.  Each rank computes a partial over its rows and only
the partials move — per head ``acc`` (dh floats), ``l`` and ``m`` — merged
by the numerically stable flash-decoding combine over the sequence axes.
The KV bytes never cross a link.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch import sharding as sh
from repro_torch.core.kv_pages import pages_to_strips
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref


def _seq_sharded(plan) -> bool:
    return plan is not None and plan.mesh is not None and bool(plan.seq_axes)


def _combine(acc, l, m, group):
    """Stable merge of the ranks' partials: max of ``m`` over the group,
    then one sum of the rescaled ``acc`` and ``l`` (packed together)."""
    m_glob = m.clone()
    sh.reduce_in_group(m_glob, group, dist.ReduceOp.MAX)
    w = torch.exp(m - m_glob)
    buf = torch.cat([acc * w[..., None], (l * w)[..., None]], dim=-1)
    sh.reduce_in_group(buf, group)
    acc, l = buf[..., :-1], buf[..., -1]
    l = torch.where(l == 0, torch.ones_like(l), l)
    return acc / l[..., None]


def decode_attention(q, k_cache, v_cache, kpos, cur_pos, *,
                     window: Optional[int], plan=None,
                     scale: Optional[float] = None):
    """q: (B, H, dh); k/v_cache: (B, S, Hkv, dh); kpos (S,) with a scalar
    cur_pos, or per-slot kpos (B, S) with cur_pos (B,) (continuous
    batching).  Returns (B, H, dhv) in q's dtype.

    ``plan`` is a ShardingRecipe; with a mesh and non-empty ``seq_axes`` the
    strip (and kpos) passed in are this rank's block of rows, each rank runs
    the decode partial over its block and the partials are combined over
    the sequence axes."""
    acc, l, m = kops.decode_partial(q, k_cache, v_cache, kpos, cur_pos,
                                    window=window, scale=scale)
    if not _seq_sharded(plan):
        return ref.combine_partials(acc[None], l[None], m[None],
                                    axis=0).to(q.dtype)
    group = sh.axis_group(plan, plan.seq_axes)
    return _combine(acc, l, m, group).to(q.dtype)


def paged_decode_attention(q, kpool, vpool, pages, cur_pos, *,
                           window: Optional[int], plan=None,
                           scale: Optional[float] = None):
    """q: (B, H, dh); kpool/vpool: (P(+scratch), page_size, Hkv, dh);
    pages: (B, maxp) int32 per-slot page tables; cur_pos: (B,) int32.
    Returns (B, H, dhv) in q's dtype.

    Under a sequence-sharded plan, as in the reference, the pool is
    gathered into the strip view (``pages_to_strips``): the page table is
    replicated host state, so sharding the pool would shard pages, not
    positions.  Each rank takes its block of the strips' rows and runs the
    strip path (``decode_attention``), whose partials are combined over the
    sequence axes; paged allocation still governs memory."""
    if not _seq_sharded(plan):
        acc, l, m = kops.paged_decode_partial(q, kpool, vpool, pages,
                                              cur_pos, window=window,
                                              scale=scale)
        return ref.combine_partials(acc[None], l[None], m[None],
                                    axis=0).to(q.dtype)
    k, v, kpos = pages_to_strips((kpool, vpool), pages, kpool.shape[1])
    n = sh.axes_size(plan, plan.seq_axes)
    if kpos.shape[1] % n:
        raise ValueError(f"a strip view of {kpos.shape[1]} rows does not "
                         f"split over the sequence axes {plan.seq_axes} "
                         f"({n} ranks)")
    k, v, kpos = (sh.own_block(plan, t, plan.seq_axes, 1)
                  for t in (k, v, kpos))
    cur = torch.as_tensor(cur_pos, dtype=torch.int32, device=q.device)
    if cur.dim() == 0:
        cur = cur.expand(q.shape[0])
    return decode_attention(q, k, v, kpos, cur, window=window, plan=plan,
                            scale=scale)


def chunk_prefill_attention(q, kpool, vpool, pages, qpos, *,
                            scale: Optional[float] = None):
    """Chunked-prefill attention over a paged KV pool.

    q: (B, C, H, dh) chunk queries; kpool/vpool: (P(+scratch), page_size,
    Hkv, dh); pages: (B, maxp) int32 page tables; qpos: (B, C) int32 query
    positions (-1 = pad row).  The chunk's rows are already scattered into
    the pool, so the slot's pages gathered into the strip view hold prefix
    + chunk in one span, masked causally per row."""
    k, v, kpos = pages_to_strips((kpool, vpool), pages, kpool.shape[1])
    return kops.chunk_prefill_attention(q, k, v, kpos, qpos, scale=scale)


def mla_absorb(q_nope, wk_b):
    """q_nope (B, H, n) through wk_b (R, H, n) in fp32: the query against
    the compressed rows, (B, H, R)."""
    return torch.einsum("bhn,rhn->bhr", q_nope.float(), wk_b.float())


def mla_decode_absorbed(q_eff, q_rope, ckv, krope, kpos, cur_pos, *,
                        scale: float, plan=None):
    """``mla_decode_attention`` from the absorbed query ``q_eff`` (B, H,
    R).  Under a sequence-sharded plan ``ckv``/``krope``/``kpos`` are this
    rank's block of the compressed strip: each rank takes the partial over
    its block, and the partials — (R + 2) floats a head — are combined over
    the sequence axes, as the reference's shard_map does."""
    acc, l, m = ref.mla_decode_scores_partial(q_eff, q_rope, ckv, krope,
                                              kpos, cur_pos, scale=scale)
    if not _seq_sharded(plan):
        return ref.combine_partials(acc[None], l[None], m[None], axis=0)
    return _combine(acc, l, m, sh.axis_group(plan, plan.seq_axes))


def mla_decode_attention(q_nope, q_rope, ckv, krope, kpos, cur_pos, wk_b, *,
                         scale: float, plan=None):
    """Absorbed-MLA decode over the compressed cache.

    q_nope: (B, H, n); q_rope: (B, H, r); ckv: (B, S, R); krope: (B, S, r);
    kpos (S,) with a scalar cur_pos, or (B, S) with cur_pos (B,); wk_b:
    (R, H, n).  q_nope is absorbed through wk_b in fp32, so the scores are
    taken against the 576-value compressed rows directly and no per-head
    K/V is materialised.  Returns the probability-weighted ckv context
    (B, H, R) in fp32; the caller applies wv_b.  Like the reference, this
    is plain tensor code on every device (no Pallas kernel there, no CUDA
    kernel here, no launch counted).  Under a sequence-sharded plan the
    cache is this rank's block of rows (``mla_decode_absorbed``)."""
    return mla_decode_absorbed(mla_absorb(q_nope, wk_b), q_rope, ckv, krope,
                               kpos, cur_pos, scale=scale, plan=plan)
