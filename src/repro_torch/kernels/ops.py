"""Dispatch of the kernel ops by the device of their tensors.

  * a CUDA tensor launches the hand-written kernel (``csrc/*.cu``), which
    raises if it cannot be built or launched, or if the device is not
    sm_90; there is no fallback to the plain version on a GPU;
  * a CPU tensor takes the plain PyTorch version (``ref.py``).

``chunk_prefill_attention`` is the one op with no kernel: the reference
has none either, and every device takes its plain version.

``flash_attention`` is differentiable, as the reference's
``chunked_attention`` (a ``custom_vjp``) is: when grad is enabled and q, k
or v requires it, it runs as ``_FlashAttention``, whose forward is the
kernel on the card (or the plain forward on the CPU) returning the rows'
log-sum-exp as well, and whose backward is the plain
``ref.flash_attention_bwd`` on every device (the reference pairs its
forward with a jnp backward; it has no Pallas backward kernel).
``isp_gather`` is differentiable the same way (``_IspGather``: the
kernel's forward, a plain masked scatter-add backward), for the
vocab-sharded embedding lookup in training.

Launches are counted per kernel in ``build.LAUNCHES`` (see
``launch_counts`` / ``reset_launch_counts``).

Each call that a hand-written kernel computes is a kernel site
(``analysis.op_trace.kernel_site``): under the analysis layer's recorder
it counts as one op with its kernel's operations and bytes.  Only there
may a tensor be on ``meta`` (the dry-run): a site then builds its
outputs' shapes and runs nothing.  Anywhere else a ``meta`` tensor
raises.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.analysis import op_trace
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import isp_decode as isp
from repro_torch.kernels import isp_gather as ig
from repro_torch.kernels import paged_decode as pd
from repro_torch.kernels import ref
from repro_torch.kernels import topk_similarity as tk


def _on_cpu(t) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    if t.device.type == "meta" and op_trace.active() is not None:
        return True          # the plain version's shapes, under a recorder
    raise ValueError(f"no kernel or plain path for tensors on {t.device}")


@op_trace.kernel_site("flash_attention")
def _flash_fwd(q, k, v, causal, window, q_offset, scale, q_chunk, kv_chunk,
               return_lse):
    if _on_cpu(q):
        return ref.chunked_attention(
            q, k, v, causal=causal, window=window, q_offset=q_offset,
            scale=scale, q_chunk=q_chunk, kv_chunk=kv_chunk,
            return_lse=return_lse)
    return fa.flash_attention(q, k, v, causal=causal, window=window,
                              q_offset=q_offset, scale=scale,
                              return_lse=return_lse)


class _FlashAttention(torch.autograd.Function):
    """Attention with the reference's flash VJP: the forward saves (q, k,
    v, out, lse); the backward recomputes the probabilities chunk by chunk
    from them (``ref.flash_attention_bwd``).  The forward launches the
    kernel for a CUDA tensor, or raises; it never gives way to the plain
    forward on the card."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, scale, q_chunk,
                kv_chunk):
        out, lse = _flash_fwd(q, k, v, causal, window, q_offset, scale,
                              q_chunk, kv_chunk, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = dict(causal=causal, window=window, q_offset=q_offset,
                      scale=scale, q_chunk=q_chunk, kv_chunk=kv_chunk)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = ref.flash_attention_bwd(q, k, v, out, lse, dout,
                                             **ctx.kw)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None, q_offset: int = 0,
                    scale: Optional[float] = None, q_chunk: int = 512,
                    kv_chunk: int = 512):
    """Causal attention.  q: (B,Sq,H,dh); k/v: (B,Skv,Hkv,dh[v]).  Returns
    (B,Sq,H,dhv).  The chunk sizes shape the plain forward and the
    backward.  Differentiable: with grad enabled and any of q/k/v requiring
    it, it goes through ``_FlashAttention``; otherwise (every serve path)
    the forward alone runs and writes no lse."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, window, q_offset,
                                     scale, q_chunk, kv_chunk)
    return _flash_fwd(q, k, v, causal, window, q_offset, scale, q_chunk,
                      kv_chunk, False)


@op_trace.kernel_site("paged_decode")
def paged_decode_partial(q, kpool, vpool, pages, cur_pos, *,
                         window: Optional[int] = None,
                         scale: Optional[float] = None):
    """Ragged decode partial over a paged KV pool.  q: (B,H,dh); pools
    (P(+scratch), page_size, Hkv, dh); pages (B,maxp) int32; cur_pos (B,).
    Returns (acc fp32 (B,H,dh), l (B,H), m (B,H))."""
    if _on_cpu(q):
        return pd.paged_decode_partial_ref(q, kpool, vpool, pages, cur_pos,
                                           window=window, scale=scale)
    return pd.paged_decode_partial(q, kpool, vpool, pages, cur_pos,
                                   window=window, scale=scale)


@op_trace.kernel_site("isp_decode")
def decode_partial(q, k, v, kpos, cur_pos, *, window: Optional[int] = None,
                   scale: Optional[float] = None):
    """Decode partial over a dense strip with explicit key positions.
    q: (B,H,dh); k/v: (B,S,Hkv,dh); kpos (S,) with scalar cur_pos, or
    per-slot kpos (B,S) with cur_pos (B,).  Both layouts take the kernel on
    the card.  Returns (acc fp32 (B,H,dh), l (B,H), m (B,H))."""
    if _on_cpu(q):
        return isp.decode_partial_ref(q, k, v, kpos, cur_pos, window=window,
                                      scale=scale)
    return isp.decode_partial(q, k, v, kpos, cur_pos, window=window,
                              scale=scale)


def chunk_prefill_attention(q, k, v, kpos, qpos, *,
                            scale: Optional[float] = None):
    """Chunked-prefill attention: chunk queries at explicit positions over
    a cached span.  q: (B,C,H,dh); k/v: (B,S,Hkv,dh[v]); kpos: (B,S) (-1 =
    empty row); qpos: (B,C) (-1 = pad row).  As in the reference, which
    has no Pallas kernel for it, every device takes the plain version (one
    chunk runs per engine tick: admission work, not the per-token loop),
    and no launch is counted."""
    return ref.chunk_attention_masked(q, k, v, kpos, qpos, scale=scale)


@op_trace.kernel_site("isp_gather")
def _isp_gather_fwd(table, indices, shard_offset, weights, shard_rows=None):
    if _on_cpu(table):
        return ig.isp_gather_ref(table, indices, shard_offset=shard_offset,
                                 weights=weights, shard_rows=shard_rows)
    return ig.isp_gather(table, indices, shard_offset=shard_offset,
                         weights=weights, shard_rows=shard_rows)


class _IspGather(torch.autograd.Function):
    """The masked shard-local gather with a gradient.  The forward is the
    kernel on the card (or raises) and the plain version on the CPU.  The
    backward is plain PyTorch on every device, as the reference has no
    Pallas backward for it: the output's gradient rows, scaled by
    ``weights`` where given, are summed into this shard's rows of the
    table for the ids it owns (a masked scatter-add, accumulated in
    float32 and cast to the table's dtype); ids outside the shard (or past
    its ``shard_rows``) add zero.  ``weights`` gets the gradient rows' dot
    products with the rows they scaled (zero outside the shard)."""

    @staticmethod
    def forward(ctx, table, indices, shard_offset, weights, shard_rows):
        ctx.off = int(shard_offset)
        ctx.rows = ref.shard_rows_of(table, shard_rows)
        ctx.table_shape, ctx.table_dtype = table.shape, table.dtype
        ctx.save_for_backward(indices, weights,
                              table if ctx.needs_input_grad[3] else None)
        return _isp_gather_fwd(table, indices, shard_offset, weights,
                               shard_rows)

    @staticmethod
    def backward(ctx, g):
        indices, weights, table = ctx.saved_tensors
        v_loc, d = ctx.table_shape
        local = indices.reshape(-1).long() - ctx.off
        ok = (local >= 0) & (local < ctx.rows)
        rows = g.reshape(-1, d).float()
        dtable = dw = None
        if ctx.needs_input_grad[0]:
            if weights is not None:
                rows = rows * weights.reshape(-1, 1).float()
            acc = torch.zeros((v_loc, d), dtype=torch.float32,
                              device=g.device)
            # ids off the shard add a zero row to row 0: no mask of
            # data-dependent length, so the dry-run can trace it
            acc.index_add_(0, torch.where(ok, local, 0),
                           torch.where(ok[:, None], rows, 0.0))
            dtable = acc.to(ctx.table_dtype)
        if ctx.needs_input_grad[3]:
            plain = ref.isp_gather(table, indices, ctx.off,
                                   shard_rows=ctx.rows).float()
            dw = (g.float() * plain).sum(-1).to(weights.dtype)
        return dtable, None, None, dw, None


def isp_gather(table, indices, *, shard_offset: int = 0, shard_rows=None,
               weights=None):
    """Masked shard-local row gather: ``table[id - shard_offset]`` for ids in
    this shard's rows, zeros elsewhere.  table (V_loc, D); indices (...)
    int; shard_rows: the shard's rows, at most (and by default) V_loc, as
    the reference's plain path takes it (ids at or past ``shard_offset +
    shard_rows`` give zeros; more than V_loc raises ValueError); weights
    optional (...).  Returns (..., D) in the table's dtype.
    Differentiable in ``table`` and ``weights``: with grad enabled and
    either requiring it, the call goes through ``_IspGather`` (the same
    forward, a plain backward); otherwise the forward alone runs."""
    if torch.is_grad_enabled() and (table.requires_grad or (
            weights is not None and weights.requires_grad)):
        return _IspGather.apply(table, indices, shard_offset, weights,
                                shard_rows)
    return _isp_gather_fwd(table, indices, shard_offset, weights, shard_rows)


@op_trace.kernel_site("isp_gather_pool")
def isp_gather_pool(table, indices, segment_ids, num_segments: int, *,
                    shard_offset: int = 0, weights=None):
    """Fused masked gather + weighted segment sum (the RecSSD embedding
    bag): ids outside this shard's rows and segments outside
    [0, num_segments) are dropped.  table (V_loc, D); indices, segment_ids
    (N,) int; weights optional (N,).  Returns (num_segments, D) float32."""
    if _on_cpu(table):
        return ig.isp_gather_pool_ref(table, indices, segment_ids,
                                      num_segments, shard_offset=shard_offset,
                                      weights=weights)
    return ig.isp_gather_pool(table, indices, segment_ids, num_segments,
                              shard_offset=shard_offset, weights=weights)


@op_trace.kernel_site("topk_similarity")
def topk_similarity(queries, corpus, k: int):
    """Cosine top-k: queries (Q, D), corpus (N, D).  Returns (scores
    float32 (Q, k), ids int32 (Q, k)), the lower id first on equal
    scores."""
    if _on_cpu(queries):
        return tk.topk_similarity_ref(queries, corpus, k)
    return tk.topk_similarity(queries, corpus, k)


def launch_counts() -> Dict[str, int]:
    """Kernel launches per kernel since the last reset."""
    return build.launch_counts()


def reset_launch_counts() -> None:
    build.reset_launches()
