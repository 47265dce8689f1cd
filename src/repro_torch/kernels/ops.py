"""Dispatch of the kernel ops by the device of their tensors.

  * a CUDA tensor launches the hand-written kernel (``csrc/*.cu``), which
    raises if it cannot be built or launched, or if the device is not
    sm_90; there is no fallback to the plain version on a GPU;
  * a CPU tensor takes the plain PyTorch version (``ref.py``).

Launches are counted per kernel in ``build.LAUNCHES`` (see
``launch_counts`` / ``reset_launch_counts``).
"""
from __future__ import annotations

from typing import Dict, Optional

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
    raise ValueError(f"no kernel or plain path for tensors on {t.device}")


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None, q_offset: int = 0,
                    scale: Optional[float] = None, q_chunk: int = 512,
                    kv_chunk: int = 512):
    """Causal attention.  q: (B,Sq,H,dh); k/v: (B,Skv,Hkv,dh).  The chunk
    sizes shape only the plain path."""
    if _on_cpu(q):
        return ref.chunked_attention(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset, scale=scale,
                                     q_chunk=q_chunk, kv_chunk=kv_chunk)
    return fa.flash_attention(q, k, v, causal=causal, window=window,
                              q_offset=q_offset, scale=scale)


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


def isp_gather(table, indices, *, shard_offset: int = 0, weights=None):
    """Masked shard-local row gather: ``table[id - shard_offset]`` for ids in
    this shard's rows, zeros elsewhere.  table (V_loc, D); indices (...)
    int; weights optional (...).  Returns (..., D) in the table's dtype."""
    if _on_cpu(table):
        return ig.isp_gather_ref(table, indices, shard_offset=shard_offset,
                                 weights=weights)
    return ig.isp_gather(table, indices, shard_offset=shard_offset,
                         weights=weights)


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


def topk_similarity(queries, corpus, k: int):
    """Cosine top-k: queries (Q, D), corpus (N, D).  Returns (scores
    float32 (Q, k), ids int32 (Q, k)), the lower id first on equal
    scores."""
    if _on_cpu(queries):
        return tk.topk_similarity_ref(queries, corpus, k)
    return tk.topk_similarity(queries, corpus, k)


def launch_counts() -> Dict[str, int]:
    """Kernel launches per kernel since the last reset."""
    return dict(build.LAUNCHES)


def reset_launch_counts() -> None:
    build.reset_launches()
