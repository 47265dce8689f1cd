"""GQA attention, full attention only (port of the prefill and paged-decode
branches of ``repro/models/attention.py::gqa_apply``).

Two entry modes:
  prefill  — full-sequence causal attention (flash kernel), emits the
             sequence's K/V for the engine to splice into the paged pool;
  decode   — one new token per slot against the paged pool (paged-decode
             kernel), writing the new K/V row into the pool first.

Parameters keep the reference's layouts: wq (D, H, dh), wk/wv (D, Hkv,
dh), wo (H, dh, D).  Activations are (B, S, H, dh).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.core.decode_attention import paged_decode_attention
from repro_torch.core.kv_pages import pages_for
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import apply_rope, dense_init, empty_param


class GQA(nn.Module):
    """Holds one layer's attention projections."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, h, hkv, dh = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                         cfg.resolved_head_dim)
        self.wq = empty_param((d, h, dh), dtype, device)
        self.wk = empty_param((d, hkv, dh), dtype, device)
        self.wv = empty_param((d, hkv, dh), dtype, device)
        self.wo = empty_param((h, dh, d), dtype, device)


def gqa_params(cfg: ModelConfig, generator: torch.Generator, dtype,
               device) -> Dict[str, torch.Tensor]:
    """Fresh projection weights with the reference's init distribution."""
    d, h, hkv, dh = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                     cfg.resolved_head_dim)
    kw = dict(generator=generator, dtype=dtype, device=device)
    return {
        "wq": dense_init((d, h, dh), **kw),
        "wk": dense_init((d, hkv, dh), **kw),
        "wv": dense_init((d, hkv, dh), **kw),
        "wo": dense_init((h, dh, d), scale=(h * dh) ** -0.5, **kw),
    }


def init_paged_gqa_cache(cfg: ModelConfig, batch: int, num_pages: int,
                         page_size: int, max_len: int, dtype, device):
    """Paged decode cache of one full-attention layer: ``kp``/``vp`` pools
    of ``num_pages`` pages (+1 scratch page at index ``num_pages`` that
    absorbs the writes of inactive slots) and the per-slot page table
    (-1 = unallocated) the engine maintains."""
    hkv, dh = cfg.num_kv_heads, cfg.resolved_head_dim
    maxp = pages_for(max_len, page_size)
    shape = (num_pages + 1, page_size, hkv, dh)
    return {
        "kp": torch.zeros(shape, dtype=dtype, device=device),
        "vp": torch.zeros(shape, dtype=dtype, device=device),
        "pages": torch.full((batch, maxp), -1, dtype=torch.int32,
                            device=device),
    }


def _paged_update(cache, k_new, v_new, posb, write_mask=None):
    """Write each slot's (1, hkv, dh) row into its page at ``pos %
    page_size``.  Slots whose logical page is unallocated, and slots masked
    off by ``write_mask`` (finished mid-way through a K-step block), write
    into the scratch page, which is never read back.

    The reference returns new pools (``.at[].set`` under buffer donation);
    here the pools are updated in place with ``index_put_``."""
    kp, vp, pages = cache["kp"], cache["vp"], cache["pages"]
    ps = kp.shape[1]
    scratch = kp.shape[0] - 1
    bidx = torch.arange(posb.shape[0], device=posb.device)
    pos = posb.long()
    page = pages[bidx, pos // ps].long()
    page = torch.where(page < 0, torch.full_like(page, scratch), page)
    if write_mask is not None:
        page = torch.where(write_mask, page, torch.full_like(page, scratch))
    off = pos % ps
    kp.index_put_((page, off), k_new[:, 0].to(kp.dtype))
    vp.index_put_((page, off), v_new[:, 0].to(vp.dtype))
    return cache


def _project(x, w):
    """(B, S, D) @ (D, H, dh) -> (B, S, H, dh)."""
    B, S, D = x.shape
    return (x.reshape(B * S, D) @ w.reshape(D, -1)).reshape(
        B, S, w.shape[1], w.shape[2])


def gqa_apply(attn: GQA, x, positions, cfg: ModelConfig,
              cache: Optional[Dict] = None, mode: str = "prefill",
              write_mask=None):
    """x: (B, S, D).  prefill: positions (S,); decode: per-slot (B,)
    positions against a paged cache, ``write_mask`` (B,) bool gating the
    cache write per slot.  Returns (out (B, S, D), new_cache)."""
    if cfg.attn.kind != "full":
        raise NotImplementedError(
            f"attention kind {cfg.attn.kind!r} is not ported yet")
    rope_base = cfg.attn.rope_base
    B, S, _ = x.shape
    if mode == "decode":
        posb = positions.expand(B).to(torch.int32)
        rope_pos = posb[:, None]
    elif mode == "prefill":
        rope_pos = positions[None, :]
    else:
        raise NotImplementedError(f"attention mode {mode!r} is not ported")

    q = apply_rope(_project(x, attn.wq), rope_pos, rope_base)
    k = apply_rope(_project(x, attn.wk), rope_pos, rope_base)
    v = _project(x, attn.wv)

    if mode == "decode":
        if cache is None or "pages" not in cache:
            raise NotImplementedError("decode needs the paged cache layout; "
                                      "the strip layout is not ported")
        new_cache = _paged_update(cache, k, v, posb, write_mask)
        out_h = paged_decode_attention(q[:, 0], cache["kp"], cache["vp"],
                                       cache["pages"], posb, window=None)
        out_h = out_h[:, None]                                # (B,1,H,dh)
    else:
        out_h = kops.flash_attention(q, k, v, causal=True, window=None,
                                     q_chunk=cfg.attn_chunk,
                                     kv_chunk=cfg.attn_chunk)
        new_cache = {"k": k, "v": v,
                     "kpos": torch.arange(S, dtype=torch.int32,
                                          device=x.device)}
    H, dh, D = attn.wo.shape
    out = out_h.to(x.dtype).reshape(B * S, H * dh) @ attn.wo.reshape(H * dh, D)
    return out.reshape(B, S, D), new_cache
