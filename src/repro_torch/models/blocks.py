"""Transformer blocks (port of the ``"attn"`` block of
``repro/models/blocks.py``): RMSNorm → GQA full attention → residual,
RMSNorm → swiglu MLP → residual."""
from __future__ import annotations

from typing import Dict, Optional

from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import empty_param, rms_norm, swiglu


def _check_kind(kind: str) -> None:
    if kind != "attn":
        raise NotImplementedError(f"block kind {kind!r} is not ported yet")


class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.w_gate = empty_param((d, f), dtype, device)
        self.w_up = empty_param((d, f), dtype, device)
        self.w_down = empty_param((f, d), dtype, device)


class Block(nn.Module):
    """One ``"attn"`` block; parameter names follow the reference's pytree
    (``ln1``, ``attn.{wq,wk,wv,wo}``, ``ln2``, ``mlp.{w_gate,w_up,w_down}``)."""

    def __init__(self, cfg: ModelConfig, kind: str, dtype, device):
        super().__init__()
        _check_kind(kind)
        d = cfg.d_model
        self.ln1 = empty_param((d,), dtype, device)
        self.attn = attn_mod.GQA(cfg, dtype, device)
        self.ln2 = empty_param((d,), dtype, device)
        self.mlp = MLP(cfg, dtype, device)


def apply_block(block: Block, x, positions, cfg: ModelConfig,
                cache: Optional[Dict], mode: str, write_mask=None):
    """Returns (x, new_cache)."""
    eps = cfg.norm_eps
    h = rms_norm(x, block.ln1, eps)
    a, new_cache = attn_mod.gqa_apply(block.attn, h, positions, cfg, cache,
                                      mode, write_mask=write_mask)
    x = x + a
    h = rms_norm(x, block.ln2, eps)
    x = x + swiglu(h, block.mlp.w_gate, block.mlp.w_up, block.mlp.w_down)
    return x, new_cache


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     dtype, device, paged: bool = True, num_pages: int = 0,
                     page_size: int = 16):
    """Decode cache of one block: the paged pool of a full-attention layer."""
    _check_kind(kind)
    if not paged:
        raise NotImplementedError("the strip KV layout is not ported yet")
    return attn_mod.init_paged_gqa_cache(cfg, batch, num_pages, page_size,
                                         max_len, dtype, device)
