"""Transformer blocks (port of the ``"attn"`` and ``"local"`` blocks of
``repro/models/blocks.py``): RMSNorm → GQA attention → residual, RMSNorm →
swiglu MLP → residual.  ``"attn"`` attends to the whole sequence,
``"local"`` to a sliding window (gemma3's local layers).  A sharding recipe
is threaded through to the attention layer; the Megatron sequence-parallel
residual stream (``sp_enabled``) is not ported."""
from __future__ import annotations

from typing import Dict, Optional

from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import empty_param, rms_norm, swiglu

KINDS = ("attn", "local")


def _check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise NotImplementedError(f"block kind {kind!r} is not ported yet")


class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.w_gate = empty_param((d, f), dtype, device)
        self.w_up = empty_param((d, f), dtype, device)
        self.w_down = empty_param((f, d), dtype, device)


class Block(nn.Module):
    """One ``"attn"`` or ``"local"`` block; parameter names follow the
    reference's pytree (``ln1``, ``attn.{wq,wk,wv,wo}``, ``ln2``,
    ``mlp.{w_gate,w_up,w_down}``)."""

    def __init__(self, cfg: ModelConfig, kind: str, dtype, device):
        super().__init__()
        _check_kind(kind)
        self.kind = kind
        d = cfg.d_model
        self.ln1 = empty_param((d,), dtype, device)
        self.attn = attn_mod.GQA(cfg, dtype, device)
        self.ln2 = empty_param((d,), dtype, device)
        self.mlp = MLP(cfg, dtype, device)


def sp_enabled(cfg: ModelConfig, plan, seq_len: int,
               mode: str = "train") -> bool:
    """Whether the residual stream runs sequence-sharded for this cell (the
    reference's single source of truth for blocks, embedding and loss
    head): only over a model axis of more than one rank, for train or
    prefill, at a sequence length and a head count that axis divides, and
    for models of at least 1 B parameters."""
    if not (plan is not None and plan.mesh is not None
            and plan.model_axis is not None and mode in ("train", "prefill")):
        return False
    tp = plan.axis_size(plan.model_axis)
    if tp <= 1 or seq_len % tp:
        return False
    if cfg.num_heads % tp != 0:
        return False
    return cfg.param_count() >= 1_000_000_000


def apply_block(block: Block, x, positions, cfg: ModelConfig,
                cache: Optional[Dict], mode: str, write_mask=None,
                plan=None):
    """Returns (x, new_cache)."""
    eps = cfg.norm_eps
    h = rms_norm(x, block.ln1, eps)
    a, new_cache = attn_mod.gqa_apply(
        block.attn, h, positions, cfg,
        "local" if block.kind == "local" else "full", cache, mode,
        write_mask=write_mask, plan=plan)
    x = x + a
    h = rms_norm(x, block.ln2, eps)
    x = x + swiglu(h, block.mlp.w_gate, block.mlp.w_up, block.mlp.w_down)
    return x, new_cache


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     dtype, device, paged: bool = False, num_pages: int = 0,
                     page_size: int = 16, plan=None):
    """Decode cache of one block.  ``paged=True`` gives a full-attention
    layer the paged pool; a sliding-window layer always keeps its dense
    ring of ``window`` rows (its state is bounded already), and a
    full-attention layer without ``paged`` a dense ``max_len`` strip."""
    _check_kind(kind)
    if kind == "attn" and paged:
        return attn_mod.init_paged_gqa_cache(cfg, batch, num_pages, page_size,
                                             max_len, dtype, device)
    return attn_mod.init_gqa_cache(cfg, "local" if kind == "local" else
                                   "full", batch, max_len, dtype, device,
                                   plan)
