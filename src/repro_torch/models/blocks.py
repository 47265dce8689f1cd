"""Transformer blocks (port of the ``"attn"``, ``"local"`` and ``"moe"``
blocks of ``repro/models/blocks.py``): RMSNorm → GQA attention →
residual, RMSNorm → FFN → residual.  ``"attn"`` attends to the whole
sequence, ``"local"`` to a sliding window (gemma3's local layers); both
take a swiglu MLP.  ``"moe"`` (llama4-scout) attends to the whole sequence
and takes the routed experts plus any shared experts (``apply_moe``).  A
sharding recipe is threaded through to the attention layer; the Megatron
sequence-parallel residual stream (``sp_enabled``) and expert parallelism
are not ported."""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import empty_param, rms_norm, swiglu

KINDS = ("attn", "local", "moe")


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


class MoE(nn.Module):
    """Routed experts (+ shared experts) of one ``"moe"`` block, in the
    reference's layouts; the router stays float32 in a bf16 model."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        m = cfg.moe
        d, e, f = cfg.d_model, m.num_experts, m.d_ff_expert
        self.router = empty_param((d, e), torch.float32, device)
        self.we_gate = empty_param((e, d, f), dtype, device)
        self.we_up = empty_param((e, d, f), dtype, device)
        self.we_down = empty_param((e, f, d), dtype, device)
        if m.num_shared_experts:
            fs = (m.d_ff_shared or m.d_ff_expert) * m.num_shared_experts
            self.ws_gate = empty_param((d, fs), dtype, device)
            self.ws_up = empty_param((d, fs), dtype, device)
            self.ws_down = empty_param((fs, d), dtype, device)


class Block(nn.Module):
    """One ``"attn"``, ``"local"`` or ``"moe"`` block; parameter names
    follow the reference's pytree (``ln1``, ``attn.{wq,wk,wv,wo}``,
    ``ln2``, then ``mlp.{w_gate,w_up,w_down}`` or ``moe.{router,we_*,
    ws_*}``)."""

    def __init__(self, cfg: ModelConfig, kind: str, dtype, device):
        super().__init__()
        _check_kind(kind)
        self.kind = kind
        d = cfg.d_model
        self.ln1 = empty_param((d,), dtype, device)
        self.attn = attn_mod.GQA(cfg, dtype, device)
        self.ln2 = empty_param((d,), dtype, device)
        if kind == "moe":
            self.moe = MoE(cfg, dtype, device)
        else:
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


def apply_moe(moe: MoE, x, cfg: ModelConfig, plan=None):
    """Routed experts (``dense_moe``) plus the shared experts as a gated
    MLP.  Returns (y, aux_loss).  Where the reference would take expert
    parallelism (a recipe whose model axis has more than one rank dividing
    the experts; the reference's plans keep ``ep`` on) the port raises
    instead of computing the dense path silently."""
    m = cfg.moe
    tp = plan.axis_size(plan.model_axis) \
        if plan is not None and plan.mesh is not None else 1
    if tp > 1 and m.num_experts % tp == 0:
        raise NotImplementedError(
            "expert-parallel MoE over a model axis of more than one rank is "
            "not ported (ROADMAP queue 1 item 5)")
    routed = {k: getattr(moe, k)
              for k in ("router", "we_gate", "we_up", "we_down")}
    y, aux = moe_mod.dense_moe(routed, x, cfg)
    if m.num_shared_experts:
        y = y + swiglu(x, moe.ws_gate, moe.ws_up, moe.ws_down)
    return y, aux


def apply_block(block: Block, x, positions, cfg: ModelConfig,
                cache: Optional[Dict], mode: str, write_mask=None,
                plan=None):
    """Returns (x, new_cache); a ``"moe"`` block's aux loss is dropped (no
    training path is ported)."""
    eps = cfg.norm_eps
    h = rms_norm(x, block.ln1, eps)
    a, new_cache = attn_mod.gqa_apply(
        block.attn, h, positions, cfg,
        "local" if block.kind == "local" else "full", cache, mode,
        write_mask=write_mask, plan=plan)
    x = x + a
    h = rms_norm(x, block.ln2, eps)
    if block.kind == "moe":
        f, _ = apply_moe(block.moe, h, cfg, plan)
    else:
        f = swiglu(h, block.mlp.w_gate, block.mlp.w_up, block.mlp.w_down)
    return x + f, new_cache


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     dtype, device, paged: bool = False, num_pages: int = 0,
                     page_size: int = 16, plan=None):
    """Decode cache of one block.  ``paged=True`` gives a full-attention
    layer (``"attn"`` or ``"moe"``) the paged pool; a sliding-window layer
    always keeps its dense ring of ``window`` rows (its state is bounded
    already), and a full-attention layer without ``paged`` a dense
    ``max_len`` strip."""
    _check_kind(kind)
    if kind in ("attn", "moe") and paged:
        return attn_mod.init_paged_gqa_cache(cfg, batch, num_pages, page_size,
                                             max_len, dtype, device)
    return attn_mod.init_gqa_cache(cfg, "local" if kind == "local" else
                                   "full", batch, max_len, dtype, device,
                                   plan)
