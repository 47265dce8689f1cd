"""Per-family blocks (port of ``repro/models/blocks.py``).

Block kinds:
  attn     RMSNorm → full GQA attention → residual, RMSNorm → swiglu MLP
  local    the same over a sliding window (gemma3's local layers)
  moe      full GQA attention + routed experts and shared experts
           (llama4-scout; ``apply_moe``)
  mla_moe  MLA attention + routed and shared experts (deepseek-v2)
  hybrid   sliding-window GQA attention and Mamba in parallel on the same
           normed input, 0.5 * (a + s) to the residual, then the MLP (hymba)
  mlstm / slstm  an xLSTM core on the normed input, to the residual; no
           second norm and no MLP (xlstm)

A sharding recipe is threaded through to the attention layer; the Megatron
sequence-parallel residual stream (``sp_enabled``) and expert parallelism
are not ported."""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import dense_init, empty_param, rms_norm, \
    swiglu

KINDS = ("attn", "local", "moe", "mla_moe", "hybrid", "mlstm", "slstm")
_MOE_KINDS = ("moe", "mla_moe")


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
    """One block of any of ``KINDS``; parameter names follow the
    reference's pytree: ``ln1``; ``attn.*`` (GQA's ``wq, wk, wv, wo`` or
    MLA's) for the attention kinds; ``ssm.*`` (Mamba) for ``"hybrid"``;
    ``ln2`` then ``mlp.{w_gate,w_up,w_down}`` or ``moe.{router,we_*,
    ws_*}``; ``core.*`` for the xLSTM kinds."""

    def __init__(self, cfg: ModelConfig, kind: str, dtype, device):
        super().__init__()
        _check_kind(kind)
        self.kind = kind
        d = cfg.d_model
        self.ln1 = empty_param((d,), dtype, device)
        if kind == "mlstm":
            self.core = ssm_mod.MLSTM(cfg, dtype, device)
            return
        if kind == "slstm":
            self.core = ssm_mod.SLSTM(cfg, dtype, device)
            return
        self.attn = attn_mod.MLA(cfg, dtype, device) if kind == "mla_moe" \
            else attn_mod.GQA(cfg, dtype, device)
        if kind == "hybrid":
            self.ssm = ssm_mod.Mamba(cfg, dtype, device)
        self.ln2 = empty_param((d,), dtype, device)
        if kind in _MOE_KINDS:
            self.moe = MoE(cfg, dtype, device)
        else:
            self.mlp = MLP(cfg, dtype, device)


def block_params(cfg: ModelConfig, kind: str, generator: torch.Generator,
                 dtype, device) -> Dict:
    """Fresh weights of one block as the reference's ``block_params`` draws
    them (its tree, its distributions), for ``Block``'s parameters."""
    kw = dict(generator=generator, dtype=dtype, device=device)
    d = cfg.d_model
    zeros = lambda: torch.zeros((d,), dtype=dtype, device=device)  # noqa
    p: Dict = {"ln1": zeros()}
    if kind == "mlstm":
        p["core"] = ssm_mod.mlstm_params(cfg, **kw)
        return p
    if kind == "slstm":
        p["core"] = ssm_mod.slstm_params(cfg, **kw)
        return p
    p["attn"] = attn_mod.mla_params(cfg, **kw) if kind == "mla_moe" \
        else attn_mod.gqa_params(cfg, **kw)
    if kind == "hybrid":
        p["ssm"] = ssm_mod.mamba_params(cfg, **kw)
    p["ln2"] = zeros()
    if kind in _MOE_KINDS:
        p["moe"] = moe_mod.moe_params(cfg, **kw)
    else:
        f = cfg.d_ff
        p["mlp"] = {"w_gate": dense_init((d, f), **kw),
                    "w_up": dense_init((d, f), **kw),
                    "w_down": dense_init((f, d), **kw)}
    return p


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
    """Returns (x, new_cache) in the serve modes, where an MoE block's aux
    loss is dropped; in ``"train"``, which builds no cache, (x, aux): the
    MoE load loss of ``"moe"`` / ``"mla_moe"`` blocks, a float32 0 for the
    others (the reference's third return value).  ``write_mask`` gates the
    attention caches' decode writes; recurrent states need none (a finished
    slot only corrupts its own state, which the engine replaces whole at
    refill)."""
    eps = cfg.norm_eps
    kind = block.kind
    train = mode == "train"
    h = rms_norm(x, block.ln1, eps)
    if kind == "mlstm":
        y, new_cache = ssm_mod.mlstm_apply(block.core, h, cfg, cache, mode)
        return x + y, _zero(x) if train else new_cache
    if kind == "slstm":
        y, new_cache = ssm_mod.slstm_apply(block.core, h, cfg, cache, mode)
        return x + y, _zero(x) if train else new_cache
    if kind == "mla_moe":
        a, new_cache = attn_mod.mla_apply(block.attn, h, positions, cfg,
                                          cache, mode, write_mask=write_mask,
                                          plan=plan)
    elif kind == "hybrid":
        a, attn_cache = attn_mod.gqa_apply(
            block.attn, h, positions, cfg, "local",
            cache["attn"] if cache else None, mode, write_mask=write_mask,
            plan=plan)
        s, ssm_cache = ssm_mod.mamba_apply(block.ssm, h, cfg,
                                           cache["ssm"] if cache else None,
                                           mode)
        a = 0.5 * (a + s)
        new_cache = {"attn": attn_cache, "ssm": ssm_cache}
    else:
        a, new_cache = attn_mod.gqa_apply(
            block.attn, h, positions, cfg,
            "local" if kind == "local" else "full", cache, mode,
            write_mask=write_mask, plan=plan)
    x = x + a
    h = rms_norm(x, block.ln2, eps)
    aux = None
    if kind in _MOE_KINDS:
        f, aux = apply_moe(block.moe, h, cfg, plan)
    else:
        f = swiglu(h, block.mlp.w_gate, block.mlp.w_up, block.mlp.w_down)
    if not train:
        return x + f, new_cache
    return x + f, _zero(x) if aux is None else aux


def _zero(x) -> torch.Tensor:
    """A block's load loss where it has none: float32 0 (train only, so
    that the serve modes add no operation)."""
    return x.new_zeros((), dtype=torch.float32)


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     dtype, device, paged: bool = False, num_pages: int = 0,
                     page_size: int = 16, plan=None):
    """Decode cache of one block.  ``paged=True`` gives a full-attention
    GQA layer (``"attn"`` or ``"moe"``) the paged pool; a sliding-window
    layer always keeps its dense ring of ``window`` rows (its state is
    bounded already), and a full-attention layer without ``paged`` a dense
    ``max_len`` strip.  An MLA layer keeps its compressed ``max_len``
    strip, ``"hybrid"`` nests its ring and its Mamba state (``{"attn",
    "ssm"}``), and the xLSTM kinds keep their recurrent state."""
    _check_kind(kind)
    if kind in ("attn", "moe") and paged:
        return attn_mod.init_paged_gqa_cache(cfg, batch, num_pages, page_size,
                                             max_len, dtype, device)
    if kind == "mla_moe":
        return attn_mod.init_mla_cache(cfg, batch, max_len, dtype, device)
    if kind == "hybrid":
        return {"attn": attn_mod.init_gqa_cache(cfg, "local", batch, max_len,
                                                dtype, device, plan),
                "ssm": ssm_mod.init_mamba_cache(cfg, batch, dtype, device)}
    if kind == "mlstm":
        return ssm_mod.init_mlstm_cache(cfg, batch, device)
    if kind == "slstm":
        return ssm_mod.init_slstm_cache(cfg, batch, device)
    return attn_mod.init_gqa_cache(cfg, "local" if kind == "local" else
                                   "full", batch, max_len, dtype, device,
                                   plan)
