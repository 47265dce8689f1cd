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

Under a sharding recipe every block computes on this rank's pieces of its
weights (``sharding.param_specs``), as the reference's GSPMD layout does:

  * Megatron TP: attention's q/k/v and the MLPs' gate/up are
    column-parallel, o and down row-parallel, and a mixer's partial output
    is summed over the model axis (``sp_scatter``);
  * Megatron SP in prefill (``sp_enabled``): the residual stream between
    mixers is this rank's block of the sequence; ``sp_gather`` all-gathers
    it at a mixer's input and ``sp_scatter`` turns the output's all-reduce
    into a reduce-scatter;
  * expert parallelism (``apply_moe``): each rank holds E / tp experts;
    prefill ships tokens to their experts' ranks and back
    (``moe.ep_moe_local``), decode runs the rank's own experts on every
    token and sums over the model axis (``moe.ep_moe_decode_local``);
  * FSDP: leaves split over the FSDP axis are all-gathered at use
    (``sharding.leaf``)."""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from repro_torch import sharding as sh
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


# the reference's threshold for the sequence-parallel residual stream (SP
# pays only for models of at least this many parameters); the reduced
# configs' parity tests lower it to reach SP at a small width
SP_MIN_PARAMS = 1_000_000_000


def sp_enabled(cfg: ModelConfig, plan, seq_len: int,
               mode: str = "train") -> bool:
    """Whether the residual stream runs sequence-sharded for this cell (the
    reference's single source of truth for blocks, embedding and loss
    head): only over a model axis of more than one rank, for train or
    prefill, at a sequence length and a head count that axis divides, and
    for models of at least ``SP_MIN_PARAMS`` parameters."""
    if not (plan is not None and plan.mesh is not None
            and plan.model_axis is not None and mode in ("train", "prefill")):
        return False
    tp = plan.axis_size(plan.model_axis)
    if tp <= 1 or seq_len % tp:
        return False
    if cfg.num_heads % tp != 0:
        return False
    return cfg.param_count() >= SP_MIN_PARAMS


def sp_gather(x, plan, sp: bool):
    """The sequence-sharded residual (B, S/tp, D) to the full sequence at a
    mixer's input: an all-gather over the model axis (``x`` as it is
    without SP)."""
    return sh.all_gather(plan, x, plan.model_axis, 1) if sp else x


def sp_scatter(y, plan, sp: bool, partial: bool):
    """A mixer's output (B, S, D) to the residual's layout.  ``partial``:
    ``y`` is this rank's partial sum (its last product was row-parallel
    over the model axis).  Under SP a reduce-scatter gives this rank its
    block of the sequence (its block of ``y`` where ``y`` is whole);
    otherwise an all-reduce (nothing where ``y`` is whole)."""
    if plan is None or plan.mesh is None:
        return y
    model = plan.model_axis
    if sp:
        return sh.reduce_scatter(plan, y, model, 1) if partial \
            else sh.own_block(plan, y, model, 1)
    return sh.all_reduce(plan, y, model) if partial else y


def _mlp(mod, h, plan, sp: bool, names=("w_gate", "w_up", "w_down")):
    """Gated MLP on the full-sequence ``h`` (gate/up column-parallel, down
    row-parallel over the model axis), to the residual's layout."""
    wg, wu, wd = (sh.leaf(mod, n, plan) for n in names)
    return sp_scatter(swiglu(h, wg, wu, wd), plan, sp,
                      sh.split_on_model(plan, mod, names[2], 0))


def moe_route(cfg: ModelConfig, plan, mode: str, seq_len: int) -> str:
    """The reference's choice of MoE path, in every mode: ``"dense"``
    without expert parallelism (no mesh, ``ep`` off, a model axis of one
    rank or one that does not divide the experts); ``"ep_decode"`` in
    decode or where the model axis does not divide the sequence;
    ``"ep_prefill"`` otherwise (prefill and train)."""
    tp = plan.axis_size(plan.model_axis) \
        if plan is not None and plan.mesh is not None else 1
    if not (tp > 1 and plan.ep and cfg.moe.num_experts % tp == 0):
        return "dense"
    return "ep_decode" if mode == "decode" or seq_len % tp else "ep_prefill"


def apply_moe(moe: MoE, x, cfg: ModelConfig, plan=None, mode="prefill",
              sp: bool = False):
    """Routed experts plus the shared experts as a gated MLP.  Returns (y,
    aux_loss).  ``x`` is the normed residual in its layout (this rank's
    block of the sequence under SP), and so is ``y``.

    Routes (``moe_route``): ``dense_moe`` on this rank's tokens; EP decode,
    where every rank runs its own experts on every token and the outputs
    are summed over the model axis; EP prefill, where each rank routes its
    block of the sequence, ships the tokens over ``all_to_all`` to their
    experts' ranks and the outputs back (capacity-bounded, as in the
    reference: an assignment past an expert's capacity is dropped), and
    the blocks are all-gathered where the residual is whole.  The expert
    weights are gathered over the FSDP axis at use.  The shared experts
    run as a TP MLP on the full sequence.

    The load loss is the reference's on its mesh.  The dense route's is
    that of every token of the global batch: the routing fractions and
    mean probabilities are summed over the axes that split the tokens
    before their product.  EP prefill's is each rank's own (its tokens)
    averaged over the model axis and then over the data axes, as the
    reference's shard_map pmeans it; EP decode's is 0, as the
    reference's."""
    m = cfg.moe
    # the route follows the whole sequence's length, as the reference's
    S = x.shape[1] * (plan.axis_size(plan.model_axis) if sp else 1)
    route = moe_route(cfg, plan, mode, S)
    names = ("router", "we_gate", "we_up", "we_down")
    aux = x.new_zeros((), dtype=torch.float32)
    if route == "dense":
        routed = {k: sh.leaf(moe, k, plan, full=True) for k in names}
        # the serve modes drop the load loss: no collective for it there
        y, aux = moe_mod.dense_moe(routed, x, cfg, plan, sh.token_axes(
            plan, sp) if mode == "train" else ())
    else:
        routed = {k: sh.leaf(moe, k, plan) for k in names}
        model = plan.model_axis
        B, _, D = x.shape
        if route == "ep_decode":
            y = moe_mod.ep_moe_decode_local(routed, x.reshape(-1, D), cfg,
                                            plan).reshape(x.shape)
        else:
            xs = x if sp else sh.own_block(plan, x, model, 1)
            y, aux = moe_mod.ep_moe_local(routed, xs.reshape(-1, D), cfg,
                                          plan)
            if mode == "train":
                aux = sh.all_reduce(plan, aux, plan.data_axes) \
                    / sh.axes_size(plan, plan.data_axes)
            y = y.reshape(xs.shape)
            if not sp:
                y = sh.all_gather(plan, y, model, 1)
    if m.num_shared_experts:
        y = y + _mlp(moe, sp_gather(x, plan, sp), plan, sp,
                     ("ws_gate", "ws_up", "ws_down"))
    return y, aux


def apply_block(block: Block, x, positions, cfg: ModelConfig,
                cache: Optional[Dict], mode: str, write_mask=None,
                plan=None, sp: bool = False):
    """Returns (x, new_cache) in the serve modes, where an MoE block's aux
    loss is dropped; in ``"train"``, which builds no cache, (x, aux): the
    MoE load loss of ``"moe"`` / ``"mla_moe"`` blocks, a float32 0 for the
    others (the reference's third return value).  ``write_mask`` gates the
    attention caches' decode writes; recurrent states need none (a finished
    slot only corrupts its own state, which the engine replaces whole at
    refill).  With ``sp`` (``sp_enabled``) ``x`` is this rank's block of
    the sequence, gathered at each mixer's input and scattered after it,
    as the reference's ``sp_gather`` / ``sp_scatter``."""
    eps = cfg.norm_eps
    kind = block.kind
    train = mode == "train"
    h = sp_gather(rms_norm(x, sh.leaf(block, "ln1", plan), eps), plan, sp)
    if kind in ("mlstm", "slstm"):
        fn = ssm_mod.mlstm_apply if kind == "mlstm" else ssm_mod.slstm_apply
        y, new_cache = fn(block.core, h, cfg, cache, mode, plan=plan)
        x = x + sp_scatter(y, plan, sp, False)
        return x, _zero(x) if train else new_cache
    if kind == "mla_moe":
        a, new_cache = attn_mod.mla_apply(block.attn, h, positions, cfg,
                                          cache, mode, write_mask=write_mask,
                                          plan=plan)
    else:
        a, new_cache = attn_mod.gqa_apply(
            block.attn, h, positions, cfg,
            "local" if kind in ("local", "hybrid") else "full",
            cache["attn"] if kind == "hybrid" and cache else cache, mode,
            write_mask=write_mask, plan=plan)
    a = sp_scatter(a, plan, sp, sh.split_on_model(plan, block.attn, "wo", 0))
    if kind == "hybrid":
        s, ssm_cache = ssm_mod.mamba_apply(block.ssm, h, cfg,
                                           cache["ssm"] if cache else None,
                                           mode, plan=plan)
        a = 0.5 * (a + sp_scatter(s, plan, sp, False))
        new_cache = {"attn": new_cache, "ssm": ssm_cache}
    x = x + a
    h = rms_norm(x, sh.leaf(block, "ln2", plan), eps)
    aux = None
    if kind in _MOE_KINDS:
        f, aux = apply_moe(block.moe, h, cfg, plan, mode, sp)
    else:
        f = _mlp(block.mlp, sp_gather(h, plan, sp), plan, sp)
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
        return attn_mod.init_mla_cache(cfg, batch, max_len, dtype, device,
                                       plan)
    if kind == "hybrid":
        return {"attn": attn_mod.init_gqa_cache(cfg, "local", batch, max_len,
                                                dtype, device, plan),
                "ssm": ssm_mod.init_mamba_cache(cfg, batch, dtype, device,
                                                plan)}
    if kind == "mlstm":
        return ssm_mod.init_mlstm_cache(cfg, batch, device)
    if kind == "slstm":
        return ssm_mod.init_slstm_cache(cfg, batch, device)
    return attn_mod.init_gqa_cache(cfg, "local" if kind == "local" else
                                   "full", batch, max_len, dtype, device,
                                   plan)
