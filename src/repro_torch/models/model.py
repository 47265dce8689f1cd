"""LM assembly: embedding → blocks → head (port of
``repro/models/model.py``).

Entry points:
  init_params      (cfg, generator, device) -> LM
  loss_fn          (model, batch, cfg, plan) -> (loss, metrics)   [train]
  prefill_fn       (model, batch, cfg, plan) -> (next_token, caches)
  decode_fn        (model, caches, token, pos, cfg, plan) -> (next_token, caches)
  decode_block_fn  up to k fused greedy steps with on-device termination
  prefill_chunk_fn (model, caches, tokens, qpos, last_idx, cfg) -> one chunk
                   of a chunked prefill for one slot
  init_caches      decode caches: shared or per-slot strips, paged pools

Caches keep the reference's stacked layout: ``caches["b{j}"]`` holds the
leaves of the j-th block of every layer group with a leading
``num_groups`` axis, so layer ``g * group_size + j`` reads index ``g``.
A block's cache may nest (``"hybrid"``: ``{"attn": ring, "ssm": state}``).
Decode updates the pools, strips and recurrent states in place.

``plan`` is a ShardingRecipe (``repro_torch.sharding``) or None.  Under a
recipe every rank of the mesh calls the entry point with the same global
inputs; it computes its own batch rows (by its coordinate on the batch
axes) on its pieces of the weights (``LM``, ``blocks``) against its
caches, which hold its batch rows, every KV head, over the sequence axes
its block of each dense strip and, for Mamba, its channels of the state
(paged pools are whole on every rank, which reads its block of their
strip view); prefill runs the Megatron-SP residual stream where
``blocks.sp_enabled``; the vocabulary lookups and the head go through the
ISP paths of ``core/embedding.py``; and the (B,) next tokens are gathered
back so that every rank returns the global result, as the reference's
global arrays do.  Training runs the same layouts (``loss_fn``: TP, SP,
EP, FSDP and the vocab-sharded lookup and loss head), and every
collective on the way carries its adjoint (``sharding``), so autograd
gives each rank its share of every gradient.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import sharding as sh
from repro_torch.analysis import op_trace
from repro_torch.config import ModelConfig
from repro_torch.core import embedding as emb
from repro_torch.core.kv_pages import pages_for
from repro_torch.device import resolve_device
from repro_torch.models import blocks as blk
from repro_torch.models.layers import dense_init, empty_param, rms_norm

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.dtype]


def group_pattern(cfg: ModelConfig) -> Tuple[str, ...]:
    return cfg.layer_pattern[: cfg.group_size]


def num_groups(cfg: ModelConfig) -> int:
    return cfg.num_layers // cfg.group_size


class _Table(nn.Module):
    def __init__(self, name: str, rows: int, cols: int, dtype, device):
        super().__init__()
        self.register_parameter(name, empty_param((rows, cols), dtype, device))


class LM(nn.Module):
    """Module state: ``embed.table``, ``blocks.{i}.*``, ``final_norm`` and
    (untied heads) ``head.w_head`` — the reference pytree, unstacked.  With
    a sharding ``plan`` every parameter is this rank's piece of it, as
    ``sharding.param_specs`` cuts it; ``specs`` holds each parameter's spec
    by name, and its owner module keeps the specs of its own leaves
    (``_specs``), which the blocks read at use (``sharding.leaf``)."""

    def __init__(self, cfg: ModelConfig, device=None, plan=None):
        super().__init__()
        dtype = torch_dtype(cfg)
        meta = torch.device("meta")
        self.embed = _Table("table", cfg.padded_vocab, cfg.d_model, dtype,
                            meta)
        self.blocks = nn.ModuleList(
            blk.Block(cfg, kind, dtype, meta) for kind in cfg.layer_pattern)
        self.final_norm = empty_param((cfg.d_model,), dtype, meta)
        if not cfg.tie_embeddings:
            self.head = _Table("w_head", cfg.padded_vocab, cfg.d_model, dtype,
                               meta)
        meshed = plan is not None and plan.mesh is not None
        self.specs = sh.param_specs(plan, {
            n: tuple(p.shape) for n, p in self.named_parameters()}) \
            if meshed else {}
        # materialise this rank's pieces on the device
        for name, p in list(self.named_parameters()):
            owner, _, leaf = name.rpartition(".")
            mod = self.get_submodule(owner) if owner else self
            spec = self.specs.get(name)
            shape = sh.local_shape(plan, spec, p.shape)
            setattr(mod, leaf, empty_param(shape, p.dtype, device))
            if sh.sharded(spec):
                mod.__dict__.setdefault("_specs", {})[leaf] = spec

    def head_table(self) -> torch.Tensor:
        return self.head.w_head if hasattr(self, "head") else self.embed.table


def _flat(tree: Dict[str, Any], prefix: str = ""):
    """(dotted path, leaf) pairs of a nested dict, as a state dict names
    them."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None, plan=None) -> LM:
    """Random weights with the reference's distribution (truncated-normal
    fan-in init, zero norm scales, unit-std embedding; each block as
    ``blocks.block_params`` draws it), drawn from ``generator``, which
    must live on ``device`` (default CUDA).  With a sharding ``plan`` each
    rank draws the same global weights, a block at a time, and keeps its
    pieces (``LM``), so every plan serves the same model."""
    dev = resolve_device(device)
    dtype = torch_dtype(cfg)
    model = LM(cfg, dev, plan)
    kw = dict(generator=generator, dtype=dtype, device=dev)

    def put(name, t):
        model.get_parameter(name).copy_(sh.cut(plan, model.specs.get(name),
                                               t))

    with torch.no_grad():
        put("embed.table", dense_init((cfg.padded_vocab, cfg.d_model),
                                      scale=1.0, **kw))
        for i, b in enumerate(model.blocks):
            for name, t in _flat(blk.block_params(cfg, b.kind, **kw)):
                put(f"blocks.{i}.{name}", t)
        model.final_norm.zero_()
        if not cfg.tie_embeddings:
            put("head.w_head", dense_init((cfg.padded_vocab, cfg.d_model),
                                          **kw))
    return model


def seeded_params(cfg: ModelConfig, seed: int, device=None) -> LM:
    """``init_params`` from ``seed`` on the CPU's generator, copied to
    ``device`` (default CUDA): the same weights on every device, where a
    generator on the device would draw other values."""
    dev = resolve_device(device)
    cpu = init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    if dev.type == "cpu":
        return cpu
    model = LM(cfg, dev)
    model.load_state_dict(cpu.state_dict())
    return model


def abstract_params(cfg: ModelConfig, plan=None) -> LM:
    """The model on the ``meta`` device: every parameter of its global
    shape or, under a sharding ``plan`` (a recipe with a mesh), of this
    rank's piece as ``sharding.param_specs`` cuts it.  Nothing is
    allocated (the reference's ``jax.eval_shape`` of ``init_params``)."""
    return LM(cfg, "meta", plan)


def _shapes(cfg: ModelConfig) -> Dict[str, torch.Size]:
    """Every parameter's global shape by name (built on ``meta`` outside
    any recorder: the counts below are not part of a step)."""
    with op_trace.paused():
        return {n: p.shape for n, p in
                abstract_params(cfg).named_parameters()}


@functools.lru_cache(maxsize=None)
def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    """Parameters of the model; with ``active_only`` the routed experts'
    ``we_*`` count ``top_k / num_experts`` of their size, as in the
    reference."""
    total = 0
    for name, shape in _shapes(cfg).items():
        n = math.prod(shape)
        if active_only and cfg.moe and name.rsplit(".", 1)[-1].startswith(
                "we_"):
            n = n * cfg.moe.top_k // cfg.moe.num_experts
        total += n
    return total


@functools.lru_cache(maxsize=None)
def count_flops_params(cfg: ModelConfig, active_only: bool = True) -> int:
    """The parameters that enter the 6·N·D estimate: every leaf but the
    embedding table and the head, routed experts ``we_*`` at ``top_k /
    num_experts`` of their size with ``active_only`` (the reference's
    definition)."""
    total = 0
    for name, shape in _shapes(cfg).items():
        if name.split(".", 1)[0] in ("embed", "head"):
            continue
        n = math.prod(shape)
        if active_only and cfg.moe and name.rsplit(".", 1)[-1].startswith(
                "we_"):
            n = n * cfg.moe.top_k // cfg.moe.num_experts
        total += n
    return total


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _tree_map(fn, tree):
    """``fn`` on every tensor of a nested cache dict."""
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _stack(trees):
    """Per-layer cache trees of one block position -> one tree with a
    leading ``num_groups`` axis."""
    return {k: _stack([t[k] for t in trees]) if isinstance(v, dict)
            else torch.stack([t[k] for t in trees])
            for k, v in trees[0].items()}


def run_blocks(model: LM, x, positions, cfg: ModelConfig, caches=None,
               mode: str = "prefill", write_mask=None, plan=None,
               sp: bool = False):
    """x: (B, S, D).  Returns (x, caches): prefill builds stacked K/V
    caches, decode and chunk update ``caches`` in place.  ``"train"``
    builds none and returns (x, aux), the MoE load losses of all blocks
    summed in float32.  With ``sp`` (``blocks.sp_enabled``, prefill or
    train under a plan) ``x`` and the returned x are this rank's block of
    the sequence: the Megatron-SP residual stream.

    In train with ``cfg.remat`` "dots" or "full", each block runs under
    non-reentrant ``torch.utils.checkpoint``: its activations are dropped
    after the forward and recomputed in the backward (the flash kernel
    launches again there, and the block's collectives run again, in the
    same order on every rank).  The reference checkpoints each layer group,
    with ``dots_with_no_batch_dims_saveable`` for "dots"; PyTorch has no
    such policy, so "dots" recomputes the products too.  The gradients
    are the same either way; only memory and time differ."""
    if mode == "train":
        aux = x.new_zeros((), dtype=torch.float32)
        remat = cfg.remat in ("dots", "full")
        for block in model.blocks:
            def run(h, block=block):
                return blk.apply_block(block, h, positions, cfg, None,
                                       "train", plan=plan, sp=sp)
            x, a = checkpoint(run, x, use_reentrant=False) if remat \
                else run(x)
            aux = aux + a
        return x, aux
    gpat = group_pattern(cfg)
    gs = len(gpat)
    out: Dict[str, list] = {}
    for li, block in enumerate(model.blocks):
        g, j = divmod(li, gs)
        name = f"b{j}"
        c = None
        if caches is not None:
            c = _tree_map(lambda t: t[g], caches[name])
        x, nc = blk.apply_block(block, x, positions, cfg, c, mode,
                                write_mask=write_mask, plan=plan, sp=sp)
        if mode == "prefill":
            out.setdefault(name, []).append(nc)
    if mode == "prefill":
        caches = {name: _stack(trees) for name, trees in out.items()}
    return x, caches


def loss_fn(model: LM, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            plan=None):
    """batch: {tokens (B, S) | embeddings (B, S, D), labels (B, S)}.
    Returns (loss, {"xent", "aux", "tokens"}), as the reference's: the
    mean cross-entropy over labels >= 0 (negative labels are masked, their
    rows clamped to 0), the MoE load loss summed over blocks and divided
    by the number of layer groups, and loss = xent + aux_loss_coef * aux.
    ``embeddings`` (a frontend's output) is cast to the model dtype and
    used in place of the lookup.

    Under a recipe every rank passes the same global batch and computes
    on its batch rows, with the Megatron-SP residual stream where
    ``blocks.sp_enabled`` (the embedding arrives as this rank's block of
    the sequence, the loss head takes the block and its labels) and the
    vocab-sharded loss head; the masked sum and the token count are summed
    over the axes that split the tokens (the batch axes, and the model
    axis under SP), so the mean is the global one, as the reference's
    ``denom`` is.  The loss and metrics come back the same on every rank;
    the train step seeds each rank's loss with 1 / (ranks in the mesh)
    (``launch.steps``)."""
    frontend = "embeddings" in batch
    B, S = batch["embeddings" if frontend else "tokens"].shape[:2]
    rows = sh.batch_rows(plan, B)
    sp = blk.sp_enabled(cfg, plan, S, "train")
    if frontend:
        x = batch["embeddings"][rows].to(torch_dtype(cfg))
        if sp:
            x = sh.own_block(plan, x, plan.model_axis, 1)
    else:
        x = emb.embed_lookup(model.embed.table, batch["tokens"][rows], cfg,
                             plan, seq_sharded=sp)
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    x, aux = run_blocks(model, x, positions, cfg, None, "train", plan=plan,
                        sp=sp)
    x = rms_norm(x, sh.leaf(model, "final_norm", plan), cfg.norm_eps)
    labels = batch["labels"][rows]
    if sp:
        labels = sh.own_block(plan, labels, plan.model_axis, 1)
    per_tok = emb.sharded_xent(x, model.head_table(),
                               torch.clamp(labels, min=0), cfg, plan,
                               seq_sharded=sp)
    mask = (labels >= 0).float()
    axes = sh.token_axes(plan, sp)
    denom = torch.clamp(sh.all_reduce(plan, mask.sum(), axes), min=1.0)
    xent = sh.all_reduce(plan, (per_tok * mask).sum(), axes) / denom
    aux_coef = cfg.moe.aux_loss_coef if cfg.moe else 0.0
    aux = aux / max(cfg.num_layers // cfg.group_size, 1)
    loss = xent + aux_coef * aux
    return loss, {"xent": xent, "aux": aux, "tokens": denom}


def prefill_fn(model: LM, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
               plan=None):
    """Full-sequence prefill.  Returns (next_token (B,) int32, caches).

    The batch holds ``tokens`` (B, S) int32 or, for a modality frontend's
    output, ``embeddings`` (B, S, D), cast to the model dtype and used in
    place of the embedding lookup.  With ``batch["lengths"]`` (B,) the
    prompts are right-padded to a common S and row i samples at position
    ``lengths[i] - 1``; pad rows only attend forward, so the first
    ``lengths[i]`` cache rows are exact.
    """
    frontend = "embeddings" in batch
    B, S = batch["embeddings" if frontend else "tokens"].shape[:2]
    rows = sh.batch_rows(plan, B)
    sp = blk.sp_enabled(cfg, plan, S, "prefill")
    if frontend:
        x = batch["embeddings"][rows].to(torch_dtype(cfg))
        if sp:
            x = sh.own_block(plan, x, plan.model_axis, 1)
    else:
        x = emb.embed_lookup(model.embed.table, batch["tokens"][rows], cfg,
                             plan, seq_sharded=sp)
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    x, caches = run_blocks(model, x, positions, cfg, None, "prefill",
                           plan=plan, sp=sp)
    x = blk.sp_gather(x, plan, sp)
    x = rms_norm(x, sh.leaf(model, "final_norm", plan), cfg.norm_eps)
    if "lengths" in batch:
        idx = batch["lengths"][rows].long() - 1
        last = x[torch.arange(x.shape[0], device=x.device), idx]
    else:
        last = x[:, -1]
    nxt = emb.greedy_sample(last, model.head_table(), cfg, plan)
    return sh.gather_batch(plan, nxt, B), caches


def decode_fn(model: LM, caches, token, pos, cfg: ModelConfig, plan=None,
              write_mask=None):
    """One decode step.  token: (B, 1) int32; pos: () int32, one position
    for the whole batch against shared-track caches, or (B,) int32
    per-slot positions against per-slot caches (the serve engine's).
    ``write_mask`` (B,) bool gates the per-slot cache writes.  Returns
    (next_token (B,), caches)."""
    B = token.shape[0]
    pos = torch.as_tensor(pos, device=token.device)
    if plan is not None:
        rows = sh.batch_rows(plan, B)
        token = token[rows]
        pos = pos[rows] if pos.dim() == 1 else pos
        write_mask = None if write_mask is None else write_mask[rows]
    x = emb.embed_lookup(model.embed.table, token, cfg, plan,
                         seq_sharded=False)
    positions = (pos[None] if pos.dim() == 0 else pos).to(torch.int32)
    x, caches = run_blocks(model, x, positions, cfg, caches, "decode",
                           write_mask=write_mask, plan=plan)
    x = rms_norm(x, sh.leaf(model, "final_norm", plan), cfg.norm_eps)
    nxt = emb.greedy_sample(x[:, -1], model.head_table(), cfg, plan)
    return sh.gather_batch(plan, nxt, B), caches


def decode_block_fn(model: LM, caches, tokens, positions, alive, remaining,
                    cfg: ModelConfig, plan=None, *, k_steps: int,
                    eos_id: Optional[int], max_len: int):
    """Up to ``k_steps`` greedy decode steps with sampling, per-slot
    position increments, EOS / max-new / max-len termination masks and KV
    writes on the device.  The reference runs this as a ``lax.while_loop``;
    here it is an eager loop with the same semantics: the same early exit
    once no slot is alive, the same write mask (finished slots write to the
    scratch page), and the same (K, B) block with -1 where a slot emitted
    nothing.

    Returns (out (K, B) int32, n_steps, tokens, positions, alive,
    remaining, caches).
    """
    B = tokens.shape[0]
    dev = tokens.device
    out = torch.full((k_steps, B), -1, dtype=torch.int32, device=dev)
    tok = tokens.to(torch.int32)
    pos = positions.to(torch.int32)
    rem = remaining.to(torch.int32)
    minus1 = torch.full((B,), -1, dtype=torch.int32, device=dev)
    i = 0
    while i < k_steps and bool(alive.any()):
        nxt, caches = decode_fn(model, caches, tok[:, None], pos, cfg, plan,
                                write_mask=alive)
        nxt = nxt.to(torch.int32)
        out[i] = torch.where(alive, nxt, minus1)
        pos = torch.where(alive, pos + 1, pos)
        rem = torch.where(alive, rem - 1, rem)
        done = (pos >= max_len - 1) | (rem <= 0)
        if eos_id is not None:
            done = done | (nxt == eos_id)
        tok = torch.where(alive, nxt, tok)
        alive = alive & ~done
        i += 1
    return out, i, tok, pos, alive, rem, caches


def prefill_chunk_fn(model: LM, caches, tokens, qpos, last_idx,
                     cfg: ModelConfig, plan=None):
    """One chunk of a chunked prefill for a single slot.

    tokens: (1, C) int32 chunk token ids (pad rows 0); qpos: (1, C) int32
    logical positions of each row (-1 = pad); last_idx: (1,) int32 index
    of the chunk's last real row, where the next token samples (only the
    last chunk's sample is used).  ``caches`` is a pool view whose
    ``pages`` leaves are the slot's page-table row ((num_groups, 1, maxp))
    over the shared kp/vp pools, which the chunk's rows are written into
    in place.  Needs a paged stack of full-attention layers (the engine
    gates chunking on that).  Under a recipe (``plan``) every rank runs
    the one slot's chunk on its weight pieces against its copy of the
    pools.  Returns (next_token (1,), caches).
    """
    x = emb.embed_lookup(model.embed.table, tokens, cfg, plan,
                         seq_sharded=False)
    x, caches = run_blocks(model, x, qpos.to(torch.int32), cfg, caches,
                           "chunk", plan=plan)
    x = rms_norm(x, sh.leaf(model, "final_norm", plan), cfg.norm_eps)
    last = x[torch.arange(x.shape[0], device=x.device), last_idx.long()]
    return emb.greedy_sample(last, model.head_table(), cfg, plan), caches


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                per_slot: bool = False, paged: bool = False,
                page_size: int = 16, num_pages: Optional[int] = None,
                device=None, plan=None):
    """Stacked decode caches: per block of the group, leaves with a leading
    ``num_groups`` axis.

    Full-attention layers get a dense ``max_len`` strip, sliding-window
    layers a ring of ``window`` rows, each with a position track ``kpos``
    that starts empty (-1): one shared track (num_groups, S) for
    uniform-position decode, or with ``per_slot=True`` one per slot
    (num_groups, batch, S), as the serve engine needs.  ``paged=True``
    (implies per-slot) gives full-attention layers paged pools instead:
    ``kp``/``vp`` (num_groups, num_pages + 1, page_size, Hkv, dh) and
    ``pages`` (num_groups, batch, maxp), all -1; ``num_pages`` defaults to
    the dense worst case ``batch * pages_for(max_len, page_size)``.  MLA
    layers keep their compressed ``ckv``/``krope`` strips with a position
    track, ``"hybrid"`` blocks nest their ring (``attn``, with its track)
    and their Mamba state (``ssm``), and the xLSTM kinds hold their
    recurrent state per slot (no track).

    Under a recipe (``plan``) the caches are this rank's: its batch rows
    and, over the sequence axes, its block of each dense strip (the paged
    pools and page tables whole, as the engine's host state is)."""
    dev = resolve_device(device)
    dtype = torch_dtype(cfg)
    ng = num_groups(cfg)
    if plan is not None:
        rows = sh.batch_rows(plan, batch)
        batch = rows.stop - rows.start
    if paged:
        per_slot = True
        if num_pages is None:
            num_pages = batch * pages_for(max_len, page_size)

    def per_slot_kpos(tree):
        return {k: per_slot_kpos(v) if isinstance(v, dict)
                else v[None].repeat(batch, 1) if k == "kpos" else v
                for k, v in tree.items()}

    out: Dict[str, Any] = {}
    for j, kind in enumerate(group_pattern(cfg)):
        one = blk.init_block_cache(cfg, kind, batch, max_len, dtype, dev,
                                   paged=paged, num_pages=num_pages or 0,
                                   page_size=page_size, plan=plan)
        if per_slot:
            one = per_slot_kpos(one)
        out[f"b{j}"] = _tree_map(
            lambda t: t[None].repeat((ng,) + (1,) * t.dim()), one)
    return out


def abstract_caches(cfg: ModelConfig, batch: int, max_len: int,
                    per_slot: bool = False, paged: bool = False,
                    page_size: int = 16, num_pages: Optional[int] = None,
                    plan=None):
    """``init_caches`` on the ``meta`` device: the caches' shapes and
    dtypes (this rank's under a ``plan``), nothing allocated."""
    return init_caches(cfg, batch, max_len, per_slot, paged, page_size,
                       num_pages, device="meta", plan=plan)


def input_specs(cfg: ModelConfig, shape, plan=None) -> Dict[str, Any]:
    """``meta`` stand-ins for every input of an (arch, shape) cell, with the
    reference's keys and dtypes: ``tokens`` and ``labels`` (B, S) int32
    for train (``embeddings`` (B, S, D) in the model dtype for a frontend
    arch), ``tokens`` or ``embeddings`` for prefill, and for decode one
    ``token`` (B, 1) int32 at one position ``pos`` () int32 against the
    dense caches of S rows (this rank's under a ``plan``).  Every rank is
    given the global batch, as the port's steps take it."""
    B, S = shape.global_batch, shape.seq_len
    meta = torch.device("meta")
    i32 = torch.int32

    def ids(*dims):
        return torch.empty(dims, dtype=i32, device=meta)
    if shape.kind in ("train", "prefill"):
        if cfg.frontend:
            out = {"embeddings": torch.empty((B, S, cfg.d_model),
                                             dtype=torch_dtype(cfg),
                                             device=meta)}
        else:
            out = {"tokens": ids(B, S)}
        if shape.kind == "train":
            out["labels"] = ids(B, S)
        return out
    return {"token": ids(B, 1), "pos": ids(),
            "caches": abstract_caches(cfg, B, S, plan=plan)}
