"""LM assembly: embedding → blocks → head (port of ``repro/models/model.py``
for the serve path).

Entry points:
  init_params      (cfg, generator, device) -> LM
  prefill_fn       (model, batch, cfg) -> (next_token, caches)
  decode_fn        (model, caches, token, pos, cfg) -> (next_token, caches)
  decode_block_fn  up to k fused greedy steps with on-device termination
  init_caches      paged decode caches

Caches keep the reference's stacked layout: ``caches["b{j}"]`` holds the
leaves of the j-th block of every layer group with a leading
``num_groups`` axis, so layer ``g * group_size + j`` reads index ``g``.
Decode updates the pools in place.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.core import embedding as emb
from repro_torch.core.kv_pages import pages_for
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import blocks as blk
from repro_torch.models.layers import dense_init, empty_param, rms_norm

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


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
    (untied heads) ``head.w_head`` — the reference pytree, unstacked."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        dtype = torch_dtype(cfg)
        v = emb.padded_vocab(cfg.vocab_size)
        self.embed = _Table("table", v, cfg.d_model, dtype, device)
        self.blocks = nn.ModuleList(
            blk.Block(cfg, kind, dtype, device) for kind in cfg.layer_pattern)
        self.final_norm = empty_param((cfg.d_model,), dtype, device)
        if not cfg.tie_embeddings:
            self.head = _Table("w_head", v, cfg.d_model, dtype, device)

    def head_table(self) -> torch.Tensor:
        return self.head.w_head if hasattr(self, "head") else self.embed.table


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> LM:
    """Random weights with the reference's distribution (truncated-normal
    fan-in init, zero norm scales, unit-std embedding), drawn from
    ``generator``, which must live on ``device`` (default CUDA)."""
    dev = resolve_device(device)
    dtype = torch_dtype(cfg)
    model = LM(cfg, dev)
    kw = dict(generator=generator, dtype=dtype, device=dev)
    with torch.no_grad():
        model.embed.table.copy_(dense_init(model.embed.table.shape,
                                           scale=1.0, **kw))
        for b in model.blocks:
            b.ln1.zero_()
            b.ln2.zero_()
            for name, t in attn_mod.gqa_params(cfg, **kw).items():
                getattr(b.attn, name).copy_(t)
            for name in ("w_gate", "w_up", "w_down"):
                w = getattr(b.mlp, name)
                w.copy_(dense_init(w.shape, **kw))
        model.final_norm.zero_()
        if not cfg.tie_embeddings:
            model.head.w_head.copy_(dense_init(model.head.w_head.shape, **kw))
    return model


def count_params(cfg: ModelConfig) -> int:
    return sum(p.numel() for p in LM(cfg, "meta").parameters())


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def run_blocks(model: LM, x, positions, cfg: ModelConfig, caches=None,
               mode: str = "prefill", write_mask=None):
    """x: (B, S, D).  Returns (x, caches): prefill builds stacked K/V
    caches, decode updates ``caches`` in place."""
    gpat = group_pattern(cfg)
    gs = len(gpat)
    out: Dict[str, Dict[str, list]] = {}
    for li, block in enumerate(model.blocks):
        g, j = divmod(li, gs)
        name = f"b{j}"
        c = None
        if caches is not None:
            c = {k: t[g] for k, t in caches[name].items()}
        x, nc = blk.apply_block(block, x, positions, cfg, c, mode,
                                write_mask=write_mask)
        if mode == "prefill":
            for k, t in nc.items():
                out.setdefault(name, {}).setdefault(k, []).append(t)
    if mode == "prefill":
        caches = {name: {k: torch.stack(ts) for k, ts in leaves.items()}
                  for name, leaves in out.items()}
    return x, caches


def prefill_fn(model: LM, batch: Dict[str, torch.Tensor], cfg: ModelConfig):
    """Full-sequence prefill.  Returns (next_token (B,) int32, caches).

    With ``batch["lengths"]`` (B,) the prompts are right-padded to a common
    S and row i samples at position ``lengths[i] - 1``; pad rows only
    attend forward, so the first ``lengths[i]`` cache rows are exact.
    """
    tokens = batch["tokens"]
    x = emb.gather_baseline(model.embed.table, tokens)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    x, caches = run_blocks(model, x, positions, cfg, None, "prefill")
    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    if "lengths" in batch:
        idx = batch["lengths"].long() - 1
        last = x[torch.arange(B, device=x.device), idx]
    else:
        last = x[:, -1]
    nxt = emb.greedy_sample(last, model.head_table(), cfg)
    return nxt, caches


def decode_fn(model: LM, caches, token, pos, cfg: ModelConfig,
              write_mask=None):
    """One decode step.  token: (B, 1) int32; pos: (B,) int32 per-slot
    positions against paged caches.  ``write_mask`` (B,) bool gates the
    cache writes per slot.  Returns (next_token (B,), caches)."""
    x = emb.gather_baseline(model.embed.table, token)
    positions = pos.to(torch.int32)
    x, caches = run_blocks(model, x, positions, cfg, caches, "decode",
                           write_mask=write_mask)
    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    nxt = emb.greedy_sample(x[:, -1], model.head_table(), cfg)
    return nxt, caches


def decode_block_fn(model: LM, caches, tokens, positions, alive, remaining,
                    cfg: ModelConfig, *, k_steps: int,
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
        nxt, caches = decode_fn(model, caches, tok[:, None], pos, cfg,
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


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                paged: bool = True, page_size: int = 16,
                num_pages: Optional[int] = None, device=None):
    """Stacked paged decode caches: per block of the group, ``kp``/``vp``
    (num_groups, num_pages + 1, page_size, Hkv, dh) and ``pages``
    (num_groups, batch, maxp) int32, all -1.  ``num_pages`` defaults to the
    dense worst case ``batch * pages_for(max_len, page_size)``."""
    if not paged:
        raise NotImplementedError("the strip KV layout is not ported yet")
    dev = resolve_device(device)
    dtype = torch_dtype(cfg)
    ng = num_groups(cfg)
    if num_pages is None:
        num_pages = batch * pages_for(max_len, page_size)
    out: Dict[str, Any] = {}
    for j, kind in enumerate(group_pattern(cfg)):
        one = blk.init_block_cache(cfg, kind, batch, max_len, dtype, dev,
                                   paged=True, num_pages=num_pages,
                                   page_size=page_size)
        out[f"b{j}"] = {k: t[None].repeat((ng,) + (1,) * t.dim())
                        for k, t in one.items()}
    return out
