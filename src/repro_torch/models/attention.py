"""Attention layers (port of ``repro/models/attention.py``): GQA, full and
sliding-window (``gqa_apply``), and DeepSeek-style multi-head latent
attention with a compressed KV cache (``mla_apply``, at the end of this
module).

Four entry modes:
  train    — full-sequence causal attention as in prefill, through the
             differentiable ``ops.flash_attention`` (the kernel's forward,
             the plain chunked backward), building no cache;
  prefill  — full-sequence causal attention (flash kernel), emits the
             sequence's K/V: the whole sequence for a full-attention layer,
             the last ``window`` rows as a ring (slot = pos % window) for a
             sliding-window layer;
  decode   — one new token per slot, written into the cache first, then
             attended: against a paged pool (paged-decode kernel) or a
             dense strip with explicit key positions ``kpos`` (isp-decode
             kernel), either per slot (kpos (B, S), the serve engine) or
             shared (kpos (S,), uniform-position decode);
  chunk    — one chunk of a chunked prefill at explicit (B, C) positions
             (-1 = pad row): its rows are scattered into the slot's pages
             first, then each row attends to the cached prefix and the
             chunk's own causal prefix (the plain masked chunk attention,
             which the reference also runs on every backend).

The window and the RoPE base follow the layer's kind: ``"local"`` layers
use ``cfg.attn.window`` and ``rope_base_local``, full layers no window and
``rope_base``.  Parameters keep the reference's layouts: wq (D, H, dh),
wk/wv (D, Hkv, dh), wo (H, dh, D).  Activations are (B, S, H, dh).  Decode
updates the caches in place where the reference returned new arrays.

Under a recipe the projections are this rank's pieces
(``sharding.param_specs``): Megatron column-parallel q/k/v (MLA's
``wq_b``/``wk_b``/``wv_b``) over the heads the model axis splits and a
row-parallel o, whose partial sum the block reduces.  Under a
sequence-sharded recipe (``plan.seq_axes``) a dense strip — MLA's
compressed one too — is held as this rank's contiguous block of rows,
``(B, S/n, Hkv, dh)`` and its kpos, with every KV head, so the KV bytes
stay on the rank that owns them: decode writes a position's row only on
the rank owning its strip row, and prefill keeps each rank's block of the
rows it computed.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from repro_torch import sharding as sh
from repro_torch.config import ModelConfig
from repro_torch.core.decode_attention import (chunk_prefill_attention,
                                               decode_attention, mla_absorb,
                                               mla_decode_absorbed,
                                               paged_decode_attention)
from repro_torch.core.kv_pages import pages_for, scatter_rows
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import (apply_rope, dense_init, empty_param,
                                      rms_norm)


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


def seq_shard(plan, s: int = 0):
    """(r, n): this rank's block ``r`` of a strip split over the recipe's
    sequence axes into ``n`` blocks; (0, 1) unsharded.  A strip of ``s``
    rows must split evenly: the reference cannot split it otherwise."""
    if plan is None or plan.mesh is None or not plan.seq_axes:
        return 0, 1
    n = sh.axes_size(plan, plan.seq_axes)
    if s % n:
        raise ValueError(f"a strip of {s} rows does not split over the "
                         f"sequence axes {plan.seq_axes} ({n} ranks)")
    return sh.axis_index(plan, plan.seq_axes), n


def init_gqa_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                   dtype, device, plan=None):
    """Dense decode strip of one layer: ``window`` rows for a
    sliding-window layer (a ring, slot = pos % window), ``max_len`` rows
    otherwise, with a shared position track ``kpos`` (-1 = empty).  Under a
    sequence-sharded recipe, this rank's block of the rows."""
    window = cfg.attn.window if kind == "local" else None
    s = window if window else max_len
    s //= seq_shard(plan, s)[1]
    hkv, dh = cfg.num_kv_heads, cfg.resolved_head_dim
    return {
        "k": torch.zeros((batch, s, hkv, dh), dtype=dtype, device=device),
        "v": torch.zeros((batch, s, hkv, dh), dtype=dtype, device=device),
        "kpos": torch.full((s,), -1, dtype=torch.int32, device=device),
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


def _paged_cache(cache) -> bool:
    """Whether this decode cache is the paged-pool layout (pools + per-slot
    page table) rather than dense strips."""
    return "pages" in cache


def _per_slot_cache(cache) -> bool:
    """Whether this decode cache keeps one position track per batch slot
    (kpos (B, S), or a paged page table) — the serve engine's layout — vs
    one shared track (kpos (S,)) for uniform-position decode."""
    return _paged_cache(cache) or cache["kpos"].dim() == 2


def _decode_positions(positions, batch: int, cache, mode: str):
    """(per_slot, posb, rope_pos): per-slot (B,) positions against a
    per-slot cache, the explicit (B, C) positions of a prefill chunk, or
    the shared (1, S) rope layout of prefill and uniform decode."""
    if mode == "chunk":
        return False, None, positions.to(torch.int32)
    if mode == "decode" and cache is not None and _per_slot_cache(cache):
        posb = positions.expand(batch).to(torch.int32)
        return True, posb, posb[:, None]
    return False, None, positions[None, :]


def _ring_slot(pos, s: int, ring: bool):
    """Strip row of position ``pos``: ``pos % s`` in a ring, else ``pos``
    capped at the last row."""
    return pos % s if ring else torch.clamp(pos, max=s - 1)


def _ring_update(cache, new_vals, pos, ring: bool, shard=(0, 1)):
    """Uniform decode: write every slot's (1, ...) row of each ``new_vals``
    leaf (``k``/``v``, or MLA's ``ckv``/``krope``) at the shared position
    ``pos`` (0-dim) and stamp the shared track, in place.  With ``shard =
    (r, n)`` the cache is block ``r`` of ``n``: only the rank owning the
    position's strip row writes (the others rewrite the row they hold at
    the clamped index)."""
    r, n = shard
    s = cache["kpos"].shape[0]
    slot = _ring_slot(pos, s * n, ring).reshape(1).long()
    pos = pos.reshape(1).to(torch.int32)
    own = None
    if n > 1:
        slot = slot - r * s
        own = (slot >= 0) & (slot < s)
        slot = torch.clamp(slot, 0, s - 1)
        pos = torch.where(own, pos, cache["kpos"].index_select(0, slot))
    for name, val in new_vals.items():
        val = val.to(cache[name].dtype)
        if own is not None:
            val = torch.where(own, val, cache[name].index_select(1, slot))
        cache[name].index_copy_(1, slot, val)
    cache["kpos"].index_copy_(0, slot, pos)
    return cache


def _slot_update(cache, new_vals, posb, ring: bool, write_mask=None,
                 shard=(0, 1)):
    """Per-slot decode: write each slot's (1, ...) row at its own position
    and stamp its kpos track, in place.  ``write_mask`` (B,) keeps masked
    slots' rows and stamps untouched (slots that finished mid-way through a
    K-step block); with ``shard = (r, n)`` so are the slots whose row lies
    in another rank's block."""
    r, n = shard
    s = cache["kpos"].shape[1]
    slot = _ring_slot(posb, s * n, ring).long()
    if n > 1:
        slot = slot - r * s
        own = (slot >= 0) & (slot < s)
        slot = torch.clamp(slot, 0, s - 1)
        write_mask = own if write_mask is None else write_mask & own
    bidx = torch.arange(posb.shape[0], device=posb.device)
    for name, val in new_vals.items():
        row = val[:, 0].to(cache[name].dtype)
        if write_mask is not None:
            keep = write_mask.reshape((-1,) + (1,) * (row.dim() - 1))
            row = torch.where(keep, row, cache[name][bidx, slot])
        cache[name][bidx, slot] = row
    stamp = posb if write_mask is None else \
        torch.where(write_mask, posb, cache["kpos"][bidx, slot])
    cache["kpos"][bidx, slot] = stamp
    return cache


def _ring_prefill_cache(k, v, window: int):
    """The decode ring of a sliding-window layer after a prefill of ``sq``
    rows: the last ``min(window, sq)`` rows rolled so that slot = pos %
    window, padded with empty rows (kpos -1) up to ``window``."""
    sq = k.shape[1]
    w = min(window, sq)
    ck, cv = k[:, sq - w:], v[:, sq - w:]
    kpos = torch.arange(sq - w, sq, dtype=torch.int32, device=k.device)
    roll = (sq % window) if sq >= window else 0
    ck = torch.roll(ck, roll, dims=1)
    cv = torch.roll(cv, roll, dims=1)
    kpos = torch.roll(kpos, roll, dims=0)
    if w < window:
        pad = window - w
        zeros = ck.new_zeros((ck.shape[0], pad) + tuple(ck.shape[2:]))
        ck = torch.cat([ck, zeros], dim=1)
        cv = torch.cat([cv, zeros], dim=1)
        kpos = torch.cat([kpos, kpos.new_full((pad,), -1)])
    return {"k": ck, "v": cv, "kpos": kpos}


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


def _paged_chunk_update(cache, k_new, v_new, positions):
    """Scatter a whole chunk of rows (B, C, hkv, dh) into the paged pools
    at their logical positions, in place (-1 = pad row, routed to the
    scratch page)."""
    scatter_rows(cache["kp"], cache["pages"], positions, k_new)
    scatter_rows(cache["vp"], cache["pages"], positions, v_new)
    return cache


def _project(x, w):
    """(B, S, D) @ (D, H, dh) -> (B, S, H, dh)."""
    B, S, D = x.shape
    return (x.reshape(B * S, D) @ w.reshape(D, -1)).reshape(
        B, S, w.shape[1], w.shape[2])


def _seq_block(cache, plan):
    """This rank's block of the rows of a prefill cache (all of them
    unsharded): the strip leaves on their row axis (1), the track on 0."""
    r, n = seq_shard(plan, cache["kpos"].shape[0])
    if n == 1:
        return cache
    return {name: t.chunk(n, dim=0 if name == "kpos" else 1)[r]
            for name, t in cache.items()}


def _kv_for_heads(k, k_all, heads, cfg: ModelConfig, q_split: bool,
                  kv_split: bool):
    """The K (or V) heads that this rank's query heads ``heads`` = (q0, q1)
    read: its own KV heads where both are split over the model axis (each
    rank's query heads share its KV heads), all of them where the query
    heads are whole, else the KV heads of its query heads out of
    ``k_all`` — a slice where they are whole GQA groups, one KV head per
    query head otherwise."""
    if not q_split:
        return k_all
    if kv_split:
        return k
    q0, q1 = heads
    g = cfg.num_heads // cfg.num_kv_heads
    if q0 % g == 0 and (q1 - q0) % g == 0:
        return k_all[:, :, q0 // g:q1 // g]
    idx = torch.arange(q0, q1, device=k_all.device) // g
    return k_all.index_select(2, idx)


def gqa_apply(attn: GQA, x, positions, cfg: ModelConfig, kind: str = "full",
              cache: Optional[Dict] = None, mode: str = "prefill",
              write_mask=None, plan=None):
    """x: (B, S, D); ``kind`` "full" or "local".  prefill: positions (S,);
    decode: per-slot (B,) positions against a per-slot cache (paged pool or
    kpos (B, S) strips), or one shared position (1,) against a kpos (S,)
    strip; chunk: (B, C) positions of a prefill chunk against a paged pool.
    ``write_mask`` (B,) bool gates per-slot cache writes.  train:
    positions (S,), prefill's attention with no cache.

    Under a ``plan`` (a ShardingRecipe) the projections are this rank's
    pieces: q/k/v column-parallel over the heads the model axis splits, o
    row-parallel, so the output is this rank's partial sum where ``wo`` is
    split (the block reduces it, ``blocks.sp_scatter``).  The caches keep
    the reference's layout — every KV head, this rank's batch rows and its
    block of each strip over the sequence axes — so the new K/V heads are
    all-gathered over the model axis before they are written.  Prefill runs
    flash on this rank's query heads; decode and chunks gather q to every
    head first (the sequence-sharded decode takes q whole, as the
    reference's shard_map does), attend, and keep this rank's heads for o.
    Returns (out (B, S, D), new_cache), new_cache None in train."""
    if mode not in ("train", "prefill", "decode", "chunk"):
        raise NotImplementedError(f"attention mode {mode!r} is not ported")
    window = cfg.attn.window if kind == "local" else None
    rope_base = cfg.attn.rope_base_local if kind == "local" \
        else cfg.attn.rope_base
    B, S, _ = x.shape
    per_slot, posb, rope_pos = _decode_positions(positions, B, cache, mode)
    q_split = sh.split_on_model(plan, attn, "wq", 1)
    kv_split = sh.split_on_model(plan, attn, "wk", 1)
    heads = sh.tp_split(plan, cfg.num_heads) if q_split \
        else (0, cfg.num_heads)
    model = plan.model_axis if plan is not None else None

    q = apply_rope(_project(x, sh.leaf(attn, "wq", plan)), rope_pos,
                   rope_base)
    k = apply_rope(_project(x, sh.leaf(attn, "wk", plan)), rope_pos,
                   rope_base)
    v = _project(x, sh.leaf(attn, "wv", plan))
    k_all, v_all = k, v
    if kv_split and mode != "train":
        k_all = sh.all_gather(plan, k, model, 2)
        v_all = sh.all_gather(plan, v, model, 2)
    if mode in ("chunk", "decode") and q_split:
        q = sh.all_gather(plan, q, model, 2)

    if mode == "chunk":
        if cache is None or not _paged_cache(cache) or window is not None:
            raise ValueError("chunked prefill needs the paged "
                             "full-attention layout")
        new_cache = _paged_chunk_update(cache, k_all, v_all, positions)
        out_h = chunk_prefill_attention(q, cache["kp"], cache["vp"],
                                        cache["pages"], positions)
    elif mode == "decode":
        if cache is None:
            raise ValueError("decode needs a cache")
        if _paged_cache(cache):
            if window is not None:
                raise ValueError("paged KV applies to full-attention layers")
            new_cache = _paged_update(cache, k_all, v_all, posb, write_mask)
            out_h = paged_decode_attention(q[:, 0], cache["kp"], cache["vp"],
                                           cache["pages"], posb, window=None,
                                           plan=plan)
        else:
            ring = window is not None
            shard = seq_shard(plan)
            new_vals = {"k": k_all, "v": v_all}
            if per_slot:
                new_cache = _slot_update(cache, new_vals, posb, ring,
                                         write_mask, shard)
                pos = posb
            else:
                pos = positions[0]
                new_cache = _ring_update(cache, new_vals, pos, ring, shard)
            out_h = decode_attention(q[:, 0], new_cache["k"], new_cache["v"],
                                     new_cache["kpos"], pos, window=window,
                                     plan=plan)
        out_h = out_h[:, None]                                # (B,1,H,dh)
    else:
        out_h = kops.flash_attention(
            q, _kv_for_heads(k, k_all, heads, cfg, q_split, kv_split),
            _kv_for_heads(v, v_all, heads, cfg, q_split, kv_split),
            causal=True, window=window, q_chunk=cfg.attn_chunk,
            kv_chunk=cfg.attn_chunk)
        if mode == "train":
            new_cache = None
        elif window is not None:
            new_cache = _ring_prefill_cache(k_all, v_all, window)
        else:
            new_cache = {"k": k_all, "v": v_all,
                         "kpos": torch.arange(S, dtype=torch.int32,
                                              device=x.device)}
        if new_cache is not None:
            new_cache = _seq_block(new_cache, plan)
    if mode in ("chunk", "decode") and q_split:
        out_h = out_h[:, :, heads[0]:heads[1]]
    wo = sh.leaf(attn, "wo", plan)
    H, dh, D = wo.shape
    out = out_h.to(x.dtype).reshape(B * S, H * dh) @ wo.reshape(H * dh, D)
    return out.reshape(B, S, D), new_cache


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------


class MLA(nn.Module):
    """One layer's MLA projections in the reference's layouts: ``wkv_a``
    (D, R + r) to the compressed KV and the rope key, ``kv_norm`` (R,),
    ``wk_b`` (R, H, nope) / ``wv_b`` (R, H, v) up from it, ``wo`` (H, v, D),
    and the query through a low-rank ``wq_a`` (D, Rq), ``q_norm``, ``wq_b``
    (Rq, H, nope + rope), or a full-rank ``wq`` (D, H, nope + rope) when
    ``q_lora_rank`` is 0."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        for name, shape in _mla_shapes(cfg).items():
            setattr(self, name, empty_param(shape, dtype, device))


def _mla_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    a = cfg.attn
    d, h = cfg.d_model, cfg.num_heads
    qk = a.qk_nope_dim + a.qk_rope_dim
    shapes = {
        "wkv_a": (d, a.kv_lora_rank + a.qk_rope_dim),
        "kv_norm": (a.kv_lora_rank,),
        "wk_b": (a.kv_lora_rank, h, a.qk_nope_dim),
        "wv_b": (a.kv_lora_rank, h, a.v_head_dim),
        "wo": (h, a.v_head_dim, d),
    }
    if a.q_lora_rank:
        shapes.update(wq_a=(d, a.q_lora_rank), q_norm=(a.q_lora_rank,),
                      wq_b=(a.q_lora_rank, h, qk))
    else:
        shapes["wq"] = (d, h, qk)
    return shapes


def mla_params(cfg: ModelConfig, generator: torch.Generator, dtype,
               device) -> Dict[str, torch.Tensor]:
    """Fresh MLA weights with the reference's init distribution (zero norm
    scales, ``wo`` at std (H * v) ** -0.5), drawn in its order."""
    a = cfg.attn
    kw = dict(generator=generator, dtype=dtype, device=device)
    out = {}
    for name, shape in _mla_shapes(cfg).items():
        if name.endswith("norm"):
            out[name] = torch.zeros(shape, dtype=dtype, device=device)
        elif name == "wo":
            out[name] = dense_init(shape, scale=(cfg.num_heads *
                                                 a.v_head_dim) ** -0.5, **kw)
        else:
            out[name] = dense_init(shape, **kw)
    return out


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   device, plan=None):
    """Compressed decode strip of one MLA layer: ``ckv`` (B, S, R) and the
    rope key ``krope`` (B, S, r) — R + r = 576 values a token at
    deepseek-v2's widths, against H * (nope + rope + v) = 40,960 for the
    per-head K/V — with the shared position track ``kpos`` (-1 = empty).
    Under a sequence-sharded recipe, this rank's block of the rows."""
    a = cfg.attn
    s = max_len // seq_shard(plan, max_len)[1]
    return {
        "ckv": torch.zeros((batch, s, a.kv_lora_rank), dtype=dtype,
                           device=device),
        "krope": torch.zeros((batch, s, a.qk_rope_dim), dtype=dtype,
                             device=device),
        "kpos": torch.full((s,), -1, dtype=torch.int32, device=device),
    }


def _mla_q(attn: MLA, x, cfg: ModelConfig, plan=None):
    """(q_nope, q_rope), each (B, S, H, ·) over this rank's heads, before
    RoPE."""
    a = cfg.attn
    if a.q_lora_rank:
        qa = rms_norm(x @ sh.leaf(attn, "wq_a", plan),
                      sh.leaf(attn, "q_norm", plan), cfg.norm_eps)
        q = _project(qa, sh.leaf(attn, "wq_b", plan))
    else:
        q = _project(x, sh.leaf(attn, "wq", plan))
    return q[..., :a.qk_nope_dim], q[..., a.qk_nope_dim:]


def mla_apply(attn: MLA, x, positions, cfg: ModelConfig,
              cache: Optional[Dict] = None, mode: str = "prefill",
              write_mask=None, plan=None):
    """x: (B, S, D); positions as for ``gqa_apply``.

    prefill: not absorbed — k = [wk_b ckv, broadcast rope key] (B, S, H,
    nope + rope) and v = wv_b ckv (B, S, H, v) are materialised and go
    through the flash kernel at qk dim != v dim, scaled by (nope + rope)
    ** -0.5; the cache is the compressed rows and their positions.
    decode: absorbed — the new row is written into the strip (per slot with
    ``write_mask``, or at the shared position), then
    ``mla_decode_attention`` scores q against the compressed rows, and
    wv_b lifts the context to the value heads.  A prefill chunk raises, as
    in the reference.  train: prefill's unabsorbed attention with no cache.

    Under a ``plan``: ``wq_b``/``wk_b``/``wv_b`` and ``wo`` hold this
    rank's heads (the output is its partial sum), ``wq_a``/``wkv_a`` are
    gathered over the FSDP axis at use, and the compressed strip is this
    rank's block over the sequence axes.  Sequence-sharded decode absorbs
    this rank's heads, gathers the absorbed query over the model axis,
    takes the partial over its block of the strip, combines the partials
    over the sequence axes and keeps its heads for wv_b and o.
    Returns (out (B, S, D), new_cache), new_cache None in train."""
    a = cfg.attn
    B, S, _ = x.shape
    if mode == "chunk":
        raise NotImplementedError(
            "chunked prefill covers paged full-attention GQA layers only "
            "(MLA caches are dense per-slot strips)")
    if mode not in ("train", "prefill", "decode"):
        raise NotImplementedError(f"attention mode {mode!r} is not ported")
    per_slot, posb, rope_pos = _decode_positions(positions, B, cache, mode)
    q_nope, q_rope = _mla_q(attn, x, cfg, plan)
    q_rope = apply_rope(q_rope, rope_pos, a.rope_base)
    q_split = sh.split_on_model(plan, attn, "wk_b", 1)
    heads = sh.tp_split(plan, cfg.num_heads) if q_split \
        else (0, cfg.num_heads)
    wk_b = sh.leaf(attn, "wk_b", plan)
    wv_b = sh.leaf(attn, "wv_b", plan)

    kv_a = x @ sh.leaf(attn, "wkv_a", plan)
    ckv = rms_norm(kv_a[..., :a.kv_lora_rank], sh.leaf(attn, "kv_norm", plan),
                   cfg.norm_eps)
    k_rope = apply_rope(kv_a[..., a.kv_lora_rank:][:, :, None, :], rope_pos,
                        a.rope_base)[:, :, 0]
    scale = (a.qk_nope_dim + a.qk_rope_dim) ** -0.5

    if mode == "decode":
        if cache is None:
            raise ValueError("decode needs a cache")
        new_vals = {"ckv": ckv, "krope": k_rope}
        shard = seq_shard(plan)
        if per_slot:
            new_cache = _slot_update(cache, new_vals, posb, False,
                                     write_mask, shard)
            pos = posb
        else:
            pos = positions[0]
            new_cache = _ring_update(cache, new_vals, pos, False, shard)
        q_eff, qr = mla_absorb(q_nope[:, 0], wk_b), q_rope[:, 0]
        gather = q_split and shard[1] > 1
        if gather:
            q_eff = sh.all_gather(plan, q_eff, plan.model_axis, 1)
            qr = sh.all_gather(plan, qr, plan.model_axis, 1)
        ctx = mla_decode_absorbed(q_eff, qr, new_cache["ckv"],
                                  new_cache["krope"], new_cache["kpos"], pos,
                                  scale=scale, plan=plan)   # (B, H, R)
        if gather:
            ctx = ctx[:, heads[0]:heads[1]]
        out_h = torch.einsum("bhr,rhv->bhv", ctx.to(x.dtype), wv_b)[:, None]
    else:
        H = wk_b.shape[1]
        k_nope = _project(ckv, wk_b)
        v = _project(ckv, wv_b)
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
            B, S, H, a.qk_rope_dim)], dim=-1)
        q = torch.cat([q_nope, q_rope], dim=-1)
        out_h = kops.flash_attention(q, k, v, causal=True, scale=scale,
                                     q_chunk=cfg.attn_chunk,
                                     kv_chunk=cfg.attn_chunk)
        del q, k, v, k_nope
        new_cache = None if mode == "train" else _seq_block({
            "ckv": ckv, "krope": k_rope,
            "kpos": torch.arange(S, dtype=torch.int32, device=x.device)},
            plan)
    wo = sh.leaf(attn, "wo", plan)
    H, dv, D = wo.shape
    out = out_h.to(x.dtype).reshape(B * S, H * dv) @ wo.reshape(H * dv, D)
    return out.reshape(B, S, D), new_cache
