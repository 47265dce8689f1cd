"""Vocabulary embedding and the greedy sampling head (port of
``repro/core/embedding.py``), unsharded and ISP-sharded.

Under a plan with a model axis the vocabulary table is the "drive": each
rank keeps its shard of rows (and, with FSDP, of columns) and the table
never moves.  Lookups ship token *indexes* to every shard, each shard
gathers the rows it owns (``isp_gather``, zeros elsewhere) and only
activation rows are reduced back.  Greedy sampling is the same idea in
reverse: each shard proposes its local (value, id) and only those cross
the link.  Collectives run on ``torch.distributed`` over the plan's groups.

Tensors here are what this rank holds: its batch rows of activations and
tokens, and its shard of a table (``sharding.vocab_slices``).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch import sharding as sh
from repro_torch.config import ModelConfig
from repro_torch.kernels import ops as kops

def gather_baseline(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """tokens: (B, S) int -> (B, S, D) rows of the table."""
    return table[tokens.long()]


def _logits_f32(x: torch.Tensor, w_head: torch.Tensor) -> torch.Tensor:
    """x @ w_headᵀ with fp32 output, like the reference's
    ``preferred_element_type=float32``: a bf16 product rounded to bf16
    before argmax would tie often at a 64k vocabulary.  On the card the
    product accumulates in fp32 and is written as fp32; on the CPU, which
    has no such kernel, the operands are widened first."""
    if x.device.type == "cuda":
        return torch.mm(x, w_head.t(), out_dtype=torch.float32)
    return x.float() @ w_head.float().t()


def _full_columns(table: torch.Tensor, plan) -> torch.Tensor:
    """FSDP storage gather: this rank's (V_loc, D/f) shard of a table
    restored to full row width over the FSDP axis."""
    fs = plan.fsdp_axis
    f = plan.axis_size(fs)
    if f == 1:
        return table
    v_loc, d_loc = table.shape
    out = table.new_empty((f * v_loc, d_loc))
    dist.all_gather_into_tensor(out, table.contiguous(),
                                group=sh.axis_group(plan, fs))
    return out.view(f, v_loc, d_loc).permute(1, 0, 2).reshape(v_loc,
                                                              f * d_loc)


def _model_rank(plan):
    """(this rank's model coordinate, model axis size, model group)."""
    tp = plan.model_axis
    return sh.axis_index(plan, tp), plan.axis_size(tp), sh.axis_group(plan, tp)


def embed_lookup(table, tokens, cfg: ModelConfig, plan=None,
                 seq_sharded=None):
    """tokens: (B, S) int, this rank's batch rows -> (B, S, D).  ISP path
    under a plan whose model axis divides the padded vocabulary
    (``sharding.vocab_sharded``; ``table`` is then this rank's shard), else
    ``gather_baseline``.

    Two variants, as in the reference.  psum: every shard gathers the rows
    it owns for all ids and the rows are summed over the model axis.
    Sequence-parallel (``seq_sharded``; by default when S divides a model
    axis of more than one rank): each shard sends its S/tp slice of the
    *indexes* to all (4 bytes a token), gathers its rows for all of them,
    and a reduce-scatter returns each shard its own S/tp slice of the rows,
    (B, S/tp, D) — half the wire bytes of the psum, and the output arrives
    S-sharded for a sequence-parallel residual stream.  Both are exact: a
    row meets only zeros from the other shards.
    """
    if not sh.vocab_sharded(plan, cfg):
        return gather_baseline(table, tokens)
    r, n, group = _model_rank(plan)
    B, S = tokens.shape
    if seq_sharded is None:
        seq_sharded = S % n == 0 and n > 1
    seq_sharded = seq_sharded and S % n == 0
    full = _full_columns(table, plan)
    v_loc, d = full.shape

    if seq_sharded:
        s_loc = S // n
        mine = tokens[:, r * s_loc:(r + 1) * s_loc].contiguous()
        ids = mine.new_empty((n * B, s_loc))
        dist.all_gather_into_tensor(ids, mine, group=group)
        ids = ids.view(n, B, s_loc).permute(1, 0, 2).reshape(B, S)
        rows = kops.isp_gather(full, ids, shard_offset=r * v_loc)
        rows = rows.view(B, n, s_loc, d).permute(1, 0, 2, 3).reshape(
            n * B, s_loc, d)
        out = rows.new_empty((B, s_loc, d))
        dist.reduce_scatter_tensor(out, rows, group=group)
        return out

    rows = kops.isp_gather(full, tokens, shard_offset=r * v_loc)
    dist.all_reduce(rows, group=group)      # activation rows, not the table
    return rows


def _local_logits(x_last, w_head, plan, cfg: ModelConfig):
    """This shard's fp32 logits (B, V_loc) with pad columns at -inf, and
    the global id of its first row."""
    r, _, _ = _model_rank(plan)
    w = _full_columns(w_head, plan)
    v_loc = w.shape[0]
    off = r * v_loc
    logits = _logits_f32(x_last, w)
    ok = (off + torch.arange(v_loc, device=logits.device)) < cfg.vocab_size
    return torch.where(ok[None], logits, -torch.inf), off


def sharded_logits_last(x_last: torch.Tensor, w_head: torch.Tensor,
                        cfg: ModelConfig, plan=None) -> torch.Tensor:
    """Full logits for the last position.  x_last: (B, D) -> fp32 (B, V),
    sliced to the vocabulary without a plan.  Under a vocab-sharded plan,
    as in the reference, (B, V_pad) with the pad columns at -inf: each
    shard's logits are all-gathered over the model axis."""
    if not sh.vocab_sharded(plan, cfg):
        return _logits_f32(x_last, w_head)[:, : cfg.vocab_size]
    logits, _ = _local_logits(x_last, w_head, plan, cfg)
    _, n, group = _model_rank(plan)
    B, v_loc = logits.shape
    out = logits.new_empty((n * B, v_loc))
    dist.all_gather_into_tensor(out, logits.contiguous(), group=group)
    return out.view(n, B, v_loc).permute(1, 0, 2).reshape(B, n * v_loc)


def greedy_sample(x_last: torch.Tensor, w_head: torch.Tensor,
                  cfg: ModelConfig, plan=None) -> torch.Tensor:
    """Greedy next token (B,) int32.  Unsharded, ties go to the lowest id,
    as with ``jnp.argmax``.

    ISP greedy sampling under a vocab-sharded plan: each shard proposes its
    local max and argmax; only (value, id) pairs cross the link.  ``best``
    is the max of the values over the model axis and the token the max of
    ``id if value == best else 0`` — so a tie across shards goes to the
    higher shard's id, exactly as in the reference."""
    if not sh.vocab_sharded(plan, cfg):
        return sharded_logits_last(x_last, w_head, cfg).argmax(dim=-1).to(
            torch.int32)
    logits, off = _local_logits(x_last, w_head, plan, cfg)
    _, _, group = _model_rank(plan)
    val = logits.amax(dim=-1)
    idx = logits.argmax(dim=-1) + off
    best = val.clone()
    dist.all_reduce(best, op=dist.ReduceOp.MAX, group=group)
    win = torch.where(val == best, idx, torch.zeros_like(idx))
    dist.all_reduce(win, op=dist.ReduceOp.MAX, group=group)
    return win.to(torch.int32)
