"""Vocabulary embedding, the greedy sampling head and the training loss
head (port of ``repro/core/embedding.py``), unsharded and ISP-sharded.

Under a plan with a model axis the vocabulary table is the "drive": each
rank keeps its shard of rows (and, with FSDP, of columns) and the table
never moves.  Lookups ship token *indexes* to every shard, each shard
gathers the rows it owns (``isp_gather``, zeros elsewhere) and only
activation rows are reduced back.  Greedy sampling is the same idea in
reverse: each shard proposes its local (value, id) and only those cross
the link.  Collectives run on ``torch.distributed`` over the plan's groups.

Tensors here are what this rank holds: its batch rows of activations and
tokens, and its shard of a table (``sharding.vocab_slices``).

The loss head is the lookup's idea in reverse: per-shard logits and
psum'd log-sum-exp scalars (``sharded_xent``), so the (tokens x
vocabulary) logits never exist whole.  Lookups and the loss head are
differentiable: ``ops.isp_gather`` scatters the rows' gradient back into
the table shard, and the collectives carry their adjoints
(``sharding``).
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

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
    product accumulates in fp32 and is written as fp32 (on ``meta`` too,
    where the dry-run counts the card's step); on the CPU, which has no
    such kernel, the operands are widened first."""
    if x.device.type in ("cuda", "meta"):
        return torch.mm(x, w_head.t(), out_dtype=torch.float32)
    return x.float() @ w_head.float().t()


class _HeadLogits(torch.autograd.Function):
    """``_logits_f32`` with a gradient: fp32 logits (T, V) from x (T, D) and
    the head (V, D).  The backward takes the fp32 cotangent to the
    operands' dtype and runs two products in it (bf16 on the tensor cores
    in a bf16 model; exact fp32 in an fp32 one): dx = g w, dw = gᵀ x."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _logits_f32(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = g.to(x.dtype)
        return gx @ w, gx.t() @ x


def _dense_chunked_xent(x, w_head, labels, vocab_size: int, chunk: int):
    """Per-token cross-entropy (B, S) fp32 against an unsharded head,
    without the (tokens x vocab) logits at once: ``chunk`` tokens at a
    time, each chunk's logits recomputed in the backward
    (``torch.utils.checkpoint``, the reference's per-chunk remat), the
    padded vocabulary columns at -1e30.  x: (B, S, D); w_head (V_pad, D);
    labels (B, S) in [0, vocab)."""
    b, s, d = x.shape
    t = b * s
    c = min(chunk, t)
    pad = (-t) % c
    xf = torch.nn.functional.pad(x.reshape(t, d), (0, 0, 0, pad))
    lf = torch.nn.functional.pad(labels.reshape(t), (0, pad), value=0)

    def body(x_c, l_c):
        logits = _HeadLogits.apply(x_c, w_head)
        cols = torch.arange(logits.shape[-1], device=logits.device)
        logits = torch.where((cols < vocab_size)[None], logits, -1e30)
        lse = torch.logsumexp(logits, dim=-1)
        ll = logits.gather(1, l_c.long()[:, None])[:, 0]
        return lse - ll

    losses = [checkpoint(body, xf[i:i + c], lf[i:i + c], use_reentrant=False)
              for i in range(0, t + pad, c)]
    return torch.cat(losses)[:t].reshape(b, s)


def _xent_local(x, w_head, labels, cfg: ModelConfig, plan, chunk: int):
    """Per-token cross-entropy (B, S) fp32 against this rank's vocabulary
    shard (the reference's ``_xent_local``).  x: (B, S, D), every token of
    this rank's batch rows; w_head: this rank's (V_loc, D[/f]) shard,
    gathered to full columns first; labels (B, S) global ids.  ``chunk``
    tokens at a time, each chunk's logits recomputed in the backward: its
    fp32 logits against the shard, the row max taken over the model axis
    (without a gradient, as the reference's ``stop_gradient``), the sum of
    exponentials and the label's logit (from the shard that owns it, 0
    from the others) summed over the model axis.  As in the reference's
    sharded head, the padded vocabulary columns are not masked."""
    tp = plan.model_axis
    w = _full_columns(w_head, plan, cfg)
    v_loc = w.shape[0]
    off = sh.axis_index(plan, tp) * v_loc
    b, s, d = x.shape
    t = b * s
    c = min(chunk, t)
    pad = (-t) % c
    xf = torch.nn.functional.pad(x.reshape(t, d), (0, 0, 0, pad))
    lf = torch.nn.functional.pad(labels.reshape(t), (0, pad), value=0)

    def body(x_c, l_c):
        logits = _HeadLogits.apply(x_c, w)
        lmax = sh.all_reduce(plan, logits.detach().amax(dim=-1), tp,
                             dist.ReduceOp.MAX)
        se = sh.all_reduce(plan, torch.exp(logits - lmax[:, None]).sum(-1),
                           tp)
        loc = l_c.long() - off
        ok = (loc >= 0) & (loc < v_loc)
        ll = logits.gather(1, loc.clamp(0, v_loc - 1)[:, None])[:, 0]
        lab = sh.all_reduce(plan, torch.where(ok, ll, torch.zeros_like(ll)),
                            tp)
        return torch.log(se) + lmax - lab

    losses = [checkpoint(body, xf[i:i + c], lf[i:i + c], use_reentrant=False)
              for i in range(0, t + pad, c)]
    return torch.cat(losses)[:t].reshape(b, s)


def sharded_xent(x, w_head, labels, cfg: ModelConfig, plan=None,
                 chunk: int = 4096, seq_sharded: bool = False
                 ) -> torch.Tensor:
    """Per-token cross-entropy (B, S) fp32 (the caller masks and means).
    x: (B, S, D) this rank's rows; w_head: (V_pad, D), this rank's piece;
    labels: (B, S), in x's layout.  Without a vocab-sharded plan this is
    ``_dense_chunked_xent`` (on the head's full columns), as in the
    reference.  Under one (``sharding.vocab_sharded``, the reference's
    ``w_head.shape[0] % tp == 0`` rule) it is ``_xent_local`` on this
    rank's vocabulary shard: the (tokens x vocabulary) logits never exist
    whole, only per-token scalars cross the model axis.  With
    ``seq_sharded`` (the Megatron-SP residual stream) x and labels are
    this rank's block of the sequence: every vocabulary shard must see
    every token, so the hidden block and the labels are all-gathered over
    the model axis and the loss is sliced back to the block."""
    if not sh.vocab_sharded(plan, cfg):
        return _dense_chunked_xent(x, _full_columns(w_head, plan, cfg),
                                   labels, cfg.vocab_size, chunk)
    tp = plan.model_axis
    if not (seq_sharded and plan.axis_size(tp) > 1):
        return _xent_local(x, w_head, labels, cfg, plan, chunk)
    s_loc = x.shape[1]
    x_all = sh.all_gather(plan, x, tp, 1)
    lab_all = sh.all_gather(plan, labels, tp, 1)
    losses = _xent_local(x_all, w_head, lab_all, cfg, plan, chunk)
    r = sh.axis_index(plan, tp)
    return losses[:, r * s_loc:(r + 1) * s_loc]


def _full_columns(table: torch.Tensor, plan, cfg: ModelConfig
                  ) -> torch.Tensor:
    """FSDP storage gather: this rank's (V_loc, D/f) shard of a table
    restored to full row width over the FSDP axis (the table as it is
    where its columns are whole)."""
    spec = sh.table_spec(plan, cfg)
    if spec is None or spec[1] is None:
        return table
    return sh.all_gather(plan, table, spec[1], 1)


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
        return gather_baseline(_full_columns(table, plan, cfg), tokens)
    tp = plan.model_axis
    r, n = sh.axis_index(plan, tp), plan.axis_size(tp)
    S = tokens.shape[1]
    if seq_sharded is None:
        seq_sharded = S % n == 0 and n > 1
    seq_sharded = seq_sharded and S % n == 0
    full = _full_columns(table, plan, cfg)
    off = r * full.shape[0]

    if seq_sharded:
        ids = sh.all_gather(plan, sh.own_block(plan, tokens, tp, 1), tp, 1)
        rows = kops.isp_gather(full, ids, shard_offset=off)
        return sh.reduce_scatter(plan, rows, tp, 1)
    rows = kops.isp_gather(full, tokens, shard_offset=off)
    return sh.all_reduce(plan, rows, tp)    # activation rows, not the table


def _local_logits(x_last, w_head, plan, cfg: ModelConfig):
    """This shard's fp32 logits (B, V_loc) with pad columns at -inf, and
    the global id of its first row."""
    r = sh.axis_index(plan, plan.model_axis)
    w = _full_columns(w_head, plan, cfg)
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
        return _logits_f32(x_last, _full_columns(w_head, plan, cfg))[
            :, : cfg.vocab_size]
    logits, _ = _local_logits(x_last, w_head, plan, cfg)
    return sh.all_gather(plan, logits, plan.model_axis, 1)


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
        return sharded_logits_last(x_last, w_head, cfg, plan).argmax(
            dim=-1).to(torch.int32)
    logits, off = _local_logits(x_last, w_head, plan, cfg)
    val = logits.amax(dim=-1)
    idx = logits.argmax(dim=-1) + off
    best = sh.all_reduce(plan, val.clone(), plan.model_axis,
                         dist.ReduceOp.MAX)
    win = torch.where(val == best, idx, torch.zeros_like(idx))
    return sh.all_reduce(plan, win, plan.model_axis,
                         dist.ReduceOp.MAX).to(torch.int32)
