"""Mixture-of-Experts FFN (port of ``repro/models/moe.py``).

``dense_moe`` is the reference's oracle and single-device path: every
expert runs on every token and the outputs are combined by the router's
gates, zero for the experts a token was not routed to.  It costs O(E) in
operations and reads every expert's weights on every call; routing tokens
only to their experts (grouped products) is later work.

Expert parallelism over the model axis (each rank holds E / tp experts):
``ep_moe_local`` ships each rank's tokens (small) over ``all_to_all`` to
the rank that owns their expert (big), in capacity-bounded per-expert
buffers (``_dispatch_indices``), and only the FFN outputs come back;
``ep_moe_decode_local`` runs each rank's own experts on every token and
sums over the model axis, which at a few tokens a rank moves fewer bytes
than the index traffic would.

Parameters keep the reference's layouts and dtypes: ``router`` (D, E) in
float32 whatever the model dtype, ``we_gate`` / ``we_up`` (E, D, F),
``we_down`` (E, F, D); shared experts are a plain gated MLP (``ws_*``)
applied in ``models/blocks.py``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch import sharding as sh
from repro_torch.config import ModelConfig
from repro_torch.models.layers import dense_init


def moe_params(cfg: ModelConfig, generator: torch.Generator, dtype,
               device) -> Dict[str, torch.Tensor]:
    """Fresh MoE weights with the reference's distribution: the router at
    std ``d_model ** -0.5`` in float32; the expert stacks through
    ``dense_init`` on their 3-D shapes, whose fan-in is ``shape[0]``, the
    number of experts (std ``E ** -0.5``, as the reference draws them);
    the shared experts as (D, F) / (F, D) matrices."""
    m = cfg.moe
    d, e, f = cfg.d_model, m.num_experts, m.d_ff_expert
    kw = dict(generator=generator, dtype=dtype, device=device)
    p = {
        "router": dense_init((d, e), generator=generator,
                             dtype=torch.float32, scale=d ** -0.5,
                             device=device),
        "we_gate": dense_init((e, d, f), **kw),
        "we_up": dense_init((e, d, f), **kw),
        "we_down": dense_init((e, f, d), **kw),
    }
    if m.num_shared_experts:
        fs = (m.d_ff_shared or m.d_ff_expert) * m.num_shared_experts
        p["ws_gate"] = dense_init((d, fs), **kw)
        p["ws_up"] = dense_init((d, fs), **kw)
        p["ws_down"] = dense_init((fs, d), **kw)
    return p


def _router(router: torch.Tensor, x: torch.Tensor, cfg: ModelConfig):
    """Returns (gates (..., k) fp32, experts (..., k) int64, probs (..., E)).

    fp32 logits against the fp32 router, a softmax, the top k with ties to
    the lower expert id (as ``jax.lax.top_k``; a stable descending sort
    gives that order, which ``torch.topk`` does not promise), and the gates
    renormalised to sum to 1 (floored at 1e-9)."""
    k = cfg.moe.top_k
    logits = x.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    gates, experts = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, experts = gates[..., :k], experts[..., :k]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    return gates, experts, probs


def aux_load_loss(probs: torch.Tensor, experts: torch.Tensor,
                  cfg: ModelConfig, plan=None, axes=()) -> torch.Tensor:
    """Switch-style load-balancing loss: E * sum_e f_e * p_e.  With
    ``axes`` the tokens are split over them: the routing fractions f and
    the mean probabilities p are those of every rank's tokens (sums and
    counts over the axes) before their product."""
    m = cfg.moe
    e1 = F.one_hot(experts, m.num_experts).float().sum(-2).reshape(
        -1, m.num_experts)
    pf = probs.reshape(-1, m.num_experts)
    if sh.axes_size(plan, axes) == 1:
        frac = e1.mean(0) / max(m.top_k, 1)
        pbar = pf.mean(0)
    else:
        n = sh.all_reduce(plan, torch.tensor(
            float(pf.shape[0]), device=pf.device), axes)
        frac = sh.all_reduce(plan, e1.sum(0), axes) / n / max(m.top_k, 1)
        pbar = sh.all_reduce(plan, pf.sum(0), axes) / n
    return m.num_experts * (frac * pbar).sum()


def _expert_ffn(we_gate, we_up, we_down, xs: torch.Tensor) -> torch.Tensor:
    """xs: (E, C, D) tokens grouped by expert; weights (E, D, F) / (E, F, D).
    silu in fp32, cast back to the activation dtype before the product
    with u."""
    g = torch.matmul(xs, we_gate)
    u = torch.matmul(xs, we_up)
    h = F.silu(g.float()).to(xs.dtype) * u
    return torch.matmul(h, we_down)


def dense_moe(params: Dict[str, torch.Tensor], x: torch.Tensor,
              cfg: ModelConfig, plan=None, axes=()
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All experts on all tokens, gate-masked combine.  x: (..., D).
    Returns (y like x, aux load loss; over the tokens of every rank on
    ``axes``, see ``aux_load_loss``).  The gate weights are cast to the
    activation dtype before the combine, as the reference does."""
    m = cfg.moe
    gates, experts, probs = _router(params["router"], x, cfg)
    shape = x.shape
    xf = x.reshape(-1, shape[-1])                                # (T, D)
    outs = _expert_ffn(params["we_gate"], params["we_up"],
                       params["we_down"],
                       xf[None].expand((m.num_experts,) + xf.shape))
    w = torch.zeros((xf.shape[0], m.num_experts), dtype=torch.float32,
                    device=x.device)
    w.scatter_add_(1, experts.reshape(-1, m.top_k),
                   gates.reshape(-1, m.top_k))
    y = torch.einsum("te,etd->td", w.to(x.dtype), outs)
    return y.reshape(shape), aux_load_loss(probs, experts, cfg, plan, axes)


# ---------------------------------------------------------------------------
# Expert parallelism over the model axis
# ---------------------------------------------------------------------------


def _dispatch_indices(experts, gates, num_experts: int, capacity: int):
    """Flatten (T, k) assignments into per-expert slots.  Returns (e_idx
    (T*k,), slot (T*k,), keep (T*k,), gate (T*k,)): ``slot`` is the
    assignment's place in its expert's buffer, in token order; past the
    capacity it is dropped (``keep`` false, slot 0)."""
    ef = experts.reshape(-1)
    gf = gates.reshape(-1)
    onehot = F.one_hot(ef, num_experts)                          # (T*k, E)
    pos = torch.cumsum(onehot, dim=0) - onehot                   # exclusive
    slot = pos.gather(1, ef[:, None])[:, 0]
    keep = slot < capacity
    return ef, torch.where(keep, slot, torch.zeros_like(slot)), keep, gf


def ep_moe_local(params, x_local, cfg: ModelConfig, plan):
    """One rank's part of the expert-parallel MoE (the reference's
    shard_map body).  x_local: (T, D), this rank's tokens; ``params``: the
    router whole and the expert stacks split on E over the model axis.
    Returns (y (T, D), aux load loss averaged over the model axis)."""
    m = cfg.moe
    model = plan.model_axis
    ep = plan.axis_size(model)
    t_local, d = x_local.shape
    capacity = max(1, int(t_local * m.top_k * m.capacity_factor
                          / m.num_experts))

    gates, experts, probs = _router(params["router"], x_local, cfg)
    aux = sh.all_reduce(plan, aux_load_loss(probs, experts, cfg), model) / ep
    e_idx, slot, keep, gate = _dispatch_indices(experts, gates,
                                                m.num_experts, capacity)
    # scatter the tokens into the (E, C, D) send buffer
    xk = x_local.repeat_interleave(m.top_k, dim=0)               # (T*k, D)
    buf = x_local.new_zeros((m.num_experts, capacity, d))
    buf.index_put_((e_idx, slot), torch.where(keep[:, None], xk,
                                              torch.zeros_like(xk)),
                   accumulate=True)
    # to the experts' ranks: (ep, E/ep, C, D) by source rank, then each
    # local expert's rows of every source side by side
    e_local = m.num_experts // ep
    got = sh.all_to_all(plan, buf, model)
    got = got.view(ep, e_local, capacity, d).transpose(0, 1).reshape(
        e_local, ep * capacity, d)
    y = _expert_ffn(params["we_gate"], params["we_up"], params["we_down"],
                    got)
    # and back: each source's rows of every local expert
    y = y.view(e_local, ep, capacity, d).transpose(0, 1).contiguous()
    y = sh.all_to_all(plan, y, model).view(m.num_experts, capacity, d)
    rows = y[e_idx, slot]                                        # (T*k, D)
    rows = torch.where(keep[:, None], rows, torch.zeros_like(rows))
    rows = rows * gate[:, None].to(rows.dtype)
    return rows.reshape(t_local, m.top_k, d).sum(dim=1), aux


def ep_moe_decode_local(params, x, cfg: ModelConfig, plan):
    """Decode-time expert parallelism: the same tokens x (T, D) on every
    rank of the model axis; each rank runs only its own experts, masked by
    the gates of the assignments it owns, and the outputs are summed over
    the model axis (no all_to_all)."""
    m = cfg.moe
    model = plan.model_axis
    e_local = m.num_experts // plan.axis_size(model)
    lo = sh.axis_index(plan, model) * e_local
    t, d = x.shape
    gates, experts, _ = _router(params["router"], x, cfg)        # (T, k)
    owned = (experts >= lo) & (experts < lo + e_local)
    e_rel = torch.clamp(experts - lo, 0, e_local - 1)
    w = torch.zeros((t, e_local), dtype=torch.float32, device=x.device)
    w.scatter_add_(1, e_rel, torch.where(owned, gates,
                                         torch.zeros_like(gates)))
    outs = _expert_ffn(params["we_gate"], params["we_up"], params["we_down"],
                       x[None].expand((e_local,) + tuple(x.shape)))
    y = torch.einsum("te,etd->td", w.to(x.dtype), outs)
    return sh.all_reduce(plan, y, model)
