"""Mixture-of-Experts FFN (port of the single-device half of
``repro/models/moe.py``).

``dense_moe`` is the reference's oracle and single-device path: every
expert runs on every token and the outputs are combined by the router's
gates, zero for the experts a token was not routed to.  It costs O(E) in
operations and reads every expert's weights on every call; routing tokens
only to their experts (grouped products) is later work, as is the
reference's expert-parallel path (``ep_moe_local``, ``ep_moe_decode_local``
and ``_dispatch_indices``), which ships tokens over ``all_to_all`` to the
rank that owns the expert.

Parameters keep the reference's layouts and dtypes: ``router`` (D, E) in
float32 whatever the model dtype, ``we_gate`` / ``we_up`` (E, D, F),
``we_down`` (E, F, D); shared experts are a plain gated MLP (``ws_*``)
applied in ``models/blocks.py``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

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
                  cfg: ModelConfig) -> torch.Tensor:
    """Switch-style load-balancing loss: E * sum_e f_e * p_e."""
    m = cfg.moe
    e1 = F.one_hot(experts, m.num_experts).float().sum(-2)
    frac = e1.reshape(-1, m.num_experts).mean(0) / max(m.top_k, 1)
    pbar = probs.reshape(-1, m.num_experts).mean(0)
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
              cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """All experts on all tokens, gate-masked combine.  x: (..., D).
    Returns (y like x, aux load loss).  The gate weights are cast to the
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
    return y.reshape(shape), aux_load_loss(probs, experts, cfg)
