"""Shared layers: RMSNorm, RoPE, gated MLP, init helpers (port of
``repro/models/layers.py``)."""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with fp32 accumulation, output in input dtype."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


def rope_frequencies(head_dim: int, base: float,
                     device=None) -> torch.Tensor:
    """Inverse frequencies for rotary embedding; head_dim must be even."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32, device=device) / half
    return 1.0 / (base ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               base: float) -> torch.Tensor:
    """Rotary position embedding, "rotate half" convention.

    x: (..., S, H, Dh) with Dh even; positions: broadcastable to (..., S).
    """
    dh = x.shape[-1]
    inv_freq = rope_frequencies(dh, base, device=x.device)
    angles = positions[..., :, None].float() * inv_freq
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """Gated MLP: silu(x W_g) * (x W_u) W_d.  Weights: (D,F),(D,F),(F,D)."""
    g = x @ w_gate
    u = x @ w_up
    h = F.silu(g.float()).to(x.dtype) * u
    return h @ w_down


# ---------------------------------------------------------------------------
# Parameter initialization helpers
# ---------------------------------------------------------------------------


def empty_param(shape: Sequence[int], dtype, device) -> nn.Parameter:
    """An uninitialized inference-only parameter (no gradient)."""
    return nn.Parameter(torch.empty(tuple(shape), dtype=dtype, device=device),
                        requires_grad=False)


def dense_init(shape: Sequence[int], generator: torch.Generator,
               dtype=torch.bfloat16, scale: Optional[float] = None,
               device=None) -> torch.Tensor:
    """Truncated-normal fan-in init: a normal truncated to [-2, 2] times
    ``fan_in ** -0.5`` (fan_in = shape[0]), or times ``scale`` — the
    distribution of the reference's ``dense_init``.  The numbers differ
    from JAX's for the same seed; tests carry weights across instead."""
    fan_in = shape[0] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else fan_in ** -0.5
    t = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, mean=0.0, std=1.0, a=-2.0, b=2.0,
                                generator=generator)
    return (t * std).to(dtype)
