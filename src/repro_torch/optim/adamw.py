"""AdamW with a configurable state dtype (bf16 m/v for >= 100 B models, as
llama3-405b's config asks) and global-norm clipping (port of
``repro/optim/adamw.py``).

The reference returns new pytrees; here the optimizer updates the
``LM``'s parameters and its own state in place under ``torch.no_grad()``
and returns the metrics.  The math is the reference's, in float32 where it
works in float32: the clipped gradients, the bias corrections from the
int32 step counter, the moments, the weight decay on the float32 copy of
the parameter, then the cast back to the parameter's and the state's
dtypes.  Parameters, gradients and moments are dicts keyed by the
parameter names (``dict(LM.named_parameters())``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Tuple

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: str = "float32"


def adamw_init(params: Mapping[str, torch.Tensor], cfg: AdamWConfig) -> Dict:
    """Zero moments in ``cfg.state_dtype`` beside each parameter and an
    int32 step counter 0 on the parameters' device."""
    dt = _DTYPES[cfg.state_dtype]
    dev = next(iter(params.values())).device
    return {"m": {n: torch.zeros(p.shape, dtype=dt, device=p.device)
                  for n, p in params.items()},
            "v": {n: torch.zeros(p.shape, dtype=dt, device=p.device)
                  for n, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _clip_scale(grads: Mapping[str, torch.Tensor], max_norm: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(min(1, max_norm / max(norm, 1e-9)), the global norm: the sqrt of
    the sum over leaves of each leaf's fp32 sum of squares)."""
    gn = torch.sqrt(torch.stack([g.float().square().sum()
                                 for g in grads.values()]).sum())
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0), gn


def clip_by_global_norm(grads: Mapping[str, torch.Tensor], max_norm: float
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """(grads as float32 scaled by min(1, max_norm / max(norm, 1e-9)),
    the global norm)."""
    scale, gn = _clip_scale(grads, max_norm)
    return {n: g.float() * scale for n, g in grads.items()}, gn


@torch.no_grad()
def adamw_update(params: Mapping[str, torch.Tensor],
                 grads: Mapping[str, torch.Tensor], state: Dict,
                 cfg: AdamWConfig, lr_scale=1.0) -> Dict[str, torch.Tensor]:
    """One step on ``params`` and ``state`` in place; returns
    {"grad_norm"}.  The gradients are clipped leaf by leaf as they are
    used (the same values as ``clip_by_global_norm``, without a float32
    copy of every gradient at once)."""
    scale, gn = _clip_scale(grads, cfg.clip_norm)
    step = state["step"] + 1
    t = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                       device=t.device), t)
    bc2 = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                       device=t.device), t)
    lr = torch.as_tensor(lr_scale, dtype=torch.float32,
                         device=t.device) * cfg.lr
    for n, p in params.items():
        g = grads[n].float() * scale
        m, v = state["m"][n], state["v"][n]
        m32 = m.float() * cfg.b1 + (1 - cfg.b1) * g
        v32 = v.float() * cfg.b2 + (1 - cfg.b2) * torch.square(g)
        mhat = m32 / bc1
        vhat = v32 / bc2
        p32 = p.float()
        p32 = p32 - lr * (mhat / (torch.sqrt(vhat) + cfg.eps)
                          + cfg.weight_decay * p32)
        p.copy_(p32)
        m.copy_(m32)
        v.copy_(v32)
    state["step"] = step
    return {"grad_norm": gn}
