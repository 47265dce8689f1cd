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

Under a sharding plan each rank holds its pieces of the parameters, their
gradients and the moments (the reference's ``opt_sharding`` is the
parameters' specs), and the update is elementwise on them.  The one
global quantity is the gradient norm: ``plan`` and ``specs`` (each
leaf's spec by name) make it the norm of the global gradient
(``sharding.global_sumsq``: every piece's sum of squares summed over the
axes that split its leaf, a leaf replicated over an axis counted once).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Tuple

import torch

from repro_torch import sharding as sh

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


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


def _clip_scale(grads: Mapping[str, torch.Tensor], max_norm: float,
                plan=None, specs=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(min(1, max_norm / max(norm, 1e-9)), the global norm: the sqrt of
    the sum over leaves of each leaf's fp32 sum of squares; of the global
    leaves under a ``plan``, whose pieces ``grads`` holds)."""
    if plan is not None and plan.mesh is not None:
        gn = torch.sqrt(sh.global_sumsq(plan, specs or {}, grads))
    else:
        gn = torch.sqrt(torch.stack([g.float().square().sum()
                                     for g in grads.values()]).sum())
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0), gn


def clip_by_global_norm(grads: Mapping[str, torch.Tensor], max_norm: float,
                        plan=None, specs=None
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """(grads as float32 scaled by min(1, max_norm / max(norm, 1e-9)),
    the global norm)."""
    scale, gn = _clip_scale(grads, max_norm, plan, specs)
    return {n: g.float() * scale for n, g in grads.items()}, gn


_SLICE = 1 << 26      # elements of a leaf updated at once


def _slices(*ts):
    """Matching flat slices of a leaf's tensors, _SLICE elements each, so
    that the update's float32 temporaries stay bounded on the largest
    leaves (the update is elementwise: the same values as whole); the
    tensors whole where one of them is not contiguous."""
    n = ts[0].numel()
    if n <= _SLICE or not all(t.is_contiguous() for t in ts):
        yield ts
        return
    flat = [t.view(-1) for t in ts]
    for i in range(0, n, _SLICE):
        yield tuple(f[i:i + _SLICE] for f in flat)


@torch.no_grad()
def adamw_update(params: Mapping[str, torch.Tensor],
                 grads: Mapping[str, torch.Tensor], state: Dict,
                 cfg: AdamWConfig, lr_scale=1.0, plan=None, specs=None
                 ) -> Dict[str, torch.Tensor]:
    """One step on ``params`` and ``state`` in place; returns
    {"grad_norm"}.  The gradients are clipped leaf by leaf as they are
    used (the same values as ``clip_by_global_norm``, without a float32
    copy of every gradient at once), a slice of a large leaf at a time.
    Under a ``plan`` the tensors are this rank's pieces and ``grad_norm``
    is the global norm."""
    scale, gn = _clip_scale(grads, cfg.clip_norm, plan, specs)
    step = state["step"] + 1
    t = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                       device=t.device), t)
    bc2 = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                       device=t.device), t)
    lr = torch.as_tensor(lr_scale, dtype=torch.float32,
                         device=t.device) * cfg.lr
    for n, p in params.items():
        for pc, gc, mc, vc in _slices(p, grads[n], state["m"][n],
                                      state["v"][n]):
            g = gc.float() * scale
            m32 = mc.float() * cfg.b1 + (1 - cfg.b1) * g
            v32 = vc.float() * cfg.b2 + (1 - cfg.b2) * torch.square(g)
            mhat = m32 / bc1
            vhat = v32 / bc2
            p32 = pc.float()
            p32 = p32 - lr * (mhat / (torch.sqrt(vhat) + cfg.eps)
                              + cfg.weight_decay * p32)
            pc.copy_(p32)
            mc.copy_(m32)
            vc.copy_(v32)
    state["step"] = step
    return {"grad_norm": gn}
