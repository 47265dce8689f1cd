"""int8 gradient compression for a slow link's all-reduce (port of
``repro/optim/compression.py``).

Per-tensor symmetric int8 quantization with stochastic rounding, whose
error has zero mean, so the compressed sum is unbiased.  ``compressed_psum`` shares one
scale over the axis (the max of the ranks' |x| / 127), sums the int8
payloads in int32, which is exact, and decompresses with that scale: the
error is the rounding's alone, at most one step (scale) per rank and
element.  The noise comes from an explicit ``torch.Generator`` where the
reference splits a JAX key; give each rank its own stream.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from repro_torch import sharding as sh


def _quantize(x32: torch.Tensor, scale: torch.Tensor,
              generator: torch.Generator) -> torch.Tensor:
    """round(x / scale + u), u uniform on [-0.5, 0.5) from ``generator``
    (on x's device), clipped to [-127, 127], still float."""
    noise = torch.rand(x32.shape, generator=generator, dtype=torch.float32,
                       device=x32.device) - 0.5
    return torch.clamp(torch.round(x32 / scale + noise), -127, 127)


def _scale(amax: torch.Tensor) -> torch.Tensor:
    return torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))


def int8_compress(x: torch.Tensor, generator: torch.Generator
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q int8, scale float32 0-dim): q = clip(round(x / scale + noise),
    -127, 127) with scale = max|x| / 127 (1 where x is all zeros)."""
    x32 = x.float()
    scale = _scale(x32.abs().max())
    return _quantize(x32, scale, generator).to(torch.int8), scale


def int8_decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_psum(x: torch.Tensor, plan, axes,
                    generator: torch.Generator) -> torch.Tensor:
    """The sum of ``x`` over ``axes`` with an int8 payload: the scale is
    the max of the ranks' (an all-reduce of one value), the payloads are
    summed in int32 and the sum decompressed with the shared scale.
    Returns float32.  No gradient (it is applied to gradients)."""
    x32 = x.detach().float()
    amax = sh.all_reduce(plan, x32.abs().max().clone(), axes,
                         dist.ReduceOp.MAX)
    scale = _scale(amax)
    q = _quantize(x32, scale, generator).to(torch.int32)
    return sh.all_reduce(plan, q, axes).float() * scale
