"""Step builders: the sharded prefill, decode and decode-block steps of
one (arch, shape, mesh) cell (port of ``repro/launch/steps.py:157-168``).

Each builder closes over the config and a ``ShardingRecipe`` and returns
the step a server calls on every rank of the mesh with the same global
inputs.  ``jit`` and ``NamedSharding`` have no counterpart: the steps run
eagerly, and the recipe decides which piece of the batch, the caches and
the vocabulary each rank works on (``models/model.py``).  Like every entry
point of the port, a step runs on the card unless the builder is asked for
the CPU; the builders raise without a CUDA device, and when the recipe's
mesh lives on another device type.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.sharding import ShardingRecipe


def _device(recipe: ShardingRecipe, device) -> torch.device:
    dev = resolve_device(device)
    if recipe.mesh is not None and recipe.mesh.device_type != dev.type:
        raise ValueError(f"the recipe's mesh is on {recipe.mesh.device_type}"
                         f", the step on {dev.type}")
    return dev


def build_prefill_step(cfg: ModelConfig, recipe: ShardingRecipe,
                       device=None):
    dev = _device(recipe, device)

    def prefill_step(model, batch):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        return M.prefill_fn(model, batch, cfg, recipe)

    return prefill_step


def build_decode_step(cfg: ModelConfig, recipe: ShardingRecipe,
                      device=None):
    dev = _device(recipe, device)

    def serve_step(model, caches, token, pos):
        return M.decode_fn(model, caches, torch.as_tensor(token, device=dev),
                           torch.as_tensor(pos, device=dev), cfg, recipe)

    return serve_step


def build_decode_block_step(cfg: ModelConfig, recipe: ShardingRecipe, *,
                            k_steps: int, eos_id: Optional[int],
                            max_len: int, device=None):
    dev = _device(recipe, device)

    def block_step(model, caches, tokens, positions, alive, remaining):
        t = lambda x: torch.as_tensor(x, device=dev)    # noqa: E731
        return M.decode_block_fn(model, caches, t(tokens), t(positions),
                                 t(alive), t(remaining), cfg, recipe,
                                 k_steps=k_steps, eos_id=eos_id,
                                 max_len=max_len)

    return block_step
