"""Carry the reference package's weights into the port.

``params_from_jax`` takes the JAX parameter pytree as numpy arrays (the
leaves of ``repro.models.model.init_params``, converted by the caller) and
returns the port's ``LM`` with the same values.  The pytree's stacked
``blocks.b{j}.*`` leaves carry a leading ``num_groups`` axis; layer
``g * group_size + j`` takes index ``g``.  With a sharding ``plan`` every
leaf is cut to this rank's piece by ``sharding.param_specs`` (the
reference's ``_RULES``), as ``LM`` stores it.  Only the tests call this (the port itself never
imports JAX); ``chip_smoke.py`` draws its weights with the port's own
``init_params``.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import sharding as sh
from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.model import LM, _flat, group_pattern


def state_from_jax(tree: Dict[str, Any], cfg: ModelConfig
                   ) -> Dict[str, np.ndarray]:
    """Map reference pytree leaves to the port's state-dict names."""
    gs = len(group_pattern(cfg))
    state: Dict[str, np.ndarray] = {}
    for path, leaf in _flat(tree):
        arr = np.asarray(leaf)
        parts = path.split(".")
        if parts[0] == "blocks":
            j = int(parts[1][1:])
            rest = ".".join(parts[2:])
            for g in range(arr.shape[0]):
                state[f"blocks.{g * gs + j}.{rest}"] = arr[g]
        else:
            state[path] = arr
    return state


def params_from_jax(tree: Dict[str, Any], cfg: ModelConfig,
                    device=None, plan=None) -> LM:
    dev = resolve_device(device)
    model = LM(cfg, dev, plan)
    state = {name: sh.cut(plan, model.specs.get(name), arr)
             for name, arr in state_from_jax(tree, cfg).items()}
    own = model.state_dict()
    if set(state) != set(own):
        raise KeyError(f"pytree/module mismatch: missing "
                       f"{sorted(set(own) - set(state))}, unexpected "
                       f"{sorted(set(state) - set(own))}")
    with torch.no_grad():
        for name, arr in state.items():
            dst = own[name]
            if tuple(arr.shape) != tuple(dst.shape):
                raise ValueError(f"{name}: shape {arr.shape} vs "
                                 f"{tuple(dst.shape)}")
            src = torch.from_numpy(np.array(arr, dtype=np.float32))
            dst.copy_(src.to(dst.dtype))
    return model
