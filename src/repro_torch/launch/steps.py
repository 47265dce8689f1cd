"""Step builders: the train step and the sharded prefill, decode and
decode-block steps of one (arch, shape, mesh) cell (port of
``repro/launch/steps.py:110-168``).

Each builder closes over the config and a ``ShardingRecipe`` and returns
the step a server calls on every rank of the mesh with the same global
inputs; the train step takes the local recipe only (no mesh).  ``jit``
and ``NamedSharding`` have no counterpart: the steps run eagerly, and the
recipe decides which piece of the batch, the caches and the vocabulary
each rank works on (``models/model.py``).  Like every entry
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
from repro_torch.optim import AdamWConfig, adamw_update, cosine_schedule
from repro_torch.sharding import ShardingRecipe


def _device(recipe: ShardingRecipe, device) -> torch.device:
    dev = resolve_device(device)
    if recipe.mesh is not None and recipe.mesh.device_type != dev.type:
        raise ValueError(f"the recipe's mesh is on {recipe.mesh.device_type}"
                         f", the step on {dev.type}")
    return dev


def _grads(model, params, batch, cfg: ModelConfig, recipe):
    """(loss, metrics, grads by name) of one (micro)batch; a parameter the
    loss does not reach gets a zero gradient, as ``jax.grad`` gives."""
    loss, metrics = M.loss_fn(model, batch, cfg, recipe)
    names = list(params)
    gs = torch.autograd.grad(loss, [params[n] for n in names],
                             allow_unused=True)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, {
        n: torch.zeros_like(params[n]) if g is None else g
        for n, g in zip(names, gs)}


def build_train_step(cfg: ModelConfig, recipe: ShardingRecipe,
                     opt_cfg: Optional[AdamWConfig] = None,
                     schedule_kwargs: Optional[dict] = None,
                     accum: Optional[int] = None, device=None):
    """Returns (train_step, opt_cfg).  ``train_step(model, opt_state,
    batch)`` takes the batch's arrays (numpy or tensors) to the step's
    device, computes the loss and its gradients (``accum`` microbatches:
    float32 sums of the gradients divided by ``accum``, as the reference's
    scan accumulates), scales the learning rate by
    ``cosine_schedule(opt_state["step"], **schedule_kwargs)`` and applies
    ``adamw_update``, updating the model's parameters and ``opt_state`` in
    place.  It returns (model, opt_state, metrics) with the reference's
    metrics: loss, xent, aux, tokens, grad_norm (0-dim tensors).  A recipe
    with a mesh raises (ROADMAP queue 1 item 5)."""
    dev = _device(recipe, device)
    M._local_only(recipe)
    opt_cfg = opt_cfg or AdamWConfig(state_dtype=cfg.optimizer_state_dtype)
    sk = schedule_kwargs or {}
    accum = accum if accum is not None else cfg.grad_accum

    def train_step(model, opt_state, batch):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        params = dict(model.named_parameters())
        for p in params.values():
            p.requires_grad_(True)
        if accum > 1:
            loss = aux = torch.zeros((), dtype=torch.float32, device=dev)
            grads = {n: torch.zeros(p.shape, dtype=torch.float32, device=dev)
                     for n, p in params.items()}
            for i in range(accum):
                mb = {k: v.reshape((accum, v.shape[0] // accum)
                                   + tuple(v.shape[1:]))[i]
                      for k, v in batch.items()}
                mloss, mmetrics, mgrads = _grads(model, params, mb, cfg,
                                                 recipe)
                for n, g in mgrads.items():
                    grads[n] += g.float()
                del mgrads
                loss = loss + mloss
                aux = aux + mmetrics["aux"]
            loss = loss / accum
            grads = {n: g / accum for n, g in grads.items()}
            metrics = {"xent": loss, "aux": aux / accum,
                       "tokens": torch.tensor(
                           float(batch["labels"].numel()),
                           dtype=torch.float32, device=dev)}
        else:
            loss, metrics, grads = _grads(model, params, batch, cfg, recipe)
        lr_scale = cosine_schedule(opt_state["step"], **sk)
        om = adamw_update(params, grads, opt_state, opt_cfg, lr_scale)
        return model, opt_state, {**metrics, **om, "loss": loss}

    return train_step, opt_cfg


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
