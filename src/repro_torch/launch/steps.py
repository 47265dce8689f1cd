"""Step builders: the train step and the sharded prefill, decode and
decode-block steps of one (arch, shape, mesh) cell (port of
``repro/launch/steps.py``).

Each builder closes over the config and a ``ShardingRecipe`` and returns
the step a trainer or a server calls on every rank of the mesh with the
same global inputs.  ``jit`` and ``NamedSharding`` have no counterpart:
the steps run eagerly on what each rank holds.  ``params_sharding``,
``opt_sharding``, ``batch_sharding`` and ``cache_sharding`` give the
reference's specs of the parameters, the optimizer state, the batch and
the caches, per dimension the axis (or axes) that splits it: the steps
take a model whose pieces are cut by ``params_sharding`` (``LM(cfg,
device, recipe)``, ``models.model.init_params(..., plan=recipe)``,
``bridge.params_from_jax(..., plan=recipe)``), the train step optimizer
state cut the same way (``train.train_loop.build_state``) and the serve
steps caches laid out as ``cache_sharding`` says
(``models.model.init_caches(..., plan=recipe)``); each checks the
model's specs at its first call.  Like every entry
point of the port, a step runs on the card unless the builder is asked for
the CPU; the builders raise without a CUDA device, and when the recipe's
mesh lives on another device type.  ``step_for`` gives the step of one
production cell with ``meta`` arguments, for the dry-run.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch import sharding as sh
from repro_torch.analysis import op_trace
from repro_torch.config import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, \
    cosine_schedule
from repro_torch.sharding import ShardingRecipe, Spec, param_specs


def _device(recipe: ShardingRecipe, device) -> torch.device:
    """The step's device; it must be the mesh's device type, except for
    ``meta`` (the dry-run's steps, whose mesh lives on a fake process
    group)."""
    dev = resolve_device(device)
    if recipe.mesh is not None and dev.type != "meta" \
            and recipe.mesh.device_type != dev.type:
        raise ValueError(f"the recipe's mesh is on {recipe.mesh.device_type}"
                         f", the step on {dev.type}")
    return dev


def params_sharding(recipe: ShardingRecipe, cfg: ModelConfig
                    ) -> Dict[str, Spec]:
    """The spec of every parameter of ``cfg`` by its state-dict name (the
    reference's ``param_specs`` on the unstacked leaves)."""
    meta = M.LM(cfg, "meta")
    return param_specs(recipe, {n: tuple(p.shape)
                                for n, p in meta.named_parameters()})


def opt_sharding(recipe: ShardingRecipe, cfg: ModelConfig) -> Dict:
    """The optimizer state's specs: the moments as the parameters, the
    step counter whole."""
    ps = params_sharding(recipe, cfg)
    return {"m": ps, "v": ps, "step": ()}


def batch_sharding(recipe: ShardingRecipe, cfg: ModelConfig,
                   shape: ShapeConfig) -> Dict[str, Spec]:
    """The train batch's specs: its rows over the batch axes (each rank
    passes the global batch and takes its rows, ``sharding.batch_rows``)."""
    b = recipe.batch_axes or None
    if cfg.frontend:
        return {"embeddings": (b, None, None), "labels": (b, None)}
    return {"tokens": (b, None), "labels": (b, None)}


def _cache_leaf_spec(recipe: ShardingRecipe, name: str, shape) -> Spec:
    """The reference's ``_cache_leaf_spec``: cache leaves are stacked
    (num_groups, ...); the batch goes over the batch axes, a strip's rows
    over the sequence axes, Mamba's channels over the model axis, each
    where it divides.  Paged pools and their page tables are whole."""
    plan = recipe.plan
    b = recipe.batch_axes or None
    s = recipe.seq_axes or None
    tp = recipe.model_axis

    def fits(dim, axes):
        n = 1
        for a in ((axes,) if isinstance(axes, str) else axes or ()):
            n *= plan.axis_size(a)
        return axes is not None and n > 1 and shape[dim] % n == 0

    def pick(dim, axes):
        return axes if fits(dim, axes) else None

    rest = (None,) * len(shape)
    if name in ("k", "v", "ckv", "krope"):
        return (None, pick(1, b), pick(2, s)) + rest[3:]
    if name == "kpos":
        if len(shape) == 3:                      # per-slot (ng, B, S)
            return (None, pick(1, b), pick(2, s))
        return (None, pick(1, s))
    if name == "conv":
        return (None, pick(1, b), None, pick(3, tp))
    if name == "ssm":
        return (None, pick(1, b), pick(2, tp), None)
    if name in ("kp", "vp", "pages"):
        return rest
    # mlstm C/n/m, slstm c/n/m/h: batch only
    return (None, pick(1, b) if len(shape) > 1 else None) + rest[2:]


def cache_sharding(recipe: ShardingRecipe, cache_shapes) -> Dict:
    """Specs of a (nested) tree of global cache shapes, leaf by leaf."""
    return {k: cache_sharding(recipe, v) if isinstance(v, dict)
            else _cache_leaf_spec(recipe, k, tuple(v))
            for k, v in cache_shapes.items()}


def _check_model(model, cfg: ModelConfig, recipe: ShardingRecipe) -> None:
    """The model must hold the pieces ``params_sharding`` cuts."""
    want = params_sharding(recipe, cfg)
    got = getattr(model, "specs", {})
    for name, spec in want.items():
        if got.get(name, (None,) * len(spec)) != spec:
            raise ValueError(f"{name}: the model holds the piece of spec "
                             f"{got.get(name)}, the recipe's is {spec}; "
                             "build it with the recipe's plan")


def _grads(model, params, batch, cfg: ModelConfig, recipe):
    """(loss, metrics, grads by name) of one (micro)batch; a parameter the
    loss does not reach gets a zero gradient, as ``jax.grad`` gives.
    Under a mesh every rank holds the same (replicated) loss, and its
    gradient is seeded with 1 / (ranks in the mesh): the gradients are
    this rank's share, which ``sharding.sync_grads`` sums (the adjoint
    convention of ``sharding``'s collectives)."""
    loss, metrics = M.loss_fn(model, batch, cfg, recipe)
    names = list(params)
    seed = torch.full_like(loss, 1.0 / sh.mesh_size(recipe))
    gs = torch.autograd.grad(loss, [params[n] for n in names],
                             grad_outputs=seed, allow_unused=True)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, {
        n: torch.zeros_like(params[n]) if g is None else g
        for n, g in zip(names, gs)}


def loss_and_grads(model, batch, cfg: ModelConfig, recipe):
    """(loss, metrics, grads): one batch's loss and metrics (the same on
    every rank) and this rank's piece of every parameter's global
    gradient, in the parameter's dtype, by name; ``batch`` is the global
    batch as tensors on the model's device.  What the train step applies
    with ``accum`` 1."""
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    loss, metrics, grads = _grads(model, params, batch, cfg, recipe)
    return loss, metrics, sh.sync_grads(recipe, model.specs, grads)


def build_train_step(cfg: ModelConfig, recipe: ShardingRecipe,
                     opt_cfg: Optional[AdamWConfig] = None,
                     schedule_kwargs: Optional[dict] = None,
                     accum: Optional[int] = None, device=None):
    """Returns (train_step, opt_cfg).  ``train_step(model, opt_state,
    batch)`` takes the global batch's arrays (numpy or tensors) to the
    step's device, computes the loss and this rank's pieces of its
    gradients (``accum`` microbatches: float32 sums of each rank's shares
    of the gradients, summed over the mesh once and divided by ``accum``,
    as the reference's scan accumulates), scales the learning rate by
    ``cosine_schedule(opt_state["step"], **schedule_kwargs)`` and applies
    ``adamw_update`` with the global gradient norm, updating the model's
    pieces and ``opt_state`` (cut as ``opt_sharding`` says) in place.  It
    returns (model, opt_state, metrics) with the reference's metrics:
    loss, xent, aux, tokens, grad_norm (0-dim tensors, the same on every
    rank).  Under a mesh, a microbatch of B / accum rows takes the recipe
    of its own shape, so its rows split as the batch axes allow."""
    dev = _device(recipe, device)
    check = _checked(cfg, recipe)
    opt_cfg = opt_cfg or AdamWConfig(state_dtype=cfg.optimizer_state_dtype)
    sk = schedule_kwargs or {}
    accum = accum if accum is not None else cfg.grad_accum

    def train_step(model, opt_state, batch):
        check(model)
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        params = dict(model.named_parameters())
        for p in params.values():
            p.requires_grad_(True)
        if accum > 1:
            loss = aux = torch.zeros((), dtype=torch.float32, device=dev)
            grads = {n: torch.zeros(p.shape, dtype=torch.float32, device=dev)
                     for n, p in params.items()}
            B, S = batch["labels"].shape
            micro = recipe if recipe.mesh is None else sh.make_recipe(
                recipe.plan, cfg, ShapeConfig(S, B // accum))
            for i in range(accum):
                mb = {k: v.reshape((accum, v.shape[0] // accum)
                                   + tuple(v.shape[1:]))[i]
                      for k, v in batch.items()}
                mloss, mmetrics, mgrads = _grads(model, params, mb, cfg,
                                                 micro)
                for n, g in mgrads.items():
                    grads[n] += g.float()
                del mgrads
                loss = loss + mloss
                aux = aux + mmetrics["aux"]
            grads = sh.sync_grads(recipe, model.specs, grads)
            loss = loss / accum
            grads = {n: g / accum for n, g in grads.items()}
            metrics = {"xent": loss, "aux": aux / accum,
                       "tokens": torch.tensor(
                           float(batch["labels"].numel()),
                           dtype=torch.float32, device=dev)}
        else:
            loss, metrics, grads = _grads(model, params, batch, cfg, recipe)
            grads = sh.sync_grads(recipe, model.specs, grads)
        lr_scale = cosine_schedule(opt_state["step"], **sk)
        om = adamw_update(params, grads, opt_state, opt_cfg, lr_scale,
                          plan=recipe, specs=model.specs)
        return model, opt_state, {**metrics, **om, "loss": loss}

    return train_step, opt_cfg


def _checked(cfg: ModelConfig, recipe: ShardingRecipe):
    """A check of a step's model at the step's first call for each model."""
    seen = set()

    def check(model):
        if id(model) not in seen:
            with op_trace.paused():
                _check_model(model, cfg, recipe)
            seen.add(id(model))
    return check


def build_prefill_step(cfg: ModelConfig, recipe: ShardingRecipe,
                       device=None):
    dev = _device(recipe, device)
    check = _checked(cfg, recipe)

    def prefill_step(model, batch):
        check(model)
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        return M.prefill_fn(model, batch, cfg, recipe)

    return prefill_step


def build_decode_step(cfg: ModelConfig, recipe: ShardingRecipe,
                      device=None):
    dev = _device(recipe, device)
    check = _checked(cfg, recipe)

    def serve_step(model, caches, token, pos):
        check(model)
        return M.decode_fn(model, caches, torch.as_tensor(token, device=dev),
                           torch.as_tensor(pos, device=dev), cfg, recipe)

    return serve_step


def build_decode_block_step(cfg: ModelConfig, recipe: ShardingRecipe, *,
                            k_steps: int, eos_id: Optional[int],
                            max_len: int, device=None):
    dev = _device(recipe, device)
    check = _checked(cfg, recipe)

    def block_step(model, caches, tokens, positions, alive, remaining):
        check(model)
        t = lambda x: torch.as_tensor(x, device=dev)    # noqa: E731
        return M.decode_block_fn(model, caches, t(tokens), t(positions),
                                 t(alive), t(remaining), cfg, recipe,
                                 k_steps=k_steps, eos_id=eos_id,
                                 max_len=max_len)

    return block_step


def step_for(cfg: ModelConfig, shape: ShapeConfig, recipe: ShardingRecipe,
             device="meta"):
    """(step, args) of one (arch, shape, mesh) cell, the counterpart of
    the reference's ``jitted_step_for``: ``step(*args)`` runs one train,
    prefill or decode step (``shape.kind``) of this rank.  The arguments
    are the model (``models.model.abstract_params`` cut by the recipe's
    plan), with the optimizer state for train and the caches for decode,
    and the inputs of ``models.model.input_specs``, all on ``meta``:
    nothing is allocated, and a step on them computes shapes only."""
    dev = _device(recipe, device)
    if dev.type != "meta":
        raise ValueError("step_for's arguments are meta stand-ins; build a "
                         "model and the builders' steps to run on "
                         f"{dev.type}")
    specs = M.input_specs(cfg, shape, plan=recipe)
    model = M.abstract_params(cfg, recipe)
    if shape.kind == "train":
        step, opt_cfg = build_train_step(cfg, recipe, device=dev)
        opt_state = adamw_init(dict(model.named_parameters()), opt_cfg)
        return step, (model, opt_state, specs)
    if shape.kind == "prefill":
        return build_prefill_step(cfg, recipe, device=dev), (model, specs)
    return build_decode_step(cfg, recipe, device=dev), (
        model, specs["caches"], specs["token"], specs["pos"])
