"""Training loop: data → step → metrics → checkpoints (port of
``repro/train/train_loop.py``).

Fault tolerance: restart-exact resume from the latest committed checkpoint
(parameters, optimizer state, data step); an async checkpoint every
``ckpt_every`` steps and a synchronous one at the end; SIGTERM stops the
loop after the current step and that final save still runs (preemption
handling).  Straggler mitigation: the step time feeds the paper's
batch-ratio rebalancer (``core.scheduler.rebalance_shares``) through the
loader's ``set_shares`` every ``rebalance_every`` steps.

The parameters come from the port's ``init_params`` with a
``torch.Generator`` seeded with ``TrainConfig.seed`` on the training
device; the step is ``launch.steps.build_train_step`` on the local plan.
Like every entry point of the port, ``train`` runs on the card unless it
is given ``device="cpu"``.
"""
from __future__ import annotations

import signal
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.checkpoint import CheckpointManager, latest_step
from repro_torch.config import ModelConfig, ShapeConfig
from repro_torch.core.scheduler import rebalance_shares
from repro_torch.data import DataConfig, ShardedLoader, SyntheticTokenSource
from repro_torch.device import resolve_device
from repro_torch.launch import steps as S
from repro_torch.models import model as M
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.sharding import make_plan, make_recipe


@dataclass
class TrainConfig:
    steps: int = 100
    microbatch: int = 0              # 0 = no accumulation
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    keep_ckpts: int = 3
    seed: int = 0
    lr: float = 3e-4
    warmup: int = 20
    rebalance_every: int = 0         # 0 = off (single host)


@dataclass
class TrainState:
    params: Any                      # the LM, updated in place
    opt_state: Any
    step: int


def build_state(cfg: ModelConfig, recipe, opt_cfg: AdamWConfig, seed: int,
                device=None) -> TrainState:
    """Fresh parameters from ``init_params`` with ``torch.Generator`` seeded
    ``seed`` on the device, and zero AdamW state.  The local plan only."""
    M._local_only(recipe)
    dev = resolve_device(device)
    model = M.init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                          dev)
    model.requires_grad_(True)
    return TrainState(params=model, opt_state=adamw_init(
        dict(model.named_parameters()), opt_cfg), step=0)


def _ckpt_tree(state: TrainState) -> Dict:
    return {"params": dict(state.params.named_parameters()),
            "opt": state.opt_state}


@torch.no_grad()
def _load(state: TrainState, tree: Dict) -> None:
    """Copy a restored tree into the state's parameters and optimizer
    state in place."""
    for n, p in state.params.named_parameters():
        p.copy_(tree["params"][n])
    opt = state.opt_state
    for k in ("m", "v"):
        for n, t in opt[k].items():
            t.copy_(tree["opt"][k][n])
    opt["step"] = tree["opt"]["step"]


def train(cfg: ModelConfig, data_cfg: DataConfig, tcfg: TrainConfig,
          mesh=None, source=None,
          metrics_cb: Optional[Callable[[int, Dict], None]] = None,
          device=None) -> TrainState:
    """Train for ``tcfg.steps`` steps (resuming from ``tcfg.ckpt_dir``'s
    latest committed step when there is one).  ``metrics_cb(step,
    metrics)`` gets each step's float metrics and ``step_time_s``, the host
    clock over the step and the read of its metrics."""
    dev = resolve_device(device)
    shape = ShapeConfig(data_cfg.seq_len, data_cfg.global_batch)
    plan = make_plan(mesh, cfg)
    recipe = make_recipe(plan, cfg, shape)
    opt_cfg = AdamWConfig(lr=tcfg.lr, state_dtype=cfg.optimizer_state_dtype)
    step_fn, _ = S.build_train_step(
        cfg, recipe, opt_cfg, schedule_kwargs={"warmup": tcfg.warmup,
                                               "total": tcfg.steps},
        device=dev)

    source = source or SyntheticTokenSource(data_cfg.vocab_size, data_cfg.seed)
    loader = ShardedLoader(source, data_cfg)
    state = build_state(cfg, recipe, opt_cfg, tcfg.seed, dev)

    mgr = None
    if tcfg.ckpt_dir:
        mgr = CheckpointManager(tcfg.ckpt_dir, keep=tcfg.keep_ckpts)
        if latest_step(tcfg.ckpt_dir) is not None:
            tree, man = mgr.restore(_ckpt_tree(state))
            _load(state, tree)
            state.step = int(man["step"])
            print(f"[train] resumed from step {state.step}")

    stop = {"now": False}

    def on_term(sig, frame):
        stop["now"] = True

    old = signal.signal(signal.SIGTERM, on_term)
    step_times: Dict[str, float] = {}
    try:
        while state.step < tcfg.steps and not stop["now"]:
            batch = loader.global_batch_at(state.step)
            t0 = time.perf_counter()
            _, _, metrics = step_fn(state.params, state.opt_state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}
            dt = time.perf_counter() - t0
            state.step += 1

            # straggler rebalancing (multi-host: times come from peers)
            if tcfg.rebalance_every and state.step % tcfg.rebalance_every == 0:
                step_times["host0"] = dt
                if len(loader.shares) > 1:
                    loader.set_shares(rebalance_shares(
                        step_times, loader.shares, data_cfg.global_batch))

            if metrics_cb:
                metrics_cb(state.step, {**metrics, "step_time_s": dt})
            if state.step % tcfg.log_every == 0:
                print(f"[train] step {state.step} loss={metrics['loss']:.4f} "
                      f"({dt:.2f}s)")
            if mgr and state.step % tcfg.ckpt_every == 0:
                mgr.save_async(state.step, _ckpt_tree(state))
        if mgr:
            mgr.wait()
            mgr.save_async(state.step, _ckpt_tree(state))
            mgr.wait()
    finally:
        signal.signal(signal.SIGTERM, old)
    return state
