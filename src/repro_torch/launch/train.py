"""End-to-end training driver (port of ``repro/launch/train.py``).

Examples:
  # the reduced config on the CPU:
  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-9b --smoke \\
      --steps 3 --global-batch 2 --seq-len 16 --device cpu

  # yi-9b at every published width, 8 of its 48 layers, on the card:
  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-9b \\
      --layers 8 --steps 8 --global-batch 2 --seq-len 4096

The reference's flags, plus ``--device`` (the card unless ``cpu``) and
``--layers`` (the serve CLI's depth cut, so that a full-width model fits
one card).  ``REPRO_FAIL_AT_STEP`` / ``REPRO_FAIL_MARKER`` make the run die
once at that step (``launch.elastic.FailureInjector``).
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch.config import get_config, reduced_config
from repro_torch.data import DataConfig
from repro_torch.launch.elastic import FailureInjector
from repro_torch.train.train_loop import TrainConfig, train


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-trainable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' for "
                         "the plain paths)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to N layers at full width (0 = "
                         "the config's depth)")
    args = ap.parse_args(argv)

    cfg = reduced_config(args.arch) if args.smoke else get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    data_cfg = DataConfig(seq_len=args.seq_len, global_batch=args.global_batch,
                          vocab_size=cfg.vocab_size, seed=args.seed)
    tcfg = TrainConfig(steps=args.steps, lr=args.lr, ckpt_dir=args.ckpt_dir,
                       ckpt_every=args.ckpt_every, log_every=args.log_every,
                       seed=args.seed)

    injector = FailureInjector(None)

    def cb(step, metrics):
        injector.maybe_fail(step)

    state = train(cfg, data_cfg, tcfg, metrics_cb=cb, device=args.device)
    print(f"[train] done at step {state.step}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
