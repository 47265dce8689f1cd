"""End-to-end example: train a small LM for a few hundred steps.

Uses the xLSTM-125m architecture at HALF width ("xlstm-60m-demo": 8
layers at d 384, 34,494,368 params incl. embeddings) on synthetic data,
with checkpointing and resume — kill it mid-run and rerun to see
restart-exact resumption.

Run:  PYTHONPATH=src python examples_torch/train_lm.py [--steps 300]
      [--device cpu]

The default checkpoint directory is the port's own, so a run never resumes
from a checkpoint of another package.
"""
import argparse
import dataclasses

from repro_torch.config import get_config
from repro_torch.data import DataConfig
from repro_torch.models import model as M
from repro_torch.train.train_loop import TrainConfig, train


def demo_config():
    """xlstm-125m at half width: d 384, 4 heads, 8 layers."""
    base = get_config("xlstm-125m")
    return dataclasses.replace(
        base, name="xlstm-60m-demo", d_model=384, num_heads=4,
        num_layers=8, block_pattern=("mlstm", "slstm"), scan_group=0,
        remat="none")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_torch_train_lm")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)

    cfg = demo_config()
    print(f"[example] {cfg.name}: {M.count_params(cfg):,} params")

    data_cfg = DataConfig(seq_len=128, global_batch=8,
                          vocab_size=cfg.vocab_size)
    tcfg = TrainConfig(steps=args.steps, log_every=20, ckpt_every=100,
                       ckpt_dir=args.ckpt_dir, lr=1e-3, warmup=30)
    state = train(cfg, data_cfg, tcfg, device=args.device)
    print(f"[example] finished at step {state.step}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
