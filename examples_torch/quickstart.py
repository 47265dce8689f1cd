"""Quickstart: the port's public API in ~60 lines.

Run:  PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]

Entry points run on the CUDA device unless ``--device cpu`` is given; the
weights are drawn from seed 0 on the CPU's generator and copied to the
device (``model.seeded_params``).
"""
import argparse

import numpy as np
import torch

from repro_torch.config import get_config, get_shape, list_configs, \
    reduced_config
from repro_torch.device import resolve_device
from repro_torch.models import model as M


def run(cfg, model, device):
    """2-3: a loss on a random batch, then a prefill and five greedy decode
    steps on resident KV caches.  Returns (loss, the last step's tokens)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    on = lambda a: torch.from_numpy(a.astype(np.int32)).to(dev)  # noqa: E731
    batch = {
        "tokens": on(rng.integers(0, cfg.vocab_size, (2, 32))),
        "labels": on(rng.integers(0, cfg.vocab_size, (2, 32))),
    }
    with torch.no_grad():
        loss, metrics = M.loss_fn(model, batch, cfg)
        print(f"initial loss: {float(loss):.3f}")

        # 3. Serve: prefill a prompt, then decode greedily with resident KV
        #    caches.
        nxt, _ = M.prefill_fn(model, {"tokens": batch["tokens"]}, cfg)
        caches = M.init_caches(cfg, batch=2, max_len=48, device=dev)
        tok = batch["tokens"][:, :1]
        for t in range(5):
            nxt, caches = M.decode_fn(model, caches, tok, t, cfg)
            tok = nxt[:, None].to(torch.int32)
    tokens = [int(x) for x in nxt.cpu()]
    print("greedy tokens:", tokens)
    return float(loss), tokens


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print("Registered architectures:", ", ".join(list_configs()))

    # 1. Pick an architecture.  Full configs are the assigned production
    #    sizes; reduced_config gives the same wiring at CPU scale.
    cfg = reduced_config("gemma3-12b")
    print(f"\n{cfg.name}: {cfg.num_layers}L d={cfg.d_model} "
          f"pattern={cfg.block_pattern} params={M.count_params(cfg):,}")

    # 2. Initialize and run a training step's loss, then serve.
    model = M.seeded_params(cfg, 0, dev)
    run(cfg, model, dev)

    # 4. The production mesh is one function away (requires 256/512
    #    devices — see python -m repro_torch.launch.dryrun for the full
    #    multi-pod dry-run):
    shape = get_shape("train_4k")
    full = get_config("gemma3-12b")
    print(f"\nproduction cell: {full.name} × {shape.name} = "
          f"{shape.tokens:,} tokens/step, {M.count_params(full):,} params")
    print("dry-run: PYTHONPATH=src python -m repro_torch.launch.dryrun "
          "--arch gemma3-12b --shape train_4k --mesh multipod")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
