"""Serving CLI of the port: init a model from a seed and serve random
variable-length requests through the continuous-batching engine.

  python -m repro_torch.launch.serve --arch yi-9b [--smoke] --requests N \
      --max-new M --max-len L --num-slots S --page-size P --k-block K \
      --seed X [--device cpu]

Runs on the CUDA device unless ``--device cpu`` is given (the plain
PyTorch path).  Prints the engine's per-tier throughput, the ledger's
link-byte reduction and the KV footprint.  The cluster, fault, SLO and
trace flags of the reference CLI are not ported yet.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.config import get_config, reduced_config
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.train.serve_loop import AdmissionController, ServeEngine


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8,
                    help="serve N random variable-length requests")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--min-prompt", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--num-slots", type=int, default=8)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--num-pages", type=int, default=0,
                    help="KV pool size in pages (0 = dense worst case)")
    ap.add_argument("--k-block", type=int, default=8,
                    help="decode steps fused per tick (1 = per-step loop)")
    ap.add_argument("--host-rate", type=float, default=20.0)
    ap.add_argument("--csd-rate", type=float, default=1.0)
    ap.add_argument("--csds", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args()

    device = resolve_device(args.device)
    cfg = reduced_config(args.arch) if args.smoke else get_config(args.arch)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = M.init_params(cfg, gen, device)
    engine = ServeEngine(
        cfg, params, max_len=args.max_len, num_slots=args.num_slots,
        page_size=args.page_size, num_pages=args.num_pages or None,
        k_block=args.k_block, device=device,
        admission=AdmissionController(args.num_slots,
                                      host_rate=args.host_rate,
                                      csd_rate=args.csd_rate,
                                      n_csds=args.csds))
    rng = np.random.default_rng(args.seed)
    hi = min(args.prompt_len, args.max_len - 1)
    for _ in range(args.requests):
        n = int(rng.integers(min(args.min_prompt, hi), hi + 1))
        engine.submit(rng.integers(0, cfg.vocab_size, n).tolist(),
                      max_new=args.max_new)
    t0 = time.perf_counter()
    results = engine.run_until_complete()
    dt = time.perf_counter() - t0
    n_tok = engine.stats.metrics()["tokens"]
    print(f"[serve] {args.arch} on {device}: {len(results)} requests, "
          f"{n_tok} tokens in {dt:.2f}s ({n_tok / max(dt, 1e-9):.1f} tok/s); "
          f"first: {results[0].tokens[:8] if results else []}")
    for line in engine.stats.summary().splitlines():
        print(f"[serve] {line}")
    kv = engine.kv_stats()
    print(f"[serve] KV[{kv['layout']}]: peak {kv['peak_kv_bytes'] / 1e6:.3f} "
          f"MB vs dense {kv['dense_kv_bytes'] / 1e6:.3f} MB "
          f"(page_size={kv['page_size']})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
