"""ISP embedding demo: "send indexes, not data" on a sharded vocab table.

Shows the two execution plans for the same lookup —
  baseline: all-gather the table to the data (the host-only configuration
            of the paper), vs
  ISP:      route indexes to the owning shard, gather locally, sum rows —
with the transfer ledger quantifying the link-byte reduction, and verifies
they produce identical embeddings (single process: shards emulated by
slicing).  The lookups go through ``ops.isp_gather`` and
``ops.isp_gather_pool``, which launch the CUDA kernels on the card and
take their plain versions on the CPU.

Run:  PYTHONPATH=src python examples_torch/isp_embedding_demo.py
      [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core.transfer import embedding_plans
from repro_torch.device import resolve_device
from repro_torch.kernels import ops

V, D, TP = 65_536, 512, 16
N_LOOKUPS = 8_192


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rng = np.random.default_rng(0)
    table = torch.from_numpy(
        rng.normal(size=(V, D)).astype(np.float32)).to(dev)
    idx = torch.from_numpy(
        rng.integers(0, V, (N_LOOKUPS,)).astype(np.int32)).to(dev)

    # dense reference (what a single giant node would do)
    want = table[idx.long()]

    # ISP: each shard owns V/TP rows; masked local gathers; a sum completes it
    vloc = V // TP
    parts = [ops.isp_gather(table[i * vloc:(i + 1) * vloc], idx,
                            shard_offset=i * vloc) for i in range(TP)]
    got = sum(parts)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-6)
    print(f"[isp] {N_LOOKUPS} lookups over {TP} shards: exact match with "
          f"dense")

    base, isp = embedding_plans(N_LOOKUPS, V, D, tp=TP)
    print(f"[transfer] baseline (ship table): {base.total_moved/1e6:.1f} MB "
          f"on the link")
    print(f"[transfer] ISP (ship indexes):    {isp.total_moved/1e6:.1f} MB "
          f"on the link")
    print(f"[transfer] reduction: {isp.reduction_vs(base):.0%} — the paper's "
          f"'data never leaves the drive', applied to a 65k-row table")

    # RecSSD-style fused pooling shrinks the result bytes further
    seg = torch.from_numpy(
        rng.integers(0, 256, (N_LOOKUPS,)).astype(np.int32)).to(dev)
    pooled = sum(ops.isp_gather_pool(table[i * vloc:(i + 1) * vloc], idx,
                                     seg, 256, shard_offset=i * vloc)
                 for i in range(TP))
    dense_pool = torch.zeros((256, D), device=dev).index_add_(
        0, seg.long(), want)
    assert torch.allclose(pooled, dense_pool, rtol=1e-5, atol=1e-4)
    print(f"[pool] fused gather+pool returns {256*D*4/1e6:.1f} MB instead of "
          f"{N_LOOKUPS*D*4/1e6:.1f} MB of rows — RecSSD offload, on-shard")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
