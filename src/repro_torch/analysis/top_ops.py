"""The ops that take the most of a step (port of the reference's
``analysis/top_ops.py``): op kinds, kernel sites included, ranked by HBM
bytes, collective wire bytes or FLOPs from a step's records; and the
torch-profiler half, ``top_kernels``, the kernels of a profiled step by
device time, each beside the bound its records count.

  PYTHONPATH=src python -m repro_torch.analysis.top_ops \\
      results/dryrun_torch/llama3-405b__train_4k__pod.ops.json.gz --kind mem -n 20
"""
from __future__ import annotations

import argparse
from collections import defaultdict
from typing import Dict, List, Tuple

from repro_torch.analysis.op_trace import OpRecord
from repro_torch.analysis.roofline import bound

# CUDA symbols of each kernel site's launches (the decode kernels share
# their merge pass, ``split_decode.cuh``)
SITE_SYMBOLS = {
    "flash_attention": ("flash_fwd",),
    "paged_decode": ("paged_split_kernel", "merge_splits_kernel"),
    "isp_decode": ("isp_split_kernel", "merge_splits_kernel"),
    "isp_gather": ("isp_gather_kernel",),
    "isp_gather_pool": ("isp_gather_pool_kernel",),
    "topk_similarity": ("topk_partial_kernel", "topk_merge_kernel"),
}


def _rec(r) -> OpRecord:
    return r if isinstance(r, OpRecord) else OpRecord(**r)


def top_ops(records, kind: str = "mem", n: int = 20
            ) -> List[Tuple[float, str, int]]:
    """(value, op, count) of the ``n`` op kinds with the most HBM bytes
    (``mem``), collective wire bytes (``coll``) or product and kernel-site
    FLOPs (``flops``)."""
    agg: Dict[str, List] = defaultdict(lambda: [0.0, 0])
    for r in map(_rec, records):
        val = {"mem": r.bytes, "coll": r.wire_bytes, "flops": r.flops}[kind]
        if not val:
            continue
        agg[r.op][0] += r.count * val
        agg[r.op][1] += r.count
    rows = [(v, op, c) for op, (v, c) in agg.items()]
    rows.sort(reverse=True)
    return rows[:n]


def op_bounds(records) -> Dict[str, Tuple[float, int]]:
    """(bound ms summed over its records, records) by op: each record's
    bytes over the HBM rate or its FLOPs over its dtype's peak (one per
    output element at the elementwise rate), the larger."""
    from repro_torch.analysis.roofline import PEAK_ELEMENTWISE, \
        HBM_BYTES_PER_S
    out: Dict[str, List] = defaultdict(lambda: [0.0, 0])
    for r in map(_rec, records):
        if r.kind in ("view", "collective"):
            continue
        ms = bound(r.bytes, r.flops, r.dtype)[0] if r.flops else max(
            r.bytes / HBM_BYTES_PER_S, r.elementwise / PEAK_ELEMENTWISE
        ) * 1e3
        out[r.op][0] += r.count * ms
        out[r.op][1] += r.count
    return {k: (v[0], v[1]) for k, v in out.items()}


def _site_of(kernel_name: str, sites) -> str:
    hits = [s for s in sites if any(sym in kernel_name
                                    for sym in SITE_SYMBOLS[s])]
    return "+".join(sorted(hits))


def top_kernels(prof, records, n: int = 20) -> List[dict]:
    """The device time of a profiled step (``torch.profiler.profile`` with
    CUDA activity) by op, the ``n`` largest, each beside the bound its
    records count: a hand-written kernel goes to its site (by its CUDA
    symbol, ``SITE_SYMBOLS``), any other kernel to the outermost aten op
    above its launch that the records name ("other" if none does).  Rows:
    {"op", "device_ms", "kernels", "bound_ms", "records"}; the kernel
    sites' rows are kept past the ``n`` largest."""
    from torch.autograd import DeviceType
    bounds = op_bounds(records)
    sites = sorted(k.split(":", 1)[1] for k in bounds
                   if k.startswith("kernel:"))
    named = set(bounds)
    rows: Dict[str, List] = defaultdict(lambda: [0.0, 0])

    walked: Dict[str, int] = defaultdict(int)

    def add(name, ms, owner):
        site = _site_of(name, sites)
        key = f"kernel:{site}" if site else owner or "other"
        rows[key][0] += ms
        rows[key][1] += 1

    def walk(evt, owner):
        if owner is None and evt.name in named:
            owner = evt.name
        for k in evt.kernels:
            add(k.name, k.duration / 1e3, owner)
            walked[k.name] += 1
        for ch in evt.cpu_children:
            walk(ch, owner)
    events = prof.events()
    cpu_names = set()
    for e in events:
        if e.device_type == DeviceType.CPU:
            cpu_names.add(e.name)
            if e.cpu_parent is None:
                walk(e, None)
    # device events no CPU op claims (a launch through ctypes outside any
    # op): by their CUDA symbol; a labelled range's span on the device
    # timeline (a user annotation, named as its CPU range) is no kernel
    for e in events:
        if e.device_type != DeviceType.CUDA:
            continue
        if walked.get(e.name, 0) > 0:
            walked[e.name] -= 1
        elif not (getattr(e, "is_user_annotation", False)
                  or e.name in cpu_names
                  or e.name == "Command Buffer Full"):
            add(e.name, e.time_range.elapsed_us() / 1e3, None)
    out = []
    for op, (ms, cnt) in rows.items():
        keys = [f"kernel:{s}" for s in op[7:].split("+")] \
            if op.startswith("kernel:") else [op]
        b = [bounds[k] for k in keys if k in bounds]
        out.append({"op": op, "device_ms": ms, "kernels": cnt,
                    "bound_ms": sum(x[0] for x in b) if b else None,
                    "records": sum(x[1] for x in b) if b else 0})
    out.sort(key=lambda r: -r["device_ms"])
    return out[:n] + [r for r in out[n:] if r["op"].startswith("kernel:")]


def main(argv=None) -> None:
    from repro_torch.launch.dryrun import load_records
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("path", help="a dry-run's <stem>.ops.json.gz")
    ap.add_argument("--kind", default="mem", choices=["mem", "coll", "flops"])
    ap.add_argument("-n", type=int, default=20)
    args = ap.parse_args(argv)
    unit = {"mem": "GB", "coll": "GB", "flops": "GFLOP"}[args.kind]
    for v, op, cnt in top_ops(load_records(args.path), args.kind, args.n):
        print(f"{v / 1e9:12.2f} {unit:6s} {op:40s} x{cnt}")


if __name__ == "__main__":
    main()
