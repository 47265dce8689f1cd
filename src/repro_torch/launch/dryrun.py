"""Production dry-run: trace one rank's step of every (arch × shape × mesh)
cell (port of the reference's ``launch/dryrun.py``).

The reference lowers and compiles each cell for 256 or 512 forced host
devices and reads XLA's memory and cost analyses.  Here one rank's train,
prefill or decode step runs under the analysis layer's recorder
(``analysis/op_trace.py``) on ``meta`` tensors: parameters, optimizer
state, batch and caches are this rank's pieces as the production plan
cuts them, a fake process group of 256 or 512 ranks stands in for the
mesh, and nothing is allocated or moved.  The step is the port's own
(``launch/steps.step_for``), with its kernel sites counted as their
kernels.

The "card" mesh is one card with no mesh (what ``chip_smoke.py`` trains
on): the whole model on one rank, no process group.  A production shape
does not fit one card, so ``--global-batch``, ``--seq-len`` and
``--layers`` cut a cell to one card's size.

Usage:
  python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k --mesh pod
  python -m repro_torch.launch.dryrun --all --mesh pod        # every live cell
  python -m repro_torch.launch.dryrun --all --mesh multipod   # 2 pods, 512 ranks
  python -m repro_torch.launch.dryrun --arch hymba-1.5b --shape train_4k \
      --mesh card --global-batch 1                            # one card

Writes results/dryrun_torch/<arch>__<shape>__<mesh>.json: bytes a rank
(arguments exact from the local shapes, temporaries counted) against one
card's 80 GB, the counted FLOPs, HBM bytes and collective wire bytes,
and the three roofline terms at the H100's peaks; and beside it
<stem>.ops.json.gz, the op records (``analysis/reanalyze.py`` recomputes
the roofline from them).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gzip
import json
import math
import pathlib
import subprocess
import sys
import time
import traceback
from typing import Optional, Union

import torch

from repro_torch.config import (SHAPES, ModelConfig, ShapeConfig, get_config,
                                get_shape, shape_applicable)
from repro_torch.configs import ASSIGNED

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "results" \
    / "dryrun_torch"

# mesh kind -> (shape, axis names); "pod" and "multipod" are the
# production meshes, "card" one card with no mesh, the others small debug
# meshes
MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model")),
          "card": ((), ()),
          "2x2": ((2, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}


def tree_bytes(tree) -> int:
    """Bytes of every tensor in a (nested) dict, list or module."""
    if isinstance(tree, torch.nn.Module):
        return sum(p.numel() * p.element_size() for p in tree.parameters())
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return 0


def _mesh(kind: str):
    from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
    if kind == "card":
        return None
    if kind in ("pod", "multipod"):
        return make_production_mesh(multi_pod=kind == "multipod",
                                    device="cpu")
    shape, _ = MESHES[kind]
    if len(shape) == 3:
        return make_debug_mesh(shape[1], shape[2], "cpu", pod=shape[0])
    return make_debug_mesh(shape[0], shape[1], "cpu")


def save_records(path: pathlib.Path, records) -> None:
    path.write_bytes(gzip.compress(json.dumps(
        [r.as_dict() for r in records]).encode(), compresslevel=6))


def load_records(path) -> list:
    return json.loads(gzip.decompress(pathlib.Path(path).read_bytes()))


def run_cell(arch: Union[str, ModelConfig], shape: Union[str, ShapeConfig],
             mesh_kind: str, out_dir: Optional[pathlib.Path] = RESULTS,
             fsdp=None, verbose: bool = True) -> dict:
    """Trace one rank (rank 0) of the cell's step and write its JSON (and
    records) under ``out_dir`` (nothing with ``out_dir=None``).  ``arch``
    and ``shape`` are names or configs (a reduced config on a debug mesh
    in the tests).  Raises if the step cannot be traced."""
    from repro_torch.analysis.op_trace import OpRecorder, totals
    from repro_torch.analysis.roofline import (HBM_CAPACITY, from_records,
                                               model_flops_for)
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import fake_group
    from repro_torch.sharding import make_plan, make_recipe

    cfg = get_config(arch) if isinstance(arch, str) else arch
    shape = get_shape(shape) if isinstance(shape, str) else shape
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": cfg.name, "shape": shape.name, "mesh": mesh_kind,
                "status": "skipped", "reason": why}
    dims, _ = MESHES[mesh_kind]
    chips = math.prod(dims)
    with fake_group(chips) if dims else contextlib.nullcontext():
        mesh = _mesh(mesh_kind)
        plan = make_plan(mesh, cfg, fsdp=fsdp)
        recipe = make_recipe(plan, cfg, shape)
        t0 = time.perf_counter()
        fn, args = S.step_for(cfg, shape, recipe, "meta")
        t_build = time.perf_counter() - t0
        mem = {"params": tree_bytes(args[0])}
        if shape.kind == "train":
            mem.update(optimizer=tree_bytes(args[1]),
                       inputs=tree_bytes(args[2]))
        elif shape.kind == "prefill":
            mem.update(inputs=tree_bytes(args[1]))
        else:
            mem.update(caches=tree_bytes(args[1]), inputs=tree_bytes(args[2:]))
        arg_bytes = sum(mem.values())
        rec = OpRecorder()
        with rec:
            out = fn(*args)
        t_trace = time.perf_counter() - t0 - t_build
        del out, fn, args
    records = rec.records
    tot = totals(records)
    rf = from_records(records, chips, model_flops_for(cfg, shape),
                      dtype=cfg.dtype)
    per_rank = arg_bytes + rec.peak_bytes
    result = {
        "arch": cfg.name, "shape": shape.name, "mesh": mesh_kind,
        "status": "ok", "chips": chips, "kind": shape.kind,
        "fsdp": plan.fsdp,
        "batch_axes": recipe.batch_axes, "seq_axes": recipe.seq_axes,
        "memory": {**mem, "argument_bytes": arg_bytes,
                   "temp_bytes": rec.peak_bytes},
        "bytes_per_device": per_rank,
        "fits": per_rank <= HBM_CAPACITY,
        "device_bytes": HBM_CAPACITY,
        "dot_flops": tot.dot_flops,
        "elementwise_flops": tot.elementwise_flops,
        "hbm_bytes": tot.hbm_bytes,
        "collective_bytes": tot.collective_bytes,
        "collective_count_by_kind": tot.count_by_kind,
        "kernel_sites": tot.kernel_sites,
        "roofline": rf.as_dict(),
        "build_s": t_build, "trace_s": t_trace,
    }
    if verbose:
        print(f"[dryrun] {cfg.name} × {shape.name} × {mesh_kind}: "
              f"{per_rank / 1e9:.2f} GB a rank of {HBM_CAPACITY / 1e9:.0f} "
              f"(arguments {arg_bytes / 1e9:.2f}, temporaries "
              f"{rec.peak_bytes / 1e9:.2f}); compute={rf.compute_s:.4f}s "
              f"memory={rf.memory_s:.4f}s collective={rf.collective_s:.4f}s "
              f"dominant={rf.dominant} MFU={rf.mfu:.1%} (counted, H100 "
              f"peaks; trace {t_trace:.1f} s)", flush=True)
    if out_dir is not None:
        out_dir = pathlib.Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        stem = f"{cfg.name}__{shape.name}__{mesh_kind}"
        (out_dir / f"{stem}.json").write_text(
            json.dumps(result, indent=2, default=str))
        save_records(out_dir / f"{stem}.ops.json.gz", records)
    return result


def all_cells():
    for arch in ASSIGNED:
        for shape_name in SHAPES:
            yield arch, shape_name


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="pod",
                    choices=["pod", "multipod", "card"])
    ap.add_argument("--global-batch", type=int, default=None,
                    help="the shape's global batch (default: the shape's)")
    ap.add_argument("--seq-len", type=int, default=None,
                    help="the shape's sequence length (default: the "
                    "shape's)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the arch's depth to this many layers")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--subprocess", action="store_true",
                    help="run each cell in a fresh process")
    ap.add_argument("--out", default=str(RESULTS))
    ap.add_argument("--fsdp", default=None, choices=[None, "on", "off"])
    args = ap.parse_args(argv)
    out_dir = pathlib.Path(args.out)
    fsdp = None if args.fsdp is None else args.fsdp == "on"

    if args.all:
        failures = []
        for arch, shape_name in all_cells():
            target = out_dir / f"{arch}__{shape_name}__{args.mesh}.json"
            if target.exists():
                print(f"[dryrun] skip existing {target.name}")
                continue
            if args.subprocess:
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape_name,
                       "--mesh", args.mesh, "--out", str(out_dir)]
                if args.fsdp:
                    cmd += ["--fsdp", args.fsdp]
                if subprocess.run(cmd).returncode:
                    failures.append((arch, shape_name))
            else:
                try:
                    run_cell(arch, shape_name, args.mesh, out_dir, fsdp=fsdp)
                except Exception:
                    traceback.print_exc()
                    failures.append((arch, shape_name))
        if failures:
            print("[dryrun] FAILURES:", failures)
            return 1
        print("[dryrun] all cells passed")
        return 0

    if not (args.arch and args.shape):
        ap.error("--arch and --shape, or --all")
    cfg, shape = get_config(args.arch), get_shape(args.shape)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    shape = dataclasses.replace(
        shape, global_batch=args.global_batch or shape.global_batch,
        seq_len=args.seq_len or shape.seq_len)
    run_cell(cfg, shape, args.mesh, out_dir, fsdp=fsdp)
    return 0


if __name__ == "__main__":
    sys.exit(main())
