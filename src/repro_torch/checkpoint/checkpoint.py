"""Sharded, async, restart-safe checkpointing (port of
``repro/checkpoint/checkpoint.py``, with its layout).

Layout (one directory per step):
    <dir>/step_000000123/
        manifest.json        # leaf paths, shapes, dtypes, file map
        shard_<host>.npz     # this host's parameter/optimizer leaves
    <dir>/step_000000123.done   # commit marker (atomic rename)

A tree is a nested dict of tensors (``{"params": {name: tensor},
"opt": {"m": ..., "v": ..., "step": ...}}``); a leaf's key is its path
joined by "/".  bfloat16 leaves are stored as their uint16 bit pattern
with the dtype in the manifest, as the reference stores them.

  * every host writes only its own shard file;
  * two-phase commit: the .done marker is renamed into place only after
    the shard file is fsync'd, so a crash mid-save never corrupts the
    latest checkpoint;
  * async: ``CheckpointManager.save_async`` copies every leaf to host
    memory before it returns and writes on a background thread.  The
    reference may take that copy on the thread, since JAX arrays never
    change; here the optimizer updates the parameters in place right
    after, so the snapshot must be complete first;
  * restore: each leaf goes onto the template leaf's device and dtype;
  * re-sharding: under a sharding plan every leaf is saved as its global
    array (each rank's piece all-gathered by the leaf's spec, then rank 0
    writes, with the same two-phase commit), and ``restore(...,
    plan=...)`` cuts each global leaf by that plan's spec of it
    (``sharding.leaf_spec``, keyed on the leaf's parameter name), so a
    checkpoint saved on one mesh restores on another, or on none — the
    reference's ``restore_checkpoint(..., shardings=)``.
"""
from __future__ import annotations

import json
import os
import pathlib
import re
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import sharding as sh


def _encode(t: torch.Tensor):
    """(numpy array, dtype name) of a host tensor; bf16 as its uint16 bits."""
    name = str(t.dtype).removeprefix("torch.")
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), name
    return t.numpy(), name


def _decode(a: np.ndarray, name: str) -> torch.Tensor:
    if name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    flat: Dict[str, Any] = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            flat.update(_flatten(v, key + "/"))
        else:
            flat[key] = v
    return flat


def _unflatten_like(template, flat: Dict[str, torch.Tensor],
                    prefix: str = ""):
    out = {}
    for k, v in template.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out[k] = _unflatten_like(v, flat, key + "/")
        else:
            out[k] = flat[key].to(device=v.device, dtype=v.dtype)
    return out


def _meshed(plan) -> bool:
    return plan is not None and plan.mesh is not None


def _global(plan, spec, t: torch.Tensor) -> torch.Tensor:
    """The global leaf of which ``t`` is this rank's piece (``spec``)."""
    for dim, axes in enumerate(spec or ()):
        if axes is not None:
            t = sh.all_gather(plan, t, axes, dim)
    return t


def _snapshot(tree, plan=None, specs=None) -> Dict[str, torch.Tensor]:
    """Every leaf copied to host memory now (a blocking copy from the
    card; a clone on the CPU), keyed by path.  Under a mesh (``plan``)
    each leaf is first gathered to its global array by its spec in
    ``specs`` (a tree like ``tree``; a leaf without one is whole): every
    rank takes part, in the same order."""
    flat = _flatten(tree)
    spec_of = _flatten(specs or {}) if _meshed(plan) else {}
    with torch.no_grad():
        return {k: _global(plan, spec_of.get(k), v.detach()).to(
            "cpu", copy=True) for k, v in flat.items()}


def _writer(plan) -> bool:
    """Whether this process writes: every process without a mesh, rank 0
    of the group under one."""
    return not _meshed(plan) or dist.get_rank() == 0


def save_checkpoint(directory, step: int, tree, *, host: str = "host0",
                    extra: Optional[dict] = None, plan=None,
                    specs=None) -> Optional[pathlib.Path]:
    """Synchronous sharded save with two-phase commit.  Under a mesh
    (``plan``, with each leaf's spec in ``specs``) every rank calls it;
    the global arrays are written by rank 0, which returns the step's
    directory (the others None)."""
    flat = _snapshot(tree, plan, specs)
    if not _writer(plan):
        return None
    return _write(pathlib.Path(directory), step, flat, host, extra)


def _write(directory: pathlib.Path, step: int,
           flat: Dict[str, torch.Tensor], host: str,
           extra: Optional[dict]) -> pathlib.Path:
    step_dir = directory / f"step_{step:09d}"
    tmp_dir = directory / f".tmp_step_{step:09d}_{host}"
    tmp_dir.mkdir(parents=True, exist_ok=True)
    step_dir.mkdir(parents=True, exist_ok=True)
    arrays, dtypes = {}, {}
    for k, v in flat.items():
        arrays[k], dtypes[k] = _encode(v)
    manifest = {
        "step": step,
        "extra": extra or {},
        "leaves": {k: {"shape": list(a.shape), "dtype": dtypes[k],
                       "file": f"shard_{host}.npz"}
                   for k, a in arrays.items()},
    }
    shard_path = tmp_dir / f"shard_{host}.npz"
    with open(shard_path, "wb") as f:
        np.savez(f, **{k.replace("/", "__"): a for k, a in arrays.items()})
        f.flush()
        os.fsync(f.fileno())
    os.replace(shard_path, step_dir / f"shard_{host}.npz")
    man_path = tmp_dir / "manifest.json"
    man_path.write_text(json.dumps(manifest))
    os.replace(man_path, step_dir / "manifest.json")
    tmp_dir.rmdir()
    done = directory / f"step_{step:09d}.done"
    marker = directory / f".tmp_done_{step:09d}_{host}"
    # persisted wall-clock stamp: the .done marker records WHEN the
    # checkpoint landed for humans/tooling comparing runs across restarts;
    # perf_counter has no epoch and would be meaningless on disk
    marker.write_text(str(time.time()))  # lint: disable=banned-api
    os.replace(marker, done)                       # atomic commit
    return step_dir


def latest_step(directory) -> Optional[int]:
    directory = pathlib.Path(directory)
    if not directory.exists():
        return None
    steps = []
    for p in directory.glob("step_*.done"):
        m = re.match(r"step_(\d+)\.done", p.name)
        if m:
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def restore_checkpoint(directory, template, *, step: Optional[int] = None,
                       plan=None):
    """Restore into the template's structure (a nested dict of tensors),
    each leaf on the template leaf's device and in its dtype.  With a
    sharding ``plan`` with a mesh, each leaf is this rank's piece of the
    saved global array by the plan's spec of it (the template holds
    pieces).  Returns (tree, manifest)."""
    directory = pathlib.Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {directory}")
    step_dir = directory / f"step_{step:09d}"
    manifest = json.loads((step_dir / "manifest.json").read_text())
    leaves_meta = manifest.get("leaves", {})
    flat: Dict[str, torch.Tensor] = {}
    for shard_file in sorted(step_dir.glob("shard_*.npz")):
        with np.load(shard_file) as z:
            for k in z.files:
                key = k.replace("__", "/")
                meta = leaves_meta.get(key, {})
                t = _decode(z[k], meta.get("dtype", str(z[k].dtype)))
                if _meshed(plan):
                    name = key.rsplit("/", 1)[-1]
                    t = sh.cut(plan, sh.leaf_spec(plan, name, t.shape), t)
                flat[key] = t
    return _unflatten_like(template, flat), manifest


class CheckpointManager:
    """Async manager: snapshot on the caller's thread, write off it, keep
    the last ``keep``.  Under a mesh (``plan``) every rank calls
    ``save_async`` with the leaves' specs; the snapshot is the global
    arrays and rank 0 alone writes them."""

    def __init__(self, directory, *, keep: int = 3, host: str = "host0",
                 plan=None):
        self.directory = pathlib.Path(directory)
        self.keep = keep
        self.host = host
        self.plan = plan
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save_async(self, step: int, tree, extra: Optional[dict] = None,
                   specs=None) -> None:
        """Copy every leaf to host memory (its global array under a mesh,
        by ``specs``), then return; the writer thread only writes those
        bytes, so the caller may update the tree in place at once."""
        self.wait()                                 # one in flight at a time
        snapshot = _snapshot(tree, self.plan, specs)
        if not _writer(self.plan):
            return

        def work():
            try:
                _write(self.directory, step, snapshot, self.host, extra)
                self._gc()
            except BaseException as e:      # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def _gc(self) -> None:
        steps = sorted(
            int(re.match(r"step_(\d+)\.done", p.name).group(1))
            for p in self.directory.glob("step_*.done"))
        for s in steps[: -self.keep]:
            done = self.directory / f"step_{s:09d}.done"
            done.unlink(missing_ok=True)
            sd = self.directory / f"step_{s:09d}"
            if sd.exists():
                for f in sd.iterdir():
                    f.unlink()
                sd.rmdir()

    def restore(self, template, step: Optional[int] = None, plan=None):
        """``restore_checkpoint`` from this manager's directory, cut by
        ``plan`` (default: the manager's)."""
        return restore_checkpoint(self.directory, template, step=step,
                                  plan=self.plan if plan is None else plan)
