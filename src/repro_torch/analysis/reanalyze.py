"""Recompute the roofline of every dry-run JSON from its saved op records
(port of the reference's ``analysis/reanalyze.py``): for when the
machine model or the analysis changes, with no tracing.

  PYTHONPATH=src python -m repro_torch.analysis.reanalyze [results/dryrun_torch]
"""
from __future__ import annotations

import json
import pathlib
import sys

from repro_torch.analysis.roofline import from_records, model_flops_for
from repro_torch.config import get_config, get_shape


def reanalyze(root) -> list:
    """Rewrite each ``ok`` JSON's roofline under ``root`` from its
    ``.ops.json.gz``; returns the updated results."""
    from repro_torch.launch.dryrun import load_records
    root = pathlib.Path(root)
    done = []
    for j in sorted(root.glob("*.json")):
        ops = root / (j.stem + ".ops.json.gz")
        if not ops.exists():
            continue
        d = json.loads(j.read_text())
        if d.get("status") != "ok":
            continue
        cfg = get_config(d["arch"])
        rf = from_records(load_records(ops), d["chips"],
                          model_flops_for(cfg, get_shape(d["shape"])),
                          dtype=cfg.dtype)
        d["roofline"] = rf.as_dict()
        j.write_text(json.dumps(d, indent=2, default=str))
        print(f"{j.stem}: compute={rf.compute_s:.3f}s "
              f"memory={rf.memory_s:.3f}s collective={rf.collective_s:.3f}s "
              f"dom={rf.dominant} MFU={rf.mfu:.1%}")
        done.append(d)
    return done


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    reanalyze(argv[0] if argv else "results/dryrun_torch")


if __name__ == "__main__":
    main()
