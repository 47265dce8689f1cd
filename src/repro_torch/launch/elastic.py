"""Elastic supervisor: run → crash → restore → continue (a copy of
``repro/launch/elastic.py``; it imports nothing of torch).

Production story (scaled down to one box): the supervisor launches the
training driver as a subprocess; on a non-zero exit (node failure, OOM,
preemption) it relaunches, and the driver resumes from the latest
*committed* checkpoint, and the data pipeline from the stored step.  (The
reference's relaunch onto another mesh, which reshards every leaf, waits
for the port's multi-device training.)

``FailureInjector`` is the test hook: it kills the child at a configured
step to prove restart-exactness (tests/test_torch_train.py in process;
chip_smoke.py through ``supervise`` and the train CLI).
"""
from __future__ import annotations

import os
import signal
import subprocess
import sys
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence


@dataclass
class SupervisorResult:
    restarts: int
    returncode: int
    log: List[str]


def supervise(cmd: Sequence[str], *, max_restarts: int = 3,
              env: Optional[dict] = None, backoff_s: float = 0.5,
              timeout_s: float = 600.0) -> SupervisorResult:
    """Relaunch ``cmd`` until clean exit or the restart budget is spent."""
    restarts = 0
    log: List[str] = []
    full_env = dict(os.environ)
    if env:
        full_env.update(env)
    while True:
        t0 = time.perf_counter()
        proc = subprocess.run(list(cmd), env=full_env, timeout=timeout_s)
        log.append(f"attempt={restarts} rc={proc.returncode} "
                   f"dur={time.perf_counter() - t0:.1f}s")
        if proc.returncode == 0:
            return SupervisorResult(restarts, 0, log)
        restarts += 1
        if restarts > max_restarts:
            return SupervisorResult(restarts - 1, proc.returncode, log)
        time.sleep(backoff_s * restarts)


class FailureInjector:
    """Deterministic failure hook for tests: dies at a given step, once.

    ``REPRO_FAIL_MARKER`` (a path) makes the injection one-shot across
    supervised restarts — the relaunched process sees the marker and runs
    through, which is exactly a transient node failure."""

    def __init__(self, fail_at_step: Optional[int]):
        self.fail_at = fail_at_step
        env = os.environ.get("REPRO_FAIL_AT_STEP")
        if self.fail_at is None and env:
            self.fail_at = int(env)
        self.marker = os.environ.get("REPRO_FAIL_MARKER")

    def maybe_fail(self, step: int) -> None:
        if self.fail_at is None or step != self.fail_at:
            return
        if self.marker:
            if os.path.exists(self.marker):
                return                      # already fired once
            with open(self.marker, "w") as f:
                f.write(str(step))
        print(f"[elastic] injected failure at step {step}", flush=True)
        os._exit(42)
