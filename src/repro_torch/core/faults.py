"""Deterministic fault injection + failure detection for the cluster tier.

The paper's deployment target is a 36-drive storage server (Table I /
Fig. 6); at that scale drive stalls, stragglers, and outright failures are
the steady state, not the exception — and in-storage processing moves the
availability responsibility onto the drive-side stack (ZCSD makes the same
argument for CSD runtimes owning failure semantics).  This module is the
pure half of that layer; ``train.cluster_loop.ClusterEngine`` consults it
each tick:

  * ``FaultSchedule`` — a seeded, replayable list of per-drive
    ``FaultEvent``s.  Five kinds:
      stall            the drive makes no progress while the event is
                       active (work sits, its virtual clock stops);
      slowdown         the drive's measured tick time is multiplied by
                       ``factor`` (>1 = slower) while active;
      crash            the drive stops responding permanently — the
                       cluster is NOT told (ground truth stays hidden);
                       only the failure layer can discover it and
                       trigger ``fail()``;
      worker_hang      the drive's worker thread really blocks for
                       ``duration`` REAL seconds at the dispatch boundary
                       (the in-flight command is lost; only a heartbeat
                       watchdog can catch it).  In the serial step loop —
                       where there is no thread to block — a hang is
                       approximated as a stall over the event window;
      page_pool_clamp  only ``factor`` (0..1) of the drive's KV page pool
                       is admissible while active — admission
                       backpressures, in-flight requests are untouched.
    Events are timed on either the cluster TICK index (``at_tick`` —
    exactly reproducible run-to-run) or the cluster wall CLOCK (``at_s`` —
    the MTTF/MTTR view; tick times are measured, so clock-based landing
    points jitter, which is fine: greedy decode makes token outputs
    identical under ANY fault landing).  ``from_rates`` draws a schedule
    from exponential MTTF/MTTR distributions with a fixed seed, and
    ``save``/``load`` round-trip a schedule through jsonl (one event per
    line, mirroring ``data.workload.save_trace``) so a chaos run can be
    replayed exactly.

  * ``FailureDetector`` — the cluster-visible health state machine
    (HEALTHY → SUSPECT → DEAD).  It sees only what a host could see: the
    per-drive virtual clocks and whether a drive with work progressed this
    tick.  A drive with work that makes no progress while the leading
    clock advances more than ``suspect_after_s`` (or for ``suspect_ticks``
    consecutive ticks) goes SUSPECT; past ``dead_after_s`` /
    ``dead_ticks`` it goes DEAD, which the engine turns into the existing
    ``fail()`` path automatically.  A SUSPECT drive that progresses again
    recovers to HEALTHY.  This clock-threshold detector is the serial step
    loop's failure oracle; the concurrent worker runtime uses
    ``core.runtime.HeartbeatWatchdog`` (same state machine, driven by
    missed heartbeats and real wall time) instead.

Everything is plain-Python and deterministic given the event list, so
token identity under any fault schedule is property-testable.

A copy of ``repro/core/faults.py``, which has no JAX in it.
"""
from __future__ import annotations

import dataclasses
import json
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

FAULT_KINDS = ("stall", "slowdown", "crash", "worker_hang", "page_pool_clamp")

HEALTHY = "healthy"
SUSPECT = "suspect"
DEAD = "dead"


@dataclass(frozen=True)
class FaultEvent:
    """One injected fault on one drive.

    Exactly one of ``at_tick`` / ``at_s`` must be set; ``duration`` is in
    the same unit (ticks or seconds).  ``factor`` is the slowdown
    multiplier (>= 1) or the admissible pool fraction (0..1) for
    ``page_pool_clamp``; crashes ignore both duration and factor (death is
    permanent — recovery is a *new drive*, not this event ending).  For
    ``worker_hang`` the concurrent runtime blocks the worker thread for
    ``duration`` REAL seconds when the first command lands in the event
    window; the serial loop approximates the window as a stall.
    """
    drive_id: int
    kind: str
    at_tick: Optional[int] = None
    at_s: Optional[float] = None
    duration: float = 0.0
    factor: float = 1.0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"fault kind must be one of {FAULT_KINDS}, "
                             f"got {self.kind!r}")
        if (self.at_tick is None) == (self.at_s is None):
            raise ValueError("exactly one of at_tick / at_s must be set")
        if self.drive_id < 0:
            raise ValueError(f"negative drive_id {self.drive_id}")
        if self.kind != "crash" and \
                (self.duration < 0 or not math.isfinite(self.duration)):
            raise ValueError(f"duration must be finite and >= 0, "
                             f"got {self.duration}")
        if self.kind == "worker_hang" and not self.duration > 0:
            raise ValueError(f"worker_hang duration must be > 0 (real "
                             f"seconds the thread blocks), "
                             f"got {self.duration}")
        if self.kind == "slowdown" and not (self.factor >= 1.0
                                            and math.isfinite(self.factor)):
            raise ValueError(f"slowdown factor must be finite and >= 1, "
                             f"got {self.factor}")
        if self.kind == "page_pool_clamp" and not 0.0 <= self.factor <= 1.0:
            raise ValueError(f"page_pool_clamp factor must be in [0, 1], "
                             f"got {self.factor}")

    @property
    def start(self) -> float:
        return float(self.at_tick if self.at_tick is not None else self.at_s)

    @property
    def tick_based(self) -> bool:
        return self.at_tick is not None

    def active(self, tick: int, clock: float) -> bool:
        now = tick if self.tick_based else clock
        if self.kind == "crash":
            return now >= self.start
        return self.start <= now < self.start + self.duration

    @property
    def end(self) -> float:
        """First instant the event is over (inf for crashes)."""
        if self.kind == "crash":
            return math.inf
        return self.start + self.duration


class FaultSchedule:
    """A replayable set of fault events the cluster consults each tick."""

    def __init__(self, events: Sequence[FaultEvent]):
        self.events: List[FaultEvent] = sorted(
            events, key=lambda e: (e.start, e.drive_id, e.kind))
        self._crashed: set = set()   # crash events already delivered
        self._begun: set = set()     # events already counted as injected

    # -- construction ---------------------------------------------------------

    @classmethod
    def from_spec(cls, spec: Sequence[Dict]) -> "FaultSchedule":
        """Build from a list of plain dicts (the --fault-trace JSON form):
        ``{"drive_id": 1, "kind": "stall", "at_tick": 5, "duration": 10}``."""
        return cls([FaultEvent(**dict(e)) for e in spec])

    @classmethod
    def from_rates(cls, n_drives: int, mttf_s: float, mttr_s: float,
                   seed: int = 0, horizon_s: float = 60.0,
                   crash_prob: float = 0.1, slowdown_factor: float = 3.0,
                   clamp_frac: float = 0.25) -> "FaultSchedule":
        """Draw a schedule from exponential MTTF/MTTR distributions.

        Per drive, fault arrivals are a Poisson process with mean
        inter-arrival ``mttf_s``; each fault is a crash with probability
        ``crash_prob`` (permanent — the drive draws no further events),
        otherwise a stall / slowdown / page_pool_clamp (uniform) lasting
        an Exp(``mttr_s``) repair window.  Same seed, same schedule.
        """
        if n_drives < 1:
            raise ValueError("need at least one drive")
        if not (mttf_s > 0 and mttr_s > 0):
            raise ValueError("mttf_s and mttr_s must be positive")
        if not 0.0 <= crash_prob <= 1.0:
            raise ValueError(f"crash_prob must be in [0, 1], got {crash_prob}")
        rng = np.random.default_rng(seed)
        transient = ("stall", "slowdown", "page_pool_clamp")
        events: List[FaultEvent] = []
        for d in range(n_drives):
            t = 0.0
            while True:
                t += float(rng.exponential(mttf_s))
                if t >= horizon_s:
                    break
                if float(rng.random()) < crash_prob:
                    events.append(FaultEvent(d, "crash", at_s=t))
                    break                       # dead drives stay dead
                kind = transient[int(rng.integers(len(transient)))]
                dur = float(rng.exponential(mttr_s))
                factor = {"stall": 1.0, "slowdown": slowdown_factor,
                          "page_pool_clamp": clamp_frac}[kind]
                events.append(FaultEvent(d, kind, at_s=t, duration=dur,
                                         factor=factor))
                t += dur                        # repair before the next fault
        return cls(events)

    # -- persistence (mirrors data.workload.save_trace / load_trace) ----------

    def save(self, path: str) -> None:
        """Write the schedule as jsonl, one event per line, so a chaos
        run's exact schedule can be committed and replayed."""
        with open(path, "w") as f:
            for e in self.events:
                rec = {k: v for k, v in dataclasses.asdict(e).items()
                       if v is not None}
                f.write(json.dumps(rec, sort_keys=True) + "\n")

    @classmethod
    def load(cls, path: str) -> "FaultSchedule":
        """Read a schedule back.  Accepts both the jsonl form written by
        ``save`` and the legacy ``--fault-trace`` JSON-list form."""
        with open(path) as f:
            text = f.read().strip()
        if not text:
            return cls([])
        if text.startswith("["):
            return cls.from_spec(json.loads(text))
        return cls.from_spec([json.loads(line)
                              for line in text.splitlines() if line.strip()])

    # -- per-tick queries (consulted by ClusterEngine.step) -------------------

    def begins(self, tick: int, clock: float) -> List[FaultEvent]:
        """Events becoming active this tick, each reported exactly once
        (the engine's ``faults_injected`` counter)."""
        out = []
        for i, e in enumerate(self.events):
            if i not in self._begun and e.active(tick, clock):
                self._begun.add(i)
                out.append(e)
        return out

    def crashes(self, tick: int, clock: float) -> List[int]:
        """Drives whose crash event fires now (each delivered once)."""
        out = []
        for i, e in enumerate(self.events):
            if e.kind == "crash" and i not in self._crashed \
                    and e.active(tick, clock):
                self._crashed.add(i)
                out.append(e.drive_id)
        return sorted(set(out))

    def stalled(self, drive_id: int, tick: int, clock: float) -> bool:
        """True while a stall, a worker_hang window, or a delivered crash
        (a crashed drive is a permanent stall until the failure layer
        notices) holds the drive.  Pure — safe to consult from a worker
        thread without touching the delivered-event bookkeeping."""
        return any(e.drive_id == drive_id
                   and e.kind in ("stall", "crash", "worker_hang")
                   and e.active(tick, clock) for e in self.events)

    def crash_active(self, drive_id: int, tick: int, clock: float) -> bool:
        """Pure crash check (no delivered-set mutation) — the concurrent
        worker's exit condition: a crashed worker thread terminates and
        the cluster only ever sees the silence."""
        return any(e.drive_id == drive_id and e.kind == "crash"
                   and e.active(tick, clock) for e in self.events)

    def hangs(self, drive_id: int, tick: int, clock: float
              ) -> List[Tuple[int, float]]:
        """Active worker_hang events for a drive as ``(event_index,
        real_seconds)`` pairs.  Pure; the worker tracks which indices it
        has already served so each hang blocks the thread exactly once."""
        return [(i, float(e.duration)) for i, e in enumerate(self.events)
                if e.drive_id == drive_id and e.kind == "worker_hang"
                and e.active(tick, clock)]

    def slowdown(self, drive_id: int, tick: int, clock: float) -> float:
        """Multiplier on the drive's tick time (active slowdowns compound)."""
        f = 1.0
        for e in self.events:
            if e.drive_id == drive_id and e.kind == "slowdown" \
                    and e.active(tick, clock):
                f *= e.factor
        return f

    def clamp(self, drive_id: int, tick: int, clock: float) -> float:
        """Admissible fraction of the drive's KV page pool (min of active
        clamps; 1.0 = unclamped)."""
        f = 1.0
        for e in self.events:
            if e.drive_id == drive_id and e.kind == "page_pool_clamp" \
                    and e.active(tick, clock):
                f = min(f, e.factor)
        return f

    # -- progress boundaries (deadlock avoidance) -----------------------------

    def next_tick_boundary(self, tick: int) -> Optional[int]:
        """The next tick index at which some tick-based event starts or
        ends (None when no tick-based change is pending)."""
        best = None
        for e in self.events:
            if not e.tick_based:
                continue
            for b in (e.start, e.end):
                if math.isfinite(b) and b > tick and \
                        (best is None or b < best):
                    best = b
        return None if best is None else int(best)

    def next_clock_boundary(self, clock: float) -> Optional[float]:
        """The next wall-clock time at which some clock-based event starts
        or ends — where a no-progress tick can fast-forward to so stall
        windows and deadlines elapse instead of deadlocking."""
        best = None
        for e in self.events:
            if e.tick_based:
                continue
            for b in (e.start, e.end):
                if math.isfinite(b) and b > clock and \
                        (best is None or b < best):
                    best = b
        return best


class FailureDetector:
    """SUSPECT/DEAD health tracking from cluster-visible signals only.

    Per tick and per drive the engine reports the leading virtual clock,
    whether the drive had work, and whether it progressed (stepped).  Lag
    is measured as *leading-clock advance since the drive's last
    productive tick* — not absolute clock skew, which would latch forever
    after a recovered stall (a drive that lost 5s of busy time stays 5s
    behind even once healthy).
    """

    def __init__(self, n_drives: int, suspect_after_s: float = 0.25,
                 suspect_ticks: int = 20,
                 dead_after_s: Optional[float] = None,
                 dead_ticks: Optional[int] = None):
        if n_drives < 1:
            raise ValueError("need at least one drive")
        if suspect_after_s <= 0 or suspect_ticks <= 0:
            raise ValueError("suspect thresholds must be positive")
        self.n_drives = n_drives
        self.suspect_after_s = float(suspect_after_s)
        self.suspect_ticks = int(suspect_ticks)
        self.dead_after_s = float(4.0 * suspect_after_s
                                  if dead_after_s is None else dead_after_s)
        self.dead_ticks = int(4 * suspect_ticks
                              if dead_ticks is None else dead_ticks)
        if self.dead_after_s < self.suspect_after_s or \
                self.dead_ticks < self.suspect_ticks:
            raise ValueError("dead thresholds must not be below suspect "
                             "thresholds")
        self.health: List[str] = [HEALTHY] * n_drives
        self._zero_ticks = [0] * n_drives
        self._lead_at_progress = [0.0] * n_drives

    def observe(self, drive_id: int, lead: float, progressed: bool,
                has_work: bool) -> Tuple[str, str]:
        """One tick's evidence for one drive; returns (old, new) health.
        DEAD is terminal — the engine fails the drive on that edge."""
        old = self.health[drive_id]
        if old == DEAD:
            return old, old
        if progressed or not has_work:
            # an idle drive's clock legitimately stands still; never
            # suspect it — and a productive tick clears any suspicion
            self._zero_ticks[drive_id] = 0
            self._lead_at_progress[drive_id] = lead
            self.health[drive_id] = HEALTHY
            return old, HEALTHY
        self._zero_ticks[drive_id] += 1
        lag = lead - self._lead_at_progress[drive_id]
        new = old
        if self._zero_ticks[drive_id] >= self.dead_ticks or \
                lag > self.dead_after_s:
            new = DEAD
        elif self._zero_ticks[drive_id] >= self.suspect_ticks or \
                lag > self.suspect_after_s:
            new = SUSPECT
        self.health[drive_id] = new
        return old, new

    def mark_dead(self, drive_id: int) -> None:
        """Operator/engine-initiated death (explicit ``fail()``) — keep the
        detector's view consistent with ground truth it was told about."""
        self.health[drive_id] = DEAD

    @property
    def suspects(self) -> List[int]:
        return [d for d, h in enumerate(self.health) if h == SUSPECT]

    @property
    def dead(self) -> List[int]:
        return [d for d, h in enumerate(self.health) if h == DEAD]
