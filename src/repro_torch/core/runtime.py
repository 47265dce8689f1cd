"""Concurrent drive-worker runtime: workers, heartbeats, watchdog.

The paper's storage server is 36 drives computing *in parallel*; the
cluster tier's serial step loop modeled that overlap with per-drive
virtual clocks, so failure detection had to infer death from clock lag.
This module provides the real thing: one ``DriveWorker`` thread per
drive, fed tick commands over a per-drive ``queue.Queue`` by the
coordinator (the ``ClusterEngine.step`` caller), replying with
``Heartbeat``s on a shared monitor queue.  Failure is then what it is in
production — *silence on a real channel* — and the
``HeartbeatWatchdog`` drives the HEALTHY -> SUSPECT -> DEAD state
machine from missed heartbeats and wall-clock silence, not modeled lag.

Protocol (fork-join per tick):

  coordinator                      worker (one per drive)
  -----------                      ----------------------
  dispatch requests                loop:
  put WorkerCommand(tick,epoch) ->   get command
  join on monitor queue              consult PURE fault predicates only:
  (dispatch_timeout_s)                 crash   -> thread exits (silence)
    absorb tick_done payloads          hang    -> really block; command
    under the cluster lock                        lost; late "alive" beat
  watchdog.observe(...) per drive      stall   -> "alive" beat, no work
  DEAD edge -> engine.fail()         else: lock drive, step engine,
                                       pad to emulated service time,
                                     <- put Heartbeat(tick_done, payload)

Workers never touch shared cluster state: the engine step runs under the
drive's own lock, and everything shared (queue, admission, router,
ledgers, stats) is mutated by the coordinator while absorbing payloads.
``fail()`` bumps the drive's epoch under the drive lock; stale-epoch
commands and heartbeats are discarded on both sides, which is what makes
kill-while-mid-tick race-safe.

Ground truth stays hidden: workers consult only the pure
``FaultSchedule`` predicates (``crash_active`` / ``hangs`` /
``stalled``), never the delivered-set mutating queries — the watchdog
can only learn about a fault from the missing heartbeat.

A copy of ``repro/core/runtime.py``, which has no JAX in it.
"""
from __future__ import annotations

import queue
import random
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..core.faults import DEAD, HEALTHY, SUSPECT, FaultSchedule
from ..core.telemetry import NULL_HUB as _NULL


@dataclass(frozen=True)
class WorkerCommand:
    """One coordinator -> worker message.  ``kind`` is "tick" or "stop";
    ``epoch`` is the drive's fail-epoch at dispatch time — a worker that
    receives a stale epoch discards the command (the drive was failed
    while the command was in flight)."""
    kind: str
    tick: int = 0
    clock: float = 0.0
    epoch: int = 0


@dataclass(frozen=True)
class Heartbeat:
    """One worker -> coordinator message on the shared monitor queue.

    ``kind`` is "tick_done" (payload carries the step results) or
    "alive" (liveness only: a stalled drive's firmware still answers
    pings, and a worker waking from a hang announces it lost the
    command).  ``busy_s`` is the worker's real wall time for the command
    including the emulated-service-time padding; the coordinator turns it
    into the drive's measured tick cost."""
    drive_id: int
    kind: str
    tick: int
    epoch: int
    busy_s: float = 0.0
    payload: Optional[Dict[str, Any]] = None


class DriveWorker(threading.Thread):
    """One drive's worker thread.

    ``step_fn(tick, clock)`` is supplied by the cluster engine and runs
    the drive's engine tick under the drive lock, returning a payload
    dict ``{"finished", "obs", "raw_s"}`` or None when there was nothing
    to do (or the drive was failed/stale meanwhile).  The worker owns the
    generic machinery: the command loop, pure-predicate fault behavior,
    service-time emulation (floor + injected slowdown + modeled drive
    speed + jitter, all slept with the GIL released), and heartbeats.
    """

    def __init__(self, drive_id: int, step_fn: Callable[[int, float], Optional[dict]],
                 commands: "queue.Queue[WorkerCommand]",
                 monitor: "queue.Queue[Heartbeat]",
                 stop_event: threading.Event,
                 epoch_of: Callable[[], int],
                 faults: Optional[FaultSchedule] = None,
                 speed: float = 1.0, min_tick_s: float = 0.0,
                 jitter_s: float = 0.0, seed: int = 0,
                 telemetry=None):
        super().__init__(name=f"drive-worker-{drive_id}", daemon=True)
        self.drive_id = drive_id
        self.step_fn = step_fn
        self.commands = commands
        self.monitor = monitor
        self.stop_event = stop_event
        self.epoch_of = epoch_of
        self.faults = faults
        # optional telemetry hub: heartbeats become instant events on the
        # f"worker{d}" track, stamped at the COMMAND's cluster clock (the
        # worker has no clock of its own; per-track monotonicity follows
        # from command clocks being monotone per drive)
        self.tele = telemetry if telemetry is not None else _NULL
        self._track = f"worker{drive_id}"
        self.speed = float(speed)
        self.min_tick_s = float(min_tick_s)
        self.jitter_s = float(jitter_s)
        self.rng = random.Random(seed)
        self.hangs_served = 0           # debug/test visibility
        self._hung: set = set()         # hang event indices already served

    def run(self) -> None:
        while not self.stop_event.is_set():
            try:
                cmd = self.commands.get(timeout=0.05)
            except queue.Empty:
                continue
            if cmd.kind == "stop":
                break
            t0 = time.perf_counter()
            if self.faults is not None:
                if self.faults.crash_active(self.drive_id, cmd.tick, cmd.clock):
                    if self.tele.enabled:
                        # a trace annotation only — the watchdog never
                        # reads the hub, so ground truth stays hidden
                        # from detection
                        self.tele.point(self._track, "worker_exit",
                                        cmd.clock, tick=cmd.tick,
                                        reason="crash")
                    return              # a crashed worker dies: pure silence
                hung = False
                for idx, dur in self.faults.hangs(self.drive_id, cmd.tick,
                                                  cmd.clock):
                    if idx in self._hung:
                        continue
                    self._hung.add(idx)
                    self.hangs_served += 1
                    # the thread REALLY blocks; only stop_event (shutdown)
                    # can interrupt it — the command it held is lost
                    self.stop_event.wait(dur)
                    hung = True
                if hung:
                    # woke up: announce liveness so the coordinator clears
                    # the outstanding command and dispatches again
                    self._beat("alive", cmd, reason="hang_wakeup")
                    continue
                if self.faults.stalled(self.drive_id, cmd.tick, cmd.clock):
                    self._beat("alive", cmd, reason="stalled")
                    continue
            if cmd.epoch != self.epoch_of():
                continue                # failed while the command flew
            payload = self.step_fn(cmd.tick, cmd.clock)
            if payload is None:
                self._beat("alive", cmd, reason="idle")
                continue
            raw = float(payload.get("raw_s", 0.0))
            compile_s = float(getattr(payload.get("obs"), "compile_s", 0.0))
            base = max(raw - compile_s, 0.0)
            slow = 1.0
            if self.faults is not None:
                slow = self.faults.slowdown(self.drive_id, cmd.tick, cmd.clock)
            # emulated drive service time: floor to min_tick_s, stretch by
            # the injected slowdown and the modeled drive speed, add jitter
            target = max(base, self.min_tick_s) * slow / self.speed
            if self.jitter_s > 0.0:
                target += self.rng.uniform(0.0, self.jitter_s)
            pad = target - base
            if pad > 0.0:
                self.stop_event.wait(pad)   # GIL released: real overlap
            busy = time.perf_counter() - t0
            if self.tele.enabled:
                self.tele.point(self._track, "heartbeat", cmd.clock,
                                kind="tick_done", tick=cmd.tick,
                                epoch=cmd.epoch, busy_s=busy)
            self.monitor.put(Heartbeat(self.drive_id, "tick_done", cmd.tick,
                                       cmd.epoch, busy_s=busy,
                                       payload=payload))

    def _beat(self, kind: str, cmd: WorkerCommand, reason: str) -> None:
        """Liveness-only heartbeat + its telemetry point."""
        if self.tele.enabled:
            self.tele.point(self._track, "heartbeat", cmd.clock, kind=kind,
                            tick=cmd.tick, epoch=cmd.epoch, reason=reason)
        self.monitor.put(Heartbeat(self.drive_id, kind, cmd.tick, cmd.epoch))


class HeartbeatWatchdog:
    """HEALTHY/SUSPECT/DEAD from heartbeats and wall-clock silence.

    Deliberately NOT a wrapper over ``FailureDetector``: feeding wall
    ``time.monotonic()`` in as the detector's "leading clock" would
    instantly kill a drive that crashed before its first productive tick
    (the detector initializes its progress marks at 0.0).  The watchdog
    keeps the same API shape (``observe`` -> (old, new), ``mark_dead``,
    ``health``, ``suspects``, ``dead``) so the cluster engine treats
    either as its health authority.

    Per coordinator join, each drive with work is observed: ``replied``
    (any current-epoch heartbeat arrived) and ``progressed`` (a tick_done
    with a payload).  A productive beat — or an idle tick — resets both
    the miss counter and the silence timer; everything else counts a miss
    and lets silence accrue.  SUSPECT at ``suspect_misses`` consecutive
    misses or ``suspect_after_s`` of silence; DEAD at the ``dead_*``
    thresholds.  Silence is measured from the last productive beat, first
    observed lazily so a drive dead-on-arrival is judged by its own
    timeline, not the process start.
    """

    def __init__(self, n_drives: int, suspect_after_s: float = 0.25,
                 suspect_misses: int = 20,
                 dead_after_s: Optional[float] = None,
                 dead_misses: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic):
        if n_drives < 1:
            raise ValueError("need at least one drive")
        if suspect_after_s <= 0 or suspect_misses <= 0:
            raise ValueError("suspect thresholds must be positive")
        self.n_drives = n_drives
        self.suspect_after_s = float(suspect_after_s)
        self.suspect_misses = int(suspect_misses)
        self.dead_after_s = float(4.0 * suspect_after_s
                                  if dead_after_s is None else dead_after_s)
        self.dead_misses = int(4 * suspect_misses
                               if dead_misses is None else dead_misses)
        if self.dead_after_s < self.suspect_after_s or \
                self.dead_misses < self.suspect_misses:
            raise ValueError("dead thresholds must not be below suspect "
                             "thresholds")
        self._clock = clock
        self.health: List[str] = [HEALTHY] * n_drives
        self._missed = [0] * n_drives
        self._last_beat: List[Optional[float]] = [None] * n_drives

    def observe(self, drive_id: int, replied: bool, progressed: bool,
                has_work: bool) -> Tuple[str, str]:
        """One join's evidence for one drive; returns (old, new) health.
        DEAD is terminal — the engine fails the drive on that edge."""
        now = self._clock()
        old = self.health[drive_id]
        if old == DEAD:
            return old, old
        if self._last_beat[drive_id] is None:
            self._last_beat[drive_id] = now
        if (replied and progressed) or not has_work:
            # idle drives are never suspected; a productive heartbeat
            # clears any suspicion and resets the silence timer
            self._missed[drive_id] = 0
            self._last_beat[drive_id] = now
            self.health[drive_id] = HEALTHY
            return old, HEALTHY
        self._missed[drive_id] += 1
        silent_s = now - self._last_beat[drive_id]
        new = old
        if self._missed[drive_id] >= self.dead_misses or \
                silent_s > self.dead_after_s:
            new = DEAD
        elif self._missed[drive_id] >= self.suspect_misses or \
                silent_s > self.suspect_after_s:
            new = SUSPECT
        self.health[drive_id] = new
        return old, new

    def mark_dead(self, drive_id: int) -> None:
        """Operator/engine-initiated death (explicit ``fail()``)."""
        self.health[drive_id] = DEAD

    @property
    def suspects(self) -> List[int]:
        return [d for d, h in enumerate(self.health) if h == SUSPECT]

    @property
    def dead(self) -> List[int]:
        return [d for d, h in enumerate(self.health) if h == DEAD]
