"""Multi-drive cluster serving (port of ``repro/train/cluster_loop.py``):
N replica ``ServeEngine``s — each modeling
one CSD drive with its own paged-KV pool, scheduler, and transfer ledger —
behind ONE shared request queue with locality-aware routing.

This is the paper's storage server (36 Solana drives in one box) applied to
LM serving: the host keeps a single queue, a router decides which drive
pulls each request (``core.cluster.Router``: round_robin / least_loaded /
data_local), and the cluster's stats merge every drive's ledger plus the
live energy integral (``core.energy.server_power`` over per-tick
active-drive counts — Table I's wall-power accounting, finally wired into
serving instead of only the offline benchmarks).

Mechanics:
  * one global FIFO queue; dispatch happens at tick start, at most one
    request per free slot per drive, never reordering around a blocked head
    (deterministic replay — a cluster serves exactly the tokens one engine
    would);
  * requests optionally carry a ``shard_id``.  ``data_local`` pins them to
    the drive holding the shard; serving a sharded request anywhere else
    (a data_local spill, or any placement by the locality-oblivious
    policies) charges ``shard_spill_bytes`` to the cluster's spill ledger —
    the bytes that had to cross the drive-to-drive link because compute did
    not come to the data;
  * every tick steps each drive that has work; each drive's measured step
    time advances its own *virtual clock* (drives are independent
    hardware; in-process they run serially), and the cluster tick costs
    the LEADING clock's advance — the async parallel-wall-clock model —
    plus the active-drive count for the energy integral;
  * ``drain(d)`` stops routing to a drive and re-queues its un-prefilled
    (still drive-queued) requests; ``fail(d)`` additionally restarts its
    in-flight requests from their prompts on the surviving drives (greedy
    decode is deterministic, so a restarted request still yields identical
    tokens) and keeps the dead drive's stats merged into the cluster view;
  * replicas serve the ONE model passed in (no copy of the weights per
    drive) and share their donor's built kernels and warm sites
    (``jit_donor``), so an N-drive cluster builds the kernels once;
  * a cluster-wide pull scheduler (``core.scheduler.ClusterAdmission``)
    learns every drive's service rate from per-tick observations
    (``ServeEngine.last_tick``); ``rate_aware`` routing consumes the live
    estimates and the scheduler's quotas cap each drive's in-flight share
    ∝ its rate — the paper's host-vs-CSD batch-ratio rule applied
    drive-vs-drive, so a ``speed_factor``-slowed drive pulls
    proportionally less instead of straggling the cluster;
  * per-drive measured tick times have the engine-reported first-use
    delta (kernel build and first launches, ``compile_s``) subtracted
    before they reach the wall-clock/energy accounting (a build happens
    once per process, not once per drive tick);
  * shards homed on a drained/failed drive are re-placed onto survivors,
    each migration charged ONCE to the spill ledger (``shard_bytes``),
    instead of every future request re-fetching the shard over the link;
  * ``concurrent=True`` replaces the serial drive loop with the real
    thing: one ``core.runtime.DriveWorker`` thread per drive, fed tick
    commands over per-drive queues by the coordinator (the ``step()``
    caller), replying with heartbeats on a shared monitor queue.  Drive
    steps genuinely overlap (engine steps and service-time sleeps release
    the GIL), the cluster wall clock is MEASURED join time instead of the
    virtual-clock model (the virtual clocks are kept as the model's
    prediction, to hold the measured wall against), and failure
    detection runs on the real channel: a ``HeartbeatWatchdog`` drives
    the same HEALTHY→SUSPECT→DEAD machine from missed heartbeats and
    wall-clock silence, so a crashed or hung worker is discovered from
    its silence, never from ground truth.  ``drain``/``fail``/``close``
    are race-safe and idempotent: ``fail()`` bumps the drive's epoch
    under its lock, stale commands/heartbeats are discarded on both
    sides, and workers join cleanly even when killed mid-tick.

On the card every drive's engine runs on the same device and the default
stream, so in concurrent mode one drive's measured step includes the
kernels the other drives queued meanwhile (the engine synchronizes the
device to time a call).
"""
from __future__ import annotations

import math
import queue as queue_mod
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Sequence

from repro_torch.config import ModelConfig
from repro_torch.core.cluster import (ClusterExhaustedError, ClusterStats,
                                DriveLoad, Placement, Router,
                                shard_spill_bytes)
from repro_torch.core.faults import (DEAD, HEALTHY, SUSPECT, FailureDetector,
                               FaultSchedule)
from repro_torch.core.latency import LatencyRecord
from repro_torch.core.runtime import (DriveWorker, Heartbeat, HeartbeatWatchdog,
                                WorkerCommand)
from repro_torch.core.scheduler import ClusterAdmission
from repro_torch.core.telemetry import NULL_HUB
from repro_torch.models.model import torch_dtype
from repro_torch.train.serve_loop import GenResult, ServeEngine, collect_results


@dataclass
class ClusterRequest:
    rid: int                      # cluster-global request id
    prompt: List[int]
    max_new: int
    shard_id: Optional[int] = None
    spilled_bytes: float = 0.0    # spill charge of the current dispatch
    priority: int = 0
    deadline_s: Optional[float] = None  # absolute TTFT deadline (cluster clock)
    # retry budget: fail()-restarts granted so far, and the earliest
    # cluster-clock time the next dispatch may happen (exponential backoff
    # — a request bouncing between sick drives must not hammer the queue)
    retries: int = 0
    not_before_s: float = 0.0


@dataclass
class _Drive:
    drive_id: int
    engine: ServeEngine
    speed: float = 1.0            # modeled hardware speed (0.5 = half rate)
    draining: bool = False
    failed: bool = False
    # hidden ground truth of an injected crash: the drive stops responding
    # (never steps again) but the CLUSTER is not told — only the
    # FailureDetector can notice the silence and trigger fail()
    crashed: bool = False
    # engine-local rid -> cluster-global rid (a request re-queued by
    # drain/fail gets a fresh local rid on whichever drive takes it next)
    rid_map: Dict[int, int] = field(default_factory=dict)
    # concurrent runtime: the drive lock serializes this drive's engine
    # between its worker thread and the coordinator (dispatch submits,
    # hedge cancels, fail's slot release); epoch is bumped by fail()
    # under the lock so in-flight commands/heartbeats from before the
    # failure are recognizably stale and discarded on both sides
    lock: threading.RLock = field(default_factory=threading.RLock,
                                  repr=False, compare=False)
    epoch: int = 0

    @property
    def accepting(self) -> bool:
        return not (self.draining or self.failed)

    @property
    def has_work(self) -> bool:
        return not self.failed and \
            (self.engine.pending > 0 or self.engine.num_active > 0)

    def load(self, clock: float = 0.0, service_s: float = math.nan,
             quota: Optional[int] = None,
             accepting: Optional[bool] = None) -> DriveLoad:
        """``accepting`` overrides the drain/fail view — the engine passes
        False for SUSPECT drives so the router quarantines them from new
        dispatch without the drive being administratively down."""
        eng = self.engine
        fill = 0.0
        if eng.pager is not None and eng.pager.num_pages > 0:
            fill = eng.pager.num_in_use / eng.pager.num_pages
        return DriveLoad(drive_id=self.drive_id, num_slots=eng.num_slots,
                         active=eng.num_active, pending=eng.pending,
                         page_fill=fill,
                         accepting=self.accepting if accepting is None
                         else accepting,
                         clock=clock, service_s=service_s, quota=quota)


class ClusterEngine:
    """N replica serve engines behind one queue with pluggable routing."""

    def __init__(self, cfg: ModelConfig, params, n_drives: int = 2,
                 routing: str = "least_loaded", placement: Placement = None,
                 spill: bool = True, jit_donor: Optional[ServeEngine] = None,
                 admission_factory=None,
                 speed_factor: Optional[Sequence[float]] = None,
                 rate_alpha: float = 0.15,
                 quota_gate: bool = False,
                 shard_replacement: bool = True,
                 shard_bytes: Optional[float] = None,
                 admission_order: str = "fifo",
                 shed_expired: bool = True,
                 faults: Optional[FaultSchedule] = None,
                 detector: Optional[FailureDetector] = None,
                 max_retries: int = 3,
                 retry_backoff_s: float = 0.05,
                 hedge: bool = False,
                 concurrent: bool = False,
                 dispatch_timeout_s: float = 0.25,
                 min_tick_s: float = 0.0,
                 tick_jitter_s: float = 0.0,
                 jitter_seed: int = 0,
                 watchdog: Optional[HeartbeatWatchdog] = None,
                 telemetry=None,
                 **engine_kw):
        if n_drives < 1:
            raise ValueError("need at least one drive")
        self.cfg = cfg
        self.router = Router(routing, n_drives, placement=placement,
                             spill=spill)
        # speed_factor models heterogeneous hardware in one process: a
        # drive's measured tick time is divided by its factor (0.5 = an
        # ARM-class drive twice as slow as its peers), which flows into the
        # wall-clock model, the energy integral, and the learned rates
        if speed_factor is None:
            speed_factor = [1.0] * n_drives
        speed_factor = [float(s) for s in speed_factor]
        if len(speed_factor) != n_drives:
            raise ValueError(f"speed_factor needs {n_drives} entries, "
                             f"got {len(speed_factor)}")
        if any(not (s > 0.0) or not math.isfinite(s) for s in speed_factor):
            raise ValueError(f"speed_factor entries must be finite and "
                             f"positive, got {speed_factor}")
        # telemetry: the coordinator owns request spans and the
        # "coordinator" track (cluster wall clock); each drive engine gets
        # the same hub pointed at its own f"drive{d}" track (per-drive
        # virtual clock) with request spans OFF — drive-local rids are not
        # cluster-global rids, and mixing clock domains inside one span
        # would make durations meaningless
        self.tele = telemetry if telemetry is not None else NULL_HUB
        self.drives: List[_Drive] = []
        # an AdmissionController is mutable pull state — replicas must not
        # share one; pass admission_factory to configure per-drive admission
        if "admission" in engine_kw:
            raise ValueError("pass admission_factory (one controller per "
                             "drive), not a shared admission instance")
        if concurrent and not engine_kw.get("prewarm"):
            # a cold drive's first tick builds the kernels and pays the
            # first launches — real wall-clock silence the heartbeat
            # watchdog cannot tell from death (and would punish with
            # SUSPECT/DEAD).  The worker runtime therefore never starts
            # cold: warm here, before any worker thread exists (drive 0
            # builds once; the rest share it via the donor chain below)
            engine_kw["prewarm"] = True
        for d in range(n_drives):
            donor = jit_donor if jit_donor is not None else \
                (self.drives[0].engine if self.drives else None)
            kw = dict(engine_kw)
            if admission_factory is not None:
                kw["admission"] = admission_factory()
            eng = ServeEngine(cfg, params, jit_donor=donor, **kw)
            eng.tele = self.tele
            eng.tele_track = f"drive{d}"
            eng.tele_requests = False
            self.drives.append(_Drive(drive_id=d, engine=eng,
                                      speed=speed_factor[d]))
        # the cluster-wide pull scheduler: one controller learns every
        # drive's service rate from tick observations (the paper's
        # batch-ratio rule lifted from host-vs-CSD to drive-vs-drive).
        # rate_aware routing consumes the live estimates via expected-
        # completion deferral (the quota in continuous form);
        # quota_gate=True additionally applies the discrete quotas as hard
        # in-flight caps — off by default because one engine tick costs the
        # same at any slot occupancy, so a sub-slot cap wastes whole ticks
        # on partial batches (measured in the reference's heterogeneous
        # cluster benchmark)
        self.pull = ClusterAdmission(n_drives, alpha=rate_alpha)
        self.quota_gate = bool(quota_gate)
        # shard re-placement: on drain/fail, move the dead drive's shards
        # to survivors ONCE (charged below) instead of paying a per-request
        # spill forever; shard_bytes models one shard's resident footprint
        # (default: one full max_len context of d_model rows)
        self.shard_replacement = bool(shard_replacement)
        if shard_bytes is None:
            shard_bytes = float(self.drives[0].engine.max_len * cfg.d_model
                                * torch_dtype(cfg).itemsize)
        self.shard_bytes = float(shard_bytes)
        self._seen_shards: set = set()
        self.queue: Deque[ClusterRequest] = deque()
        self.stats = ClusterStats(
            drives=[d.engine.stats for d in self.drives])
        self._inflight: Dict[int, ClusterRequest] = {}
        self._next_rid = 0
        self._finished: List[GenResult] = []
        self._spill_bytes_per_el = torch_dtype(cfg).itemsize
        # per-drive virtual clocks for the async parallel-drives model:
        # drives are independent hardware with no tick barrier (the paper's
        # pull protocol), so the cluster wall clock is the LEADING drive's
        # cumulative busy time, and work done in the leader's shadow is
        # free — which is exactly why sizing each drive's share to its
        # rate (instead of a straggler-bound per-tick max) pays off
        self._clocks = [0.0] * n_drives
        self._lead = 0.0              # leading clock at the last tick
        # SLO layer: the cluster wall clock (tick advances + idle
        # fast-forwards via advance_clock) is the ONE clock all per-request
        # timestamps live on — per-drive virtual clocks never leak into
        # LatencyRecords, so TTFT/e2e cannot go negative across drives.
        # "edf" sorts the SHARED queue by deadline before routing (drives
        # themselves stay FIFO: a deadline on the cluster clock means
        # nothing on a drive's busy-time clock, so deadlines are not
        # propagated down); shed_expired drops queued requests whose
        # deadline already passed instead of dispatching hopeless work.
        if admission_order not in ("fifo", "edf"):
            raise ValueError(f"admission_order must be 'fifo' or 'edf', "
                             f"got {admission_order!r}")
        self.admission_order = admission_order
        self.shed_expired = bool(shed_expired)
        self.clock = 0.0
        self.records: Dict[int, LatencyRecord] = {}
        # fault tolerance: an optional seeded FaultSchedule injects
        # stalls/slowdowns/crashes/pool clamps per tick (hidden ground
        # truth); the FailureDetector watches the cluster-VISIBLE signals
        # (virtual clocks + per-tick progress) and auto-fail()s drives it
        # declares DEAD.  Requests restarted by fail() carry a retry
        # budget with exponential backoff; past max_retries they finish
        # status="failed" instead of requeueing forever.  hedge=True
        # additionally duplicates the oldest SUSPECT-stranded request onto
        # a healthy drive — first finisher wins, the loser is canceled and
        # its serving time booked as hedge_wasted_s.
        if max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {max_retries}")
        if retry_backoff_s < 0 or not math.isfinite(retry_backoff_s):
            raise ValueError(f"retry_backoff_s must be finite and >= 0, "
                             f"got {retry_backoff_s}")
        self.faults = faults
        self.detector = detector if detector is not None \
            else FailureDetector(n_drives)
        if self.detector.n_drives != n_drives:
            raise ValueError(f"detector tracks {self.detector.n_drives} "
                             f"drives, cluster has {n_drives}")
        self.max_retries = int(max_retries)
        self.retry_backoff_s = float(retry_backoff_s)
        self.hedge = bool(hedge)
        self._tick = 0                 # fault-schedule tick index
        # grid -> (primary_drive_id, hedge_drive_id) for in-flight hedges
        self._hedges: Dict[int, tuple] = {}
        # status="failed" results produced outside a step (operator fail())
        # wait here until the next step()/run_until_complete() delivers them
        self._failout: List[GenResult] = []
        self._stuck = False
        self._idle_grace = 0           # consecutive idle ticks granted to
        # dispatch after a same-tick fail() requeue (see _idle_advance)
        # hedge copies whose cancel() found the copy already finished
        # (both copies completed in one joined tick): the duplicate
        # result is still pending absorption — drop it AND book its burn
        self._hedge_drops: Dict[tuple, bool] = {}
        # -- concurrent worker runtime (core.runtime) ------------------------
        self.concurrent = bool(concurrent)
        if not (dispatch_timeout_s > 0.0 and math.isfinite(dispatch_timeout_s)):
            raise ValueError(f"dispatch_timeout_s must be finite and > 0, "
                             f"got {dispatch_timeout_s}")
        if min_tick_s < 0 or not math.isfinite(min_tick_s):
            raise ValueError(f"min_tick_s must be finite and >= 0, "
                             f"got {min_tick_s}")
        if tick_jitter_s < 0 or not math.isfinite(tick_jitter_s):
            raise ValueError(f"tick_jitter_s must be finite and >= 0, "
                             f"got {tick_jitter_s}")
        self.dispatch_timeout_s = float(dispatch_timeout_s)
        self.min_tick_s = float(min_tick_s)
        self.tick_jitter_s = float(tick_jitter_s)
        self.jitter_seed = int(jitter_seed)
        if watchdog is not None and watchdog.n_drives != n_drives:
            raise ValueError(f"watchdog tracks {watchdog.n_drives} drives, "
                             f"cluster has {n_drives}")
        if self.concurrent and watchdog is None:
            # default watchdog mirrors the detector's thresholds: ticks
            # become missed heartbeats, clock lag becomes wall silence
            watchdog = HeartbeatWatchdog(
                n_drives,
                suspect_after_s=self.detector.suspect_after_s,
                suspect_misses=self.detector.suspect_ticks,
                dead_after_s=self.detector.dead_after_s,
                dead_misses=self.detector.dead_ticks)
        self.watchdog = watchdog
        # cluster lock: every mutation of shared state (queue, admission,
        # router, ledgers, stats, rid maps, hedges) happens under it —
        # workers never take it (they only hold their drive lock), so
        # coordinator->drive lock acquisition cannot deadlock
        self._lock = threading.RLock()
        self._close_lock = threading.Lock()
        self._closed = False
        self._stop = threading.Event()
        self._monitor: "queue_mod.Queue[Heartbeat]" = queue_mod.Queue()
        self._commands: List["queue_mod.Queue[WorkerCommand]"] = []
        self._workers: Optional[List[DriveWorker]] = None
        self._outstanding = [0] * n_drives   # unanswered commands per drive
        self.stats.health = list(self._health)

    # -- intake --------------------------------------------------------------

    def submit(self, prompt: Sequence[int], max_new: int = 32,
               shard_id: Optional[int] = None, priority: int = 0,
               deadline_s: Optional[float] = None) -> int:
        """Enqueue a request; ``deadline_s`` is an ABSOLUTE first-token
        deadline on the CLUSTER wall clock (None = best-effort)."""
        prompt = list(prompt)
        # reject at enqueue time what no drive can ever serve — a deferred
        # ValueError inside _dispatch would tear down the whole run
        self.drives[0].engine.validate_request(prompt, max_new)
        with self._lock:
            rid = self._next_rid
            self._next_rid += 1
            req = ClusterRequest(rid, prompt, max_new, shard_id,
                                 priority=priority, deadline_s=deadline_s)
            if shard_id is not None:
                self._seen_shards.add(shard_id)
            self._inflight[rid] = req
            self.queue.append(req)
            self.records[rid] = LatencyRecord(rid=rid, priority=priority,
                                              deadline_s=deadline_s,
                                              submit_t=self.clock)
            if self.tele.enabled:
                self.tele.open_request(rid, self.clock, priority=priority,
                                       prompt_len=len(prompt),
                                       max_new=max_new, shard=shard_id)
            return rid

    def advance_clock(self, to_t: float) -> None:
        """Fast-forward the cluster wall clock across an idle gap (open-loop
        replay).  Only the wall clock moves — the per-drive virtual clocks
        track busy time and idle is not busy."""
        with self._lock:
            self.clock = max(self.clock, to_t)

    @property
    def pending(self) -> int:
        return len(self.queue)

    @property
    def num_active(self) -> int:
        """Slots mid-flight across live drives (same semantics as
        ``ServeEngine.num_active``; drive-queued requests count under
        ``in_flight``, not here)."""
        return sum(d.engine.num_active for d in self.drives if not d.failed)

    @property
    def in_flight(self) -> int:
        """Everything dispatched but unfinished: active slots plus requests
        waiting in per-drive queues."""
        return sum(d.engine.num_active + d.engine.pending
                   for d in self.drives if not d.failed)

    # -- drive lifecycle -----------------------------------------------------

    def drain(self, drive_id: int) -> int:
        """Stop routing to a drive and pull its un-prefilled requests back
        into the shared queue (front, original order — they were dispatched
        earliest).  In-flight slots finish normally.  Shards homed on the
        drive are re-placed onto survivors (one migration charge each).
        Idempotent and race-safe: a second drain finds an empty drive
        queue and re-queues nothing.  Returns the number re-queued."""
        with self._lock:
            d = self.drives[drive_id]
            with d.lock:
                d.draining = True
                n = self._requeue_unprefilled(d)
            self._replace_shards_of(drive_id)
            return n

    def fail(self, drive_id: int) -> int:
        """Hard drive failure: re-queue its un-prefilled requests AND
        restart its in-flight ones from their prompts (partial output is
        lost; greedy decode is deterministic so the retry reproduces the
        same tokens).  The dead drive's stats stay merged in the cluster
        view — the work it did (and the energy it burned) happened.

        Recovery semantics: each restart consumes one unit of the
        request's retry budget and arms an exponential backoff; a request
        already at ``max_retries`` finishes ``status="failed"`` instead of
        requeueing.  A hedged request whose primary died is NOT restarted
        — its hedge copy on the healthy drive simply becomes the primary.
        The dead engine's slots and pages are released (a failed drive
        mid-chunked-prefill would otherwise leak its partially spliced KV
        pages forever), and if this was the LAST healthy drive every
        queued request finishes ``status="failed"`` — conservation
        (``submitted == ok + shed + failed``) holds even at total loss.

        Race-safe under the concurrent runtime: the whole teardown runs
        under the cluster lock AND the drive lock — a worker mid-step
        holds the drive lock, so fail() waits for the step to finish
        before touching slots, then bumps the drive's epoch so the step's
        late heartbeat (and any command still in the worker's queue) is
        recognizably stale and discarded.  Idempotent: a second fail()
        (operator + watchdog racing) returns 0.
        Returns the number of requests re-queued."""
        with self._lock:
            d = self.drives[drive_id]
            if d.failed:
                return 0
            retry: List[ClusterRequest] = []
            failed_out: List[ClusterRequest] = []
            with d.lock:
                d.epoch += 1
                if self.tele.enabled:
                    self.tele.point("coordinator", "drive_failed",
                                    self.clock, drive=drive_id,
                                    epoch=d.epoch)
                    self.tele.counter("cluster.drive_failures")
                n = self._requeue_unprefilled(d)
                self.detector.mark_dead(drive_id)
                if self.watchdog is not None:
                    self.watchdog.mark_dead(drive_id)
                self.pull.unquarantine(drive_id)  # dead ≠ suspect: refit
                # everything still mapped after _requeue_unprefilled is
                # in-flight in a slot OR finished-but-unabsorbed (its
                # result rode a heartbeat the epoch bump just made stale
                # — from the coordinator's view that output never
                # existed).  Both are lost with the drive: scanning only
                # active slots would orphan the unabsorbed ones, silently
                # breaking submitted == ok + shed + failed
                for local in sorted(d.rid_map,
                                    key=lambda l: d.rid_map[l]):
                    grid = d.rid_map.pop(local)
                    req = self._inflight.get(grid)
                    if req is None:
                        continue
                    pair = self._hedges.get(grid)
                    if pair is not None and pair[0] == drive_id:
                        # the hedge copy outlived the primary: promote
                        # it (it keeps running; no restart, no retry)
                        self._hedges.pop(grid)
                        self.stats.hedges_won += 1
                        if self.tele.enabled:
                            self.tele.close_span(("hedge", grid),
                                                 self.clock, "promoted")
                        continue
                    if pair is not None and pair[1] == drive_id:
                        # the hedge copy died with this drive; the
                        # primary is still serving — abandon the hedge
                        self._hedges.pop(grid)
                        self.stats.hedges_lost += 1
                        if self.tele.enabled:
                            self.tele.close_span(("hedge", grid),
                                                 self.clock, "canceled",
                                                 reason="hedge drive died")
                        continue
                    if req.retries >= self.max_retries:
                        failed_out.append(req)
                        continue
                    req.retries += 1
                    self.stats.retries += 1
                    if self.tele.enabled:
                        self.tele.request_point(grid, "retry", self.clock,
                                                attempt=req.retries,
                                                from_drive=drive_id)
                        self.tele.counter("cluster.retries")
                    if self.retry_backoff_s > 0.0:
                        req.not_before_s = self.clock + \
                            self.retry_backoff_s * \
                            (2.0 ** (req.retries - 1))
                    retry.append(req)
                    rec = self.records.get(grid)
                    if rec is not None:
                        # the retry replays from the prompt:
                        # admit/first-token re-stamp on the surviving
                        # drive, but queue wait keeps the ORIGINAL
                        # submit — the user has been waiting since
                        # then, whatever the cluster did in between
                        rec.restart()
                # slots are scanned in pool order, which is refill order,
                # not submission order — restore FIFO by global rid before
                # requeueing (in-flight requests go ahead of the
                # drive-queued ones _requeue_unprefilled just put back:
                # they were dispatched earlier)
                for req in sorted(retry, key=lambda r: r.rid, reverse=True):
                    self.queue.appendleft(req)
                # free the dead engine's slots and their KV pages:
                # in-flight requests (including mid-chunked-prefill ones
                # with partially spliced pages) were restarted or failed
                # out above — without this release the dead drive's page
                # pool leaks its live pages forever (pager.check_balanced()
                # is the regression gate)
                for slot in d.engine.slots:
                    if slot.active:
                        d.engine._release_slot(slot)
                d.engine.records.clear()
                # drop finished-but-undelivered results too: their
                # requests were just restarted (or failed out) above, so
                # absorbing a stale copy later would deliver twice
                d.engine._finished.clear()
                d.failed = True
                d.draining = True
            self._outstanding[drive_id] = 0   # silent commands died with it
            self._replace_shards_of(drive_id)
            for req in failed_out:
                self._fail_request(req)
            if not any(x.accepting for x in self.drives):
                # the LAST drive died with requests still queued: nothing
                # can ever serve them — fail them out now, not deadlock
                while self.queue:
                    self._fail_request(self.queue.popleft())
            return n + len(retry)

    def _fail_request(self, req: ClusterRequest) -> None:
        """Terminal failure: the request is out of retries (or out of
        drives).  Emits a ``status="failed"`` GenResult and closes the
        latency record — the original submit timestamp is kept, so the
        record's e2e covers every retry the budget paid for."""
        self._inflight.pop(req.rid, None)
        self.stats.failed_requests += 1
        res = GenResult(tokens=[], prefill_s=0.0, decode_s=0.0, rid=req.rid,
                        status="failed", priority=req.priority)
        rec = self.records.pop(req.rid, None)
        if rec is not None:
            rec.finish_t = self.clock
            rec.status = "failed"
            self.stats.latency.add(rec)
            res.e2e_s = rec.e2e_s
        if self.tele.enabled:
            self.tele.close_request(req.rid, self.clock, "failed",
                                    retries=req.retries)
        self._failout.append(res)

    def _requeue_unprefilled(self, d: _Drive) -> int:
        """Pull everything still sitting in the drive's own queue back into
        the shared queue's head.  These requests never touched the drive, so
        a spill charged at their dispatch never actually crossed the link —
        refund it (in-flight requests keep their charge: their shard bytes
        did move)."""
        backed: List[ClusterRequest] = []
        while d.engine.queue:
            local = d.engine.queue.popleft()
            grid = d.rid_map.pop(local.rid)
            pair = self._hedges.get(grid)
            if pair is not None and pair[1] == d.drive_id:
                # a still-queued hedge copy on a draining/failing drive:
                # drop it (the primary is serving) instead of re-queueing
                # a duplicate into the shared queue
                self._hedges.pop(grid)
                self.stats.hedges_lost += 1
                d.engine.records.pop(local.rid, None)
                if self.tele.enabled:
                    self.tele.close_span(("hedge", grid), self.clock,
                                         "canceled",
                                         reason="hedge still queued on "
                                                "draining drive")
                continue
            backed.append(self._inflight[grid])
        for req in reversed(backed):
            if req.spilled_bytes:
                self.stats.spill_ledger.add("link", -req.spilled_bytes,
                                            "remote shard spill")
                self.stats.remote_requests -= 1
                req.spilled_bytes = 0.0
            self.queue.appendleft(req)
        return len(backed)

    # -- shard re-placement ----------------------------------------------------

    def _replace_shards_of(self, drive_id: int) -> int:
        """Re-home every seen shard living on ``drive_id`` onto a surviving
        drive, paying each shard's bytes over the link exactly once —
        instead of re-fetching them on every future request (the
        no-replacement behavior, which charges a spill per request
        forever).  Returns the number of shards migrated."""
        if not self.shard_replacement:
            return 0
        moved = 0
        for shard in sorted(self._seen_shards):
            if self.router.home(shard) == drive_id:
                moved += int(self._migrate_shard(shard))
        return moved

    def _migrate_shard(self, shard_id: int) -> bool:
        """Move one shard to the least-loaded accepting drive and charge
        the migration to the spill ledger."""
        survivors = [d for d in self.drives if d.accepting]
        if not survivors:
            return False
        target = min(survivors, key=lambda d: (d.load().load, d.drive_id))
        self.router.replace_shard(shard_id, target.drive_id)
        self.stats.spill_ledger.add("link", self.shard_bytes,
                                    "shard migration")
        self.stats.migrated_shards += 1
        return True

    # -- dispatch + tick -----------------------------------------------------

    def _pull_quotas(self) -> Dict[int, int]:
        """Per-drive in-flight quotas from the cluster pull scheduler,
        refit over the accepting drives (share ∝ learned rate).  SUSPECT
        drives are quarantined out — a stalled drive must not keep a
        share it cannot serve (the scheduler also drops their ticks)."""
        live = [d.drive_id for d in self.drives if d.accepting
                and self._health[d.drive_id] != SUSPECT]
        if not live:
            live = [d.drive_id for d in self.drives if d.accepting]
        if not live:
            return {}
        total = sum(self.drives[i].engine.num_slots for i in live)
        return self.pull.quotas(total, live)

    def _shed_queue(self) -> List[GenResult]:
        """Drop shared-queue requests whose deadline already passed — even
        an instant dispatch could not produce their first token in time, so
        routing them only steals capacity from requests that can still make
        their SLO.  Queued sheds cost nothing beyond their queue wait (no
        serving time was spent); each produces a ``status='shed'``
        GenResult so the submitter hears back."""
        if not self.shed_expired or not any(
                r.deadline_s is not None and r.deadline_s < self.clock
                for r in self.queue):
            return []
        out: List[GenResult] = []
        keep: Deque[ClusterRequest] = deque()
        for req in self.queue:
            if req.deadline_s is None or req.deadline_s >= self.clock:
                keep.append(req)
                continue
            self._inflight.pop(req.rid, None)
            self.stats.shed_requests += 1
            res = GenResult(tokens=[], prefill_s=0.0, decode_s=0.0,
                            rid=req.rid, status="shed",
                            priority=req.priority)
            rec = self.records.pop(req.rid, None)
            if rec is not None:
                rec.finish_t = self.clock
                rec.status = "shed"
                self.stats.latency.add(rec)
                res.e2e_s = rec.e2e_s
            if self.tele.enabled:
                self.tele.close_request(req.rid, self.clock, "shed")
                self.tele.counter("cluster.shed")
            out.append(res)
        self.queue = keep
        return out

    def _dispatch(self) -> None:
        """Route queued requests to drives, at most one per free slot, FIFO
        (a blocked head waits; nothing is reordered around it).  Under EDF
        the shared queue is deadline-sorted FIRST (stable: FIFO preserved
        within a class), then the same no-reorder dispatch runs.  Under
        quota gating each drive's in-flight share is additionally capped by
        the pull scheduler's rate-proportional quota."""
        if self.admission_order == "edf" and len(self.queue) > 1:
            self.queue = deque(sorted(
                self.queue,
                key=lambda r: (r.deadline_s if r.deadline_s is not None
                               else math.inf, r.priority, r.rid)))
        quotas = self._pull_quotas() if self.quota_gate else {}
        # expected seconds to serve one request on drive d: mean observed
        # tokens per completed request / the drive's learned token rate
        mean_items = (self.stats.tokens / self.stats.completed) \
            if self.stats.completed > 0 else math.nan
        # retry backoff: a request whose not_before hasn't arrived is
        # INELIGIBLE (not blocked) — dispatch steps around it, which is
        # the one sanctioned reorder: token identity is per-request under
        # greedy decode, so skipping a cooling-down retry cannot change
        # anyone's output, only who waits
        deferred: List[ClusterRequest] = []
        while self.queue:
            head = self.queue[0]
            if head.not_before_s > self.clock:
                deferred.append(self.queue.popleft())
                continue
            if self.shard_replacement and head.shard_id is not None and \
                    not self.drives[self.router.home(head.shard_id)].accepting:
                # lazy re-placement: the head's shard still points at a
                # drained/failed drive (a shard first seen after the drain)
                self._migrate_shard(head.shard_id)
            loads = [d.load(clock=self._clocks[d.drive_id],
                            service_s=mean_items / self.pull.rate(d.drive_id),
                            quota=quotas.get(d.drive_id),
                            accepting=d.accepting and
                            self._health[d.drive_id] != SUSPECT)
                     for d in self.drives]
            route = self.router.pick(head.shard_id, loads)
            if route is None:
                break
            req = self.queue.popleft()
            drive = self.drives[route.drive_id]
            # under the drive lock: a late worker may still be stepping
            # this engine (previous tick overran the dispatch timeout)
            with drive.lock:
                local = drive.engine.submit(req.prompt, max_new=req.max_new)
                drive.rid_map[local] = req.rid
            req.spilled_bytes = 0.0
            if route.remote:
                self.stats.remote_requests += 1
                req.spilled_bytes = shard_spill_bytes(
                    len(req.prompt), req.max_new, self.cfg.d_model,
                    self._spill_bytes_per_el)
                self.stats.spill_ledger.add("link", req.spilled_bytes,
                                            "remote shard spill")
            if self.tele.enabled:
                self.tele.request_point(
                    req.rid, "route", self.clock, drive=route.drive_id,
                    policy=self.router.policy, remote=bool(route.remote),
                    spill_bytes=req.spilled_bytes)
        if deferred:
            # cooling-down retries go back to the FRONT in original order
            # (they are the oldest requests; their backoff, not their
            # place in line, is what delays them)
            self.queue.extendleft(reversed(deferred))

    def step(self) -> List[GenResult]:
        """One cluster tick.  Serial mode steps every drive in-process
        under the virtual-clock model; ``concurrent=True`` forks the tick
        to the per-drive worker threads and joins on their heartbeats —
        see ``_step_serial`` / ``_step_concurrent``."""
        if self.concurrent:
            return self._step_concurrent()
        return self._step_serial()

    @property
    def _health(self) -> List[str]:
        """The cluster's health authority: the heartbeat watchdog when the
        concurrent runtime is live, else the virtual-clock detector."""
        if self.concurrent and self.watchdog is not None:
            return self.watchdog.health
        return self.detector.health

    def _absorb_tick(self, d: _Drive, finished: List[GenResult], obs,
                     dt: float, out: List[GenResult],
                     admit_events: List[int],
                     first_tok_events: List[int]) -> None:
        """Fold one drive tick's observations into the shared cluster
        state: virtual clock, pull-scheduler rates, admit/first-token
        event mapping, finished results, and hedge settlement.  The
        winner-commit and loser-cancel of a hedge are decided HERE, under
        the one cluster lock in concurrent mode — the both-finish race
        resolves to exactly one delivered result with the loser's burn
        booked as hedge waste."""
        self._clocks[d.drive_id] += dt
        self.pull.observe(d.drive_id, dt, obs.per_step_items)
        # map engine-local events to global rids BEFORE the finished
        # loop pops rid_map (a request can admit, emit its first token
        # and finish in the same tick)
        for local in obs.admitted_rids:
            if local in d.rid_map:
                admit_events.append(d.rid_map[local])
        for local in obs.first_token_rids:
            if local in d.rid_map:
                first_tok_events.append(d.rid_map[local])
        for r in finished:
            if r.rid not in d.rid_map:
                # abandoned by an earlier fail(), or the losing copy of a
                # hedge whose winner was absorbed first — the loser's
                # serving time is the availability premium, book it
                if self._hedge_drops.pop((d.drive_id, r.rid), None):
                    self.stats.hedge_wasted_s += r.prefill_s + r.decode_s
                    self.stats.hedge_wasted_s = max(
                        self.stats.hedge_wasted_s, 0.0)
                continue
            grid = d.rid_map.pop(r.rid)
            pair = self._hedges.pop(grid, None)
            if pair is not None:
                self._settle_hedge(grid, winner=d.drive_id, pair=pair)
            self._inflight.pop(grid, None)
            r.rid = grid
            r.drive = d.drive_id
            out.append(r)
            self.stats.completed += 1

    def _deliver(self, shed: List[GenResult], out: List[GenResult],
                 admit_events: List[int],
                 first_tok_events: List[int]) -> List[GenResult]:
        """Stamp per-request latency at the post-tick cluster clock and
        hand back the tick's results (sheds + completions + failouts)."""
        for grid in admit_events:
            rec = self.records.get(grid)
            if rec is not None and not math.isfinite(rec.admit_t):
                rec.admit_t = self.clock
                if self.tele.enabled:
                    self.tele.request_point(grid, "admit", self.clock)
        for grid in first_tok_events:
            rec = self.records.get(grid)
            if rec is not None and not math.isfinite(rec.first_token_t):
                rec.first_token_t = self.clock
                if self.tele.enabled:
                    self.tele.request_point(grid, "first_token", self.clock)
        for r in out:
            rec = self.records.pop(r.rid, None)
            if rec is None:
                continue
            rec.finish_t = self.clock
            rec.n_tokens = len(r.tokens)
            rec.status = "ok"
            self.stats.latency.add(rec)
            if self.tele.enabled:
                self.tele.close_request(r.rid, self.clock, "ok",
                                        drive=r.drive,
                                        tokens=len(r.tokens))
            r.priority = rec.priority
            r.queue_wait_s = rec.queue_wait_s
            r.ttft_s = rec.ttft_s
            r.tpot_s = rec.tpot_s
            r.e2e_s = rec.e2e_s
        if self._failout:
            # terminal failures produced this tick (retry budget / last
            # drive death) ride the tick's result list like sheds do
            out = out + self._failout
            self._failout = []
        out = shed + out
        self._finished.extend(out)
        return out

    def _step_serial(self) -> List[GenResult]:
        """One cluster tick: dispatch, then step every drive that has work.
        Each drive's step time advances its virtual clock; the tick costs
        the leading clock's advance (async parallel hardware), and the
        active-drive count feeds the live energy integral.

        Two corrections are applied to each drive's measured wall time:
        the engine-reported first-use delta is subtracted (a kernel build
        happens once per process, not once per replica tick —
        charging it would inflate ``cluster_s``/``serial_s`` and the
        ``server_power·dt`` energy integral on a cold cluster), and the
        remainder is divided by the drive's ``speed_factor`` (modeled
        heterogeneous hardware).  The corrected time also feeds the pull
        scheduler's per-drive rate estimate.

        Per-request latency is stamped at TICK granularity on the cluster
        wall clock: admissions and first tokens observed during the tick
        are stamped at the post-tick clock (the event completed somewhere
        inside the tick; the cluster cannot see sub-tick drive time
        without mixing clock domains, and a post-tick stamp is the
        conservative, monotone choice).

        Fault injection wraps the tick: the schedule's ground truth
        is applied FIRST (crashes silence drives, clamps shrink admissible
        pools, stalls skip a drive's step, slowdowns inflate its measured
        time), then the FailureDetector reads the tick's cluster-visible
        evidence and may auto-``fail()`` a DEAD drive; SUSPECT drives are
        quarantined from dispatch/quotas and optionally hedged around."""
        tick = self._tick
        self._tick += 1
        if self.faults is not None:
            begun = self.faults.begins(tick, self.clock)
            self.stats.faults_injected += len(begun)
            if self.tele.enabled:
                for ev in begun:
                    self.tele.fault_injected(ev.drive_id, ev.kind,
                                             self.clock, tick)
            for did in self.faults.crashes(tick, self.clock):
                if not self.drives[did].failed:
                    self.drives[did].crashed = True
            for d in self.drives:
                if not d.failed:
                    d.engine.pool_clamp_frac = \
                        self.faults.clamp(d.drive_id, tick, self.clock)
        shed = self._shed_queue()
        self._dispatch()
        out: List[GenResult] = []
        dts: List[float] = []
        admit_events: List[int] = []
        first_tok_events: List[int] = []
        n_active = 0
        progressed: set = set()
        for d in self.drives:
            if not d.has_work:
                continue
            if d.crashed or (self.faults is not None and self.faults.stalled(
                    d.drive_id, tick, self.clock)):
                # the drive does not respond this tick: its work sits, its
                # virtual clock stands still — exactly the silence the
                # detector is watching for
                continue
            t0 = time.perf_counter()
            finished = d.engine.step()
            raw = time.perf_counter() - t0
            if self.min_tick_s > 0.0:
                # emulated drive service-time floor (makes the
                # serial-vs-concurrent comparison hardware-independent);
                # really slept so measured wall time includes it
                pad = self.min_tick_s - raw
                if pad > 0.0:
                    time.sleep(pad)
                    raw += pad
            obs = d.engine.last_tick
            dt = max(raw - obs.compile_s, 0.0) / d.speed
            if self.faults is not None:
                dt *= self.faults.slowdown(d.drive_id, tick, self.clock)
            dts.append(dt)
            progressed.add(d.drive_id)
            n_active += 1
            self._absorb_tick(d, finished, obs, dt, out, admit_events,
                              first_tok_events)
            # the cluster owns result delivery: drop the engine's internal
            # copy so a long-running server doesn't accumulate one
            # GenResult per request per drive forever
            d.engine._finished.clear()
        if dts:
            # async parallel model: the cluster advances only when the
            # LEADING virtual clock advances; a slower/lagging drive's step
            # overlaps the leader and adds no wall time (no tick barrier)
            lead = max(self._clocks)
            tick_s = max(lead - self._lead, 0.0)
            self._lead = lead
            self.stats.record_tick(n_active, tick_s, sum(dts))
            self.clock += tick_s
            self._idle_grace = 0
            if self.tele.enabled and tick_s > 0.0:
                self.tele.phase("coordinator", "tick",
                                self.clock - tick_s, tick_s,
                                tick=tick, active=n_active)
        # failure detection on cluster-VISIBLE evidence only: which drives
        # progressed, and how far the leading clock ran since each drive's
        # last productive tick (ground-truth crash flags never leak here)
        lead_clock = max(self._clocks)
        dead_now: List[int] = []
        for d in self.drives:
            if d.failed:
                continue
            old, new = self.detector.observe(
                d.drive_id, lead_clock,
                progressed=d.drive_id in progressed,
                has_work=d.has_work)
            if old != new and self.tele.enabled:
                self.tele.health_transition("detector", d.drive_id,
                                            old, new, self.clock)
            if new == DEAD and old != DEAD:
                dead_now.append(d.drive_id)
            elif new == SUSPECT and old != SUSPECT:
                self.pull.quarantine(d.drive_id)
            elif new == HEALTHY and old == SUSPECT:
                self.pull.unquarantine(d.drive_id)
        for did in dead_now:
            self.stats.auto_failed_drives += 1
            self.fail(did)
        if self.hedge:
            self._launch_hedges()
        self.stats.health = list(self.detector.health)
        if self.tele.enabled:
            self._publish_tick_metrics(tick)
        if not dts:
            self._idle_advance(tick)
        return self._deliver(shed, out, admit_events, first_tok_events)

    # -- concurrent worker runtime -------------------------------------------

    def _make_step_fn(self, d: _Drive):
        """The engine-specific half of a worker's tick, run on the worker
        thread UNDER the drive lock (so fail() and hedge-cancel exclude a
        mid-step worker).  Shared cluster state is never touched here —
        the payload is absorbed by the coordinator under the cluster
        lock."""
        def run(tick: int, clock: float) -> Optional[dict]:
            with d.lock:
                if d.failed or self._stop.is_set() or not d.has_work:
                    return None
                if self.faults is not None:
                    d.engine.pool_clamp_frac = \
                        self.faults.clamp(d.drive_id, tick, clock)
                t0 = time.perf_counter()
                finished = list(d.engine.step())
                raw = time.perf_counter() - t0
                obs = d.engine.last_tick
                # the worker owns result hand-off: clear the engine's
                # internal copy (same contract as the serial loop)
                d.engine._finished.clear()
                return {"finished": finished, "obs": obs, "raw_s": raw}
        return run

    def _ensure_workers(self) -> None:
        if self._workers is not None:
            return
        if self._closed:
            raise RuntimeError("cluster engine is closed")
        self._commands = []
        self._workers = []
        for d in self.drives:
            cq: "queue_mod.Queue[WorkerCommand]" = queue_mod.Queue()
            w = DriveWorker(
                d.drive_id, self._make_step_fn(d), cq, self._monitor,
                self._stop, epoch_of=(lambda dd=d: dd.epoch),
                faults=self.faults, speed=d.speed,
                min_tick_s=self.min_tick_s, jitter_s=self.tick_jitter_s,
                seed=self.jitter_seed * 1009 + d.drive_id,
                telemetry=self.tele)
            self._commands.append(cq)
            self._workers.append(w)
            w.start()

    def close(self) -> None:
        """Stop and join every worker thread.  Idempotent and race-safe:
        concurrent close() calls join once; a worker blocked in an
        injected hang (or sleeping out its service-time pad) is woken by
        the stop event and joins cleanly mid-tick."""
        with self._close_lock:
            self._closed = True
            workers, self._workers = self._workers, None
        if not workers:
            return
        self._stop.set()
        for cq in self._commands:
            cq.put(WorkerCommand("stop"))
        for w in workers:
            w.join(timeout=10.0)
        alive = [w.name for w in workers if w.is_alive()]
        if alive:
            raise RuntimeError(f"worker threads failed to join: {alive}")

    # shutdown is close by its production name; the context-manager form
    # guarantees the join even when a test body raises
    shutdown = close

    def __enter__(self) -> "ClusterEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def predicted_parallel_s(self) -> float:
        """The virtual-clock model's prediction of the parallel makespan
        (leading per-drive clock).  In concurrent mode the clocks advance
        by each drive's measured busy time while ``stats.cluster_s``
        accrues MEASURED join wall time, to be held against this."""
        return max(self._clocks)

    def _step_concurrent(self) -> List[GenResult]:
        """One concurrent cluster tick (fork-join):

        1. under the cluster lock: deliver fault begins, shed, dispatch,
           then send one tick command to every non-failed drive with work
           and no unanswered command;
        2. join: drain the monitor queue until every outstanding command
           (including stragglers from earlier ticks) is answered or
           ``dispatch_timeout_s`` of real wall time elapses.  Payloads
           are absorbed under the cluster lock as they arrive;
        3. account the tick: the cluster wall clock advances by MEASURED
           join time (minus the largest reported lazy-compile delta) —
           overlap is real now, not modeled;
        4. the watchdog observes reply/progress per drive — silence from
           a crashed or hung worker accrues real wall time here, so
           wall-threshold detection converges even while the cluster
           clock stands still — and DEAD edges run the same fail() path
           as the serial detector.

        A drive whose command is unanswered is NOT re-dispatched (its
        ``_outstanding`` stays up), so a straggler can never be stepped
        twice concurrently; a late same-epoch reply is absorbed next
        tick and counts as progress."""
        self._ensure_workers()
        tick = self._tick
        self._tick += 1
        with self._lock:
            if self.faults is not None:
                begun = self.faults.begins(tick, self.clock)
                self.stats.faults_injected += len(begun)
                if self.tele.enabled:
                    for ev in begun:
                        self.tele.fault_injected(ev.drive_id, ev.kind,
                                                 self.clock, tick)
            shed = self._shed_queue()
            self._dispatch()
            sent = 0
            for d in self.drives:
                if d.failed or self._outstanding[d.drive_id] > 0 \
                        or not d.has_work:
                    continue
                self._commands[d.drive_id].put(
                    WorkerCommand("tick", tick, self.clock, d.epoch))
                self._outstanding[d.drive_id] += 1
                sent += 1
            waiting = sum(self._outstanding[d.drive_id]
                          for d in self.drives if not d.failed)
        out: List[GenResult] = []
        dts: List[float] = []
        admit_events: List[int] = []
        first_tok_events: List[int] = []
        n_active = 0
        progressed: set = set()
        replied: set = set()
        comp = 0.0
        t0 = time.perf_counter()
        deadline = t0 + self.dispatch_timeout_s
        while waiting > 0:
            remain = deadline - time.perf_counter()
            if remain <= 0.0:
                break
            try:
                hb = self._monitor.get(timeout=remain)
            except queue_mod.Empty:
                break
            with self._lock:
                d = self.drives[hb.drive_id]
                if d.failed or hb.epoch != d.epoch:
                    continue        # emitted before a fail(): stale
                if self._outstanding[hb.drive_id] > 0:
                    self._outstanding[hb.drive_id] -= 1
                    waiting -= 1
                replied.add(hb.drive_id)
                if hb.kind != "tick_done" or hb.payload is None:
                    continue        # liveness only (stall / hang wakeup)
                obs = hb.payload["obs"]
                dt = max(hb.busy_s - obs.compile_s, 0.0)
                comp = max(comp, obs.compile_s)
                self._absorb_tick(d, hb.payload["finished"], obs, dt, out,
                                  admit_events, first_tok_events)
                dts.append(dt)
                n_active += 1
                progressed.add(hb.drive_id)
        wall = time.perf_counter() - t0
        with self._lock:
            if progressed:
                # measured parallel wall clock: the join time IS the tick
                # cost (compiles happen once per process — subtract the
                # largest reported delta, mirroring the serial model)
                tick_s = max(wall - comp, 0.0)
                self._lead = max(self._clocks)
                self.stats.record_tick(n_active, tick_s, sum(dts))
                self.clock += tick_s
                self._idle_grace = 0
                if self.tele.enabled and tick_s > 0.0:
                    self.tele.phase("coordinator", "tick",
                                    self.clock - tick_s, tick_s,
                                    tick=tick, active=n_active)
            dead_now: List[int] = []
            for d in self.drives:
                if d.failed:
                    continue
                old, new = self.watchdog.observe(
                    d.drive_id, replied=d.drive_id in replied,
                    progressed=d.drive_id in progressed,
                    has_work=d.has_work)
                if old != new and self.tele.enabled:
                    self.tele.health_transition("watchdog", d.drive_id,
                                                old, new, self.clock)
                if new == DEAD and old != DEAD:
                    dead_now.append(d.drive_id)
                elif new == SUSPECT and old != SUSPECT:
                    self.pull.quarantine(d.drive_id)
                elif new == HEALTHY and old == SUSPECT:
                    self.pull.unquarantine(d.drive_id)
            for did in dead_now:
                self.stats.auto_failed_drives += 1
                self.fail(did)
            if self.hedge:
                self._launch_hedges()
            self.stats.health = list(self._health)
            if self.tele.enabled:
                self._publish_tick_metrics(tick)
            if not progressed and waiting == 0:
                # nothing stepped and nothing is pending on the channel:
                # fast-forward stall windows / backoffs / deadlines like
                # the serial loop (a silent drive keeps waiting > 0, so
                # real join timeouts — not this path — cover it)
                self._idle_advance(tick)
            return self._deliver(shed, out, admit_events, first_tok_events)

    def _publish_tick_metrics(self, tick: int) -> None:
        """End-of-tick snapshot into the telemetry registry: cluster wall
        clock, energy integral, queue depth, per-drive busy time and
        join-wall-vs-busy utilization.  Only finite values are published
        (NaN would poison the JSON export and the NaN bench gates)."""
        t = self.tele
        if not t.enabled:
            return
        t.counter("cluster.ticks")
        t.gauge("cluster.clock_s", self.clock)
        t.gauge("cluster.queue_depth", len(self.queue))
        t.gauge("cluster.in_flight", self.in_flight)
        if math.isfinite(self.stats.energy_j):
            t.gauge("cluster.energy_j", self.stats.energy_j)
        t.counter_sample("coordinator", "queue_depth", self.clock,
                         len(self.queue))
        wall = max(self.clock, 1e-9)
        for d in self.drives:
            busy = self._clocks[d.drive_id]
            t.gauge(f"drive.{d.drive_id}.busy_s", busy)
            # busy time on the drive's virtual clock over the cluster
            # join wall: >1 means the model claims more busy time than
            # wall passed (overlapped compile), <1 is idle/straggle
            t.gauge(f"drive.{d.drive_id}.utilization", busy / wall)

    def _settle_hedge(self, grid: int, winner: int, pair: tuple) -> None:
        """First finisher wins: cancel the losing copy, free its slot, and
        book the serving time it burned as hedge waste (the availability
        premium, priced like shed work).

        Called with the winner's rid_map entry already popped, under the
        cluster lock in concurrent mode — winner-commit and loser-cancel
        are one atomic decision.  The both-finish-same-instant race (both
        copies complete inside one joined tick) lands in ``cancel()``
        returning None because the loser's engine already finished the
        copy: the loser's rid_map entry is popped here, so when its
        result arrives it is dropped by ``_absorb_tick`` and its burn is
        booked via ``_hedge_drops``."""
        primary, hedger = pair
        loser = hedger if winner == primary else primary
        if winner == hedger:
            self.stats.hedges_won += 1
        else:
            self.stats.hedges_lost += 1
        ld = self.drives[loser]
        if ld.failed:
            if self.tele.enabled:
                self.tele.close_span(("hedge", grid), self.clock,
                                     "ok" if winner == hedger
                                     else "canceled", hedge_wasted_s=0.0)
            return                    # its copy died with the drive
        local = next((l for l, g in ld.rid_map.items() if g == grid), None)
        if local is None:
            if self.tele.enabled:
                self.tele.close_span(("hedge", grid), self.clock,
                                     "ok" if winner == hedger
                                     else "canceled", hedge_wasted_s=0.0)
            return
        ld.rid_map.pop(local)
        with ld.lock:                 # exclude the loser's mid-step worker
            wasted = ld.engine.cancel(local)
        if self.tele.enabled:
            # the hedge span closes at settlement: "ok" when the hedge
            # copy won the race, "canceled" when it lost — the loser's
            # burn is attributed on the span either way
            self.tele.close_span(("hedge", grid), self.clock,
                                 "ok" if winner == hedger else "canceled",
                                 hedge_wasted_s=float(wasted or 0.0))
        if wasted:
            self.stats.hedge_wasted_s += wasted
        elif wasted is None:
            # the copy had ALREADY finished on the loser's engine: its
            # duplicate result is pending absorption — mark it so the
            # drop books the loser's serving time as hedge waste
            self._hedge_drops[(loser, local)] = True

    def _launch_hedges(self) -> None:
        """Duplicate the oldest slot-stranded request of each SUSPECT
        drive onto the healthiest drive with capacity.  At most one hedge
        per stranded request; the copy pays no spill accounting (it is an
        availability bet, not a placement decision)."""
        for d in self.drives:
            if d.failed or self._health[d.drive_id] != SUSPECT:
                continue
            stranded = sorted(
                d.rid_map[s.rid] for s in d.engine.slots
                if s.active and s.rid in d.rid_map)
            stranded = [g for g in stranded if g not in self._hedges]
            if not stranded:
                continue
            grid = stranded[0]
            req = self._inflight.get(grid)
            if req is None:
                continue
            targets = [x for x in self.drives
                       if x.drive_id != d.drive_id and x.accepting
                       and self._health[x.drive_id] == HEALTHY
                       and x.load().capacity > 0]
            if not targets:
                continue
            t = min(targets, key=lambda x: (x.load().load, x.drive_id))
            with t.lock:
                local = t.engine.submit(req.prompt, max_new=req.max_new)
                t.rid_map[local] = grid
            self._hedges[grid] = (d.drive_id, t.drive_id)
            self.stats.hedges += 1
            if self.tele.enabled:
                self.tele.open_span(("hedge", grid), self.clock,
                                    "requests", f"hedge{grid}", rid=grid,
                                    primary=d.drive_id,
                                    hedge_drive=t.drive_id)
                self.tele.counter("cluster.hedges")

    def _idle_advance(self, tick: int) -> None:
        """A tick where nothing stepped: time must still move, or stall
        windows, retry backoffs, and deadlines would never elapse
        (graceful degradation instead of deadlock).  Tick-based events
        expire as ``step()`` calls pass, so they need no clock help;
        clock-based boundaries and backoffs fast-forward the wall clock
        (idle time, integrated at zero-active power).  When no progress
        is possible at all, the engine marks itself stuck and
        ``run_until_complete`` raises ``ClusterExhaustedError``."""
        if not (self.queue or any(d.has_work for d in self.drives)):
            return
        if self.faults is not None and \
                self.faults.next_tick_boundary(tick) is not None:
            return
        waits: List[float] = []
        if self.faults is not None:
            b = self.faults.next_clock_boundary(self.clock)
            if b is not None:
                waits.append(b)
        waits += [r.not_before_s for r in self.queue
                  if r.not_before_s > self.clock]
        if waits:
            to = min(waits)
            dt = max(to - self.clock, 0.0)
            self.clock = to
            self.stats.record_tick(0, dt, 0.0)
            self._idle_grace = 0
            return
        if any(not d.failed and d.has_work for d in self.drives):
            self._idle_grace = 0
            return       # the detector will declare them DEAD in bounded ticks
        if self._idle_grace < 1 and \
                any(r.not_before_s <= self.clock for r in self.queue) and \
                any(not d.failed and d.accepting
                    and self._health[d.drive_id] != SUSPECT
                    and d.load().capacity > 0 for d in self.drives):
            # a fail() THIS tick requeued work after dispatch already ran
            # (detection happens post-dispatch by design: dispatch uses
            # last tick's health) — give the next tick's dispatch one
            # chance before declaring the cluster exhausted
            self._idle_grace += 1
            return
        self._stuck = True

    def run_until_complete(self) -> List[GenResult]:
        while self.queue or any(d.has_work for d in self.drives):
            if self.queue and not any(d.accepting for d in self.drives) \
                    and not any(d.has_work for d in self.drives):
                raise ClusterExhaustedError(
                    f"{len(self.queue)} queued requests but every drive is "
                    f"draining/failed — nothing can serve them")
            if self._stuck:
                raise ClusterExhaustedError(
                    f"{len(self.queue)} queued requests cannot make "
                    f"progress: no drive can admit them (page pools "
                    f"clamped?) and no fault/backoff boundary is pending "
                    f"— the cluster is effectively draining/failed")
            self.step()
        if self._failout:
            self._finished.extend(self._failout)
            self._failout = []
        out, self._finished = self._finished, []
        return sorted(out, key=lambda r: r.rid)

    def generate(self, prompts: Sequence[Sequence[int]], max_new: int = 32,
                 shard_ids: Optional[Sequence[Optional[int]]] = None
                 ) -> List[GenResult]:
        """Greedy generation for a batch of prompts.  Drains the whole
        queue; results of requests queued earlier via ``submit()`` are kept
        for their caller, not discarded (same contract as
        ``ServeEngine.generate``)."""
        if shard_ids is None:
            shard_ids = [None] * len(prompts)
        if len(shard_ids) != len(prompts):
            raise ValueError("shard_ids must match prompts 1:1")
        rids = [self.submit(p, max_new=max_new, shard_id=s)
                for p, s in zip(prompts, shard_ids)]
        return collect_results(self, rids)

    # -- reporting -----------------------------------------------------------

    def kv_stats(self) -> List[Dict[str, float]]:
        return [d.engine.kv_stats() for d in self.drives]

    def drive_rates(self) -> List[float]:
        """The pull scheduler's live per-drive service-rate estimates
        (items/s; NaN until a drive has been observed)."""
        return self.pull.rates()

    def summary(self) -> str:
        rates = ", ".join("cold" if math.isnan(r) else f"{r:.1f}"
                          for r in self.drive_rates())
        speeds = ", ".join(f"{d.speed:g}" for d in self.drives)
        return (self.stats.summary()
                + f"\npull rates (items/s): [{rates}] at speed factors "
                  f"[{speeds}]"
                + (f"; quota gate on" if self.quota_gate else ""))
