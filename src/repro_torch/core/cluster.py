"""Multi-drive CSD cluster layer: routing policies over replica serve
engines behind one queue, merged transfer stats, and live energy accounting.

The paper's headline numbers come from a *cluster* of CSDs in one storage
server (36 drives, Table I / Fig. 6), not from a single device.  This module
is the pure/mechanical half of that tier — the serving half
(``train.cluster_loop.ClusterEngine``) owns the replica engines and drives
the pieces defined here:

  * ``Router`` — pluggable dispatch policies over a shared request queue:
      round_robin   cycle over accepting drives (ignores load and locality);
      least_loaded  pick the drive with the lowest live slot/page occupancy;
      data_local    requests carry a ``shard_id``; the router pins them to
                    the drive holding that shard (bring compute to data),
                    spilling to the least-loaded remote drive only when the
                    home drive has no capacity — and every remote serve is
                    charged the shard bytes that now have to cross the link;
      rate_aware    pick the drive with the shortest *expected completion*
                    (virtual clock + backlog / learned rate — the cluster
                    pull scheduler's live per-drive estimates), WAITING for
                    that drive when it is momentarily full rather than
                    burdening a slower-but-free one: a 2x-slower drive ends
                    up with proportionally fewer requests instead of an
                    equal share.  Unobserved drives are tried first so
                    every drive produces a measurement (explore, then
                    exploit);
  * ``merge_ledgers`` — fold per-drive ``TransferLedger``s (plus the
    cluster's own spill ledger) into one cluster-wide accounting;
  * ``ClusterStats`` — the merged view: aggregate tokens/s under the
    parallel-drives wall-clock model (per tick the cluster advances by the
    *slowest* stepped drive — drives are independent hardware), per-tick
    active-engine counts integrated into wall energy via
    ``core.energy.server_power``, and the Table I metric
    ``energy_per_query_mj`` next to the link/KV reductions.

A copy of ``repro/core/cluster.py``, which has no JAX in it.
"""
from __future__ import annotations

import math
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Union

from repro_torch.core import energy as E
from repro_torch.core.latency import LatencyStats
from repro_torch.core.transfer import TransferLedger

ROUTING_POLICIES = ("round_robin", "least_loaded", "data_local",
                    "rate_aware")

Placement = Union[Dict[int, int], Callable[[int], int], None]


class ClusterExhaustedError(RuntimeError):
    """Every drive is draining/failed and queued work can never be served.

    Subclasses ``RuntimeError`` (and keeps "draining/failed" in its
    message) so callers matching on the old exception keep working.  When
    the LAST healthy drive *fails*, the engine instead finishes queued
    requests with ``status="failed"`` — this error marks the drain-only
    corner, where the operator parked every drive with work still queued.
    """


def merge_ledgers(ledgers: Sequence[TransferLedger]) -> TransferLedger:
    """Fold per-drive ledgers into one cluster ledger (tiers and notes sum)."""
    out = TransferLedger()
    for led in ledgers:
        out.link_bytes += led.link_bytes
        out.local_bytes += led.local_bytes
        out.output_bytes += led.output_bytes
        out.kv_bytes += led.kv_bytes
        for note, n in led.notes.items():
            out.notes[note] = out.notes.get(note, 0.0) + n
    return out


def shard_spill_bytes(prompt_len: int, max_new: int, d_model: int,
                      bytes_per_el: int) -> float:
    """Link bytes a remote serve costs: the request's resident token rows
    (prompt + everything it will generate) live on the home drive and must
    cross the drive-to-drive link when another drive computes on them —
    the inverse of the paper's bring-compute-to-data placement."""
    return float((prompt_len + max_new) * d_model * bytes_per_el)


@dataclass
class DriveLoad:
    """One drive's live occupancy as the router sees it."""
    drive_id: int
    num_slots: int
    active: int = 0            # slots mid-flight
    pending: int = 0           # requests queued on the drive itself
    page_fill: float = 0.0     # fraction of the KV page pool in use
    accepting: bool = True     # False while draining / after a failure
    clock: float = 0.0         # drive's virtual clock (cumulative busy time)
    service_s: float = math.nan  # est. seconds to serve one request
    quota: Optional[int] = None  # optional hard cap on in-flight requests

    @property
    def capacity(self) -> int:
        """Requests the drive can take before they queue behind a slot —
        optionally hard-capped by an explicit pull quota.  (The default
        rate_aware gate prefers ETA deferral over this cap: one engine tick
        costs the same whether 1 or all slots are live, so capping a slow
        drive below its slot count wastes whole ticks on partial batches.)"""
        cap = self.num_slots if self.quota is None \
            else min(self.num_slots, self.quota)
        return cap - self.active - self.pending

    @property
    def load(self) -> float:
        """Slot occupancy, page occupancy as the tie-break (two drives with
        the same slot count but different live KV tails differ in how soon
        their pools backpressure)."""
        return (self.active + self.pending) / max(self.num_slots, 1) \
            + 0.25 * self.page_fill


@dataclass(frozen=True)
class Route:
    drive_id: int
    remote: bool = False       # data_local spill (or home drive unavailable)


class Router:
    """Pluggable routing policy over a set of ``DriveLoad``s.

    ``pick`` returns ``None`` when no eligible drive can accept the request
    this tick — the request stays in the shared queue (FIFO order is
    preserved by the caller; the cluster never reorders around a blocked
    head, which keeps replay deterministic).
    """

    def __init__(self, policy: str, n_drives: int,
                 placement: Placement = None, spill: bool = True):
        if policy not in ROUTING_POLICIES:
            raise ValueError(f"routing policy must be one of "
                             f"{ROUTING_POLICIES}, got {policy!r}")
        if n_drives < 1:
            raise ValueError("need at least one drive")
        self.policy = policy
        self.n_drives = n_drives
        self.placement = placement
        self.spill = spill
        # routing state (_rr rotation, _overrides) is shared between the
        # coordinator and anything inspecting routes concurrently; RLock
        # because pick() -> _is_remote() -> home() re-enters
        self._lock = threading.RLock()
        self._rr = 0
        # shard re-placement: overrides win over the static placement, so a
        # drained/failed drive's shards can move to a survivor once instead
        # of paying spill bytes on every future request
        self._overrides: Dict[int, int] = {}

    def home(self, shard_id: int) -> int:
        """The drive holding ``shard_id``'s data (re-placement overrides
        first, then the static placement)."""
        with self._lock:
            if shard_id in self._overrides:
                return self._overrides[shard_id]
        if callable(self.placement):
            d = self.placement(shard_id)
        elif isinstance(self.placement, dict):
            d = self.placement[shard_id]
        else:
            d = shard_id % self.n_drives
        if not 0 <= d < self.n_drives:
            raise ValueError(f"placement maps shard {shard_id} to drive {d} "
                             f"outside [0, {self.n_drives})")
        return d

    def replace_shard(self, shard_id: int, drive_id: int) -> None:
        """Move ``shard_id``'s home to ``drive_id`` (the caller charges the
        migrated bytes; from here on the shard is local to its new home)."""
        if not 0 <= drive_id < self.n_drives:
            raise ValueError(f"cannot place shard {shard_id} on drive "
                             f"{drive_id} outside [0, {self.n_drives})")
        with self._lock:
            self._overrides[shard_id] = drive_id

    def pick(self, shard_id: Optional[int],
             loads: Sequence[DriveLoad]) -> Optional[Route]:
        eligible = [l for l in loads if l.accepting and l.capacity > 0]
        if not eligible:
            return None
        with self._lock:
            if self.policy == "round_robin":
                return self._round_robin(shard_id, loads, eligible)
            if self.policy == "least_loaded":
                return self._least_loaded(shard_id, eligible)
            if self.policy == "rate_aware":
                return self._rate_aware(shard_id, loads, eligible)
            return self._data_local(shard_id, loads, eligible)

    # -- policies ------------------------------------------------------------

    def _is_remote(self, shard_id: Optional[int], drive_id: int) -> bool:
        """A sharded request served off its home drive pays the spill bytes
        regardless of which policy put it there — that is exactly the cost a
        locality-oblivious policy silently eats."""
        return shard_id is not None and self.home(shard_id) != drive_id

    def _round_robin(self, shard_id, loads, eligible) -> Route:
        # Rotate over the ELIGIBLE set: the next pick is the first eligible
        # drive in cyclic order strictly after the last one picked.  Keying
        # the rotation to the last picked drive (rather than stepping a raw
        # pointer that can come to rest on an ineligible drive) keeps the
        # distribution uniform over the survivors when a drive drains or
        # fails mid-rotation — no survivor permanently inherits the drained
        # drive's turns.
        ids = sorted(l.drive_id for l in eligible)
        d = next((i for i in ids if i >= self._rr), ids[0])
        self._rr = (d + 1) % self.n_drives
        return Route(d, remote=self._is_remote(shard_id, d))

    def _least_loaded(self, shard_id, eligible) -> Route:
        best = min(eligible, key=lambda l: (l.load, l.drive_id))
        return Route(best.drive_id,
                     remote=self._is_remote(shard_id, best.drive_id))

    def _rate_aware(self, shard_id, loads, eligible) -> Optional[Route]:
        """Shortest expected COMPLETION across the whole cluster: the
        request goes to the drive minimizing

            virtual clock + (in-flight + 1) × est. seconds per request

        i.e. when the drive would actually finish it, given how far ahead
        its clock already is and its learned service rate.  If that drive
        has no free slot the head WAITS for it (returns None) — handing
        the request to a slower-but-free drive would finish it later, and
        one engine tick costs the same whether 1 or all slots are live, so
        partially loading the slow drive wastes whole (2x-priced) ticks.
        This deferral IS the pull quota in continuous form: a 2x-slower
        drive's clock runs ahead 2x faster, so it ends up pulling
        proportionally fewer requests without any hard cap.

        Drives without an estimate yet are tried FIRST (they must serve
        something before the scheduler can rate them), ordered like
        least_loaded — a cold cluster routes exactly like least_loaded
        until the rates arrive."""
        cold = [l for l in eligible
                if not (math.isfinite(l.service_s) and l.service_s > 0.0)]
        if cold:
            best = min(cold, key=lambda l: (l.load, l.drive_id))
            return Route(best.drive_id,
                         remote=self._is_remote(shard_id, best.drive_id))
        rated = [l for l in loads if l.accepting
                 and math.isfinite(l.service_s) and l.service_s > 0.0]
        if not rated:
            return self._least_loaded(shard_id, eligible)
        best = min(rated, key=lambda l: (
            l.clock + (l.active + l.pending + 1) * l.service_s,
            l.load, l.drive_id))
        if best.capacity > 0:
            return Route(best.drive_id,
                         remote=self._is_remote(shard_id, best.drive_id))
        return None                # wait for the fastest-finishing drive

    def _data_local(self, shard_id, loads, eligible) -> Optional[Route]:
        if shard_id is None:                 # nothing to be local to
            return self._least_loaded(None, eligible)
        h = self.home(shard_id)
        home = next((l for l in loads if l.drive_id == h), None)
        if home is not None and home.accepting and home.capacity > 0:
            return Route(h, remote=False)
        home_alive = home is not None and home.accepting
        if self.spill or not home_alive:
            # overloaded (or dead) home: serve remotely and pay the shard
            # bytes rather than head-of-line-block the whole queue
            return self._least_loaded(shard_id, eligible)
        return None                          # wait for the home drive


@dataclass
class ClusterStats:
    """Merged per-drive stats + the cluster's own wall-clock/energy track.

    Wall-clock model: drives are independent hardware with no tick barrier
    (the paper's pull protocol is ack-driven, not lockstep), so the engine
    keeps one virtual clock per drive and a cluster tick costs the advance
    of the *leading* clock — work a lagging drive does in the leader's
    shadow adds no wall time, which is what makes rate-proportional load
    splitting measurable (a straggler-bound per-tick max would be invariant
    to the split).  ``cluster_s`` integrates those advances (= the leading
    drive's cumulative busy time, the parallel makespan); the serial sum of
    per-drive busy time (``serial_s``) is what one host-side engine would
    have needed — the pair gives both the scaling curve and the host
    baseline the energy reduction is measured against.

    Energy model (paper Table I): every tick integrates
    ``server_power(n_active_drives) * tick_s`` into ``energy_j``; because
    ``server_power`` is affine in the active-engine count, the accumulated
    energy equals ``server_power(mean_active) * cluster_s`` exactly, and
    ``energy_per_query_mj`` therefore matches
    ``core.energy.energy_per_query_mj(throughput_qps, mean_active)``.
    """
    drives: List = field(default_factory=list)        # per-drive ServeStats
    spill_ledger: TransferLedger = field(default_factory=TransferLedger)
    completed: int = 0         # requests fully served by the cluster
    remote_requests: int = 0   # served off their shard's home drive
    migrated_shards: int = 0   # shards re-placed after a drain/fail
    ticks: int = 0
    cluster_s: float = 0.0     # sum over ticks of max per-drive tick time
    serial_s: float = 0.0      # sum over ticks of SUM of per-drive times
    energy_j: float = 0.0      # integral of server_power(n_active) dt
    _active_dt: float = 0.0    # integral of n_active dt (for mean_active)
    # SLO accounting on the cluster's idle-aware wall clock: one
    # LatencyRecord per tracked request, plus load-shedding tallies
    # (shed_wasted_s = serving time already burned on then-dropped work)
    latency: LatencyStats = field(default_factory=LatencyStats)
    shed_requests: int = 0
    shed_wasted_s: float = 0.0
    # fault tolerance: injected-fault and recovery accounting.
    # health mirrors the FailureDetector's per-drive state each tick
    # (healthy/suspect/dead); retries counts fail()-restarts granted;
    # failed_requests are terminal status="failed" finishes (retry budget
    # exhausted or the last drive died); hedge_wasted_s is serving time
    # burned on the losing copy of a hedged dispatch (booked like
    # shed_wasted_s).
    health: List[str] = field(default_factory=list)
    faults_injected: int = 0   # fault events that became active
    auto_failed_drives: int = 0  # drives the detector (not the operator) killed
    retries: int = 0
    failed_requests: int = 0
    hedges: int = 0            # hedged dispatches launched
    hedges_won: int = 0        # hedge copy finished first (or primary died)
    hedges_lost: int = 0       # primary finished first / hedge abandoned
    hedge_wasted_s: float = 0.0
    # tick accounting is += on floats — keep it atomic under the
    # concurrent worker runtime (excluded from repr/compare: a lock is
    # runtime plumbing, not a stat)
    _tick_lock: threading.Lock = field(default_factory=threading.Lock,
                                       repr=False, compare=False)

    def record_tick(self, n_active: int, tick_s: float,
                    tick_serial_s: Optional[float] = None) -> None:
        """One cluster tick: ``tick_s`` is the cluster wall-clock advance
        (the engine passes the leading virtual clock's delta; a lagging
        drive's overlapped work may make it 0), ``tick_serial_s`` the sum
        over stepped drives — what a lone host engine replaying the same
        work would have paid (defaults to ``tick_s``: one drive stepped)."""
        if tick_s < 0:
            raise ValueError("negative tick duration")
        with self._tick_lock:
            self.ticks += 1
            self.cluster_s += tick_s
            self.serial_s += (tick_serial_s if tick_serial_s is not None
                              else tick_s)
            self.energy_j += E.server_power(n_active) * tick_s
            self._active_dt += n_active * tick_s

    # -- merged transfer accounting ------------------------------------------

    @property
    def ledger(self) -> TransferLedger:
        return merge_ledgers([d.ledger for d in self.drives]
                             + [self.spill_ledger])

    @property
    def baseline(self) -> TransferLedger:
        return merge_ledgers([d.baseline for d in self.drives])

    @property
    def spill_bytes(self) -> float:
        """All cluster-level link bytes: per-request remote-serve spills
        plus one-time shard migrations."""
        return self.spill_ledger.link_bytes

    @property
    def shard_migration_bytes(self) -> float:
        """Bytes moved by shard re-placement (charged once per migration,
        instead of a per-request spill forever)."""
        return self.spill_ledger.notes.get("shard migration", 0.0)

    @property
    def link_bytes(self) -> float:
        return self.ledger.link_bytes

    @property
    def host_link_bytes(self) -> float:
        return self.baseline.link_bytes

    @property
    def link_reduction(self) -> float:
        if self.host_link_bytes <= 0:
            return 0.0
        return max(1.0 - self.link_bytes / self.host_link_bytes, 0.0)

    @property
    def kv_reduction(self) -> float:
        base = self.baseline.kv_bytes
        if base <= 0:
            return 0.0
        return max(1.0 - self.ledger.kv_bytes / base, 0.0)

    # -- aggregate serving numbers -------------------------------------------

    @property
    def tokens(self) -> int:
        return sum(d.tokens for d in self.drives)

    @property
    def requests_admitted(self) -> int:
        """Per-drive admissions (a failed-over request counts on each drive
        that admitted it; ``completed`` counts global requests once)."""
        return sum(d.requests for d in self.drives)

    @property
    def busy_s(self) -> float:
        """Jit-only busy time summed over drives (excludes host overhead —
        compare against ``serial_s``, which includes it on both sides)."""
        return sum(d.prefill_s + d.decode_s for d in self.drives)

    @property
    def tokens_per_s(self) -> float:
        return self.tokens / max(self.cluster_s, 1e-9)

    @property
    def throughput_qps(self) -> float:
        return self.completed / max(self.cluster_s, 1e-9)

    # -- energy (paper Table I, live) ----------------------------------------

    @property
    def mean_active(self) -> float:
        """Time-weighted mean number of simultaneously active drives."""
        return self._active_dt / max(self.cluster_s, 1e-9)

    @property
    def energy_per_query_mj(self) -> float:
        """Table I metric from the live integral: wall energy / queries.

        Degenerate runs are reported, not raised: with zero completed
        queries (everything shed, or stats read before the first finish)
        there is no per-query denominator — the metric is 0.0 by
        convention so dashboards render a number; callers gating on it
        should check ``completed > 0`` first.
        """
        if self.completed <= 0:
            return 0.0
        return self.energy_j / self.completed * 1e3

    @property
    def mean_power_w(self) -> float:
        """Time-averaged wall power over the run; 0.0 for a zero-length
        run (no time elapsed means no power draw to average)."""
        if self.cluster_s <= 0:
            return 0.0
        return self.energy_j / self.cluster_s

    @property
    def shed_energy_mj(self) -> float:
        """Energy burned on requests that were then shed: the serving time
        already spent on dropped work, priced at the run's mean wall power.
        0.0 when nothing was shed or no wall time has elapsed (the latter
        means shed work cost no measurable energy yet, not an error)."""
        return self.shed_wasted_s * self.mean_power_w * 1e3

    @property
    def hedge_energy_mj(self) -> float:
        """Energy burned on losing hedge copies, priced like shed work at
        the run's mean wall power (0.0 when nothing was hedged)."""
        return self.hedge_wasted_s * self.mean_power_w * 1e3

    @property
    def wasted_s(self) -> float:
        """All serving time spent on work that was then thrown away —
        shed requests plus losing hedge copies."""
        return self.shed_wasted_s + self.hedge_wasted_s

    @property
    def energy_reduction_vs_host(self) -> float:
        """Energy-per-query saving vs one host-side engine serving the same
        workload serially at ISP-disabled wall power (``server_power(0)``)."""
        if self.completed <= 0 or self.serial_s <= 0 or self.cluster_s <= 0:
            return 0.0
        e_host = E.energy_per_query_mj(self.completed / self.serial_s, 0)
        e_cluster = self.energy_per_query_mj
        if not math.isfinite(e_host) or e_host <= 0:
            return 0.0
        return 1.0 - e_cluster / e_host

    # -- reporting -----------------------------------------------------------

    def metrics(self) -> dict:
        """Flat metric dict — the single source ``summary()`` renders from
        and the telemetry/metrics export publishes, so the printed and
        the exported cluster numbers can never disagree."""
        m = {
            "n_drives": len(self.drives),
            "completed": self.completed,
            "tokens": self.tokens,
            "cluster_s": self.cluster_s,
            "serial_s": self.serial_s,
            "tokens_per_s": self.tokens_per_s,
            "throughput_qps": self.throughput_qps,
            "ticks": self.ticks,
            "mean_active": self.mean_active,
            "energy_j": self.energy_j,
            "energy_per_query_mj": self.energy_per_query_mj,
            "mean_power_w": self.mean_power_w,
            "energy_reduction_vs_host": self.energy_reduction_vs_host,
            "link_bytes": self.link_bytes,
            "host_link_bytes": self.host_link_bytes,
            "link_reduction": self.link_reduction,
            "kv_bytes": self.ledger.kv_bytes,
            "kv_dense_bytes": self.baseline.kv_bytes,
            "kv_reduction": self.kv_reduction,
            "spill_bytes": self.spill_bytes,
            "remote_requests": self.remote_requests,
            "migrated_shards": self.migrated_shards,
            "shard_migration_bytes": self.shard_migration_bytes,
            "shed_requests": self.shed_requests,
            "shed_wasted_s": self.shed_wasted_s,
            "shed_energy_mj": self.shed_energy_mj,
            "faults_injected": self.faults_injected,
            "auto_failed_drives": self.auto_failed_drives,
            "retries": self.retries,
            "failed_requests": self.failed_requests,
            "hedges": self.hedges,
            "hedges_won": self.hedges_won,
            "hedges_lost": self.hedges_lost,
            "hedge_wasted_s": self.hedge_wasted_s,
            "hedge_energy_mj": self.hedge_energy_mj,
        }
        for i, d in enumerate(self.drives):
            m[f"drive.{i}.requests"] = d.requests
            m[f"drive.{i}.tokens"] = d.tokens
            m[f"drive.{i}.busy_s"] = d.prefill_s + d.decode_s
            m[f"drive.{i}.link_reduction"] = d.link_reduction
            m[f"drive.{i}.kv_reduction"] = d.kv_reduction
        return m

    def summary(self) -> str:
        m = self.metrics()
        lines = [
            f"cluster: {m['n_drives']} drives, {m['completed']} requests, "
            f"{m['tokens']} tokens in {m['cluster_s']:.2f}s parallel "
            f"({m['tokens_per_s']:.1f} tok/s; serial "
            f"{m['serial_s']:.2f}s)",
            f"energy: {m['energy_per_query_mj']:.1f} mJ/query at "
            f"{m['mean_active']:.2f} mean active drives "
            f"({m['energy_reduction_vs_host']:.0%} vs host-serial)",
            f"link bytes: {m['link_bytes'] / 1e6:.2f} MB vs host-only "
            f"{m['host_link_bytes'] / 1e6:.2f} MB "
            f"({m['link_reduction']:.0%} never crossed the link; "
            f"{m['spill_bytes'] / 1e6:.3f} MB shard spill, "
            f"{m['remote_requests']} remote requests, "
            f"{m['migrated_shards']} shards migrated "
            f"[{m['shard_migration_bytes'] / 1e6:.3f} MB])",
        ]
        if m["kv_dense_bytes"] > 0:
            lines.append(f"KV bytes touched: {m['kv_bytes'] / 1e6:.2f}"
                         f" MB vs dense {m['kv_dense_bytes'] / 1e6:.2f} MB"
                         f" ({m['kv_reduction']:.0%} fewer KV reads)")
        if self.latency.records:
            lines.append(self.latency.summary())
        if m["shed_requests"]:
            lines.append(f"shed: {m['shed_requests']} requests "
                         f"({m['shed_wasted_s']:.3f}s wasted, "
                         f"{m['shed_energy_mj']:.1f} mJ)")
        if m["faults_injected"] or m["auto_failed_drives"] or self.health:
            state = ", ".join(self.health) if self.health else "untracked"
            lines.append(f"faults: {m['faults_injected']} injected; "
                         f"health [{state}]; "
                         f"{m['auto_failed_drives']} drives auto-failed "
                         f"by the detector")
        if m["retries"] or m["failed_requests"]:
            lines.append(f"recovery: {m['retries']} retries granted, "
                         f"{m['failed_requests']} requests failed "
                         f"permanently")
        if m["hedges"]:
            lines.append(f"hedges: {m['hedges']} launched, "
                         f"{m['hedges_won']} won / {m['hedges_lost']} lost "
                         f"({m['hedge_wasted_s']:.3f}s wasted, "
                         f"{m['hedge_energy_mj']:.1f} mJ)")
        for i in range(len(self.drives)):
            lines.append(
                f"drive[{i}]: {m[f'drive.{i}.requests']} reqs, "
                f"{m[f'drive.{i}.tokens']} tok, "
                f"busy {m[f'drive.{i}.busy_s']:.2f}s, "
                f"link cut {m[f'drive.{i}.link_reduction']:.0%}, "
                f"KV cut {m[f'drive.{i}.kv_reduction']:.0%}")
        return "\n".join(lines)
