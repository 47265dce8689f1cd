"""Per-request latency records + tail-latency / goodput aggregation.

The paper's claim is end-to-end service quality on a storage server, not
just aggregate tokens/s — and at the tail, scheduling and chunked-prefill
decisions become visible only through *per-request* timing.  This module is
the measurement layer the SLO-aware serving stack is built on:

  * ``LatencyRecord`` — one request's life on the serving clock:
    submit → admit (slot assignment) → first token → completion, plus the
    request's priority class and its (absolute) TTFT deadline.  Every
    timestamp lives on ONE clock — the single engine's virtual serving
    clock, or the cluster's idle-aware wall clock — so the derived metrics
    (queue wait, TTFT, time-per-output-token, end-to-end) are internally
    consistent: ``submit_t <= admit_t <= first_token_t <= finish_t``;
  * ``LatencyStats`` — the aggregation ``ServeStats`` / ``ClusterStats``
    expose: p50/p95/p99 TTFT and end-to-end percentiles, mean TPOT/queue
    wait, SLO attainment, and goodput-under-SLO (completions that met
    their TTFT deadline, per second of serving clock).

Degenerate inputs never raise (a shed-everything or instant-drain run must
not crash a bench): percentiles over zero completed records are NaN, rates
over a zero wall clock are NaN, counts are 0.  Callers gate on finiteness.
"""
from __future__ import annotations

import math
import threading
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

NAN = float("nan")


def percentile(xs: Sequence[float], q: float) -> float:
    """q-th percentile (0..100, linear interpolation) over the finite
    entries of ``xs``; NaN when none are finite (documented, not raised)."""
    vals = sorted(x for x in xs if math.isfinite(x))
    if not vals:
        return NAN
    if len(vals) == 1:
        return vals[0]
    rank = (len(vals) - 1) * q / 100.0
    lo = int(math.floor(rank))
    hi = min(lo + 1, len(vals) - 1)
    frac = rank - lo
    return vals[lo] * (1.0 - frac) + vals[hi] * frac


@dataclass
class LatencyRecord:
    """One request's timestamps on the serving clock (NaN until stamped)."""
    rid: int
    priority: int = 0
    deadline_s: Optional[float] = None   # absolute TTFT deadline; None = no SLO
    submit_t: float = NAN                # entered the shared queue
    admit_t: float = NAN                 # got a slot (re-stamped on restart)
    first_token_t: float = NAN           # first generated token emitted
    finish_t: float = NAN                # completed (or shed / failed)
    n_tokens: int = 0
    status: str = "pending"              # pending | ok | shed | failed
    retries: int = 0                     # fail()-restarts granted so far

    # -- derived metrics -----------------------------------------------------

    @property
    def queue_wait_s(self) -> float:
        return self.admit_t - self.submit_t

    @property
    def ttft_s(self) -> float:
        """Time to first token, measured from SUBMIT (queue wait included —
        that is where scheduling decisions show up)."""
        return self.first_token_t - self.submit_t

    @property
    def e2e_s(self) -> float:
        return self.finish_t - self.submit_t

    @property
    def tpot_s(self) -> float:
        """Time per output token AFTER the first (decode cadence); NaN for
        0/1-token requests, where no inter-token interval exists."""
        if self.n_tokens <= 1:
            return NAN
        return (self.finish_t - self.first_token_t) / (self.n_tokens - 1)

    @property
    def met_deadline(self) -> bool:
        """True iff the first token arrived by the deadline.  No deadline
        means no SLO to miss; a shed / never-served request missed it."""
        if self.deadline_s is None:
            return self.status == "ok"
        return math.isfinite(self.first_token_t) and \
            self.first_token_t <= self.deadline_s

    def restart(self) -> None:
        """A fail()-restarted request replays from its prompt: the service
        clock restarts (admit / first token re-stamped by the retry) but
        queue wait keeps the ORIGINAL submit — the user has been waiting
        since then, whatever the cluster did in between.  ``retries``
        counts the restarts so the retry budget is visible per record."""
        self.admit_t = NAN
        self.first_token_t = NAN
        self.n_tokens = 0
        self.retries += 1


@dataclass
class LatencyStats:
    """Aggregate view over completed (and shed) ``LatencyRecord``s."""
    records: List[LatencyRecord] = field(default_factory=list)
    # appended to from the concurrent runtime's absorb path; list.append
    # is GIL-atomic but the explicit lock keeps the contract honest
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)

    def add(self, rec: LatencyRecord) -> None:
        with self._lock:
            self.records.append(rec)

    # -- populations ---------------------------------------------------------

    @property
    def completed(self) -> List[LatencyRecord]:
        return [r for r in self.records if r.status == "ok"]

    @property
    def count(self) -> int:
        return len(self.completed)

    @property
    def shed(self) -> int:
        return sum(1 for r in self.records if r.status == "shed")

    @property
    def failed(self) -> int:
        """Requests that exhausted their retry budget (or died with the
        last drive) — terminal, never served."""
        return sum(1 for r in self.records if r.status == "failed")

    # -- percentiles (NaN over empty populations) ----------------------------

    def _pop(self, priority: Optional[int]) -> List[LatencyRecord]:
        """Completed records, optionally one priority class only — EDF
        trades the loose-deadline tail for the tight one, so aggregate
        percentiles hide exactly the improvement class-level ones show."""
        if priority is None:
            return self.completed
        return [r for r in self.completed if r.priority == priority]

    def ttft_p(self, q: float, priority: Optional[int] = None) -> float:
        return percentile([r.ttft_s for r in self._pop(priority)], q)

    def e2e_p(self, q: float, priority: Optional[int] = None) -> float:
        return percentile([r.e2e_s for r in self._pop(priority)], q)

    def queue_wait_p(self, q: float,
                     priority: Optional[int] = None) -> float:
        return percentile([r.queue_wait_s for r in self._pop(priority)], q)

    @property
    def p50_ttft_s(self) -> float:
        return self.ttft_p(50)

    @property
    def p95_ttft_s(self) -> float:
        return self.ttft_p(95)

    @property
    def p99_ttft_s(self) -> float:
        return self.ttft_p(99)

    @property
    def p99_e2e_s(self) -> float:
        return self.e2e_p(99)

    @property
    def mean_tpot_s(self) -> float:
        vals = [r.tpot_s for r in self.completed if math.isfinite(r.tpot_s)]
        return sum(vals) / len(vals) if vals else NAN

    @property
    def mean_queue_wait_s(self) -> float:
        vals = [r.queue_wait_s for r in self.completed
                if math.isfinite(r.queue_wait_s)]
        return sum(vals) / len(vals) if vals else NAN

    # -- SLO attainment ------------------------------------------------------

    @property
    def slo_met(self) -> int:
        """Completed requests whose first token beat their TTFT deadline
        (no-deadline completions count as met: there was no SLO to miss)."""
        return sum(1 for r in self.completed if r.met_deadline)

    @property
    def slo_attainment(self) -> float:
        """Fraction of ALL tracked requests (shed and failed included —
        both missed by construction) that met their deadline; NaN when
        nothing tracked."""
        denom = self.count + self.shed + self.failed
        return self.slo_met / denom if denom > 0 else NAN

    def goodput_qps(self, wall_s: float) -> float:
        """Goodput-under-SLO: deadline-met completions per second of serving
        clock.  NaN for a zero/negative wall clock (an instant-drain run)."""
        if not (wall_s > 0.0) or not math.isfinite(wall_s):
            return NAN
        return self.slo_met / wall_s

    # -- reporting -----------------------------------------------------------

    def metrics(self, wall_s: Optional[float] = None) -> dict:
        """Flat metric dict — the single source ``summary()`` (and the
        telemetry/metrics export) renders from, so printed and exported
        numbers cannot drift.  ``wall_s`` adds goodput on that clock."""
        m = {
            "count": self.count,
            "shed": self.shed,
            "failed": self.failed,
            "tracked": self.count + self.shed + self.failed,
            "p50_ttft_s": self.p50_ttft_s,
            "p95_ttft_s": self.p95_ttft_s,
            "p99_ttft_s": self.p99_ttft_s,
            "p99_e2e_s": self.p99_e2e_s,
            "mean_tpot_s": self.mean_tpot_s,
            "mean_queue_wait_s": self.mean_queue_wait_s,
            "slo_met": self.slo_met,
            "slo_attainment": self.slo_attainment,
        }
        if wall_s is not None:
            m["wall_s"] = wall_s
            m["goodput_qps"] = self.goodput_qps(wall_s)
        return m

    def summary(self) -> str:
        m = self.metrics()
        if m["tracked"] == 0:
            return "latency: no completed requests"
        failed = f" / {m['failed']} failed" if m["failed"] else ""
        return (f"latency: {m['count']} ok / {m['shed']} shed{failed}; TTFT "
                f"p50 {m['p50_ttft_s'] * 1e3:.1f} / p95 "
                f"{m['p95_ttft_s'] * 1e3:.1f} / p99 "
                f"{m['p99_ttft_s'] * 1e3:.1f} ms; e2e p99 "
                f"{m['p99_e2e_s'] * 1e3:.1f} ms; TPOT "
                f"{m['mean_tpot_s'] * 1e3:.2f} ms; queue wait "
                f"{m['mean_queue_wait_s'] * 1e3:.1f} ms; SLO met "
                f"{m['slo_met']}/{m['tracked']}")
