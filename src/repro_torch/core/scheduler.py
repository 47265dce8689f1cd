"""The paper's pull-based heterogeneous scheduler (§IV-A), faithfully
reimplemented, plus a discrete-event cluster simulator to evaluate it.

Mechanics reproduced from the paper:
  * pull/ack protocol — a node acks when its batch is done; the ack is the
    request for the next batch;
  * the scheduler thread wakes every 0.2 s to poll acks (we model ack
    pickup latency by quantizing assignment times to the 0.2 s grid);
  * two tunables: ``batch_size`` (items per CSD assignment) and
    ``batch_ratio`` (host batch = ratio × batch_size), with the ratio set
    from measured single-node throughputs (Xeon ≈ 20–30 × ARM A53);
  * per-batch fixed overhead — the reason Fig. 6 shows throughput rising
    with batch size and why tiny batches under-utilize the host.

The same class drives the training runtime's straggler mitigation
(``launch/elastic.py``): observed step times -> new per-worker shares.
"""
from __future__ import annotations

import heapq
import math
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass(frozen=True)
class Node:
    name: str
    rate: float                  # items/s at infinite batch (steady-state)
    batch_overhead: float = 0.0  # fixed seconds per batch (dispatch+wakeup)
    is_host: bool = False

    def batch_seconds(self, n_items: int) -> float:
        return self.batch_overhead + n_items / self.rate

    def effective_rate(self, n_items: int) -> float:
        return n_items / self.batch_seconds(n_items)


@dataclass
class NodeStats:
    items: int = 0
    batches: int = 0
    busy_s: float = 0.0


@dataclass
class SimResult:
    makespan: float
    throughput: float
    per_node: Dict[str, NodeStats]
    total_items: int

    @property
    def host_fraction(self) -> float:
        host = sum(s.items for n, s in self.per_node.items() if n.startswith("host"))
        return host / max(self.total_items, 1)

    @property
    def csd_fraction(self) -> float:
        """Fraction of data processed in storage — the paper's
        'data that never left the drive' number."""
        return 1.0 - self.host_fraction


@dataclass(frozen=True)
class Assignment:
    """One pull event: ``node`` acked and was handed ``n_items`` more."""
    node: Node
    n_items: int
    start: float
    finish: float


@dataclass
class SchedulerState:
    """Mutable event-loop state so callers can drive the scheduler one pull
    at a time (the serve engine's admission loop) instead of to completion."""
    remaining: int
    total_items: int
    stats: Dict[str, NodeStats]
    heap: List[Tuple[float, int, int]] = field(default_factory=list)
    seq: int = 0
    t_end: float = 0.0

    @property
    def done(self) -> bool:
        return self.remaining <= 0

    def result(self) -> SimResult:
        assigned = self.total_items - max(self.remaining, 0)
        return SimResult(makespan=self.t_end,
                         throughput=assigned / max(self.t_end, 1e-9),
                         per_node=self.stats, total_items=assigned)


class PullScheduler:
    """Discrete-event simulation of the MPI pull scheduler."""

    def __init__(self, nodes: List[Node], batch_size: int, batch_ratio: float,
                 poll_interval: float = 0.2):
        self.nodes = nodes
        self.batch_size = batch_size
        self.batch_ratio = batch_ratio
        self.poll = poll_interval

    def node_batch(self, node: Node) -> int:
        if node.is_host:
            return max(1, int(round(self.batch_size * self.batch_ratio)))
        return max(1, self.batch_size)

    def _quantize(self, t: float) -> float:
        """Acks are picked up at the next scheduler wakeup."""
        if self.poll <= 0:
            return t
        return math.ceil(t / self.poll - 1e-9) * self.poll

    def start(self, total_items: int) -> SchedulerState:
        """Begin an incremental run: every node's initial pull is queued."""
        state = SchedulerState(remaining=total_items, total_items=total_items,
                               stats={n.name: NodeStats() for n in self.nodes})
        for i, _ in enumerate(self.nodes):
            heapq.heappush(state.heap, (0.0, state.seq, i))
            state.seq += 1
        return state

    def tick(self, state: SchedulerState) -> Optional[Assignment]:
        """Advance one pull/ack event; ``None`` once all items are assigned.

        ``run()`` is exactly ``start()`` + ``tick()`` until exhaustion, so the
        two APIs agree batch-for-batch (and therefore on makespan).
        """
        if state.remaining <= 0 or not state.heap:
            return None
        ready, _, i = heapq.heappop(state.heap)
        node = self.nodes[i]
        n = min(self.node_batch(node), state.remaining)
        state.remaining -= n
        start = self._quantize(ready)
        dur = node.batch_seconds(n)
        finish = start + dur
        st = state.stats[node.name]
        st.items += n
        st.batches += 1
        st.busy_s += dur
        state.t_end = max(state.t_end, finish)
        if state.remaining > 0:
            heapq.heappush(state.heap, (finish, state.seq, i))
            state.seq += 1
        return Assignment(node=node, n_items=n, start=start, finish=finish)

    def run(self, total_items: int) -> SimResult:
        state = self.start(total_items)
        while self.tick(state) is not None:
            pass
        return state.result()


def optimal_batch_ratio(host_rate: float, csd_rate: float) -> float:
    """The paper's rule: ratio ≈ host/CSD single-node throughput (20–30)."""
    return host_rate / csd_rate


def make_cluster(host_rate: float, csd_rate: float, n_csds: int,
                 host_overhead: float = 0.05, csd_overhead: float = 0.05) -> List[Node]:
    nodes = [Node("host", host_rate, host_overhead, is_host=True)]
    nodes += [Node(f"csd{i:02d}", csd_rate, csd_overhead) for i in range(n_csds)]
    return nodes


# ---------------------------------------------------------------------------
# Straggler mitigation for the training runtime (batch-ratio rule applied to
# observed per-worker step times)
# ---------------------------------------------------------------------------


def split_block_service(block_s: float, per_step_items: List[int]) -> List[float]:
    """Attribute one fused K-step block's wall time across its inner steps,
    proportional to the items each step actually served.

    The serve engine's device-resident decode loop observes one wall-clock
    sample per *block*; feeding that lump to ``rebalance_shares`` would make
    the batch-ratio refit see K-step-quantized service times.  Splitting it
    per step (weighted by live slots, since a step serving fewer slots did
    proportionally less work) restores the bounded per-step samples the
    K=1 loop produced.  Returns one duration per step; they sum to
    ``block_s`` exactly (idle steps get an equal share if nothing ran).
    """
    total = sum(per_step_items)
    if total <= 0:
        n = max(len(per_step_items), 1)
        return [block_s / n] * len(per_step_items)
    return [block_s * items / total for items in per_step_items]


class ClusterAdmission:
    """Cluster-wide pull scheduler: learn each drive's service rate online
    and size per-drive pull quotas the way §IV-A sizes host-vs-CSD batches.

    The paper's pull protocol lets heterogeneous nodes cooperate without
    stragglers because each node's batch is sized to its *measured* rate.
    With one private ``AdmissionController`` per drive and a rate-blind
    router, a slow drive would be handed the same share as a fast one.
    This controller closes that gap at the cluster level:

      * ``observe()`` feeds one engine tick per drive — the tick's wall
        time is spread over its inner decode steps with
        ``split_block_service`` (the same attribution the single-engine
        scheduler uses for fused K-blocks), and each step's per-item
        service time updates an EWMA;
      * ``rate()`` is the learned items/s estimate (NaN until observed);
      * ``quotas()`` refits per-drive in-flight quotas with
        ``rebalance_shares`` — share ∝ measured rate, blended against the
        current shares, exact-sum, and protected by the cold-start guard
        (an unobserved drive keeps the current proportions instead of
        being read as infinitely fast).
    """

    def __init__(self, n_drives: int, alpha: float = 0.15,
                 smoothing: float = 0.5):
        if n_drives < 1:
            raise ValueError("need at least one drive")
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.n_drives = n_drives
        self.alpha = alpha
        self.smoothing = smoothing
        # the EWMA / share / quarantine state is read-modify-write from
        # whoever absorbs drive ticks — serialize it so the concurrent
        # worker runtime can't interleave half-applied updates (RLock:
        # quotas() and rates() re-enter through rate())
        self._lock = threading.RLock()
        # EWMA of per-item service seconds; NaN = never observed
        self._ewma: Dict[int, float] = {d: math.nan for d in range(n_drives)}
        self.samples: Dict[int, int] = {d: 0 for d in range(n_drives)}
        self._shares: Dict[int, int] = {}
        # drives the failure detector currently suspects: their ticks are
        # untrustworthy (a half-stalled drive reports garbage service
        # times), so they neither update the EWMA nor take part in the
        # share refit until released
        self._quarantined: set = set()

    def observe(self, drive: int, block_s: float,
                per_step_items: List[int]) -> None:
        """One engine tick: ``block_s`` of serving wall time (compile time
        already excluded by the caller) over ``per_step_items`` items per
        inner step."""
        if drive not in self._ewma:
            raise KeyError(f"unknown drive {drive}")
        with self._lock:
            if drive in self._quarantined:
                return
            if block_s <= 0.0 or not math.isfinite(block_s):
                return
            for dur, items in zip(split_block_service(block_s,
                                                      per_step_items),
                                  per_step_items):
                if items <= 0 or dur <= 0.0:
                    continue
                per_item = dur / items
                prev = self._ewma[drive]
                self._ewma[drive] = per_item if not math.isfinite(prev) \
                    else self.alpha * per_item + (1.0 - self.alpha) * prev
                self.samples[drive] += 1

    def quarantine(self, drive: int) -> None:
        """Stop trusting a SUSPECT drive's ticks: its observations are
        dropped and ``quotas()`` refits shares over the others only — a
        stalled drive must not poison the learned rates or keep a share
        it cannot serve."""
        if drive not in self._ewma:
            raise KeyError(f"unknown drive {drive}")
        with self._lock:
            self._quarantined.add(drive)

    def unquarantine(self, drive: int) -> None:
        """A recovered drive's ticks count again (its pre-quarantine EWMA
        is kept — the hardware is the same, the stall was transient)."""
        with self._lock:
            self._quarantined.discard(drive)

    @property
    def quarantined(self) -> List[int]:
        return sorted(self._quarantined)

    def rate(self, drive: int) -> float:
        """Learned service rate in items/s; NaN until the drive has been
        observed (callers must treat NaN as "no estimate yet")."""
        with self._lock:
            t = self._ewma[drive]
        return 1.0 / t if (math.isfinite(t) and t > 0.0) else math.nan

    def rates(self) -> List[float]:
        return [self.rate(d) for d in range(self.n_drives)]

    def quotas(self, total: int, live: List[int]) -> Dict[int, int]:
        """Per-drive pull quotas over the ``live`` drives, summing exactly
        to ``total`` (the cluster's concurrency budget).

        ``rebalance_shares`` wants per-worker *step times for their current
        share*; feeding it ``share * ewma_per_item`` makes its throughput
        estimate ``share / t = 1/ewma`` — i.e. new share ∝ measured rate,
        which is the paper's batch-ratio rule applied across drives.  The
        cold-start guard inside ``rebalance_shares`` keeps the current
        proportions while any live drive is still unobserved.
        """
        if not live:
            return {}
        live = sorted(set(live))
        with self._lock:
            # quarantined drives are refit around, not into — unless EVERY
            # live drive is quarantined, where excluding them all would
            # leave nothing to serve at all (better a suspect share than
            # none)
            trusted = [d for d in live if d not in self._quarantined]
            if trusted:
                live = trusted
            if total < len(live):
                raise ValueError(f"quota total {total} cannot cover "
                                 f"{len(live)} drives")
            cur = {d: self._shares.get(d, 0) for d in live}
            if sum(cur.values()) <= 0:
                base, extra = divmod(total, len(live))
                cur = {d: base + (1 if i < extra else 0)
                       for i, d in enumerate(live)}
            step_times = {d: (cur[d] * self._ewma[d]
                              if math.isfinite(self._ewma[d]) else math.nan)
                          for d in live}
            new = rebalance_shares(step_times, cur, total,
                                   smoothing=self.smoothing)
            self._shares = dict(new)
            return new


def rebalance_shares(step_times: Dict[str, float], current_shares: Dict[str, int],
                     total: int, smoothing: float = 0.5,
                     min_share: int = 1) -> Dict[str, int]:
    """New per-worker microbatch shares ∝ observed throughput.

    throughput_w = share_w / step_time_w; new share ∝ throughput (the paper's
    batch-ratio rule).  ``smoothing`` blends old and new shares to avoid
    oscillation.  Shares sum exactly to ``total``.
    """
    if total < min_share * len(step_times):
        raise ValueError(
            f"cannot split {total} items across {len(step_times)} workers "
            f"with min_share={min_share}")
    # Cold-start guard: a worker that has served nothing yet reports a
    # zero/NaN service time (a cluster replica before its first observe()).
    # 1/t would read that as infinite throughput and hand it everything —
    # keep the current *proportions* (settled to the exact total below, so
    # the sum contract holds) until every worker has a real measurement.
    if any(not math.isfinite(t) or t <= 0.0 for t in step_times.values()):
        z = sum(current_shares[w] for w in step_times)
        if z <= 0:
            blended = {w: total / len(step_times) for w in step_times}
        else:
            blended = {w: total * current_shares[w] / z for w in step_times}
    else:
        tput = {w: current_shares[w] / max(t, 1e-9)
                for w, t in step_times.items()}
        z = sum(tput.values())
        raw = {w: total * tput[w] / z for w in tput}
        blended = {w: smoothing * raw[w] + (1 - smoothing) * current_shares[w]
                   for w in raw}
    # round, then resolve the drift exactly: increments go to the workers the
    # rounding short-changed most; decrements come from the workers rounding
    # (or the min_share floor) over-paid most, never dipping below min_share.
    shares = {w: max(min_share, int(v)) for w, v in blended.items()}
    drift = total - sum(shares.values())
    while drift > 0:
        w = max(shares, key=lambda w: (blended[w] - shares[w], w))
        shares[w] += 1
        drift -= 1
    while drift < 0:
        eligible = [w for w in shares if shares[w] > min_share]
        # guaranteed non-empty: sum > total >= n * min_share
        w = max(eligible, key=lambda w: (shares[w] - blended[w], w))
        shares[w] -= 1
        drift += 1
    assert sum(shares.values()) == total
    return shares
