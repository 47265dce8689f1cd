"""Open-loop workload generation for the serving benches.

The benches historically pushed 4–32 *closed-loop* requests (submit all,
drain); the paper's scenario is a storage server fielding bursty open-loop
traffic from millions of users.  This module generates that traffic as a
reproducible trace — arrival times on the serving clock, mixed
prompt/output lengths, per-request priority class and TTFT deadline — and
replays it against a serve engine:

  arrival processes
    poisson   homogeneous Poisson: exponential inter-arrival times at
              ``rate`` requests/s — memoryless background load;
    bursty    on/off modulated Poisson (an MMPP): ``duty`` of each
              ``period_s`` cycle runs at ``rate * burst_factor`` (the
              burst), the rest at a trickle — queues build during bursts,
              which is where FIFO vs EDF admission becomes visible;
    diurnal   non-homogeneous Poisson with a sinusoidal rate ramp of one
              ``period_s`` cycle (thinning) — the millions-of-users
              day/night curve compressed onto the bench clock.

  request mix
    every request draws a ``PriorityClass`` by weight; the class fixes its
    priority, TTFT SLO budget (``slo_s`` after arrival; None = best
    effort) and its prompt / max_new length ranges — e.g. interactive
    traffic is short prompts with tight deadlines, batch traffic long
    prompts with loose ones.

``replay_open_loop`` drives any engine exposing the serving-clock API
(``clock`` / ``advance_clock`` / ``submit`` / ``step`` — both
``ServeEngine`` and ``ClusterEngine``): requests are submitted when the
clock reaches their arrival time, the clock fast-forwards across idle
gaps, and the engine's own per-request ``LatencyRecord``s pick up the
queue-wait/TTFT story from there.

A copy of ``repro/data/workload.py``, which has no JAX in it.
"""
from __future__ import annotations

import json
import math
from dataclasses import asdict, dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

ARRIVAL_MODES = ("poisson", "bursty", "diurnal")


@dataclass(frozen=True)
class PriorityClass:
    """One traffic class: scheduling priority (lower = more urgent), TTFT
    budget after arrival (None = best-effort), and its length mix."""
    name: str
    priority: int = 0
    weight: float = 1.0
    slo_s: Optional[float] = None
    prompt_range: Tuple[int, int] = (4, 16)
    max_new_range: Tuple[int, int] = (4, 16)


# a serviceable default mix: mostly tight-deadline interactive traffic with
# a long-prompt batch tail (weights ≈ the interactive-heavy mixes real
# serving fleets report)
DEFAULT_CLASSES = (
    PriorityClass("interactive", priority=0, weight=0.7, slo_s=1.0,
                  prompt_range=(4, 12), max_new_range=(4, 12)),
    PriorityClass("batch", priority=1, weight=0.3, slo_s=8.0,
                  prompt_range=(16, 40), max_new_range=(8, 24)),
)


@dataclass
class TraceRequest:
    """One generated request: arrival on the serving clock + its payload.
    ``deadline_s`` is ABSOLUTE (arrival + class SLO budget); None = no SLO."""
    arrival_s: float
    prompt: List[int]
    max_new: int
    priority: int = 0
    deadline_s: Optional[float] = None
    cls: str = ""


@dataclass(frozen=True)
class WorkloadConfig:
    n_requests: int
    vocab_size: int
    arrival: str = "poisson"       # poisson | bursty | diurnal
    rate: float = 4.0              # mean requests/s on the serving clock
    burst_factor: float = 4.0      # bursty: on-phase rate multiplier
    duty: float = 0.25             # bursty: fraction of the period that is on
    period_s: float = 4.0          # bursty/diurnal: cycle length
    classes: Sequence[PriorityClass] = DEFAULT_CLASSES
    seed: int = 0

    def __post_init__(self):
        if self.arrival not in ARRIVAL_MODES:
            raise ValueError(f"arrival must be one of {ARRIVAL_MODES}, "
                             f"got {self.arrival!r}")
        if self.n_requests < 1:
            raise ValueError("n_requests must be positive")
        if not (self.rate > 0.0 and math.isfinite(self.rate)):
            raise ValueError(f"rate must be finite and positive, "
                             f"got {self.rate}")
        if not 0.0 < self.duty <= 1.0:
            raise ValueError(f"duty must be in (0, 1], got {self.duty}")
        if not self.classes:
            raise ValueError("need at least one priority class")


def _arrival_times(cfg: WorkloadConfig, rng) -> List[float]:
    """Monotone arrival times for ``cfg.n_requests`` requests."""
    if cfg.arrival == "poisson":
        gaps = rng.exponential(1.0 / cfg.rate, cfg.n_requests)
        return np.cumsum(gaps).tolist()
    if cfg.arrival == "bursty":
        # on/off modulated Poisson with mean rate == cfg.rate: the on phase
        # runs at rate * burst_factor for duty * period; the off phase
        # carries whatever rate keeps the cycle mean at cfg.rate (floored
        # at a trickle so the off phase is quiet, not silent)
        on_rate = cfg.rate * cfg.burst_factor
        off_rate = max((cfg.rate - on_rate * cfg.duty) / (1.0 - cfg.duty),
                       0.05 * cfg.rate) if cfg.duty < 1.0 else on_rate
        out: List[float] = []
        t = 0.0
        while len(out) < cfg.n_requests:
            phase_on = (t % cfg.period_s) < cfg.duty * cfg.period_s
            r = on_rate if phase_on else off_rate
            # step to the next event OR the next phase boundary, whichever
            # comes first (the rate changes there)
            gap = rng.exponential(1.0 / r)
            boundary = cfg.duty * cfg.period_s if phase_on else cfg.period_s
            into = t % cfg.period_s
            to_boundary = boundary - into
            if gap < to_boundary:
                t += gap
                out.append(t)
            else:
                t += to_boundary + 1e-9
        return out
    # diurnal: non-homogeneous Poisson via thinning against the peak rate
    peak = 2.0 * cfg.rate
    out = []
    t = 0.0
    while len(out) < cfg.n_requests:
        t += rng.exponential(1.0 / peak)
        lam = cfg.rate * (1.0 + math.sin(2.0 * math.pi * t / cfg.period_s))
        if rng.random() * peak < lam:
            out.append(t)
    return out


def generate_trace(cfg: WorkloadConfig) -> List[TraceRequest]:
    """Generate the open-loop request trace (deterministic per seed)."""
    rng = np.random.default_rng(cfg.seed)
    arrivals = _arrival_times(cfg, rng)
    weights = np.asarray([c.weight for c in cfg.classes], float)
    weights = weights / weights.sum()
    picks = rng.choice(len(cfg.classes), size=cfg.n_requests, p=weights)
    trace: List[TraceRequest] = []
    for t, ci in zip(arrivals, picks):
        c = cfg.classes[int(ci)]
        plen = int(rng.integers(c.prompt_range[0], c.prompt_range[1] + 1))
        max_new = int(rng.integers(c.max_new_range[0],
                                   c.max_new_range[1] + 1))
        prompt = rng.integers(0, cfg.vocab_size, plen).tolist()
        deadline = None if c.slo_s is None else float(t) + c.slo_s
        trace.append(TraceRequest(arrival_s=float(t), prompt=prompt,
                                  max_new=max_new, priority=c.priority,
                                  deadline_s=deadline, cls=c.name))
    return trace


def scale_trace(trace: List[TraceRequest], time_scale: float
                ) -> List[TraceRequest]:
    """Stretch/compress a trace's time axis (arrivals AND deadlines) by
    ``time_scale`` — how the benches calibrate a generated trace to the
    measured service rate of the box they run on."""
    if not (time_scale > 0.0 and math.isfinite(time_scale)):
        raise ValueError(f"time_scale must be finite and positive, "
                         f"got {time_scale}")
    out = []
    for r in trace:
        out.append(TraceRequest(
            arrival_s=r.arrival_s * time_scale, prompt=list(r.prompt),
            max_new=r.max_new, priority=r.priority,
            deadline_s=None if r.deadline_s is None
            else r.deadline_s * time_scale, cls=r.cls))
    return out


def save_trace(path: str, trace: List[TraceRequest]) -> None:
    """One JSON object per line — diffable, streamable, replayable."""
    with open(path, "w") as f:
        for r in trace:
            f.write(json.dumps(asdict(r)) + "\n")


def load_trace(path: str) -> List[TraceRequest]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            out.append(TraceRequest(**json.loads(line)))
    return out


@dataclass
class ReplayReport:
    """What one open-loop replay produced: the engine's results plus the
    trace-level accounting the SLO bench gates on."""
    results: list = field(default_factory=list)
    submitted: int = 0
    wall_s: float = 0.0            # serving clock at drain (idle included)

    @property
    def completed(self) -> int:
        return sum(1 for r in self.results if r.status == "ok")

    @property
    def shed(self) -> int:
        return sum(1 for r in self.results if r.status == "shed")

    @property
    def failed(self) -> int:
        """Terminal ``status="failed"`` finishes (retry budget exhausted or
        the last drive died) — the third leg of the conservation invariant
        ``submitted == completed + shed + failed``."""
        return sum(1 for r in self.results if r.status == "failed")


def replay_open_loop(engine, trace: List[TraceRequest],
                     use_deadlines: bool = True,
                     submit_kw=None) -> ReplayReport:
    """Replay an open-loop trace against a serve engine on ITS clock.

    Requests are submitted when the engine clock reaches their arrival
    time; when the engine is idle ahead of the next arrival, the clock
    fast-forwards to it (open-loop idle is real wall time, not work).
    ``use_deadlines=False`` strips priorities/deadlines — the FIFO
    baseline replay, which must see exactly the same arrival process.
    """
    order = sorted(range(len(trace)), key=lambda i: trace[i].arrival_s)
    report = ReplayReport()
    kw = dict(submit_kw or {})
    i = 0
    while True:
        while i < len(order) and trace[order[i]].arrival_s <= engine.clock:
            r = trace[order[i]]
            if use_deadlines:
                engine.submit(r.prompt, max_new=r.max_new,
                              priority=r.priority, deadline_s=r.deadline_s,
                              **kw)
            else:
                engine.submit(r.prompt, max_new=r.max_new, **kw)
            report.submitted += 1
            i += 1
        # in_flight (cluster: active slots + drive-local queues) falls back
        # to num_active for the single engine, whose queue IS `pending`
        busy = engine.pending > 0 or \
            getattr(engine, "in_flight", engine.num_active) > 0
        if not busy and i >= len(order):
            break
        if not busy:
            # idle gap: jump the serving clock to the next arrival
            engine.advance_clock(trace[order[i]].arrival_s)
            continue
        report.results.extend(engine.step())
    report.results.sort(key=lambda r: r.rid)
    report.wall_s = engine.clock
    return report
