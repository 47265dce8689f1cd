"""One opt-in telemetry hub for the whole serving stack.

Three faces, one object:

* **request spans** — every request traces ``submit -> route -> admit ->
  prefill_chunk* -> decode_block* -> (retry/hedge/shed/cancel)* ->
  finish``.  Spans are *keyed* (``("req", rid)``, ``("hedge", grid)``)
  so the owner that opened a span is not necessarily the one that
  closes it; double-closes and orphan closes are counted, never raised.
* **metrics registry** — counters, gauges and fixed-bucket histograms
  that the engines publish into each tick, plus the derived fault
  **detection latency** (injection -> SUSPECT -> DEAD, per authority)
  that no per-subsystem stats object could compute alone.
* **exporters** — a jsonl event log, a Chrome-trace / Perfetto JSON
  (one track per drive worker + coordinator + counter tracks), and a
  plain metrics snapshot dict.

Clock-domain rule (mirrors the ``LatencyRecord`` clock caveat):
every event is stamped by its *caller* on the clock that owns the
track — a standalone engine stamps its virtual serving clock, a
cluster's drive engines stamp their per-drive virtual clocks, and the
coordinator (request spans included) stamps the cluster wall.  The hub
never reads a clock itself; one timebase per track is the invariant
the monotonicity tests enforce.

Honesty about cost: the module-level ``NULL_HUB`` is a no-op whose
every method is ``pass`` behind ``enabled = False`` — instrumentation
sites guard on that flag so the disabled path costs one attribute
check (tier-1 gated).  The enabled hub keeps events in a bounded
``deque`` ring so open-loop soak runs cannot OOM; drops are counted in
``events_dropped``.
"""
from __future__ import annotations

import json
import math
import threading
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["NullHub", "NULL_HUB", "TelemetryHub", "DEFAULT_HIST_BUCKETS"]

# seconds-scale latency buckets: 1ms .. 30s, roughly x3 apart
DEFAULT_HIST_BUCKETS = (0.001, 0.003, 0.01, 0.03, 0.1, 0.3, 1.0, 3.0,
                        10.0, 30.0)


class NullHub:
    """Disabled telemetry: every method is a no-op.

    Call sites guard on ``hub.enabled`` before building attribute
    dicts, so with the null hub a traced tick pays one attribute load
    per site and nothing else.
    """

    enabled = False

    def counter(self, name, inc=1):            # pragma: no cover - trivial
        pass

    def gauge(self, name, value):              # pragma: no cover - trivial
        pass

    def observe(self, name, value):            # pragma: no cover - trivial
        pass

    def phase(self, track, name, t0, dur, **attrs):
        pass

    def point(self, track, name, t, **attrs):
        pass

    def counter_sample(self, track, name, t, value):
        pass

    def open_span(self, key, t, track, name, **attrs):
        pass

    def close_span(self, key, t, status, **attrs):
        pass

    def open_request(self, rid, t, **attrs):
        pass

    def request_point(self, rid, name, t, **attrs):
        pass

    def close_request(self, rid, t, status, **attrs):
        pass

    def fault_injected(self, drive, kind, t, tick):
        pass

    def health_transition(self, authority, drive, old, new, t):
        pass

    def publish(self, name, mapping):
        pass


NULL_HUB = NullHub()


class TelemetryHub:
    """Thread-safe, bounded-memory telemetry hub.

    One internal lock guards everything; callers already hold engine or
    cluster locks, and the hub never calls back out, so lock ordering
    stays ``caller lock -> hub lock`` with no cycles.
    """

    enabled = True

    def __init__(self, capacity: int = 65536,
                 hist_buckets: Tuple[float, ...] = DEFAULT_HIST_BUCKETS):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=int(capacity))
        self.capacity = int(capacity)
        self.events_dropped = 0
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._hist_buckets = tuple(hist_buckets)
        self._hists: Dict[str, List[int]] = {}   # name -> len(buckets)+1 bins
        self._hist_sum: Dict[str, float] = {}
        self._open: Dict[Any, dict] = {}         # span key -> attrs at open
        self._published: Dict[str, dict] = {}
        # detection latency: first injection per drive, first transition
        # per (authority, drive, state)
        self._inject: Dict[int, Tuple[str, float, int]] = {}
        self._detect: Dict[Tuple[str, int], Dict[str, float]] = {}

    # -- raw event plumbing -------------------------------------------------

    def _emit(self, ev: dict) -> None:
        # caller holds self._lock
        if len(self._events) == self._events.maxlen:
            self.events_dropped += 1
        self._events.append(ev)

    # -- metrics registry ---------------------------------------------------

    def counter(self, name: str, inc: float = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + inc

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = float(value)

    def observe(self, name: str, value: float) -> None:
        """Record ``value`` into the fixed-bucket histogram ``name``."""
        v = float(value)
        with self._lock:
            bins = self._hists.get(name)
            if bins is None:
                bins = [0] * (len(self._hist_buckets) + 1)
                self._hists[name] = bins
                self._hist_sum[name] = 0.0
            i = 0
            for b in self._hist_buckets:
                if v <= b:
                    break
                i += 1
            bins[i] += 1
            if math.isfinite(v):
                self._hist_sum[name] += v

    def publish(self, name: str, mapping: Dict[str, Any]) -> None:
        """Merge a stats-object snapshot into the metrics export."""
        with self._lock:
            self._published[name] = dict(mapping)

    # -- track events -------------------------------------------------------

    def phase(self, track: str, name: str, t0: float, dur: float,
              **attrs) -> None:
        """A complete span ``[t0, t0+dur]`` on ``track`` (Chrome "X")."""
        with self._lock:
            self._emit({"ev": "phase", "track": track, "name": name,
                        "t": float(t0), "dur": float(dur), "attrs": attrs})

    def point(self, track: str, name: str, t: float, **attrs) -> None:
        """An instant event on ``track`` (Chrome "i")."""
        with self._lock:
            self._emit({"ev": "point", "track": track, "name": name,
                        "t": float(t), "attrs": attrs})

    def counter_sample(self, track: str, name: str, t: float,
                       value: float) -> None:
        """A sampled counter value on ``track`` (Chrome "C")."""
        with self._lock:
            self._emit({"ev": "counter", "track": track, "name": name,
                        "t": float(t), "value": float(value)})

    # -- keyed spans --------------------------------------------------------

    def open_span(self, key: Any, t: float, track: str, name: str,
                  **attrs) -> None:
        with self._lock:
            if key in self._open:
                # double-open: count it, keep the original
                self._counters["telemetry.span_double_open"] = \
                    self._counters.get("telemetry.span_double_open", 0) + 1
                return
            self._open[key] = {"t0": float(t), "track": track,
                               "name": name, "attrs": dict(attrs)}
            self._emit({"ev": "point", "track": track,
                        "name": f"{name}:open", "t": float(t),
                        "attrs": dict(attrs)})

    def close_span(self, key: Any, t: float, status: str, **attrs) -> None:
        """Close a keyed span; unknown/already-closed keys are counted
        (``telemetry.span_double_close``) and dropped, never raised."""
        with self._lock:
            sp = self._open.pop(key, None)
            if sp is None:
                self._counters["telemetry.span_double_close"] = \
                    self._counters.get("telemetry.span_double_close", 0) + 1
                return
            merged = dict(sp["attrs"])
            merged.update(attrs)
            merged["status"] = status
            t0 = sp["t0"]
            self._emit({"ev": "phase", "track": sp["track"],
                        "name": sp["name"], "t": t0,
                        "dur": max(0.0, float(t) - t0), "attrs": merged})
            self._counters[f"spans.{status}"] = \
                self._counters.get(f"spans.{status}", 0) + 1

    def open_span_count(self) -> int:
        with self._lock:
            return len(self._open)

    def span_point(self, key: Any, name: str, t: float, **attrs) -> None:
        """An instant event on the track of the open span ``key``."""
        with self._lock:
            sp = self._open.get(key)
            track = sp["track"] if sp is not None else "orphans"
            self._emit({"ev": "point", "track": track, "name": name,
                        "t": float(t), "attrs": attrs})

    # -- request-span conveniences -----------------------------------------

    def open_request(self, rid: int, t: float, **attrs) -> None:
        self.open_span(("req", rid), t, "requests", f"req{rid}",
                       rid=rid, **attrs)

    def request_point(self, rid: int, name: str, t: float, **attrs) -> None:
        self.span_point(("req", rid), name, t, rid=rid, **attrs)

    def close_request(self, rid: int, t: float, status: str,
                      **attrs) -> None:
        self.close_span(("req", rid), t, status, **attrs)

    # -- fault detection latency -------------------------------------------

    def fault_injected(self, drive: int, kind: str, t: float,
                       tick: int) -> None:
        with self._lock:
            if drive not in self._inject:      # first injection wins
                self._inject[drive] = (kind, float(t), int(tick))
            self._emit({"ev": "point", "track": "coordinator",
                        "name": "fault_injected", "t": float(t),
                        "attrs": {"drive": drive, "kind": kind,
                                  "tick": tick}})

    def health_transition(self, authority: str, drive: int, old: str,
                          new: str, t: float) -> None:
        with self._lock:
            self._emit({"ev": "point", "track": "coordinator",
                        "name": "health_transition", "t": float(t),
                        "attrs": {"authority": authority, "drive": drive,
                                  "old": old, "new": new}})
            inj = self._inject.get(drive)
            if inj is None:
                return
            key = (authority, drive)
            rec = self._detect.setdefault(key, {})
            field = {"suspect": "suspect_s", "dead": "dead_s"}.get(new)
            if field is not None and field not in rec:
                rec[field] = float(t) - inj[1]

    # -- exporters ----------------------------------------------------------

    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    def metrics(self) -> dict:
        with self._lock:
            hists = {}
            for name, bins in self._hists.items():
                n = sum(bins)
                hists[name] = {
                    "buckets": list(self._hist_buckets),
                    "counts": list(bins),
                    "count": n,
                    "sum": self._hist_sum[name],
                    "mean": self._hist_sum[name] / n if n else 0.0,
                }
            detection = {}
            for (auth, drive), rec in sorted(self._detect.items()):
                inj = self._inject.get(drive)
                detection[f"{auth}.drive{drive}"] = {
                    "kind": inj[0] if inj else None,
                    "injected_t": inj[1] if inj else None,
                    **rec,
                }
            return {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "histograms": hists,
                "detection_latency": detection,
                "open_spans": len(self._open),
                "events_dropped": self.events_dropped,
                "published": {k: dict(v) for k, v in
                              self._published.items()},
            }

    def write_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            for ev in self.events():
                f.write(json.dumps(ev) + "\n")

    def to_chrome_trace(self) -> dict:
        """Render the event ring as Chrome-trace / Perfetto JSON.

        One pid per track (coordinator first, then drives/workers in
        name order); timestamps are microseconds on each track's own
        clock — comparing across tracks compares different timebases,
        which the ROADMAP clock-domain note spells out.
        """
        evs = self.events()
        tracks = sorted({e["track"] for e in evs},
                        key=lambda t: (t != "coordinator", t))
        pid_of = {t: i + 1 for i, t in enumerate(tracks)}
        out: List[dict] = []
        for t in tracks:
            out.append({"name": "thread_name", "ph": "M",
                        "pid": pid_of[t], "tid": 0,
                        "args": {"name": t}})
            out.append({"name": "process_name", "ph": "M",
                        "pid": pid_of[t], "tid": 0,
                        "args": {"name": t}})
        for e in evs:
            pid = pid_of[e["track"]]
            ts = e["t"] * 1e6
            if e["ev"] == "phase":
                out.append({"name": e["name"], "ph": "X", "pid": pid,
                            "tid": 0, "ts": ts,
                            "dur": max(e["dur"], 0.0) * 1e6,
                            "args": e.get("attrs", {})})
            elif e["ev"] == "counter":
                out.append({"name": e["name"], "ph": "C", "pid": pid,
                            "tid": 0, "ts": ts,
                            "args": {"value": e["value"]}})
            else:
                out.append({"name": e["name"], "ph": "i", "pid": pid,
                            "tid": 0, "ts": ts, "s": "t",
                            "args": e.get("attrs", {})})
        return {"traceEvents": out, "displayTimeUnit": "ms"}

    def write_chrome_trace(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)

    def write_metrics(self, path: str,
                      extra: Optional[dict] = None) -> None:
        snap = self.metrics()
        if extra:
            snap = {**snap, **extra}
        with open(path, "w") as f:
            json.dump(snap, f, indent=2, sort_keys=True)
