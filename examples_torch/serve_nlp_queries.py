"""The paper's serving scenario end-to-end on the PyTorch port: a
heterogeneous cluster (1 fast host + N slow near-data workers) answers NLP
queries through the pull scheduler, with real compute per batch on the
port's kernels and the paper's energy/transfer accounting, then the same
pipeline with a real LM: the continuous-batching engine, the cluster tier,
uneven drives, SLO serving, faults and telemetry.

Run:  PYTHONPATH=src python examples_torch/serve_nlp_queries.py [--csds 36]
      [--device cpu]

Entry points run on the CUDA device unless ``--device cpu`` is given.
The LM's weights are drawn from seed 0 on the CPU's generator and copied to
the device, so a command gives the same weights on every device.
"""
import argparse
import dataclasses
import math
import pathlib
import time

import numpy as np

from repro_torch.apps import (APPS, recommender_query_batch,
                              sentiment_query_batch)
from repro_torch.config import reduced_config
from repro_torch.core.energy import energy_per_query_mj
from repro_torch.core.faults import FailureDetector, FaultSchedule
from repro_torch.core.scheduler import (PullScheduler, make_cluster,
                                        optimal_batch_ratio)
from repro_torch.core.telemetry import TelemetryHub
from repro_torch.core.transfer import host_only_ledger, workload_split_ledger
from repro_torch.data.workload import (WorkloadConfig, generate_trace,
                                       replay_open_loop)
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.train.cluster_loop import ClusterEngine
from repro_torch.train.serve_loop import AdmissionController, ServeEngine


def compute_section(app_name: str, device) -> None:
    """1. real compute: run one query batch of the app's kernel locally."""
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    if app_name == "recommender":
        ids = recommender_query_batch(rng, n_queries=64, device=device)
        print(f"[compute] top-10 for 64 queries in "
              f"{time.perf_counter()-t0:.2f}s; query0 -> movies "
              f"{ids[0][:5]}...")
    else:
        preds = sentiment_query_batch(rng, n_queries=256, device=device)
        print(f"[compute] 256 sentiment predictions in "
              f"{time.perf_counter()-t0:.2f}s; positive frac "
              f"{preds.mean():.2f}")


def cluster_section(app, n_csds: int):
    """2. cluster scale-out via the pull scheduler (paper Fig. 5).
    Returns the simulated runs with and without the CSDs."""
    ratio = optimal_batch_ratio(app.host_rate, app.csd_rate)
    nodes = make_cluster(app.host_rate, app.csd_rate, n_csds,
                         host_overhead=0.05, csd_overhead=0.02)
    sched = PullScheduler(nodes, app.batch_size, ratio, poll_interval=0.05)
    r = sched.run(app.total_items)
    base = PullScheduler(make_cluster(app.host_rate, app.csd_rate, 0,
                                      host_overhead=0.05, csd_overhead=0.02),
                         app.batch_size, ratio, 0.05).run(app.total_items)
    print(f"[cluster] host-only {base.throughput:.0f} items/s -> "
          f"{n_csds} CSDs {r.throughput:.0f} items/s "
          f"({r.throughput / base.throughput:.2f}x; paper "
          f"{app.paper_with_36 / app.paper_host_only:.2f}x)")
    print(f"[cluster] {r.csd_fraction:.0%} of items processed in storage "
          f"(paper {app.paper_csd_fraction:.0%})")
    return r, base


def accounting_section(app, r, base, n_csds: int) -> None:
    """3. energy + transfer accounting (paper Table I / Fig. 7)."""
    e0 = energy_per_query_mj(base.throughput, 0)
    e1 = energy_per_query_mj(r.throughput, n_csds)
    led = workload_split_ledger(app.dataset_bytes, r.csd_fraction,
                                app.output_bytes)
    ref = host_only_ledger(app.dataset_bytes, app.output_bytes)
    print(f"[energy] {e0:.0f} mJ/query -> {e1:.0f} mJ/query "
          f"({1 - e1 / e0:.0%} saving; paper {app.paper_energy_host_mj:.0f} "
          f"-> {app.paper_energy_csd_mj:.0f})")
    print(f"[transfer] link traffic cut {led.reduction_vs(ref):.0%} "
          f"({led.link_bytes / 1e9:.2f} GB vs {ref.link_bytes / 1e9:.2f} GB)")


def engine_section(cfg, model, page_size: int, device):
    """4. the same pipeline with a real LM: mixed-length queries through the
    continuous-batching engine — scheduler-driven admission, host/ISP plan
    routing, live link-byte ledger (the fig5 bench's engine run).

    KV lives in a *paged* pool (the in-storage layout lesson applied to
    serving): prefill allocates ceil(prompt/page_size) pages, each decode
    step appends at most one page, EOS frees the slot's pages the same step
    — so peak KV memory tracks live tokens, not num_slots * max_len.
    ``page_size`` trades footprint granularity (smaller pages hug live
    tokens tighter) against per-page walk overhead (larger pages mean
    fewer, bigger kernel blocks).  8 requests of 4..16 tokens, 8 new
    tokens each, on 4 slots.  Returns (results, stats, kv_stats)."""
    rng = np.random.default_rng(0)
    engine = ServeEngine(
        cfg, model, max_len=64, num_slots=4, kv_layout="paged",
        page_size=page_size, k_block=8, prewarm=True,
        admission=AdmissionController(4, host_rate=4.0, csd_rate=1.0),
        device=device)
    prompts = [rng.integers(0, cfg.vocab_size, rng.integers(4, 17)).tolist()
               for _ in range(8)]
    results = engine.generate(prompts, max_new=8)
    stats, kv = engine.stats, engine.kv_stats()
    for line in stats.summary().splitlines():
        print(f"[engine] {line}")
    print(f"[engine] paged KV: peak {kv['peak_kv_bytes'] / 1e6:.3f} MB "
          f"of a {kv['dense_kv_bytes'] / 1e6:.3f} MB dense worst case "
          f"(page_size={kv['page_size']})")
    return results, stats, kv


def cluster_engine_section(cfg, model, n_drives: int, device):
    """5. the cluster tier: the same LM served by multiple replica drives
    behind ONE queue (the paper's 36-CSD storage server, scaled down).
    Requests carry shard ids; data_local routing pins each to the drive
    holding its shard, and the merged ClusterStats put the live
    energy-per-query (Table I's wall-power / throughput) next to the
    link/KV reductions — per drive AND aggregate.  Returns (cluster,
    prompts, results)."""
    clu = ClusterEngine(cfg, model, n_drives=n_drives, routing="data_local",
                        max_len=64, num_slots=2, device=device)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size,
                            rng.integers(4, 17)).tolist()
               for _ in range(4 * n_drives)]
    shard_ids = rng.integers(0, n_drives, len(prompts)).tolist()
    results = clu.generate(prompts, max_new=6, shard_ids=shard_ids)
    for line in clu.summary().splitlines():
        print(f"[cluster-engine] {line}")
    return clu, prompts, results


def hetero_section(cfg, model, clu, prompts, n_drives: int, device):
    """6. heterogeneous drives: model the last drive 2x slower
    (speed_factor) and let the cluster pull scheduler learn the skew —
    rate_aware routing then sheds load onto the fast drives (the paper's
    §IV-A batch-ratio rule, live)."""
    speeds = [1.0] * (n_drives - 1) + [0.5]
    het = ClusterEngine(cfg, model, n_drives=n_drives, routing="rate_aware",
                        max_len=64, num_slots=2, speed_factor=speeds,
                        jit_donor=clu.drives[0].engine, device=device)
    het.generate(prompts, max_new=6)
    for line in het.summary().splitlines():
        print(f"[hetero-engine] {line}")
    return het


def slo_section(cfg, model, clu, device):
    """7. open-loop SLO serving: the storage server's real traffic is
    bursty arrivals with per-class TTFT deadlines, not a drained batch.
    Generate a reproducible bursty trace, replay it on the engine's serving
    clock with EDF admission + shedding of already-expired requests, and
    read the tail: p99 TTFT, goodput-under-SLO (deadline-met completions
    per second) and what the shed work cost.  Returns (engine, report)."""
    slo = ServeEngine(cfg, model, max_len=64, num_slots=2, chunk_prefill=8,
                      admission_order="edf", jit_donor=clu.drives[0].engine,
                      device=device)
    wl = WorkloadConfig(n_requests=24, vocab_size=cfg.vocab_size,
                        arrival="bursty", rate=40.0, seed=0)
    report = replay_open_loop(slo, generate_trace(wl))
    lat = slo.stats.latency
    print(f"[slo] bursty open loop: {report.submitted} submitted, "
          f"{report.completed} ok / {report.shed} shed in "
          f"{report.wall_s:.2f}s serving clock")
    print(f"[slo] {lat.summary()}")
    print(f"[slo] goodput under SLO: "
          f"{lat.goodput_qps(report.wall_s):.1f} qps "
          f"(attainment {lat.slo_attainment:.0%}; "
          f"{slo.stats.shed_wasted_s * 1e3:.1f} ms serving time shed)")
    return slo, report


def faults_section(cfg, model, clu, prompts, device):
    """8. fault injection + recovery: at a 36-drive storage server, drive
    stalls and failures are the steady state.  Inject an explicit schedule
    — a hidden crash of drive 1, then a transient stall on drive 0 — and
    watch the cluster-visible side: the detector suspects the silent
    drives, quarantines them from quotas, declares the crashed one DEAD,
    auto-fail()s it, and the retry budget replays its in-flight work on the
    survivor.  Greedy decode makes every recovered request token-identical
    to a fault-free run.  (Ticks are engine steps; with the default fused
    k_block a short drain is only a handful of ticks, so the schedule lands
    early.)  Returns (cluster, results)."""
    faults = FaultSchedule.from_spec([
        {"drive_id": 1, "kind": "crash", "at_tick": 1},
        {"drive_id": 0, "kind": "stall", "at_tick": 2, "duration": 2},
    ])
    det = FailureDetector(2, suspect_ticks=2, dead_ticks=4,
                          suspect_after_s=math.inf)
    chaos = ClusterEngine(cfg, model, n_drives=2, routing="round_robin",
                          max_len=64, num_slots=2, faults=faults,
                          detector=det, max_retries=3,
                          jit_donor=clu.drives[0].engine, device=device)
    for p in prompts[:6]:
        chaos.submit(p, max_new=6)
    results = chaos.run_until_complete()
    ok = sum(1 for r in results if r.status == "ok")
    failed = sum(1 for r in results if r.status == "failed")
    st = chaos.stats
    print(f"[faults] injected {st.faults_injected} faults; health now "
          f"{st.health} ({st.auto_failed_drives} auto-failed)")
    print(f"[faults] {ok} ok / {failed} failed of {len(results)}; "
          f"{st.retries} retries spent recovering in-flight work")
    for line in st.summary().splitlines():
        print(f"[faults] {line}")
    return chaos, results


def telemetry_section(cfg, model, clu, prompts, device):
    """9. observability: re-run the chaos scenario with the telemetry hub
    attached and read the story back out of the trace — request spans
    (submit -> route -> admit -> decode -> retry -> finish), the crash's
    detection latency per health authority, and a Chrome-trace timeline
    loadable in Perfetto (chrome://tracing).  Tracing is opt-in and
    changes no token; each track rides its own clock (per-drive virtual
    clocks vs the cluster wall — compare within a track, not across).
    Writes the trace to ``serve_trace.json`` in the working directory and
    returns the hub."""
    hub = TelemetryHub()
    traced = ClusterEngine(cfg, model, n_drives=2, routing="round_robin",
                           max_len=64, num_slots=2,
                           faults=FaultSchedule.from_spec([
                               {"drive_id": 1, "kind": "crash",
                                "at_tick": 1}]),
                           detector=FailureDetector(
                               2, suspect_ticks=2, dead_ticks=4,
                               suspect_after_s=math.inf),
                           max_retries=3, telemetry=hub,
                           jit_donor=clu.drives[0].engine, device=device)
    for p in prompts[:6]:
        traced.submit(p, max_new=6)
    traced.run_until_complete()
    m = hub.metrics()
    spans = {k: v for k, v in m["counters"].items()
             if k.startswith("spans.")}
    print(f"[telemetry] {len(hub.events())} events, span outcomes "
          f"{spans}, open spans {m['open_spans']}")
    for key, lat in m["detection_latency"].items():
        print(f"[telemetry] detection {key}: kind={lat['kind']} "
              f"suspect after {lat.get('suspect_s', math.nan):.3f}s, "
              f"dead after {lat.get('dead_s', math.nan):.3f}s")
    trace_path = pathlib.Path("serve_trace.json")
    hub.write_chrome_trace(str(trace_path))
    print(f"[telemetry] wrote {trace_path} — load it in Perfetto/"
          f"chrome://tracing, or: "
          f"python scripts/trace_report.py {trace_path}")
    return hub


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--csds", type=int, default=36)
    ap.add_argument("--app", default="recommender", choices=sorted(APPS))
    ap.add_argument("--no-engine", action="store_true",
                    help="skip the LM continuous-batching engine demo")
    ap.add_argument("--page-size", type=int, default=16,
                    help="KV page size (tokens) for the paged serve engine")
    ap.add_argument("--cluster-drives", type=int, default=2,
                    help="replica drives in the LM cluster-engine demo")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    app = APPS[args.app]

    # --app speech_to_text runs the sentiment batch, as the reference does
    compute_section(args.app, dev)
    r, base = cluster_section(app, args.csds)
    accounting_section(app, r, base, args.csds)
    if args.no_engine:
        return 0

    cfg = dataclasses.replace(reduced_config("yi-9b"), dtype="float32")
    model = M.seeded_params(cfg, 0, dev)
    engine_section(cfg, model, args.page_size, dev)
    n_drives = min(max(args.cluster_drives, 1), 4)
    clu, prompts, _ = cluster_engine_section(cfg, model, n_drives, dev)
    if n_drives > 1:
        hetero_section(cfg, model, clu, prompts, n_drives, dev)
    slo_section(cfg, model, clu, dev)
    faults_section(cfg, model, clu, prompts, dev)
    telemetry_section(cfg, model, clu, prompts, dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
