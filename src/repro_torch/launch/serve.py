"""Serving CLI of the port: init a model from a seed and serve requests
through the continuous-batching engine, or through a multi-drive cluster
of them (port of ``repro/launch/serve.py``).

  python -m repro_torch.launch.serve --arch ARCH [--smoke | --layers N] \
      [--trace FILE | --requests N | --batch N] --prompt-len P \
      --min-prompt P --max-new M --max-len L --num-slots S \
      --kv-layout {paged,strip} --page-size P --k-block K --seed X \
      [--chunk-prefill C --chunk-budget B] [--prewarm] \
      [--replicas N --routing R --shards K --speed-factor 1.0,0.5] \
      [--arrival {poisson,bursty,diurnal} --rate R --slo-ms T \
       --sched {fifo,edf}] \
      [--mttf S --mttr S --fault-seed N | --fault-trace FILE] \
      [--max-retries N] [--hedge] \
      [--concurrent --dispatch-timeout S] [--min-tick-ms T] \
      [--trace-out F] [--metrics-out F] [--events-out F] [--device cpu]

ARCH is one of the port's configs: yi-9b, gemma3-12b, starcoder2-15b,
llama3-405b, llama4-scout-17b-a16e, musicgen-large, chameleon-34b (the
frontend archs serve token prompts here), deepseek-v2-236b, hymba-1.5b,
xlstm-125m (the last three have no paged layer and serve on strips;
hymba's and xlstm's recurrent stacks take exact-length prefill buckets).
``--layers N`` cuts the depth to N layers at full width: llama4-scout's
48 layers (215.6 GB in bf16), llama3-405b's and deepseek-v2's 60 (478.8
GB) do not fit one 80 GB card.

Request sources, the first that is given wins (the reference CLI's, with
its defaults, so that one command line serves the same requests on both):
  --arrival M    open loop: a reproducible arrival trace (poisson, bursty
                 or diurnal at --rate req/s; mixed priority classes with
                 TTFT deadlines, --slo-ms overrides every class budget) of
                 --requests requests (32 when --requests is 0, its
                 default), replayed on the engine's serving clock, with
                 --sched edf for deadline-first admission and shedding;
  --trace FILE   one request per line: whitespace-separated token ids,
                 optionally followed by ``| max_new`` to override
                 --max-new; blank lines and lines starting with ``#`` are
                 skipped, and a file with no request exits 1;
  --requests N   N prompts of random lengths in [--min-prompt,
                 --prompt-len];
  (neither)      --batch prompts (default 4) of exactly --prompt-len
                 (default 32) tokens.
Every random draw comes from ``np.random.default_rng(--seed)`` in the
reference's order.  A prompt of --max-len tokens or more is refused by
the engine (ValueError), as in the reference.  For example, on the CPU:

  printf '# two prompts\n1 2 3 4\n\n5 6 7 | 4\n' > prompts.txt
  python -m repro_torch.launch.serve --arch yi-9b --smoke \
      --trace prompts.txt --device cpu

``--replicas N`` (N > 1), fault injection (``--mttf`` / ``--fault-trace``)
and ``--concurrent`` serve through ``ClusterEngine``: N replica drives
sharing the one model behind one queue, routed per ``--routing``; the
failure detector (or, with ``--concurrent``, the heartbeat watchdog of
the worker threads) fails drives it declares DEAD and restarted requests
spend their ``--max-retries`` budget.  The cluster prints per-drive and
aggregate stats and the Table I energy per query of the paper's server
model.  ``--trace-out`` / ``--metrics-out`` / ``--events-out`` turn the
telemetry hub on and write its Perfetto trace, metrics and raw events.

Runs on the CUDA device unless ``--device cpu`` is given (the plain
PyTorch path).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.config import get_config, reduced_config
from repro_torch.core.cluster import ROUTING_POLICIES
from repro_torch.core.faults import FaultSchedule
from repro_torch.core.telemetry import TelemetryHub
from repro_torch.data.workload import (ARRIVAL_MODES, DEFAULT_CLASSES,
                                       PriorityClass, WorkloadConfig,
                                       generate_trace, replay_open_loop)
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.train.cluster_loop import ClusterEngine
from repro_torch.train.serve_loop import AdmissionController, ServeEngine


def _load_trace(path: str, default_max_new: int):
    """The requests of a trace file: ``(prompt, max_new)`` a line of
    whitespace-separated token ids with an optional ``| max_new`` tail;
    blank lines and ``#`` lines are skipped."""
    reqs = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            ids, _, tail = line.partition("|")
            prompt = [int(t) for t in ids.split()]
            max_new = int(tail) if tail.strip() else default_max_new
            reqs.append((prompt, max_new))
    return reqs


def _args():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to N layers at full width (0 = "
                         "the config's depth)")
    ap.add_argument("--batch", type=int, default=4,
                    help="prompts of exactly --prompt-len tokens when "
                         "neither --trace nor --requests is given")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--min-prompt", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--num-slots", type=int, default=8)
    ap.add_argument("--requests", type=int, default=0,
                    help="serve N random variable-length requests (with "
                         "--arrival: N open-loop requests, 0 = 32)")
    ap.add_argument("--trace", type=str, default=None,
                    help="file of token-id prompts, one request per line")
    ap.add_argument("--kv-layout", choices=("paged", "strip"),
                    default="paged",
                    help="full-attention KV in paged pools or dense strips")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--num-pages", type=int, default=0,
                    help="KV pool size in pages (0 = dense worst case)")
    ap.add_argument("--k-block", type=int, default=8,
                    help="decode steps fused per tick (1 = per-step loop)")
    ap.add_argument("--chunk-prefill", type=int, default=0,
                    help="split prompts longer than this into per-tick "
                         "prefill chunks (0 = one-shot prefill)")
    ap.add_argument("--chunk-budget", type=int, default=1,
                    help="prefill chunks one tick may run (with "
                         "--chunk-prefill); 1 protects decode TTFT")
    ap.add_argument("--prewarm", action="store_true",
                    help="build the kernels and pay each site's first "
                         "launch before serving")
    ap.add_argument("--host-rate", type=float, default=20.0)
    ap.add_argument("--csd-rate", type=float, default=1.0)
    ap.add_argument("--csds", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--replicas", type=int, default=1,
                    help="replica drives; >1 serves through the cluster")
    ap.add_argument("--routing", choices=ROUTING_POLICIES,
                    default="least_loaded",
                    help="cluster dispatch policy")
    ap.add_argument("--shards", type=int, default=0,
                    help="tag request i with shard i %% K for data_local "
                         "routing (0 = unsharded requests)")
    ap.add_argument("--speed-factor", type=str, default=None,
                    help="comma-separated per-drive speed factors")
    ap.add_argument("--no-shard-replacement", action="store_true",
                    help="keep static shard placement on drain/fail")
    ap.add_argument("--arrival", choices=ARRIVAL_MODES, default=None,
                    help="open-loop SLO mode: generate and replay an "
                         "arrival trace at --rate req/s")
    ap.add_argument("--rate", type=float, default=4.0,
                    help="mean arrival rate (req/s) for --arrival")
    ap.add_argument("--slo-ms", type=float, default=0.0,
                    help="override every class's TTFT SLO budget (ms); "
                         "0 keeps the per-class defaults")
    ap.add_argument("--sched", choices=("fifo", "edf"), default="fifo",
                    help="admission order (edf = earliest deadline first "
                         "+ shedding of expired requests)")
    ap.add_argument("--mttf", type=float, default=0.0,
                    help="mean seconds between injected faults per drive "
                         "(0 = no fault injection)")
    ap.add_argument("--mttr", type=float, default=0.5,
                    help="mean repair window (s) of injected transient "
                         "faults")
    ap.add_argument("--fault-seed", type=int, default=None,
                    help="seed for the drawn fault schedule "
                         "(default: --seed)")
    ap.add_argument("--fault-trace", type=str, default=None,
                    help="fault event file (FaultSchedule.save jsonl or a "
                         "JSON event list); overrides --mttf")
    ap.add_argument("--max-retries", type=int, default=3,
                    help="restarts a request may spend on drive failures")
    ap.add_argument("--hedge", action="store_true",
                    help="duplicate SUSPECT-stranded requests onto healthy "
                         "drives")
    ap.add_argument("--concurrent", action="store_true",
                    help="run drives on worker threads, one a drive")
    ap.add_argument("--dispatch-timeout", type=float, default=0.25,
                    help="seconds the concurrent coordinator waits for "
                         "heartbeats per join")
    ap.add_argument("--min-tick-ms", type=float, default=0.0,
                    help="per-drive service-time floor (ms)")
    ap.add_argument("--trace-out", type=str, default=None,
                    help="write a Chrome-trace/Perfetto JSON timeline")
    ap.add_argument("--metrics-out", type=str, default=None,
                    help="write the telemetry metrics registry as JSON")
    ap.add_argument("--events-out", type=str, default=None,
                    help="write the raw telemetry event ring as jsonl")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    return ap.parse_args()


def _faults(args):
    if args.fault_trace:
        return FaultSchedule.load(args.fault_trace)
    if args.mttf > 0:
        seed = args.seed if args.fault_seed is None else args.fault_seed
        return FaultSchedule.from_rates(args.replicas, mttf_s=args.mttf,
                                        mttr_s=args.mttr, seed=seed)
    return None


def main() -> int:
    args = _args()
    device = resolve_device(args.device)
    cfg = reduced_config(args.arch) if args.smoke else get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = M.init_params(cfg, gen, device)
    engine_kw = dict(max_len=args.max_len, num_slots=args.num_slots,
                     kv_layout=args.kv_layout, page_size=args.page_size,
                     num_pages=args.num_pages or None, k_block=args.k_block,
                     chunk_prefill=args.chunk_prefill or None,
                     chunk_budget=args.chunk_budget, prewarm=args.prewarm,
                     admission_order=args.sched, device=device)

    def admission():
        return AdmissionController(args.num_slots, host_rate=args.host_rate,
                                   csd_rate=args.csd_rate, n_csds=args.csds)

    hub = TelemetryHub() if (args.trace_out or args.metrics_out
                             or args.events_out) else None
    faults = _faults(args)
    is_cluster = args.replicas > 1 or faults is not None or args.concurrent
    if is_cluster:
        speed = None
        if args.speed_factor:
            speed = [float(s) for s in args.speed_factor.split(",")]
        engine = ClusterEngine(
            cfg, params, n_drives=args.replicas, routing=args.routing,
            admission_factory=admission, speed_factor=speed,
            shard_replacement=not args.no_shard_replacement, faults=faults,
            max_retries=args.max_retries, hedge=args.hedge,
            concurrent=args.concurrent,
            dispatch_timeout_s=args.dispatch_timeout,
            min_tick_s=args.min_tick_ms / 1e3, telemetry=hub, **engine_kw)
    else:
        engine = ServeEngine(cfg, params, admission=admission(),
                             telemetry=hub, **engine_kw)
    try:
        wall_s = _serve(args, cfg, engine, is_cluster, device)
    finally:
        if is_cluster:
            engine.close()          # joins worker threads (no-op serial)
    if wall_s is None:
        return 1
    if hub is not None:
        hub.publish("cluster" if is_cluster else "engine",
                    engine.stats.metrics())
        hub.publish("latency", engine.stats.latency.metrics(wall_s=wall_s))
        for path, write in ((args.trace_out, hub.write_chrome_trace),
                            (args.metrics_out, hub.write_metrics),
                            (args.events_out, hub.write_jsonl)):
            if path:
                write(path)
                print(f"[serve] telemetry written to {path}")
    return 0


def _serve(args, cfg, engine, is_cluster: bool, device) -> float | None:
    """Serve the requests and print the summary; returns the wall
    seconds the summary's latency metrics are taken over, or None when
    there is no request to serve."""
    summary = engine.summary if is_cluster else engine.stats.summary
    if args.arrival:
        classes = DEFAULT_CLASSES
        if args.slo_ms > 0:
            classes = tuple(PriorityClass(
                c.name, priority=c.priority, weight=c.weight,
                slo_s=args.slo_ms / 1e3, prompt_range=c.prompt_range,
                max_new_range=c.max_new_range) for c in DEFAULT_CLASSES)
        wl = WorkloadConfig(n_requests=args.requests or 32,
                            vocab_size=cfg.vocab_size, arrival=args.arrival,
                            rate=args.rate, classes=classes, seed=args.seed)
        t0 = time.perf_counter()
        report = replay_open_loop(engine, generate_trace(wl))
        dt = time.perf_counter() - t0
        lat = engine.stats.latency
        lm = lat.metrics(wall_s=report.wall_s)
        n_tok = sum(len(r.tokens) for r in report.results)
        print(f"[serve] {args.arch} on {device}: open-loop "
              f"{args.arrival}@{args.rate}/s ({args.sched}): "
              f"{report.submitted} requests, {n_tok} tokens in {dt:.2f}s "
              f"wall / {report.wall_s:.2f}s serving clock")
        print(f"[serve] {lat.summary()}")
        print(f"[serve] goodput under SLO: {lm['goodput_qps']:.2f} qps "
              f"(attainment {lm['slo_attainment']:.0%}, "
              f"{report.shed} shed)")
        for line in summary().splitlines():
            print(f"[serve] {line}")
        return report.wall_s

    rng = np.random.default_rng(args.seed)
    if args.trace:
        requests = _load_trace(args.trace, args.max_new)
    elif args.requests:
        requests = [
            (rng.integers(0, cfg.vocab_size,
                          rng.integers(args.min_prompt,
                                       args.prompt_len + 1)).tolist(),
             args.max_new)
            for _ in range(args.requests)]
    else:
        requests = [(rng.integers(0, cfg.vocab_size,
                                  args.prompt_len).tolist(), args.max_new)
                    for _ in range(args.batch)]
    if not requests:
        print("[serve] no requests (empty --trace file?)")
        return None

    t0 = time.perf_counter()
    for i, (prompt, max_new) in enumerate(requests):
        if is_cluster:
            engine.submit(prompt, max_new=max_new,
                          shard_id=i % args.shards if args.shards else None)
        else:
            engine.submit(prompt, max_new=max_new)
    results = engine.run_until_complete()
    dt = time.perf_counter() - t0
    n_tok = engine.stats.metrics()["tokens"]
    print(f"[serve] {args.arch} on {device}: {len(results)} requests, "
          f"{n_tok} tokens in {dt:.2f}s ({n_tok / max(dt, 1e-9):.1f} tok/s); "
          f"first: {results[0].tokens[:8]}")
    for line in summary().splitlines():
        print(f"[serve] {line}")
    kvs = engine.kv_stats()                 # cluster: one entry per drive
    for kv in kvs if isinstance(kvs, list) else [kvs]:
        print(f"[serve] KV[{kv['layout']}]: peak "
              f"{kv['peak_kv_bytes'] / 1e6:.3f} MB vs dense "
              f"{kv['dense_kv_bytes'] / 1e6:.3f} MB "
              f"(page_size={kv['page_size']})")
    return dt


if __name__ == "__main__":
    raise SystemExit(main())
