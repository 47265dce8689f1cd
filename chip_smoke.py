"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit and no result line):
  1. device   — the card's name and power limit, torch/CUDA versions, and
                the parallel nvcc build of every kernel in
                src/repro_torch/kernels/csrc;
  2. kernels  — each CUDA kernel against its plain PyTorch version at the
                serve path's shapes, in bfloat16 and float32, then timed
                with CUDA events (median of 25 runs, L2 flushed between
                runs) beside its plain version, its bound and, where one
                PyTorch call computes the same function, that call;
  3. serve    — full-width, full-depth yi-9b in bfloat16 with seeded random
                weights: 16 requests with prompt lengths in 16..700 and
                max_new=32 through ServeEngine(num_slots=8, max_len=1024,
                page_size=16, k_block=8); every request must end ok, the
                page free list must balance, and the launch counters must
                show the flash kernel on every layer of every prefill call
                and the paged-decode kernel on every layer of every step;
  4. consistency — the same requests with k_block=1 give identical tokens;
  then two engine ticks under torch.profiler (CUDA activity) show where
  the device time goes and how much of a decode step the card sits idle.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SEED = 0
HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
N_TIMED = 25

# tolerances of kernel vs plain version on the same inputs:
#  fp32 — both accumulate in fp32 in another order (online vs one-shot
#         softmax, different reduction trees) over up to 1024 keys;
#  bf16 — inputs are identical; the decode partials are fp32 (only the
#         order differs), the flash output is rounded to bf16, one bf16
#         ulp at |x| < 4 is <= 2**-6, so 2e-2 covers a rounding flip.
TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
       torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}


def log(*a):
    print(*a, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip()
    return out.splitlines()[0]


def time_ms(fn, flush) -> float:
    """Median of N_TIMED single runs timed with CUDA events, after a
    warm-up; ``flush`` evicts the L2 cache before each run."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(N_TIMED):
        flush()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        ts.append(e0.elapsed_time(e1))
    return float(np.median(ts))


def max_err(got, want, dtype) -> float:
    err = 0.0
    for a, b in zip(got, want):
        a, b = a.float(), b.float()
        assert torch.isfinite(a).all(), "kernel produced non-finite values"
        torch.testing.assert_close(a, b, **TOL[dtype])
        err = max(err, float((a - b).abs().max()))
    return err


def decode_case(dtype, dev, gen):
    """Decode shapes of the serve path: 8 slots, 32 q / 4 kv heads, dh 128,
    pages of 16, ragged positions up to 1023, an unallocated page inside a
    slot's span and one empty slot."""
    B, H, Hkv, dh, ps, maxp = 8, 32, 4, 128, 16, 64
    P = B * maxp
    r = lambda *s: torch.randn(*s, generator=gen).to(dev, dtype)
    q, kp, vp = r(B, H, dh), r(P + 1, ps, Hkv, dh), r(P + 1, ps, Hkv, dh)
    perm = torch.randperm(P, generator=gen)
    pages = torch.full((B, maxp), -1, dtype=torch.int32)
    cur = torch.zeros(B, dtype=torch.int32)
    lengths = [1023, 700, 16, 0, 513, 1, 257, 900]      # slot 3 is empty
    used = 0
    for b, n in enumerate(lengths):
        if n == 0:
            continue
        k = -(-n // ps)
        pages[b, :k] = perm[used:used + k].to(torch.int32)
        used += k
        cur[b] = n - 1
    pages[4, 5] = -1                                    # a hole in slot 4
    pages, cur = pages.to(dev), cur.to(dev)
    # keys this data needs: allocated rows at positions <= cur
    valid = 0
    for b in range(B):
        for lp in range(maxp):
            if int(pages[b, lp]) >= 0:
                valid += max(0, min(ps, int(cur[b]) + 1 - lp * ps))
    return (q, kp, vp, pages, cur), valid


def kernel_phase(dev):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.kernels import ref
    gen = torch.Generator().manual_seed(SEED)
    flush_buf = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    flush = lambda: flush_buf.zero_()
    rows = []

    # -- paged decode ----------------------------------------------------
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        (q, kp, vp, pages, cur), valid = decode_case(dtype, dev, gen)
        got = pd.paged_decode_partial(q, kp, vp, pages, cur)
        want = pd.paged_decode_partial_ref(q, kp, vp, pages, cur)
        torch.cuda.synchronize()
        errs[dtype] = max_err(got, want, dtype)
        assert float(got[1][3].abs().max()) == 0.0, "empty slot: l != 0"
        assert bool((got[2][3] == ref.NEG_INF).all()), \
            "empty slot: m != -1e30"
        log(f"[kernels] paged_decode {dtype}: max abs err {errs[dtype]:.3g}")
    (q, kp, vp, pages, cur), valid = decode_case(torch.bfloat16, dev, gen)
    B, H, dh = q.shape
    Hkv = kp.shape[2]
    nbytes = (q.numel() * 2 + 2 * valid * Hkv * dh * 2 + pages.numel() * 4
              + cur.numel() * 4 + B * H * dh * 4 + 2 * B * H * 4)
    flops = 4 * valid * H * dh
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[torch.bfloat16] * 1e3
    rows.append(dict(
        name="paged_decode_partial", route="cuda",
        source="src/repro_torch/kernels/csrc/paged_decode.cu",
        replaces="src/repro/kernels/paged_decode.py:102",
        dtype="bfloat16", shape=f"B={B} H={H} Hkv={Hkv} dh={dh} ps=16 "
        f"cur<=1023 ({valid} valid keys)",
        max_abs_err=errs[torch.bfloat16],
        max_abs_err_fp32=errs[torch.float32],
        ms=time_ms(lambda: pd.paged_decode_partial(q, kp, vp, pages, cur),
                   flush),
        plain_ms=time_ms(lambda: pd.paged_decode_partial_ref(
            q, kp, vp, pages, cur), flush),
        bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=None))

    # -- flash attention -------------------------------------------------
    B, S, H, Hkv, dh = 8, 704, 32, 4, 128
    for dtype in (torch.float32, torch.bfloat16):
        r = lambda *s: torch.randn(*s, generator=gen).to(dev, dtype)
        q, k, v = r(B, S, H, dh), r(B, S, Hkv, dh), r(B, S, Hkv, dh)
        got = fa.flash_attention(q, k, v)
        want = ref.chunked_attention(q, k, v)
        torch.cuda.synchronize()
        errs[dtype] = max_err([got], [want], dtype)
        log(f"[kernels] flash_attention {dtype}: max abs err "
            f"{errs[dtype]:.3g}")
    # q/k/v are the bf16 inputs of the last iteration
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * 2
    flops = 4 * dh * (S * (S + 1) // 2) * B * H
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[torch.bfloat16] * 1e3
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    rows.append(dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:77",
        dtype="bfloat16", shape=f"B={B} S={S} H={H} Hkv={Hkv} dh={dh} causal",
        max_abs_err=errs[torch.bfloat16],
        max_abs_err_fp32=errs[torch.float32],
        ms=time_ms(lambda: fa.flash_attention(q, k, v), flush),
        plain_ms=time_ms(lambda: ref.chunked_attention(q, k, v), flush),
        bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=time_ms(lambda: sdpa(qt, kt, vt, is_causal=True,
                                        enable_gqa=True), flush)))
    del flush_buf
    for row in rows:
        row["kernel_ms"] = row["ms"]
        log(f"[kernels] {row['name']}: kernel {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}), library {row['library_ms']}")
    return rows


def serve(cfg, params, requests, k_block, dev):
    from repro_torch.core.telemetry import TelemetryHub
    from repro_torch.kernels import ops
    from repro_torch.train.serve_loop import ServeEngine
    hub = TelemetryHub()
    eng = ServeEngine(cfg, params, num_slots=8, max_len=1024, page_size=16,
                      k_block=k_block, telemetry=hub, device=dev)
    for prompt, max_new in requests:
        eng.submit(prompt, max_new=max_new)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    results = eng.run_until_complete()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    assert hub.events_dropped == 0
    prefill_calls = sum(1 for e in hub.events()
                        if e["ev"] == "phase" and e["name"] == "prefill")
    return eng, results, wall, launches, prefill_calls


def profile_window(eng, label, step_ms=None):
    """One engine tick under torch.profiler: the union of the tick's
    device kernel intervals against its wall time, and the kernels that
    took the most device time.  The profiler slows the host, so the idle
    share inside the window is an upper bound; with ``step_ms`` (a decode
    step's unprofiled host-clock time) the kernel time per step is also
    set against it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and e.name != "Command Buffer Full"]
    if not kern:
        log(f"[profile] {label}: device time not measured (the profiler "
            f"recorded no device events)")
        return
    busy_us, end = 0.0, -1.0
    for e in sorted(kern, key=lambda e: e.time_range.start):
        s0, s1 = e.time_range.start, e.time_range.end
        if s1 > end:
            busy_us += s1 - max(s0, end)
            end = s1
    steps = eng.last_tick.steps
    log(f"[profile] {label}: wall {wall_us / 1e3:.2f} ms (profiled), "
        f"device kernels {busy_us / 1e3:.2f} ms, idle share in window "
        f"{1 - busy_us / wall_us:.1%}, decode steps {steps}")
    if step_ms and steps:
        per_step = busy_us / 1e3 / steps
        log(f"[profile] {label}: {per_step:.2f} ms of kernels per step "
            f"({len(kern) / steps:.0f} launches) vs {step_ms:.2f} ms per "
            f"step unprofiled: idle share {1 - per_step / step_ms:.1%}")
    by_name = {}
    for e in kern:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.end - e.time_range.start, n + 1)
    for name, (t, n) in sorted(by_name.items(), key=lambda x: -x[1][0])[:8]:
        log(f"[profile] {label}:   {t / 1e3:9.3f} ms x{n:<5d} {name[:80]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs an H100",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.config import get_config
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build
    from repro_torch.models import model as M

    t_start = time.perf_counter()
    dev = resolve_device("cuda:0")
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log(smi)
    log(f"[device] {name}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    build_s = build.build()
    log(f"[device] kernel build {build_s:.2f} s (wall "
        f"{time.perf_counter() - t0:.2f} s), libraries in {build.BUILD_DIR}")
    for n, out in build.BUILD_LOGS.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[device] ptxas {n}: {line.strip()}")

    rows = kernel_phase(dev)

    # -- serve -------------------------------------------------------------
    cfg = get_config("yi-9b")
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = M.init_params(cfg, gen, dev)
    torch.cuda.synchronize()
    log(f"[serve] yi-9b bf16: {M.count_params(cfg) / 1e9:.3f} B params, "
        f"{cfg.num_layers} layers, init {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED)
    requests = [(rng.integers(0, cfg.vocab_size,
                              int(rng.integers(16, 701))).tolist(), 32)
                for _ in range(16)]
    log(f"[serve] prompt lengths {[len(p) for p, _ in requests]}")
    eng, results, wall, launches, prefill_calls = serve(cfg, params,
                                                        requests, 8, dev)
    st = eng.stats
    assert len(results) == 16 and all(r.status == "ok" for r in results), \
        [r.status for r in results]
    assert all(len(r.tokens) == 32 for r in results)
    assert all(0 <= t < cfg.vocab_size for r in results for t in r.tokens)
    eng.pager.check_balanced()
    L = cfg.num_layers
    assert launches["flash_attention"] == L * prefill_calls > 0, \
        (launches, prefill_calls)
    assert launches["paged_decode"] == L * st.decode_steps > 0, \
        (launches, st.decode_steps)
    for row in rows:
        row["launches"] = launches[row["name"].replace("_partial", "")]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"[serve] {len(results)} requests ok, {st.tokens} tokens in "
        f"{wall:.2f} s wall ({st.tokens / wall:.1f} tok/s wall); "
        f"{prefill_calls} prefill calls, {st.decode_steps} decode steps")
    log(f"[serve] prefill {st.prefill_s * 1e3:.1f} ms serving "
        f"({st.prefill_s * 1e3 / max(prefill_calls - 1, 1):.1f} ms per warm "
        f"call), decode {st.decode_s * 1e3 / max(st.decode_steps, 1):.2f} "
        f"ms per step (first block and first prefill booked as compile "
        f"{st.compile_s:.2f} s), {st.tokens / (st.prefill_s + st.decode_s):.1f}"
        f" tok/s serving; peak memory {peak_gb:.2f} GB")
    log(f"[serve] launches {launches}")
    for line in st.summary().splitlines():
        log(f"[serve] {line}")

    # -- consistency ---------------------------------------------------------
    eng1, results1, wall1, _, _ = serve(cfg, params, requests, 1, dev)
    assert [r.tokens for r in results1] == [r.tokens for r in results], \
        "k_block=1 and k_block=8 disagree"
    eng1.pager.check_balanced()
    log(f"[consistency] k_block=1 gives identical tokens ({wall1:.2f} s "
        f"wall, {eng1.stats.decode_s * 1e3 / eng1.stats.decode_steps:.2f} "
        f"ms per step)")

    # -- where the time goes -------------------------------------------------
    # a separate engine, warm by now: one tick that admits 8 requests
    # (prefill calls + a decode block), then one decode-only tick
    from repro_torch.train.serve_loop import ServeEngine
    eng = ServeEngine(cfg, params, num_slots=8, max_len=1024, page_size=16,
                      k_block=8, device=dev)
    for prompt, _ in requests[:8]:
        eng.submit(prompt, max_new=32)
    profile_window(eng, "admit+prefill+block tick")
    profile_window(eng, "decode block tick",
                   step_ms=st.decode_s * 1e3 / st.decode_steps)
    eng.run_until_complete()
    log(f"[done] total {time.perf_counter() - t_start:.1f} s")

    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
