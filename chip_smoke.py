"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit and no result line):
  1. device   — the card's name and power limit, torch/CUDA versions, and
                the parallel nvcc build of every kernel in
                src/repro_torch/kernels/csrc (six sources);
  2. kernels  — each CUDA kernel against its plain PyTorch version at the
                shapes its serve path gives it (yi-9b: dh 128; gemma3-12b:
                dh 240, window 1024, and its 262144 x 3840 vocabulary table
                for isp_gather: 8 ids of a decode step and 8 x 1024 of a
                prefill at offset 0, a four-shard layout with weights and
                -1 pads, an n no block size divides at a D the vector width
                does not divide), in bfloat16 and float32, then timed with
                CUDA events (median of 25 runs, L2 flushed between runs, a
                spin on the card before each so that the interval is device
                time) beside its plain version, its bound and, where one
                PyTorch call computes the same function, that call;
  3. apps     — the paper's NLP-query path (benchmarks/apps.py's recommender
                and sentiment batches, examples/isp_embedding_demo.py's
                sharded pool) through ops.topk_similarity and
                ops.isp_gather_pool: cosine top-10 over the 58,000 x 128
                movie matrix at Q = 50 and 256 with an fp32 and a bf16
                corpus, and an exact-tie case that must give identical ids;
                40,000 reviews of 12 ids over a 4096 x 64 table pooled, then
                a (64, 2) head and argmax, without and with per-id weights,
                in fp32 and bf16; a 65,536 x 512 table pooled in 16 shards
                of 4096 rows (8192 ids, 256 segments, -1 ids and segments
                -1 and 256 dropped) summing to the dense pool; each kernel
                launched exactly once per call, held to its plain version,
                timed beside it, its bound and the library call, with items
                per second per batch;
  4. serve    — full-width, full-depth yi-9b in bfloat16 with seeded random
                weights: 16 requests with prompt lengths in 16..700 and
                max_new=32 through ServeEngine(num_slots=8, max_len=1024,
                page_size=16, k_block=8); every request must end ok, the
                page free list must balance, and the launch counters must
                show the flash kernel on every layer of every prefill call
                and the paged-decode kernel on every layer of every step;
  5. consistency — the same requests with k_block=1 give identical tokens;
     then two engine ticks under torch.profiler (CUDA activity) show where
     the device time goes and how much of a decode step the card sits idle;
  6. strip    — yi-9b at 8 layers in float32 on kv_layout="strip" against
                "paged", on the same 16 requests: the isp-decode kernel on
                every layer of every strip step, and the same tokens (a
                flip passes only at a printed top-2 logit margin < 1e-3);
  7. gemma3   — full-width, full-depth gemma3-12b in bfloat16 (40 window
                layers on per-slot rings, 8 global layers on the paged
                pool): 16 requests with prompt lengths in 16..1500, two of
                them 1000-token prompts with max_new=64 so their rings wrap
                while decoding, through ServeEngine(num_slots=8,
                max_len=2048, page_size=16, k_block=8); all ok, a balanced
                free list, the flash kernel on all 48 layers of every
                prefill call, the isp-decode kernel on the 40 window layers
                and the paged-decode kernel on the 8 global layers of every
                step; k_block=1 gives identical tokens; one decode tick is
                profiled;
  8. plan     — the same gemma3-12b (before it is freed) through a sharding
                plan on the one-rank (1, 1) ("data", "model") mesh (NCCL,
                make_plan's FSDP heuristic on): prefill_fn with the recipe
                on 8 prompts of 1024 random tokens, then 32 uniform decode_fn
                steps from init_caches(cfg, 8, 1024) (16 prompt tokens fed,
                16 greedy), against the same run without a recipe: identical
                tokens; isp_gather launched exactly once per prefill call and
                decode step under the plan and never without it, the other
                kernels exactly as on the uniform path (flash 48 per prefill,
                isp decode 48 per step); embed_lookup under the plan
                bit-equal to gather_baseline; decode ms per step and peak
                memory with and without the recipe, in turns (plan, no
                plan, no plan, plan); the process group is torn down at the
                end.
Each path's launch counters are set to 0 just before it runs and read just
after; the launches that hold a kernel against its plain version do not
count.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import dataclasses
import gc
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
SPIN_CYCLES = 10_000_000    # ~5 ms of GPU spin at the H100's ~1.98 GHz

# tolerances of kernel vs plain version on the same inputs:
#  fp32 — both accumulate in fp32 in another order (online vs one-shot
#         softmax, different reduction trees) over up to 1024 keys;
#  bf16 — inputs are identical; the decode partials are fp32 (only the
#         order differs), the flash output is rounded to bf16, one bf16
#         ulp at |x| < 4 is <= 2**-6, so 2e-2 covers a rounding flip.
# isp_gather copies rows: exact (atol 0) without weights and in fp32; with
# weights in bf16 the kernel multiplies in fp32 and rounds once where the
# plain version multiplies in bf16, so they may differ by one bf16 ulp.
TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
       torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
# topk_similarity: a score is a dot product of two unit fp32 vectors (|s| <=
# 1), summed in another order by the kernel (FMA chain) and cuBLAS; that
# moves it by a few fp32 ulps of 1, far below 1e-5.  isp_gather_pool: see
# check_pool (fp32 atomics sum in an order that changes from run to run).
TOPK_ATOL = 1e-5


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
    warm-up; ``flush`` evicts the L2 cache before each run.  A spin on the
    card before the start event keeps it busy while the host enqueues the
    run, so the interval is the run's device time: without it a slow host
    shows its launch overhead as kernel time."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(N_TIMED):
        flush()
        torch.cuda._sleep(SPIN_CYCLES)
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


def bound(nbytes: float, flops: float, dtype):
    """The least time the card could take: bytes over the memory rate or
    operations over the peak rate of ``dtype``, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def bf16_ulps(a, b) -> int:
    """Largest distance in bf16 ulps between two bf16 tensors."""
    def line(x):
        i = x.view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return int((line(a) - line(b)).abs().max())


def gather_cases(dev):
    """isp_gather against its plain version.  Returns, per number of ids,
    gemma3-12b's bf16 table and ids at offset 0 (the timed cases) and the
    max abs error at that case in bf16 and in fp32."""
    from repro_torch.kernels import isp_gather as ig
    gen = torch.Generator(device=dev).manual_seed(SEED)
    V, D = 262144, 3840
    ids = lambda n, lo=0, hi=V: torch.randint(   # noqa: E731
        lo, hi, (n,), generator=gen, device=dev, dtype=torch.int32)
    timed, errs = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        table = torch.randn(V, D, generator=gen, device=dev).to(dtype)
        for n in (8, 8 * 1024):
            idx = ids(n)
            got = ig.isp_gather(table, idx)
            want = ig.isp_gather_ref(table, idx)
            errs[dtype, n] = float((got.float() - want.float()).abs().max())
            assert torch.equal(got, want), \
                f"isp_gather {dtype} n={n}: not exact"
            if dtype == torch.bfloat16:
                timed[n] = (table, idx)
        # four shards: this one holds rows [131072, 196608); ids over the
        # whole vocabulary, every 9th a -1 pad, with weights
        off, v_loc = 131072, 65536
        idx = ids(8192)
        idx[::9] = -1
        w = torch.randn(8192, generator=gen, device=dev)
        shard = table[off:off + v_loc]
        got = ig.isp_gather(shard, idx, shard_offset=off, weights=w)
        want = ig.isp_gather_ref(shard, idx, shard_offset=off, weights=w)
        out = (idx < off) | (idx >= off + v_loc)
        assert int(out.sum()) > 0 and not bool(got[out].any())
        if dtype == torch.float32:
            assert torch.equal(got, want), "isp_gather fp32 weighted"
        else:
            assert bf16_ulps(got, want) <= 1, "isp_gather bf16 weighted"
        # n = 1001 (no block of 8 ids divides it), D = 3841 (rows not
        # 16-byte aligned take the scalar path)
        odd = torch.randn(4096, 3841, generator=gen, device=dev).to(dtype)
        idx = ids(1001, -1, 4200)
        got = ig.isp_gather(odd, idx, shard_offset=100)
        assert torch.equal(got, ig.isp_gather_ref(odd, idx,
                                                  shard_offset=100))
        torch.cuda.synchronize()
        log(f"[kernels] isp_gather {dtype}: exact at gemma3's table (8 and "
            f"8192 ids), four-shard weighted "
            f"{'exact' if dtype == torch.float32 else '<= 1 bf16 ulp'}, "
            f"n=1001 D=3841 exact")
        del table, shard, odd
    return {n: (t, i, errs[torch.bfloat16, n], errs[torch.float32, n])
            for n, (t, i) in timed.items()}


def decode_case(dtype, dev, gen, H=32, Hkv=4, dh=128, maxp=64,
                lengths=(1023, 700, 16, 0, 513, 1, 257, 900)):
    """Paged-decode shapes of a serve path: 8 slots, pages of 16, ragged
    positions (``lengths``: tokens per slot, slot 3 empty), and an
    unallocated page inside slot 4's span."""
    B, ps = len(lengths), 16
    P = B * maxp
    r = lambda *s: torch.randn(*s, generator=gen).to(dev, dtype)
    q, kp, vp = r(B, H, dh), r(P + 1, ps, Hkv, dh), r(P + 1, ps, Hkv, dh)
    perm = torch.randperm(P, generator=gen)
    pages = torch.full((B, maxp), -1, dtype=torch.int32)
    cur = torch.zeros(B, dtype=torch.int32)
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


def ring_tracks(cur, S: int, empty=()):
    """Per-slot ring tracks (B, S): slot b holds positions
    max(0, cur[b] - S + 1) .. cur[b] at row pos % S, -1 elsewhere."""
    kpos = torch.full((len(cur), S), -1, dtype=torch.int32)
    for b, c in enumerate(cur):
        if b not in empty:
            p = torch.arange(max(0, c - S + 1), c + 1, dtype=torch.int32)
            kpos[b, p % S] = p
    return kpos


def strip_case(layout, dtype, dev, gen):
    """Dense-strip decode shapes.  "shared": the Pallas layout at yi-9b's
    shapes, one track kpos (S,) with half the rows empty and a scalar cur.
    "ring": gemma3-12b's window layers, per-slot rings kpos (8, 1024) with
    wrapped slots, an empty slot (3) and a slot with fewer keys than the
    window (7), window 1024."""
    if layout == "shared":
        B, H, Hkv, dh, S, window = 8, 32, 4, 128, 1024, None
        pos = torch.arange(S, dtype=torch.int32)
        kpos = torch.where(pos < S // 2, pos, -1)
        cur = torch.tensor(S // 2 - 1, dtype=torch.int32)
    else:
        B, H, Hkv, dh, S, window = 8, 16, 8, 240, 1024, 1024
        now = [1500, 2047, 1023, 0, 700, 1024, 1999, 50]
        kpos = ring_tracks(now, S, empty=(3,))
        cur = torch.tensor(now, dtype=torch.int32)
    r = lambda *s: torch.randn(*s, generator=gen).to(dev, dtype)
    q, k, v = r(B, H, dh), r(B, S, Hkv, dh), r(B, S, Hkv, dh)
    kpos, cur = kpos.to(dev), cur.to(dev)
    from repro_torch.kernels import ref
    valid = int(ref._decode_valid_mask(kpos, cur, window).expand(B, S).sum())
    return (q, k, v, kpos, cur), window, valid


def kernel_phase(dev):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import isp_decode as isp
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.kernels import ref
    gen = torch.Generator().manual_seed(SEED)
    flush_buf = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    flush = lambda: flush_buf.zero_()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []

    # -- paged decode: yi-9b (dh 128) and gemma3-12b's global layers (dh 240)
    for path, kw in (("yi-9b serve", {}),
                     ("gemma3-12b serve", dict(
                         H=16, Hkv=8, dh=240, maxp=128,
                         lengths=(2048, 1500, 16, 0, 1031, 1, 700, 1990)))):
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            (q, kp, vp, pages, cur), valid = decode_case(dtype, dev, gen,
                                                         **kw)
            got = pd.paged_decode_partial(q, kp, vp, pages, cur)
            want = pd.paged_decode_partial_ref(q, kp, vp, pages, cur)
            torch.cuda.synchronize()
            errs[dtype] = max_err(got, want, dtype)
            assert float(got[1][3].abs().max()) == 0.0, "empty slot: l != 0"
            assert bool((got[2][3] == ref.NEG_INF).all()), \
                "empty slot: m != -1e30"
            log(f"[kernels] paged_decode {path} {dtype}: max abs err "
                f"{errs[dtype]:.3g}")
        # q/kp/... are the bf16 inputs of the last iteration
        B, H, dh = q.shape
        Hkv = kp.shape[2]
        nbytes = (q.numel() * 2 + 2 * valid * Hkv * dh * 2
                  + pages.numel() * 4 + cur.numel() * 4 + B * H * dh * 4
                  + 2 * B * H * 4)
        bound_ms, bound_by = bound(nbytes, 4 * valid * H * dh,
                                   torch.bfloat16)
        rows.append(dict(
            name="paged_decode_partial", kernel="paged_decode", path=path,
            route="cuda", source="src/repro_torch/kernels/csrc/paged_decode.cu",
            replaces="src/repro/kernels/paged_decode.py:102",
            dtype="bfloat16", shape=f"B={B} H={H} Hkv={Hkv} dh={dh} ps=16 "
            f"cur<={int(cur.max())} ({valid} valid keys)",
            max_abs_err=errs[torch.bfloat16],
            max_abs_err_fp32=errs[torch.float32],
            ms=time_ms(lambda: pd.paged_decode_partial(q, kp, vp, pages, cur),
                       flush),
            plain_ms=time_ms(lambda: pd.paged_decode_partial_ref(
                q, kp, vp, pages, cur), flush),
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None))

    # -- dense-strip decode: the Pallas layout (yi-9b's shapes, the strip
    # phase) and gemma3-12b's per-slot window rings
    for path, layout in (("yi-9b strip", "shared"),
                         ("gemma3-12b serve", "ring")):
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            args, window, valid = strip_case(layout, dtype, dev, gen)
            got = isp.decode_partial(*args, window=window)
            want = isp.decode_partial_ref(*args, window=window)
            torch.cuda.synchronize()
            errs[dtype] = max_err(got, want, dtype)
            if layout == "ring":
                assert float(got[0][3].abs().max()) == 0.0, \
                    "empty slot: acc != 0"
                assert float(got[1][3].abs().max()) == 0.0, \
                    "empty slot: l != 0"
                assert bool((got[2][3] == ref.NEG_INF).all()), \
                    "empty slot: m != -1e30"
            log(f"[kernels] isp_decode {layout} {dtype}: max abs err "
                f"{errs[dtype]:.3g}")
        q, k, v, kpos, cur = args
        B, H, dh = q.shape
        S, Hkv = k.shape[1], k.shape[2]
        nbytes = (q.numel() * 2 + 2 * valid * Hkv * dh * 2 + kpos.numel() * 4
                  + cur.numel() * 4 + B * H * dh * 4 + 2 * B * H * 4)
        bound_ms, bound_by = bound(nbytes, 4 * valid * H * dh,
                                   torch.bfloat16)
        rows.append(dict(
            name="decode_partial", kernel="isp_decode", path=path,
            route="cuda", source="src/repro_torch/kernels/csrc/isp_decode.cu",
            replaces="src/repro/kernels/isp_decode.py:72",
            dtype="bfloat16", shape=f"B={B} H={H} Hkv={Hkv} dh={dh} S={S} "
            f"kpos {tuple(kpos.shape)} window={window} ({valid} valid keys)",
            max_abs_err=errs[torch.bfloat16],
            max_abs_err_fp32=errs[torch.float32],
            ms=time_ms(lambda: isp.decode_partial(*args, window=window),
                       flush),
            plain_ms=time_ms(lambda: isp.decode_partial_ref(
                *args, window=window), flush),
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None))

    # -- flash attention: yi-9b's prefill (dh 128, causal) and gemma3-12b's
    # window layers (dh 240, window 1024)
    for path, (B, S, H, Hkv, dh, window) in (
            ("yi-9b serve", (8, 704, 32, 4, 128, None)),
            ("gemma3-12b serve", (8, 1536, 16, 8, 240, 1024))):
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            r = lambda *s: torch.randn(*s, generator=gen).to(dev, dtype)
            q, k, v = r(B, S, H, dh), r(B, S, Hkv, dh), r(B, S, Hkv, dh)
            got = fa.flash_attention(q, k, v, window=window)
            want = ref.chunked_attention(q, k, v, window=window)
            torch.cuda.synchronize()
            errs[dtype] = max_err([got], [want], dtype)
            log(f"[kernels] flash_attention {path} {dtype}: max abs err "
                f"{errs[dtype]:.3g}")
        # q/k/v are the bf16 inputs of the last iteration; (query, key)
        # pairs the causal mask and the window leave
        w = S if window is None else window
        pairs = sum(min(i + 1, w) for i in range(S))
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * 2
        bound_ms, bound_by = bound(nbytes, 4 * dh * pairs * B * H,
                                   torch.bfloat16)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        if window is None:
            lib = lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)
        else:
            i = torch.arange(S, device=dev)
            mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - w)
            lib = lambda: sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True)
        rows.append(dict(
            name="flash_attention", kernel="flash_attention", path=path,
            route="cuda",
            source="src/repro_torch/kernels/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:77",
            dtype="bfloat16", shape=f"B={B} S={S} H={H} Hkv={Hkv} dh={dh} "
            f"causal window={window}",
            max_abs_err=errs[torch.bfloat16],
            max_abs_err_fp32=errs[torch.float32],
            ms=time_ms(lambda: fa.flash_attention(q, k, v, window=window),
                       flush),
            plain_ms=time_ms(lambda: ref.chunked_attention(
                q, k, v, window=window), flush),
            bound_ms=bound_ms, bound_by=bound_by, library_ms=time_ms(lib,
                                                                     flush)))
    # -- isp gather: gemma3-12b's vocabulary table under the plan (offset 0:
    # the whole table is this rank's shard on the one-rank mesh)
    from repro_torch.kernels import isp_gather as ig
    for n, (table, idx, err, err32) in gather_cases(dev).items():
        V, D = table.shape
        idx64 = idx.long()
        nbytes = 2 * n * D * 2 + 4 * n          # rows read + written, ids
        bound_ms, bound_by = bound(nbytes, 0, torch.bfloat16)
        rows.append(dict(
            name="isp_gather", kernel="isp_gather", path="gemma3-12b plan",
            route="cuda", source="src/repro_torch/kernels/csrc/isp_gather.cu",
            replaces="src/repro/kernels/isp_gather.py:50",
            dtype="bfloat16", shape=f"table ({V}, {D}) offset 0, {n} ids "
            f"({'decode step' if n == 8 else 'prefill'})",
            max_abs_err=err, max_abs_err_fp32=err32, bytes=nbytes,
            ms=time_ms(lambda: ig.isp_gather(table, idx), flush),
            plain_ms=time_ms(lambda: ig.isp_gather_ref(table, idx), flush),
            bound_ms=bound_ms, bound_by=bound_by,
            library_ms=time_ms(lambda: torch.nn.functional.embedding(
                idx64, table), flush)))
        del table
    del flush_buf
    for row in rows:
        row["kernel_ms"] = row["ms"]
        log(f"[kernels] {row['name']} ({row['path']}): kernel "
            f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}), library "
            f"{row['library_ms']}")
    return rows


def dname(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def sign_rows(rng, n, d=128, nonzero=64):
    """Rows with ``nonzero`` entries of +-1: norm 8, so normalising and
    every dot product are exact in fp32 and equal scores are exactly
    equal."""
    x = np.zeros((n, d), np.float32)
    for r in range(n):
        cols = rng.choice(d, nonzero, replace=False)
        x[r, cols] = rng.choice([-1.0, 1.0], nonzero)
    return x


def check_topk(got, qs, corpus, k, tag) -> float:
    """The kernel's top-k against the plain version on the same inputs:
    scores within TOPK_ATOL, ids equal wherever a score lies more than that
    from its neighbours in the list and from the (k+1)-th score.  Returns
    the max abs score error."""
    from repro_torch.kernels import topk_similarity as tk
    ws, wi = tk.topk_similarity_ref(qs, corpus, k + 1)
    gs, gi = got
    assert gs.shape == gi.shape == (qs.shape[0], k)
    assert torch.isfinite(gs).all(), f"{tag}: non-finite scores"
    err = float((gs - ws[:, :k]).abs().max())
    assert err <= TOPK_ATOL, f"{tag}: score error {err}"
    gap = (ws[:, 1:] - ws[:, :-1]).abs()
    lo = torch.cat([torch.full_like(gap[:, :1], float("inf")),
                    gap[:, :-1]], dim=1)
    sep = (gap > TOPK_ATOL) & (lo > TOPK_ATOL)
    assert bool((gi[sep] == wi[:, :k][sep]).all()), f"{tag}: ids differ"
    log(f"[apps] {tag}: max abs score err {err:.3g}, ids equal at "
        f"{int(sep.sum())}/{sep.numel()} separated places")
    return err


def check_pool(got, table, idx, seg, nseg, off=0, w=None, tag="") -> float:
    """The kernel's pool against the plain version on the same inputs.
    Each output is a sum of at most 64 terms, taken in another order (fp32
    atomics): the two differ by at most 2 * 63 * 2**-24 of the pooled
    absolute terms, held here within 2**-16 of them (+1e-6); with weights
    in bf16 each term may also differ by one bf16 ulp (2**-7).  Returns
    the max abs error."""
    from repro_torch.kernels import isp_gather as ig
    counts = torch.bincount(seg[(seg >= 0) & (seg < nseg)].long(),
                            minlength=nseg)
    assert int(counts.max()) <= 64
    want = ig.isp_gather_pool_ref(table, idx, seg, nseg, shard_offset=off,
                                  weights=w)
    mag = ig.isp_gather_pool_ref(table.abs(), idx, seg, nseg,
                                 shard_offset=off,
                                 weights=None if w is None else w.abs())
    rel = 2.0 ** -16 + (2.0 ** -7 if w is not None
                        and table.dtype == torch.bfloat16 else 0.0)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.isfinite(got).all(), f"{tag}: non-finite pool"
    diff = (got - want).abs()
    assert bool((diff <= 1e-6 + rel * mag).all()), \
        f"{tag}: pool error {float(diff.max())}"
    return float(diff.max())


def apps_phase(dev):
    """The paper's NLP-query path (benchmarks/apps.py's two kernel apps and
    examples/isp_embedding_demo.py's pool) through ops.topk_similarity and
    ops.isp_gather_pool at the paper's batch sizes; the launch counters are
    set to 0 just before the path and read just after.  Returns the kernel
    rows and the path's launches."""
    from repro_torch.kernels import isp_gather as ig
    from repro_torch.kernels import ops
    from repro_torch.kernels import topk_similarity as tk
    rng = np.random.default_rng(SEED + 3)
    flush_buf = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    flush = lambda: flush_buf.zero_()  # noqa: E731
    on = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # noqa

    # recommender: the 58,000 x 128 movie matrix, top 10, Q = 50 and 256
    N, D, K = 58_000, 128, 10
    corpus = {torch.float32: on(rng.normal(size=(N, D)).astype(np.float32))}
    corpus[torch.bfloat16] = corpus[torch.float32].to(torch.bfloat16)
    queries = {q: on(rng.normal(size=(q, D)).astype(np.float32))
               for q in (50, 256)}
    uniq = sign_rows(rng, 1000)
    tie_c = on(np.concatenate([uniq, uniq[::-1], uniq, uniq[::-1]]))
    tie_q = on(np.concatenate([sign_rows(rng, 25),
                               uniq[rng.choice(1000, 25, replace=False)]]))
    # sentiment: 40,000 reviews of 12 ids over a 4096 x 64 table, 2 classes
    R, L, V, E = 40_000, 12, 4096, 64
    s_idx = on(rng.integers(0, V, (R * L,)).astype(np.int32))
    s_seg = on(np.repeat(np.arange(R), L).astype(np.int32))
    s_tab = {torch.float32: on(rng.normal(size=(V, E)).astype(np.float32))}
    s_tab[torch.bfloat16] = s_tab[torch.float32].to(torch.bfloat16)
    s_w = on(rng.normal(size=(R * L,)).astype(np.float32))
    head = on(rng.normal(size=(E, 2)).astype(np.float32))
    sent_cases = {"fp32": (torch.float32, None),
                  "fp32 weighted": (torch.float32, s_w),
                  "bf16": (torch.bfloat16, None),
                  "bf16 weighted": (torch.bfloat16, s_w)}
    # sharded pool: 65,536 x 512 in 16 shards of 4096 rows, 8192 ids in 256
    # segments, with -1 ids and segment ids -1 and 256 that are dropped
    SV, SD, TP, SN, NSEG = 65_536, 512, 16, 8192, 256
    p_tab = on(rng.normal(size=(SV, SD)).astype(np.float32))
    p_idx = rng.integers(0, SV, (SN,)).astype(np.int32)
    p_seg = rng.integers(0, NSEG, (SN,)).astype(np.int32)
    p_idx[::31], p_seg[1::29], p_seg[2::37] = -1, -1, NSEG
    p_idx, p_seg = on(p_idx), on(p_seg)
    vloc = SV // TP
    shards = [p_tab[i * vloc:(i + 1) * vloc] for i in range(TP)]

    def sentiment(dtype, w, pool=ops.isp_gather_pool):
        pooled = pool(s_tab[dtype], s_idx, s_seg, R, weights=w)
        logits = pooled @ head
        return pooled, logits, logits.argmax(-1)

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    rec = {(dt, q): ops.topk_similarity(queries[q], corpus[dt], K)
           for dt in corpus for q in queries}
    tie = ops.topk_similarity(tie_q, tie_c, K)
    sent = {name: sentiment(*case) for name, case in sent_cases.items()}
    parts = [ops.isp_gather_pool(shards[i], p_idx, p_seg, NSEG,
                                 shard_offset=i * vloc) for i in range(TP)]
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    want = {n: 0 for n in launches}
    want.update(topk_similarity=len(rec) + 1,
                isp_gather_pool=len(sent) + TP)
    assert launches == want, (launches, want)
    log(f"[apps] launches {launches}")

    errs = {}
    for (dt, q), got in rec.items():
        errs[dt, q] = check_topk(got, queries[q], corpus[dt], K,
                                 f"recommender Q={q} corpus {dname(dt)}")
    ws, wi = tk.topk_similarity_ref(tie_q, tie_c, K)
    assert torch.equal(tie[1], wi) and torch.equal(tie[0], ws), \
        "exact ties: the kernel's ids differ from the plain version's"
    assert int((ws[:, 1:] == ws[:, :-1]).sum()) > 50, "too few ties"
    log(f"[apps] exact ties (50 x 4000 rows, each repeated 4 times): "
        f"identical scores and ids, lower id first")
    for name, (dt, w) in sent_cases.items():
        pooled, logits, preds = sent[name]
        errs[name] = check_pool(pooled, s_tab[dt], s_idx, s_seg, R, w=w,
                                tag=f"sentiment {name}")
        w_pooled, w_logits, w_preds = sentiment(dt, w, ig.isp_gather_pool_ref)
        # a prediction may flip only where the plain path's two logits lie
        # closer than the pool's own error can move them
        moved = ((pooled - w_pooled).abs() @ head.abs()).sum(-1) + 1e-6
        near = (w_logits[:, 0] - w_logits[:, 1]).abs() <= moved
        assert bool((preds == w_preds)[~near].all()), f"sentiment {name}"
        log(f"[apps] sentiment {name}: max abs pool err {errs[name]:.3g}; "
            f"{int((preds == w_preds).sum())}/{R} predictions equal, "
            f"{int(near.sum())} near-ties excused, positive share "
            f"{float(preds.float().mean()):.4f}")
    errs["sharded"] = max(
        check_pool(parts[i], shards[i], p_idx, p_seg, NSEG, i * vloc,
                   tag=f"shard {i}") for i in range(TP))
    keep = (p_idx >= 0) & (p_seg >= 0) & (p_seg < NSEG)
    dense = torch.zeros(NSEG, SD, device=dev).index_add_(
        0, p_seg[keep].long(), p_tab[p_idx[keep].long()])
    torch.testing.assert_close(sum(parts), dense, atol=1e-4, rtol=0)
    log(f"[apps] sharded pool: 16 shards sum to the dense pool (atol 1e-4), "
        f"{int((~keep).sum())} dropped ids/segments; max abs err per shard "
        f"{errs['sharded']:.3g}")
    # edge shapes, off the counted path: a D that 4 does not divide (the
    # wrapper pads it), two query blocks and k = 32; an odd D (scalar
    # loads) in bf16 with weights, an offset and segments -1 and 40, 41
    eq = on(rng.normal(size=(70, 37)).astype(np.float32))
    ec = on(rng.normal(size=(1000, 37)).astype(np.float32))
    check_topk(tk.topk_similarity(eq, ec, 32), eq, ec, 32,
               "edge: D=37, Q=70, N=1000, k=32")
    et = on(rng.normal(size=(300, 67)).astype(np.float32)).to(torch.bfloat16)
    ei = on(rng.integers(-5, 420, (999,)).astype(np.int32))
    es = on(rng.integers(-1, 42, (999,)).astype(np.int32))
    ew = on(rng.normal(size=(999,)).astype(np.float32))
    err = check_pool(ig.isp_gather_pool(et, ei, es, 40, shard_offset=100,
                                        weights=ew), et, ei, es, 40, 100, ew,
                     tag="edge pool")
    log(f"[apps] edge pool: bf16 (300, 67) offset 100, 999 ids, weighted, "
        f"segments -1..41 of 40: max abs err {err:.3g}")

    rows = []
    emb_bag = torch.nn.functional.embedding_bag
    for (dt, q) in rec:
        qs, c = queries[q], corpus[dt]
        flops = 2 * q * N * D
        nbytes = q * D * 4 + c.numel() * c.element_size() + q * K * 8
        bound_ms, bound_by = bound(nbytes, flops, torch.float32)
        ms = time_ms(lambda: tk.topk_similarity(qs, c, K), flush)
        qn = torch.nn.functional.normalize(qs, dim=-1, eps=1e-9)
        cn = torch.nn.functional.normalize(c.float(), dim=-1, eps=1e-9)
        rows.append(dict(
            name="topk_similarity", kernel="topk_similarity", path="apps",
            route="cuda",
            source="src/repro_torch/kernels/csrc/topk_similarity.cu",
            replaces="src/repro/kernels/topk_similarity.py:75",
            dtype=dname(dt),
            shape=f"recommender: Q={q} corpus ({N}, {D}) {dname(dt)} k={K}",
            max_abs_err=errs[dt, q], ms=ms,
            plain_ms=time_ms(lambda: tk.topk_similarity_ref(qs, c, K), flush),
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
            library_two_calls_ms=time_ms(
                lambda: torch.topk(qn @ cn.mT, K), flush),
            items_per_s=q / ms * 1e3))
    s_ids = s_idx.long().view(R, L)
    for name, (dt, w) in sent_cases.items():
        table = s_tab[dt]
        nbytes = (8 * R * L + (0 if w is None else 4 * R * L)
                  + int(torch.unique(s_idx).numel()) * E * table.element_size()
                  + R * E * 4)
        bound_ms, bound_by = bound(nbytes, 2 * R * L * E, torch.float32)
        lib = None
        if dt == torch.float32:
            pw = None if w is None else w.view(R, L)
            lib = time_ms(lambda: emb_bag(s_ids, table, mode="sum",
                                          per_sample_weights=pw), flush)
        ms = time_ms(lambda: ig.isp_gather_pool(table, s_idx, s_seg, R,
                                                weights=w), flush)
        batch_ms = time_ms(lambda: sentiment(dt, w), flush)
        log(f"[apps] sentiment {name}: batch (pool + head + argmax) "
            f"{batch_ms:.4f} ms, {R / batch_ms * 1e3:.4g} reviews/s")
        rows.append(dict(
            name="isp_gather_pool", kernel="isp_gather_pool", path="apps",
            route="cuda",
            source="src/repro_torch/kernels/csrc/isp_gather_pool.cu",
            replaces="src/repro/kernels/isp_gather.py:124",
            dtype=dname(dt),
            shape=f"sentiment {name}: table ({V}, {E}), {R} x {L} ids",
            max_abs_err=errs[name], ms=ms,
            plain_ms=time_ms(lambda: ig.isp_gather_pool_ref(
                table, s_idx, s_seg, R, weights=w), flush),
            bound_ms=bound_ms, bound_by=bound_by, library_ms=lib,
            bytes=nbytes, batch_ms=batch_ms, items_per_s=R / batch_ms * 1e3))
    # one shard of the sharded pool (shard 5: rows [20480, 24576))
    sh, off = shards[5], 5 * vloc
    inside = (p_idx >= off) & (p_idx < off + vloc)
    nbytes = (8 * SN + int(torch.unique(p_idx[inside]).numel()) * SD * 4
              + NSEG * SD * 4)
    bound_ms, bound_by = bound(nbytes, 2 * int(inside.sum()) * SD,
                               torch.float32)
    ms = time_ms(lambda: ig.isp_gather_pool(sh, p_idx, p_seg, NSEG,
                                            shard_offset=off), flush)
    rows.append(dict(
        name="isp_gather_pool", kernel="isp_gather_pool", path="apps",
        route="cuda", source="src/repro_torch/kernels/csrc/isp_gather_pool.cu",
        replaces="src/repro/kernels/isp_gather.py:124", dtype="float32",
        shape=f"sharded pool: shard ({vloc}, {SD}) offset {off} of {TP}, "
        f"{SN} ids ({int(inside.sum())} in the shard), {NSEG} segments",
        max_abs_err=errs["sharded"], ms=ms,
        plain_ms=time_ms(lambda: ig.isp_gather_pool_ref(
            sh, p_idx, p_seg, NSEG, shard_offset=off), flush),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None, bytes=nbytes))
    del flush_buf
    for row in rows:
        row["kernel_ms"] = row["ms"]
        log(f"[kernels] {row['name']} ({row['shape']}): kernel "
            f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}), library "
            f"{row['library_ms']}"
            + (f", topk(q @ c.T) two calls {row['library_two_calls_ms']:.4f}"
               f" ms, {row['items_per_s']:.4g} queries/s"
               if row["kernel"] == "topk_similarity" else ""))
    return rows, launches


def serve(cfg, params, requests, k_block, dev, max_len=1024,
          kv_layout="paged"):
    """Serve ``requests`` through a fresh engine with the launch counters
    set to 0 just before and read just after."""
    from repro_torch.core.telemetry import TelemetryHub
    from repro_torch.kernels import ops
    from repro_torch.train.serve_loop import ServeEngine
    hub = TelemetryHub()
    eng = ServeEngine(cfg, params, num_slots=8, max_len=max_len,
                      page_size=16, k_block=k_block, kv_layout=kv_layout,
                      telemetry=hub, device=dev)
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


def free_device() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def serve_report(tag, eng, results, wall, launches, prefill_calls):
    st = eng.stats
    lat = st.latency
    log(f"[{tag}] {len(results)} requests ok, {st.tokens} tokens in "
        f"{wall:.2f} s wall ({st.tokens / wall:.1f} tok/s wall); "
        f"{prefill_calls} prefill calls, {st.decode_steps} decode steps")
    log(f"[{tag}] prefill {st.prefill_s * 1e3:.1f} ms serving "
        f"({st.prefill_s * 1e3 / max(prefill_calls - 1, 1):.1f} ms per warm "
        f"call), decode {st.decode_s * 1e3 / max(st.decode_steps, 1):.2f} "
        f"ms per step (first block and first prefill booked as compile "
        f"{st.compile_s:.2f} s), {st.tokens / (st.prefill_s + st.decode_s):.1f}"
        f" tok/s serving; TTFT p50 {lat.p50_ttft_s * 1e3:.1f} ms, p99 "
        f"{lat.p99_ttft_s * 1e3:.1f} ms; peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    log(f"[{tag}] launches {launches}")
    for line in st.summary().splitlines():
        log(f"[{tag}] {line}")


def top2_margin(model, cfg, seq, dev) -> float:
    """Top-2 logit margin of the next token after ``seq`` (one prefill)."""
    from repro_torch.core import embedding as emb
    from repro_torch.models import model as M
    from repro_torch.models.layers import rms_norm
    with torch.no_grad():
        toks = torch.tensor([seq], dtype=torch.int32, device=dev)
        x = emb.gather_baseline(model.embed.table, toks)
        x, _ = M.run_blocks(model, x, torch.arange(len(seq), dtype=torch.int32,
                                                   device=dev), cfg, None,
                            "prefill")
        x = rms_norm(x, model.final_norm, cfg.norm_eps)
        top = torch.topk(emb.sharded_logits_last(x[:, -1], model.head_table(),
                                                 cfg)[0], 2).values
    return float(top[0] - top[1])


def strip_phase(dev, requests):
    """yi-9b at 8 layers in float32 on the strip layout against the paged
    layout: the same tokens, and the isp-decode kernel on every layer of
    every strip step.  Returns the strip run's launches."""
    from repro_torch.config import get_config
    from repro_torch.models import model as M
    cfg = dataclasses.replace(get_config("yi-9b"), num_layers=8,
                              dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = M.init_params(cfg, gen, dev)
    L = cfg.num_layers
    out = {}
    for layout in ("paged", "strip"):
        eng, results, wall, launches, prefill_calls = serve(
            cfg, params, requests, 8, dev, kv_layout=layout)
        assert eng.kv_layout == layout
        assert len(results) == 16 and all(r.status == "ok" for r in results)
        steps = eng.stats.decode_steps
        assert launches["flash_attention"] == L * prefill_calls > 0, launches
        if layout == "strip":
            assert launches["isp_decode"] == L * steps > 0, (launches, steps)
            assert launches["paged_decode"] == 0, launches
        else:
            assert launches["paged_decode"] == L * steps > 0, (launches,
                                                               steps)
            assert launches["isp_decode"] == 0, launches
            eng.pager.check_balanced()
        log(f"[strip] {layout}: {len(results)} ok, {steps} decode steps, "
            f"{eng.stats.decode_s * 1e3 / steps:.2f} ms per step, "
            f"{wall:.2f} s wall; launches {launches}")
        out[layout] = ([r.tokens for r in results], launches)
        del eng
    flips = 0
    for (prompt, _), a, b in zip(requests, out["strip"][0], out["paged"][0]):
        if a == b:
            continue
        t = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        margin = top2_margin(params, cfg, prompt + b[:t], dev)
        log(f"[strip] token flip at step {t}: strip {a[t]} vs paged {b[t]}, "
            f"top-2 logit margin {margin:.3g}")
        assert margin < 1e-3, "strip and paged disagree at a clear margin"
        flips += 1
    log(f"[strip] strip and paged give identical tokens on "
        f"{16 - flips}/16 requests ({flips} flips at near-ties)")
    del params
    free_device()
    return out["strip"][1]


def gemma_phase(dev):
    """Full gemma3-12b in bfloat16: returns (launches, requests' tokens)."""
    from repro_torch.config import get_config
    from repro_torch.models import model as M
    from repro_torch.train.serve_loop import ServeEngine
    cfg = get_config("gemma3-12b")
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = M.init_params(cfg, gen, dev)
    torch.cuda.synchronize()
    log(f"[gemma3] gemma3-12b bf16: {M.count_params(cfg) / 1e9:.3f} B "
        f"params, {cfg.num_layers} layers "
        f"({cfg.layer_pattern.count('local')} window {cfg.attn.window}), "
        f"init {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED + 1)
    lens = [int(rng.integers(16, 1501)) for _ in range(16)]
    long = (1, 12)             # 1000-token prompts whose rings wrap decoding
    for i in long:
        lens[i] = 1000
    requests = [(rng.integers(0, cfg.vocab_size, n).tolist(),
                 64 if i in long else 32) for i, n in enumerate(lens)]
    log(f"[gemma3] prompt lengths {lens}")
    eng, results, wall, launches, prefill_calls = serve(
        cfg, params, requests, 8, dev, max_len=2048)
    st = eng.stats
    assert len(results) == 16 and all(r.status == "ok" for r in results), \
        [r.status for r in results]
    assert [len(r.tokens) for r in results] == [m for _, m in requests]
    assert all(0 <= t < cfg.vocab_size for r in results for t in r.tokens)
    eng.pager.check_balanced()
    n_local = cfg.layer_pattern.count("local")
    n_global = cfg.num_layers - n_local
    assert launches["flash_attention"] == cfg.num_layers * prefill_calls > 0, \
        (launches, prefill_calls)
    assert launches["isp_decode"] == n_local * st.decode_steps > 0, \
        (launches, st.decode_steps)
    assert launches["paged_decode"] == n_global * st.decode_steps > 0, \
        (launches, st.decode_steps)
    serve_report("gemma3", eng, results, wall, launches, prefill_calls)
    step_ms = st.decode_s * 1e3 / st.decode_steps
    tokens = [r.tokens for r in results]
    del eng
    free_device()

    eng1, results1, wall1, _, _ = serve(cfg, params, requests, 1, dev,
                                        max_len=2048)
    assert [r.tokens for r in results1] == tokens, \
        "gemma3: k_block=1 and k_block=8 disagree"
    eng1.pager.check_balanced()
    log(f"[gemma3] k_block=1 gives identical tokens ({wall1:.2f} s wall, "
        f"{eng1.stats.decode_s * 1e3 / eng1.stats.decode_steps:.2f} ms per "
        f"step)")
    del eng1
    free_device()

    # a warm engine: one tick admits 8 requests, the next decodes only
    eng = ServeEngine(cfg, params, num_slots=8, max_len=2048, page_size=16,
                      k_block=8, device=dev)
    for prompt, _ in requests[:8]:
        eng.submit(prompt, max_new=32)
    eng.step()
    profile_window(eng, "gemma3 decode block tick", step_ms=step_ms)
    del eng
    free_device()
    plan_launches = plan_phase(cfg, params, dev)
    del params
    free_device()
    return launches, plan_launches


def plan_phase(cfg, params, dev):
    """gemma3-12b through a sharding recipe on the one-rank mesh against
    the same calls without one; returns the plan run's launches."""
    from repro_torch import sharding as sh
    from repro_torch.config import ShapeConfig
    from repro_torch.core import embedding as emb
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as lm
    from repro_torch.models import model as M
    B, S, FED, STEPS = 8, 1024, 16, 32
    rng = np.random.default_rng(SEED + 2)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32)).to(dev)
    mesh = lm.make_local_mesh(dev)
    try:
        plan = sh.make_plan(mesh, cfg)
        assert plan.fsdp and plan.fsdp_axis == "data", plan
        recipe = sh.make_recipe(plan, cfg, ShapeConfig(S, B))
        log(f"[plan] mesh {mesh}; fsdp {plan.fsdp} (axis {plan.fsdp_axis}), "
            f"batch axes {recipe.batch_axes}, seq axes {recipe.seq_axes}, "
            f"vocab sharded {sh.vocab_sharded(recipe, cfg)}")
        runs = []      # in turns, so that a drift of the host hits both sides
        for tag in ("plan", "no plan", "no plan", "plan"):
            rc = recipe if tag == "plan" else None
            free_device()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            with torch.no_grad():
                nxt, caches = M.prefill_fn(params, {"tokens": prompts}, cfg,
                                           rc)
                del caches
                caches = M.init_caches(cfg, B, S, device=dev, plan=rc)
                tok, out = prompts[:, :1], []
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for t in range(STEPS):
                    o, caches = M.decode_fn(
                        params, caches, tok,
                        torch.tensor(t, dtype=torch.int32, device=dev), cfg,
                        rc)
                    out.append(o)
                    tok = prompts[:, t + 1:t + 2] if t + 1 < FED \
                        else o[:, None]
                torch.cuda.synchronize()
                step_ms = (time.perf_counter() - t0) * 1e3 / STEPS
            launches = ops.launch_counts()
            peak = torch.cuda.max_memory_allocated() / 1e9
            runs.append((tag, nxt, torch.stack(out), launches, step_ms))
            log(f"[plan] {tag}: decode {step_ms:.2f} ms per step over "
                f"{STEPS} steps, peak memory {peak:.2f} GB; launches "
                f"{launches}")
            del caches
        L = cfg.num_layers
        _, n_p, d_p, l_p, _ = runs[0]
        for tag, nxt, toks, launches, _ in runs:
            assert torch.equal(nxt, n_p), "plan: prefill tokens differ"
            assert torch.equal(toks, d_p), "plan: decode tokens differ"
            gathers = 1 + STEPS if tag == "plan" else 0
            assert launches == {"flash_attention": L, "isp_decode": L * STEPS,
                                "paged_decode": 0, "isp_gather": gathers,
                                "isp_gather_pool": 0,
                                "topk_similarity": 0}, (tag, launches)
        assert all(0 <= t < cfg.vocab_size for t in d_p.flatten().tolist())
        for tag in ("plan", "no plan"):
            ms = [r[4] for r in runs if r[0] == tag]
            log(f"[plan] {tag}: decode {np.mean(ms):.2f} ms per step, mean "
                f"of the two runs {[round(m, 2) for m in ms]}")
        with torch.no_grad():
            rows = emb.embed_lookup(params.embed.table, prompts, cfg,
                                    recipe, seq_sharded=False)
        assert torch.equal(rows, emb.gather_baseline(params.embed.table,
                                                     prompts))
        log(f"[plan] identical prefill and {STEPS} decode tokens with and "
            f"without the recipe; isp_gather {l_p['isp_gather']} launches "
            f"(1 prefill + {STEPS} steps); embed_lookup under the plan is "
            f"bit-equal to gather_baseline")
    finally:
        lm.teardown()
    return l_p


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
    app_rows, app_launches = apps_phase(dev)
    rows += app_rows
    free_device()

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
    assert launches["isp_decode"] == 0, launches
    serve_report("serve", eng, results, wall, launches, prefill_calls)
    path_launches = {"yi-9b serve": launches, "apps": app_launches}

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
    del eng, eng1, params
    free_device()

    # -- strip layout, then gemma3-12b -----------------------------------------
    path_launches["yi-9b strip"] = strip_phase(dev, requests)
    (path_launches["gemma3-12b serve"],
     path_launches["gemma3-12b plan"]) = gemma_phase(dev)
    for row in rows:
        row["launches"] = path_launches[row["path"]][row["kernel"]]
    log(f"[done] total {time.perf_counter() - t_start:.1f} s")

    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
