"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit and no result line):
  1. device   — the card's name and power limit, torch/CUDA versions, and
                the parallel nvcc build of every kernel in
                src/repro_torch/kernels/csrc (six sources), with ptxas's
                register and spill lines for every instantiation;
  2. kernels  — each CUDA kernel against its plain PyTorch version at the
                shapes its serve path gives it (yi-9b: dh 128; llama4-scout:
                40 heads over 8 kv; musicgen-large: MHA at dh 64;
                deepseek-v2: flash at 128 heads of qk 192 / v 128;
                hymba-1.5b: 25 heads over 5 at dh 64, flash with window
                1024 and isp decode on its rings; gemma3-12b:
                dh 240, window 1024, and its 262144 x 3840 vocabulary table
                for isp_gather: 8 ids of a decode step and 8 x 1024 of a
                prefill at offset 0, a four-shard layout with weights and
                -1 pads, one id, a D = 1048 whose 131 vectors no tile
                divides, an n no block size divides at a D the vector width
                does not divide), in bfloat16 and float32; paged decode's
                split-K edges (slots that fill whole split spans, a window
                edge inside a span), isp decode's (valid rows filling whole
                spans and one row more or less, empty spans and an empty
                slot, a ring wrapped inside a span, rows that are not
                16-byte aligned, the shared track) and flash's (Sq not a
                multiple of the q tile, q_offset > 0 with and without a
                window, one query row over a long cache) at both head dims,
                flash also at qk 192 / v 128 (MLA_HEADS; the unequal pairs
                it has no instantiation for raise) and, for both decode and
                flash, at the other families' head shapes (NEW_HEADS:
                groups 5, 1 at dh 64, 12, 16, 8, hymba's 5 at dh 64; isp
                decode's edges at hymba's heads too); paged decode at
                hymba's heads timed as an edge off every path (logged, not
                in the kernels record);
                then timed with
                CUDA events (median of 25 runs, L2 flushed between runs, a
                spin on the card before each so that the interval is device
                time) beside its plain version, its bound and, where one
                PyTorch call computes the same function, that call; the
                gather, the pool and isp decode on the rings also after a
                flush that leaves the L2 clean (ms_clean_l2), beside the
                time of one empty launch and, for the prefill gather, one
                contiguous copy of the same bytes;
  3. apps     — the paper's NLP-query path (benchmarks/apps.py's recommender
                and sentiment batches, examples/isp_embedding_demo.py's
                sharded pool) through ops.topk_similarity and
                ops.isp_gather_pool: cosine top-10 over the 58,000 x 128
                movie matrix at Q = 50 and 256 with an fp32 and a bf16
                corpus, and an exact-tie case that must give identical ids
                (plus D = 37, k = 32 edges in fp32 and bf16, off the path;
                one Q = 50 call split by the profiler into pass 1, the merge
                pass and the wrapper's ops; the library yardstick timed with
                the normalisation outside and inside the window);
                40,000 reviews of 12 ids over a 4096 x 64 table pooled, then
                a (64, 2) head and argmax, without and with per-id weights,
                in fp32 and bf16; a 65,536 x 512 table pooled in 16 shards
                of 4096 rows (8192 ids, 256 segments, -1 ids and segments
                -1 and 256 dropped) summing to the dense pool; each kernel
                launched exactly once per call, held to its plain version,
                timed beside it, its bound and the library call, with items
                per second per batch; one sentiment and one shard pool call
                split by the profiler (one device operation each); off the
                counted path, pools with shuffled segments, a shard no id
                reaches and a call whose untouched segments lie in the
                freed block of a full one (exactly 0);
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
  6. chunked  — the same yi-9b and requests with chunk_prefill=256 at chunk
                budgets 1 and 2: all ok, a balanced free list, the kernels
                on every layer of every one-shot prefill call and step, the
                chunk calls (the plain masked attention) counted from the
                telemetry hub, prefill ms a call and a chunk, TTFT; the
                one-shot tokens (a flip only below BF16_FLIP_MARGIN); one
                chunk call profiled;
  7. cluster  — four drives (ClusterEngine, 8 slots each, 256-row chunks)
                over the one yi-9b: CLUSTER_REQUESTS = 16 requests (prompts
                16..700, max_new 32; 32 before the train phases came) served
                serially give one engine's tokens with balanced
                free lists, a merged ledger equal to the drives' plus the
                spill ledger, and peak memory under the weights plus four
                pools plus CLUSTER_MEM_MARGIN; data_local over 4 shards with
                drive 1 crashed at tick 3 (16 requests of 16 tokens):
                conservation and the fault-free tokens; 8 requests of 8
                tokens serially and on worker threads (dispatch timeout and
                watchdog sized from the serial run's longest tick): the same
                tokens, no SUSPECT drive, workers joined, with the host cost
                of one small CUDA op from one and from four threads; then
                16 requests of open-loop bursty traffic at 1.2x the serial
                run's service rate, FIFO and EDF: TTFT, TPOT, SLO
                attainment, conservation.  Requests/s and the Table I
                energy per query of the paper's server model are printed;
  8. strip    — yi-9b at 8 layers in float32 on kv_layout="strip" against
                "paged", on the same 16 requests: the isp-decode kernel on
                every layer of every strip step, and the same tokens (a
                flip passes only at a printed top-2 logit margin < 1e-3);
                then chunk_prefill=128 on the paged layout, cold and
                prewarmed: the same tokens, and the prewarmed engine books
                its first launches before the first request;
  9. gemma3   — full-width, full-depth gemma3-12b in bfloat16 (40 window
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
  10. plan    — the same gemma3-12b (before it is freed) through a sharding
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
                end;
  11. llama4  — llama4-scout-17b-a16e in bfloat16 at every published width
                (d_model 5120, 40/8 heads of dh 128, 16 experts of d_ff 8192
                top-1 + one shared, vocabulary 202,048), its depth cut from
                48 to LLAMA4_LAYERS = 8 layers to fit one card: 8 requests
                (prompts 16..700, max_new=32) through the same engine; all
                ok, a balanced free list, flash and paged decode on every
                layer of every prefill call and step, no isp decode;
                k_block=1 gives identical tokens, chunk_prefill=256 flips
                only below BF16_FLIP_MARGIN; one decode tick profiled; layer
                0's MoE on 64 real hidden rows on the card in bf16 against
                the same function on the CPU in fp32 (MOE_REL_FRO,
                MOE_MAX_OF_RMS); one layer's dense MoE timed at 8 rows and
                at a prompt's rows beside its bytes bound and grouped
                dispatch's;
  12. musicgen — musicgen-large whole (48 layers, MHA at dh 64, tied
                embeddings) in bfloat16: AudioFrontendStub on a seeded
                waveform, prefill_fn on its embeddings, the caches spliced
                into a paged pool, 16 decode_fn steps on tokens (flash 48
                launches, paged decode 48 a step; the last token equals a
                one-shot prefill's but at a near-tie); then 8 token requests
                through the engine, k_block 8 and 1 (identical tokens); one
                decode tick profiled;
  13. deepseek — deepseek-v2-236b in bfloat16 at every published width
                (d_model 5120, 128 MLA heads, q rank 1536, kv rank 512, qk
                128 + 64, v 128, 160 experts of d_ff 1536 top-6 + 2 shared,
                vocabulary 102,400), its depth cut from 60 to
                DEEPSEEK_LAYERS = 4 layers: 8 requests (prompts 16..700,
                max_new=32) through ServeEngine(num_slots=8, max_len=1024,
                k_block=8) on strips (the compressed MLA cache); all ok,
                flash on every layer of every prefill call, no decode
                kernel (the absorbed decode is plain tensor code, as in the
                reference); k_block=1 gives identical tokens; one decode
                tick profiled; KV bytes a token compressed against
                unabsorbed; layer 0's absorbed decode step in fp32 against
                the unabsorbed computation (MLA_REL_TOL);
  14. hymba   — hymba-1.5b whole (32 hybrid layers: window-1024 GQA at 25
                heads over 5 of dh 64 beside Mamba) in bfloat16: 8 requests
                as above in exact-length buckets on strips; all ok, flash on
                all 32 layers of every prefill call, isp decode on all 32
                rings of every step; k_block=1 gives identical tokens; one
                decode tick profiled;
  15. xlstm   — xlstm-125m whole (6 mLSTM + 6 sLSTM blocks, no attention)
                in bfloat16: 8 requests as above; all ok, no kernel
                launched, every weight and cache on the card; k_block=1
                gives identical tokens; one sLSTM layer's sequential
                prefill timed;
  16. train   — yi-9b in bfloat16 at every published width, its depth cut
                from 48 to TRAIN_LAYERS = 8 layers (1.908 B parameters),
                AdamW moments in float32, remat "dots": 8 steps of 2 x 4096
                synthetic tokens through train_loop.train (no checkpoint);
                every loss and grad norm finite; flash launched 16 times a
                step (8 layers, forward and remat recompute) and no other
                kernel; median step, tokens/s, model FLOPs against the bf16
                peak, peak memory; one step profiled into the flash kernel,
                the plain attention backward, AdamW, GEMMs and the rest,
                with the idle share; four steps on one repeated batch lower
                its loss (a wrong but finite gradient would not);
  17. elastic — launch.elastic.supervise runs the train CLI on xlstm-125m
                (6 steps of 4 x 256, a checkpoint every 2) with
                REPRO_FAIL_AT_STEP=3 and a marker: it dies once (exit 42),
                resumes from the last committed checkpoint and finishes at
                6; its final checkpoint equals an uninterrupted in-process
                run from the same seed bit for bit.
The kernel phase also holds flash's log-sum-exp output (lse, what the
training path's backward reads) to the plain version at the train shape
(B=2, S=4096, H=32, Hkv=4, dh 128, causal, bf16 and fp32; LSE_TOL), the
differentiable op's dq/dk/dv with the kernel's forward against the plain
forward's through the plain backward (GRAD_REL_TOL), and lse at the edge
head shapes, where rows that see no key must give out 0, lse +inf and
dq 0; the kernel with lse is timed at the train shape beside SDPA's
forward and one layer's plain backward.
Each path's launch counters are set to 0 just before it runs and read just
after; the launches that hold a kernel against its plain version do not
count.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  Exits non-zero without a CUDA device.

    python3 chip_smoke.py --times

times only isp_gather and isp_gather_pool at their path shapes (and isp
decode on the rings) under both flushes, after holding each to its plain
version, and prints them as one JSON line.  The wrappers' contracts are
those of every tree since the kernels were ported, so a copy of this
script in another checkout times that tree's kernels: two trees can run
in turns in one call.

    python3 chip_smoke.py --flash-times

times flash at its six serve paths' shapes without lse (the wrapper's
contract before and after lse), one JSON line, for the same use.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import re
import math
import subprocess
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SEED = 0
HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet
# dense peaks (H100 SXM data sheet): bf16 and TF32 on the tensor cores,
# fp32 on the CUDA cores
PEAK_FLOPS = {torch.bfloat16: 989e12, "tf32": 495e12, torch.float32: 67e12}
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
# topk_similarity: a score is a cosine (|s| <= 1), summed in another order by
# the kernel (three tensor-core products, 3xTF32 or bf16x3, each within
# ~2e-7 of fp64 at D = 128: tests/test_torch_topk_numerics.py) and cuBLAS;
# that moves it by a few fp32 ulps of 1, far below 1e-5.  isp_gather_pool:
# see check_pool (fp32 atomics sum in an order that changes from run to
# run).
TOPK_ATOL = 1e-5
# chunked against one-shot prefill in bf16: the one-shot path runs the
# flash kernel (bf16 probabilities into the value product), the chunked
# path the fp32 plain masked attention, each rounding to bf16 into a
# residual stream of 48 layers.  One bf16 rounding of a unit-scale value
# is up to 2**-8; 48 layers of independent roundings walk sqrt(48) ~ 7
# times that, ~0.03 on a logit of this unit-scale random model, so a token
# may flip only where the two best logits lie closer than 4x that.
BF16_FLIP_MARGIN = 0.125
# (H, Hkv, dh) of the other model families on the card: llama4-scout
# (group 5, so 3 of paged decode's 8 head lanes idle), musicgen-large (MHA
# at dh 64), starcoder2-15b (group 12: a second head chunk half empty),
# llama3-405b (group 16), chameleon-34b (group 8 at d_model 8192) and
# hymba-1.5b (25 heads over 5 at dh 64, group 5; its window of 1024 is in
# the flash and isp decode rows)
NEW_HEADS = ((40, 8, 128), (32, 32, 64), (48, 4, 128), (128, 8, 128),
             (64, 8, 128), (25, 5, 64))
# deepseek-v2's MLA prefill: (H, Hkv, q/k head dim, v head dim) through
# the flash kernel's (192, 128) instantiation
MLA_HEADS = (128, 128, 192, 128)
# flash's serve paths: (B, S, H, Hkv, dh, dv, window)
FLASH_PATHS = (
    ("yi-9b serve", (8, 704, 32, 4, 128, 128, None)),
    ("gemma3-12b serve", (8, 1536, 16, 8, 240, 240, 1024)),
    ("llama4-scout serve", (8, 704, 40, 8, 128, 128, None)),
    ("musicgen-large serve", (8, 704, 32, 32, 64, 64, None)),
    ("deepseek-v2 serve", (8, 704) + MLA_HEADS + (None,)),
    ("hymba serve", (8, 704, 25, 5, 64, 64, 1024)))
# the train phase: yi-9b at every published width, its depth cut from 48
# to 8 layers (1.908 B parameters: with bf16 weights and gradients and
# fp32 AdamW moments, 22.9 GB; all 48 layers would need 106 GB), Yi's 4K
# pretraining context, global batch 2, 8 steps
TRAIN_LAYERS, TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = 8, 4096, 2, 8
# flash at the train shape: (B, S, H, Hkv, dh) and yi-9b's attn_chunk
TRAIN_FLASH = (TRAIN_BATCH, TRAIN_SEQ, 32, 4, 128)
TRAIN_CHUNK = 512
# lse, kernel against plain version: both sum the same fp32 scores (exact
# products of the inputs) in other orders, ~1e-6 of an lse of O(10); a key
# masked wrongly moves a row's lse by log(1 + p_key), >= ~1e-4 here
LSE_TOL = dict(atol=1e-4, rtol=1e-5)
# dq/dk/dv through the plain backward with the kernel's forward against
# the plain forward's, as a share of each gradient's max |value|: fp32,
# the same math on outputs within 1e-6 (1e-4); bf16, the kernel's output
# (bf16 probabilities into the value product, rounded to bf16) enters
# delta = rowsum(dout * out) and both sides round dq/dk/dv to bf16, each
# up to 2**-8 of a value, summed over a 4096-key row: 5e-2
GRAD_REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}


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


def l2_flushes(dev):
    """The two L2 flushes a timed run may follow: ``dirty`` writes a 256 MB
    buffer (the flush every ``ms`` is taken after) and leaves the 50 MB L2
    full of dirty lines, which a timed kernel may have to write back before
    its own lines fit; ``clean`` writes the same and then reads a second
    256 MB buffer, so that the L2 holds clean lines only (``ms_clean_l2``)."""
    wbuf = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    rbuf = torch.zeros(64 * 2**20, dtype=torch.int32, device=dev)

    def dirty():
        wbuf.zero_()

    def clean():
        wbuf.zero_()
        rbuf.sum()
    return dirty, clean


def launch_floor(flushes) -> tuple:
    """The time of one empty launch under the timing harness, after each
    flush: the yardstick of a call whose byte bound lies far below it."""
    ms = tuple(time_ms(lambda: torch.cuda._sleep(0), f) for f in flushes)
    log(f"[kernels] launch floor (one empty launch, torch.cuda._sleep(0)): "
        f"{ms[0]:.4f} ms after the dirty flush, {ms[1]:.4f} ms after the "
        f"clean one")
    return ms


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
        # n = 1 (one row over a few blocks), with and without weights
        idx = ids(1, off, off + v_loc)
        assert torch.equal(ig.isp_gather(shard, idx, shard_offset=off),
                           ig.isp_gather_ref(shard, idx, shard_offset=off))
        w1 = torch.randn(1, generator=gen, device=dev)
        got = ig.isp_gather(shard, idx, shard_offset=off, weights=w1)
        want = ig.isp_gather_ref(shard, idx, shard_offset=off, weights=w1)
        assert (torch.equal(got, want) if dtype == torch.float32
                else bf16_ulps(got, want) <= 1), "isp_gather n=1"
        # D = 1048: 131 16-byte vectors a row in bf16, 262 in fp32, which no
        # tile of the plan divides, at the plan's 1, 2 and 4 vectors a
        # thread (n = 1, 100, 8192), weighted and -1 pads
        mid = torch.randn(4096, 1048, generator=gen, device=dev).to(dtype)
        for n in (1, 100, 8192):
            idx = ids(n, -1, 4200)
            assert torch.equal(ig.isp_gather(mid, idx, shard_offset=100),
                               ig.isp_gather_ref(mid, idx, shard_offset=100))
            wn = torch.randn(n, generator=gen, device=dev)
            got = ig.isp_gather(mid, idx, shard_offset=100, weights=wn)
            want = ig.isp_gather_ref(mid, idx, shard_offset=100, weights=wn)
            assert (torch.equal(got, want) if dtype == torch.float32
                    else bf16_ulps(got, want) <= 1), f"isp_gather D=1048 {n}"
        # n = 1001 (no block of 8 ids divides it), D = 3841 (rows not
        # 16-byte aligned take the scalar path)
        odd = torch.randn(4096, 3841, generator=gen, device=dev).to(dtype)
        idx = ids(1001, -1, 4200)
        got = ig.isp_gather(odd, idx, shard_offset=100)
        assert torch.equal(got, ig.isp_gather_ref(odd, idx,
                                                  shard_offset=100))
        torch.cuda.synchronize()
        exact = 'exact' if dtype == torch.float32 else '<= 1 bf16 ulp'
        log(f"[kernels] isp_gather {dtype}: exact at gemma3's table (8 and "
            f"8192 ids), four-shard weighted {exact}, n=1 exact and "
            f"weighted {exact}, D=1048 at n=1, 100, 8192 exact and weighted "
            f"{exact}, n=1001 D=3841 exact")
        del table, shard, odd, mid
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
    window (7), window 1024.  "hymba ring": the same tracks at hymba-1.5b's
    heads (25 over 5 at dh 64)."""
    if layout == "shared":
        B, H, Hkv, dh, S, window = 8, 32, 4, 128, 1024, None
        pos = torch.arange(S, dtype=torch.int32)
        kpos = torch.where(pos < S // 2, pos, -1)
        cur = torch.tensor(S // 2 - 1, dtype=torch.int32)
    else:
        B, S, window = 8, 1024, 1024
        H, Hkv, dh = (16, 8, 240) if layout == "ring" else (25, 5, 64)
        now = [1500, 2047, 1023, 0, 700, 1024, 1999, 50]
        kpos = ring_tracks(now, S, empty=(3,))
        cur = torch.tensor(now, dtype=torch.int32)
    r = lambda *s: torch.randn(*s, generator=gen).to(dev, dtype)
    q, k, v = r(B, H, dh), r(B, S, Hkv, dh), r(B, S, Hkv, dh)
    kpos, cur = kpos.to(dev), cur.to(dev)
    from repro_torch.kernels import ref
    valid = int(ref._decode_valid_mask(kpos, cur, window).expand(B, S).sum())
    return (q, k, v, kpos, cur), window, valid


def paged_edges(dev, gen):
    """Split-K edges of paged_decode at both serve shapes and at
    NEW_HEADS, in both dtypes, against the plain version: slots whose
    lengths fill whole split spans (and one key more or less), an empty
    slot, a one-key slot, a full table; then a window whose edge falls
    inside a span."""
    from repro_torch.kernels import paged_decode as pd
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for H, Hkv, dh, maxp, window in ((32, 4, 128, 64, 100),
                                     (16, 8, 240, 128, 300)) + tuple(
            (H, Hkv, dh, 64, 100) for H, Hkv, dh in NEW_HEADS):
        span, n_split = pd.split_plan(8, Hkv, maxp, n_sms)
        keys = span * 16
        lengths = tuple(min(n, maxp * 16) for n in (
            keys, 2 * keys, keys + 1, keys - 1, 0, 1, maxp * 16,
            3 * keys + 5))
        edges = sorted({n - window for n in lengths if n > window})
        assert any(e % keys for e in edges), "no window edge inside a span"
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            args, _ = decode_case(dtype, dev, gen, H=H, Hkv=Hkv, dh=dh,
                                  maxp=maxp, lengths=lengths)
            for w in (None, window):
                got = pd.paged_decode_partial(*args, window=w)
                want = pd.paged_decode_partial_ref(*args, window=w)
                torch.cuda.synchronize()
                errs[dtype, w] = max_err(got, want, dtype)
                assert float(got[0][4].abs().max()) == 0.0, \
                    "empty slot: acc != 0"
                assert float(got[1][4].abs().max()) == 0.0, \
                    "empty slot: l != 0"
                assert bool((got[2][4] == -1e30).all()), \
                    "empty slot: m != -1e30"
        log(f"[kernels] paged_decode edges H={H} Hkv={Hkv} dh={dh} (group "
            f"{H // Hkv}): {n_split} splits of "
            f"{span} pages, lengths {list(lengths)}, window {window} (first "
            f"visible keys {edges}): max abs err " + ", ".join(
                f"{dname(d)} w={w} {e:.3g}" for (d, w), e in errs.items()))


def isp_edges(dev, gen):
    """Split-K edges of isp_decode at both strip shapes, in both dtypes,
    with and without a window, against the plain version.  Per-slot tracks
    kpos (8, 1024): slots whose valid rows fill whole spans (and one row
    more or less), an empty slot, a one-row slot (its later spans empty), a
    full strip, a ring whose valid rows wrap across a span edge; the same
    tracks on k/v views whose rows are not 16-byte aligned (the kernel's
    element-load branch); and the shared track kpos (1024,) with its first
    span empty and its valid rows ending inside a span."""
    from repro_torch.kernels import isp_decode as isp
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    B, S = 8, 1024
    for H, Hkv, dh in ((32, 4, 128), (16, 8, 240), (25, 5, 64)):
        span, n_split = isp.split_plan(B, Hkv, S, n_sms)
        lengths = (span, 2 * span, span + 1, span - 1, 0, 1, S)
        kpos = torch.full((B, S), -1, dtype=torch.int32)
        cur = torch.zeros(B, dtype=torch.int32)
        for b, n in enumerate(lengths):
            kpos[b, :n] = torch.arange(n, dtype=torch.int32)
            cur[b] = max(n - 1, 0)
        wrap = S + span + span // 2          # row wrap % S lies in a span
        kpos[7] = ring_tracks([wrap], S)[0]
        cur[7] = wrap
        assert 0 < (wrap % S) % span and kpos[7, wrap % S + 1] == wrap - S + 1
        shared = torch.full((S,), -1, dtype=torch.int32)
        lo, hi = span + 3, 3 * span + span // 2
        shared[lo:hi] = torch.arange(lo, hi, dtype=torch.int32)
        kpos, cur, shared = kpos.to(dev), cur.to(dev), shared.to(dev)
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            r = lambda *s: torch.randn(*s, generator=gen).to(dev, dtype)
            q = r(B, H, dh)
            k, v = r(B, S, Hkv, dh), r(B, S, Hkv, dh)
            # rows dh + 1 elements apart, one element off: not 16-byte aligned
            ku, vu = (r(B, S, Hkv, dh + 1)[..., 1:] for _ in range(2))
            cases = {"rings": (q, k, v, kpos, cur),
                     "unaligned": (q, ku, vu, kpos, cur),
                     "shared": (q, k, v, shared,
                                torch.tensor(hi - 1, dtype=torch.int32,
                                             device=dev))}
            for (name, args), w in ((c, w) for c in cases.items()
                                    for w in (None, 300)):
                got = isp.decode_partial(*args, window=w)
                want = isp.decode_partial_ref(*args, window=w)
                torch.cuda.synchronize()
                errs[name, dtype, w] = max_err(got, want, dtype)
                if name != "shared":
                    assert float(got[0][4].abs().max()) == 0.0, \
                        "empty slot: acc != 0"
                    assert float(got[1][4].abs().max()) == 0.0, \
                        "empty slot: l != 0"
                    assert bool((got[2][4] == -1e30).all()), \
                        "empty slot: m != -1e30"
        log(f"[kernels] isp_decode edges H={H} Hkv={Hkv} dh={dh}: {n_split} "
            f"splits of {span} "
            f"rows, per-slot valid rows {list(lengths)} and a ring wrapped "
            f"at row {wrap % S}, shared rows [{lo}, {hi}), windows None and "
            f"300: max abs err " + ", ".join(
                f"{n} {dname(d)} w={w} {e:.3g}" for (n, d, w), e in
                errs.items()))


def flash_edges(dev, gen):
    """flash_attention edges at both serve head dims, at NEW_HEADS and at
    MLA's qk 192 / v 128 (MLA_HEADS: a wrong v stride or output width
    shows only where the two dims differ), in both dtypes, against the
    plain version: Sq not a multiple of the 64-row q tile, q_offset > 0
    with and without a window whose edge crosses the key tiles, and one
    query row over a long cache.  Then the pairs the kernel has no
    instantiation for raise."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    cases = ((100, 100, 0), (65, 200, 135), (1, 300, 299))
    for H, Hkv, dh, dv, windows in ((32, 4, 128, 128, (None, 48)),
                                    (16, 8, 240, 240, (1024, 48)),
                                    MLA_HEADS + ((None, 48),)) + tuple(
            (H, Hkv, dh, dh, (None, 48)) for H, Hkv, dh in NEW_HEADS):
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            r = lambda *s: torch.randn(*s, generator=gen).to(dev, dtype)
            for (Sq, Skv, qoff), w in ((c, w) for c in cases
                                       for w in windows):
                q, k, v = r(2, Sq, H, dh), r(2, Skv, Hkv, dh), \
                    r(2, Skv, Hkv, dv)
                got = fa.flash_attention(q, k, v, window=w, q_offset=qoff)
                want = ref.chunked_attention(q, k, v, window=w,
                                             q_offset=qoff)
                torch.cuda.synchronize()
                assert got.shape == (2, Sq, H, dv), got.shape
                errs[dtype] = max(errs.get(dtype, 0.0),
                                  max_err([got], [want], dtype))
        log(f"[kernels] flash_attention edges H={H} Hkv={Hkv} dh={dh} "
            f"dv={dv} (group {H // Hkv}) windows {windows} "
            f"(Sq, Skv, q_offset) in {cases}: max abs err fp32 "
            f"{errs[torch.float32]:.3g}, bf16 {errs[torch.bfloat16]:.3g}")
    for dh, dv in ((192, 192), (128, 192), (192, 64)):
        q, k = (torch.zeros(1, 8, 4, dh, device=dev) for _ in range(2))
        try:
            fa.flash_attention(q, k, torch.zeros(1, 8, 4, dv, device=dev))
        except ValueError:
            continue
        raise AssertionError(f"flash_attention took (dh, dv) = {(dh, dv)}")
    log("[kernels] flash_attention refuses (dh, dv) in (192, 192), "
        "(128, 192), (192, 64)")


def lse_err(got, want, mask=None) -> float:
    """Max abs error of a kernel's lse against the plain version's, held to
    LSE_TOL, over the rows in ``mask`` (all without one)."""
    if mask is not None:
        got, want = got[:, mask], want[:, mask]
    assert torch.isfinite(got).all(), "kernel lse non-finite on a live row"
    torch.testing.assert_close(got, want, **LSE_TOL)
    return float((got - want).abs().max())


def grad_rel_err(got, want, dtype, what) -> float:
    """Max over dq, dk, dv of max |got - want| / max |want|, held to
    GRAD_REL_TOL."""
    worst = 0.0
    for g, w, n in zip(got, want, "qkv"):
        g, w = g.float(), w.float()
        assert torch.isfinite(g).all(), f"{what}: d{n} non-finite"
        e = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
        assert e <= GRAD_REL_TOL[dtype], (what, n, e)
        worst = max(worst, e)
    return worst


def flash_train_row(dev, gen, flush):
    """Flash with lse at the train phase's shape (TRAIN_FLASH: yi-9b at
    4096 rows, causal), bf16 and fp32: out and lse against the plain
    ``chunked_attention(return_lse=True)``; the differentiable op's
    dq/dk/dv (the kernel's forward) against the plain forward's, both
    through the plain backward; then timed with lse beside its bound, the
    plain version, SDPA's forward and the kernel without lse, and one
    layer's plain backward timed."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    B, S, H, Hkv, dh = TRAIN_FLASH
    ck = dict(q_chunk=TRAIN_CHUNK, kv_chunk=TRAIN_CHUNK)
    errs, lerrs, gerrs = {}, {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        r = lambda *s: torch.randn(*s, generator=gen).to(dev, dtype)
        q, k, v, dout = r(B, S, H, dh), r(B, S, Hkv, dh), r(B, S, Hkv, dh), \
            r(B, S, H, dh)
        out, lse = fa.flash_attention(q, k, v, return_lse=True)
        want, wlse = ref.chunked_attention(q, k, v, return_lse=True, **ck)
        torch.cuda.synchronize()
        assert lse.dtype == torch.float32 and lse.shape == (B, S, H)
        errs[dtype] = max_err([out], [want], dtype)
        lerrs[dtype] = lse_err(lse, wlse)
        qq, kk, vv = (t.clone().requires_grad_(True) for t in (q, k, v))
        got = torch.autograd.grad(ops.flash_attention(qq, kk, vv, **ck),
                                  (qq, kk, vv), dout)
        plain = ref.flash_attention_bwd(q, k, v, want, wlse, dout, **ck)
        gerrs[dtype] = grad_rel_err(got, plain, dtype, "train shape")
        log(f"[kernels] flash_attention yi-9b train {dtype} (B={B} S={S} "
            f"H={H} Hkv={Hkv} dh={dh}, with lse): out max abs err "
            f"{errs[dtype]:.3g}, lse {lerrs[dtype]:.3g}; dq/dk/dv with the "
            f"kernel's forward vs the plain forward's, max err / max |grad| "
            f"{gerrs[dtype]:.3g} (bound {GRAD_REL_TOL[dtype]})")
        del qq, kk, vv, got, plain, want, wlse, out, lse
    # q/k/v/dout: the bf16 inputs of the last iteration
    pairs = S * (S + 1) // 2
    nbytes = (q.numel() + k.numel() + v.numel() + B * S * H * dh) * 2 \
        + B * S * H * 4
    bound_ms, bound_by = bound(nbytes, 4 * dh * pairs * B * H,
                               torch.bfloat16)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    row = dict(
        name="flash_attention", kernel="flash_attention", path="yi-9b train",
        route="cuda", source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:77", dtype="bfloat16",
        shape=f"B={B} S={S} H={H} Hkv={Hkv} dh={dh} dv={dh} causal, with lse",
        max_abs_err=errs[torch.bfloat16],
        max_abs_err_fp32=errs[torch.float32],
        lse_max_abs_err=lerrs[torch.bfloat16],
        lse_max_abs_err_fp32=lerrs[torch.float32],
        grad_rel_err=gerrs[torch.bfloat16],
        grad_rel_err_fp32=gerrs[torch.float32],
        ms=time_ms(lambda: fa.flash_attention(q, k, v, return_lse=True),
                   flush),
        plain_ms=time_ms(lambda: ref.chunked_attention(
            q, k, v, return_lse=True, **ck), flush),
        bound_ms=bound_ms, bound_by=bound_by,
        library_ms=time_ms(lambda: torch.nn.functional.
                           scaled_dot_product_attention(
                               qt, kt, vt, is_causal=True, enable_gqa=True),
                           flush),
        ms_no_lse=time_ms(lambda: fa.flash_attention(q, k, v), flush))
    out, lse = fa.flash_attention(q, k, v, return_lse=True)
    row["plain_bwd_ms"] = time_ms(lambda: ref.flash_attention_bwd(
        q, k, v, out, lse, dout, **ck), flush)
    log(f"[kernels] flash_attention yi-9b train: with lse {row['ms']:.4f} "
        f"ms, without {row['ms_no_lse']:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}), plain forward {row['plain_ms']:.4f} ms, SDPA "
        f"forward {row['library_ms']:.4f} ms; one layer's plain backward "
        f"(bf16 inputs, fp32 math) {row['plain_bwd_ms']:.4f} ms")
    return row


def flash_lse_edges(dev, gen):
    """Flash with lse at the edge head shapes (both serve head dims, MLA's
    qk 192 / v 128, NEW_HEADS), both dtypes: Sq not a multiple of the q
    tile, a window edge crossing the key tiles with q_offset, one row over
    a long cache, rows of which some and rows of which all see no key
    (q_offset past the window's reach).  Live rows: out and lse against
    the plain version.  Rows with no key: out 0 and lse +inf from the
    kernel (the plain version keeps the reference's -1e30 and its mean of
    visited values there), and the plain backward fed the kernel's lse
    gives them dq = 0 and finite dk/dv."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    cases = ((100, 100, 0, None), (65, 200, 135, 48), (1, 300, 299, None),
             (16, 40, 36, 8), (16, 40, 60, 8))
    heads = ((32, 4, 128, 128), (16, 8, 240, 240), MLA_HEADS) + tuple(
        (H, Hkv, dh, dh) for H, Hkv, dh in NEW_HEADS)
    n_empty = 0
    for H, Hkv, dh, dv in heads:
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            r = lambda *s: torch.randn(*s, generator=gen).to(dev, dtype)
            for Sq, Skv, qoff, w in cases:
                q, k, v = r(2, Sq, H, dh), r(2, Skv, Hkv, dh), \
                    r(2, Skv, Hkv, dv)
                out, lse = fa.flash_attention(q, k, v, window=w,
                                              q_offset=qoff, return_lse=True)
                want, wlse = ref.chunked_attention(q, k, v, window=w,
                                                   q_offset=qoff,
                                                   return_lse=True)
                torch.cuda.synchronize()
                qpos = qoff + torch.arange(Sq, device=dev)
                lo = torch.zeros_like(qpos) if w is None \
                    else torch.clamp(qpos - w + 1, min=0)
                live = lo <= torch.clamp(qpos, max=Skv - 1)
                e = le = 0.0
                if bool(live.any()):
                    e = max_err([out[:, live]], [want[:, live]], dtype)
                    le = lse_err(lse, wlse, live)
                errs[dtype] = max(errs.get(dtype, (0.0, 0.0))[0], e), \
                    max(errs.get(dtype, (0.0, 0.0))[1], le)
                dead = ~live
                if bool(dead.any()):
                    n_empty += int(dead.sum())
                    assert float(out[:, dead].float().abs().max()) == 0.0
                    assert bool(torch.isinf(lse[:, dead]).all()) and \
                        bool((lse[:, dead] > 0).all()), "empty rows: lse"
                    dq, dk, dvv = ref.flash_attention_bwd(
                        q, k, v, out, lse, r(2, Sq, H, dv), window=w,
                        q_offset=qoff)
                    assert float(dq[:, dead].float().abs().max()) == 0.0
                    assert all(bool(torch.isfinite(t).all())
                               for t in (dq, dk, dvv))
        log(f"[kernels] flash_attention lse edges H={H} Hkv={Hkv} dh={dh} "
            f"dv={dv} (Sq, Skv, q_offset, window) in {cases}: live rows max "
            f"abs err out/lse fp32 {errs[torch.float32][0]:.3g}/"
            f"{errs[torch.float32][1]:.3g}, bf16 "
            f"{errs[torch.bfloat16][0]:.3g}/{errs[torch.bfloat16][1]:.3g}")
    assert n_empty > 0
    log(f"[kernels] flash_attention lse edges: {n_empty} (batch, row) "
        f"pairs with no key gave out 0, lse +inf and dq 0")


def flash_times_phase(dev) -> dict:
    """flash at its six serve paths' shapes in bf16, without lse (the
    contract of every tree since the kernel was ported), held to the
    plain version and timed after the dirty flush, for comparing trees in
    turns (``--flash-times``)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    gen = torch.Generator().manual_seed(SEED)
    flush = l2_flushes(dev)[0]
    out = {}
    for path, (B, S, H, Hkv, dh, dv, window) in FLASH_PATHS:
        r = lambda *s: torch.randn(*s, generator=gen).to(dev, torch.bfloat16)
        q, k, v = r(B, S, H, dh), r(B, S, Hkv, dh), r(B, S, Hkv, dv)
        max_err([fa.flash_attention(q, k, v, window=window)],
                [ref.chunked_attention(q, k, v, window=window)],
                torch.bfloat16)
        out[path] = time_ms(lambda: fa.flash_attention(q, k, v,
                                                       window=window), flush)
        log(f"[flash-times] {path}: {out[path]:.4f} ms")
    return out


def gather_rows(dev, flushes):
    """isp_gather at gemma3-12b's vocabulary table under the plan (offset
    0: the whole table is this rank's shard on the one-rank mesh), held to
    its plain version by gather_cases, then timed beside F.embedding under
    both flushes."""
    from repro_torch.kernels import isp_gather as ig
    rows = []
    for n, (table, idx, err, err32) in gather_cases(dev).items():
        V, D = table.shape
        idx64 = idx.long()
        nbytes = 2 * n * D * 2 + 4 * n          # rows read + written, ids
        bound_ms, bound_by = bound(nbytes, 0, torch.bfloat16)
        kern = lambda: ig.isp_gather(table, idx)   # noqa: E731
        lib = lambda: torch.nn.functional.embedding(idx64, table)  # noqa
        rows.append(dict(
            name="isp_gather", kernel="isp_gather", path="gemma3-12b plan",
            route="cuda", source="src/repro_torch/kernels/csrc/isp_gather.cu",
            replaces="src/repro/kernels/isp_gather.py:50",
            dtype="bfloat16", shape=f"table ({V}, {D}) offset 0, {n} ids "
            f"({'decode step' if n == 8 else 'prefill'})",
            max_abs_err=err, max_abs_err_fp32=err32, bytes=nbytes,
            ms=time_ms(kern, flushes[0]),
            ms_clean_l2=time_ms(kern, flushes[1]),
            plain_ms=time_ms(lambda: ig.isp_gather_ref(table, idx),
                             flushes[0]),
            bound_ms=bound_ms, bound_by=bound_by,
            library_ms=time_ms(lib, flushes[0]),
            library_ms_clean_l2=time_ms(lib, flushes[1])))
        if n > 8:     # the same bytes as one contiguous device copy
            src, dst = table[:n], torch.empty_like(table[:n])
            copy = lambda: dst.copy_(src)   # noqa: E731
            rows[-1].update(copy_ms=time_ms(copy, flushes[0]),
                            copy_ms_clean_l2=time_ms(copy, flushes[1]))
            log(f"[kernels] isp_gather prefill: the same bytes as one "
                f"contiguous copy_ {rows[-1]['copy_ms']:.4f} ms, clean L2 "
                f"{rows[-1]['copy_ms_clean_l2']:.4f} ms")
            del src, dst
        del table
    return rows


def paged_edge_timing(dev, gen, flush):
    """paged_decode at hymba-1.5b's heads (25 over 5 at dh 64), an edge off
    every serve path (hymba's window layers decode on rings): held to the
    plain version in both dtypes and timed beside it and its bound, logged
    but kept out of the kernels record (no path launches it)."""
    from repro_torch.kernels import paged_decode as pd
    kw = dict(H=25, Hkv=5, dh=64)
    for dtype in (torch.float32, torch.bfloat16):
        args, valid = decode_case(dtype, dev, gen, **kw)
        err = max_err(pd.paged_decode_partial(*args),
                      pd.paged_decode_partial_ref(*args), dtype)
    q, kp = args[0], args[1]
    B, H, dh = q.shape
    Hkv = kp.shape[2]
    nbytes = (q.numel() * 2 + 2 * valid * Hkv * dh * 2 + args[3].numel() * 4
              + B * 4 + B * H * dh * 4 + 2 * B * H * 4)
    bound_ms, bound_by = bound(nbytes, 4 * valid * H * dh, torch.bfloat16)
    ms = time_ms(lambda: pd.paged_decode_partial(*args), flush)
    plain = time_ms(lambda: pd.paged_decode_partial_ref(*args), flush)
    log(f"[kernels] paged_decode hymba heads (edge, off every path) B={B} "
        f"H={H} Hkv={Hkv} dh={dh} ({valid} valid keys): bf16 max abs err "
        f"{err:.3g}; kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}), library none")


def kernel_phase(dev):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import isp_decode as isp
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.kernels import ref
    gen = torch.Generator().manual_seed(SEED)
    flushes = l2_flushes(dev)
    flush = flushes[0]
    launch_floor(flushes)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []

    # -- paged decode: yi-9b (dh 128), gemma3-12b's global layers (dh 240),
    # llama4-scout (group 5) and musicgen-large (MHA, dh 64)
    for path, kw in (("yi-9b serve", {}),
                     ("gemma3-12b serve", dict(
                         H=16, Hkv=8, dh=240, maxp=128,
                         lengths=(2048, 1500, 16, 0, 1031, 1, 700, 1990))),
                     ("llama4-scout serve", dict(H=40, Hkv=8, dh=128)),
                     ("musicgen-large serve", dict(H=32, Hkv=32, dh=64))):
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

    paged_edges(dev, gen)
    paged_edge_timing(dev, gen, flush)

    # -- dense-strip decode: the Pallas layout (yi-9b's shapes, the strip
    # phase) and gemma3-12b's per-slot window rings
    for path, layout in (("yi-9b strip", "shared"),
                         ("gemma3-12b serve", "ring"),
                         ("hymba serve", "hymba ring")):
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            args, window, valid = strip_case(layout, dtype, dev, gen)
            got = isp.decode_partial(*args, window=window)
            want = isp.decode_partial_ref(*args, window=window)
            torch.cuda.synchronize()
            errs[dtype] = max_err(got, want, dtype)
            if layout != "shared":
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
        if layout != "shared":    # a bytes-bound row under the clean flush
            rows[-1]["ms_clean_l2"] = time_ms(
                lambda: isp.decode_partial(*args, window=window), flushes[1])
    isp_edges(dev, gen)

    # -- flash attention: yi-9b's prefill (dh 128, causal), gemma3-12b's
    # window layers (dh 240, window 1024), llama4-scout's and
    # musicgen-large's prefill, deepseek-v2's MLA prefill (qk 192 / v 128)
    # and hymba-1.5b's window layers (25 heads over 5 at dh 64)
    for path, (B, S, H, Hkv, dh, dv, window) in FLASH_PATHS:
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            r = lambda *s: torch.randn(*s, generator=gen).to(dev, dtype)
            q, k, v = r(B, S, H, dh), r(B, S, Hkv, dh), r(B, S, Hkv, dv)
            got = fa.flash_attention(q, k, v, window=window)
            want = ref.chunked_attention(q, k, v, window=window)
            torch.cuda.synchronize()
            errs[dtype] = max_err([got], [want], dtype)
            log(f"[kernels] flash_attention {path} {dtype}: max abs err "
                f"{errs[dtype]:.3g}")
            del got, want
        # q/k/v are the bf16 inputs of the last iteration; (query, key)
        # pairs the causal mask and the window leave; q is read and the
        # output (B, S, H, dv) written once
        w = S if window is None else window
        pairs = sum(min(i + 1, w) for i in range(S))
        nbytes = (q.numel() + B * S * H * dv + k.numel() + v.numel()) * 2
        bound_ms, bound_by = bound(nbytes, 2 * (dh + dv) * pairs * B * H,
                                   torch.bfloat16)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        if window is None:
            lib = lambda: sdpa(qt, kt, vt, is_causal=True,  # noqa: E731
                               enable_gqa=True)
        else:
            i = torch.arange(S, device=dev)
            mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - w)
            lib = lambda: sdpa(qt, kt, vt, attn_mask=mask,  # noqa: E731
                               enable_gqa=True)
        try:
            library_ms = time_ms(lib, flush)
        except RuntimeError as e:      # no SDPA backend takes this shape
            library_ms = None
            log(f"[kernels] flash_attention {path}: library yardstick none, "
                f"scaled_dot_product_attention refused the shape: "
                f"{str(e).splitlines()[0][:200]}")
        rows.append(dict(
            name="flash_attention", kernel="flash_attention", path=path,
            route="cuda",
            source="src/repro_torch/kernels/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:77",
            dtype="bfloat16", shape=f"B={B} S={S} H={H} Hkv={Hkv} dh={dh} "
            f"dv={dv} causal window={window}",
            max_abs_err=errs[torch.bfloat16],
            max_abs_err_fp32=errs[torch.float32],
            ms=time_ms(lambda: fa.flash_attention(q, k, v, window=window),
                       flush),
            plain_ms=time_ms(lambda: ref.chunked_attention(
                q, k, v, window=window), flush),
            bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms))
        del q, k, v, qt, kt, vt, lib
    flash_edges(dev, gen)
    rows.append(flash_train_row(dev, gen, flush))
    flash_lse_edges(dev, gen)

    rows += gather_rows(dev, flushes)
    del flushes
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


def topk_breakdown(qs, corpus, k, flush, reps=25):
    """Device time of one topk_similarity call, kernel by kernel, from
    torch.profiler over ``reps`` calls (L2 flushed before each; the flush
    is left out): pass 1, the merge pass, and the PyTorch ops of the
    wrapper (the queries' normalisation)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import topk_similarity as tk
    tk.topk_similarity(qs, corpus, k)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush()
            tk.topk_similarity(qs, corpus, k)
        torch.cuda.synchronize()
    us = {"pass 1": 0.0, "merge": 0.0, "wrapper ops": 0.0}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or "FillFunctor<unsigned char>" \
                in e.name or e.name == "Command Buffer Full":
            continue
        part = "pass 1" if "topk_partial_kernel" in e.name else "merge" \
            if "topk_merge_kernel" in e.name else "wrapper ops"
        us[part] += (e.time_range.end - e.time_range.start) / reps
    if not us["pass 1"]:
        log("[apps] top-k breakdown: not measured (the profiler recorded no "
            "device events)")
        return
    total = sum(us.values())
    log(f"[apps] top-k breakdown, Q={qs.shape[0]} corpus "
        f"{dname(corpus.dtype)}: " + ", ".join(
            f"{n} {t / 1e3:.4f} ms ({t / total:.1%})" for n, t in us.items())
        + f" of {total / 1e3:.4f} ms device time a call")


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


def apps_data(dev):
    """The apps phase's inputs, drawn from one generator (seed SEED + 3) in
    a fixed order: the recommender's corpus and queries, the exact-tie
    case, the sentiment batch, the sharded pool.  The generator goes on to
    draw the edge cases."""
    rng = np.random.default_rng(SEED + 3)
    on = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # noqa
    a = SimpleNamespace(rng=rng, on=on)
    # recommender: the 58,000 x 128 movie matrix, top 10, Q = 50 and 256
    a.N, a.D, a.K = N, D, _ = 58_000, 128, 10
    a.corpus = {torch.float32: on(rng.normal(size=(N, D)).astype(np.float32))}
    a.corpus[torch.bfloat16] = a.corpus[torch.float32].to(torch.bfloat16)
    a.queries = {q: on(rng.normal(size=(q, D)).astype(np.float32))
                 for q in (50, 256)}
    uniq = sign_rows(rng, 1000)
    a.tie_c = on(np.concatenate([uniq, uniq[::-1], uniq, uniq[::-1]]))
    a.tie_q = on(np.concatenate([sign_rows(rng, 25),
                                 uniq[rng.choice(1000, 25, replace=False)]]))
    # sentiment: 40,000 reviews of 12 ids over a 4096 x 64 table, 2 classes
    a.R, a.L, a.V, a.E = R, L, V, E = 40_000, 12, 4096, 64
    a.s_idx = on(rng.integers(0, V, (R * L,)).astype(np.int32))
    a.s_seg = on(np.repeat(np.arange(R), L).astype(np.int32))
    a.s_tab = {torch.float32: on(rng.normal(size=(V, E)).astype(np.float32))}
    a.s_tab[torch.bfloat16] = a.s_tab[torch.float32].to(torch.bfloat16)
    a.s_w = on(rng.normal(size=(R * L,)).astype(np.float32))
    a.head = on(rng.normal(size=(E, 2)).astype(np.float32))
    a.sent_cases = {"fp32": (torch.float32, None),
                    "fp32 weighted": (torch.float32, a.s_w),
                    "bf16": (torch.bfloat16, None),
                    "bf16 weighted": (torch.bfloat16, a.s_w)}
    # sharded pool: 65,536 x 512 in 16 shards of 4096 rows, 8192 ids in 256
    # segments, with -1 ids and segment ids -1 and 256 that are dropped
    a.SV, a.SD, a.TP, a.SN, a.NSEG = SV, SD, TP, SN, NSEG = \
        65_536, 512, 16, 8192, 256
    a.p_tab = on(rng.normal(size=(SV, SD)).astype(np.float32))
    p_idx = rng.integers(0, SV, (SN,)).astype(np.int32)
    p_seg = rng.integers(0, NSEG, (SN,)).astype(np.int32)
    p_idx[::31], p_seg[1::29], p_seg[2::37] = -1, -1, NSEG
    a.p_idx, a.p_seg = on(p_idx), on(p_seg)
    a.vloc = vloc = SV // TP
    a.shards = [a.p_tab[i * vloc:(i + 1) * vloc] for i in range(TP)]
    return a


def pool_breakdown(label, call, flush, reps=25, want_ops=None):
    """Every device operation of one isp_gather_pool call by name and µs,
    from torch.profiler over ``reps`` calls (L2 flushed before each; the
    flush is left out).  With ``want_ops`` the call must make exactly that
    many a call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    flush()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
            torch.cuda.synchronize()
            flush()
        torch.cuda.synchronize()
    ops = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or "FillFunctor<unsigned char>" \
                in e.name or e.name == "Command Buffer Full":
            continue
        t, k = ops.get(e.name, (0.0, 0))
        ops[e.name] = (t + e.time_range.end - e.time_range.start, k + 1)
    if not ops:
        log(f"[apps] pool breakdown, {label}: not measured (the profiler "
            f"recorded no device events)")
        return None
    n_ops = sum(k for _, k in ops.values()) / reps
    log(f"[apps] pool breakdown, {label}: {n_ops:g} device operations a "
        f"call: " + ", ".join(f"{name[:70]} {t / reps:.2f} us x{k // reps}"
                              for name, (t, k) in ops.items()))
    if want_ops is not None:
        assert n_ops == want_ops, f"{label}: {n_ops} device operations a call"
    return n_ops


def pool_rows(a, errs, flushes, want_ops=None):
    """isp_gather_pool at the apps' five path shapes (the sentiment batch
    four ways, one shard of the sharded pool), timed under both flushes
    beside its plain version, its bound and F.embedding_bag where one call
    computes the same function; one sentiment fp32 call and one shard call
    split by the profiler."""
    from repro_torch.kernels import isp_gather as ig
    emb_bag = torch.nn.functional.embedding_bag
    R, L, E = a.R, a.L, a.E
    s_ids = a.s_idx.long().view(R, L)
    rows = []
    for name, (dt, w) in a.sent_cases.items():
        table = a.s_tab[dt]
        nbytes = (8 * R * L + (0 if w is None else 4 * R * L)
                  + int(torch.unique(a.s_idx).numel()) * E
                  * table.element_size() + R * E * 4)
        bound_ms, bound_by = bound(nbytes, 2 * R * L * E, torch.float32)
        kern = lambda: ig.isp_gather_pool(   # noqa: E731
            table, a.s_idx, a.s_seg, R, weights=w)
        lib = lib_clean = None
        if dt == torch.float32:
            pw = None if w is None else w.view(R, L)
            bag = lambda: emb_bag(s_ids, table, mode="sum",  # noqa: E731
                                  per_sample_weights=pw)
            lib, lib_clean = (time_ms(bag, f) for f in flushes)
        rows.append(dict(
            name="isp_gather_pool", kernel="isp_gather_pool", path="apps",
            route="cuda",
            source="src/repro_torch/kernels/csrc/isp_gather_pool.cu",
            replaces="src/repro/kernels/isp_gather.py:124",
            dtype=dname(dt),
            shape=f"sentiment {name}: table ({a.V}, {E}), {R} x {L} ids",
            max_abs_err=errs[name], ms=time_ms(kern, flushes[0]),
            ms_clean_l2=time_ms(kern, flushes[1]),
            plain_ms=time_ms(lambda: ig.isp_gather_pool_ref(
                table, a.s_idx, a.s_seg, R, weights=w), flushes[0]),
            bound_ms=bound_ms, bound_by=bound_by, library_ms=lib,
            library_ms_clean_l2=lib_clean, bytes=nbytes))
    # one shard of the sharded pool (shard 5: rows [20480, 24576))
    sh, off = a.shards[5], 5 * a.vloc
    inside = (a.p_idx >= off) & (a.p_idx < off + a.vloc)
    nbytes = (8 * a.SN + int(torch.unique(a.p_idx[inside]).numel()) * a.SD * 4
              + a.NSEG * a.SD * 4)
    bound_ms, bound_by = bound(nbytes, 2 * int(inside.sum()) * a.SD,
                               torch.float32)
    kern = lambda: ig.isp_gather_pool(sh, a.p_idx, a.p_seg,  # noqa: E731
                                      a.NSEG, shard_offset=off)
    rows.append(dict(
        name="isp_gather_pool", kernel="isp_gather_pool", path="apps",
        route="cuda", source="src/repro_torch/kernels/csrc/isp_gather_pool.cu",
        replaces="src/repro/kernels/isp_gather.py:124", dtype="float32",
        shape=f"sharded pool: shard ({a.vloc}, {a.SD}) offset {off} of "
        f"{a.TP}, {a.SN} ids ({int(inside.sum())} in the shard), {a.NSEG} "
        f"segments",
        max_abs_err=errs["sharded"], ms=time_ms(kern, flushes[0]),
        ms_clean_l2=time_ms(kern, flushes[1]),
        plain_ms=time_ms(lambda: ig.isp_gather_pool_ref(
            sh, a.p_idx, a.p_seg, a.NSEG, shard_offset=off), flushes[0]),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None, bytes=nbytes))
    pool_breakdown("sentiment fp32", lambda: ig.isp_gather_pool(
        a.s_tab[torch.float32], a.s_idx, a.s_seg, R), flushes[0],
        want_ops=want_ops)
    pool_breakdown("one shard", kern, flushes[0], want_ops=want_ops)
    return rows


def pool_edges(a):
    """isp_gather_pool off the counted path: an odd D (scalar loads) in
    bf16 with weights, an offset and segments -1 and 40, 41; the sentiment
    batch with its segments shuffled, so that every review's ids lie in
    many ranges; a shard that no id reaches (all zeros); and a call whose
    ids reach 100 of 40,000 segments, right after a call of the same size
    that leaves its non-zero output in the allocator's freed block: the
    other 39,900 segments must read exactly 0."""
    from repro_torch.kernels import isp_gather as ig
    rng, on = a.rng, a.on
    et = on(rng.normal(size=(300, 67)).astype(np.float32)).to(torch.bfloat16)
    ei = on(rng.integers(-5, 420, (999,)).astype(np.int32))
    es = on(rng.integers(-1, 42, (999,)).astype(np.int32))
    ew = on(rng.normal(size=(999,)).astype(np.float32))
    err = check_pool(ig.isp_gather_pool(et, ei, es, 40, shard_offset=100,
                                        weights=ew), et, ei, es, 40, 100, ew,
                     tag="edge pool")
    log(f"[apps] edge pool: bf16 (300, 67) offset 100, 999 ids, weighted, "
        f"segments -1..41 of 40: max abs err {err:.3g}")
    R = a.R
    shuffled = a.s_seg[torch.from_numpy(
        rng.permutation(R * a.L)).to(a.s_seg.device)].contiguous()
    for dt in (torch.float32, torch.bfloat16):
        t = a.s_tab[dt]
        err = check_pool(ig.isp_gather_pool(t, a.s_idx, shuffled, R,
                                            weights=a.s_w), t, a.s_idx,
                         shuffled, R, w=a.s_w, tag=f"unsorted {dname(dt)}")
        log(f"[apps] edge pool: sentiment {dname(dt)} weighted with its "
            f"segments shuffled across ranges: max abs err {err:.3g}")
    far = ig.isp_gather_pool(a.shards[0], a.p_idx, a.p_seg, a.NSEG,
                             shard_offset=a.SV)
    assert far.shape == (a.NSEG, a.SD) and not bool(far.any()), \
        "a shard no id reaches must pool to zeros"
    t = a.s_tab[torch.float32]
    few = (a.s_seg < 100).nonzero().flatten()
    idx, seg = a.s_idx[few].contiguous(), a.s_seg[few].contiguous()
    full = ig.isp_gather_pool(t, a.s_idx, a.s_seg, R)
    torch.cuda.synchronize()
    assert bool(full.any())
    block = full.data_ptr()
    del full
    got = ig.isp_gather_pool(t, idx, seg, R)
    torch.cuda.synchronize()
    assert got.data_ptr() == block, "the allocator did not reuse the block"
    assert not bool(got[100:].any()), "untouched segments must read 0"
    err = check_pool(got, t, idx, seg, R, tag="100 of 40000 segments")
    log(f"[apps] edge pool: a shard no id reaches pools to exact zeros; "
        f"ids in 100 of {R} segments, in the freed block of a full call: "
        f"the other {R - 100} segments exactly 0, max abs err {err:.3g}")


def apps_phase(dev):
    """The paper's NLP-query path (benchmarks/apps.py's two kernel apps and
    examples/isp_embedding_demo.py's pool) through ops.topk_similarity and
    ops.isp_gather_pool at the paper's batch sizes; the launch counters are
    set to 0 just before the path and read just after.  Returns the kernel
    rows and the path's launches."""
    from repro_torch.kernels import isp_gather as ig
    from repro_torch.kernels import ops
    from repro_torch.kernels import topk_similarity as tk
    flushes = l2_flushes(dev)
    flush = flushes[0]
    a = apps_data(dev)
    rng, on = a.rng, a.on
    N, D, K, corpus, queries = a.N, a.D, a.K, a.corpus, a.queries
    R, head = a.R, a.head

    def sentiment(dtype, w, pool=ops.isp_gather_pool):
        pooled = pool(a.s_tab[dtype], a.s_idx, a.s_seg, R, weights=w)
        logits = pooled @ head
        return pooled, logits, logits.argmax(-1)

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    rec = {(dt, q): ops.topk_similarity(queries[q], corpus[dt], K)
           for dt in corpus for q in queries}
    tie = ops.topk_similarity(a.tie_q, a.tie_c, K)
    sent = {name: sentiment(*case) for name, case in a.sent_cases.items()}
    parts = [ops.isp_gather_pool(a.shards[i], a.p_idx, a.p_seg, a.NSEG,
                                 shard_offset=i * a.vloc)
             for i in range(a.TP)]
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    want = {n: 0 for n in launches}
    want.update(topk_similarity=len(rec) + 1,
                isp_gather_pool=len(sent) + a.TP)
    assert launches == want, (launches, want)
    log(f"[apps] launches {launches}")

    errs = {}
    for (dt, q), got in rec.items():
        errs[dt, q] = check_topk(got, queries[q], corpus[dt], K,
                                 f"recommender Q={q} corpus {dname(dt)}")
    ws, wi = tk.topk_similarity_ref(a.tie_q, a.tie_c, K)
    assert torch.equal(tie[1], wi) and torch.equal(tie[0], ws), \
        "exact ties: the kernel's ids differ from the plain version's"
    assert int((ws[:, 1:] == ws[:, :-1]).sum()) > 50, "too few ties"
    log(f"[apps] exact ties (50 x 4000 rows, each repeated 4 times): "
        f"identical scores and ids, lower id first")
    for name, (dt, w) in a.sent_cases.items():
        pooled, logits, preds = sent[name]
        errs[name] = check_pool(pooled, a.s_tab[dt], a.s_idx, a.s_seg, R,
                                w=w, tag=f"sentiment {name}")
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
        check_pool(parts[i], a.shards[i], a.p_idx, a.p_seg, a.NSEG,
                   i * a.vloc, tag=f"shard {i}") for i in range(a.TP))
    keep = (a.p_idx >= 0) & (a.p_seg >= 0) & (a.p_seg < a.NSEG)
    dense = torch.zeros(a.NSEG, a.SD, device=dev).index_add_(
        0, a.p_seg[keep].long(), a.p_tab[a.p_idx[keep].long()])
    torch.testing.assert_close(sum(parts), dense, atol=1e-4, rtol=0)
    log(f"[apps] sharded pool: 16 shards sum to the dense pool (atol 1e-4), "
        f"{int((~keep).sum())} dropped ids/segments; max abs err per shard "
        f"{errs['sharded']:.3g}")
    # edge shapes, off the counted path: D = 37 (rows not 16-byte aligned:
    # element loads, columns past D zero), two query blocks and k = 32, in
    # fp32 and bf16
    eq = on(rng.normal(size=(70, 37)).astype(np.float32))
    ec = on(rng.normal(size=(1000, 37)).astype(np.float32))
    for c in (ec, ec.to(torch.bfloat16)):
        check_topk(tk.topk_similarity(eq, c, 32), eq, c, 32,
                   f"edge: D=37, Q=70, N=1000, k=32, {dname(c.dtype)}")
    # the widest D the kernel's shared-memory tiles take runs; one more is
    # refused by the C entry and raised as a ValueError
    for dt, dmax in ((torch.float32, 640), (torch.bfloat16, 496)):
        wq = on(rng.normal(size=(70, dmax + 1)).astype(np.float32))
        wc = on(rng.normal(size=(1000, dmax + 1)).astype(np.float32)).to(dt)
        check_topk(tk.topk_similarity(wq[:, :dmax], wc[:, :dmax], 10),
                   wq[:, :dmax], wc[:, :dmax], 10,
                   f"edge: D={dmax}, Q=70, N=1000, k=10, {dname(dt)}")
        try:
            tk.topk_similarity(wq, wc, 10)
        except ValueError:
            pass
        else:
            raise AssertionError(f"topk_similarity took D={dmax + 1} "
                                 f"({dname(dt)}) past its tiles")
    log("[apps] top-k D limit: 640 fp32 / 496 bf16 run, 641 / 497 raise")
    pool_edges(a)

    rows = []
    norm = torch.nn.functional.normalize
    for (dt, q) in rec:
        qs, c = queries[q], corpus[dt]
        flops = 2 * q * N * D
        nbytes = q * D * 4 + c.numel() * c.element_size() + q * K * 8
        # the function's bound: its one product at the tensor cores' peak
        # for the corpus type (TF32 for fp32, bf16); beside it the route's
        # three products (3xTF32 or bf16x3) and the first design's one
        # fp32 product on the CUDA cores
        tc = torch.bfloat16 if dt == torch.bfloat16 else "tf32"
        bound_ms, bound_by = bound(nbytes, flops, tc)
        route_ms, _ = bound(nbytes, 3 * flops, tc)
        cuda_core_ms, _ = bound(nbytes, flops, torch.float32)
        ms = time_ms(lambda: tk.topk_similarity(qs, c, K), flush)
        qn = norm(qs, dim=-1, eps=1e-9)
        cn = norm(c.float(), dim=-1, eps=1e-9)
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
            bound_route_ms=route_ms, bound_cuda_core_ms=cuda_core_ms,
            library_two_calls_ms=time_ms(
                lambda: torch.topk(qn @ cn.mT, K), flush),
            library_with_norm_ms=time_ms(lambda: torch.topk(
                norm(qs, dim=-1, eps=1e-9)
                @ norm(c.float(), dim=-1, eps=1e-9).mT, K), flush),
            items_per_s=q / ms * 1e3))
    for dt in corpus:
        topk_breakdown(queries[50], corpus[dt], K, flush)
    p_rows = pool_rows(a, errs, flushes, want_ops=1)
    for row, (name, (dt, w)) in zip(p_rows, a.sent_cases.items()):
        batch_ms = time_ms(lambda: sentiment(dt, w), flush)
        log(f"[apps] sentiment {name}: batch (pool + head + argmax) "
            f"{batch_ms:.4f} ms, {R / batch_ms * 1e3:.4g} reviews/s")
        row.update(batch_ms=batch_ms, items_per_s=R / batch_ms * 1e3)
    rows += p_rows
    del flushes, flush
    for row in rows:
        row["kernel_ms"] = row["ms"]
        log(f"[kernels] {row['name']} ({row['shape']}): kernel "
            f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}), library "
            f"{row['library_ms']}"
            + (f", topk(q @ c.T) two calls {row['library_two_calls_ms']:.4f}"
               f" ms, with the normalisation "
               f"{row['library_with_norm_ms']:.4f} ms, route bound "
               f"{row['bound_route_ms']:.4f} ms, CUDA-core bound "
               f"{row['bound_cuda_core_ms']:.4f} ms, "
               f"{row['items_per_s']:.4g} queries/s"
               if row["kernel"] == "topk_similarity" else "")
            + (f", clean L2: kernel {row['ms_clean_l2']:.4f} ms, library "
               f"{row.get('library_ms_clean_l2')}" if "ms_clean_l2" in row
               else ""))
    return rows, launches


def serve(cfg, params, requests, k_block, dev, max_len=1024,
          kv_layout="paged", engine=None, **engine_kw):
    """Serve ``requests`` through a fresh engine (or ``engine``, built with
    a telemetry hub) with the launch counters set to 0 just before and
    read just after."""
    from repro_torch.core.telemetry import TelemetryHub
    from repro_torch.kernels import ops
    from repro_torch.train.serve_loop import ServeEngine
    eng = engine
    if eng is None:
        eng = ServeEngine(cfg, params, num_slots=8, max_len=max_len,
                          page_size=16, k_block=k_block, kv_layout=kv_layout,
                          telemetry=TelemetryHub(), device=dev, **engine_kw)
    hub = eng.tele
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
    return eng, results, wall, launches, len(phases(hub, "prefill"))


def phases(hub, name) -> list:
    """The hub's phases named ``name`` (on every track)."""
    return [e for e in hub.events()
            if e["ev"] == "phase" and e["name"] == name]


def warm_ms(events) -> float:
    """Mean serving ms of the phases that booked serving time (a site's
    first call is booked as compile and records 0)."""
    d = [e["dur"] for e in events if e["dur"] > 0]
    return sum(d) / max(len(d), 1) * 1e3


def check_flips(tag, requests, got, want, params, cfg, dev, margin_max):
    """Token lists ``got`` against ``want``: at the first token where they
    part, the top-2 logit margin of the one-shot prefill must lie below
    ``margin_max``.  Returns the number of requests that parted."""
    flips = 0
    for (prompt, _), a, b in zip(requests, got, want):
        if a == b:
            continue
        t = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b)))
        margin = top2_margin(params, cfg, prompt + b[:t], dev)
        log(f"[{tag}] token flip at step {t}: {a[t:t + 1]} vs {b[t:t + 1]}, "
            f"top-2 logit margin {margin:.3g}")
        assert margin < margin_max, f"{tag}: tokens part at a clear margin"
        flips += 1
    log(f"[{tag}] identical tokens on {len(got) - flips}/{len(got)} requests "
        f"({flips} flips at near-ties, margin < {margin_max:g})")
    return flips


def profile_window(eng, label, step_ms=None, fn=None):
    """One engine tick (or ``fn()``) under torch.profiler: the union of the
    window's device kernel intervals against its wall time, and the
    kernels that took the most device time.  The profiler slows the host,
    so the idle share inside the window is an upper bound; with ``step_ms``
    (a decode step's unprofiled host-clock time) the kernel time per step
    is also set against it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with torch.no_grad():
            (fn or eng.step)()
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
    steps = 0 if fn else eng.last_tick.steps
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
    ranked = sorted(by_name.items(), key=lambda x: -x[1][0])
    for name, (t, n) in ranked[:8]:
        log(f"[profile] {label}:   {t / 1e3:9.3f} ms x{n:<5d} {name[:80]}")
    # the port's own kernels (the __global__ functions of csrc/*.cu and
    # of the shared header's namespace), ranked or not
    for name, (t, n) in ranked:
        fn = re.search(r"(?:\(anonymous namespace\)|split_decode)::(\w+)",
                       name)
        if fn and fn.group(1) in port_kernels():
            log(f"[profile] {label}: port kernel {t / 1e3:9.3f} ms x{n:<5d} "
                f"{name[fn.start(1):][:60]}")


def port_kernels() -> set:
    """Names of the __global__ functions in the port's CUDA sources and
    their shared headers."""
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                     r"(\w+)\s*\(")
    return {m for f in (ROOT / "src/repro_torch/kernels/csrc").iterdir()
            if f.suffix in (".cu", ".cuh")
            for m in pat.findall(f.read_text())}


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
    check_flips("strip", requests, out["strip"][0], out["paged"][0], params,
                cfg, dev, 1e-3)
    chunk_fp32_phase(cfg, params, dev, requests, out["paged"][0])
    del params
    free_device()
    return out["strip"][1]


def chunk_fp32_phase(cfg, params, dev, requests, want):
    """The 8-layer float32 yi-9b with chunked prefill (128-row chunks, up
    to 6 a prompt) against its one-shot paged tokens ``want``, cold and
    prewarmed: the same tokens (a flip only at a top-2 margin < 1e-3),
    the flash kernel on every layer of every one-shot prefill call, the
    paged-decode kernel on every layer of every step, the chunk calls
    (the plain masked attention, no kernel) counted from the hub; the
    prewarmed engine books its first launches before the first request and
    none in any tick."""
    from repro_torch.core.telemetry import TelemetryHub
    from repro_torch.train.serve_loop import ServeEngine
    C, L = 128, cfg.num_layers
    n_chunks = sum(-(-len(p) // C) for p, _ in requests if len(p) > C)
    n_oneshot = sum(len(p) <= C for p, _ in requests)
    for prewarm in (False, True):
        tag = "chunk fp32" + (" prewarm" if prewarm else "")
        eng = ServeEngine(cfg, params, num_slots=8, max_len=1024,
                          page_size=16, k_block=8, chunk_prefill=C,
                          prewarm=prewarm, telemetry=TelemetryHub(),
                          device=dev)
        compile0 = eng.stats.compile_s
        if prewarm:
            assert compile0 > 0 and eng._warm_keys == {
                ("prefill",), ("decode_block",), ("chunk",)}, eng._warm_keys
        eng, results, wall, launches, prefill_calls = serve(
            cfg, params, requests, 8, dev, engine=eng)
        steps = eng.stats.decode_steps
        chunks = phases(eng.tele, "prefill_chunk")
        assert all(r.status == "ok" for r in results) and len(results) == 16
        eng.pager.check_balanced()
        assert len(chunks) == n_chunks > 0, (len(chunks), n_chunks)
        assert (0 < prefill_calls <= n_oneshot) == (n_oneshot > 0), \
            (prefill_calls, n_oneshot)
        assert launches["flash_attention"] == L * prefill_calls, launches
        assert launches["paged_decode"] == L * steps > 0, (launches, steps)
        if prewarm:
            assert eng.stats.compile_s == compile0, \
                "a tick of the prewarmed engine booked compile time"
        log(f"[{tag}] {prefill_calls} one-shot prefill calls, "
            f"{len(chunks)} chunk calls ({warm_ms(chunks):.2f} ms a chunk), "
            f"{steps} decode steps, compile {eng.stats.compile_s:.2f} s "
            f"(before the first request: {compile0:.2f} s); launches "
            f"{launches}")
        check_flips(tag, requests, [r.tokens for r in results], want,
                    params, cfg, dev, 1e-3)
        del eng
        free_device()


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


def times_phase(dev) -> dict:
    """The timing of the two gather kernels alone, for comparing trees in
    turns (``--times``): the launch floor; isp_gather at the decode step
    and the prefill beside F.embedding; isp_gather_pool at its five path
    shapes beside F.embedding_bag, and the profiler split of one sentiment
    fp32 and one shard call; isp decode on gemma3-12b's rings as a
    bytes-bound row of a kernel this comparison leaves alone.  Each under
    both flushes; every kernel is held to its plain version first."""
    from repro_torch.kernels import isp_decode as isp
    from repro_torch.kernels import isp_gather as ig
    flushes = l2_flushes(dev)
    floor = launch_floor(flushes)
    rows = gather_rows(dev, flushes)
    args, window, _ = strip_case("ring", torch.bfloat16, dev,
                                 torch.Generator().manual_seed(SEED))
    max_err(isp.decode_partial(*args, window=window),
            isp.decode_partial_ref(*args, window=window), torch.bfloat16)
    ring = [time_ms(lambda: isp.decode_partial(*args, window=window), f)
            for f in flushes]
    a = apps_data(dev)
    errs = {}
    for name, (dt, w) in a.sent_cases.items():
        t = a.s_tab[dt]
        errs[name] = check_pool(ig.isp_gather_pool(t, a.s_idx, a.s_seg, a.R,
                                                   weights=w),
                                t, a.s_idx, a.s_seg, a.R, w=w, tag=name)
    off = 5 * a.vloc
    errs["sharded"] = check_pool(
        ig.isp_gather_pool(a.shards[5], a.p_idx, a.p_seg, a.NSEG,
                           shard_offset=off),
        a.shards[5], a.p_idx, a.p_seg, a.NSEG, off, tag="shard 5")
    rows += pool_rows(a, errs, flushes)
    # the pool with no ids: what a call costs before its first id (the
    # launch, the zero-fill and, in a cooperative launch, the grid sync)
    calls = (lambda: ig.isp_gather_pool(a.s_tab[torch.float32], a.s_idx[:0],
                                        a.s_seg[:0], a.R),
             lambda: ig.isp_gather_pool(a.shards[5], a.p_idx[:0],
                                        a.p_seg[:0], a.NSEG,
                                        shard_offset=off))
    empty = [time_ms(call, flushes[0]) for call in calls]
    log(f"[times] isp_gather_pool with no ids: {empty[0]:.4f} ms at the "
        f"sentiment output ({a.R}, {a.E}), {empty[1]:.4f} ms at a shard's "
        f"({a.NSEG}, {a.SD})")
    out = {"launch_floor_ms": floor, "isp_decode_rings_ms": ring,
           "pool_no_ids_ms": empty,
           "rows": [{k: r.get(k) for k in (
               "name", "shape", "ms", "ms_clean_l2", "library_ms",
               "library_ms_clean_l2", "plain_ms", "bound_ms", "copy_ms",
               "copy_ms_clean_l2")}
               for r in rows]}
    for r in out["rows"]:
        log(f"[times] {r['name']} ({r['shape']}): kernel {r['ms']:.4f} ms, "
            f"clean L2 {r['ms_clean_l2']:.4f} ms; library "
            f"{r['library_ms']} / {r['library_ms_clean_l2']}; bound "
            f"{r['bound_ms']:.4f} ms")
    log(f"[times] isp decode rings: {ring[0]:.4f} ms, clean L2 "
        f"{ring[1]:.4f} ms")
    return out


def chunk_bf16_phase(cfg, params, dev, requests, want):
    """Full yi-9b in bf16 serving the serve phase's 16 requests with
    256-row chunks at chunk budgets 1 and 2: every request ok, a balanced
    free list, the kernels on every layer of every one-shot prefill call
    and decode step, and the one-shot run's tokens ``want`` (a flip only
    below BF16_FLIP_MARGIN)."""
    C, L = 256, cfg.num_layers
    n_chunks = sum(-(-len(p) // C) for p, _ in requests if len(p) > C)
    for budget in (1, 2):
        tag = f"chunk bf16 budget {budget}"
        eng, results, wall, launches, prefill_calls = serve(
            cfg, params, requests, 8, dev, chunk_prefill=C,
            chunk_budget=budget)
        st, lat = eng.stats, eng.stats.latency
        assert len(results) == 16 and all(r.status == "ok" for r in results)
        eng.pager.check_balanced()
        chunks = phases(eng.tele, "prefill_chunk")
        assert len(chunks) == n_chunks > 0, (len(chunks), n_chunks)
        assert launches["flash_attention"] == L * prefill_calls > 0, launches
        assert launches["paged_decode"] == L * st.decode_steps > 0, launches
        log(f"[{tag}] {prefill_calls} one-shot prefill calls "
            f"({warm_ms(phases(eng.tele, 'prefill')):.1f} ms a warm call), "
            f"{len(chunks)} chunks ({warm_ms(chunks):.1f} ms a warm chunk), "
            f"decode {st.decode_s * 1e3 / st.decode_steps:.2f} ms per step "
            f"({st.decode_steps} steps); TTFT p50 {lat.p50_ttft_s * 1e3:.1f}"
            f" ms, p99 {lat.p99_ttft_s * 1e3:.1f} ms; {wall:.2f} s wall; "
            f"launches {launches}")
        check_flips(tag, requests, [r.tokens for r in results], want,
                    params, cfg, dev, BF16_FLIP_MARGIN)
        del eng
        free_device()
    # where a chunk's time goes: one 256-row chunk call alone, warm
    from repro_torch.train.serve_loop import ServeEngine
    eng = ServeEngine(cfg, params, num_slots=8, max_len=1024, page_size=16,
                      k_block=8, chunk_prefill=C, device=dev)
    for prompt, _ in requests[:8]:
        eng.submit(prompt, max_new=32)
    eng.step()
    profile_window(eng, "one 256-row chunk", fn=eng._chunk_prefill_tick)
    del eng
    free_device()


# the cluster's drives: the serve engine's settings, 256-row chunks
CLUSTER_KW = dict(n_drives=4, num_slots=8, max_len=1024, page_size=16,
                  k_block=8, chunk_prefill=256)
# headroom over the weights and the four pools for one prefill bucket's
# activations (8 x 256 rows), one chunk's scores (256 x 32 x 1024 fp32)
# and the allocator's rounding
CLUSTER_MEM_MARGIN = 2 * 2**30
# requests of the serial cluster run and of each open-loop trace: 16 (cut
# from 32 to make room for the train phases in the run's time limit; the
# crash run takes these 16 with 16 tokens each)
CLUSTER_REQUESTS = 16


def drive_cluster(cfg, params, dev, requests, shards=None, replay=None,
                  **kw):
    """Serve ``requests`` (or replay the open-loop trace ``replay``) on a
    fresh cluster over the one ``params``, the launch counters set to 0
    just before and read just after, every tick timed.  Checks the
    kernels' launches, conservation, the drives' free lists and the merged
    ledger.  Returns a namespace of the run."""
    from repro_torch.core.telemetry import TelemetryHub
    from repro_torch.data.workload import replay_open_loop
    from repro_torch.kernels import ops
    from repro_torch.train.cluster_loop import ClusterEngine
    hub = TelemetryHub()
    clu = ClusterEngine(cfg, params, telemetry=hub, device=dev,
                        **{**CLUSTER_KW, **kw})
    assert all(d.engine.params is params for d in clu.drives)
    for i, (prompt, max_new) in enumerate(requests):
        clu.submit(prompt, max_new=max_new,
                   shard_id=None if shards is None else i % shards)
    run = SimpleNamespace(clu=clu, hub=hub, longest_tick=0.0,
                          submitted=len(requests))
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    if replay is not None:
        report = replay_open_loop(clu, replay)
        run.submitted = report.submitted
    else:
        for _ in range(100_000):
            if not (clu.queue or any(d.has_work for d in clu.drives)):
                break
            t = time.perf_counter()
            clu.step()
            run.longest_tick = max(run.longest_tick, time.perf_counter() - t)
    run.results = clu.run_until_complete()
    torch.cuda.synchronize()
    run.wall = time.perf_counter() - t0
    run.launches = ops.launch_counts()
    clu.close()
    assert hub.events_dropped == 0
    run.suspect = [e["attrs"] for e in hub.events()
                   if e["name"] == "health_transition"
                   and e["attrs"]["new"] == "suspect"]
    L = cfg.num_layers
    run.prefill_calls = len(phases(hub, "prefill"))
    run.chunks = len(phases(hub, "prefill_chunk"))
    run.steps = sum(d.engine.stats.decode_steps for d in clu.drives)
    assert run.launches["flash_attention"] == L * run.prefill_calls > 0, \
        (run.launches, run.prefill_calls)
    assert run.launches["paged_decode"] == L * run.steps > 0, \
        (run.launches, run.steps)
    statuses = [r.status for r in run.results]
    assert run.submitted == len(statuses) == sum(
        statuses.count(x) for x in ("ok", "shed", "failed")), statuses
    for d in clu.drives:
        assert d.engine.pager.num_in_use == 0
        d.engine.pager.check_balanced()
    merged, drives = clu.stats.ledger, [x.ledger for x in clu.stats.drives]
    for tier in ("link_bytes", "kv_bytes"):
        parts = sum(getattr(x, tier) for x in drives) + \
            getattr(clu.stats.spill_ledger, tier)
        assert math.isclose(getattr(merged, tier), parts, rel_tol=1e-12), \
            (tier, getattr(merged, tier), parts)
    return run


def cluster_log(tag, run):
    st, lat = run.clu.stats, run.clu.stats.latency
    log(f"[{tag}] {st.completed} ok / {st.shed_requests} shed / "
        f"{st.failed_requests} failed of {run.submitted}; "
        f"{run.prefill_calls} one-shot prefill calls, {run.chunks} chunks, "
        f"{run.steps} decode steps on {len(run.clu.drives)} drives; "
        f"{run.wall:.2f} s wall in-process ({st.completed / run.wall:.3f} "
        f"requests/s), {st.cluster_s:.2f} s on the cluster clock "
        f"({st.throughput_qps:.3f} requests/s, {st.tokens_per_s:.1f} tok/s); "
        f"TTFT p50 {lat.p50_ttft_s * 1e3:.1f} ms, p99 "
        f"{lat.p99_ttft_s * 1e3:.1f} ms; longest tick "
        f"{run.longest_tick:.3f} s; launches {run.launches}")
    log(f"[{tag}] Table I energy per query of the paper's 36-drive server "
        f"model (core/energy.py, not the card's power): "
        f"{st.energy_per_query_mj:.1f} mJ at {st.mean_active:.2f} mean "
        f"active drives")
    for line in run.clu.summary().splitlines():
        log(f"[{tag}] {line}")


def tpot_p(lat, q) -> float:
    from repro_torch.core.latency import percentile
    return percentile([r.tpot_s for r in lat.completed
                       if math.isfinite(r.tpot_s)], q)


def gil_probe(dev, n_ops=20_000):
    """Host cost of one small CUDA op launched by one thread alone and by
    four threads at once (each launching ``n_ops``): what the drive
    workers pay per op when they share the interpreter."""
    x = [torch.zeros(8, device=dev) for _ in range(4)]

    def launch(t):
        for _ in range(n_ops):
            t.add_(1.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    launch(x[0])
    torch.cuda.synchronize()
    one = (time.perf_counter() - t0) / n_ops
    threads = [threading.Thread(target=launch, args=(t,)) for t in x]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    torch.cuda.synchronize()
    four = (time.perf_counter() - t0) / (4 * n_ops)
    assert all(float(t[0]) == n_ops * (1 + (i == 0)) for i, t in enumerate(x))
    log(f"[gil] one small CUDA op: {one * 1e6:.2f} us from one thread, "
        f"{four * 1e6:.2f} us a op with four threads launching at once "
        f"({four / one:.2f}x)")


def cluster_phase(cfg, params, dev):
    """yi-9b bf16 served by a 4-drive cluster over the one model: serial,
    then data_local over 4 shards with a tick-based crash of drive 1, then
    on worker threads, then open-loop bursty traffic FIFO and EDF."""
    from repro_torch.core.faults import (DEAD, HEALTHY, FailureDetector,
                                         FaultSchedule)
    from repro_torch.core.runtime import HeartbeatWatchdog
    from repro_torch.data.workload import (PriorityClass, WorkloadConfig,
                                           generate_trace)
    rng = np.random.default_rng(SEED + 2)
    requests = [(rng.integers(0, cfg.vocab_size,
                              int(rng.integers(16, 701))).tolist(), 32)
                for _ in range(CLUSTER_REQUESTS)]
    log(f"[cluster] prompt lengths {[len(p) for p, _ in requests]}")
    kw = CLUSTER_KW        # serve()'s engine has 8 slots of 16-row pages
    eng, results, wall, launches, prefill_calls = serve(
        cfg, params, requests, kw["k_block"], dev, max_len=kw["max_len"],
        chunk_prefill=kw["chunk_prefill"])
    want = [r.tokens for r in results]
    assert all(r.status == "ok" for r in results)
    log(f"[cluster] one engine: {len(results)} ok in {wall:.2f} s wall, "
        f"{eng.stats.decode_steps} decode steps")
    del eng
    free_device()

    weights = sum(p.numel() * p.element_size() for p in params.parameters())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run = drive_cluster(cfg, params, dev, requests, routing="least_loaded")
    peak = torch.cuda.max_memory_allocated()
    pools = [sum(c[leaf].numel() * c[leaf].element_size()
                 for c in d.engine.caches.values() for leaf in ("kp", "vp"))
             for d in run.clu.drives]
    bound = weights + sum(pools) + CLUSTER_MEM_MARGIN
    cluster_log("cluster serial", run)
    assert [r.tokens for r in run.results] == want, \
        "the cluster's tokens differ from one engine's"
    assert not run.suspect, run.suspect
    log(f"[cluster serial] tokens identical to one engine on "
        f"{len(requests)}/{len(requests)} requests; free lists balance on "
        f"all 4 drives; merged ledger = "
        f"the drives' ledgers + the spill ledger")
    log(f"[cluster serial] peak memory {peak / 1e9:.3f} GB <= weights "
        f"{weights / 1e9:.3f} GB + 4 pools of {pools[0] / 1e6:.1f} MB + "
        f"margin {CLUSTER_MEM_MARGIN / 1e9:.3f} GB = {bound / 1e9:.3f} GB "
        f"(one copy of the weights for all drives)")
    assert peak <= bound, (peak, bound)
    per_req_s = run.clu.stats.cluster_s / run.clu.stats.completed
    longest = run.longest_tick
    del run
    free_device()

    # the crash run and the worker-thread runs serve a prefix of the
    # requests with fewer tokens each, to fit the run's time limit; greedy
    # decode makes their tokens prefixes of the fault-free run's
    sub = [(p, 16) for p, _ in requests[:16]]
    crash = drive_cluster(
        cfg, params, dev, sub, shards=4, routing="data_local",
        faults=FaultSchedule.from_spec(
            [{"drive_id": 1, "kind": "crash", "at_tick": 3}]),
        detector=FailureDetector(4, suspect_ticks=2, dead_ticks=4,
                                 suspect_after_s=math.inf))
    cst = crash.clu.stats
    cluster_log("cluster crash", crash)
    assert cst.health[1] == DEAD and cst.auto_failed_drives == 1, cst.health
    ok = [(r.rid, r.tokens) for r in crash.results if r.status == "ok"]
    assert ok and all(t == want[rid][:16] for rid, t in ok), \
        "an ok result of the crash run differs from the fault-free tokens"
    log(f"[cluster crash] data_local over 4 shards, 16 requests of 16 "
        f"tokens, drive 1 crashed at tick 3: health {cst.health}, "
        f"{cst.retries} retries, {len(ok)}/16 ok token-identical to the "
        f"fault-free run; spill ledger {cst.spill_bytes / 1e6:.3f} MB "
        f"({cst.remote_requests} remote requests, {cst.migrated_shards} "
        f"shards migrated; {dict(cst.spill_ledger.notes)})")
    del crash
    free_device()

    # the drives share the card and its default stream: a concurrent join
    # waits for all four drives' kernels, so the timeouts are sized from
    # the serial run's longest tick (all four drives stepped one after the
    # other), with room to spare
    timeout = max(10.0, 4.0 * longest)
    sub = [(p, 8) for p, _ in requests[:8]]
    walls = {}
    for concurrent in (False, True):
        tag = "cluster " + ("concurrent" if concurrent else "serial 8x8")
        kw = dict(concurrent=True, dispatch_timeout_s=timeout,
                  watchdog=HeartbeatWatchdog(
                      4, suspect_after_s=3.0 * timeout, suspect_misses=3,
                      dead_after_s=10.0 * timeout, dead_misses=10)) \
            if concurrent else {}
        run = drive_cluster(cfg, params, dev, sub, routing="least_loaded",
                            **kw)
        cluster_log(tag, run)
        assert [r.tokens for r in run.results] == [t[:8] for t in want[:8]],\
            f"{tag}: the tokens differ from one engine's"
        assert not run.suspect and run.clu.stats.health == [HEALTHY] * 4, \
            (run.suspect, run.clu.stats.health)
        walls[concurrent] = run.wall
        if concurrent:
            assert not [t for t in threading.enumerate()
                        if t.name.startswith("drive-worker-")], "workers"
            log(f"[{tag}] 8 requests of 8 tokens; dispatch timeout "
                f"{timeout:.2f} s, watchdog suspect after {3 * timeout:.1f} "
                f"s / dead after {10 * timeout:.1f} s; tokens identical to "
                f"one engine, no drive SUSPECT, workers joined; measured wall"
                f" {run.clu.stats.cluster_s:.2f} s vs virtual-clock "
                f"prediction {run.clu.predicted_parallel_s:.2f} s, "
                f"{walls[True] / walls[False]:.2f}x the serial run's wall "
                f"(four drives on one card and its default stream: a "
                f"drive's measured step includes the kernels the others "
                f"queued)")
        del run
        free_device()
    gil_probe(dev)

    classes = (
        PriorityClass("interactive", priority=0, weight=0.7,
                      slo_s=6.0 * per_req_s, prompt_range=(16, 128),
                      max_new_range=(8, 32)),
        PriorityClass("batch", priority=1, weight=0.3,
                      slo_s=30.0 * per_req_s, prompt_range=(256, 700),
                      max_new_range=(16, 32)))
    trace = generate_trace(WorkloadConfig(
        n_requests=CLUSTER_REQUESTS, vocab_size=cfg.vocab_size,
        arrival="bursty",
        rate=1.2 / per_req_s, burst_factor=4.0, duty=0.25,
        period_s=8.0 * per_req_s, classes=classes, seed=SEED))
    log(f"[open-loop] {per_req_s * 1e3:.1f} ms a request (the serial "
        f"cluster's clock / requests); bursty at {1.2 / per_req_s:.3f} "
        f"requests/s, SLO {6 * per_req_s:.2f} s interactive / "
        f"{30 * per_req_s:.2f} s batch")
    served = {}
    for order, shed in (("fifo", False), ("edf", True)):
        ol = drive_cluster(cfg, params, dev, [], replay=trace,
                           routing="least_loaded", admission_order=order,
                           shed_expired=shed)
        lat = ol.clu.stats.latency
        m = lat.metrics(wall_s=ol.clu.clock)
        log(f"[open-loop {order}] {m['count']} ok / {m['shed']} shed / "
            f"{m['failed']} failed of {ol.submitted}; TTFT p50 "
            f"{m['p50_ttft_s'] * 1e3:.1f} ms, p99 {m['p99_ttft_s'] * 1e3:.1f}"
            f" ms; TPOT p50 {tpot_p(lat, 50) * 1e3:.2f} ms, p99 "
            f"{tpot_p(lat, 99) * 1e3:.2f} ms; SLO attainment "
            f"{m['slo_attainment']:.1%} ({m['slo_met']} met); goodput "
            f"{m['goodput_qps']:.3f} requests/s on the cluster clock; "
            f"launches {ol.launches}")
        assert ol.submitted == CLUSTER_REQUESTS and (shed or m["shed"] == 0)
        served[order] = {r.rid: r.tokens for r in ol.results
                         if r.status == "ok"}
        del ol
        free_device()
    both = served["fifo"].keys() & served["edf"].keys()
    assert all(served["fifo"][r] == served["edf"][r] for r in both)
    log(f"[open-loop] FIFO and EDF agree token for token on the {len(both)} "
        f"requests both served")


# llama4-scout at full width: 8 of its 48 layers hold 19.69 B parameters
# (39.4 GB in bf16); all 48 hold 107.8 B (215.6 GB), which no card holds
LLAMA4_LAYERS = 8
# one layer's MoE in bf16 on the card against fp32 on the CPU, on the same
# bf16 weights and inputs: bf16 rounds g, u, the silu cast, h and the
# expert and shared outputs, each within 2**-8 of the value; independent
# roundings of h move an output by about 2**-8 of the output's RMS over
# the F-wide sum, so the relative Frobenius error stays near 4e-3 (bound
# 1e-2); the largest of 64 x 5120 errors has tails heavier than a
# Gaussian's (products of rounded factors: 5.6x the RMS error over 4096
# elements at the reduced config on the CPU), so its bound is 0.1 of the
# output's RMS, while a wrong expert or a lost shared expert moves a row by
# the order of the RMS itself.  A row whose top-1 expert differs (fp32
# router logits summed in another order) must be a near tie (top-2
# probability margin < 1e-4) and is left out.
MOE_REL_FRO = 1e-2
MOE_MAX_OF_RMS = 0.1


def weight_gb(model) -> float:
    return sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9


def check_serve(tag, cfg, eng, results, launches, prefill_calls, requests):
    """Every request ok with its max_new tokens in the vocabulary, a
    balanced free list, flash on every layer of every prefill call and
    paged decode on every layer of every step, isp decode never."""
    st, L = eng.stats, cfg.num_layers
    assert len(results) == len(requests) and all(
        r.status == "ok" for r in results), [r.status for r in results]
    assert [len(r.tokens) for r in results] == [m for _, m in requests], tag
    assert all(0 <= t < cfg.vocab_size for r in results for t in r.tokens)
    eng.pager.check_balanced()
    assert launches["flash_attention"] == L * prefill_calls > 0, \
        (tag, launches, prefill_calls)
    assert launches["paged_decode"] == L * st.decode_steps > 0, \
        (tag, launches, st.decode_steps)
    assert launches["isp_decode"] == 0, (tag, launches)


def moe_phase(cfg, params, requests, dev):
    """Layer 0's MoE (16 routed experts top-1 + the shared expert) on 64
    real hidden rows (the longest prompt's first 64 tokens through layer
    0's attention), on the card in bf16 against the same function on the
    CPU in fp32 (MOE_REL_FRO, MOE_MAX_OF_RMS); then the dense MoE's cost on
    the card: one layer's apply_moe at a decode step's 8 rows and at the
    longest prompt's rows, beside the bytes of every expert (dense) and of the
    experts the rows route to (grouped dispatch)."""
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import blocks as blk
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.layers import rms_norm
    b0, m = params.blocks[0], cfg.moe
    prompt = max((p for p, _ in requests), key=len)
    with torch.no_grad():
        def hidden(n):
            toks = torch.tensor([prompt[:n]], dtype=torch.long, device=dev)
            x = params.embed.table[toks]
            pos = torch.arange(n, dtype=torch.int32, device=dev)
            a, _ = attn_mod.gqa_apply(b0.attn, rms_norm(x, b0.ln1,
                                                        cfg.norm_eps),
                                      pos, cfg, "full", None, "prefill")
            return rms_norm(x + a, b0.ln2, cfg.norm_eps)
        h = hidden(64)
        y, _ = blk.apply_moe(b0.moe, h, cfg)
        _, experts, _ = moe_mod._router(b0.moe.router, h, cfg)
        names = ("router", "we_gate", "we_up", "we_down", "ws_gate",
                 "ws_up", "ws_down")
        cpu = SimpleNamespace(**{k: getattr(b0.moe, k).float().cpu()
                                 for k in names})
        h32 = h.float().cpu()
        t0 = time.perf_counter()
        y32, _ = blk.apply_moe(cpu, h32, cfg)
        cpu_s = time.perf_counter() - t0
        _, e32, p32 = moe_mod._router(cpu.router, h32, cfg)
        del cpu
    y = y.float().cpu()[0]
    y32, e32, p32 = y32[0], e32[0, :, 0], p32[0]
    part = experts[0, :, 0].cpu() != e32
    top2 = torch.sort(p32, dim=-1, descending=True).values[:, :2]
    margins = (top2[:, 0] - top2[:, 1])[part]
    assert bool((margins < 1e-4).all()), f"MoE routes part at {margins}"
    keep = ~part
    diff = (y - y32)[keep]
    rms = float(y32[keep].square().mean().sqrt())
    rel_fro = float(diff.norm() / y32[keep].norm())
    max_rel = float(diff.abs().max()) / rms
    assert torch.isfinite(y).all()
    assert rel_fro < MOE_REL_FRO and max_rel < MOE_MAX_OF_RMS, \
        (rel_fro, max_rel)
    log(f"[llama4 moe] layer 0 on 64 rows, bf16 card vs fp32 CPU "
        f"({cpu_s:.1f} s): {int(keep.sum())}/64 rows routed alike "
        f"({int(part.sum())} near ties left out), experts used "
        f"{sorted(set(e32.tolist()))}, output RMS {rms:.4g}; relative "
        f"Frobenius error {rel_fro:.3g} (bound {MOE_REL_FRO:g}), max abs "
        f"error {float(diff.abs().max()):.4g} = {max_rel:.3g} of the RMS "
        f"(bound {MOE_MAX_OF_RMS:g})")
    # the dense MoE's cost, one layer: every expert on every row
    flush = l2_flushes(dev)[0]
    e_bytes = 3 * cfg.d_model * m.d_ff_expert * 2       # one expert, bf16
    shared = 3 * cfg.d_model * m.d_ff_shared * 2
    for n_rows in (8, len(prompt)):
        with torch.no_grad():
            hx = h[:, :8] if n_rows == 8 else hidden(n_rows)
            _, ex, _ = moe_mod._router(b0.moe.router, hx, cfg)
            ms = time_ms(lambda: blk.apply_moe(b0.moe, hx, cfg), flush)
        used = len(set(ex.flatten().tolist()))
        dense_b = m.num_experts * e_bytes + shared
        grouped_b = used * e_bytes + shared
        flops = 2 * n_rows * 3 * cfg.d_model * m.d_ff_expert
        log(f"[llama4 moe] one layer's dense MoE at {n_rows} rows: "
            f"{ms:.4f} ms on the card; bytes bound "
            f"{dense_b / HBM_BYTES_PER_S * 1e3:.4f} ms for all "
            f"{m.num_experts} experts ({dense_b / 1e9:.3f} GB), "
            f"{grouped_b / HBM_BYTES_PER_S * 1e3:.4f} ms for the {used} "
            f"experts routed to + the shared one ({grouped_b / 1e9:.3f} GB); "
            f"{flops * (m.num_experts + 1) / 1e9:.1f} GFLOP dense against "
            f"{flops * (m.top_k + 1) / 1e9:.1f} GFLOP routed")
        del hx
    free_device()


def llama4_phase(dev):
    """llama4-scout-17b-a16e in bf16 at every published width, depth cut
    to LLAMA4_LAYERS: 8 requests (prompts 16..700, max_new 32) through
    the paged engine with k_block 8, then k_block 1 (identical tokens) and
    chunk_prefill=256 (flips only at near-ties), one decode-block tick
    profiled, then moe_phase.  Returns the k_block 8 run's launches."""
    from repro_torch.config import get_config
    from repro_torch.models import model as M
    from repro_torch.train.serve_loop import ServeEngine
    full = get_config("llama4-scout-17b-a16e")
    cfg = dataclasses.replace(full, num_layers=LLAMA4_LAYERS)
    m = cfg.moe
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = M.init_params(cfg, gen, dev)
    torch.cuda.synchronize()
    assert all(b.moe.router.dtype == torch.float32 for b in params.blocks)
    log(f"[llama4] llama4-scout-17b-a16e bf16 at full width: d_model "
        f"{cfg.d_model}, {cfg.num_heads} heads / {cfg.num_kv_heads} kv of dh "
        f"{cfg.resolved_head_dim}, {m.num_experts} experts of d_ff "
        f"{m.d_ff_expert} top-{m.top_k} + {m.num_shared_experts} shared of "
        f"{m.d_ff_shared}, vocab {cfg.vocab_size}; depth cut from "
        f"{full.num_layers} to {cfg.num_layers} layers (the whole model is "
        f"{M.count_params(full) / 1e9:.3f} B parameters, "
        f"{M.count_params(full) * 2 / 1e9:.1f} GB in bf16): "
        f"{M.count_params(cfg) / 1e9:.3f} B parameters "
        f"({cfg.active_param_count() / 1e9:.3f} B active), "
        f"{weight_gb(params):.2f} GB of weights, init "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED)
    requests = [(rng.integers(0, cfg.vocab_size,
                              int(rng.integers(16, 701))).tolist(), 32)
                for _ in range(8)]
    log(f"[llama4] prompt lengths {[len(p) for p, _ in requests]}")
    eng, results, wall, launches, prefill_calls = serve(cfg, params,
                                                        requests, 8, dev)
    check_serve("llama4", cfg, eng, results, launches, prefill_calls,
                requests)
    serve_report("llama4", eng, results, wall, launches, prefill_calls)
    st = eng.stats
    step_ms = st.decode_s * 1e3 / st.decode_steps
    tokens = [r.tokens for r in results]
    del eng
    free_device()

    eng1, results1, wall1, _, _ = serve(cfg, params, requests, 1, dev)
    assert [r.tokens for r in results1] == tokens, \
        "llama4: k_block=1 and k_block=8 disagree"
    eng1.pager.check_balanced()
    log(f"[llama4] k_block=1 gives identical tokens ({wall1:.2f} s wall, "
        f"{eng1.stats.decode_s * 1e3 / eng1.stats.decode_steps:.2f} ms per "
        f"step)")
    del eng1
    free_device()

    C = 256
    n_chunks = sum(-(-len(p) // C) for p, _ in requests if len(p) > C)
    eng, results, wall, cl, prefill_calls = serve(cfg, params, requests, 8,
                                                  dev, chunk_prefill=C)
    chunks = phases(eng.tele, "prefill_chunk")
    assert len(chunks) == n_chunks > 0, (len(chunks), n_chunks)
    assert len(results) == 8 and all(r.status == "ok" for r in results)
    eng.pager.check_balanced()
    assert cl["flash_attention"] == cfg.num_layers * prefill_calls, cl
    assert cl["paged_decode"] == cfg.num_layers * eng.stats.decode_steps, cl
    log(f"[llama4 chunk] chunk_prefill={C}: {prefill_calls} one-shot "
        f"prefill calls, {len(chunks)} chunks ({warm_ms(chunks):.1f} ms a "
        f"warm chunk), TTFT p50 {eng.stats.latency.p50_ttft_s * 1e3:.1f} "
        f"ms; launches {cl}")
    check_flips("llama4 chunk", requests, [r.tokens for r in results],
                tokens, params, cfg, dev, BF16_FLIP_MARGIN)
    del eng
    free_device()

    # a warm engine: one tick admits the 8 requests, the next decodes only
    eng = ServeEngine(cfg, params, num_slots=8, max_len=1024, page_size=16,
                      k_block=8, device=dev)
    for prompt, _ in requests:
        eng.submit(prompt, max_new=32)
    eng.step()
    profile_window(eng, "llama4 decode block tick", step_ms=step_ms)
    del eng
    free_device()
    moe_phase(cfg, params, requests, dev)
    del params
    free_device()
    return launches


def musicgen_phase(dev):
    """musicgen-large whole (48 layers, full width, MHA at dh 64) in bf16.
    The frontend path: AudioFrontendStub on a seeded 3 s waveform of 2
    rows, prefill_fn on the embeddings, its caches spliced into a paged
    pool, 16 per-slot decode_fn steps on tokens; one prefill over the
    embeddings and the 16 fed tokens gives the last step's token (a flip
    only below BF16_FLIP_MARGIN).  Then 8 token requests through the
    engine, k_block 8 and 1 (identical tokens), and one decode-block tick
    profiled.  Returns the serve run's
    and the frontend path's launches."""
    from repro_torch.config import get_config
    from repro_torch.core import embedding as emb
    from repro_torch.core.kv_pages import pages_for
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.models.frontend import AudioFrontendStub
    from repro_torch.models.layers import rms_norm
    from repro_torch.train.serve_loop import ServeEngine, _splice_slots
    cfg = get_config("musicgen-large")
    L = cfg.num_layers
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = M.init_params(cfg, gen, dev)
    torch.cuda.synchronize()
    log(f"[musicgen] musicgen-large bf16 whole: {L} layers, d_model "
        f"{cfg.d_model}, {cfg.num_heads} heads / {cfg.num_kv_heads} kv of dh "
        f"{cfg.resolved_head_dim}, vocab {cfg.vocab_size}, tied embeddings; "
        f"{M.count_params(cfg) / 1e9:.3f} B parameters, "
        f"{weight_gb(params):.2f} GB of weights, init "
        f"{time.perf_counter() - t0:.1f} s")

    # -- the frontend path: prefill on embeddings, decode on tokens
    wave = np.random.default_rng(SEED + 2).standard_normal(
        (2, 3 * 16_000)).astype(np.float32)
    frames, _ = AudioFrontendStub(cfg).encode(wave, seed=SEED)
    B, S = frames.shape[:2]
    steps, ps, max_len = 16, 16, 256
    table = np.full((B, pages_for(max_len, ps)), -1, np.int32)
    need = pages_for(S + steps, ps)
    for b in range(B):
        table[b, :need] = np.arange(b * need, (b + 1) * need)
    caches = M.init_caches(cfg, B, max_len, paged=True, page_size=ps,
                           device=dev)
    for c in caches.values():
        c["pages"][:] = torch.from_numpy(table).to(dev)
    x = torch.from_numpy(frames).to(dev)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        nxt, pre = M.prefill_fn(params, {"embeddings": x}, cfg)
        caches = _splice_slots(caches, pre, list(range(B)), [S] * B, table,
                               ps)
        del pre
        out = [nxt]
        pos = torch.full((B,), S, dtype=torch.int32, device=dev)
        for _ in range(steps):
            nxt, caches = M.decode_fn(params, caches, nxt[:, None], pos, cfg)
            out.append(nxt)
            pos = pos + 1
    torch.cuda.synchronize()
    fe_s = time.perf_counter() - t0
    fe_launches = ops.launch_counts()
    toks = torch.stack(out, 1)
    assert toks.shape == (B, steps + 1) and bool(
        ((toks >= 0) & (toks < cfg.vocab_size)).all())
    assert fe_launches["flash_attention"] == L, fe_launches
    assert fe_launches["paged_decode"] == L * steps, fe_launches
    assert fe_launches["isp_decode"] == 0, fe_launches
    # one prefill over the frames and the fed tokens gives the last token
    with torch.no_grad():
        seq = torch.cat([x.to(params.embed.table.dtype),
                         params.embed.table[toks[:, :steps].long()]], 1)
        h, _ = M.run_blocks(params, seq, torch.arange(
            S + steps, dtype=torch.int32, device=dev), cfg, None, "prefill")
        logits = emb.sharded_logits_last(rms_norm(
            h[:, -1], params.final_norm, cfg.norm_eps), params.head_table(),
            cfg)
    top = torch.topk(logits.float(), 2).values
    for b in range(B):
        want, got = int(logits[b].argmax()), int(toks[b, steps])
        margin = float(top[b, 0] - top[b, 1])
        if got != want:
            log(f"[musicgen frontend] row {b}: decode token {got} vs one-shot"
                f" {want}, top-2 margin {margin:.3g}")
            assert margin < BF16_FLIP_MARGIN, "decode parts at a clear margin"
    log(f"[musicgen frontend] {B} x {3 * 16_000} samples -> {S} frames: "
        f"prefill on embeddings ({S} rows) + {steps} decode steps in "
        f"{fe_s * 1e3:.1f} ms (first launches included), tokens "
        f"{toks.tolist()}; launches {fe_launches}")
    del caches
    free_device()

    # -- a token serve
    rng = np.random.default_rng(SEED + 3)
    requests = [(rng.integers(0, cfg.vocab_size,
                              int(rng.integers(16, 701))).tolist(), 32)
                for _ in range(8)]
    log(f"[musicgen] prompt lengths {[len(p) for p, _ in requests]}")
    eng, results, wall, launches, prefill_calls = serve(cfg, params,
                                                        requests, 8, dev)
    check_serve("musicgen", cfg, eng, results, launches, prefill_calls,
                requests)
    serve_report("musicgen", eng, results, wall, launches, prefill_calls)
    step_ms = eng.stats.decode_s * 1e3 / eng.stats.decode_steps
    tokens = [r.tokens for r in results]
    del eng
    free_device()
    eng1, results1, wall1, _, _ = serve(cfg, params, requests, 1, dev)
    assert [r.tokens for r in results1] == tokens, \
        "musicgen: k_block=1 and k_block=8 disagree"
    eng1.pager.check_balanced()
    log(f"[musicgen] k_block=1 gives identical tokens ({wall1:.2f} s wall)")
    del eng1
    free_device()
    eng = ServeEngine(cfg, params, num_slots=8, max_len=1024, page_size=16,
                      k_block=8, device=dev)
    for prompt, _ in requests:
        eng.submit(prompt, max_new=32)
    eng.step()
    profile_window(eng, "musicgen decode block tick", step_ms=step_ms)
    del eng, params
    free_device()
    return launches, fe_launches

DEEPSEEK_LAYERS = 4        # of 60: 16.94 B parameters, 33.9 GB in bf16
# absorbed MLA decode against the unabsorbed computation in fp32 at one
# layer: the two take the same sums in another association (q_nope through
# wk_b first, or wk_b through the cached rows first; 128- and 512-term fp32
# sums, ~1e-6 of a value each), so they agree far inside 1e-4 of the
# output's largest value
MLA_REL_TOL = 1e-4


def check_strip_serve(tag, cfg, eng, results, launches, prefill_calls,
                      requests, flash_layers, isp_layers):
    """Every request ok with its max_new tokens in the vocabulary, on the
    strip layout (no pager), and the launch counts exact: flash on
    ``flash_layers`` layers of every prefill call, isp decode on
    ``isp_layers`` of every step, paged decode never."""
    st = eng.stats
    assert eng.kv_layout == "strip" and eng.pager is None, tag
    assert len(results) == len(requests) and all(
        r.status == "ok" for r in results), [r.status for r in results]
    assert [len(r.tokens) for r in results] == [m for _, m in requests], tag
    assert all(0 <= t < cfg.vocab_size for r in results for t in r.tokens)
    assert prefill_calls > 0 and st.decode_steps > 0, tag
    assert launches["flash_attention"] == flash_layers * prefill_calls, \
        (tag, launches, prefill_calls)
    assert launches["isp_decode"] == isp_layers * st.decode_steps, \
        (tag, launches, st.decode_steps)
    assert launches["paged_decode"] == 0, (tag, launches)


def family_requests(cfg, seed, n=8):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, cfg.vocab_size,
                          int(rng.integers(16, 701))).tolist(), 32)
            for _ in range(n)]


def serve_twice(tag, cfg, params, requests, dev, check):
    """Serve ``requests`` at k_block 8 (checked by ``check``, reported),
    then at k_block 1: the same tokens.  Returns (the k_block 8 run's
    launches, its decode ms a step)."""
    eng, results, wall, launches, prefill_calls = serve(cfg, params,
                                                        requests, 8, dev)
    check(eng, results, launches, prefill_calls)
    serve_report(tag, eng, results, wall, launches, prefill_calls)
    st = eng.stats
    step_ms = st.decode_s * 1e3 / st.decode_steps
    log(f"[{tag}] prefill {warm_ms(phases(eng.tele, 'prefill')):.1f} ms a "
        f"warm call, TTFT p50 {st.latency.p50_ttft_s * 1e3:.1f} ms, host "
        f"{step_ms:.2f} ms a decode step")
    tokens = [r.tokens for r in results]
    del eng
    free_device()
    eng1, results1, wall1, _, _ = serve(cfg, params, requests, 1, dev)
    assert [r.tokens for r in results1] == tokens, \
        f"{tag}: k_block=1 and k_block=8 disagree"
    log(f"[{tag}] k_block=1 gives identical tokens ({wall1:.2f} s wall, "
        f"{eng1.stats.decode_s * 1e3 / eng1.stats.decode_steps:.2f} ms per "
        f"step)")
    del eng1
    free_device()
    return launches, step_ms


def profile_tick(cfg, params, requests, dev, label, step_ms):
    """A warm engine: one tick admits the requests, the next is profiled
    (decode only)."""
    from repro_torch.train.serve_loop import ServeEngine
    eng = ServeEngine(cfg, params, num_slots=8, max_len=1024, k_block=8,
                      device=dev)
    for prompt, max_new in requests:
        eng.submit(prompt, max_new=max_new)
    eng.step()
    profile_window(eng, label, step_ms=step_ms)
    del eng
    free_device()


def mla_decode_check(cfg, params, dev):
    """Layer 0's MLA in fp32 on the card: a prefill of 300 rows of seeded
    hidden states into a compressed strip, then one absorbed decode step
    (mla_apply) against the unabsorbed computation on the same cache: k =
    [wk_b ckv, rope key], v = wv_b ckv materialised for every cached row,
    plain masked softmax attention, wo.  Within MLA_REL_TOL of the
    output's largest value."""
    from repro_torch.models import attention as attn_mod
    from repro_torch.models.layers import apply_rope
    a = cfg.attn
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    mla = attn_mod.MLA(cfg32, torch.float32, dev)
    with torch.no_grad():
        for name, p in params.blocks[0].attn.named_parameters():
            getattr(mla, name).copy_(p.float())
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    B, S, D = 2, 300, cfg.d_model
    x = torch.randn(B, S + 1, D, generator=gen, device=dev)
    with torch.no_grad():
        _, pre = attn_mod.mla_apply(mla, x[:, :S], torch.arange(
            S, dtype=torch.int32, device=dev), cfg32, None, "prefill")
        cache = attn_mod.init_mla_cache(cfg32, B, 512, torch.float32, dev)
        cache["ckv"][:, :S] = pre["ckv"]
        cache["krope"][:, :S] = pre["krope"]
        cache["kpos"][:S] = pre["kpos"]
        pos = torch.tensor([S], dtype=torch.int32, device=dev)
        got, cache = attn_mod.mla_apply(mla, x[:, S:], pos, cfg32, cache,
                                        "decode")
        # unabsorbed, from the cache the step left
        q_nope, q_rope = attn_mod._mla_q(mla, x[:, S:], cfg32)
        q_rope = apply_rope(q_rope, pos[None, :], a.rope_base)
        n = S + 1
        ckv, kr = cache["ckv"][:, :n], cache["krope"][:, :n]
        k = torch.cat([torch.einsum("bsr,rhk->bshk", ckv, mla.wk_b),
                       kr[:, :, None].expand(-1, -1, cfg.num_heads, -1)], -1)
        v = torch.einsum("bsr,rhv->bshv", ckv, mla.wv_b)
        q = torch.cat([q_nope, q_rope], -1)[:, 0]              # (B, H, 192)
        s = torch.einsum("bhd,bshd->bhs", q, k) * (
            a.qk_nope_dim + a.qk_rope_dim) ** -0.5
        want = torch.einsum("bhs,bshv->bhv", torch.softmax(s, -1), v)
        want = torch.einsum("bhv,hvd->bd", want, mla.wo)[:, None]
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    assert torch.isfinite(got).all() and err <= MLA_REL_TOL * scale, \
        (err, scale)
    log(f"[deepseek mla] layer 0 in fp32: absorbed decode over the "
        f"compressed cache of {n} rows vs unabsorbed (k, v materialised, "
        f"plain attention): max abs err {err:.3g} against max |out| "
        f"{scale:.4g} (bound {MLA_REL_TOL:g} of it)")
    del mla, cache, pre, k, v
    free_device()


def deepseek_phase(dev):
    """deepseek-v2-236b in bf16 at every published width, depth cut to
    DEEPSEEK_LAYERS: 8 requests (prompts 16..700, max_new 32) through the
    engine on strips (MLA's compressed cache), k_block 8 then 1 (identical
    tokens), flash on every layer of every prefill call and no decode
    kernel (the absorbed decode is plain tensor code); one decode tick
    profiled; the MLA decode check.  Returns the k_block 8 run's
    launches."""
    from repro_torch.config import get_config
    from repro_torch.models import model as M
    full = get_config("deepseek-v2-236b")
    cfg = dataclasses.replace(full, num_layers=DEEPSEEK_LAYERS)
    a, m = cfg.attn, cfg.moe
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = M.init_params(cfg, gen, dev)
    torch.cuda.synchronize()
    log(f"[deepseek] deepseek-v2-236b bf16 at full width: d_model "
        f"{cfg.d_model}, {cfg.num_heads} MLA heads (q rank {a.q_lora_rank}, "
        f"kv rank {a.kv_lora_rank}, qk {a.qk_nope_dim} + {a.qk_rope_dim}, v "
        f"{a.v_head_dim}), {m.num_experts} experts of d_ff {m.d_ff_expert} "
        f"top-{m.top_k} + {m.num_shared_experts} shared of {m.d_ff_shared}, "
        f"vocab {cfg.vocab_size}; depth cut from {full.num_layers} to "
        f"{cfg.num_layers} layers (the whole model is "
        f"{M.count_params(full) / 1e9:.3f} B parameters, "
        f"{M.count_params(full) * 2 / 1e9:.1f} GB in bf16): "
        f"{M.count_params(cfg) / 1e9:.3f} B parameters "
        f"({cfg.active_param_count() / 1e9:.3f} B active), "
        f"{weight_gb(params):.2f} GB of weights, init "
        f"{time.perf_counter() - t0:.1f} s")
    compressed = (a.kv_lora_rank + a.qk_rope_dim) * 2
    unabsorbed = cfg.num_heads * (a.qk_nope_dim + a.qk_rope_dim
                                  + a.v_head_dim) * 2
    log(f"[deepseek] KV bytes a token a layer: {compressed} compressed "
        f"(ckv {a.kv_lora_rank} + rope key {a.qk_rope_dim}, bf16) against "
        f"{unabsorbed} for the unabsorbed per-head K/V "
        f"({unabsorbed / compressed:.1f}x)")
    requests = family_requests(cfg, SEED + 7)
    log(f"[deepseek] prompt lengths {[len(p) for p, _ in requests]}")
    L = cfg.num_layers
    launches, step_ms = serve_twice(
        "deepseek", cfg, params, requests, dev,
        lambda e, r, ln, pc: check_strip_serve("deepseek", cfg, e, r, ln, pc,
                                               requests, L, 0))
    profile_tick(cfg, params, requests, dev, "deepseek decode block tick",
                 step_ms)
    mla_decode_check(cfg, params, dev)
    del params
    free_device()
    return launches


def hymba_phase(dev):
    """hymba-1.5b whole in bf16: 8 requests (prompts 16..700, max_new 32;
    exact-length buckets, the Mamba state would integrate pad tokens)
    through the engine on strips, k_block 8 then 1 (identical tokens);
    flash on all 32 window layers of every prefill call, isp decode on all
    32 rings of every step; one decode tick profiled.  Returns the k_block
    8 run's launches."""
    from repro_torch.config import get_config
    from repro_torch.models import model as M
    cfg = get_config("hymba-1.5b")
    L = cfg.num_layers
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = M.init_params(cfg, gen, dev)
    torch.cuda.synchronize()
    assert all(b.ssm.a_log.dtype == torch.float32 for b in params.blocks)
    log(f"[hymba] hymba-1.5b bf16 whole: {L} hybrid layers, d_model "
        f"{cfg.d_model}, {cfg.num_heads} heads / {cfg.num_kv_heads} kv of dh "
        f"{cfg.resolved_head_dim}, window {cfg.attn.window}, Mamba d_in "
        f"{cfg.ssm.expand * cfg.d_model} x state {cfg.ssm.state_dim}, vocab "
        f"{cfg.vocab_size}; {M.count_params(cfg) / 1e9:.3f} B parameters, "
        f"{weight_gb(params):.2f} GB of weights, init "
        f"{time.perf_counter() - t0:.1f} s")
    requests = family_requests(cfg, SEED + 8)
    log(f"[hymba] prompt lengths {[len(p) for p, _ in requests]}")
    launches, step_ms = serve_twice(
        "hymba", cfg, params, requests, dev,
        lambda e, r, ln, pc: check_strip_serve("hymba", cfg, e, r, ln, pc,
                                               requests, L, L))
    profile_tick(cfg, params, requests, dev, "hymba decode block tick",
                 step_ms)
    del params
    free_device()
    return launches


def xlstm_phase(dev):
    """xlstm-125m whole in bf16 (6 mLSTM + 6 sLSTM blocks, no attention, no
    KV): 8 requests (prompts 16..700, max_new 32) through the engine,
    k_block 8 then 1 (identical tokens); no kernel launched, every weight
    and cache on the card; one sLSTM layer's sequential prefill timed."""
    from repro_torch.config import get_config
    from repro_torch.models import model as M
    from repro_torch.models import ssm as ssm_mod
    cfg = get_config("xlstm-125m")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = M.init_params(cfg, gen, dev)
    torch.cuda.synchronize()
    log(f"[xlstm] xlstm-125m bf16 whole: {cfg.num_layers} layers "
        f"{cfg.layer_pattern[:2]} x {cfg.num_layers // 2}, d_model "
        f"{cfg.d_model}, {cfg.ssm.num_heads} heads, vocab {cfg.vocab_size}; "
        f"{M.count_params(cfg) / 1e9:.4f} B parameters, "
        f"{weight_gb(params):.3f} GB of weights")
    requests = family_requests(cfg, SEED + 9)
    log(f"[xlstm] prompt lengths {[len(p) for p, _ in requests]}")

    def check(eng, results, launches, prefill_calls):
        check_strip_serve("xlstm", cfg, eng, results, launches,
                          prefill_calls, requests, 0, 0)
        assert sum(launches.values()) == 0, launches
        leaves = [t for g in eng.caches.values() for t in g.values()]
        assert leaves and all(t.device == dev for t in leaves)
        assert all(p.device == dev for p in params.parameters())
    launches, step_ms = serve_twice("xlstm", cfg, params, requests, dev,
                                    check)
    # one sLSTM layer's sequential prefill over the longest prompt's rows
    n = max(len(p) for p, _ in requests)
    b1 = params.blocks[1]
    assert b1.kind == "slstm"
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    x = torch.randn(8, n, cfg.d_model, generator=gen, device=dev).to(
        torch.bfloat16)
    with torch.no_grad():
        ssm_mod.slstm_apply(b1.core, x[:, :16], cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y, _ = ssm_mod.slstm_apply(b1.core, x, cfg)
        torch.cuda.synchronize()
    slstm_ms = (time.perf_counter() - t0) * 1e3
    assert torch.isfinite(y).all()
    log(f"[xlstm] one sLSTM layer's prefill over 8 x {n} rows: "
        f"{slstm_ms:.1f} ms host clock ({n} sequential steps, "
        f"{slstm_ms / n * 1e3:.0f} us a step)")
    del params
    free_device()
    return launches


def train_flops(cfg, model) -> tuple:
    """(model FLOPs of one train step at TRAIN_BATCH x TRAIN_SEQ, the block
    parameters, the head's): 6 * (block parameters + head) * tokens for
    the products, plus attention's causal score and value products, 4 *
    dh * pairs * H * B a layer forward and twice that backward.  The remat
    recompute is not counted (model FLOPs, not hardware FLOPs)."""
    tokens = TRAIN_BATCH * TRAIN_SEQ
    blocks = sum(p.numel() for p in model.blocks.parameters())
    head = model.head_table().numel()
    pairs = TRAIN_SEQ * (TRAIN_SEQ + 1) // 2
    attn = 3 * 4 * cfg.resolved_head_dim * pairs * cfg.num_heads \
        * TRAIN_BATCH * cfg.num_layers
    return 6 * (blocks + head) * tokens + attn, blocks, head


def profile_train_step(step_fn, state, batch, step_ms):
    """One train step under torch.profiler (CPU and CUDA activity), its
    device kernels split into the flash kernel, the plain attention
    backward, AdamW, the other GEMMs and the rest (each kernel attributed
    through its launching op to the labelled range it ran in), and the
    device's idle share of the step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.kernels import ref
    from repro_torch.launch import steps as S
    bwd, upd = ref.flash_attention_bwd, S.adamw_update

    def labelled(fn, label):
        def run(*a, **kw):
            with record_function(label):
                return fn(*a, **kw)
        return run
    ref.flash_attention_bwd = labelled(bwd, "plain attention backward")
    S.adamw_update = labelled(upd, "AdamW")
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _, _, m = step_fn(state.params, state.opt_state, batch)
            float(m["loss"])
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        ref.flash_attention_bwd, S.adamw_update = bwd, upd
    labels = ("plain attention backward", "AdamW")
    # device events, less the labels' own spans on the device timeline
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and e.name != "Command Buffer Full" and e.name not in labels]
    if not kern:
        log("[profile] train step: device time not measured (the profiler "
            "recorded no device events)")
        return
    busy, end = 0.0, -1.0
    for e in sorted(kern, key=lambda e: e.time_range.start):
        s0, s1 = e.time_range.start, e.time_range.end
        if s1 > end:
            busy += s1 - max(s0, end)
            end = s1
    total = sum(e.time_range.end - e.time_range.start for e in kern)
    parts, names = {}, {}
    gemm = re.compile(r"gemm|nvjet|xmma|cutlass|cublas", re.I)

    def walk(evt, label):
        if evt.name in labels:
            label = evt.name
        for kn in evt.kernels:
            if "flash_fwd" in kn.name:
                cls = "flash kernel (forward + remat recompute)"
            elif label:
                cls = label
            elif gemm.search(kn.name):
                cls = "GEMMs (model, head)"
            else:
                cls = "rest"
            parts[cls] = parts.get(cls, 0.0) + kn.duration
            key = (cls, kn.name)
            t, n = names.get(key, (0.0, 0))
            names[key] = (t + kn.duration, n + 1)
        for ch in evt.cpu_children:
            walk(ch, label)
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.cpu_parent is None:
            walk(e, None)
    parts["unattributed"] = max(total - sum(parts.values()), 0.0)
    log(f"[profile] train step: wall {wall_ms:.1f} ms (profiled), device "
        f"kernels {busy / 1e3:.1f} ms ({len(kern)} launches), idle share in "
        f"window {1 - busy / 1e3 / wall_ms:.1%}; against the unprofiled "
        f"median step {step_ms:.1f} ms: idle {1 - busy / 1e3 / step_ms:.1%}")
    for cls, us in sorted(parts.items(), key=lambda x: -x[1]):
        log(f"[profile] train step: {us / 1e3:9.1f} ms {us / total:6.1%}  "
            f"{cls}")
    # the three kernels that took the most time in each class
    for cls in parts:
        top = sorted(((us, n, name) for (c, name), (us, n) in names.items()
                      if c == cls), reverse=True)[:3]
        for us, n, name in top:
            log(f"[profile] train step:   {us / 1e3:8.1f} ms x{n:<5d} "
                f"[{cls.split(' (')[0]}] {name[:70]}")
    return {k: v / 1e3 for k, v in parts.items()}


def train_phase(dev):
    """yi-9b at every published width, depth cut to TRAIN_LAYERS, bf16
    with fp32 AdamW moments and remat "dots": TRAIN_STEPS steps through
    ``train_loop.train`` on SyntheticTokenSource batches of TRAIN_BATCH x
    TRAIN_SEQ, no checkpoint.  Every step's loss and grad norm finite;
    flash launched on every layer twice a step (forward and the remat
    recompute), no other kernel; the median step, tokens/s, model FLOPs
    against the bf16 peak, peak memory; one step profiled; then four
    steps on one repeated batch at lr 1e-4 must lower its loss."""
    from repro_torch.config import ShapeConfig, get_config
    from repro_torch.data import DataConfig, ShardedLoader, \
        SyntheticTokenSource
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as S
    from repro_torch.models import model as M
    from repro_torch.optim import AdamWConfig
    from repro_torch.sharding import make_plan, make_recipe
    from repro_torch.train import train_loop as TL
    cfg = dataclasses.replace(get_config("yi-9b"), num_layers=TRAIN_LAYERS)
    assert cfg.remat == "dots" and cfg.optimizer_state_dtype == "float32"
    n = M.count_params(cfg)
    log(f"[train] yi-9b bf16 at full width (d_model {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads of dh "
        f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}),"
        f" depth cut from 48 to {cfg.num_layers} layers: {n / 1e9:.3f} B "
        f"parameters ({n * 12 / 1e9:.1f} GB of bf16 weights and gradients "
        f"and fp32 moments); remat {cfg.remat!r}, attn_chunk "
        f"{cfg.attn_chunk}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dcfg = DataConfig(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                      vocab_size=cfg.vocab_size, seed=SEED)
    tcfg = TL.TrainConfig(steps=TRAIN_STEPS, log_every=1, ckpt_every=10**9,
                          seed=SEED)
    mets = []
    ops.reset_launch_counts()
    state = TL.train(cfg, dcfg, tcfg, device=dev,
                     metrics_cb=lambda step, m: mets.append(m))
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    assert state.step == TRAIN_STEPS and len(mets) == TRAIN_STEPS
    for m in mets:
        assert math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"]), m
    want = {k: 0 for k in launches}
    want["flash_attention"] = 2 * TRAIN_LAYERS * TRAIN_STEPS
    assert launches == want, (launches, want)
    step_s = sorted(m["step_time_s"] for m in mets[1:])
    med_ms = float(np.median(step_s)) * 1e3
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops, blocks, head = train_flops(cfg, state.params)
    share = flops / (med_ms / 1e3) / PEAK_FLOPS[torch.bfloat16]
    log(f"[train] {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens: "
        f"losses {[round(m['loss'], 4) for m in mets]}, grad norms "
        f"{[round(m['grad_norm'], 3) for m in mets]}; launches {launches}")
    log(f"[train] step times (host clock, ms) "
        f"{[round(m['step_time_s'] * 1e3, 1) for m in mets]}: median after "
        f"the first {med_ms:.1f} ms, {tokens / med_ms * 1e3:.0f} tokens/s; "
        f"model FLOPs a step {flops / 1e12:.2f} T (6 x ({blocks / 1e9:.3f} B "
        f"block + {head / 1e9:.3f} B head parameters) x {tokens} tokens + "
        f"attention), {flops / (med_ms / 1e3) / 1e12:.1f} TFLOP/s = "
        f"{share:.1%} of the 989 TFLOP/s dense bf16 peak; peak memory "
        f"{peak / 1e9:.2f} GB")
    # one more step profiled, on the next batch, with the loop's schedule
    recipe = make_recipe(make_plan(None, cfg), cfg,
                         ShapeConfig(TRAIN_SEQ, TRAIN_BATCH))
    step_fn, _ = S.build_train_step(
        cfg, recipe, AdamWConfig(lr=tcfg.lr),
        {"warmup": tcfg.warmup, "total": tcfg.steps}, device=dev)
    loader = ShardedLoader(SyntheticTokenSource(dcfg.vocab_size, dcfg.seed),
                           dcfg)
    parts = profile_train_step(step_fn, state,
                               loader.global_batch_at(TRAIN_STEPS), med_ms)
    # a repeated batch: four steps on it must lower its loss (at lr 1e-4
    # with no warmup: AdamW moves each weight by about lr a step whatever
    # its gradient's scale, and 1e-3 overshoots by the third step, ~6% of
    # a fan-in-scaled bf16 weight a step)
    fit_fn, _ = S.build_train_step(cfg, recipe, AdamWConfig(lr=1e-4),
                                   {"warmup": 0, "total": 10**6}, device=dev)
    batch = loader.global_batch_at(0)
    fit = [float(fit_fn(state.params, state.opt_state, batch)[2]["loss"])
           for _ in range(4)]
    with torch.no_grad():
        after, _ = M.loss_fn(state.params, {
            k: torch.as_tensor(v, device=dev) for k, v in batch.items()}, cfg)
    fit.append(float(after))
    assert all(math.isfinite(x) for x in fit) and fit[-1] < fit[0], fit
    log(f"[train] one repeated batch, 4 steps at lr 1e-4: loss {fit[0]:.4f} "
        f"-> {fit[-1]:.4f} ({[round(x, 4) for x in fit]})")
    del state, step_fn, fit_fn
    free_device()
    return launches, dict(median_step_ms=med_ms,
                          tokens_per_s=tokens / med_ms * 1e3,
                          model_tflop=flops / 1e12, peak_share=share,
                          peak_gb=peak / 1e9, profile_ms=parts)


def elastic_phase(dev):
    """Kill and resume through the normal entry points:
    ``launch.elastic.supervise`` runs the train CLI on xlstm-125m (whole, 6
    steps of 4 x 256, a checkpoint every 2) with REPRO_FAIL_AT_STEP=3 and a
    marker.  The first attempt must die at step 3 (exit 42), the relaunch
    resume from the last committed checkpoint and finish at step 6; its
    final checkpoint must equal an uninterrupted in-process 6-step run
    from the same seed bit for bit.  Tolerance 0: every operation on this
    path is deterministic on the card (cuBLAS products, the embedding's
    index backward, which CUDA sums through a sort and not with atomics,
    the loss's gather, which adds one value to each element), and the
    checkpoint restores bf16 and fp32 bits exactly."""
    import shutil
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.config import get_config
    from repro_torch.data import DataConfig
    from repro_torch.launch.elastic import supervise
    from repro_torch.train import train_loop as TL
    work = ROOT / "build" / "elastic_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    ck, out = work / "ckpt", work / "train.log"
    args = ["--arch", "xlstm-125m", "--steps", "6", "--ckpt-every", "2",
            "--seq-len", "256", "--global-batch", "4", "--log-every", "1",
            "--ckpt-dir", str(ck)]
    cmd = ["bash", "-c", 'set -o pipefail; "$0" -m repro_torch.launch.train '
           '"$@" 2>&1 | tee -a "$REPRO_TRAIN_LOG"', sys.executable] + args
    t0 = time.perf_counter()
    res = supervise(cmd, max_restarts=2, timeout_s=600, env={
        "PYTHONPATH": str(ROOT / "src"), "REPRO_FAIL_AT_STEP": "3",
        "REPRO_FAIL_MARKER": str(work / "marker"),
        "REPRO_TRAIN_LOG": str(out)})
    wall = time.perf_counter() - t0
    text = out.read_text()
    log(f"[elastic] supervise: {res.log}, {wall:.1f} s wall")
    assert res.returncode == 0 and res.restarts == 1, res
    assert "rc=42" in res.log[0] and "rc=0" in res.log[1], res.log
    assert text.count("[elastic] injected failure at step 3") == 1
    assert "[train] done at step 6" in text
    resumed = re.findall(r"\[train\] resumed from step (\d+)", text)
    resumed_from = int(resumed[0]) if resumed else 0
    assert len(resumed) <= 1 and resumed_from in (0, 2), resumed
    cfg = get_config("xlstm-125m")
    ckpt_bytes = sum(f.stat().st_size for f in (ck / "step_000000006")
                     .iterdir())
    t0 = time.perf_counter()
    clean = TL.train(cfg, DataConfig(seq_len=256, global_batch=4,
                                     vocab_size=cfg.vocab_size, seed=0),
                     TL.TrainConfig(steps=6, log_every=10**9,
                                    ckpt_every=10**9, seed=0), device=dev)
    clean_s = time.perf_counter() - t0
    tree = {"params": dict(clean.params.named_parameters()),
            "opt": clean.opt_state}
    got, man = restore_checkpoint(ck, tree)
    assert man["step"] == 6
    from repro_torch.checkpoint.checkpoint import _flatten
    want, have = _flatten(tree), _flatten(got)
    diff = {k: float((have[k].double() - want[k].detach().double()).abs()
                     .max()) for k in want}
    unequal = [k for k in want if not torch.equal(have[k],
                                                  want[k].detach())]
    log(f"[elastic] xlstm-125m bf16 whole, 6 steps of 4 x 256: the "
        f"supervised run died at step 3 (exit 42), resumed from step "
        f"{resumed_from} and finished at 6; its final checkpoint "
        f"({ckpt_bytes / 1e9:.2f} GB) against an uninterrupted in-process "
        f"run ({clean_s:.1f} s): {len(want) - len(unequal)}/{len(want)} "
        f"leaves bit-equal, max abs diff {max(diff.values()):.3g}")
    assert not unequal, unequal[:5]
    del clean, got, tree
    shutil.rmtree(work, ignore_errors=True)
    free_device()
    return resumed_from


def build_kernels() -> None:
    """Build every kernel (one nvcc per source, in parallel) and print
    ptxas's register and spill lines for every instantiation."""
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build_s = build.build()
    log(f"[device] kernel build {build_s:.2f} s (wall "
        f"{time.perf_counter() - t0:.2f} s), libraries in {build.BUILD_DIR}")
    for n, out in build.BUILD_LOGS.items():
        fn = "?"
        for line in out.splitlines():
            if "Function properties for" in line:
                fn = line.split("Function properties for")[-1].strip()
            elif "Compiling entry function" in line:
                fn = line.split("'")[1]
            if "registers" in line or "spill" in line:
                log(f"[device] ptxas {n} {fn}: {line.strip()}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--times", action="store_true", help=(
        "only time isp_gather and isp_gather_pool at their path shapes "
        "under both L2 flushes (and isp decode on the rings), and print "
        "them as one JSON line; for running two trees' kernels in turns"))
    parser.add_argument("--flash-times", action="store_true", help=(
        "only time flash at its six serve paths' shapes without lse and "
        "print them as one JSON line; for running two trees in turns"))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs an H100",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.config import get_config
    from repro_torch.device import resolve_device
    from repro_torch.models import model as M

    t_start = time.perf_counter()
    dev = resolve_device("cuda:0")
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log(smi)
    log(f"[device] {name}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, python {sys.version.split()[0]}")
    if args.times:
        from repro_torch.kernels import build
        secs = build.build(["isp_gather", "isp_gather_pool", "isp_decode"])
        log(f"[device] kernel build {secs:.2f} s")
        log(json.dumps({"times": times_phase(dev), "device": smi}))
        return 0
    if args.flash_times:
        from repro_torch.kernels import build
        secs = build.build(["flash_attention"])
        log(f"[device] kernel build {secs:.2f} s")
        log(json.dumps({"flash_times": flash_times_phase(dev),
                        "device": smi}))
        return 0
    build_kernels()

    def lap(phase):
        log(f"[time] {phase} done at {time.perf_counter() - t_start:.1f} s")

    rows = kernel_phase(dev)
    app_rows, app_launches = apps_phase(dev)
    rows += app_rows
    free_device()
    lap("kernels and apps")

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
    check_serve("serve", cfg, eng, results, launches, prefill_calls,
                requests)
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
    del eng, eng1
    free_device()
    lap("serve and consistency")

    # -- chunked prefill in bf16, then the cluster tier ------------------------
    chunk_bf16_phase(cfg, params, dev, requests,
                     [r.tokens for r in results])
    lap("chunked bf16")
    cluster_phase(cfg, params, dev)
    del params
    free_device()
    lap("cluster")

    # -- strip layout, then gemma3-12b -----------------------------------------
    path_launches["yi-9b strip"] = strip_phase(dev, requests)
    lap("strip and chunked fp32")
    (path_launches["gemma3-12b serve"],
     path_launches["gemma3-12b plan"]) = gemma_phase(dev)
    lap("gemma3-12b and plan")

    # -- the other model families: llama4-scout's MoE, musicgen-large whole
    path_launches["llama4-scout serve"] = llama4_phase(dev)
    lap("llama4-scout")
    (path_launches["musicgen-large serve"],
     path_launches["musicgen-large frontend"]) = musicgen_phase(dev)
    lap("musicgen-large")
    path_launches["deepseek-v2 serve"] = deepseek_phase(dev)
    lap("deepseek-v2")
    path_launches["hymba serve"] = hymba_phase(dev)
    lap("hymba-1.5b")
    path_launches["xlstm serve"] = xlstm_phase(dev)
    lap("xlstm-125m")

    # -- training: yi-9b at 8 layers on the card, then kill and resume ------
    path_launches["yi-9b train"], train = train_phase(dev)
    lap("train yi-9b")
    elastic_phase(dev)
    lap("kill and resume")
    for row in rows:
        row["launches"] = path_launches[row["path"]][row["kernel"]]
    log(f"[done] total {time.perf_counter() - t_start:.1f} s")

    log(json.dumps({"train": train}))
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
