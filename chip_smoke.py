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
                decode's edges at hymba's heads too) and at the smoke head
                dims (SMOKE_HEADS: dh 16 at groups 1 and 4, the reduced
                MLA's qk 24 / v 16; rows at the smoke paths' shapes,
                SMOKE_FLASH_PATHS, SMOKE_TRAIN_FLASH); paged decode at
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
                freed block of a full one (exactly 0); then, for the
                energy phase, recommender batches (Q = 256, fp32 corpus)
                and sentiment batches (fp32) back to back for
                ENERGY_WINDOW_S each, the card's joules read around them;
  3b. smoke   — every reduced config of configs.ASSIGNED in bfloat16 (4
                heads over 4 at dh 16; deepseek-v2's MLA at qk 16 + 8 / v
                16) and reduced yi-9b in float32 (the reference's bench
                cell) through ServeEngine as the serve CLI builds it for
                --requests 8 at its other defaults (prompts 4..32,
                max_new 32, max_len 256, 8 slots, paged, pages of 16,
                k_block 8), on the card and on
                the CPU from the same weights: all ok, balanced free
                lists, flash on every attention layer of every prefill
                call and paged or isp decode on every attention layer of
                every step (nothing launched on the CPU); fp32 tokens
                identical, bf16 flips only below BF16_FLIP_MARGIN; then
                three steps of the train CLI's path (train_loop.train, 8 x
                256) for reduced yi-9b and deepseek-v2: finite losses,
                flash (with lse, at (16, 16) and (24, 16)) on every layer
                of every step, step 0's loss within SMOKE_LOSS_TOL of the
                CPU's;
  3c. cli     — the port's serve CLI (launch/serve.py's main, in this
                process under a patched sys.argv, no --device) on the
                card: yi-9b at full width and CLI_LAYERS = 8 of 48 layers
                in bfloat16 with --trace FILE, a file written under build/
                from seed 0 of CLI_REQUESTS = 8 prompts of 16..700 tokens,
                four with a "| max_new" tail, a comment and a blank line
                (--max-len 1024, --num-slots 8, paged, k_block 8,
                --trace-out): exit 0, the file's requests submitted as
                written, all ok with their own max_new tokens, flash on
                every layer of every prefill call and paged decode on
                every layer of every step, and the tokens of a ServeEngine
                built as the CLI builds it on the same seed's weights and
                fed the same list; then "--arch yi-9b --smoke" with no
                other flag (the reference's defaults: 4 prompts of 32
                tokens) exits 0, and an empty trace file exits 1;
  4. serve    — full-width, full-depth yi-9b in bfloat16 with seeded random
                weights: 16 requests with prompt lengths in 16..700 and
                max_new=32 through ServeEngine(num_slots=8, max_len=1024,
                page_size=16, k_block=8); every request must end ok, the
                page free list must balance, and the launch counters must
                show the flash kernel on every layer of every prefill call
                and the paged-decode kernel on every layer of every step;
                the run is an energy window (joules a generated token);
  5. consistency — the same requests with k_block=1 give identical tokens;
     then two engine ticks under torch.profiler (CUDA activity) show where
     the device time goes and how much of a decode step the card sits idle;
  6. chunked  — yi-9b at full width, its depth cut to CHUNK_LAYERS = 8
                of 48, on the same requests one-shot and then with
                chunk_prefill=256 at chunk
                budgets 1 and 2: all ok, a balanced free list, the kernels
                on every layer of every one-shot prefill call and step, the
                chunk calls (the plain masked attention) counted from the
                telemetry hub, prefill ms a call and a chunk, TTFT; the
                one-shot tokens (a flip only below BF16_FLIP_MARGIN); one
                chunk call profiled;
  7. cluster  — four drives (ClusterEngine, 8 slots each, 256-row chunks)
                over one yi-9b at full width, its depth cut to
                CLUSTER_LAYERS = 4 of 48 layers: CLUSTER_REQUESTS = 16
                requests (prompts 16..700, max_new 32; 32 before the train
                phases came) served
                serially give one engine's tokens with balanced
                free lists, a merged ledger equal to the drives' plus the
                spill ledger, and peak memory under the weights plus four
                pools plus CLUSTER_MEM_MARGIN; data_local over 4 shards with
                drive 1 crashed at tick 3 (the 16 requests, 16 tokens):
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
  9. gemma3   — full-width gemma3-12b in bfloat16, its depth cut to
                GEMMA_LAYERS = 12 of 48 (10 window layers on per-slot
                rings, 2 global layers on the paged pool; whole before the
                two-rank phase): 16 requests with prompt lengths in
                16..1500, two of
                them 1000-token prompts with max_new=64 so their rings wrap
                while decoding, through ServeEngine(num_slots=8,
                max_len=2048, page_size=16, k_block=8); all ok, a balanced
                free list, the flash kernel on every layer of every
                prefill call, the isp-decode kernel on the 10 window layers
                and the paged-decode kernel on the 2 global layers of every
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
                kernels exactly as on the uniform path (flash 12 per prefill,
                isp decode 12 per step); embed_lookup under the plan
                bit-equal to gather_baseline; decode ms per step and peak
                memory with and without the recipe, in turns (plan, no
                plan, no plan, plan); the process group is torn down at the
                end;
  11. llama4  — llama4-scout-17b-a16e in bfloat16 at every published width
                (d_model 5120, 40/8 heads of dh 128, 16 experts of d_ff 8192
                top-1 + one shared, vocabulary 202,048), its depth cut from
                48 to LLAMA4_LAYERS = 4 layers to fit one card and the
                script's time: 8 requests
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
  14. hymba   — hymba-1.5b at full width, its depth cut to HYMBA_LAYERS
                = 8 of 32 hybrid layers (window-1024 GQA at 25
                heads over 5 of dh 64 beside Mamba) in bfloat16: 8 requests
                as above in exact-length buckets on strips; all ok, flash on
                every layer of every prefill call, isp decode on every
                ring of every step; k_block=1 gives identical tokens; one
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
  16b. roofline — the port's analysis layer (repro_torch/analysis) on the
                train phase's model: one yi-9b train step counted by its op
                recorder, the next profiled, the next timed with its peak
                memory; then one decode tick of the same model on the
                paged layout (8 slots over 4096 rows) counted, timed and
                profiled.  Printed for each: the counted FLOPs and HBM
                bytes, the roofline step at the H100's peaks against the
                measured step, the MFU (the reference's definition, and
                the train phase's share for the train step), the kernels
                by device time beside their counted bounds, the predicted
                peak (arguments + counted temporaries) against
                max_memory_allocated.  Asserted: no kernel site's and no
                step's bound over 105% of its measured time, the peak
                within 20%, each kernel launched as counted.  Meanwhile
                three production cells dry-run on the CPU in their own
                processes (yi-9b train_4k and prefill_32k, gemma3-12b
                decode_32k, each one rank of the 16 x 16 pod): bytes a
                rank against 80 GB, the three terms, the dominant one, the
                MFU; the same train step on the next batches and the same
                decode tick are then each run back to back for
                ENERGY_WINDOW_S, the card's joules read around them;
  16c. energy — the card's energy counter (NVML's total-energy counter
                through ctypes; nvidia-smi's power samples every 100 ms
                integrated beside it) around four calibration windows of
                ENERGY_WINDOW_S with known FLOPs and bytes (idle with the
                context alive, bf16 GEMMs of 8192^3, device copies of a
                4 GB buffer, the two in turns); the least-squares fit of
                E = P0 t + a F + b B gives core/energy.py's CHIP_IDLE_W,
                PJ_PER_FLOP and PJ_PER_HBM_BYTE; every calibration window
                predicted within ENERGY_CAL_TOL and the roofline phase's
                held-out windows (their counted FLOPs and bytes through
                gpu_step_energy) within ENERGY_HELD_TOL; the joules a
                generated token, a recommender query and a sentiment
                review, beside the cluster phase's Table I line; every
                joule figure with its source;
  17. elastic — launch.elastic.supervise runs the train CLI on xlstm-125m
                at full width and ELASTIC_LAYERS = 4 of its 12 layers
                (6 steps of 4 x 256, a checkpoint every 2) with
                REPRO_FAIL_AT_STEP=5 and a marker: it dies once (exit 42),
                resumes from a committed checkpoint (step 2 or 4: at 4
                layers a step is shorter than a checkpoint's write, and
                the save at step 4 waits for step 2's) and finishes at
                6; its final checkpoint equals an uninterrupted in-process
                run from the same seed bit for bit;
  18. mesh    — two ranks share the one card (two processes on cuda:0,
                a (1, 2) ("data", "model") mesh in a gloo group over CUDA
                tensors: NCCL refuses two ranks on one device) and serve
                through ServeEngine(recipe=...) (num_slots=8,
                max_len=1024, k_block=8; mesh_cases): yi-9b at full width
                and MESH_LAYERS = 16 of 48 layers in bf16
                (TP 2 on the block weights, SP in prefill, the paged
                engine, decode on the strips over the model axis) and at
                MESH_FP32_LAYERS = 4 in fp32, deepseek-v2 at full width
                in bf16 (MESH_DEEPSEEK_LAYERS = 4) and fp32 (2 layers),
                EP 2 over its 160 experts at full capacity and MLA decode
                under sequence sharding; then each case with no plan in
                this process: fp32 tokens identical, bf16 flips only
                below BF16_FLIP_MARGIN; the first-prefill logits of
                MESH_LOGIT_PROMPTS = 2 prompts within MESH_LOGIT_TOL of
                the one-rank logits (the largest difference over their
                RMS); both ranks the same tokens; flash
                on every layer of every prefill call, isp decode on every
                layer of every paged step (the strips' blocks), paged
                decode never, isp_gather on the vocabulary shard; each
                rank's weights and peak memory beside the one-rank run's;
                a yi-9b decode step's time in gloo collectives (through
                the host, not NCCL) beside its profiled kernel time, on
                a warm engine of MESH_TIMING_K = 2 steps a tick whose
                8 requests are the first 16 tokens of the served ones;
  19. mesh train — the same two ranks then train (mesh_train_cases,
                steps.build_train_step under the (1, 2) mesh's plan, AdamW
                at lr 1e-4 on one repeated seeded batch): yi-9b at full
                width and MESH_TRAIN_LAYERS = 8 of 48 layers in bf16, 2 x
                2048 tokens, 4 steps, TP 2 with SP, remat "dots", the
                vocab-sharded lookup (isp_gather with its backward) and
                loss head; llama4-scout at full width and 1 of 48 layers
                in bf16, 2 x 256 tokens, 3 steps, EP 2 over 16 experts at
                full capacity (the all_to_all backward); yi-9b at 2
                layers in fp32, 2 x 256 tokens.  Step 0's gradients are
                those the first step applies (its lr is 0).  Checks:
                finite losses that fall, the same on both ranks; flash
                twice a layer a step and isp_gather once a step on each
                rank; the embedding's and head's gradient pieces nonzero;
                step 0 against one rank (in this process, same seed and
                batch): the bf16 loss (llama4's cross-entropy) within
                MESH_TRAIN_LOSS_TOL and the embedding's and head's pieces
                within MESH_TRAIN_GRAD_TOL of the leaf's max |grad|; in
                fp32 (on each rank) the loss within 1e-5 and every piece
                within 1e-4; optim.compressed_psum over the two ranks
                within the reference test's bound (2 x 2 x amax / 127),
                its mean error within 4 standard errors of 0.  Printed:
                each rank's peak memory beside one rank's for the same
                steps (llama4: one rank's forward), ms a step beside one
                rank's, a yi-9b step's gloo ms against its profiled
                kernel ms, and the launch counts a step.
The kernel phase also holds flash, isp decode and isp_gather to their
plain versions at one rank's shapes of the two-rank yi-9b path (16 of
32 query heads over 2 of 4 KV heads; a 512-row block of a 1024-row strip
view with every head; a 32000-row vocabulary shard) and times them, and
flash with lse and isp_gather at one rank's shapes of the two-rank yi-9b
train path (16 of 32 heads over 2 of 4 at 2 x 2048 rows; the 32000-row
shard for 2 x 2048 ids).
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

    python3 chip_smoke.py --mesh

builds the kernels and runs only the two-rank phase, serve and train.

    python3 chip_smoke.py --cli

builds flash and paged decode and runs only the cli phase.

    python3 chip_smoke.py --roofline

builds the kernels and runs only the train phase, the roofline phase and
the energy phase (whose item windows then are none).
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
import traceback
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# the card's peaks and the kernels' operation and byte counts are the
# port's (analysis/roofline.py, analysis/op_trace.py)
from repro_torch.analysis.op_trace import KERNEL_COSTS  # noqa: E402
from repro_torch.analysis.roofline import bound, peak_flops  # noqa: E402

SEED = 0
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
# the reduced (smoke) configs on the card: every reduced config of
# configs.ASSIGNED has 4 heads over 4 kv heads at dh 16, and the reduced
# MLA attends at qk 16 + 8 / v 16; flash at the serve CLI's prompt bucket
# (8 x 32 rows) and the train CLI's batch (8 x 256, attn_chunk 32), paged
# decode on pages of 16 under the CLI's max_len of 256, isp decode on
# gemma3's local rings (window 32)
SMOKE_FLASH_PATHS = (
    ("smoke serve", (8, 32, 4, 4, 16, 16, None)),
    ("smoke serve", (8, 32, 4, 4, 24, 16, None)))
SMOKE_TRAIN_FLASH = (((8, 256, 4, 4, 16), 16), ((8, 256, 4, 4, 24), 16))
SMOKE_CHUNK = 32
# (H, Hkv, q/k head dim, v head dim) of the edges at the smoke head dims:
# the reduced configs' heads, a group of 4, the reduced MLA
SMOKE_HEADS = ((4, 4, 16, 16), (8, 2, 16, 16), (4, 4, 24, 16))
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


def site_bound(name: str, *args, **kwargs):
    """``bound`` of one kernel call from its site's operation and byte
    counts (``analysis.op_trace.KERNEL_COSTS``, what the step counter
    counts): (ms, bound_by, bytes)."""
    c = KERNEL_COSTS[name](*args, **kwargs)
    return bound(c.bytes, c.flops, c.dtype) + (c.bytes,)


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
    heads (25 over 5 at dh 64).  "smoke ring": the reduced gemma3's local
    layers, rings kpos (8, 32) at window 32, 4 heads over 4 at dh 16,
    wrapped slots, an empty slot (3) and a slot with fewer keys than the
    window (7)."""
    if layout == "shared":
        B, H, Hkv, dh, S, window = 8, 32, 4, 128, 1024, None
        pos = torch.arange(S, dtype=torch.int32)
        kpos = torch.where(pos < S // 2, pos, -1)
        cur = torch.tensor(S // 2 - 1, dtype=torch.int32)
    elif layout == "smoke ring":
        B, S, window, H, Hkv, dh = 8, 32, 32, 4, 4, 16
        now = [40, 63, 31, 0, 50, 32, 60, 5]
        kpos = ring_tracks(now, S, empty=(3,))
        cur = torch.tensor(now, dtype=torch.int32)
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
    """Split-K edges of paged_decode at both serve shapes, at NEW_HEADS
    and at the smoke head dim 16 (SMOKE_HEADS), in both dtypes, against
    the plain version: slots whose
    lengths fill whole split spans (and one key more or less), an empty
    slot, a one-key slot, a full table; then a window whose edge falls
    inside a span."""
    from repro_torch.kernels import paged_decode as pd
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for H, Hkv, dh, maxp, window in ((32, 4, 128, 64, 100),
                                     (16, 8, 240, 128, 300)) + tuple(
            (H, Hkv, dh, 64, 100) for H, Hkv, dh in NEW_HEADS) + tuple(
            (H, Hkv, dh, 64, 100) for H, Hkv, dh, dv in SMOKE_HEADS
            if dh == dv):
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
    """Split-K edges of isp_decode at both strip shapes, hymba's heads
    and the smoke head dim 16, in both dtypes, with and without a window,
    against the plain version.  Per-slot tracks
    kpos (8, 1024): slots whose valid rows fill whole spans (and one row
    more or less), an empty slot, a one-row slot (its later spans empty), a
    full strip, a ring whose valid rows wrap across a span edge; the same
    tracks on k/v views whose rows are not 16-byte aligned (the kernel's
    element-load branch); and the shared track kpos (1024,) with its first
    span empty and its valid rows ending inside a span."""
    from repro_torch.kernels import isp_decode as isp
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    B, S = 8, 1024
    for H, Hkv, dh in ((32, 4, 128), (16, 8, 240), (25, 5, 64)) + tuple(
            (H, Hkv, dh) for H, Hkv, dh, dv in SMOKE_HEADS if dh == dv):
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
    """flash_attention edges at both serve head dims, at NEW_HEADS, at
    MLA's qk 192 / v 128 (MLA_HEADS: a wrong v stride or output width
    shows only where the two dims differ) and at the smoke head dims
    (SMOKE_HEADS: dh 16, and qk 24 / v 16, padded to two k-steps of the
    MMA in bf16 and read in float2 groups in fp32), in both dtypes, against the
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
            (H, Hkv, dh, dh, (None, 48)) for H, Hkv, dh in NEW_HEADS) + \
            tuple(h + ((None, 48),) for h in SMOKE_HEADS):
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


def flash_train_row(dev, gen, flush, path="yi-9b train", shape=TRAIN_FLASH,
                    dv=None, chunk=TRAIN_CHUNK):
    """Flash with lse at a train path's shape (by default TRAIN_FLASH:
    yi-9b at 4096 rows, causal; ``dv`` the v head dim, dh's by default;
    ``chunk`` the config's attn_chunk), bf16 and fp32: out and lse against
    the plain ``chunked_attention(return_lse=True)``; the differentiable
    op's dq/dk/dv (the kernel's forward) against the plain forward's, both
    through the plain backward; then timed with lse beside its bound, the
    plain version, SDPA's forward and the kernel without lse, and one
    layer's plain backward timed."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    B, S, H, Hkv, dh = shape
    dv = dh if dv is None else dv
    ck = dict(q_chunk=chunk, kv_chunk=chunk)
    errs, lerrs, gerrs = {}, {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        r = lambda *s: torch.randn(*s, generator=gen).to(dev, dtype)
        q, k, v, dout = r(B, S, H, dh), r(B, S, Hkv, dh), r(B, S, Hkv, dv), \
            r(B, S, H, dv)
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
        log(f"[kernels] flash_attention {path} {dtype} (B={B} S={S} "
            f"H={H} Hkv={Hkv} dh={dh} dv={dv}, with lse): out max abs err "
            f"{errs[dtype]:.3g}, lse {lerrs[dtype]:.3g}; dq/dk/dv with the "
            f"kernel's forward vs the plain forward's, max err / max |grad| "
            f"{gerrs[dtype]:.3g} (bound {GRAD_REL_TOL[dtype]})")
        del qq, kk, vv, got, plain, want, wlse, out, lse
    # q/k/v/dout: the bf16 inputs of the last iteration
    bound_ms, bound_by, _ = site_bound("flash_attention", q, k, v,
                                       return_lse=True)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    row = dict(
        name="flash_attention", kernel="flash_attention", path=path,
        route="cuda", source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:77", dtype="bfloat16",
        shape=f"B={B} S={S} H={H} Hkv={Hkv} dh={dh} dv={dv} causal, with lse",
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
    log(f"[kernels] flash_attention {path}: with lse {row['ms']:.4f} "
        f"ms, without {row['ms_no_lse']:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}), plain forward {row['plain_ms']:.4f} ms, SDPA "
        f"forward {row['library_ms']:.4f} ms; one layer's plain backward "
        f"(bf16 inputs, fp32 math) {row['plain_bwd_ms']:.4f} ms")
    return row


def flash_lse_edges(dev, gen):
    """Flash with lse at the edge head shapes (both serve head dims, MLA's
    qk 192 / v 128, NEW_HEADS, SMOKE_HEADS), both dtypes: Sq not a multiple of the q
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
        (H, Hkv, dh, dh) for H, Hkv, dh in NEW_HEADS) + SMOKE_HEADS
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
        # rows read + written, ids
        bound_ms, bound_by, nbytes = site_bound("isp_gather", table, idx)
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


def tp2_rows(dev, gen, flushes):
    """The kernels of the two-rank yi-9b path at one rank's shapes: flash
    on the rank's 16 of 32 query heads over its 2 of 4 KV heads (prompts
    up to 128 rows), isp decode on the rank's block of the strip view
    (rows 0..511 of each slot's 1024, every head: q is gathered whole
    before the sequence-sharded decode), and isp_gather on the rank's
    32000 x 4096 vocabulary shard for a decode step's 8 ids (about half
    of them on the other shard).  Each held to its plain version, then
    timed beside it, its bound and, for flash and the gather, the library
    call."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import isp_decode as isp
    from repro_torch.kernels import isp_gather as ig
    from repro_torch.kernels import ref
    flush = flushes[0]
    path = "yi-9b tp2 serve"
    rows = []
    B, S, H, Hkv, dh = 8, 128, 16, 2, 128
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        r = lambda *s: torch.randn(*s, generator=gen).to(dev, dtype)  # noqa
        q, k, v = r(B, S, H, dh), r(B, S, Hkv, dh), r(B, S, Hkv, dh)
        errs[dtype] = max_err([fa.flash_attention(q, k, v)],
                              [ref.chunked_attention(q, k, v)], dtype)
    bound_ms, bound_by, _ = site_bound("flash_attention", q, k, v)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows.append(dict(
        name="flash_attention", kernel="flash_attention", path=path,
        route="cuda", source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:77", dtype="bfloat16",
        shape=f"B={B} S={S} H={H} Hkv={Hkv} dh={dh} causal (one rank's "
        f"heads)", max_abs_err=errs[torch.bfloat16],
        max_abs_err_fp32=errs[torch.float32],
        ms=time_ms(lambda: fa.flash_attention(q, k, v), flush),
        plain_ms=time_ms(lambda: ref.chunked_attention(q, k, v), flush),
        bound_ms=bound_ms, bound_by=bound_by,
        library_ms=time_ms(lambda: sdpa(qt, kt, vt, is_causal=True,
                                        enable_gqa=True), flush)))
    del q, k, v, qt, kt, vt

    B, H, Hkv, dh, S = 8, 32, 4, 128, 512
    cur = torch.tensor([271, 100, 16, 0, 300, 1, 257, 700],
                       dtype=torch.int32)
    j = torch.arange(S, dtype=torch.int32)
    kpos = torch.where(j[None] <= cur[:, None], j[None], -1)
    kpos, cur = kpos.to(dev), cur.to(dev)
    valid = int((kpos >= 0).sum())
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        r = lambda *s: torch.randn(*s, generator=gen).to(dev, dtype)  # noqa
        args = (r(B, H, dh), r(B, S, Hkv, dh), r(B, S, Hkv, dh), kpos, cur)
        errs[dtype] = max_err(isp.decode_partial(*args, window=None),
                              isp.decode_partial_ref(*args, window=None),
                              dtype)
    bound_ms, bound_by, _ = site_bound("isp_decode", *args, window=None)
    rows.append(dict(
        name="decode_partial", kernel="isp_decode", path=path, route="cuda",
        source="src/repro_torch/kernels/csrc/isp_decode.cu",
        replaces="src/repro/kernels/isp_decode.py:72", dtype="bfloat16",
        shape=f"B={B} H={H} Hkv={Hkv} dh={dh} S={S} (rank 0's block of a "
        f"1024-row strip view) kpos (8, {S}) ({valid} valid keys)",
        max_abs_err=errs[torch.bfloat16],
        max_abs_err_fp32=errs[torch.float32],
        ms=time_ms(lambda: isp.decode_partial(*args, window=None), flush),
        plain_ms=time_ms(lambda: isp.decode_partial_ref(*args, window=None),
                         flush),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None))
    del args

    table = torch.randn(32000, 4096, generator=gen).to(dev, torch.bfloat16)
    idx = torch.randint(0, 64000, (8,), generator=gen,
                        dtype=torch.int32).to(dev)
    got, want = ig.isp_gather(table, idx), ig.isp_gather_ref(table, idx)
    assert torch.equal(got, want), "isp_gather tp2: not exact"
    # an id off the shard reads no row (the kernel stores zeros): the
    # bytes are the on-shard rows read, every row written and the ids
    n_on = int((idx < 32000).sum())
    bound_ms, bound_by, _ = site_bound("isp_gather", table, idx)
    lib_idx = idx.long().clamp(0, 31999)
    rows.append(dict(
        name="isp_gather", kernel="isp_gather", path=path, route="cuda",
        source="src/repro_torch/kernels/csrc/isp_gather.cu",
        replaces="src/repro/kernels/isp_gather.py:50", dtype="bfloat16",
        shape="table (32000, 4096) offset 0 (rank 0's vocabulary shard), 8 "
        f"ids over 64000 ({n_on} on the shard)",
        max_abs_err=0.0, max_abs_err_fp32=None,
        ms=time_ms(lambda: ig.isp_gather(table, idx), flush),
        plain_ms=time_ms(lambda: ig.isp_gather_ref(table, idx), flush),
        bound_ms=bound_ms, bound_by=bound_by,
        library_ms=time_ms(lambda: torch.nn.functional.embedding(
            lib_idx, table), flush)))
    del table
    return rows


def tp2_train_rows(dev, gen, flushes):
    """The kernels of the two-rank yi-9b train path at one rank's shapes
    (MESH_TRAIN_SHAPE): flash with lse on the rank's 16 of 32 query heads
    over its 2 of 4 KV heads, causal over 2048 rows, and isp_gather on
    the rank's 32000 x 4096 vocabulary shard for the batch's 2 x 2048 ids
    (the sequence-parallel lookup gathers every id; about half are on the
    other shard).  Each held to its plain version, then timed beside it,
    its bound and the library call (SDPA's forward, F.embedding)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import isp_gather as ig
    from repro_torch.kernels import ref
    flush = flushes[0]
    path = "yi-9b tp2 train"
    B, S = MESH_TRAIN_SHAPE
    H, Hkv, dh = 16, 2, 128
    ck = dict(q_chunk=TRAIN_CHUNK, kv_chunk=TRAIN_CHUNK)
    errs, lerrs = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        r = lambda *s: torch.randn(*s, generator=gen).to(dev, dtype)  # noqa
        q, k, v = r(B, S, H, dh), r(B, S, Hkv, dh), r(B, S, Hkv, dh)
        out, lse = fa.flash_attention(q, k, v, return_lse=True)
        want, wlse = ref.chunked_attention(q, k, v, return_lse=True, **ck)
        errs[dtype] = max_err([out], [want], dtype)
        lerrs[dtype] = lse_err(lse, wlse)
        del out, lse, want, wlse
    bound_ms, bound_by, _ = site_bound("flash_attention", q, k, v,
                                       return_lse=True)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = [dict(
        name="flash_attention", kernel="flash_attention", path=path,
        route="cuda", source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:77", dtype="bfloat16",
        shape=f"B={B} S={S} H={H} Hkv={Hkv} dh={dh} causal, with lse (one "
        f"rank's heads)", max_abs_err=errs[torch.bfloat16],
        max_abs_err_fp32=errs[torch.float32],
        lse_max_abs_err=lerrs[torch.bfloat16],
        ms=time_ms(lambda: fa.flash_attention(q, k, v, return_lse=True),
                   flush),
        plain_ms=time_ms(lambda: ref.chunked_attention(
            q, k, v, return_lse=True, **ck), flush),
        bound_ms=bound_ms, bound_by=bound_by,
        library_ms=time_ms(lambda: sdpa(qt, kt, vt, is_causal=True,
                                        enable_gqa=True), flush))]
    del q, k, v, qt, kt, vt
    table = torch.randn(32000, 4096, generator=gen).to(dev, torch.bfloat16)
    idx = torch.randint(0, 64000, (B, S), generator=gen,
                        dtype=torch.int32).to(dev)
    got, want = ig.isp_gather(table, idx), ig.isp_gather_ref(table, idx)
    assert torch.equal(got, want), "isp_gather tp2 train: not exact"
    n_on = int((idx < 32000).sum())
    bound_ms, bound_by, _ = site_bound("isp_gather", table, idx)
    lib_idx = idx.long().clamp(0, 31999)
    rows.append(dict(
        name="isp_gather", kernel="isp_gather", path=path, route="cuda",
        source="src/repro_torch/kernels/csrc/isp_gather.cu",
        replaces="src/repro/kernels/isp_gather.py:50", dtype="bfloat16",
        shape=f"table (32000, 4096) offset 0 (rank 0's vocabulary shard), "
        f"({B}, {S}) ids over 64000 ({n_on} on the shard)",
        max_abs_err=0.0, max_abs_err_fp32=None,
        ms=time_ms(lambda: ig.isp_gather(table, idx), flush),
        plain_ms=time_ms(lambda: ig.isp_gather_ref(table, idx), flush),
        bound_ms=bound_ms, bound_by=bound_by,
        library_ms=time_ms(lambda: torch.nn.functional.embedding(
            lib_idx, table), flush)))
    del table, got, want
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
    bound_ms, bound_by, _ = site_bound("paged_decode", *args)
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
    # llama4-scout (group 5), musicgen-large (MHA, dh 64) and the reduced
    # configs (dh 16, max_len 256)
    for path, kw in (("yi-9b serve", {}),
                     ("gemma3-12b serve", dict(
                         H=16, Hkv=8, dh=240, maxp=128,
                         lengths=(2048, 1500, 16, 0, 1031, 1, 700, 1990))),
                     ("llama4-scout serve", dict(H=40, Hkv=8, dh=128)),
                     ("musicgen-large serve", dict(H=32, Hkv=32, dh=64)),
                     ("smoke serve", dict(
                         H=4, Hkv=4, dh=16, maxp=16,
                         lengths=(64, 40, 16, 0, 33, 1, 20, 63)))):
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
        bound_ms, bound_by, _ = site_bound("paged_decode", q, kp, vp, pages,
                                           cur)
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
                         ("hymba serve", "hymba ring"),
                         ("smoke serve", "smoke ring")):
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
        bound_ms, bound_by, _ = site_bound("isp_decode", *args,
                                           window=window)
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
    # and hymba-1.5b's window layers (25 heads over 5 at dh 64); the
    # reduced configs' prefill (dh 16, and the reduced MLA's qk 24 / v 16)
    for path, (B, S, H, Hkv, dh, dv, window) in FLASH_PATHS + \
            SMOKE_FLASH_PATHS:
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
        bound_ms, bound_by, _ = site_bound("flash_attention", q, k, v,
                                           window=window)
        w = S if window is None else window
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
    rows += [flash_train_row(dev, gen, flush, "smoke train", shape, dv,
                             SMOKE_CHUNK) for shape, dv in SMOKE_TRAIN_FLASH]
    flash_lse_edges(dev, gen)

    rows += gather_rows(dev, flushes)
    rows += tp2_rows(dev, gen, flushes)
    rows += tp2_train_rows(dev, gen, flushes)
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
    many a call.  A window whose counts are not whole multiples of
    ``reps`` lost events in the profiler (a call launches the same
    operations every time), so it is profiled again, up to three times;
    the count is checked on a window that saw every call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    flush()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                call()
                torch.cuda.synchronize()
                flush()
            torch.cuda.synchronize()
        ops = {}
        for e in prof.events():
            if e.device_type != DeviceType.CUDA or \
                    "FillFunctor<unsigned char>" in e.name or \
                    e.name == "Command Buffer Full":
                continue
            t, k = ops.get(e.name, (0.0, 0))
            ops[e.name] = (t + e.time_range.end - e.time_range.start, k + 1)
        if all(k % reps == 0 for _, k in ops.values()):
            break
        log(f"[apps] pool breakdown, {label}: the profiler saw "
            f"{sum(k for _, k in ops.values())} operations over {reps} "
            f"calls (events lost); profiling again")
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
        bound_ms, bound_by, nbytes = site_bound(
            "isp_gather_pool", table, a.s_idx, a.s_seg, R, weights=w)
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
    bound_ms, bound_by, nbytes = site_bound(
        "isp_gather_pool", sh, a.p_idx, a.p_seg, a.NSEG, shard_offset=off)
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


def apps_phase(dev, meter):
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
        # the function's bound: its one product at the tensor cores' peak
        # for the corpus type (TF32 for fp32, bf16); beside it the route's
        # three products (3xTF32 or bf16x3) and the first design's one
        # fp32 product on the CUDA cores
        cost = KERNEL_COSTS["topk_similarity"](qs, c, K)
        bound_ms, bound_by = bound(cost.bytes, cost.flops, cost.dtype)
        route_ms, _ = bound(cost.bytes, 3 * cost.flops, cost.dtype)
        cuda_core_ms, _ = bound(cost.bytes, cost.flops, torch.float32)
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
    # the energy an item: recommender batches of 256 queries over the fp32
    # corpus, and sentiment batches of R reviews (fp32, no weights: pool,
    # head and argmax), each back to back for a window of ``meter``'s
    qs, c = queries[256], corpus[torch.float32]
    for label, fn, per in (
            ("apps recommender, a query (Q=256, fp32 corpus)",
             lambda: tk.topk_similarity(qs, c, K), 256),
            ("apps sentiment, a review (fp32, no weights)",
             lambda: sentiment(torch.float32, None), R)):
        n = back_to_back(fn)
        meter.measure("item", label, lambda: repeat(fn, n), items=n * per)
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
          kv_layout="paged", engine=None, meter=None, **engine_kw):
    """Serve ``requests`` through a fresh engine (or ``engine``, built with
    a telemetry hub) with the launch counters set to 0 just before and
    read just after; with a ``meter`` the run is one of its item windows
    (joules a generated token)."""
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
    if meter is None:
        results = eng.run_until_complete()
    else:
        w = meter.measure("item", f"{cfg.name} serve, a generated token",
                          eng.run_until_complete)
        results = w.out
        w.items = sum(len(r.tokens) for r in results)
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


# gemma3-12b's depth in its serve and plan phases, cut from 48 to keep the
# script in its time: 10 window layers and 2 global ones, its 5:1 pattern
# (3.661 B parameters: the plan phase needs FSDP's > 3 B default)
GEMMA_LAYERS = 12


def gemma_phase(dev):
    """gemma3-12b in bfloat16 at full width and GEMMA_LAYERS layers:
    returns (launches, the plan phase's launches)."""
    from repro_torch.config import get_config
    from repro_torch.models import model as M
    from repro_torch.train.serve_loop import ServeEngine
    cfg = dataclasses.replace(get_config("gemma3-12b"),
                              num_layers=GEMMA_LAYERS)
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


# yi-9b's depth in the chunked bf16 phase, cut from 48 (to 16, then to 8
# when the two-rank train phase came) to keep the script in its time:
# chunking and its budgets do not depend on the depth
CHUNK_LAYERS = 8


def chunk_bf16_phase(dev, requests):
    """yi-9b in bf16 at full width and CHUNK_LAYERS layers serving the
    serve phase's 16 requests one-shot, then with 256-row chunks at chunk
    budgets 1 and 2: every request ok, a balanced free list, the kernels
    on every layer of every one-shot prefill call and decode step, and the
    one-shot run's tokens (a flip only below BF16_FLIP_MARGIN)."""
    from repro_torch.config import get_config
    from repro_torch.models import model as M
    cfg = dataclasses.replace(get_config("yi-9b"), num_layers=CHUNK_LAYERS)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = M.init_params(cfg, gen, dev)
    eng, results, wall, _, _ = serve(cfg, params, requests, 8, dev)
    want = [r.tokens for r in results]
    log(f"[chunk bf16] yi-9b at full width, depth cut from 48 to "
        f"{cfg.num_layers} layers: one-shot {wall:.2f} s wall")
    del eng
    free_device()
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
    del eng, params
    free_device()


# the cluster's drives: the serve engine's settings, 256-row chunks
CLUSTER_KW = dict(n_drives=4, num_slots=8, max_len=1024, page_size=16,
                  k_block=8, chunk_prefill=256)
# headroom over the weights and the four pools for one prefill bucket's
# activations (8 x 256 rows), one chunk's scores (256 x 32 x 1024 fp32)
# and the allocator's rounding
CLUSTER_MEM_MARGIN = 2 * 2**30
# requests of the serial cluster run and of each open-loop trace (cut from
# 32 to 16 to make room for the train phases; the crash run takes these
# with 16 tokens each)
CLUSTER_REQUESTS = 16
# the cluster's yi-9b at full width, its depth cut from 48 to 4 layers (8
# before the two-rank train phase came) to keep the script in its time: the drives' routing, faults, threads and
# schedules do not depend on the depth, each tick's time does
CLUSTER_LAYERS = 4


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


def cluster_log(tag, run) -> tuple:
    """Log a cluster run; returns its Table I energy a query (mJ) and mean
    active drives."""
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
    return st.energy_per_query_mj, st.mean_active


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


def cluster_phase(dev):
    """yi-9b bf16 at full width and CLUSTER_LAYERS layers served by a
    4-drive cluster over the one model: serial, then data_local over 4
    shards with a tick-based crash of drive 1, then on worker threads,
    then open-loop bursty traffic FIFO and EDF.  Returns the serial run's
    Table I energy a query (mJ) and mean active drives."""
    from repro_torch.config import get_config
    from repro_torch.core.faults import (DEAD, HEALTHY, FailureDetector,
                                         FaultSchedule)
    from repro_torch.core.runtime import HeartbeatWatchdog
    from repro_torch.data.workload import (PriorityClass, WorkloadConfig,
                                           generate_trace)
    from repro_torch.models import model as M
    cfg = dataclasses.replace(get_config("yi-9b"), num_layers=CLUSTER_LAYERS)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = M.init_params(cfg, gen, dev)
    log(f"[cluster] yi-9b bf16 at full width, depth cut from 48 to "
        f"{cfg.num_layers} layers: {M.count_params(cfg) / 1e9:.3f} B params")
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
    table1 = cluster_log("cluster serial", run)
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
    sub = [(p, 16) for p, _ in requests]
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
    log(f"[cluster crash] data_local over 4 shards, {len(sub)} requests of "
        f"16 tokens, drive 1 crashed at tick 3: health {cst.health}, "
        f"{cst.retries} retries, {len(ok)}/{len(sub)} ok token-identical to "
        f"the "
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
    del params
    free_device()
    return table1


# llama4-scout at full width: all 48 layers hold 107.8 B parameters (215.6
# GB in bf16), which no card holds; 8 (19.69 B, 39.4 GB) ran until the
# two-rank train phase came, 4 keep the script in its time
LLAMA4_LAYERS = 4
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
            f"{bound(dense_b, 0, torch.bfloat16)[0]:.4f} ms for all "
            f"{m.num_experts} experts ({dense_b / 1e9:.3f} GB), "
            f"{bound(grouped_b, 0, torch.bfloat16)[0]:.4f} ms for the {used} "
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


# hymba-1.5b's depth, cut from 32 (to 16, then to 8 when the two-rank
# train phase came) to keep the script in its time
HYMBA_LAYERS = 8


def hymba_phase(dev):
    """hymba-1.5b in bf16 at full width and HYMBA_LAYERS layers: 8
    requests (prompts 16..700, max_new 32; exact-length buckets, the Mamba
    state would integrate pad tokens) through the engine on strips,
    k_block 8 then 1 (identical tokens); flash on every window layer of
    every prefill call, isp decode on every ring of every step; one decode
    tick profiled.  Returns the k_block 8 run's launches."""
    from repro_torch.config import get_config
    from repro_torch.models import model as M
    cfg = dataclasses.replace(get_config("hymba-1.5b"),
                              num_layers=HYMBA_LAYERS)
    L = cfg.num_layers
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = M.init_params(cfg, gen, dev)
    torch.cuda.synchronize()
    assert all(b.ssm.a_log.dtype == torch.float32 for b in params.blocks)
    log(f"[hymba] hymba-1.5b bf16 at full width, {L} of 32 hybrid layers, "
        f"d_model "
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
        return None, prof
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
    return {k: v / 1e3 for k, v in parts.items()}, prof


def train_phase(dev):
    """yi-9b at every published width, depth cut to TRAIN_LAYERS, bf16
    with fp32 AdamW moments and remat "dots": TRAIN_STEPS steps through
    ``train_loop.train`` on SyntheticTokenSource batches of TRAIN_BATCH x
    TRAIN_SEQ, no checkpoint.  Every step's loss and grad norm finite;
    flash launched on every layer twice a step (forward and the remat
    recompute), no other kernel; the median step, tokens/s, model FLOPs
    against the bf16 peak, peak memory; one step counted by the port's
    op recorder, the next profiled, the next timed for its peak memory
    (the roofline phase reads the three, ``roofline_phase``); then four
    steps on one repeated batch at lr 1e-4 must lower its loss.  The
    roofline phase's dry-runs start first and trace on the CPU meanwhile.
    Returns (launches, summary, what the roofline phase needs)."""
    from repro_torch.config import ShapeConfig, get_config
    from repro_torch.data import DataConfig, ShardedLoader, \
        SyntheticTokenSource
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as S
    from repro_torch.models import model as M
    from repro_torch.optim import AdamWConfig
    from repro_torch.sharding import make_plan, make_recipe
    from repro_torch.train import train_loop as TL
    dryruns = start_dryruns()
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
    share = flops / (med_ms / 1e3) / peak_flops(torch.bfloat16)
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
    # the next three steps: counted, profiled, timed with its peak memory
    counted = count_call(lambda: step_fn(state.params, state.opt_state,
                                         loader.global_batch_at(TRAIN_STEPS)))
    parts, prof = profile_train_step(
        step_fn, state, loader.global_batch_at(TRAIN_STEPS + 1), med_ms)
    timed = measure_call(lambda: step_fn(
        state.params, state.opt_state,
        loader.global_batch_at(TRAIN_STEPS + 2)))
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
    del fit_fn
    summary = dict(median_step_ms=med_ms, tokens_per_s=tokens / med_ms * 1e3,
                   model_tflop=flops / 1e12, peak_share=share,
                   peak_gb=peak / 1e9, profile_ms=parts)
    return launches, summary, SimpleNamespace(
        cfg=cfg, state=state, counted=counted, prof=prof, timed=timed,
        med_ms=med_ms, train_flops=flops, dryruns=dryruns, step_fn=step_fn,
        loader=loader)


# -- the roofline phase -------------------------------------------------------
# the port's analysis layer on real steps: a step counted by its op
# recorder (analysis/op_trace.py) held against the same step measured
ROOFLINE_SLACK = 1.05        # a bound over 105% of its measured time means
                             # the counter counts work the step does not do
ROOFLINE_PEAK_TOL = 0.20     # predicted peak bytes against the measured peak
# yi-9b's decode tick on the paged layout: 8 slots, pages of 16, a 4096-row
# span a slot, positions drawn in [1024, 4096) from SEED
DECODE_SLOTS, DECODE_SPAN = 8, 4096
# the production cells dry-run on the CPU (fake group of 256 ranks, meta)
DRYRUN_CELLS = (("yi-9b", "train_4k"), ("yi-9b", "prefill_32k"),
                ("gemma3-12b", "decode_32k"))
DRYRUN_DIR = ROOT / "build" / "dryrun_smoke"
DRYRUN_TIMEOUT = 600
_CHILDREN = []


def _stop_children() -> None:
    for p in _CHILDREN:
        if p.poll() is None:
            p.kill()
            p.wait()


def start_dryruns():
    """One process a production cell (DRYRUN_CELLS) tracing its rank's
    step on the CPU with no card visible; read by ``dryrun_report``."""
    import atexit
    import os
    import shutil
    if not _CHILDREN:
        atexit.register(_stop_children)
    shutil.rmtree(DRYRUN_DIR, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    procs = []
    for arch, shape in DRYRUN_CELLS:
        p = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", "pod", "--out",
             str(DRYRUN_DIR)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        _CHILDREN.append(p)
        procs.append(((arch, shape), p))
    return procs


def dryrun_report(procs, smi) -> dict:
    """Each dry-run's bytes a rank against the card's 80 GB, its three
    roofline terms at the H100's peaks, the dominant one and its MFU:
    counts, not times."""
    out = {}
    for (arch, shape), p in procs:
        try:
            text, _ = p.communicate(timeout=DRYRUN_TIMEOUT)
        except subprocess.TimeoutExpired:
            p.kill()
            p.communicate()
            raise AssertionError(f"dry-run {arch} x {shape}: not done in "
                                 f"{DRYRUN_TIMEOUT} s")
        assert p.returncode == 0, f"dry-run {arch} x {shape}:\n{text[-4000:]}"
        d = json.loads((DRYRUN_DIR / f"{arch}__{shape}__pod.json")
                       .read_text())
        rf = d["roofline"]
        log(f"[roofline] dry-run {arch} x {shape} x pod (one of 256 ranks, "
            f"counted on the CPU at the peaks of {smi}): "
            f"{d['bytes_per_device'] / 1e9:.2f} GB a rank of 80 "
            f"(arguments {d['memory']['argument_bytes'] / 1e9:.2f}, "
            f"temporaries {d['memory']['temp_bytes'] / 1e9:.2f}); compute "
            f"{rf['compute_s']:.4f} s, memory {rf['memory_s']:.4f} s, "
            f"collective {rf['collective_s']:.4f} s, dominant "
            f"{rf['dominant']}, MFU {rf['mfu']:.1%}; trace "
            f"{d['trace_s']:.1f} s")
        out[f"{arch} {shape}"] = dict(
            gb_per_rank=d["bytes_per_device"] / 1e9, fits=d["fits"],
            compute_s=rf["compute_s"], memory_s=rf["memory_s"],
            collective_s=rf["collective_s"], dominant=rf["dominant"],
            mfu=rf["mfu"], trace_s=d["trace_s"])
    return out


def count_call(fn):
    """One call of ``fn`` under the port's op recorder, the card's
    storages tracked: (records, temp peak bytes, kernel sites, launches)."""
    from repro_torch.analysis.op_trace import OpRecorder, totals
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    rec = OpRecorder(device="cuda")
    with rec:
        fn()
    torch.cuda.synchronize()
    records = rec.records
    return SimpleNamespace(records=records, temp=rec.peak_bytes,
                           sites=totals(records).kernel_sites,
                           launches=ops.launch_counts())


def measure_call(fn, reps: int = 1):
    """Host-clock ms of ``fn`` to a synchronize (the median of ``reps``),
    and the card's allocated bytes before it and at its peak."""
    ts = []
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return SimpleNamespace(ms=float(np.median(ts)), before=before,
                           peak=torch.cuda.max_memory_allocated())


def held_to_count(tag, cfg, shape, counted, timed, prof, args_bytes, smi,
                  extra_mfu=None) -> dict:
    """Counted against measured for one step: the roofline of its records
    (chips 1) against its host-clock time, the kernel sites' counted
    bounds against their profiled device time, the predicted peak (the
    arguments' bytes plus the counted temporaries) against
    ``max_memory_allocated``; each kernel site launched as counted."""
    from repro_torch.analysis.roofline import from_records, model_flops_for
    from repro_torch.analysis.top_ops import top_kernels
    rf = from_records(counted.records, 1, model_flops_for(cfg, shape),
                      dtype=cfg.dtype)
    peak = peak_flops(cfg.dtype)
    mfu_measured = rf.model_flops / (timed.ms / 1e3) / peak
    by_dtype = {k: round(v / 1e12, 3)
                for k, v in rf.dot_flops_by_dtype.items()}
    log(f"[roofline] {tag} ({smi}): counted {rf.dot_flops / 1e12:.3f} "
        f"TFLOP of products and kernel sites ({by_dtype}), "
        f"{rf.elementwise_flops / 1e12:.3f} T elementwise, "
        f"{rf.hbm_bytes / 1e9:.2f} GB of HBM traffic (counts: the card "
        f"has no FLOP or byte counter here); roofline compute "
        f"{rf.compute_s * 1e3:.2f} ms, memory {rf.memory_s * 1e3:.2f} ms, "
        f"dominant {rf.dominant}, step {rf.step_s * 1e3:.2f} ms against "
        f"the measured {timed.ms:.2f} ms ({rf.step_s * 1e3 / timed.ms:.1%});"
        f" achieved {rf.dot_flops / (timed.ms / 1e3) / 1e12:.1f} TFLOP/s "
        f"and {rf.hbm_bytes / (timed.ms / 1e3) / 1e12:.3f} TB/s")
    log(f"[roofline] {tag}: MFU (the reference's: 6·N·D or 2·N·D, N "
        f"without embedding and head, at the roofline step) {rf.mfu:.1%}; "
        f"the same model FLOPs over the measured step {mfu_measured:.1%}"
        + ("" if extra_mfu is None else f"; {extra_mfu}"))
    rows = top_kernels(prof, counted.records, 10**6) if prof is not None \
        else []
    busy = sum(r["device_ms"] for r in rows)
    log(f"[roofline] {tag}: profiled device time {busy:.2f} ms in "
        f"{sum(r['kernels'] for r in rows)} kernels, against the measured "
        f"step {timed.ms:.2f} ms ({busy / timed.ms:.1%}); by op, each "
        f"beside its counted bound:")
    rows = rows[:12] + [r for r in rows[12:] if r["op"].startswith("kernel:")]
    for r in rows:
        b = "none" if r["bound_ms"] is None else f"{r['bound_ms']:.3f} ms"
        log(f"[roofline] {tag}: {r['device_ms']:9.3f} ms x{r['kernels']:<5d}"
            f" {r['op'][:40]:40s} bound {b} ({r['records']} records)")
    assert rows, f"{tag}: the profiler recorded no device time"
    sites = [r for r in rows if r["op"].startswith("kernel:")]
    assert {r["op"][7:] for r in sites} >= set(counted.sites), \
        (tag, "a counted kernel site is missing from the profile", rows)
    for r in sites:
        assert r["bound_ms"] <= ROOFLINE_SLACK * r["device_ms"], (tag, r)
    assert rf.step_s * 1e3 <= ROOFLINE_SLACK * timed.ms, (tag, rf.step_s,
                                                          timed.ms)
    want = {k: counted.sites.get(k, 0) for k in counted.launches}
    assert counted.launches == want, (tag, counted.launches, want)
    predicted = args_bytes + counted.temp
    log(f"[roofline] {tag}: predicted peak {predicted / 1e9:.3f} GB "
        f"(arguments {args_bytes / 1e9:.3f} + counted temporaries "
        f"{counted.temp / 1e9:.3f}) against max_memory_allocated "
        f"{timed.peak / 1e9:.3f} GB ({timed.before / 1e9:.3f} allocated "
        f"before the step): {predicted / timed.peak - 1:+.1%}")
    assert abs(predicted - timed.peak) <= ROOFLINE_PEAK_TOL * timed.peak, \
        (tag, predicted, timed.peak)
    return dict(counted_tflop=rf.dot_flops / 1e12,
                elementwise_tflop=rf.elementwise_flops / 1e12,
                hbm_gb=rf.hbm_bytes / 1e9, compute_ms=rf.compute_s * 1e3,
                memory_ms=rf.memory_s * 1e3, roofline_ms=rf.step_s * 1e3,
                dominant=rf.dominant, measured_ms=timed.ms, mfu=rf.mfu,
                mfu_measured=mfu_measured, device_ms=busy,
                predicted_peak_gb=predicted / 1e9,
                measured_peak_gb=timed.peak / 1e9,
                launches={k: v for k, v in counted.launches.items() if v},
                kernels=[dict(op=r["op"], device_ms=r["device_ms"],
                              bound_ms=r["bound_ms"], launches=r["kernels"])
                         for r in rows])


def roofline_phase(dev, tr, smi, meter) -> dict:
    """The train phase's counted, profiled and timed yi-9b steps (8 of 48
    layers, 2 x 4096, bf16, remat "dots") held to their count; then one
    decode tick of the same model on the paged layout (DECODE_SLOTS slots
    over DECODE_SPAN rows, ``models.model.decode_fn`` with per-slot
    positions) counted, timed (median of 10), profiled and held the same
    way; then the dry-runs' report.  The same train step (on the next
    batches) and the same decode tick each run back to back for
    ENERGY_WINDOW_S as ``meter``'s held-out windows, with the counted
    FLOPs and bytes, for the energy phase."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.config import ShapeConfig
    from repro_torch.launch.dryrun import tree_bytes
    from repro_torch.models import model as M
    cfg, state = tr.cfg, tr.state
    out = {"device": smi}
    share = tr.train_flops / (tr.timed.ms / 1e3) / peak_flops(torch.bfloat16)
    out["train"] = held_to_count(
        f"yi-9b train step ({cfg.num_layers} layers, {TRAIN_BATCH} x "
        f"{TRAIN_SEQ})", cfg,
        ShapeConfig(TRAIN_SEQ, TRAIN_BATCH, "yi-9b train", "train"),
        tr.counted, tr.timed, tr.prof,
        tree_bytes(state.params) + tree_bytes(state.opt_state), smi,
        extra_mfu="the train phase's share (6 x (block + head parameters) "
        f"x tokens + attention, train_flops) over the measured step "
        f"{share:.1%}")
    t = out["train"]
    losses = []

    def step():
        batch = tr.loader.global_batch_at(TRAIN_STEPS + 3 + len(losses))
        losses.append(float(tr.step_fn(state.params, state.opt_state,
                                       batch)[2]["loss"]))
    meter.measure_for(
        "held-out", f"yi-9b train steps ({cfg.num_layers} layers, "
        f"{TRAIN_BATCH} x {TRAIN_SEQ})", step,
        flops=t["counted_tflop"] * 1e12, nbytes=t["hbm_gb"] * 1e9)
    tr.step_fn = tr.loader = None
    # the decode tick: the optimizer state goes first
    state.opt_state = None
    params = state.params
    tr.state = tr.prof = None
    free_device()
    B, T = DECODE_SLOTS, DECODE_SPAN
    rng = np.random.default_rng(SEED)
    with torch.no_grad():
        caches = M.init_caches(cfg, B, T, paged=True, device=dev)
        maxp = caches["b0"]["pages"].shape[-1]
        caches["b0"]["pages"].copy_(torch.arange(
            B * maxp, dtype=torch.int32, device=dev).view(B, maxp))
        pos = torch.as_tensor(rng.integers(1024, T, B), dtype=torch.int32,
                              device=dev)
        token = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, 1)),
                                dtype=torch.int32, device=dev)

        def tick():
            return M.decode_fn(params, caches, token, pos, cfg)
        tick()
        counted = count_call(tick)
        timed = measure_call(tick, reps=10)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            tick()
            torch.cuda.synchronize()
        ticks = meter.measure_for(
            "held-out", f"yi-9b decode ticks ({cfg.num_layers} layers, "
            f"{B} slots, paged)", tick)
    out["decode"] = held_to_count(
        f"yi-9b decode tick ({cfg.num_layers} layers, {B} slots, paged, "
        f"positions {pos.min().item()}..{pos.max().item()})", cfg,
        ShapeConfig(T, B, "yi-9b decode", "decode"), counted, timed, prof,
        tree_bytes([params, caches, token, pos]), smi)
    ticks.flops = ticks.items * out["decode"]["counted_tflop"] * 1e12
    ticks.nbytes = ticks.items * out["decode"]["hbm_gb"] * 1e9
    del caches, params, prof, state
    tr.state = None
    free_device()
    out["dryrun"] = dryrun_report(tr.dryruns, smi)
    return out


# xlstm-125m's depth in the kill-and-resume phase, cut from 12 to keep the
# script in its time (its sLSTM recurrence steps through the sequence on
# the host, one layer at a time)
ELASTIC_LAYERS = 4


def elastic_phase(dev):
    """Kill and resume through the normal entry points:
    ``launch.elastic.supervise`` runs the train CLI on xlstm-125m (full
    width, ELASTIC_LAYERS layers, 6 steps of 4 x 256, a checkpoint every
    2) with REPRO_FAIL_AT_STEP=5 and a
    marker.  The first attempt must die at step 5 (exit 42), the relaunch
    resume from a committed checkpoint (step 2, which the save at step 4
    waits for, or step 4) and finish at step 6; its
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
    args = ["--arch", "xlstm-125m", "--layers", str(ELASTIC_LAYERS),
            "--steps", "6", "--ckpt-every", "2",
            "--seq-len", "256", "--global-batch", "4", "--log-every", "1",
            "--ckpt-dir", str(ck)]
    cmd = ["bash", "-c", 'set -o pipefail; "$0" -m repro_torch.launch.train '
           '"$@" 2>&1 | tee -a "$REPRO_TRAIN_LOG"', sys.executable] + args
    t0 = time.perf_counter()
    res = supervise(cmd, max_restarts=2, timeout_s=600, env={
        "PYTHONPATH": str(ROOT / "src"), "REPRO_FAIL_AT_STEP": "5",
        "REPRO_FAIL_MARKER": str(work / "marker"),
        "REPRO_TRAIN_LOG": str(out)})
    wall = time.perf_counter() - t0
    text = out.read_text()
    log(f"[elastic] supervise: {res.log}, {wall:.1f} s wall")
    assert res.returncode == 0 and res.restarts == 1, res
    assert "rc=42" in res.log[0] and "rc=0" in res.log[1], res.log
    assert text.count("[elastic] injected failure at step 5") == 1
    assert "[train] done at step 6" in text
    resumed = re.findall(r"\[train\] resumed from step (\d+)", text)
    resumed_from = int(resumed[0]) if resumed else 0
    assert len(resumed) == 1 and resumed_from in (2, 4), resumed
    cfg = dataclasses.replace(get_config("xlstm-125m"),
                              num_layers=ELASTIC_LAYERS)
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
    log(f"[elastic] xlstm-125m bf16 at full width, {ELASTIC_LAYERS} of 12 "
        f"layers, 6 steps of 4 x 256: the "
        f"supervised run died at step 5 (exit 42), resumed from step "
        f"{resumed_from} and finished at 6; its final checkpoint "
        f"({ckpt_bytes / 1e9:.2f} GB) against an uninterrupted in-process "
        f"run ({clean_s:.1f} s): {len(want) - len(unequal)}/{len(want)} "
        f"leaves bit-equal, max abs diff {max(diff.values()):.3g}")
    assert not unequal, unequal[:5]
    del clean, got, tree
    shutil.rmtree(work, ignore_errors=True)
    free_device()
    return resumed_from


# -- the two-rank phase ----------------------------------------------------
# Both ranks share the one card (cuda:0), one process each, on a (1, 2)
# ("data", "model") mesh.  NCCL refuses two ranks on one device, so the
# group is gloo over CUDA tensors: every collective goes through the host.
# gloo has CUDA paths for all_reduce, all_gather_into_tensor,
# reduce_scatter_tensor and all_to_all_single, which the port uses; it has
# none for the list form of all_to_all, which the port does not use.
MESH_REQUESTS = 8
MESH_LAYERS = 16               # yi-9b in bf16, of 48 (whole before the
#                                two-rank train phase came)
MESH_FP32_LAYERS = 4           # yi-9b in fp32 at a cut depth: identical
MESH_DEEPSEEK_LAYERS = 4       # deepseek-v2 in bf16, of 60
MESH_DEEPSEEK_FP32_LAYERS = 2  # deepseek-v2 in fp32: identical
MESH_TIMING_K = 2              # decode steps a tick of the timing engine
MESH_LOGIT_PROMPTS = 2         # prompts whose first-prefill logits are held
# the two-rank first-prefill logits against the one-rank run's on the same
# prompts: the largest |difference| over the one-rank logits' RMS.  Read
# on the H100: fp32 3.7e-6..1.4e-5, bf16 0.084..0.100 (4 prompts each;
# bf16 rounds each rank's partial sums before gloo adds them, over 48
# layers); the bounds are 3.6x and 2x the largest.  A lost collective or a
# wrong piece moves the logits by the order of their RMS.
MESH_LOGIT_TOL = {"float32": 5e-5, "bfloat16": 0.2}
MESH_TIMEOUT = 900             # seconds for both ranks
MESH_COLLECTIVES = ("all_reduce", "all_gather_into_tensor",
                    "reduce_scatter_tensor", "all_to_all_single")


def mesh_cases():
    """(tag, config, requests) of the two-rank phase: yi-9b at full width
    and MESH_LAYERS in bf16
    (TP 2 on the block weights, SP in prefill, the paged engine, decode
    on the strips over the model axis) and at MESH_FP32_LAYERS in fp32;
    deepseek-v2 at full width in bf16 at MESH_DEEPSEEK_LAYERS and in fp32
    at MESH_DEEPSEEK_FP32_LAYERS (EP 2 over its 160 experts, MLA heads
    over the model axis, MLA decode on the strips over it).  The deepseek
    configs run at full expert capacity (capacity_factor = 160): below it
    the expert-parallel prefill drops assignments that the one-card dense
    path keeps, and the two would differ by design, not by rounding; the
    prompts are short (8..16; yi-9b's 16..128) so that full-capacity
    dispatch buffers stay small and gloo's host copies few; the fp32
    cases serve the first half of the requests."""
    from repro_torch.config import get_config
    yi = get_config("yi-9b")
    ds = get_config("deepseek-v2-236b")
    ds = dataclasses.replace(ds, moe=dataclasses.replace(
        ds.moe, capacity_factor=float(ds.moe.num_experts)))
    rng = np.random.default_rng(SEED + 11)
    yi_req = [(rng.integers(0, yi.vocab_size, int(rng.integers(16, 129))
                            ).tolist(), 12) for _ in range(MESH_REQUESTS)]
    ds_req = [(rng.integers(0, ds.vocab_size, int(rng.integers(8, 17))
                            ).tolist(), 12) for _ in range(MESH_REQUESTS)]
    half = MESH_REQUESTS // 2
    return [
        ("yi-9b bf16", dataclasses.replace(yi, num_layers=MESH_LAYERS),
         yi_req),
        ("yi-9b fp32", dataclasses.replace(yi, num_layers=MESH_FP32_LAYERS,
                                           dtype="float32"), yi_req[:half]),
        ("deepseek-v2 bf16", dataclasses.replace(
            ds, num_layers=MESH_DEEPSEEK_LAYERS), ds_req),
        ("deepseek-v2 fp32", dataclasses.replace(
            ds, num_layers=MESH_DEEPSEEK_FP32_LAYERS, dtype="float32"),
         ds_req[:half])]


class CollectiveTimer:
    """Host time spent in torch.distributed's collectives while active:
    each call is wrapped between two synchronisations of the card, so the
    interval is the collective alone (gloo: device to host, the exchange,
    host to device)."""

    def __init__(self):
        self.s, self.calls, self._orig = 0.0, 0, {}

    def __enter__(self):
        import torch.distributed as dist
        for name in MESH_COLLECTIVES:
            orig = getattr(dist, name)
            self._orig[name] = orig

            def timed(*a, _orig=orig, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _orig(*a, **kw)
                torch.cuda.synchronize()
                self.s += time.perf_counter() - t0
                self.calls += 1
                return out
            setattr(dist, name, timed)
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist
        for name, orig in self._orig.items():
            setattr(dist, name, orig)


def kernel_ms_per_step(eng) -> float:
    """Device kernel time a decode step over one engine tick, from the
    profiler (the union of the kernel intervals); None where the profiler
    recorded no device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with torch.no_grad():
            eng.step()
        torch.cuda.synchronize()
    kern = sorted((e for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and e.name != "Command Buffer Full"),
                  key=lambda e: e.time_range.start)
    if not kern or not eng.last_tick.steps:
        return None
    busy, end = 0.0, -1.0
    for e in kern:
        if e.time_range.end > end:
            busy += e.time_range.end - max(e.time_range.start, end)
            end = e.time_range.end
    return busy / 1e3 / eng.last_tick.steps


def prefill_logits(model, cfg, plan, prompt, dev) -> torch.Tensor:
    """fp32 logits (V,) of the token after ``prompt`` from one prefill of
    the model as this rank holds it (its pieces under the ParallelPlan
    ``plan``, in the recipe of a (len(prompt), 1) prefill; the whole model
    without one): the embedding (sequence-sharded under SP), the blocks,
    the final norm and the vocabulary-sharded head."""
    from repro_torch import sharding as sh
    from repro_torch.config import ShapeConfig
    from repro_torch.core import embedding as emb
    from repro_torch.models import blocks as blk
    from repro_torch.models import model as M
    from repro_torch.models.layers import rms_norm
    S = len(prompt)
    if plan is not None:
        plan = sh.make_recipe(plan, cfg, ShapeConfig(S, 1))
    sp = blk.sp_enabled(cfg, plan, S, "prefill")
    with torch.no_grad():
        toks = torch.tensor([prompt], dtype=torch.int32, device=dev)
        x = emb.embed_lookup(model.embed.table, toks, cfg, plan,
                             seq_sharded=sp)
        x, _ = M.run_blocks(model, x, torch.arange(S, dtype=torch.int32,
                                                   device=dev),
                            cfg, None, "prefill", plan=plan, sp=sp)
        x = blk.sp_gather(x, plan, sp)
        last = rms_norm(x, sh.leaf(model, "final_norm", plan),
                        cfg.norm_eps)[:, -1]
        logits = emb.sharded_logits_last(last, model.head_table(), cfg, plan)
    return logits[0, :cfg.vocab_size].float().cpu()


def mesh_rank(rank: int, world: int, work: str,
              parts=("serve", "train")) -> None:
    """One rank of the two-rank phase: every mesh case served through
    ServeEngine(recipe=...) on this rank's pieces, then the train cases
    (mesh_train_rank); what it saw goes to ``rank{rank}.json`` under
    ``work``."""
    import torch.distributed as dist
    from repro_torch import sharding as sh
    from repro_torch.config import ShapeConfig
    from repro_torch.core.telemetry import TelemetryHub
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import blocks as blk
    from repro_torch.models import model as M
    from repro_torch.train.serve_loop import ServeEngine

    torch.cuda.set_device(0)
    dev = torch.device("cuda:0")
    dist.init_process_group("gloo", init_method=f"file://{work}/store",
                            rank=rank, world_size=world)
    try:
        build.build()
        mesh = make_debug_mesh(1, world, device=dev)
        out = {}
        serve_cases = mesh_cases() if "serve" in parts else []
        for case, (tag, cfg, requests) in enumerate(serve_cases):
            plan = sh.make_plan(mesh, cfg)
            recipe = sh.make_recipe(plan, cfg, ShapeConfig(1024, 8))
            free_device()
            torch.cuda.reset_peak_memory_stats()
            t0 = case_t0 = time.perf_counter()
            # one rank at a time: each draws every global block before it
            # keeps its pieces, and both share the card
            for r in range(world):
                if r == rank:
                    gen = torch.Generator(device=dev).manual_seed(SEED)
                    params = M.init_params(cfg, gen, dev, plan=recipe)
                    torch.cuda.synchronize()
                    init_peak = torch.cuda.max_memory_allocated() / 1e9
                    free_device()
                dist.barrier()
            init_s = time.perf_counter() - t0
            eng = ServeEngine(cfg, params, recipe, num_slots=8, max_len=1024,
                              page_size=16, k_block=8,
                              telemetry=TelemetryHub(), device=dev)
            eng, results, wall, launches, prefill_calls = serve(
                cfg, params, requests, 8, dev, engine=eng)
            st = eng.stats
            assert all(r.status == "ok" for r in results), tag
            if eng.kv_layout == "paged":
                eng.pager.check_balanced()
            row = dict(
                tokens=[r.tokens for r in results], launches=launches,
                prefill_calls=prefill_calls, decode_steps=st.decode_steps,
                layout=eng.kv_layout, seq_axes=list(recipe.seq_axes),
                sp=blk.sp_enabled(cfg, recipe, 16, "prefill"),
                weights_gb=weight_gb(params), init_s=init_s,
                init_peak_gb=init_peak,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9, wall_s=wall,
                step_ms=st.decode_s * 1e3 / max(st.decode_steps, 1),
                prefill_ms=warm_ms(phases(eng.tele, "prefill")))
            del eng
            free_device()
            # both ranks run the prefills (their collectives pair up); rank
            # 0 keeps the logits
            logits = [prefill_logits(params, cfg, plan, p, dev)
                      for p, _ in requests[:MESH_LOGIT_PROMPTS]]
            if rank == 0:
                torch.save(logits, Path(work) / f"logits{case}.pt")
            if tag == "yi-9b bf16":
                # a warm engine: one tick admits (the requests' first 16
                # tokens, one prefill call, and a block), one tick's
                # collectives are timed, one tick is profiled
                timing = ServeEngine(cfg, params, recipe, num_slots=8,
                                     max_len=1024, page_size=16,
                                     k_block=MESH_TIMING_K, device=dev)
                for prompt, _ in requests:
                    timing.submit(prompt[:16], max_new=24)
                timing.step()
                t0 = time.perf_counter()
                with CollectiveTimer() as ct:
                    timing.step()
                torch.cuda.synchronize()
                steps = timing.last_tick.steps
                row["timed_tick_ms"] = (time.perf_counter() - t0) * 1e3
                row["coll_ms_per_step"] = ct.s * 1e3 / steps
                row["coll_calls_per_step"] = ct.calls / steps
                # the profiler on one rank only; the other runs the same
                # tick unprofiled (the collectives pair up)
                row["kernel_ms_per_step"] = kernel_ms_per_step(timing) \
                    if rank == 0 else None
                if rank != 0:
                    timing.step()
                del timing
            out[tag] = row
            log(f"[mesh r{rank}] {tag}: {len(results)} requests ok in "
                f"{wall:.1f} s (the case {time.perf_counter() - case_t0:.1f} s), "
                f"{row['weights_gb']:.2f} GB of weights on this rank, peak "
                f"{row['peak_gb']:.2f} GB, launches {launches}")
            del params
            free_device()
        if "train" in parts:
            out["train"] = mesh_train_rank(rank, world, work, mesh, dev)
        (Path(work) / f"rank{rank}.json").write_text(json.dumps(out))
    except BaseException:
        # the other rank's error is then only a closed connection
        free, total = torch.cuda.mem_get_info()
        log(f"[mesh r{rank}] failed ({free / 1e9:.2f} of {total / 1e9:.2f} "
            f"GB free on the card):\n{traceback.format_exc()}")
        raise
    finally:
        dist.destroy_process_group()


def mesh_phase(dev, parts=("serve", "train")):
    """Both ranks on the one card through the port's sharded serve path
    (mesh_cases), then every case with no plan in this process: the same
    tokens (fp32 identical; bf16 a flip only at a near-tie top-2 margin),
    each rank's peak memory beside the one-rank run's, the kernels on
    every layer (flash on each rank's heads in prefill, isp decode on its
    block of the strips, isp_gather on its vocabulary shard), and the time
    a yi-9b decode step spends in gloo's collectives beside its kernel
    time.  Then the train cases (mesh_train_cases; mesh_train_report).
    Returns the rank-0 launches of yi-9b bf16's serve and train runs."""
    import shutil
    import torch.multiprocessing as mp
    from repro_torch.models import model as M
    work = ROOT / "build" / "mesh_phase"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    free_device()
    t0 = time.perf_counter()
    ctx = mp.start_processes(mesh_rank, args=(2, str(work), parts),
                             nprocs=2, join=False, start_method="spawn")
    try:
        while not ctx.join(timeout=1.0):
            if time.perf_counter() - t0 > MESH_TIMEOUT:
                raise TimeoutError(f"the two ranks ran past {MESH_TIMEOUT} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    ranks = [json.loads((work / f"rank{r}.json").read_text())
             for r in range(2)]
    log(f"[mesh] two ranks on cuda:0 (gloo over CUDA tensors, through the "
        f"host; not NCCL) done in {time.perf_counter() - t0:.1f} s")
    yi_launches = train_launches = None
    for case, (tag, cfg, requests) in enumerate(
            mesh_cases() if "serve" in parts else []):
        got = [r[tag] for r in ranks]
        assert got[0]["tokens"] == got[1]["tokens"], f"{tag}: ranks differ"
        L = cfg.num_layers
        for r, g in enumerate(got):
            ln = g["launches"]
            assert ln["flash_attention"] == L * g["prefill_calls"] > 0, \
                (tag, r, ln)
            assert ln["isp_gather"] > 0 and ln["paged_decode"] == 0, \
                (tag, r, ln)
            want_isp = L * g["decode_steps"] if g["layout"] == "paged" else 0
            assert ln["isp_decode"] == want_isp, (tag, r, ln)
            assert g["seq_axes"] == ["model"], (tag, g["seq_axes"])
        free_device()
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device=dev).manual_seed(SEED)
        params = M.init_params(cfg, gen, dev)
        eng, results, wall, launches, _ = serve(cfg, params, requests, 8,
                                                dev)
        want = [r.tokens for r in results]
        one_peak = torch.cuda.max_memory_allocated() / 1e9
        one_w = weight_gb(params)
        del eng
        free_device()
        two = torch.load(work / f"logits{case}.pt")
        for k, ((prompt, _), a) in enumerate(zip(requests, two)):
            b = prefill_logits(params, cfg, None, prompt, dev)
            rms = float(b.pow(2).mean().sqrt())
            err = float((a - b).abs().max()) / rms
            top = torch.topk(b, 2).values
            log(f"[mesh] {tag} first-prefill logits, prompt {k} "
                f"({len(prompt)} tokens): max |two ranks - one rank| "
                f"{err:.3g} of the logits' RMS {rms:.3g} (bound "
                f"{MESH_LOGIT_TOL[cfg.dtype]:g}); argmax "
                f"{'equal' if int(a.argmax()) == int(b.argmax()) else 'differs'}"
                f", one-rank top-2 margin {float(top[0] - top[1]):.3g}")
            assert err <= MESH_LOGIT_TOL[cfg.dtype], \
                f"{tag}: first-prefill logits past the bound"
        if cfg.dtype == "float32":
            assert got[0]["tokens"] == want, f"{tag}: tokens differ in fp32"
            log(f"[mesh] {tag}: identical tokens on {len(want)}/{len(want)} "
                f"requests against the one-rank run")
        else:
            check_flips(f"mesh {tag}", requests, got[0]["tokens"], want,
                        params, cfg, dev, BF16_FLIP_MARGIN)
        del params
        free_device()
        for r, g in enumerate(got):
            log(f"[mesh] {tag} rank {r}: {g['weights_gb']:.2f} GB of weights "
                f"({g['weights_gb'] / one_w:.1%} of the one-rank "
                f"{one_w:.2f} GB), peak {g['peak_gb']:.2f} GB against the "
                f"one-rank run's {one_peak:.2f} GB; {g['layout']} layout, "
                f"sequence axes {g['seq_axes']}; decode "
                f"{g['step_ms']:.2f} ms a step, prefill "
                f"{g['prefill_ms']:.1f} ms a warm call, init "
                f"{g['init_s']:.1f} s; launches {g['launches']}")
        if tag == "yi-9b bf16":
            yi_launches = got[0]["launches"]
            for r, g in enumerate(got):
                kern = g["kernel_ms_per_step"]
                log(f"[mesh] {tag} rank {r} decode step: "
                    f"{g['coll_ms_per_step']:.2f} ms in gloo collectives "
                    f"through the host ({g['coll_calls_per_step']:.0f} "
                    f"calls, timed between syncs, tick "
                    f"{g['timed_tick_ms']:.1f} ms) against "
                    + (f"{kern:.2f} ms of kernels (profiled)" if kern
                       else "kernels not measured on this rank")
                    + f"; unprofiled {g['step_ms']:.2f} ms a step")
    if "train" in parts:
        train_launches = mesh_train_report([r["train"] for r in ranks], dev)
    return yi_launches, train_launches


# -- the two-rank train phase ------------------------------------------------
# The same two ranks on cuda:0 (gloo over CUDA tensors), after the serve
# cases: each train case's step-0 loss and gradient pieces (steps.
# loss_and_grads) and its steps (steps.build_train_step) under the (1, 2)
# mesh's plan, then in this process the same weights and batch on one
# rank.  Depths are cut, widths are the published ones.
MESH_TRAIN_LAYERS = 8          # yi-9b in bf16, of 48: 1.908 B parameters
MESH_TRAIN_SHAPE = (2, 2048)   # (batch, tokens)
MESH_TRAIN_STEPS = 4
MESH_MOE_TRAIN_LAYERS = 1      # llama4-scout in bf16, of 48: 4.27 B
MESH_MOE_TRAIN_SHAPE = (2, 256)
MESH_MOE_TRAIN_STEPS = 3
MESH_FP32_TRAIN_LAYERS = 2     # yi-9b in fp32
MESH_FP32_TRAIN_SHAPE = (2, 256)
MESH_FP32_TRAIN_STEPS = 2
MESH_TRAIN_LR = 1e-4           # no warmup: see train_phase's repeated batch
# two ranks against one rank at step 0, on the same weights and batch: the
# loss (|difference|; for the MoE case the cross-entropy, as its load loss
# is each rank's own tokens' by the reference's rule) and the gradient
# pieces (max |difference| over the leaf's max |grad|: every leaf in fp32,
# the embedding table and the head in bf16).  Read on the H100 (a whole
# run of this script): bf16 losses 2.1e-5 (yi-9b) and 4.2e-5
# (llama4-scout's cross-entropy), pieces 0.0128..0.0203; the bf16 bounds
# are 12x and 2.5x the largest.  A lost collective or a wrong piece moves the loss by
# ~0.1 and a gradient piece by the order of its largest element.
MESH_TRAIN_LOSS_TOL = {"bfloat16": 5e-4, "float32": 1e-5}
MESH_TRAIN_GRAD_TOL = {"bfloat16": 0.05, "float32": 1e-4}
MESH_PSUM_N = 1 << 22          # elements of the compressed_psum check


def mesh_train_cases():
    """(tag, config, (batch, tokens), steps, SP on) of the two-rank train
    phase:
    yi-9b at full width and MESH_TRAIN_LAYERS in bf16 (TP 2, SP on: 1.908
    B parameters >= SP_MIN_PARAMS, remat "dots", the vocab-sharded lookup
    and loss head); llama4-scout at full width and MESH_MOE_TRAIN_LAYERS
    in bf16, EP 2 over its 16 experts at full capacity (capacity_factor =
    16: no assignment dropped, so the two ranks compute what the one-rank
    dense route does), so the all_to_all backward runs; yi-9b at
    MESH_FP32_TRAIN_LAYERS in fp32 (0.870 B parameters: under
    SP_MIN_PARAMS, so TP without SP)."""
    from repro_torch.config import get_config
    yi = get_config("yi-9b")
    scout = get_config("llama4-scout-17b-a16e")
    scout = dataclasses.replace(
        scout, num_layers=MESH_MOE_TRAIN_LAYERS, moe=dataclasses.replace(
            scout.moe, capacity_factor=float(scout.moe.num_experts)))
    return [
        ("yi-9b bf16 train", dataclasses.replace(
            yi, num_layers=MESH_TRAIN_LAYERS), MESH_TRAIN_SHAPE,
         MESH_TRAIN_STEPS, True),
        ("llama4-scout bf16 train", scout, MESH_MOE_TRAIN_SHAPE,
         MESH_MOE_TRAIN_STEPS, True),
        ("yi-9b fp32 train", dataclasses.replace(
            yi, num_layers=MESH_FP32_TRAIN_LAYERS, dtype="float32"),
         MESH_FP32_TRAIN_SHAPE, MESH_FP32_TRAIN_STEPS, False)]


def train_batch(cfg, shape, dev, case: int):
    """A seeded global batch of random tokens and labels (some masked)."""
    B, Sq = shape
    rng = np.random.default_rng(SEED + 100 + case)
    labels = rng.integers(0, cfg.vocab_size, (B, Sq)).astype(np.int32)
    labels[0, :7] = -1
    return {"tokens": torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (B, Sq)).astype(np.int32)).to(dev),
            "labels": torch.from_numpy(labels).to(dev)}


def kernel_ms_in(fn) -> float:
    """Device kernel time (the union of the kernel intervals, ms) of one
    call of ``fn`` under torch.profiler; None where it recorded no device
    event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = sorted((e for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and e.name != "Command Buffer Full"),
                  key=lambda e: e.time_range.start)
    busy, end = 0.0, -1.0
    for e in kern:
        if e.time_range.end > end:
            busy += e.time_range.end - max(e.time_range.start, end)
            end = e.time_range.end
    return busy / 1e3 if kern else None


class first_grads:
    """While active, the first ``adamw_update`` call's gradients (this
    rank's pieces, after the sum over the mesh) are kept: those named in
    ``names``, or all of them with None."""

    def __init__(self, names=None):
        self.names, self.grads = names, {}

    def __enter__(self):
        from repro_torch.launch import steps as S
        self._orig = orig = S.adamw_update

        def capture(params, grads, *a, **kw):
            if not self.grads:
                self.grads.update({n: g.detach().clone()
                                   for n, g in grads.items()
                                   if self.names is None or n in self.names})
            return orig(params, grads, *a, **kw)
        S.adamw_update = capture
        return self.grads

    def __exit__(self, *exc):
        from repro_torch.launch import steps as S
        S.adamw_update = self._orig


def train_state_in_turns(cfg, recipe, opt_cfg, dev, rank, world):
    """``train_loop.build_state`` on each rank in turn (each draws every
    global leaf before it keeps its pieces, and both share the card)."""
    import torch.distributed as dist
    from repro_torch.train import train_loop as TL
    state = None
    for r in range(world):
        if r == rank:
            state = TL.build_state(cfg, recipe, opt_cfg, SEED, dev)
            torch.cuda.synchronize()
            free_device()
        dist.barrier()
    return state


def mesh_train_rank(rank: int, world: int, work: str, mesh, dev) -> dict:
    """This rank's part of the two-rank train phase (mesh_train_cases):
    step 0's loss and gradient pieces (in fp32 held here against one
    rank's gradients, cut by the model's specs; in bf16 the embedding's
    and the head's pieces saved for the parent), the case's steps on the
    one repeated batch with the launch counts (step 0's gradients are
    those the first step applies, whose learning rate is 0), and for
    yi-9b bf16 the last step's gloo time (CollectiveTimer) and, on rank
    0, its kernels profiled (that step is left out of the step times);
    then compressed_psum against the exact sum on the card."""
    import torch.distributed as dist
    from repro_torch import sharding as sh
    from repro_torch.config import ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as S
    from repro_torch.models import blocks as blk
    from repro_torch.models import model as M
    from repro_torch.optim import AdamWConfig, compressed_psum
    out = {}
    opt_cfg = AdamWConfig(lr=MESH_TRAIN_LR)
    sched = {"warmup": 0, "total": 10**6}
    for case, (tag, cfg, shape, steps, _) in enumerate(mesh_train_cases()):
        plan = sh.make_plan(mesh, cfg)
        recipe = sh.make_recipe(plan, cfg, ShapeConfig(shape[1], shape[0]))
        free_device()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state = train_state_in_turns(cfg, recipe, opt_cfg, dev, rank, world)
        model = state.params
        batch = train_batch(cfg, shape, dev, case)
        row = dict(init_s=time.perf_counter() - t0,
                   sp=blk.sp_enabled(cfg, recipe, shape[1], "train"),
                   route=blk.moe_route(cfg, recipe, "train", shape[1])
                   if cfg.moe else None,
                   state_gb=sum(t.numel() * t.element_size() for t in
                                list(model.parameters())
                                + list(state.opt_state["m"].values())
                                + list(state.opt_state["v"].values())) / 1e9)
        vocab = ("embed.table", "head.w_head")
        keep = None if cfg.dtype == "float32" else vocab
        step_fn, _ = S.build_train_step(cfg, recipe, opt_cfg, sched,
                                        device=dev)
        times, mets = [], []
        ops.reset_launch_counts()
        run = lambda: mets.append({  # noqa: E731
            k: float(v) for k, v in step_fn(model, state.opt_state,
                                            batch)[2].items()})
        with first_grads(keep) as grads:
            # the first step's learning rate is 0 (the schedule's warmup
            # starts there): its gradients are step 0's
            for i in range(steps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if case == 0 and i == steps - 1:
                    # the last yi-9b step: its gloo calls timed between
                    # syncs and, on rank 0, its kernels profiled (the
                    # other rank runs it unprofiled: the collectives pair)
                    with CollectiveTimer() as ct:
                        row["kernel_ms"] = kernel_ms_in(run) if rank == 0 \
                            else run()
                    torch.cuda.synchronize()
                    row.update(timed_step_ms=(time.perf_counter() - t0) * 1e3,
                               coll_ms=ct.s * 1e3, coll_calls=ct.calls)
                    continue
                run()
                times.append((time.perf_counter() - t0) * 1e3)
        losses = [m["loss"] for m in mets]
        row.update(launches=ops.launch_counts(), losses=losses,
                   grad_norms=[m["grad_norm"] for m in mets], step_ms=times,
                   loss0=mets[0]["loss"], xent0=mets[0]["xent"],
                   aux0=mets[0]["aux"],
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                   vocab_grad_max={n: float(grads[n].float().abs().max())
                                   for n in vocab})
        if cfg.dtype == "float32":
            # one rank's gradients of the same global weights, here
            local = M.init_params(cfg, torch.Generator(
                device=dev).manual_seed(SEED), dev)
            local.requires_grad_(True)
            one_loss, _, one = S.loss_and_grads(local, batch, cfg, None)
            errs = {}
            for n, g in grads.items():
                want = sh.cut(recipe, model.specs.get(n), one[n])
                errs[n] = float((g - want).abs().max()) / max(
                    float(one[n].abs().max()), 1e-30)
            row.update(one_loss0=float(one_loss), grad_errs=errs)
            del local, one
        else:
            torch.save({n: grads[n].cpu() for n in vocab},
                       Path(work) / f"train_grads{case}_r{rank}.pt")
        grads.clear()
        with torch.no_grad():
            after = M.loss_fn(model, batch, cfg, recipe)[0]
        row["loss_after"] = float(after)
        out[tag] = row
        log(f"[mesh train r{rank}] {tag}: losses {[round(x, 5) for x in losses]}"
            f", step ms {[round(x, 1) for x in times]}, peak "
            f"{row['peak_gb']:.2f} GB, launches {row['launches']}")
        del state, model, step_fn, batch
        free_device()
    # compressed_psum against the exact sum over the model axis
    plan = sh.make_recipe(sh.make_plan(mesh, None), mesh_train_cases()[0][1],
                          ShapeConfig(16, 2))
    gen = torch.Generator(device=dev).manual_seed(SEED + rank)
    x = torch.randn(MESH_PSUM_N, generator=gen, device=dev)
    exact = sh.all_reduce(plan, x.clone(), "model")
    amax = sh.all_reduce(plan, x.abs().max().clone(), "model",
                         dist.ReduceOp.MAX)
    got = compressed_psum(x, plan, "model", torch.Generator(
        device=dev).manual_seed(SEED + 1000 + rank))
    err = got - exact
    out["psum"] = dict(max_err=float(err.abs().max()), mean_err=float(
        err.mean()), amax=float(amax), n=MESH_PSUM_N)
    return out


def mesh_train_report(ranks, dev) -> dict:
    """The parent's half of the two-rank train phase: each bf16 case on
    one rank from the same seed and batch (step 0's loss and, for yi-9b,
    the embedding's and head's gradients, cut by the ranks' specs, then
    the same steps for the one-rank step time and peak; llama4-scout's
    forward only), the checks, and the lines.  Returns yi-9b bf16's rank-0
    launches."""
    from repro_torch import sharding as sh
    from repro_torch.config import ShapeConfig
    from repro_torch.launch import steps as S
    from repro_torch.models import model as M
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import train_loop as TL
    opt_cfg = AdamWConfig(lr=MESH_TRAIN_LR)
    work = ROOT / "build" / "mesh_phase"
    for case, (tag, cfg, shape, steps, sp) in enumerate(
            mesh_train_cases()):
        got = [r[tag] for r in ranks]
        for r, g in enumerate(got):
            ln = g["launches"]
            assert all(math.isfinite(x) for x in g["losses"] + g[
                "grad_norms"]), (tag, r, g["losses"])
            assert g["loss_after"] < g["losses"][0], (tag, r, g["losses"],
                                                      g["loss_after"])
            assert cfg.remat == "dots", cfg.remat   # flash twice a layer
            assert ln["flash_attention"] == 2 * cfg.num_layers * steps, \
                (tag, r, ln)
            assert ln["isp_gather"] == steps, (tag, r, ln)
            assert g["sp"] == sp, (tag, r, g["sp"])
            assert min(g["vocab_grad_max"].values()) > 0, \
                (tag, r, "a zero vocabulary gradient")
        assert got[0]["losses"] == got[1]["losses"], f"{tag}: ranks differ"
        if cfg.moe:
            assert got[0]["route"] == "ep_prefill", got[0]["route"]
        dtype = cfg.dtype
        lines = [f"[mesh train] {tag}: {shape[0]} x {shape[1]} tokens, "
                 f"{cfg.num_layers} layers, {M.count_params(cfg) / 1e9:.3f} "
                 f"B parameters; losses {[round(x, 4) for x in got[0]['losses']]}"
                 f" -> {got[0]['loss_after']:.4f} after the last step (the "
                 f"first step's lr is 0), grad norms "
                 f"{[round(x, 5) for x in got[0]['grad_norms']]}; "
                 f"launches a rank {got[0]['launches']}"]
        if dtype == "float32":
            for r, g in enumerate(got):
                d = abs(g["loss0"] - g["one_loss0"])
                worst = max(g["grad_errs"].items(), key=lambda x: x[1])
                lines.append(
                    f"[mesh train] {tag} rank {r}: step-0 loss "
                    f"{g['loss0']:.7f} against one rank's {g['one_loss0']:.7f}"
                    f" (|difference| {d:.3g}, bound "
                    f"{MESH_TRAIN_LOSS_TOL[dtype]:g}); every gradient piece "
                    f"within {worst[1]:.3g} of its leaf's max |grad| (the "
                    f"worst {worst[0]}; bound {MESH_TRAIN_GRAD_TOL[dtype]:g})")
                assert d <= MESH_TRAIN_LOSS_TOL[dtype], (tag, r, d)
                assert worst[1] <= MESH_TRAIN_GRAD_TOL[dtype], (tag, r, worst)
        else:
            free_device()
            torch.cuda.reset_peak_memory_stats()
            batch = train_batch(cfg, shape, dev, case)
            local = sh.make_recipe(sh.make_plan(None, cfg), cfg,
                                   ShapeConfig(shape[1], shape[0]))
            state = TL.build_state(cfg, local, opt_cfg, SEED, dev)
            if cfg.moe:
                with torch.no_grad():
                    _, met = M.loss_fn(state.params, batch, cfg)
                one = dict(loss0=float(met["xent"]), aux0=float(met["aux"]))
                key = "xent0"
            else:
                loss, met, grads = S.loss_and_grads(state.params, batch,
                                                    cfg, local)
                one = dict(loss0=float(loss))
                key = "loss0"
                errs = []
                for r in range(2):
                    pieces = torch.load(work / f"train_grads{case}_r{r}.pt")
                    plan = _rank_plan(cfg, shape, r)
                    for n, g in pieces.items():
                        want = sh.cut(plan, sh.leaf_spec(
                            plan, n, tuple(grads[n].shape)), grads[n])
                        e = float((g.to(dev).float() - want.float()).abs()
                                  .max()) / max(float(grads[n].float().abs()
                                                      .max()), 1e-30)
                        errs.append((e, r, n))
                del grads, pieces
                worst = max(errs)
                lines.append(
                    f"[mesh train] {tag}: the embedding's and head's "
                    f"gradient pieces against one rank's cut by the specs: "
                    f"max |difference| / max |grad| "
                    f"{', '.join(f'{n} r{r} {e:.3g}' for e, r, n in errs)} "
                    f"(bound {MESH_TRAIN_GRAD_TOL[dtype]:g})")
                assert worst[0] <= MESH_TRAIN_GRAD_TOL[dtype], (tag, worst)
                # the same steps on one rank, for its step time and peak
                step_fn, _ = S.build_train_step(
                    cfg, local, opt_cfg, {"warmup": 0, "total": 10**6},
                    device=dev)
                one_ms, one_losses = [], []
                for _ in range(steps):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    m = step_fn(state.params, state.opt_state, batch)[2]
                    one_losses.append(float(m["loss"]))
                    one_ms.append((time.perf_counter() - t0) * 1e3)
                one.update(step_ms=one_ms, losses=one_losses)
            one["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            del state
            free_device()
            d = abs(got[0][key] - one["loss0"])
            lines.append(
                f"[mesh train] {tag}: step-0 "
                f"{'cross-entropy' if cfg.moe else 'loss'} "
                f"{got[0][key]:.5f} on two ranks against one rank's "
                f"{one['loss0']:.5f} (|difference| {d:.3g}, bound "
                f"{MESH_TRAIN_LOSS_TOL[dtype]:g})"
                + (f"; load loss {got[0]['aux0']:.5f} (each rank's tokens, "
                   f"averaged) against {one['aux0']:.5f} (all tokens)"
                   if cfg.moe else ""))
            assert d <= MESH_TRAIN_LOSS_TOL[dtype], (tag, d)
            for r, g in enumerate(got):
                med = float(np.median(g["step_ms"][1:]))
                lines.append(
                    f"[mesh train] {tag} rank {r}: {g['state_gb']:.2f} GB of "
                    f"parameters and moments, peak {g['peak_gb']:.2f} GB "
                    f"against one rank's {one['peak_gb']:.2f} GB "
                    + ("(its forward only)" if cfg.moe else "(the same "
                       "steps)")
                    + f"; step ms {[round(x, 1) for x in g['step_ms']]}, "
                    f"median after the first {med:.1f}"
                    + ("" if cfg.moe else
                       f" against one rank's {float(np.median(one['step_ms'][1:])):.1f}"
                       f" (losses {[round(x, 4) for x in one['losses']]})")
                    + f"; init {g['init_s']:.1f} s")
            if case == 0:
                for r, g in enumerate(got):
                    kern = g["kernel_ms"]
                    lines.append(
                        f"[mesh train] {tag} rank {r} step: "
                        f"{g['coll_ms']:.1f} ms in gloo collectives through "
                        f"the host ({g['coll_calls']} calls, timed between "
                        f"syncs, step {g['timed_step_ms']:.1f} ms) against "
                        + (f"{kern:.1f} ms of kernels (profiled)" if kern
                           else "kernels not measured on this rank"))
        for line in lines:
            log(line)
    for r, rk in enumerate(ranks):
        p = rk["psum"]
        step = p["amax"] / 127.0
        bound_err = 2 * 2 * p["amax"] / 127.0 + 1e-6
        se = math.sqrt(2 * 0.25 * step ** 2 / p["n"])
        log(f"[mesh train] compressed_psum rank {r} over {p['n']} fp32 "
            f"elements: max |error| {p['max_err']:.4g} (bound "
            f"{bound_err:.4g} = 2 x 2 x amax / 127), mean error "
            f"{p['mean_err']:.3g} ({p['mean_err'] / se:.2f} standard errors)")
        assert p["max_err"] <= bound_err, p
        assert abs(p["mean_err"]) <= 4 * se, p
    return ranks[0]["yi-9b bf16 train"]["launches"]


def _rank_plan(cfg, shape, rank):
    """A stand-in recipe of rank ``rank`` on the (1, 2) mesh, for cutting
    a global array by its spec in this (meshless) process."""
    from repro_torch import sharding as sh

    class _Mesh:
        mesh_dim_names = ("data", "model")

        def size(self, i):
            return (1, 2)[i]

        def get_local_rank(self, name):
            return rank if name == "model" else 0
    plan = sh.make_plan(_Mesh(), cfg)
    return sh.ShardingRecipe(plan=plan, batch_axes=("data",), seq_axes=())


# -- the smoke phase -----------------------------------------------------------
# every reduced config of configs.ASSIGNED (bf16) and the reference's bench
# cell of fig5-fig9 (reduced yi-9b in float32) served as the serve CLI
# serves --requests 8 at its other defaults on the card, then on the CPU
# from the same weights; three steps
# of the train CLI's path for reduced yi-9b and deepseek-v2 (flash with lse
# at (16, 16) and (24, 16))
SMOKE_SERVE = dict(requests=8, prompt_len=32, min_prompt=4, max_new=32,
                   max_len=256, num_slots=8, page_size=16, k_block=8)
SMOKE_TRAIN_ARCHS = ("yi-9b", "deepseek-v2-236b")
SMOKE_TRAIN_STEPS = 3
SMOKE_TRAIN_SHAPE = (8, 256)    # the train CLI's --global-batch, --seq-len
SMOKE_TRAIN_LR = 3e-4           # the train CLI's --lr
# step 0's loss on the card against the CPU's, same weights and batch:
# fp32, the same sums in other orders (~1e-6 of a loss of ~5.5); bf16,
# each side rounds to bf16 in other places (flash's bf16 probabilities
# against the plain fp32 softmax; cuBLAS against the CPU's GEMMs), up to
# 2**-8 of a unit-scale value through two layers into a mean over 2048
# tokens
SMOKE_LOSS_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
ATTN_KINDS = ("attn", "local", "moe", "mla_moe", "hybrid")  # prefill: flash
FULL_KINDS = ("attn", "moe")       # decode: paged pools (strips if none)
RING_KINDS = ("local", "hybrid")   # decode: isp decode on window rings


def smoke_requests(cfg):
    """The serve CLI's requests for ``--requests 8`` at its other defaults
    (launch/serve.py's _serve, --seed 0: prompts of 4..32 tokens)."""
    s = SMOKE_SERVE
    rng = np.random.default_rng(SEED)
    return [(rng.integers(0, cfg.vocab_size,
                          rng.integers(s["min_prompt"],
                                       s["prompt_len"] + 1)).tolist(),
             s["max_new"]) for _ in range(s["requests"])]


def smoke_serve(cfg, params, requests, device):
    """``requests`` through a ServeEngine built as the serve CLI builds it,
    the launch counters set to 0 just before the run and read just after:
    (engine, results, launches, prefill calls)."""
    from repro_torch.core.telemetry import TelemetryHub
    from repro_torch.kernels import ops
    from repro_torch.train.serve_loop import AdmissionController, ServeEngine
    s = SMOKE_SERVE
    eng = ServeEngine(
        cfg, params, admission=AdmissionController(
            s["num_slots"], host_rate=20.0, csd_rate=1.0, n_csds=1),
        telemetry=TelemetryHub(), max_len=s["max_len"],
        num_slots=s["num_slots"], kv_layout="paged",
        page_size=s["page_size"], k_block=s["k_block"], device=device)
    for prompt, max_new in requests:
        eng.submit(prompt, max_new=max_new)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    ops.reset_launch_counts()
    results = eng.run_until_complete()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    launches = ops.launch_counts()
    assert len(results) == len(requests) and all(
        r.status == "ok" for r in results), [r.status for r in results]
    assert [len(r.tokens) for r in results] == [m for _, m in requests]
    assert all(0 <= t < cfg.vocab_size for r in results for t in r.tokens)
    if eng.pager is not None:
        eng.pager.check_balanced()
    return eng, results, launches, len(phases(eng.tele, "prefill"))


def smoke_cells():
    """(tag, config) of the smoke phase's serve cells."""
    from repro_torch.config import reduced_config
    from repro_torch.configs import ASSIGNED
    return [(a, reduced_config(a)) for a in ASSIGNED] + [
        ("yi-9b fp32", dataclasses.replace(reduced_config("yi-9b"),
                                           dtype="float32"))]


def smoke_phase(dev):
    """Each smoke cell served on the card and on the CPU from the same
    weights (drawn on the CPU, copied to the card): every request ok, free
    lists balanced, on the card flash on every attention layer of every
    prefill call and paged or isp decode on every attention layer of every
    decode step, nothing launched on the CPU; fp32 tokens identical, bf16
    tokens parting only where the top-2 margin is below BF16_FLIP_MARGIN.
    Then SMOKE_TRAIN_STEPS steps of ``train_loop.train`` (the train CLI's
    path) for each of SMOKE_TRAIN_ARCHS on the card: finite losses, flash
    on every attention layer of every step, step 0's loss within
    SMOKE_LOSS_TOL of the CPU's on the same weights and batch.  Returns the
    serve cells' launches summed and the train runs'."""
    from repro_torch.config import ShapeConfig, reduced_config
    from repro_torch.data import DataConfig, ShardedLoader, \
        SyntheticTokenSource
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.optim import AdamWConfig
    from repro_torch.sharding import make_plan, make_recipe
    from repro_torch.train import train_loop as TL
    serve_total, train_total = {}, {}
    for tag, cfg in smoke_cells():
        t0 = time.perf_counter()
        cpu = M.init_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
        params = M.init_params(
            cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
        params.load_state_dict(cpu.state_dict())
        requests = smoke_requests(cfg)
        eng, res, ln, calls = smoke_serve(cfg, params, requests, dev)
        steps, layout = eng.stats.decode_steps, eng.kv_layout
        kinds = cfg.layer_pattern
        n_attn = sum(k in ATTN_KINDS for k in kinds)
        n_full = sum(k in FULL_KINDS for k in kinds)
        n_ring = sum(k in RING_KINDS for k in kinds)
        n_paged = n_full if layout == "paged" else 0
        want = dict(flash_attention=n_attn * calls,
                    paged_decode=n_paged * steps,
                    isp_decode=(n_ring + n_full - n_paged) * steps)
        assert {k: ln[k] for k in want} == want, (tag, ln, want)
        assert steps > 0 and calls > 0, tag
        for k, v in ln.items():
            serve_total[k] = serve_total.get(k, 0) + v
        del eng
        _, res_cpu, ln_cpu, _ = smoke_serve(cfg, cpu, requests, "cpu")
        assert not any(ln_cpu.values()), (tag, ln_cpu)
        got = [r.tokens for r in res]
        ref_tokens = [r.tokens for r in res_cpu]
        if cfg.dtype == "float32":
            assert got == ref_tokens, f"smoke {tag}: card and CPU disagree"
            flips = 0
        else:
            flips = check_flips(f"smoke {tag}", requests, got, ref_tokens,
                                params, cfg, dev, BF16_FLIP_MARGIN)
        log(f"[smoke] {tag} ({cfg.dtype}, {'/'.join(sorted(set(kinds)))}, "
            f"{cfg.num_layers} layers, H {cfg.num_heads}/{cfg.num_kv_heads} "
            f"dh {cfg.resolved_head_dim}"
            + (f", MLA qk {cfg.attn.qk_nope_dim}+{cfg.attn.qk_rope_dim} v "
               f"{cfg.attn.v_head_dim}" if "mla_moe" in kinds else "")
            + f"): {len(res)} requests ok on the card and the CPU, "
            f"{layout} layout, {calls} prefill calls, {steps} decode steps; "
            f"launches {want}; tokens "
            + ("identical" if flips == 0 else f"{flips} near-tie flips")
            + f" against the CPU's; {time.perf_counter() - t0:.2f} s")
        del params, cpu
    free_device()
    B, S = SMOKE_TRAIN_SHAPE
    for arch in SMOKE_TRAIN_ARCHS:
        cfg = reduced_config(arch)
        assert cfg.remat == "none", cfg.remat   # flash once a layer a step
        dcfg = DataConfig(seq_len=S, global_batch=B,
                          vocab_size=cfg.vocab_size, seed=SEED)
        tcfg = TL.TrainConfig(steps=SMOKE_TRAIN_STEPS, lr=SMOKE_TRAIN_LR,
                              log_every=1, ckpt_every=10**9, seed=SEED)
        # step 0's loss on the CPU: the weights train() draws (its state
        # from the same seed), copied to the CPU, and its first batch
        recipe = make_recipe(make_plan(None, cfg), cfg, ShapeConfig(S, B))
        first = TL.build_state(cfg, recipe, AdamWConfig(lr=tcfg.lr), SEED,
                               dev).params
        cpu = M.init_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
        cpu.load_state_dict(first.state_dict())
        del first
        batch = ShardedLoader(SyntheticTokenSource(dcfg.vocab_size,
                                                   dcfg.seed),
                              dcfg).global_batch_at(0)
        with torch.no_grad():
            cpu_loss = float(M.loss_fn(cpu, {
                k: torch.as_tensor(v) for k, v in batch.items()}, cfg)[0])
        del cpu
        mets = []
        t0 = time.perf_counter()
        ops.reset_launch_counts()
        TL.train(cfg, dcfg, tcfg, device=dev,
                 metrics_cb=lambda step, m: mets.append(m))
        torch.cuda.synchronize()
        ln = ops.launch_counts()
        losses = [m["loss"] for m in mets]
        assert len(losses) == SMOKE_TRAIN_STEPS and all(
            math.isfinite(x) for x in losses), (arch, losses)
        n_attn = sum(k in ATTN_KINDS for k in cfg.layer_pattern)
        assert ln["flash_attention"] == n_attn * SMOKE_TRAIN_STEPS, (arch,
                                                                     ln)
        d = abs(losses[0] - cpu_loss)
        log(f"[smoke] train {arch} ({cfg.dtype}, {B} x {S}, "
            f"{SMOKE_TRAIN_STEPS} steps): losses "
            f"{[round(x, 5) for x in losses]}; step 0 against the CPU's "
            f"{cpu_loss:.5f} on the same weights and batch (|difference| "
            f"{d:.3g}, bound {SMOKE_LOSS_TOL[cfg.dtype]:g}); launches {ln}; "
            f"{time.perf_counter() - t0:.2f} s")
        assert d <= SMOKE_LOSS_TOL[cfg.dtype], (arch, losses[0], cpu_loss)
        for k, v in ln.items():
            train_total[k] = train_total.get(k, 0) + v
    free_device()
    return serve_total, train_total


# -- the cli phase ------------------------------------------------------------
# the serve CLI's own entry point on the card: a trace file at full width,
# the smoke config at the reference's defaults, an empty trace file
CLI_LAYERS = 8
CLI_REQUESTS = 8
CLI_DIR = ROOT / "build" / "cli"


def cli_trace(path, vocab_size) -> list:
    """Write the cli phase's trace file (seed SEED: CLI_REQUESTS prompts of
    16..700 tokens, the odd ones with a ``| max_new`` tail, a comment line
    and a blank line); returns its (prompt, max_new) list at the CLI's
    default --max-new of 32."""
    rng = np.random.default_rng(SEED)
    lines, out = [f"# cli phase: {CLI_REQUESTS} prompts, seed {SEED}"], []
    for i in range(CLI_REQUESTS):
        prompt = rng.integers(0, vocab_size,
                              int(rng.integers(16, 701))).tolist()
        max_new = 16 * (i // 2 + 1) if i % 2 else 32
        lines.append(" ".join(map(str, prompt))
                     + (f" | {max_new}" if i % 2 else ""))
        if i == CLI_REQUESTS // 2:
            lines.append("")
        out.append((prompt, max_new))
    path.write_text("\n".join(lines) + "\n")
    return out


def run_cli(argv):
    """``launch/serve.py``'s main on ``argv`` in this process, its engine
    class wrapped to keep the engine, what was submitted and the results,
    the launch counters set to 0 just before and read just after:
    (exit code, engine, submits, results, launches, stdout)."""
    import contextlib
    import io
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as cli
    seen = SimpleNamespace(engine=None, submits=[], results=None)

    class Engine(cli.ServeEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            seen.engine = self

        def submit(self, prompt, max_new=32, **kw):
            seen.submits.append((list(prompt), max_new))
            return super().submit(prompt, max_new=max_new, **kw)

        def run_until_complete(self):
            seen.results = super().run_until_complete()
            return seen.results

    saved, cli.ServeEngine = (cli.ServeEngine, sys.argv), Engine
    sys.argv = ["repro_torch.launch.serve"] + argv
    out = io.StringIO()
    try:
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        with contextlib.redirect_stdout(out):
            rc = cli.main()
        torch.cuda.synchronize()
        launches = ops.launch_counts()
    finally:
        cli.ServeEngine, sys.argv = saved
    for line in out.getvalue().splitlines():
        log(f"[cli]   {line}")
    return rc, seen.engine, seen.submits, seen.results, launches, \
        out.getvalue()


def cli_phase(dev) -> dict:
    """The serve CLI on the card (see the module docstring, 3c); returns
    the trace run's launches."""
    from repro_torch.config import get_config
    from repro_torch.core.telemetry import TelemetryHub
    from repro_torch.models import model as M
    from repro_torch.train.serve_loop import AdmissionController, ServeEngine
    t0 = time.perf_counter()
    CLI_DIR.mkdir(parents=True, exist_ok=True)
    cfg = dataclasses.replace(get_config("yi-9b"), num_layers=CLI_LAYERS)
    assert cfg.dtype == "bfloat16", cfg.dtype
    trace, empty = CLI_DIR / "prompts.txt", CLI_DIR / "empty.txt"
    requests = cli_trace(trace, cfg.vocab_size)
    timeline = CLI_DIR / "timeline.json"
    rc, eng, submits, results, launches, _ = run_cli([
        "--arch", "yi-9b", "--layers", str(CLI_LAYERS), "--trace",
        str(trace), "--max-len", "1024", "--num-slots", "8", "--kv-layout",
        "paged", "--k-block", "8", "--seed", str(SEED), "--trace-out",
        str(timeline)])
    assert rc == 0, rc
    assert eng.device.type == "cuda" and eng.cfg == cfg, (eng.device,
                                                          eng.cfg)
    assert submits == requests, "cli: the trace file was not served as " \
        "written"
    check_serve("cli", cfg, eng, results, launches,
                len(phases(eng.tele, "prefill")), requests)
    assert json.loads(timeline.read_text())["traceEvents"]
    steps, calls = eng.stats.decode_steps, len(phases(eng.tele, "prefill"))
    got = [r.tokens for r in results]
    t_cli = time.perf_counter() - t0
    del eng, results
    free_device()
    # the same list through a ServeEngine built as the CLI builds it
    params = M.init_params(
        cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    direct = ServeEngine(
        cfg, params, admission=AdmissionController(
            8, host_rate=20.0, csd_rate=1.0, n_csds=1),
        telemetry=TelemetryHub(), max_len=1024, num_slots=8,
        kv_layout="paged", page_size=16, num_pages=None, k_block=8,
        chunk_prefill=None, chunk_budget=1, prewarm=False,
        admission_order="fifo", device=dev)
    for prompt, max_new in requests:
        direct.submit(prompt, max_new=max_new)
    want = [r.tokens for r in direct.run_until_complete()]
    assert got == want, "cli: the CLI's tokens differ from the engine's"
    del direct, params
    free_device()
    log(f"[cli] yi-9b ({CLI_LAYERS} of 48 layers, bf16) --trace "
        f"{trace.relative_to(ROOT)}: {len(requests)} requests of "
        f"{[len(p) for p, _ in requests]} tokens, max_new "
        f"{[m for _, m in requests]}, all ok; {calls} prefill calls, "
        f"{steps} decode steps, launches {launches}; tokens identical to "
        f"a direct ServeEngine's on the same weights; {t_cli:.2f} s")
    # the reference's defaults: --batch 4 prompts of --prompt-len 32
    rc, eng, submits, results, ln, _ = run_cli(["--arch", "yi-9b",
                                                "--smoke"])
    assert rc == 0, rc
    assert eng.device.type == "cuda", eng.device
    assert [(len(p), m) for p, m in submits] == [(32, 32)] * 4, submits
    assert [(r.status, len(r.tokens)) for r in results] == [("ok", 32)] * 4
    assert ln["flash_attention"] > 0 and ln["paged_decode"] > 0, ln
    log(f"[cli] yi-9b --smoke with no other flag: 4 prompts of 32 tokens, "
        f"all ok with 32 tokens; launches {ln}")
    del eng, results
    empty.write_text("# no requests\n\n")
    rc, _, submits, _, _, out = run_cli(["--arch", "yi-9b", "--smoke",
                                         "--trace", str(empty)])
    assert rc == 1 and not submits, (rc, submits)
    assert "[serve] no requests (empty --trace file?)" in out.splitlines()
    free_device()
    log(f"[cli] an empty trace file exits 1; phase "
        f"{time.perf_counter() - t0:.2f} s")
    return launches


# -- the energy phase ----------------------------------------------------------
# core/energy.py's H100 constants fitted on the card's own energy counter:
# E = P0 t + a F + b B by least squares over calibration windows whose
# FLOPs and bytes are known exactly, then held out on the roofline phase's
# yi-9b train steps and decode ticks, whose counts it gives
ENERGY_WINDOW_S = 2.5      # every window lasts at least this (> 2 s)
WINDOW_AHEAD = 4           # calls the host may queue ahead of the card
ENERGY_CAL_TOL = 0.10      # each calibration window predicted within 10%
ENERGY_HELD_TOL = 0.35     # each held-out window within 35% (PERF.md)
ENERGY_GEMM_N = 8192       # the compute window's bf16 GEMM, 8192^3
ENERGY_COPY_BYTES = 4 * 10**9   # each buffer of the byte window's copy
SMI_PERIOD_MS = 100        # nvidia-smi's power samples beside the counter
SMI_FIELDS = ("power.draw.instant", "power.draw")


def smi_power_field() -> str:
    """The first of SMI_FIELDS the installed nvidia-smi reads (on Ampere
    and later, ``power.draw`` is a one-second average)."""
    for field in SMI_FIELDS:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={field}",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=60)
        try:
            float(out.stdout.strip().splitlines()[0])
            return field
        except (ValueError, IndexError):
            continue
    return SMI_FIELDS[-1]


class PowerMeter:
    """The card's energy over windows of the host clock, from two sources:
    NVML's total-energy counter (mJ since the GPU's kernel module loaded),
    read through ctypes from libnvidia-ml.so.1, and nvidia-smi's power
    samples every SMI_PERIOD_MS (a child process writing to a file under
    build/), integrated over the same window.  The counter is the source
    where it can be read; the integral otherwise, and every joule figure
    names its source."""

    def __init__(self):
        import atexit
        import ctypes
        self.ctypes, self.lib, self.handle, self.why = ctypes, None, None, ""
        try:
            lib = ctypes.CDLL("libnvidia-ml.so.1")
            for fn in ("nvmlInit_v2", "nvmlShutdown",
                       "nvmlDeviceGetHandleByIndex_v2",
                       "nvmlDeviceGetTotalEnergyConsumption"):
                getattr(lib, fn).restype = ctypes.c_int    # nvmlReturn_t
            lib.nvmlInit_v2.argtypes = lib.nvmlShutdown.argtypes = []
            lib.nvmlDeviceGetHandleByIndex_v2.argtypes = [
                ctypes.c_uint, ctypes.POINTER(ctypes.c_void_p)]
            lib.nvmlDeviceGetTotalEnergyConsumption.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_ulonglong)]
            handle = ctypes.c_void_p()
            rc = lib.nvmlInit_v2()
            if rc == 0:
                rc = lib.nvmlDeviceGetHandleByIndex_v2(0, ctypes.byref(handle))
            if rc == 0:
                self.lib, self.handle = lib, handle
                if self.counter_mj() is None:
                    self.lib, self.why = None, "nvmlDeviceGetTotalEnergy" \
                        "Consumption is not supported on this card"
            else:
                self.why = f"NVML returned {rc} at init"
        except OSError as e:
            self.why = f"libnvidia-ml.so.1 did not load: {e}"
        self.field = smi_power_field()
        self.path = ROOT / "build" / "power_samples.csv"
        self.path.parent.mkdir(parents=True, exist_ok=True)
        # line-buffered (stdbuf), so that each sample reaches the file as
        # it is taken and not in blocks of a few kB
        import shutil
        line = ["stdbuf", "-oL"] if shutil.which("stdbuf") else []
        with open(self.path, "w") as f:
            self.proc = subprocess.Popen(
                line + ["nvidia-smi", f"--query-gpu=timestamp,{self.field}",
                        "--format=csv,noheader,nounits", "-lms",
                        str(SMI_PERIOD_MS), "-i", "0"],
                stdout=f, stderr=subprocess.DEVNULL)
        atexit.register(self.close)
        self.windows = []
        log(f"[energy] sources: "
            + ("NVML's total-energy counter (nvmlDeviceGetTotalEnergy"
               "Consumption, mJ)" if self.lib else
               f"no energy counter ({self.why}): nvidia-smi's integral")
            + f"; beside it nvidia-smi {self.field} every {SMI_PERIOD_MS} ms")

    @property
    def source(self) -> str:
        return "NVML counter" if self.lib else \
            f"nvidia-smi {self.field} integral"

    def counter_mj(self):
        if self.lib is None:
            return None
        v = self.ctypes.c_ulonglong()
        rc = self.lib.nvmlDeviceGetTotalEnergyConsumption(
            self.handle, self.ctypes.byref(v))
        return int(v.value) if rc == 0 else None

    def measure(self, kind, label, fn, flops=0.0, nbytes=0.0, items=None):
        """Run ``fn`` between two synchronizes and read both sources
        around it: a window of ``kind`` ("calibration", "held-out" or
        "item") with its known FLOPs and bytes; ``out`` keeps fn's
        result."""
        # the window's ends on the wall clock, which nvidia-smi's sample
        # timestamps are on; its length on perf_counter
        torch.cuda.synchronize()
        e0, p0 = self.counter_mj(), time.perf_counter()
        t0 = time.time()  # lint: disable=banned-api
        out = fn()
        torch.cuda.synchronize()
        t1 = time.time()  # lint: disable=banned-api
        p1, e1 = time.perf_counter(), self.counter_mj()
        w = SimpleNamespace(kind=kind, label=label, t0=t0, t1=t1, s=p1 - p0,
                            counter_j=None if e0 is None or e1 is None
                            else (e1 - e0) / 1e3, smi_j=None, flops=flops,
                            nbytes=nbytes, items=items, out=out)
        self.windows.append(w)
        return w

    def measure_for(self, kind, label, fn, flops=0.0, nbytes=0.0):
        """``measure`` of ``fn`` called back to back until ENERGY_WINDOW_S
        have passed on the host clock (at least twice; the closing
        synchronize then waits for the card, so the window is never
        shorter, and the host runs at most WINDOW_AHEAD calls ahead of
        the card, so it is not much longer): the label gains the count,
        and FLOPs, bytes and items are ``flops``, ``nbytes`` and 1 a call
        times that count."""
        def run():
            n, t0, ends = 0, time.perf_counter(), []
            while n < 2 or time.perf_counter() - t0 < ENERGY_WINDOW_S:
                fn()
                n += 1
                ends.append(torch.cuda.Event())
                ends[-1].record()
                if len(ends) > WINDOW_AHEAD:
                    ends.pop(0).synchronize()
            return n
        w = self.measure(kind, label, run)
        w.label, w.items = f"{label} x {w.out}", w.out
        w.flops, w.nbytes = w.out * flops, w.out * nbytes
        return w

    def integrate(self) -> None:
        """nvidia-smi's integral (the samples' mean power times the
        window) for every window, once the last sample has landed."""
        import datetime
        time.sleep(2 * SMI_PERIOD_MS / 1e3)
        samples = []
        for line in self.path.read_text().splitlines():
            parts = [x.strip() for x in line.split(",")]
            try:
                t = datetime.datetime.strptime(
                    parts[0], "%Y/%m/%d %H:%M:%S.%f").timestamp()
                samples.append((t, float(parts[1])))
            except (ValueError, IndexError):
                continue
        for w in self.windows:
            p = [x for t, x in samples if w.t0 <= t <= w.t1]
            w.smi_j = float(np.mean(p)) * w.s if len(p) >= 2 else None

    def joules(self, w):
        return w.counter_j if self.lib else w.smi_j

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        if self.lib is not None:
            self.lib.nvmlShutdown()
            self.lib = None


def repeat(fn, n: int) -> None:
    for _ in range(n):
        fn()


def back_to_back(fn, seconds=ENERGY_WINDOW_S) -> int:
    """How many calls of ``fn`` back to back fill ``seconds`` (from three
    timed calls after a warm one)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    return max(3, math.ceil(seconds / ((time.perf_counter() - t0) / 3)))


def fit_energy(windows):
    """(P0 in W, pJ a FLOP, pJ a byte) by least squares of E = P0 t +
    a F + b B over ``windows`` of (seconds, FLOPs, bytes, joules), each row
    divided by its joules so that every window's relative error weighs
    alike."""
    a = np.array([[t, f * 1e-12, b * 1e-12] for t, f, b, _ in windows])
    e = np.array([j for *_, j in windows], dtype=float)
    x = np.linalg.lstsq(a / e[:, None], np.ones(len(e)), rcond=None)[0]
    return tuple(float(v) for v in x)


def predict_j(consts, flops, nbytes, s) -> float:
    """``gpu_step_energy``'s total for one window with the constants
    ``consts`` (P0, pJ a FLOP, pJ a byte) in place of the module's."""
    from repro_torch.core import energy as E
    saved = E.CHIP_IDLE_W, E.PJ_PER_FLOP, E.PJ_PER_HBM_BYTE
    E.CHIP_IDLE_W, E.PJ_PER_FLOP, E.PJ_PER_HBM_BYTE = consts
    try:
        return E.gpu_step_energy(flops, nbytes, 0, s).total_j
    finally:
        E.CHIP_IDLE_W, E.PJ_PER_FLOP, E.PJ_PER_HBM_BYTE = saved


def calibration_windows(meter, dev) -> None:
    """The four calibration windows, each at least ENERGY_WINDOW_S: the
    card idle with the context alive; bf16 GEMMs of ENERGY_GEMM_N^3
    (2 N^3 FLOPs, 3 N^2 bf16 elements read or written a call); copies of
    an ENERGY_COPY_BYTES buffer to another (read once, written once); the
    two in turns."""
    n3 = ENERGY_GEMM_N
    a, b = (torch.randn(n3, n3, device=dev, dtype=torch.bfloat16)
            for _ in range(2))
    c = torch.empty_like(a)
    src = torch.ones(ENERGY_COPY_BYTES, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    gemm_f, gemm_b = 2 * n3 ** 3, 3 * n3 * n3 * 2
    copy_b = 2 * ENERGY_COPY_BYTES

    def gemm():
        torch.matmul(a, b, out=c)

    def copy():
        dst.copy_(src)

    def mix():
        gemm()
        copy()
    meter.measure("calibration", "idle (context alive, time.sleep)",
                  lambda: time.sleep(ENERGY_WINDOW_S))
    for label, fn, f, nb in (
            (f"bf16 GEMM {n3}^3", gemm, gemm_f, gemm_b),
            (f"device copy of {ENERGY_COPY_BYTES / 1e9:g} GB", copy, 0,
             copy_b),
            ("GEMM and copy in turns", mix, gemm_f, gemm_b + copy_b)):
        fn()
        meter.measure_for("calibration", label, fn, flops=f, nbytes=nb)
    del a, b, c, src, dst
    free_device()


def energy_phase(dev, meter, table1=None) -> dict:
    """The calibration windows, the fit, each calibration window and each
    held-out window (the roofline phase's) predicted against its measured
    joules, then the joules an item of the paths measured earlier (the
    yi-9b serve phase's tokens, the apps phase's queries and reviews)
    beside ``table1``, the cluster phase's Table I line (mJ a query, mean
    active drives)."""
    from repro_torch.core import energy as E
    calibration_windows(meter, dev)
    meter.integrate()
    src = meter.source
    cal = [w for w in meter.windows if w.kind == "calibration"]
    consts = fit_energy([(w.s, w.flops, w.nbytes, meter.joules(w))
                         for w in cal])
    log(f"[energy] fit of E = P0 t + a F + b B over {len(cal)} calibration "
        f"windows ({src}): CHIP_IDLE_W {consts[0]:.4f} W, PJ_PER_FLOP "
        f"{consts[1]:.6f} pJ, PJ_PER_HBM_BYTE {consts[2]:.4f} pJ")
    assert all(math.isfinite(x) and x > 0 for x in consts), consts
    out = {"source": src, "smi_field": meter.field,
           "constants": dict(zip(("CHIP_IDLE_W", "PJ_PER_FLOP",
                                  "PJ_PER_HBM_BYTE"), consts)),
           "windows": []}
    module = (E.CHIP_IDLE_W, E.PJ_PER_FLOP, E.PJ_PER_HBM_BYTE)
    for w in sorted((w for w in meter.windows if w.kind != "item"),
                    key=lambda w: w.kind != "calibration"):
        got = meter.joules(w)
        assert got is not None, (w.label, f"no joules from the {src}")
        want = predict_j(consts, w.flops, w.nbytes, w.s)
        err = want / got - 1
        row = dict(kind=w.kind, label=w.label, s=w.s, flops=w.flops,
                   bytes=w.nbytes, measured_j=got, counter_j=w.counter_j,
                   smi_j=w.smi_j, predicted_j=want, err=err)
        line = (f"[energy] {w.kind} {w.label}: {w.s:.3f} s, "
                f"{w.flops / 1e12:.3f} TFLOP, {w.nbytes / 1e9:.2f} GB; "
                f"measured {got:.2f} J ({src}; nvidia-smi {meter.field} "
                f"integral {w.smi_j if w.smi_j is None else round(w.smi_j, 2)}"
                f" J), predicted {want:.2f} J by this run's fit ({err:+.1%})")
        if None not in module:
            row["module_j"] = predict_j(module, w.flops, w.nbytes, w.s)
            line += (f", {row['module_j']:.2f} J by core/energy.py's "
                     f"constants ({row['module_j'] / got - 1:+.1%})")
        log(line)
        tol = ENERGY_CAL_TOL if w.kind == "calibration" else ENERGY_HELD_TOL
        assert abs(err) <= tol, (w.label, got, want, tol)
        assert w.s >= 2.0, (w.label, w.s)
        out["windows"].append(row)
    for w in meter.windows:
        if w.kind == "item":
            got = meter.joules(w)
            assert got is not None, (w.label, f"no joules from the {src}")
            log(f"[energy] {w.label}: {got:.2f} J over {w.s:.3f} s ({src}; "
                f"nvidia-smi integral "
                f"{w.smi_j if w.smi_j is None else round(w.smi_j, 2)} J), "
                f"{got / w.items * 1e3:.4g} mJ an item over {w.items} "
                f"items, {got / w.s:.1f} W mean")
            out[w.label] = dict(j=got, items=w.items, s=w.s,
                                mj_per_item=got / w.items * 1e3)
    if table1 is not None:
        log(f"[energy] beside them, the cluster serial run's Table I line: "
            f"{table1[0]:.1f} mJ a query of the paper's 36-drive server "
            f"model (core/energy.py's Table I half, not the card's power) "
            f"at {table1[1]:.2f} mean active drives")
    meter.close()
    return out


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
    parser.add_argument("--mesh", action="store_true", help=(
        "only build the kernels and run the two-rank phase, serve and "
        "train (both ranks on the one card over gloo)"))
    parser.add_argument("--roofline", action="store_true", help=(
        "only build the kernels and run the train phase and the roofline "
        "phase (the analysis layer's counts against the measured yi-9b "
        "train step and decode tick, and three production dry-runs)"))
    parser.add_argument("--cli", action="store_true", help=(
        "only build flash and paged decode and run the cli phase (the "
        "serve CLI's main on the card: a trace file at full width, the "
        "smoke config at the reference's defaults, an empty trace)"))
    parser.add_argument("--flash-times", action="store_true", help=(
        "only time flash at its six serve paths' shapes without lse and "
        "print them as one JSON line; for running two trees in turns"))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs an H100",
              file=sys.stderr)
        return 2
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
    if args.cli:
        from repro_torch.kernels import build
        secs = build.build(["flash_attention", "paged_decode"])
        log(f"[device] kernel build {secs:.2f} s")
        cli_phase(dev)
        log(f"[done] total {time.perf_counter() - t_start:.1f} s")
        return 0
    build_kernels()
    meter = None if args.mesh else PowerMeter()
    if args.mesh:
        mesh_phase(dev)
        log(f"[done] total {time.perf_counter() - t_start:.1f} s")
        return 0
    if args.roofline:
        _, _, tr = train_phase(dev)
        roofline = roofline_phase(dev, tr, smi, meter)
        del tr
        energy = energy_phase(dev, meter)
        log(f"[done] total {time.perf_counter() - t_start:.1f} s")
        log(json.dumps({"roofline": roofline}))
        log(json.dumps({"energy": energy}))
        return 0

    def lap(phase):
        log(f"[time] {phase} done at {time.perf_counter() - t_start:.1f} s")

    rows = kernel_phase(dev)
    app_rows, app_launches = apps_phase(dev, meter)
    rows += app_rows
    free_device()
    lap("kernels and apps")
    smoke_launches = smoke_phase(dev)
    lap("smoke configs")
    cli_phase(dev)
    lap("cli")

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
    eng, results, wall, launches, prefill_calls = serve(
        cfg, params, requests, 8, dev, meter=meter)
    st = eng.stats
    check_serve("serve", cfg, eng, results, launches, prefill_calls,
                requests)
    serve_report("serve", eng, results, wall, launches, prefill_calls)
    path_launches = {"yi-9b serve": launches, "apps": app_launches,
                     "smoke serve": smoke_launches[0],
                     "smoke train": smoke_launches[1]}

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
    del params
    free_device()
    chunk_bf16_phase(dev, requests)
    lap("chunked bf16")
    table1 = cluster_phase(dev)
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
    path_launches["yi-9b train"], train, tr = train_phase(dev)
    lap("train yi-9b")
    roofline = roofline_phase(dev, tr, smi, meter)
    del tr
    lap("roofline")
    energy = energy_phase(dev, meter, table1)
    lap("energy")
    elastic_phase(dev)
    lap("kill and resume")
    (path_launches["yi-9b tp2 serve"],
     path_launches["yi-9b tp2 train"]) = mesh_phase(dev)
    lap("two ranks")
    for row in rows:
        row["launches"] = path_launches[row["path"]][row["kernel"]]
    log(f"[done] total {time.perf_counter() - t_start:.1f} s")

    log(json.dumps({"train": train}))
    log(json.dumps({"roofline": roofline}))
    log(json.dumps({"energy": energy}))
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
