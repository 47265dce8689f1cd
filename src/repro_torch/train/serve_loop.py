"""Continuous-batching serve engine with scheduler-driven admission (port
of ``repro/train/serve_loop.py``).

  request queue ──▶ admission (PullScheduler.tick + rebalance_shares)
               ──▶ slot pool (per-slot position/length tracks)
               ──▶ plan chooser (choose_embedding_plan / choose_decode_plan)
               ──▶ TransferLedger ("bytes that never crossed the link")

Mechanics, as in the reference:
  * ``kv_layout="paged"`` keeps full-attention KV in a paged pool
    (``core.kv_pages``): prefill allocates ``ceil(len/page_size)`` pages per
    slot, decode pre-reserves the pages a K-block can touch, and
    EOS/eviction frees the slot's pages in the same tick; admission
    reserves each request's worst-case page count, so a full pool
    backpressures the queue instead of failing mid-decode;
  * ``kv_layout="strip"`` keeps them in dense per-slot strips of
    ``max_len`` rows; sliding-window layers keep a per-slot ring of
    ``window`` rows under either layout (a model with no full-attention
    layer always serves on strips);
  * prefill is length-bucketed with a fixed ``num_slots`` batch, padded only
    where padding is exact (no window ring shorter than the bucket); pad
    rows are never spliced into the pool;
  * chunked prefill (``chunk_prefill=N``, paged stacks of full-attention
    layers only): a prompt longer than N is spliced into the paged pool
    one N-row chunk at a time, up to ``chunk_budget`` chunks a tick,
    interleaved with decode blocks; the slot's device page-table row stays
    -1 until its last chunk, so the decode block's masked writes go to the
    scratch page meanwhile;
  * ``k_block`` > 1 runs up to ``k_block`` greedy steps per tick with
    on-device sampling and termination masks (``decode_block_fn``) and
    reads back one (K, num_slots) token block; ``k_block=1`` is the
    per-step host loop the fused path is held against;
  * every prefill/decode step records the chosen and the host-baseline
    link bytes in the ledgers.

On the card, prefill runs the flash-attention kernel, decode the
paged-decode kernel on paged layers and the isp-decode kernel on strips
and rings (``kernels/csrc``); the KV caches and the per-slot device state
are updated in place where the reference donated buffers.

``recipe`` (a ``sharding.ShardingRecipe``) serves under a mesh, as the
reference's engine does: every rank runs the same engine on the same
requests — the host state (page tables, ledgers, scheduler) is the same
on every rank — over its pieces of the weights and the caches (its slots
over the batch axes, its block of their strips over the sequence axes;
the paged pools whole); prefill, the K-block and chunked prefill take the
recipe.  Prefill builds each slot's whole rows, the bucket's caches are
gathered over the batch axes, and each rank splices its slots' block of
them.

``prewarm`` pays each kernel-launching site's first call before the
first request (there is no per-shape compile on the card, so
one call per site warms it); ``jit_donor`` checks that a replica's wiring
equals its donor's and shares the donor's warm sites, as the cluster's
drives do.  ``pool_clamp_frac`` is the cluster's pool-clamp fault hook.
Every entry a worker thread reaches (``step``, ``prewarm``) runs under
the engine's own ``torch.no_grad()``: grad mode is thread-local.
"""
from __future__ import annotations

import dataclasses
import math
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import sharding as sh
from repro_torch.config import ModelConfig
from repro_torch.core.isp import choose_decode_plan, choose_embedding_plan
from repro_torch.core.kv_pages import PageAllocator, pages_for
from repro_torch.core.latency import NAN, LatencyRecord, LatencyStats
from repro_torch.core.scheduler import (PullScheduler, SchedulerState,
                                        make_cluster, optimal_batch_ratio,
                                        rebalance_shares,
                                        split_block_service)
from repro_torch.core.telemetry import NULL_HUB
from repro_torch.core.transfer import TransferLedger
from repro_torch.device import resolve_device
from repro_torch.kernels import build
from repro_torch.models import model as M


@dataclass
class GenResult:
    tokens: List[int]
    prefill_s: float
    decode_s: float
    rid: int = 0
    tier: str = "host"
    drive: int = 0
    status: str = "ok"           # "ok" | "shed" | "failed"
    priority: int = 0
    queue_wait_s: float = NAN
    ttft_s: float = NAN
    tpot_s: float = NAN
    e2e_s: float = NAN


@dataclass
class ServeStats:
    requests: int = 0
    tokens: int = 0
    prefill_s: float = 0.0
    decode_s: float = 0.0
    decode_steps: int = 0        # inner decode steps actually executed
    compile_s: float = 0.0       # kernel build + first launches
    tier_tokens: Dict[str, int] = field(default_factory=dict)
    tier_requests: Dict[str, int] = field(default_factory=dict)
    ledger: TransferLedger = field(default_factory=TransferLedger)     # chosen
    baseline: TransferLedger = field(default_factory=TransferLedger)  # host-only
    latency: LatencyStats = field(default_factory=LatencyStats)
    shed_requests: int = 0
    shed_wasted_s: float = 0.0

    @property
    def link_bytes(self) -> float:
        return self.ledger.link_bytes

    @property
    def host_link_bytes(self) -> float:
        return self.baseline.link_bytes

    @property
    def bytes_never_crossed(self) -> float:
        return max(self.host_link_bytes - self.link_bytes, 0.0)

    @property
    def link_reduction(self) -> float:
        if self.host_link_bytes <= 0:
            return 0.0
        return self.bytes_never_crossed / self.host_link_bytes

    @property
    def kv_bytes_touched(self) -> float:
        return self.ledger.kv_bytes

    @property
    def kv_reduction(self) -> float:
        if self.baseline.kv_bytes <= 0:
            return 0.0
        return max(1.0 - self.ledger.kv_bytes / self.baseline.kv_bytes, 0.0)

    def tier_throughput(self, tier: str) -> float:
        dt = max(self.decode_s + self.prefill_s, 1e-9)
        return self.tier_tokens.get(tier, 0) / dt

    @property
    def steps_per_s(self) -> float:
        return self.decode_steps / max(self.decode_s, 1e-9)

    def metrics(self) -> Dict[str, float]:
        """Flat metric dict — the single source ``summary()`` renders."""
        m = {
            "requests": self.requests,
            "tokens": self.tokens,
            "prefill_s": self.prefill_s,
            "decode_s": self.decode_s,
            "decode_steps": self.decode_steps,
            "steps_per_s": self.steps_per_s,
            "compile_s": self.compile_s,
            "link_bytes": self.link_bytes,
            "host_link_bytes": self.host_link_bytes,
            "link_reduction": self.link_reduction,
            "kv_bytes": self.kv_bytes_touched,
            "kv_dense_bytes": self.baseline.kv_bytes,
            "kv_reduction": self.kv_reduction,
            "shed_requests": self.shed_requests,
            "shed_wasted_s": self.shed_wasted_s,
        }
        for tier in sorted(self.tier_tokens):
            m[f"tier.{tier}.requests"] = self.tier_requests.get(tier, 0)
            m[f"tier.{tier}.tokens"] = self.tier_tokens[tier]
            m[f"tier.{tier}.tok_per_s"] = self.tier_throughput(tier)
        return m

    def summary(self) -> str:
        m = self.metrics()
        lines = [f"requests={m['requests']} tokens={m['tokens']} "
                 f"prefill={m['prefill_s']:.2f}s "
                 f"decode={m['decode_s']:.2f}s "
                 f"({m['decode_steps']} steps, {m['steps_per_s']:.1f} "
                 f"steps/s; compile {m['compile_s']:.2f}s separate)"]
        for tier in sorted(self.tier_tokens):
            lines.append(
                f"tier[{tier}]: {m[f'tier.{tier}.requests']} reqs, "
                f"{m[f'tier.{tier}.tokens']} tok, "
                f"{m[f'tier.{tier}.tok_per_s']:.1f} tok/s")
        lines.append(
            f"link bytes: {m['link_bytes'] / 1e6:.2f} MB vs host-only "
            f"{m['host_link_bytes'] / 1e6:.2f} MB "
            f"({m['link_reduction']:.0%} never crossed the link)")
        if m["kv_dense_bytes"] > 0:
            lines.append(
                f"KV bytes touched: {m['kv_bytes'] / 1e6:.2f} MB vs "
                f"dense {m['kv_dense_bytes'] / 1e6:.2f} MB "
                f"({m['kv_reduction']:.0%} fewer KV reads)")
        if self.latency.records:
            lines.append(self.latency.summary())
        if m["shed_requests"]:
            lines.append(f"shed: {m['shed_requests']} requests "
                         f"({m['shed_wasted_s']:.3f}s serving time wasted)")
        return "\n".join(lines)


@dataclass
class TickObservation:
    """What one ``ServeEngine.step()`` did: serving wall time (``busy_s``,
    kernel build and first launches excluded and reported as
    ``compile_s``), tokens, inner decode steps and per-step item counts,
    admitted and first-token request ids."""
    busy_s: float = 0.0
    compile_s: float = 0.0
    tokens: int = 0
    steps: int = 0
    per_step_items: List[int] = field(default_factory=list)
    admitted_rids: List[int] = field(default_factory=list)
    first_token_rids: List[int] = field(default_factory=list)


@dataclass
class _Request:
    rid: int
    prompt: List[int]
    max_new: int
    priority: int = 0
    deadline_s: Optional[float] = None   # absolute TTFT deadline (engine clock)


@dataclass
class _Slot:
    index: int
    active: bool = False
    rid: int = -1
    tier: str = "host"
    pos: int = 0                 # next cache position to write
    cur_token: int = 0           # input token of the next decode step
    max_new: int = 0
    out: List[int] = field(default_factory=list)
    prefill_s: float = 0.0
    decode_s: float = 0.0
    reserved_pages: int = 0      # admission-time page reservation
    prompt: Optional[List[int]] = None   # until its prefill is spliced
    prefilling: bool = False     # chunked prefill still in flight
    prefill_done_tokens: int = 0  # prompt tokens already spliced

    @property
    def decoding(self) -> bool:
        return self.active and not self.prefilling


class AdmissionController:
    """Scheduler-driven admission: which tier pulls the next requests.

    Each admitted request is tagged with the tier whose pull it rode in on;
    ``rebalance_shares`` periodically refits the host:CSD batch ratio from
    observed per-tier service times (the paper's batch-ratio rule online).
    """

    def __init__(self, num_slots: int, host_rate: float = 20.0,
                 csd_rate: float = 1.0, n_csds: int = 1, batch_size: int = 1,
                 poll_interval: float = 0.0, rebalance_every: int = 16):
        self.num_slots = max(num_slots, 2)
        nodes = make_cluster(host_rate, csd_rate, max(n_csds, 1),
                             host_overhead=0.0, csd_overhead=0.0)
        ratio = optimal_batch_ratio(host_rate, csd_rate)
        self.sched = PullScheduler(nodes, batch_size, ratio,
                                   poll_interval=poll_interval)
        self.state: Optional[SchedulerState] = None
        self._pending: Deque[str] = deque()
        self.shares = {"host": max(self.num_slots - 1, 1), "csd": 1}
        self._busy = {"host": 0.0, "csd": 0.0}
        self._tok = {"host": 0, "csd": 0}
        self._since_rebalance = 0
        self.rebalance_every = rebalance_every

    def tiers_for(self, n: int, queued: int) -> List[str]:
        """Tier tags for the next ``n`` admissions, in scheduler pull order."""
        out: List[str] = []
        while len(out) < n:
            if self._pending:
                out.append(self._pending.popleft())
                continue
            if self.state is None or self.state.done:
                self.state = self.sched.start(max(queued, n, 1))
            a = self.sched.tick(self.state)
            if a is None:
                self.state = None
                continue
            tier = "host" if a.node.is_host else "csd"
            self._pending.extend([tier] * a.n_items)
        return out

    def observe(self, tier: str, busy_s: float, tokens: int) -> None:
        """Feed measured service back; refit the batch ratio periodically.
        Negative / non-finite intervals are dropped whole."""
        if busy_s < 0.0 or not math.isfinite(busy_s):
            return
        self._busy[tier] += busy_s
        self._tok[tier] += tokens
        self._since_rebalance += 1
        if self._since_rebalance < self.rebalance_every:
            return
        if min(self._tok.values()) == 0:
            return
        self._since_rebalance = 0
        step_times = {t: self._busy[t] / self._tok[t] for t in self._tok}
        tput = {t: self._tok[t] / max(self._busy[t], 1e-9) for t in self._tok}
        self._busy = {t: 0.0 for t in self._busy}
        self._tok = {t: 0 for t in self._tok}
        if max(step_times.values()) <= 1.10 * min(step_times.values()):
            return       # no observable tier difference: keep configured ratio
        self.shares = rebalance_shares(step_times, self.shares,
                                       self.num_slots)
        self.sched.batch_ratio = max(tput["host"] / max(tput["csd"], 1e-9),
                                     1e-3)


class ServeEngine:
    """Continuous-batching greedy-decode engine over a fixed slot pool.

    ``params`` is the port's ``LM``; ``device=None`` means CUDA and raises
    when no CUDA device is present (pass ``device="cpu"`` for the plain
    path).  The model's weights must live on that device.
    """

    def __init__(self, cfg: ModelConfig, params, recipe=None,
                 max_len: int = 256,
                 eos_id: Optional[int] = None, num_slots: int = 8,
                 bucket_quantum: int = 8, shards: int = 16,
                 admission: Optional[AdmissionController] = None,
                 kv_layout: str = "paged", page_size: int = 16,
                 num_pages: Optional[int] = None, k_block: int = 8,
                 chunk_prefill: Optional[int] = None, prewarm: bool = False,
                 jit_donor: Optional["ServeEngine"] = None,
                 admission_order: str = "fifo", chunk_budget: int = 1,
                 shed_expired: bool = True, telemetry=None, device=None):
        if kv_layout not in ("paged", "strip"):
            raise ValueError(f"kv_layout must be 'paged' or 'strip', "
                             f"got {kv_layout!r}")
        if admission_order not in ("fifo", "edf"):
            raise ValueError(f"admission_order must be 'fifo' or 'edf', "
                             f"got {admission_order!r}")
        self.device = resolve_device(device)
        w = next(params.parameters())
        if w.device.type != self.device.type:
            raise ValueError(f"model weights live on {w.device}, the engine "
                             f"runs on {self.device}")
        self.cfg = cfg
        self.params = params
        self.recipe = recipe if recipe is not None and \
            recipe.mesh is not None else None
        self._shard = (0, 1)             # (this rank's block, blocks)
        # this rank's slots (the batch axes split them)
        self._rows = sh.batch_rows(self.recipe, num_slots)
        if self.recipe is not None:
            if self.recipe.seq_axes:
                self._shard = (sh.axis_index(self.recipe,
                                             self.recipe.seq_axes),
                               sh.axes_size(self.recipe,
                                            self.recipe.seq_axes))
        # prefill builds whole rows of the sequence; each rank splices its
        # block of them
        self._prefill_recipe = None if self.recipe is None else \
            dataclasses.replace(self.recipe, seq_axes=())
        self.max_len = max_len
        self.eos_id = eos_id
        self.num_slots = num_slots
        self.bucket_quantum = max(bucket_quantum, 1)
        self.shards = shards
        self.admission = admission if admission is not None else \
            AdmissionController(num_slots)
        self.k_block = max(int(k_block), 1)
        if jit_donor is not None:
            # replicas share the donor's warm sites and its built kernels
            # (the libraries are loaded once a process), which holds only
            # if the wiring is identical
            same = (jit_donor.cfg == cfg and jit_donor.recipe is self.recipe
                    and jit_donor.k_block == self.k_block
                    and jit_donor.eos_id == eos_id
                    and jit_donor.max_len == max_len
                    and jit_donor.device == self.device)
            if not same:
                raise ValueError(
                    "jit_donor wiring (cfg/recipe/k_block/eos_id/max_len/"
                    "device) "
                    "differs from this engine; replicas must be identical")
        self.kv_layout = kv_layout if self._has_paged_layers() else "strip"
        self.page_size = max(page_size, 1)
        self._maxp = pages_for(max_len, self.page_size)
        # chunked prefill needs the paged layout and a stack of
        # full-attention layers only (a window ring would have to carry
        # state across chunks)
        self.chunk_prefill: Optional[int] = None
        if chunk_prefill and self.kv_layout == "paged" and \
                all(k in ("attn", "moe") for k in cfg.layer_pattern):
            self.chunk_prefill = max(int(chunk_prefill), 1)
        if self.kv_layout == "paged":
            if num_pages is None:
                num_pages = num_slots * self._maxp    # dense worst case
            self.pager: Optional[PageAllocator] = PageAllocator(
                num_pages, self.page_size)
            self.page_table = np.full((num_slots, self._maxp), -1, np.int32)
            self.caches = M.init_caches(cfg, num_slots, max_len, paged=True,
                                        page_size=self.page_size,
                                        num_pages=num_pages,
                                        device=self.device,
                                        plan=self.recipe)
            # the single device copy of the page table; every paged group's
            # ``pages`` leaf is a view of it, so row updates reach all
            # layers at once
            self._pages_dev = torch.full((num_slots, self._maxp), -1,
                                         dtype=torch.int32,
                                         device=self.device)
            self._sync_pages_leaves()
        else:
            self.pager = None
            self.page_table = None
            self._pages_dev = None
            self.caches = M.init_caches(cfg, num_slots, max_len,
                                        per_slot=True, device=self.device,
                                        plan=self.recipe)
        # per-slot decode state of the fused block, updated in place at
        # admission/finish and round-tripped through the block
        dev = self.device
        self._tok_dev = torch.zeros(num_slots, dtype=torch.int32, device=dev)
        self._pos_dev = torch.zeros(num_slots, dtype=torch.int32, device=dev)
        self._alive_dev = torch.zeros(num_slots, dtype=torch.bool, device=dev)
        self._rem_dev = torch.zeros(num_slots, dtype=torch.int32, device=dev)
        self.slots = [_Slot(index=i) for i in range(num_slots)]
        self.queue: Deque[_Request] = deque()
        self.stats = ServeStats()
        self.ledger = self.stats.ledger
        self.baseline = self.stats.baseline
        self._next_rid = 0
        self._finished: List[GenResult] = []
        self.admission_order = admission_order
        self.chunk_budget = max(int(chunk_budget), 1)
        self.shed_expired = shed_expired
        # fault injection (page_pool_clamp): only this fraction of the KV
        # page pool is admissible to NEW requests; in-flight reservations
        # are untouched.  1.0 = unclamped; the cluster sets it per tick.
        self.pool_clamp_frac = 1.0
        # virtual serving clock: advances by measured serving time (kernel
        # build and first launches excluded); every LatencyRecord lives on it
        self.clock = 0.0
        self.records: Dict[int, LatencyRecord] = {}
        self.tele = telemetry if telemetry is not None else NULL_HUB
        self.tele_track = "engine"
        self.tele_requests = True
        # first-use attribution: the first call at each kernel-launching
        # site (which may build the kernel and pays its first launch) is
        # booked as compile_s, not serving time; replicas share their
        # donor's set
        self._warm_keys: set = set() if jit_donor is None \
            else jit_donor._warm_keys
        self._tick_compile_s = 0.0
        self.last_tick = TickObservation()
        if self.device.type == "cuda" and jit_donor is None:
            self.stats.compile_s += build.build()
        if prewarm:
            self.prewarm()

    # -- device helpers ------------------------------------------------------

    def _sync(self) -> None:
        """Wait for queued device work, so host clocks measure it."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _dev(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a)).to(self.device)

    # -- paged KV bookkeeping ------------------------------------------------

    def _has_paged_layers(self) -> bool:
        """Paged pools exist only for full-attention layers (``"attn"``,
        ``"moe"``); a model with none serves on the strip layout."""
        return any(k in ("attn", "moe") for k in self.cfg.layer_pattern)

    def _sync_pages_leaves(self) -> None:
        """Point every paged group's ``pages`` leaf at (a view of) the
        device page table."""
        mine = self._pages_dev[self._rows]
        for g, cache in self.caches.items():
            if "pages" in cache:
                ng = cache["pages"].shape[0]
                cache["pages"] = mine[None].expand((ng,) + tuple(mine.shape))

    def _set_pages_rows(self, slot_ids: List[int]) -> None:
        """Copy the host table's rows for ``slot_ids`` to the device table."""
        idx = self._dev(np.asarray(slot_ids, np.int64))
        self._pages_dev[idx] = self._dev(self.page_table[np.asarray(slot_ids)])

    def _sync_slot_dev(self, slots: List[_Slot]) -> None:
        """Refresh the device-side decode state of ``slots``."""
        idx = self._dev(np.asarray([s.index for s in slots], np.int64))
        self._tok_dev[idx] = self._dev(
            np.asarray([s.cur_token for s in slots], np.int32))
        self._pos_dev[idx] = self._dev(np.asarray([s.pos for s in slots],
                                                  np.int32))
        self._alive_dev[idx] = self._dev(
            np.asarray([s.decoding for s in slots], bool))
        self._rem_dev[idx] = self._dev(np.asarray(
            [max(s.max_new - len(s.out), 0) for s in slots], np.int32))

    def _reservation(self, prompt_len: int, max_new: int) -> int:
        """Pages a request can ever need: prompt + generated tokens, capped
        at max_len."""
        return pages_for(min(prompt_len + max_new, self.max_len),
                         self.page_size)

    def _reservable_pages(self) -> int:
        """Free pages not spoken for by active slots' unallocated tail."""
        outstanding = sum(
            s.reserved_pages - int((self.page_table[s.index] >= 0).sum())
            for s in self.slots if s.active)
        free = self.pager.num_free
        if self.pool_clamp_frac < 1.0:
            cap = int(self.pager.num_pages * self.pool_clamp_frac)
            free = min(free, cap - self.pager.num_in_use)
        return free - outstanding

    def _kv_bytes_per_token(self) -> int:
        """K+V bytes one token row costs across all full-attention layers."""
        n_kv_layers = sum(k in ("attn", "moe") for k in self.cfg.layer_pattern)
        return 2 * self.cfg.num_kv_heads * self.cfg.resolved_head_dim \
            * M.torch_dtype(self.cfg).itemsize * n_kv_layers

    def kv_stats(self) -> Dict[str, float]:
        """Live/peak KV footprint of the full-attention layers vs the dense
        per-slot baseline (bytes)."""
        per_token = self._kv_bytes_per_token()
        dense_tokens = self.num_slots * self.max_len
        if self.kv_layout == "paged":
            live = self.pager.num_in_use * self.page_size
            peak = self.pager.peak_pages * self.page_size
            pool = self.pager.num_pages * self.page_size
        else:
            live = peak = pool = dense_tokens
        return {"layout": self.kv_layout, "page_size": self.page_size,
                "live_kv_bytes": live * per_token,
                "peak_kv_bytes": peak * per_token,
                "pool_kv_bytes": pool * per_token,
                "dense_kv_bytes": dense_tokens * per_token}

    # -- first-use attribution -----------------------------------------------

    def _serving_time(self, key, dt: float) -> float:
        """Split a measured call between serving and first use: the first
        call at a kernel-launching site books its whole wall time as
        ``compile_s`` and contributes no serving time."""
        if key in self._warm_keys:
            return dt
        self._warm_keys.add(key)
        self.stats.compile_s += dt
        self._tick_compile_s += dt
        return 0.0

    # -- prewarm -------------------------------------------------------------

    def prewarm(self) -> float:
        """Pay every kernel-launching site's first call before the first
        request (the constructor built the kernels): one decode step with
        every write masked
        (the writes land in the scratch page; the fused block would stop on
        the host before its first step with no slot alive), one all-pad
        prefill, and one all-pad chunk against an empty page row.  Caches,
        pager, ledgers and stats stay as they were, apart from
        ``compile_s``.  Returns the seconds spent."""
        t0 = time.perf_counter()
        n = self.num_slots
        zeros = torch.zeros(n, dtype=torch.int32, device=self.device)
        with torch.no_grad():
            M.decode_fn(self.params, self.caches, zeros[:, None], zeros,
                        self.cfg, self.recipe, write_mask=zeros.bool())
            self._warm_keys.add(("decode_block",) if self.k_block > 1
                                else ("decode",))
            padded = self._bucket_len(1)
            M.prefill_fn(self.params, {
                "tokens": torch.zeros((n, padded), dtype=torch.int32,
                                      device=self.device),
                "lengths": torch.ones_like(zeros)}, self.cfg,
                self._prefill_recipe)
            self._warm_keys.add(("prefill",))
            if self.chunk_prefill is not None:
                c = self.chunk_prefill
                M.prefill_chunk_fn(
                    self.params,
                    self._chunk_view(np.full(self._maxp, -1, np.int32)),
                    torch.zeros((1, c), dtype=torch.int32,
                                device=self.device),
                    torch.full((1, c), -1, dtype=torch.int32,
                               device=self.device),
                    zeros[:1], self.cfg, self.recipe)
                self._warm_keys.add(("chunk",))
            self._sync()
        dt = time.perf_counter() - t0
        self.stats.compile_s += dt
        return dt

    # -- request intake ------------------------------------------------------

    def validate_request(self, prompt: Sequence[int],
                         max_new: int = 32) -> None:
        """Raise ValueError if this engine can never serve the request."""
        if not prompt:
            raise ValueError("empty prompt")
        if len(prompt) >= self.max_len:
            raise ValueError(f"prompt ({len(prompt)}) must fit below "
                             f"max_len ({self.max_len})")
        if self.kv_layout == "paged" and \
                self._reservation(len(prompt), max_new) > self.pager.num_pages:
            raise ValueError(
                f"request needs {self._reservation(len(prompt), max_new)} KV "
                f"pages but the pool only has {self.pager.num_pages}")

    def submit(self, prompt: Sequence[int], max_new: int = 32,
               priority: int = 0,
               deadline_s: Optional[float] = None) -> int:
        """Enqueue a request; ``deadline_s`` is an ABSOLUTE first-token
        deadline on the engine's serving clock (None = best-effort)."""
        prompt = list(prompt)
        self.validate_request(prompt, max_new)
        rid = self._next_rid
        self._next_rid += 1
        self.queue.append(_Request(rid, prompt, max_new, priority,
                                   deadline_s))
        self.records[rid] = LatencyRecord(rid=rid, priority=priority,
                                          deadline_s=deadline_s,
                                          submit_t=self.clock)
        if self.tele.enabled and self.tele_requests:
            self.tele.open_request(rid, self.clock, priority=priority,
                                   prompt_len=len(prompt), max_new=max_new)
        return rid

    def cancel(self, rid: int) -> Optional[float]:
        """Abort a request WITHOUT producing a result.  Returns the serving
        seconds already burned on it (0.0 if it was still queued), or None
        if the rid is unknown (already finished)."""
        for i, req in enumerate(self.queue):
            if req.rid == rid:
                del self.queue[i]
                self.records.pop(rid, None)
                if self.tele.enabled and self.tele_requests:
                    self.tele.close_request(rid, self.clock, "canceled",
                                            wasted_s=0.0)
                return 0.0
        for s in self.slots:
            if s.active and s.rid == rid:
                wasted = s.prefill_s + s.decode_s
                was_decoding = s.decoding
                self.records.pop(rid, None)
                if self.tele.enabled and self.tele_requests:
                    self.tele.close_request(rid, self.clock, "canceled",
                                            wasted_s=wasted)
                self._release_slot(s)
                if was_decoding and self.k_block > 1:
                    # the fused block keeps liveness on the device; a
                    # released slot must be dead there too
                    self._sync_slot_dev([s])
                return wasted
        self.records.pop(rid, None)
        return None

    # -- serving clock + shedding --------------------------------------------

    def advance_clock(self, to_t: float) -> None:
        """Fast-forward the serving clock across an idle gap; the clock
        never moves backwards."""
        self.clock = max(self.clock, to_t)

    def _shed_expired(self) -> None:
        """Drop queued requests whose deadline already passed."""
        if not self.shed_expired:
            return
        if any(r.deadline_s is not None and r.deadline_s < self.clock
               for r in self.queue):
            keep: Deque[_Request] = deque()
            for req in self.queue:
                if req.deadline_s is not None and req.deadline_s < self.clock:
                    self._shed(req.rid, req.priority, wasted_s=0.0)
                else:
                    keep.append(req)
            self.queue = keep
        for s in self.slots:
            if not (s.active and s.prefilling):
                continue
            rec = self.records.get(s.rid)
            if rec is not None and rec.deadline_s is not None \
                    and rec.deadline_s < self.clock:
                # mid-prefill: the chunks already run are booked as waste
                self._shed(s.rid, rec.priority, wasted_s=s.prefill_s,
                           prefill_s=s.prefill_s)
                self._release_slot(s)

    def _shed(self, rid: int, priority: int, wasted_s: float,
              prefill_s: float = 0.0) -> None:
        """Record one shed request: a 'shed' GenResult, its latency record
        closed out, and the waste tallied."""
        self.stats.shed_requests += 1
        self.stats.shed_wasted_s += wasted_s
        rec = self.records.pop(rid, None)
        res = GenResult(tokens=[], prefill_s=prefill_s, decode_s=0.0,
                        rid=rid, status="shed", priority=priority)
        if rec is not None:
            rec.finish_t = self.clock
            rec.status = "shed"
            self.stats.latency.add(rec)
            res.e2e_s = rec.e2e_s
            res.queue_wait_s = rec.queue_wait_s
        if self.tele.enabled:
            self.tele.counter("engine.shed")
            if self.tele_requests:
                self.tele.close_request(rid, self.clock, "shed",
                                        wasted_s=wasted_s)
        self._finished.append(res)

    # -- bucketing -----------------------------------------------------------

    def _padding_safe(self, padded_len: int) -> bool:
        """Padded prefill is exact iff no recurrent state integrates pad
        tokens and no sliding-window ring evicts real prompt positions."""
        kinds = set(self.cfg.layer_pattern)
        if kinds & {"hybrid", "mlstm", "slstm"}:
            return False
        return not ("local" in kinds and self.cfg.attn.window is not None
                    and padded_len > self.cfg.attn.window)

    def _bucket_len(self, n: int) -> int:
        q = self.bucket_quantum
        padded = min(-(-n // q) * q, self.max_len - 1)
        return padded if padded > n and self._padding_safe(padded) else n

    # -- engine steps --------------------------------------------------------

    @property
    def num_active(self) -> int:
        return sum(s.active for s in self.slots)

    @property
    def pending(self) -> int:
        return len(self.queue)

    @property
    def bytes_never_crossed(self) -> float:
        return self.stats.bytes_never_crossed

    def step(self) -> List[GenResult]:
        """One engine tick: admit into free slots, advance up to
        ``chunk_budget`` chunks of any chunked prefill in flight, then run
        one decode block (``k_block`` fused steps; ``k_block=1`` is the
        per-step host loop).  Returns the requests that finished during
        this tick."""
        n_before = len(self._finished)
        self.last_tick = obs = TickObservation()
        self._tick_compile_s = 0.0
        tok0, steps0 = self.stats.tokens, self.stats.decode_steps
        busy0 = self.stats.prefill_s + self.stats.decode_s
        with torch.no_grad():
            self._shed_expired()
            self._admit()
            if self.chunk_prefill is not None:
                self._chunk_prefill_tick()
            if any(s.decoding for s in self.slots):
                if self.k_block > 1:
                    self._decode_block_step()
                else:
                    self._decode_step()
        obs.compile_s = self._tick_compile_s
        obs.tokens = self.stats.tokens - tok0
        obs.steps = self.stats.decode_steps - steps0
        obs.busy_s = self.stats.prefill_s + self.stats.decode_s - busy0
        if not obs.per_step_items and obs.tokens:
            obs.per_step_items = [obs.tokens]
        if self.tele.enabled:
            self.tele.counter(f"{self.tele_track}.ticks")
            self.tele.counter(f"{self.tele_track}.tokens", obs.tokens)
            self.tele.gauge(f"{self.tele_track}.clock_s", self.clock)
            self.tele.counter_sample(self.tele_track, "queue_depth",
                                     self.clock, len(self.queue))
            if obs.busy_s > 0:
                self.tele.observe("tick_busy_s", obs.busy_s)
        return self._finished[n_before:]

    def run_until_complete(self) -> List[GenResult]:
        while self.queue or self.num_active:
            self.step()
        out, self._finished = self._finished, []
        return sorted(out, key=lambda r: r.rid)

    def generate(self, prompts: Sequence[Sequence[int]],
                 max_new: int = 32) -> List[GenResult]:
        """Greedy generation for a batch of prompts; results of requests
        queued earlier via ``submit()`` are kept for their caller."""
        rids = [self.submit(p, max_new) for p in prompts]
        return collect_results(self, rids)

    # -- admission + prefill -------------------------------------------------

    def _admit(self) -> None:
        free = [s for s in self.slots if not s.active]
        n = min(len(free), len(self.queue))
        if n == 0:
            return
        if self.admission_order == "edf" and len(self.queue) > 1:
            # earliest deadline first; no-deadline requests last; stable,
            # ties broken on rid
            self.queue = deque(sorted(
                self.queue,
                key=lambda r: (r.deadline_s if r.deadline_s is not None
                               else math.inf, r.priority, r.rid)))
        if self.kv_layout == "paged":
            # backpressure at the pool: admit only while each request's
            # worst case can still be reserved
            budget = self._reservable_pages()
            fits = 0
            for req in list(self.queue)[:n]:
                need = self._reservation(len(req.prompt), req.max_new)
                if need > budget:
                    break
                budget -= need
                fits += 1
            n = fits
            if n == 0:
                return
        tiers = self.admission.tiers_for(n, queued=len(self.queue))
        admitted: List[_Slot] = []
        for slot, tier in zip(free, tiers):
            req = self.queue.popleft()
            slot.active = True
            slot.rid = req.rid
            slot.tier = tier
            slot.pos = len(req.prompt)
            slot.max_new = req.max_new
            slot.out = []
            slot.prefill_s = 0.0
            slot.decode_s = 0.0
            slot.prompt = req.prompt
            slot.prefilling = self.chunk_prefill is not None and \
                len(req.prompt) > self.chunk_prefill
            slot.prefill_done_tokens = 0
            if self.kv_layout == "paged":
                slot.reserved_pages = self._reservation(len(req.prompt),
                                                        req.max_new)
                pages = self.pager.alloc(pages_for(len(req.prompt),
                                                   self.page_size))
                self.page_table[slot.index, :] = -1
                self.page_table[slot.index, : len(pages)] = pages
            admitted.append(slot)
            self.last_tick.admitted_rids.append(req.rid)
            rec = self.records.get(req.rid)
            if rec is not None:
                rec.admit_t = self.clock
            if self.tele.enabled and self.tele_requests:
                self.tele.request_point(req.rid, "admit", self.clock,
                                        tier=tier)
            self.stats.requests += 1
            self.stats.tier_requests[tier] = \
                self.stats.tier_requests.get(tier, 0) + 1
        oneshot = [s for s in admitted if not s.prefilling]
        if self.kv_layout == "paged" and oneshot:
            # mid-prefill slots keep their device row -1 (decode writes go
            # to the scratch page) until their last chunk is spliced
            self._set_pages_rows([s.index for s in oneshot])

        buckets: Dict[int, List[_Slot]] = {}
        for slot in oneshot:
            buckets.setdefault(self._bucket_len(len(slot.prompt)),
                               []).append(slot)
        for padded, group in sorted(buckets.items()):
            self._prefill_bucket(group, padded)

    def _prefill_bucket(self, group: List[_Slot], padded: int) -> None:
        b = len(group)
        prompts = [s.prompt for s in group]
        lengths = [len(p) for p in prompts]
        # fixed batch dimension: dummy length-1 rows fill the bucket up to
        # num_slots; rows are independent, so pads never touch real rows
        tokens = np.zeros((self.num_slots, padded), np.int32)
        lens = np.ones((self.num_slots,), np.int32)
        for i, p in enumerate(prompts):
            tokens[i, : lengths[i]] = p
            lens[i] = lengths[i]
        t0 = time.perf_counter()
        batch = {"tokens": self._dev(tokens), "lengths": self._dev(lens)}
        nxt, pre_caches = M.prefill_fn(self.params, batch, self.cfg,
                                       self._prefill_recipe)
        nxt = nxt.cpu().numpy()
        t1 = time.perf_counter()
        dt = self._serving_time(("prefill",), t1 - t0)
        if self._rows.stop - self._rows.start < self.num_slots:
            pre_caches = _gather_rows(self.recipe, pre_caches)
        self.caches = _splice_slots(self.caches, pre_caches,
                                    [s.index for s in group], lengths,
                                    self.page_table, self.page_size,
                                    self._shard, self._rows)
        del pre_caches
        self._sync()
        dt += time.perf_counter() - t1
        self._account_prefill(sum(lengths))
        self.clock += dt               # first tokens are stamped post-prefill
        if self.tele.enabled:
            self.tele.phase(self.tele_track, "prefill", self.clock - dt, dt,
                            batch=b, padded=padded)
        for i, s in enumerate(group):
            s.prefill_s = dt
            s.cur_token = int(nxt[i])
            s.prompt = None
            self.stats.prefill_s += dt / b
            # the prefill-sampled token is the first generated token
            self._push_token(s, s.cur_token)
        if self.k_block > 1:
            self._sync_slot_dev(group)

    def _chunk_prefill_tick(self) -> None:
        """Advance up to ``chunk_budget`` prefill chunks this tick, each
        tick still running a decode block for everyone else: budget 1
        protects in-flight decodes, larger budgets admit long prompts
        faster."""
        for _ in range(self.chunk_budget):
            slot = next((s for s in self.slots if s.active and s.prefilling),
                        None)
            if slot is None:
                return
            self._advance_chunk(slot)

    def _advance_chunk(self, slot: _Slot) -> None:
        chunk = self.chunk_prefill
        prompt = slot.prompt
        c0 = slot.prefill_done_tokens
        real = min(chunk, len(prompt) - c0)
        tokens = np.zeros((1, chunk), np.int32)
        tokens[0, :real] = prompt[c0: c0 + real]
        qpos = np.full((1, chunk), -1, np.int32)
        qpos[0, :real] = np.arange(c0, c0 + real, dtype=np.int32)
        view = self._chunk_view(self.page_table[slot.index])
        t0 = time.perf_counter()
        nxt, _ = M.prefill_chunk_fn(self.params, view, self._dev(tokens),
                                    self._dev(qpos),
                                    self._dev(np.asarray([real - 1],
                                                         np.int32)),
                                    self.cfg, self.recipe)
        nxt = nxt.cpu().numpy()
        dt = self._serving_time(("chunk",), time.perf_counter() - t0)
        self.clock += dt
        if self.tele.enabled:
            self.tele.phase(self.tele_track, "prefill_chunk",
                            self.clock - dt, dt, rid=slot.rid, tokens=real)
        slot.prefill_done_tokens = c0 + real
        slot.prefill_s += dt
        self.stats.prefill_s += dt
        self._account_prefill(real)
        if slot.prefill_done_tokens == len(prompt):
            slot.prefilling = False
            slot.prompt = None
            slot.cur_token = int(nxt[0])
            self._set_pages_rows([slot.index])
            self._push_token(slot, slot.cur_token)
            if self.k_block > 1:
                self._sync_slot_dev([slot])

    def _chunk_view(self, table_row: np.ndarray):
        """B=1 view of the paged caches for one slot: the shared kp/vp
        pools under the slot's own page-table row, so a chunk writes into
        the pool without the other slots' batch rows."""
        row = self._dev(np.asarray(table_row, np.int32)[None])   # (1, maxp)
        return {g: dict(cache, pages=row[None].expand(
                    (cache["pages"].shape[0],) + tuple(row.shape)))
                for g, cache in self.caches.items()}

    # -- decode --------------------------------------------------------------

    def _decode_step(self) -> None:
        """K=1 host loop: one decode step, one token readback per slot.
        The fused block (``_decode_block_step``) must stay token-identical
        to this path."""
        tokens = np.zeros((self.num_slots, 1), np.int32)
        positions = np.zeros((self.num_slots,), np.int32)
        for s in self.slots:
            if s.decoding:
                tokens[s.index, 0] = s.cur_token
                positions[s.index] = s.pos
        if self.kv_layout == "paged":
            self._grow_pages(1)
        t0 = time.perf_counter()
        nxt, self.caches = M.decode_fn(self.params, self.caches,
                                       self._dev(tokens),
                                       self._dev(positions), self.cfg,
                                       self.recipe)
        nxt = nxt.cpu().numpy()
        dt = self._serving_time(("decode",), time.perf_counter() - t0)
        self.stats.decode_s += dt
        self.stats.decode_steps += 1
        self.clock += dt
        if self.tele.enabled:
            self.tele.phase(self.tele_track, "decode", self.clock - dt, dt,
                            steps=1)

        active = [s for s in self.slots if s.decoding]
        self._observe_step(active, dt)
        for s in active:
            s.decode_s += dt
            s.pos += 1
            s.cur_token = int(nxt[s.index])
            self._push_token(s, s.cur_token)

    def _observe_step(self, live: List[_Slot], step_s: float) -> None:
        """Per-decode-step ledger + scheduler bookkeeping, shared by the
        K=1 loop and the fused block's replay."""
        self._account_decode(len(live), int(max(s.pos for s in live)) + 1)
        tier_counts: Dict[str, int] = {}
        for s in live:
            tier_counts[s.tier] = tier_counts.get(s.tier, 0) + 1
        for tier, cnt in tier_counts.items():
            self.admission.observe(tier, step_s * cnt / len(live), cnt)

    def _decode_block_step(self) -> None:
        """Fused tick: up to ``k_block`` decode steps with sampling and
        termination on the device; the host reads back the (K, num_slots)
        token block and replays the per-step bookkeeping from it."""
        if self.kv_layout == "paged":
            self._grow_pages(self.k_block)
        t0 = time.perf_counter()
        out = M.decode_block_fn(self.params, self.caches, self._tok_dev,
                                self._pos_dev, self._alive_dev,
                                self._rem_dev, self.cfg, self.recipe,
                                k_steps=self.k_block, eos_id=self.eos_id,
                                max_len=self.max_len)
        block, n_steps, tok, pos, alive, rem, caches = out
        self.caches = caches
        self._tok_dev, self._pos_dev = tok, pos
        self._alive_dev, self._rem_dev = alive, rem
        block = block.cpu().numpy()               # ONE readback per block
        dt = self._serving_time(("decode_block",), time.perf_counter() - t0)
        self.stats.decode_s += dt
        self.stats.decode_steps += n_steps

        active = [s for s in self.slots if s.decoding]
        emitted = block[:n_steps, [s.index for s in active]] >= 0
        self.last_tick.per_step_items = emitted.sum(axis=1).tolist()
        per_step = split_block_service(dt, self.last_tick.per_step_items)
        clock_end = self.clock + dt
        for i in range(n_steps):
            live = [s for s in active if s.decoding]
            if not live:
                break
            self.clock += per_step[i]
            self._observe_step(live, per_step[i])
            for s in live:
                t = int(block[i, s.index])
                assert t >= 0, "device/host liveness diverged"
                s.decode_s += per_step[i]
                s.pos += 1
                s.cur_token = t
                self._push_token(s, t)
        self.clock = max(self.clock, clock_end)
        if self.tele.enabled:
            self.tele.phase(self.tele_track, "decode_block", clock_end - dt,
                            dt, steps=n_steps)

    def _push_token(self, slot: _Slot, tok: int) -> None:
        """Record a generated token and finish/evict the slot if done."""
        if slot.max_new <= 0:
            self._finish(slot)
            return
        slot.out.append(tok)
        if len(slot.out) == 1:
            rec = self.records.get(slot.rid)
            if rec is not None and not math.isfinite(rec.first_token_t):
                rec.first_token_t = self.clock
            self.last_tick.first_token_rids.append(slot.rid)
            if self.tele.enabled and self.tele_requests:
                self.tele.request_point(slot.rid, "first_token", self.clock)
        self.stats.tokens += 1
        self.stats.tier_tokens[slot.tier] = \
            self.stats.tier_tokens.get(slot.tier, 0) + 1
        eos = self.eos_id is not None and tok == self.eos_id
        full = slot.pos >= self.max_len - 1
        if eos or full or len(slot.out) >= slot.max_new:
            self._finish(slot)

    def _grow_pages(self, steps: int = 1) -> None:
        """Allocate every page the next ``steps`` decode writes can touch
        (at most ``min(steps, tokens left)`` positions per slot); admission
        reserved the worst case, so this never exhausts the pool."""
        ps = self.page_size
        grew = []
        for s in self.slots:
            if not s.decoding:
                continue
            e = min(steps, max(s.max_new - len(s.out), 1))
            last = min(s.pos + e - 1, self.max_len - 1)
            for lp in range(s.pos // ps, last // ps + 1):
                if self.page_table[s.index, lp] < 0:
                    self.page_table[s.index, lp] = self.pager.alloc(1)[0]
                    grew.append(s.index)
        if grew:
            self._set_pages_rows(sorted(set(grew)))

    def _finish(self, slot: _Slot) -> None:
        res = GenResult(tokens=slot.out, rid=slot.rid, tier=slot.tier,
                        prefill_s=slot.prefill_s, decode_s=slot.decode_s)
        rec = self.records.pop(slot.rid, None)
        if rec is not None:
            rec.finish_t = self.clock
            rec.n_tokens = len(slot.out)
            rec.status = "ok"
            self.stats.latency.add(rec)
            res.priority = rec.priority
            res.queue_wait_s = rec.queue_wait_s
            res.ttft_s = rec.ttft_s
            res.tpot_s = rec.tpot_s
            res.e2e_s = rec.e2e_s
        if self.tele.enabled and self.tele_requests:
            self.tele.close_request(slot.rid, self.clock, "ok",
                                    tokens=len(slot.out))
        self._finished.append(res)
        self._release_slot(slot)

    def _release_slot(self, slot: _Slot) -> None:
        """Return a slot (and its pages) to the pool in the same step."""
        slot.active = False
        slot.prefilling = False
        slot.prompt = None
        slot.out = []
        slot.rid = -1
        if self.kv_layout == "paged":
            row = self.page_table[slot.index]
            live = [int(p) for p in row[row >= 0]]
            if live:
                self.pager.free(live)
            self.page_table[slot.index, :] = -1
            slot.reserved_pages = 0
            self._set_pages_rows([slot.index])

    # -- transfer accounting -------------------------------------------------

    def _account_prefill(self, n_tokens: int) -> None:
        """Embedding lookups for the prompt tokens: host plan ships table
        shards, ISP plan ships indexes (the paper's protocol)."""
        c = choose_embedding_plan(n_tokens, self.cfg.vocab_size,
                                  self.cfg.d_model, tp=self.shards)
        chosen = c.isp_link_bytes if c.plan == "isp" else c.host_link_bytes
        self.ledger.add("link", chosen, "prefill")
        self.baseline.add("link", c.host_link_bytes, "prefill")

    def _account_decode(self, batch: int, seq: int) -> None:
        """One decode step: embedding lookup of the step tokens plus the
        per-layer decode attention over the resident KV span."""
        e = choose_embedding_plan(batch, self.cfg.vocab_size,
                                  self.cfg.d_model, tp=self.shards)
        d = choose_decode_plan(batch, self.cfg.num_heads,
                               self.cfg.resolved_head_dim, seq,
                               self.cfg.num_kv_heads, shards=self.shards)
        layers = self.cfg.num_layers
        chosen = (e.isp_link_bytes if e.plan == "isp" else e.host_link_bytes) \
            + layers * (d.isp_link_bytes if d.plan == "isp"
                        else d.host_link_bytes)
        base = e.host_link_bytes + layers * d.host_link_bytes
        self.ledger.add("link", chosen, "decode")
        self.baseline.add("link", base, "decode")
        self._account_kv_step()

    def _account_kv_step(self) -> None:
        """KV rows of the full-attention layers this decode step walks
        (live pages, or every slot's whole strip on the strip layout) vs
        the dense per-slot strips."""
        per_token = self._kv_bytes_per_token()
        if per_token == 0:
            return
        dense = self.num_slots * self.max_len * per_token
        if self.kv_layout == "paged":
            touched = self.pager.num_in_use * self.page_size * per_token
        else:
            touched = dense
        self.ledger.add("kv", touched, "decode KV rows")
        self.baseline.add("kv", dense, "decode KV rows")


def collect_results(engine, rids: List[int]) -> List[GenResult]:
    """Drain ``engine`` and return ``rids``'s results in submission order,
    re-appending other submitters' finished results for their caller."""
    mine = set(rids)
    by_rid = {}
    for r in engine.run_until_complete():
        if r.rid in mine:
            by_rid[r.rid] = r
        else:
            engine._finished.append(r)
    return [by_rid[r] for r in rids]


def _gather_rows(recipe, tree):
    """A prefill's caches, this rank's batch rows of each leaf (ng, b, ...),
    all-gathered over the batch axes into every row (the position tracks,
    (ng, S), have none)."""
    return {k: _gather_rows(recipe, v) if isinstance(v, dict) else v
            if k == "kpos" else sh.all_gather(recipe, v, recipe.batch_axes, 1)
            for k, v in tree.items()}


def _splice_slots(pool, pre, slot_ids: List[int], lengths: List[int],
                  page_table=None, page_size: int = 0, shard=(0, 1),
                  rows: Optional[slice] = None):
    """Scatter a bucket's prefill caches into the engine's caches, per
    group and in place: paged groups into their allocated pages, strip and
    ring groups into their slots' rows (``rows``: the slots this rank
    holds; ``shard`` = (r, n): its strips are block r of n of each slot's
    rows, and ``pre`` holds them whole)."""
    for gname, dst in pool.items():
        if "pages" in dst:
            _splice_paged_group(dst, pre[gname], slot_ids, lengths,
                                page_table, page_size)
        else:
            _splice_strip_group(dst, pre[gname], slot_ids, lengths, shard,
                                rows)
    return pool


def _splice_paged_group(dst, src, slot_ids: List[int], lengths: List[int],
                        page_table, page_size: int):
    """Scatter prefill rows into the paged pool, in place.

    ``src`` leaves are dense (ng, b, padded, ...); only the first
    ``lengths[i]`` rows of each sequence are real — pad rows are never
    scattered, so the pool only ever holds live tokens.
    """
    src_b, src_pos, dst_page, dst_off = [], [], [], []
    for i, (sid, n) in enumerate(zip(slot_ids, lengths)):
        p = np.arange(n)
        src_b.append(np.full(n, i))
        src_pos.append(p)
        dst_page.append(page_table[sid, p // page_size])
        dst_off.append(p % page_size)
    pages_np = np.concatenate(dst_page)
    assert (pages_np >= 0).all(), "prefill splice into unallocated page"
    dev = dst["kp"].device
    sb = torch.from_numpy(np.concatenate(src_b)).to(dev)
    sp = torch.from_numpy(np.concatenate(src_pos)).to(dev)
    dp = torch.from_numpy(pages_np.astype(np.int64)).to(dev)
    do = torch.from_numpy(np.concatenate(dst_off)).to(dev)
    dst["kp"][:, dp, do] = src["k"][:, sb, sp].to(dst["kp"].dtype)
    dst["vp"][:, dp, do] = src["v"][:, sb, sp].to(dst["vp"].dtype)
    return dst


def _splice_strip_group(dst, src, slot_ids: List[int], lengths: List[int],
                        shard=(0, 1), rows: Optional[slice] = None):
    """Dense per-slot splice, in place, leaf by leaf of a possibly nested
    group (``"hybrid"``: ``{"attn", "ssm"}``).  ``dst`` leaves are (ng,
    num_slots, ...), ``src`` leaves (ng, bpad, ...) with the bucket's real
    sequences first.  A kpos row becomes the slot's own track: prefill
    positions at or past the true prompt length (padding) are -1, and so
    is everything past the copied span; the KV rows (``k``/``v``, MLA's
    ``ckv``/``krope``) are copied up to that span; recurrent leaves
    (Mamba's ``conv``/``ssm``, mLSTM's ``C``/``n``/``m``, sLSTM's
    ``c``/``n``/``m``/``h``) replace the slot's row whole.  With ``rows``
    ``dst`` holds only the slots ``rows.start .. rows.stop - 1``; with
    ``shard`` = (r, n) a ``dst`` strip of s rows is block r of the slot's
    n * s rows: it takes ``src``'s rows r * s .. r * s + s - 1 (those there
    are)."""
    lo, hi = (0, math.inf) if rows is None else (rows.start, rows.stop)
    sel = [(i, sid - lo) for i, sid in enumerate(slot_ids) if lo <= sid < hi]
    if not sel:
        return dst
    r, _ = shard
    for name, d in dst.items():
        s = src[name]
        if isinstance(d, dict):
            _splice_strip_group(d, s, slot_ids, lengths, shard, rows)
            continue
        src_i = torch.as_tensor([i for i, _ in sel], dtype=torch.long,
                                device=d.device)
        slots = torch.as_tensor([j for _, j in sel], dtype=torch.long,
                                device=d.device)
        if name == "kpos":
            lens = torch.as_tensor([lengths[i] for i, _ in sel],
                                   dtype=torch.int32, device=d.device)
            o = r * d.shape[2]
            n = max(0, min(s.shape[1] - o, d.shape[2]))
            row = s[:, None, o:o + n].expand(-1, len(sel), -1)
            row = torch.where((row >= 0) & (row < lens[None, :, None]), row,
                              -1)
            d[:, slots] = -1
            d[:, slots, :n] = row
        elif name in ("k", "v", "ckv", "krope"):
            o = r * d.shape[2]
            n = max(0, min(s.shape[2] - o, d.shape[2]))
            d[:, slots, :n] = s[:, src_i, o:o + n].to(d.dtype)
        else:
            d[:, slots] = s[:, src_i].to(d.dtype)
    return dst
