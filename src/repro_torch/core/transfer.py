"""Data-movement accounting: the paper's "68% of the data never left the
storage" analysis, generalized.

An execution plan moves bytes across three tiers (paper / TPU analogue):
  link    — host↔drive PCIe / inter-chip ICI+DCN     (slow, expensive)
  local   — drive-internal flash↔DRAM / HBM↔VMEM     (fast)
  output  — results shipped back (tiny)

``TransferLedger`` tallies them; plan helpers compute ledgers for the
host-style baseline vs the ISP layout of each core primitive, which the
benchmarks then report next to the paper's numbers.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict


@dataclass
class TransferLedger:
    link_bytes: float = 0.0
    local_bytes: float = 0.0
    output_bytes: float = 0.0
    # KV-cache rows the decode step actually walked (device-local traffic,
    # accounted separately so the paged-vs-dense reduction is visible next
    # to the link reduction; see serve_loop._account_kv_step)
    kv_bytes: float = 0.0
    notes: Dict[str, float] = field(default_factory=dict)
    # float += read-modify-writes: atomic under the concurrent cluster
    # runtime (excluded from repr/compare — plumbing, not accounting)
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)

    def add(self, tier: str, n: float, note: str = "") -> None:
        with self._lock:
            if tier == "link":
                self.link_bytes += n
            elif tier == "local":
                self.local_bytes += n
            elif tier == "kv":
                self.kv_bytes += n
            else:
                self.output_bytes += n
            if note:
                self.notes[note] = self.notes.get(note, 0.0) + n

    @property
    def total_moved(self) -> float:
        return self.link_bytes + self.output_bytes

    def reduction_vs(self, baseline: "TransferLedger") -> float:
        """Fractional link-traffic reduction vs a baseline plan."""
        if baseline.total_moved == 0:
            return 0.0
        return 1.0 - self.total_moved / baseline.total_moved


def workload_split_ledger(dataset_bytes: float, csd_fraction: float,
                          output_bytes: float) -> TransferLedger:
    """The paper's top-level accounting: the host-processed fraction crosses
    the link; the CSD-processed fraction stays put; outputs come back."""
    led = TransferLedger()
    led.add("link", dataset_bytes * (1.0 - csd_fraction), "host input")
    led.add("local", dataset_bytes * csd_fraction, "in-storage input")
    led.add("output", output_bytes, "results")
    return led


def host_only_ledger(dataset_bytes: float, output_bytes: float) -> TransferLedger:
    led = TransferLedger()
    led.add("link", dataset_bytes, "host input")
    led.add("output", output_bytes, "results")
    return led


# -- ISP primitive plans (TPU mapping) --------------------------------------


def embedding_plans(num_lookups: int, vocab: int, d_model: int,
                    bytes_per_el: int = 2, tp: int = 16):
    """(baseline, isp) ledgers for a vocab-sharded embedding lookup.

    baseline = all-gather the table shards (XLA default for plain take);
    isp      = ship indexes, psum result rows.
    """
    table = vocab * d_model * bytes_per_el
    rows = num_lookups * d_model * bytes_per_el
    base = TransferLedger()
    base.add("link", table * (tp - 1) / tp, "all-gather table")
    base.add("local", rows, "gather")
    isp = TransferLedger()
    isp.add("link", num_lookups * 4, "indexes")
    isp.add("link", 2 * rows * (tp - 1) / tp, "psum rows")
    isp.add("local", rows, "gather")
    return base, isp


def decode_attention_plans(batch: int, heads: int, head_dim: int, seq: int,
                           kv_heads: int, bytes_per_el: int = 2, shards: int = 16):
    """(baseline, isp) ledgers for one decode step's attention.

    baseline = gather the KV cache to the query's shard;
    isp      = broadcast q, psum (acc,l,m) partials.
    """
    kv = 2 * batch * seq * kv_heads * head_dim * bytes_per_el
    base = TransferLedger()
    base.add("link", kv * (shards - 1) / shards, "gather KV")
    isp = TransferLedger()
    isp.add("link", batch * heads * head_dim * bytes_per_el * shards, "broadcast q")
    isp.add("link", 2 * batch * heads * (head_dim + 2) * 4 * (shards - 1) / shards,
            "psum partials")
    isp.add("local", kv / shards, "local KV read")
    return base, isp
