"""ISP execution-plan helpers: pick the cheaper side of the link.

The paper's rule, made explicit: given a workload with a big resident
object (table / KV cache / expert weights) and a small query stream, choose
between shipping data to compute ("host plan") and shipping queries to data
("ISP plan") by comparing link bytes — then record the decision in a
transfer ledger.  `core.embedding` / `core.decode_attention` / `models.moe`
implement the winning plans; this module exposes the decision function the
serving layer and benchmarks use.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Literal

from repro_torch.core.transfer import (TransferLedger,
                                       decode_attention_plans,
                                       embedding_plans, host_only_ledger,
                                       workload_split_ledger)

Plan = Literal["host", "isp"]


@dataclass(frozen=True)
class PlanChoice:
    plan: Plan
    host_link_bytes: float
    isp_link_bytes: float

    @property
    def saving(self) -> float:
        hi = max(self.host_link_bytes, 1e-9)
        return 1.0 - min(self.isp_link_bytes, hi) / hi


def choose_embedding_plan(num_lookups: int, vocab: int, d_model: int,
                          tp: int = 16, bytes_per_el: int = 2) -> PlanChoice:
    base, isp = embedding_plans(num_lookups, vocab, d_model,
                                bytes_per_el=bytes_per_el, tp=tp)
    plan: Plan = "isp" if isp.total_moved < base.total_moved else "host"
    return PlanChoice(plan, base.total_moved, isp.total_moved)


def choose_decode_plan(batch: int, heads: int, head_dim: int, seq: int,
                       kv_heads: int, shards: int = 16) -> PlanChoice:
    base, isp = decode_attention_plans(batch, heads, head_dim, seq, kv_heads,
                                       shards=shards)
    plan: Plan = "isp" if isp.total_moved < base.total_moved else "host"
    return PlanChoice(plan, base.total_moved, isp.total_moved)
