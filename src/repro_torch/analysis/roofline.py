"""Three-term roofline of one step from its op records (port of the
reference's ``analysis/roofline.py``).

All terms are per rank, from the records of one rank's step
(``analysis/op_trace.py``):

  compute term    = product and kernel-site FLOPs over the peak of their
                    dtype, plus elementwise FLOPs over the CUDA cores' rate
  memory term     = HBM bytes (each op's inputs read and outputs written
                    once) over the HBM rate
  collective term = collective wire bytes over one link's rate

Machine model: one NVIDIA H100 SXM at its data sheet's dense peaks (no
sparsity), which assume the full 700 W power limit: 989 TFLOP/s in bf16
and fp16 on the tensor cores, 495 in TF32, 67 TFLOP/s in fp32 (the port
turns TF32 off for its products, ``device.py``, so fp32 products run at
this rate) and for elementwise work, 3.35 TB/s of HBM, and 450 GB/s a
direction on NVLink.  Like the reference, one link rate stands for every
axis: the slower inter-node link a "pod" axis would cross is not
modelled.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Iterable

from repro_torch.analysis.op_trace import dtype_name, totals

# dense peaks by operand dtype ("tf32": fp32 products on the tensor cores)
PEAK_FLOPS: Dict[str, float] = {"bfloat16": 989e12, "float16": 989e12,
                                "tf32": 495e12, "float32": 67e12}
PEAK_ELEMENTWISE = 67e12         # fp32 on the CUDA cores
HBM_BYTES_PER_S = 3.35e12
LINK_BYTES_PER_S = 450e9         # NVLink, one direction
HBM_CAPACITY = 80e9              # bytes of one card


def peak_flops(dtype) -> float:
    """The dense peak for products in ``dtype`` (a torch dtype or its
    name; integer and other types at the fp32 rate)."""
    return PEAK_FLOPS.get(dtype_name(dtype), PEAK_FLOPS["float32"])


def bound(nbytes: float, flops: float, dtype):
    """(ms, "bytes" | "operations"): the least time the card could take
    for work that moves ``nbytes`` and does ``flops`` at the peak of
    ``dtype``, whichever term is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops(dtype) * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


@dataclass
class Roofline:
    dot_flops: float                 # per rank: products and kernel sites
    elementwise_flops: float         # per rank
    hbm_bytes: float                 # per rank
    collective_bytes: float          # per rank, wire bytes
    chips: int
    model_flops: float = 0.0         # 6·N·D (analytic, useful work, GLOBAL)
    dtype: str = "bfloat16"          # the model's: the peak MFU is taken at
    dot_flops_by_dtype: Dict[str, float] = field(default_factory=dict)
    bytes_by_kind: Dict[str, float] = field(default_factory=dict)

    @property
    def compute_s(self) -> float:
        by = self.dot_flops_by_dtype or {self.dtype: self.dot_flops}
        return sum(f / peak_flops(d) for d, f in by.items()) \
            + self.elementwise_flops / PEAK_ELEMENTWISE

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / HBM_BYTES_PER_S

    @property
    def collective_s(self) -> float:
        return self.collective_bytes / LINK_BYTES_PER_S

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        """Roofline step time (max of terms: a perfectly overlapped
        model)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / counted product FLOPs: a remat and redundancy
        waste detector."""
        total = self.dot_flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def mfu(self) -> float:
        """Model FLOPs utilization at the roofline step time, against the
        peak of the model's dtype."""
        if not self.model_flops or not self.step_s:
            return 0.0
        return self.model_flops / (self.step_s * self.chips
                                   * peak_flops(self.dtype))

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.update(compute_s=self.compute_s, memory_s=self.memory_s,
                 collective_s=self.collective_s, dominant=self.dominant,
                 step_s=self.step_s,
                 useful_flops_ratio=self.useful_flops_ratio, mfu=self.mfu)
        return d


def from_records(records: Iterable, chips: int, model_flops: float = 0.0,
                 dtype: str = "bfloat16") -> Roofline:
    """The counterpart of the reference's ``from_hlo_text``: records are
    ``OpRecord``s or their dicts (a saved record file)."""
    t = totals(records)
    return Roofline(dot_flops=t.dot_flops,
                    elementwise_flops=t.elementwise_flops,
                    hbm_bytes=t.hbm_bytes,
                    collective_bytes=t.collective_bytes, chips=chips,
                    model_flops=model_flops, dtype=dtype,
                    dot_flops_by_dtype=dict(t.dot_flops_by_dtype),
                    bytes_by_kind=dict(t.bytes_by_kind))


def model_flops_for(cfg, shape) -> float:
    """6·N·D for training, 2·N·D for prefill, 2·N·batch for decode (one
    token a sequence), with N from ``count_flops_params``."""
    from repro_torch.models.model import count_flops_params
    n = count_flops_params(cfg, active_only=True)
    if shape.kind == "train":
        return 6.0 * n * shape.tokens
    if shape.kind == "prefill":
        return 2.0 * n * shape.tokens
    return 2.0 * n * shape.global_batch
