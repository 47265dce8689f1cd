"""Energy model: the paper's Table I.

Paper measurements (HPM-100A wall meter, AIC FB128-LX, 36 CSDs):
  idle (no drives)          167 W
  idle (36 CSDs)            405 W   -> 6.6 W per CSD
  load, ISP disabled        482 W
  load, all 36 ISP engines  492 W   -> 0.28 W marginal per active engine

Table I's energy-per-query is exactly P_load / throughput, which gives all
six published numbers (5021/1662, 832/327, 51/23 mJ).  A copy of the
Table I half of ``repro/core/energy.py``.

The accelerator half is the reference's step-energy model with the H100's
own constants: E = idle watts x step time + joules a FLOP x FLOPs + joules
a byte x HBM bytes (+ joules a link byte x wire bytes).  The reference
chose its constants for a TPU; these were fitted by least squares on the
card's energy counter (``chip_smoke.py``'s energy phase) over calibration
windows with known FLOPs and bytes: an idle window, a bf16 GEMM loop, a
device-to-device copy loop and a mix of the two.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

# --- paper's server constants ----------------------------------------------
SERVER_IDLE_W = 167.0
SERVER_IDLE_36CSD_W = 405.0
CSD_IDLE_W = (SERVER_IDLE_36CSD_W - SERVER_IDLE_W) / 36.0   # 6.61 W
LOAD_STORAGE_ONLY_W = 482.0
LOAD_ALL_ISP_W = 492.0
ISP_MARGINAL_W = (LOAD_ALL_ISP_W - LOAD_STORAGE_ONLY_W) / 36.0  # 0.28 W


def server_power(n_isp_active: int = 0) -> float:
    """Whole-server wall power under load with n active ISP engines."""
    return LOAD_STORAGE_ONLY_W + ISP_MARGINAL_W * n_isp_active


def energy_per_query_mj(throughput_qps: float, n_isp_active: int = 0) -> float:
    """Table I metric: wall power / throughput, in millijoules."""
    return server_power(n_isp_active) / max(throughput_qps, 1e-9) * 1e3


def energy_saving(host_only_qps: float, isp_qps: float, n_isp: int = 36) -> float:
    """Fractional energy-per-query saving of the ISP configuration."""
    e_host = energy_per_query_mj(host_only_qps, 0)
    e_isp = energy_per_query_mj(isp_qps, n_isp)
    return 1.0 - e_isp / e_host


# --- H100 step-energy model -------------------------------------------------
# Fitted by chip_smoke.py's energy phase (a whole run of
# ``python3 chip_smoke.py``; NVML's total-energy counter; E = P0 t + a F +
# b B by least squares over the four calibration windows, each predicted
# within 6%) on "NVIDIA H100 80GB HBM3, 700.00 W" (nvidia-smi's name and
# power limit).  P0 is the card idle with a CUDA context alive; a FLOP is
# charged the bf16 tensor-core GEMM's joules whatever its type, so work on
# the CUDA cores (fp32 products, elementwise) costs more than the model
# says.
CHIP_IDLE_W = 130.0346447013607
PJ_PER_FLOP = 0.8172144290109666
PJ_PER_HBM_BYTE = 94.517995198457
# Not fitted: on one card the only link traffic is the two-rank phase's
# gloo, which goes through the host, so no window moves a known number of
# NVLink bytes.  A four-card run could fit it; until then a step with wire
# bytes cannot be given a link term, and gpu_step_energy refuses it.
PJ_PER_LINK_BYTE: Optional[float] = None


@dataclass
class GpuStepEnergy:
    """One step's joules on one card, by term: the counterpart of the
    reference's ``TpuStepEnergy``."""
    compute_j: float
    hbm_j: float
    link_j: float
    idle_j: float

    @property
    def total_j(self) -> float:
        return self.compute_j + self.hbm_j + self.link_j + self.idle_j


def gpu_step_energy(dot_flops: float, hbm_bytes: float, link_bytes: float,
                    step_s: float, chips: int = 1) -> GpuStepEnergy:
    """Per-device energy for one step (multiply by chips for fleet energy),
    with the reference's arithmetic (``tpu_step_energy``) and the H100's
    constants.  Raises ValueError for link bytes while PJ_PER_LINK_BYTE is
    not fitted."""
    if link_bytes > 0 and PJ_PER_LINK_BYTE is None:
        raise ValueError("gpu_step_energy: the link term is not fitted on "
                         "this card (PJ_PER_LINK_BYTE is None); pass "
                         "link_bytes=0")
    return GpuStepEnergy(
        compute_j=dot_flops * PJ_PER_FLOP * 1e-12,
        hbm_j=hbm_bytes * PJ_PER_HBM_BYTE * 1e-12,
        link_j=link_bytes * (PJ_PER_LINK_BYTE or 0.0) * 1e-12,
        idle_j=CHIP_IDLE_W * step_s,
    )
