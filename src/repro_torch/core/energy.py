"""Energy model: the paper's Table I.

Paper measurements (HPM-100A wall meter, AIC FB128-LX, 36 CSDs):
  idle (no drives)          167 W
  idle (36 CSDs)            405 W   -> 6.6 W per CSD
  load, ISP disabled        482 W
  load, all 36 ISP engines  492 W   -> 0.28 W marginal per active engine

Table I's energy-per-query is exactly P_load / throughput, which gives all
six published numbers (5021/1662, 832/327, 51/23 mJ).  A copy of the
Table I half of ``repro/core/energy.py``; its analytic accelerator model
is not copied (an H100 counterpart would be built from the card's own
power readings).
"""
from __future__ import annotations

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
