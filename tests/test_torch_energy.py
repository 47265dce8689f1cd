"""The card's step-energy model (repro_torch.core.energy's accelerator half)
against the reference's ``repro.core.energy.tpu_step_energy``, and the
least-squares fitter that ``chip_smoke.py``'s energy phase fits its
constants with.

The arithmetic is the reference's: with the reference's four constants in
place of the card's, every term agrees to rel 1e-12 (the same products in
the same order).  The card's constants are its own, fitted on the H100's
energy counter; the link constant is not fitted on one card and a step
with wire bytes is refused.  The fitter runs here on synthetic windows of
the calibration's shapes with 1% seeded noise on their joules: four
windows give three constants, each within 2% of the truth."""
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest

from repro.core import energy as j_energy
from repro_torch.core import energy as t_energy

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    """chip_smoke.py as a module (it builds and launches nothing when
    imported)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _steps(n, seed=0):
    rng = np.random.default_rng(seed)
    return [(float(rng.uniform(0, 2e15)), float(rng.uniform(0, 5e12)),
             float(rng.uniform(0, 1e11)), float(rng.uniform(1e-3, 10.0)),
             int(rng.integers(1, 9))) for _ in range(n)]


@pytest.mark.parametrize("i", range(20))
def test_step_energy_is_the_reference_arithmetic(monkeypatch, i):
    for name in ("CHIP_IDLE_W", "PJ_PER_FLOP", "PJ_PER_HBM_BYTE",
                 "PJ_PER_LINK_BYTE"):
        monkeypatch.setattr(t_energy, name, getattr(j_energy, name))
    flops, hbm, link, step_s, chips = _steps(20)[i]
    got = t_energy.gpu_step_energy(flops, hbm, link, step_s, chips)
    want = j_energy.tpu_step_energy(flops, hbm, link, step_s, chips)
    assert isinstance(got, t_energy.GpuStepEnergy)
    for field in ("compute_j", "hbm_j", "link_j", "idle_j", "total_j"):
        assert getattr(got, field) == pytest.approx(getattr(want, field),
                                                    rel=1e-12, abs=0.0)


def test_link_term_is_refused_until_fitted():
    assert t_energy.PJ_PER_LINK_BYTE is None
    with pytest.raises(ValueError, match="link"):
        t_energy.gpu_step_energy(1e12, 1e9, 1.0, 0.1)
    e = t_energy.gpu_step_energy(1e12, 1e9, 0, 0.1)
    assert e.link_j == 0.0 and e.total_j == pytest.approx(
        e.compute_j + e.hbm_j + e.idle_j, rel=1e-15)


def test_card_constants_are_fitted_not_the_tpus():
    """Three positive, finite constants of the card's own, none of them
    the reference's TPU figure."""
    for name in ("CHIP_IDLE_W", "PJ_PER_FLOP", "PJ_PER_HBM_BYTE"):
        v = getattr(t_energy, name)
        assert isinstance(v, float) and math.isfinite(v) and v > 0, name
        assert v != getattr(j_energy, name), name
    e = t_energy.gpu_step_energy(117.374e12, 1960.28e9, 0, 1.19)
    assert e.total_j > e.idle_j > 0


@pytest.mark.parametrize("seed", range(3))
def test_fitter_recovers_known_constants(seed):
    """Windows shaped as the energy phase's (idle, GEMM loop, copy loop,
    the two in turns; 2.5-2.7 s), their joules from known constants with
    1% seeded noise: the fit is within 2% of each constant."""
    cs = _chip_smoke()
    truth = (70.0, 0.85, 110.0)           # W, pJ a FLOP, pJ a byte
    rng = np.random.default_rng(seed)
    gemm_f, gemm_b = 2 * 8192 ** 3, 3 * 8192 ** 2 * 2
    copy_b = 2 * 4 * 10 ** 9
    shapes = ((2.5, 0.0, 0.0),
              (2.6, 1500 * gemm_f, 1500 * gemm_b),
              (2.5, 0.0, 900 * copy_b),
              (2.7, 600 * gemm_f, 600 * (gemm_b + copy_b)))
    windows = []
    for t, f, b in shapes:
        e = truth[0] * t + truth[1] * f * 1e-12 + truth[2] * b * 1e-12
        windows.append((t, f, b, e * (1 + rng.normal(0, 0.01))))
    got = cs.fit_energy(windows)
    for g, w in zip(got, truth):
        assert g == pytest.approx(w, rel=0.02)
    # and the prediction goes through gpu_step_energy's arithmetic
    for t, f, b, e in windows:
        assert cs.predict_j(got, f, b, t) == pytest.approx(e, rel=0.05)
