"""The port stands alone: no module of repro_torch (nor chip_smoke.py)
imports JAX or the reference package, and its entry points default to the
CUDA device and raise without one instead of carrying on on the CPU."""
import dataclasses
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import sharding as sh
from repro_torch.config import ShapeConfig, reduced_config
from repro_torch.kernels import ops
from repro_torch.launch import mesh as lm
from repro_torch.launch import steps
from repro_torch.models import model as TM
from repro_torch.train.serve_loop import ServeEngine

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"

_BANNED = [re.compile(r"^\s*(import|from)\s+jax\b"),
           re.compile(r"^\s*(import|from)\s+repro(\.|\s|$)"),
           re.compile(r"^\s*from\s+repro\s+import\b")]


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, prefix="repro_torch."))


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_importing_every_module_loads_no_jax():
    mods = _modules()
    for m in ("repro_torch.train.serve_loop", "repro_torch.kernels.isp_decode",
              "repro_torch.configs.gemma3_12b",
              "repro_torch.core.decode_attention",
              "repro_torch.kernels.isp_gather", "repro_torch.sharding",
              "repro_torch.launch.mesh", "repro_torch.launch.steps",
              "repro_torch.kernels.topk_similarity",
              "repro_torch.core.energy", "repro_torch.models.ssm",
              "repro_torch.configs.deepseek_v2_236b",
              "repro_torch.configs.hymba_1_5b",
              "repro_torch.configs.xlstm_125m",
              "repro_torch.optim.adamw", "repro_torch.optim.schedule",
              "repro_torch.checkpoint.checkpoint",
              "repro_torch.data.pipeline", "repro_torch.train.train_loop",
              "repro_torch.launch.train", "repro_torch.launch.elastic",
              "repro_torch.launch.dryrun", "repro_torch.analysis.op_trace",
              "repro_torch.analysis.roofline", "repro_torch.analysis.top_ops",
              "repro_torch.analysis.reanalyze"):
        assert m in mods, m
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m == 'jax' or m.startswith('jax.')\n"
            "             or m == 'repro' or m.startswith('repro.'))\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, env=_env(),
                   timeout=120)


def test_sources_import_neither_jax_nor_reference():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for f in files:
        for n, line in enumerate(f.read_text().splitlines(), 1):
            for pat in _BANNED:
                assert not pat.search(line), f"{f}:{n}: {line.strip()}"


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    cfg = dataclasses.replace(reduced_config("yi-9b"), dtype="float32")
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        TM.init_params(cfg, gen)
    with pytest.raises(RuntimeError, match="CUDA"):
        TM.init_caches(cfg, 2, 32)
    with pytest.raises(RuntimeError, match="CUDA"):
        TM.init_caches(cfg, 2, 32, per_slot=False)
    params = TM.init_params(cfg, gen, "cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(cfg, params)
    ServeEngine(cfg, params, device="cpu")
    gemma = dataclasses.replace(reduced_config("gemma3-12b"),
                                dtype="float32")
    gparams = TM.init_params(gemma, gen, "cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(gemma, gparams)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(gemma, gparams, kv_layout="strip")
    ServeEngine(gemma, gparams, device="cpu")


def test_mesh_and_step_builders_default_to_cuda():
    """The mesh helpers and the step builders default to CUDA and raise
    without it; asked for the CPU, a one-rank gloo mesh serves a prefill
    through the sharded step (the ISP lookup on the plain gather) with the
    unsharded path's tokens."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.make_local_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.make_debug_mesh(1, 1)
    cfg = dataclasses.replace(reduced_config("yi-9b"), dtype="float32")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 8))
    mesh = lm.make_local_mesh("cpu")
    try:
        recipe = sh.make_recipe(sh.make_plan(mesh, cfg), cfg,
                                ShapeConfig(8, 2))
        assert recipe.batch_axes == ("data",) and recipe.seq_axes == ()
        for build in (steps.build_prefill_step, steps.build_decode_step):
            with pytest.raises(RuntimeError, match="CUDA"):
                build(cfg, recipe)
        with pytest.raises(RuntimeError, match="CUDA"):
            steps.build_decode_block_step(cfg, recipe, k_steps=2, eos_id=None,
                                          max_len=16)
        step = steps.build_prefill_step(cfg, recipe, device="cpu")
        ops.reset_launch_counts()
        with torch.no_grad():
            nxt, _ = step(params, {"tokens": tokens.astype(np.int32)})
            want, _ = TM.prefill_fn(params, {"tokens": torch.from_numpy(
                tokens)}, cfg)
        assert nxt.tolist() == want.tolist()
        assert sum(ops.launch_counts().values()) == 0
    finally:
        lm.teardown()


def test_train_entry_points_default_to_cuda(tmp_path):
    """``train``, ``build_state``, ``build_train_step`` and the train CLI
    run on the card unless told otherwise, and raise without one; asked
    for the CPU, the CLI trains the reduced config."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    from repro_torch.data import DataConfig
    from repro_torch.launch import train as train_cli
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import train_loop
    cfg = dataclasses.replace(reduced_config("yi-9b"), dtype="float32")
    dcfg = DataConfig(seq_len=8, global_batch=2, vocab_size=cfg.vocab_size)
    tcfg = train_loop.TrainConfig(steps=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_loop.train(cfg, dcfg, tcfg)
    recipe = sh.make_recipe(sh.make_plan(None, cfg), cfg, ShapeConfig(8, 2))
    with pytest.raises(RuntimeError, match="CUDA"):
        train_loop.build_state(cfg, recipe, AdamWConfig(), 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        steps.build_train_step(cfg, recipe)
    argv = ["--arch", "yi-9b", "--smoke", "--steps", "1", "--global-batch",
            "2", "--seq-len", "8"]
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main(argv)
    assert train_cli.main(argv + ["--device", "cpu"]) == 0


def test_unported_options_raise(tmp_path):
    """Every engine option of the reference is ported now: what is left to
    raise is a layout no package has and a donor with other wiring."""
    cfg = dataclasses.replace(reduced_config("yi-9b"), dtype="float32")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError):
        ServeEngine(cfg, params, device="cpu", kv_layout="dense")
    donor = ServeEngine(cfg, params, device="cpu", chunk_prefill=8,
                        prewarm=True)
    with pytest.raises(ValueError, match="jit_donor"):
        ServeEngine(cfg, params, device="cpu", jit_donor=donor, k_block=1)


def test_chip_smoke_fails_without_a_card():
    """chip_smoke.py exits non-zero and prints no result where
    torch.cuda.is_available() is false."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                       cwd=ROOT, env=_env(), capture_output=True, text=True,
                       timeout=120)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
