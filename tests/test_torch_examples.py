"""The port's example scripts (``examples_torch/``) against the
reference's (``examples/``) on the CPU, in this process (no subprocess):

  * the NLP-query scenario's [compute] (time left out), [cluster], [energy]
    and [transfer] lines string-equal to the reference script's for each
    of the three applications (the reference run through ``runpy`` under
    a patched ``sys.argv``);
  * with the reference's ``PRNGKey(0)`` weights carried over
    (``bridge.params_from_jax``), the engine section against
    ``benchmarks.fig5_throughput.run_engine`` and the ``data_local``
    cluster section against the reference's ``ClusterEngine`` at the same
    arguments: tokens, statuses, link-byte ledgers and KV peaks equal;
  * on the port alone: uneven drives all ok, the SLO run's conservation,
    the faults run's recovery (the fault-free tokens), and the trace file
    accepted by ``scripts/trace_report.py``'s ``load_trace``;
  * the quickstart's loss within 1e-5 of the reference's on the same
    weights and batch (reduced gemma3-12b in float32), with the same greedy
    tokens, and the script itself on the CPU;
  * the ISP demo at its full 65,536 x 512 table: its asserts hold and its
    transfer lines are the reference ledger's;
  * train_lm's config has the reference's parameter count (the script
    itself trains only on the card, in ``chip_smoke.py``);
  * every script's entry point defaults to CUDA and raises without it."""
import dataclasses
import importlib.util
import re
import runpy
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.fig5_throughput import run_engine
from repro.config import get_config as j_get_config
from repro.config import reduced_config as j_reduced
from repro.core.transfer import embedding_plans as j_embedding_plans
from repro.models import model as JM
from repro.train.cluster_loop import ClusterEngine as JCluster
from repro_torch.bridge import params_from_jax
from repro_torch.config import reduced_config as t_reduced
from repro_torch.models import model as TM

ROOT = Path(__file__).resolve().parents[1]
SCENARIO = ("[cluster]", "[energy]", "[transfer]")


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", ROOT / "examples_torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_reference(name, argv, monkeypatch):
    """Run ``examples/<name>.py`` as a script with ``argv``; the path it
    prepends to ``sys.path`` is undone after the test."""
    monkeypatch.setattr(sys, "argv", [f"{name}.py"] + argv)
    monkeypatch.setattr(sys, "path", list(sys.path))
    runpy.run_path(str(ROOT / "examples" / f"{name}.py"),
                   run_name="__main__")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scenario():
    return _load("serve_nlp_queries")


@pytest.fixture(scope="module")
def bridged():
    jcfg = dataclasses.replace(j_reduced("yi-9b"), dtype="float32")
    tcfg = dataclasses.replace(t_reduced("yi-9b"), dtype="float32")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    model = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jcfg, tcfg, jp, model


@pytest.fixture(scope="module")
def port_cluster(scenario, bridged):
    """The port's section-5 run on the bridged weights (its drives lend
    their wiring to the later sections, as in the script)."""
    _, tcfg, _, model = bridged
    return scenario.cluster_engine_section(tcfg, model, 2, "cpu")


def _scenario_lines(out: str):
    keep = [re.sub(r" in [0-9.]+s;", " in <t>s;", line)
            for line in out.splitlines()
            if line.startswith(SCENARIO + ("[compute]",))]
    assert len(keep) == 5, out
    return keep


@pytest.mark.parametrize("app", ["recommender", "sentiment",
                                 "speech_to_text"])
def test_scenario_lines_equal_the_reference(app, scenario, capsys,
                                            monkeypatch):
    argv = ["--no-engine", "--csds", "36", "--app", app]
    assert scenario.main(argv + ["--device", "cpu"]) == 0
    port = _scenario_lines(capsys.readouterr().out)
    _run_reference("serve_nlp_queries", argv, monkeypatch)
    assert port == _scenario_lines(capsys.readouterr().out)


def test_engine_section_equals_run_engine(scenario, bridged, capsys):
    _, tcfg, _, model = bridged
    res, st, kv = scenario.engine_section(tcfg, model, 16, "cpu")
    jres, jst, jkv, _ = run_engine(emit=lambda _: None, page_size=16)
    key = lambda r: (r.rid, r.tokens, r.status)  # noqa: E731
    assert [key(r) for r in res] == [key(r) for r in jres]
    assert len(res) == 8 and all(len(r.tokens) == 8 for r in res)
    assert (st.requests, st.tokens, st.decode_steps) == \
        (jst.requests, jst.tokens, jst.decode_steps)
    for name in ("ledger", "baseline"):
        a, b = getattr(st, name), getattr(jst, name)
        assert (a.link_bytes, a.kv_bytes) == (b.link_bytes, b.kv_bytes)
    for k in ("layout", "page_size", "peak_kv_bytes", "dense_kv_bytes",
              "pool_kv_bytes", "live_kv_bytes"):
        assert kv[k] == jkv[k], k
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1] == (
        f"[engine] paged KV: peak {jkv['peak_kv_bytes'] / 1e6:.3f} MB of a "
        f"{jkv['dense_kv_bytes'] / 1e6:.3f} MB dense worst case "
        f"(page_size=16)")


def test_cluster_section_equals_the_reference(bridged, port_cluster):
    jcfg, _, jp, _ = bridged
    clu, prompts, res = port_cluster
    jclu = JCluster(jcfg, jp, n_drives=2, routing="data_local", max_len=64,
                    num_slots=2)
    rng = np.random.default_rng(0)
    want_prompts = [rng.integers(0, jcfg.vocab_size,
                                 rng.integers(4, 17)).tolist()
                    for _ in range(8)]
    shard_ids = rng.integers(0, 2, 8).tolist()
    assert prompts == want_prompts
    jres = jclu.generate(want_prompts, max_new=6, shard_ids=shard_ids)
    key = lambda r: (r.rid, r.tokens, r.status, r.drive)  # noqa: E731
    assert [key(r) for r in res] == [key(r) for r in jres]
    st, js = clu.stats, jclu.stats
    assert (st.completed, st.tokens, st.remote_requests) == \
        (js.completed, js.tokens, js.remote_requests)
    assert (st.link_bytes, st.spill_bytes) == (js.link_bytes, js.spill_bytes)
    assert [d.ledger.link_bytes for d in st.drives] == \
        [d.ledger.link_bytes for d in js.drives]
    assert clu.kv_stats() == jclu.kv_stats()


def test_later_sections_on_the_port(scenario, bridged, port_cluster,
                                    tmp_path, monkeypatch):
    """Uneven drives, the SLO run, faults and telemetry on the port: every
    request accounted for, the crashed drive's work recovered with the
    fault-free tokens, and a trace that loads."""
    _, tcfg, _, model = bridged
    clu, prompts, res = port_cluster
    free = {tuple(p): r.tokens for p, r in zip(prompts, res)}
    het = scenario.hetero_section(tcfg, model, clu, prompts, 2, "cpu")
    assert het.stats.completed == len(prompts)

    slo, report = scenario.slo_section(tcfg, model, clu, "cpu")
    assert report.submitted == 24 == len(report.results)
    assert report.submitted == report.completed + report.shed + \
        report.failed
    assert report.failed == 0 and report.completed > 0
    assert all(r.status in ("ok", "shed") for r in report.results)

    chaos, results = scenario.faults_section(tcfg, model, clu, prompts,
                                             "cpu")
    st = chaos.stats
    assert len(results) == 6 and all(r.status == "ok" for r in results)
    assert [r.tokens for r in results] == [free[tuple(p)]
                                           for p in prompts[:6]]
    assert st.faults_injected == 2 and st.auto_failed_drives == 1
    assert list(st.health) == ["healthy", "dead"]

    monkeypatch.chdir(tmp_path)
    hub = scenario.telemetry_section(tcfg, model, clu, prompts, "cpu")
    path = tmp_path / "serve_trace.json"
    assert path.exists()
    load_trace = runpy.run_path(str(ROOT / "scripts" / "trace_report.py"))[
        "load_trace"]
    events = load_trace(str(path))
    assert len(events) > 0
    assert hub.metrics()["open_spans"] == 0
    assert hub.metrics()["counters"].get("spans.ok") == 6


def test_quickstart_equals_the_reference(capsys):
    """The quickstart's steps 2-3 on reduced gemma3-12b in float32 with the
    reference's weights: the loss within 1e-5 of the reference's (each of
    its 64 cross-entropy terms summed in another order, a few fp32 ulps of
    30), the same greedy tokens.  The script's own bfloat16 config rounds
    every activation to 8 bits, which moves this loss by about 4e-3, so
    there it runs end to end (``main``) on the port's own weights.  The
    reference's calls are jitted here (the script calls them eagerly)."""
    qs = _load("quickstart")
    jcfg = dataclasses.replace(j_reduced("gemma3-12b"), dtype="float32")
    tcfg = dataclasses.replace(t_reduced("gemma3-12b"), dtype="float32")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    model = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    loss, tokens = qs.run(tcfg, model, "cpu")

    # the reference script's steps 2-3 on the same weights
    rng = np.random.default_rng(0)
    batch = {
        "tokens": jnp.asarray(rng.integers(0, jcfg.vocab_size, (2, 32)),
                              jnp.int32),
        "labels": jnp.asarray(rng.integers(0, jcfg.vocab_size, (2, 32)),
                              jnp.int32),
    }
    want_loss, _ = jax.jit(JM.loss_fn, static_argnums=2)(jp, batch, jcfg)
    nxt, _ = jax.jit(JM.prefill_fn, static_argnums=2)(
        jp, {"tokens": batch["tokens"]}, jcfg)
    caches = JM.init_caches(jcfg, batch=2, max_len=48)
    decode = jax.jit(JM.decode_fn, static_argnums=4)
    tok = batch["tokens"][:, :1]
    for t in range(5):
        nxt, caches = decode(jp, caches, tok, jnp.int32(t), jcfg)
        tok = nxt[:, None].astype(jnp.int32)
    assert abs(loss - float(want_loss)) <= 1e-5, (loss, float(want_loss))
    assert tokens == [int(x) for x in np.asarray(nxt)]

    capsys.readouterr()
    assert qs.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    full = j_get_config("gemma3-12b")
    small = j_reduced("gemma3-12b")
    assert small.dtype == "bfloat16"
    assert f"{small.name}: {small.num_layers}L d={small.d_model} " \
        f"pattern={small.block_pattern} params=" \
        f"{JM.count_params(small):,}" in out
    loss_line = [x for x in out if x.startswith("initial loss: ")]
    assert len(loss_line) == 1 and np.isfinite(float(loss_line[0][14:]))
    assert f"production cell: {full.name} × train_4k = 1,048,576 " \
        f"tokens/step, {JM.count_params(full):,} params" in out
    assert out[-1] == ("dry-run: PYTHONPATH=src python -m "
                       "repro_torch.launch.dryrun --arch gemma3-12b --shape "
                       "train_4k --mesh multipod")


def test_isp_demo_full_size(capsys):
    """The ISP demo at its full size: its two asserts (16 shard gathers
    summing to the dense lookup, 16 shard pools to the dense pool) hold,
    and its transfer lines are the reference ledger's."""
    demo = _load("isp_embedding_demo")
    assert (demo.V, demo.D, demo.TP, demo.N_LOOKUPS) == (65_536, 512, 16,
                                                         8_192)
    assert demo.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    base, isp = j_embedding_plans(8_192, 65_536, 512, tp=16)
    assert out == [
        "[isp] 8192 lookups over 16 shards: exact match with dense",
        f"[transfer] baseline (ship table): {base.total_moved/1e6:.1f} MB "
        f"on the link",
        f"[transfer] ISP (ship indexes):    {isp.total_moved/1e6:.1f} MB on "
        f"the link",
        f"[transfer] reduction: {isp.reduction_vs(base):.0%} — the paper's "
        f"'data never leaves the drive', applied to a 65k-row table",
        "[pool] fused gather+pool returns 0.5 MB instead of 16.8 MB of rows "
        "— RecSSD offload, on-shard"]


def test_train_lm_config_counts_the_reference():
    tlm = _load("train_lm")
    cfg = tlm.demo_config()
    want = dataclasses.replace(
        j_get_config("xlstm-125m"), name="xlstm-60m-demo", d_model=384,
        num_heads=4, num_layers=8, block_pattern=("mlstm", "slstm"),
        scan_group=0, remat="none")
    assert cfg.name == want.name
    assert TM.count_params(cfg) == JM.count_params(want) == 34_494_368


@pytest.mark.parametrize("name,argv", [
    ("serve_nlp_queries", ["--no-engine"]), ("quickstart", []),
    ("isp_embedding_demo", []), ("train_lm", ["--steps", "1"])])
def test_examples_default_to_cuda(name, argv, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    mod = _load(name)
    if name == "train_lm":
        argv = argv + ["--ckpt-dir", str(tmp_path / "ckpt")]
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main(argv)
    assert not (tmp_path / "ckpt").exists()
