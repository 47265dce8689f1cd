"""The port's open-loop workload module against the JAX package's: the
same trace field by field for each arrival mode and seed, the same time
scaling, traces that round-trip through either package's files, and an
open-loop replay on the port's engine that serves the reference engine's
tokens for every request."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.config import reduced_config as j_reduced
from repro.data import workload as jw
from repro.models import model as JM
from repro.train.serve_loop import ServeEngine as JEngine
from repro_torch.bridge import params_from_jax
from repro_torch.config import reduced_config as t_reduced
from repro_torch.data import workload as tw
from repro_torch.train.serve_loop import ServeEngine as TEngine


def _fields(trace):
    return [dataclasses.astuple(r) for r in trace]


def _cfgs(**kw):
    base = dict(n_requests=48, vocab_size=1000, seed=3)
    base.update(kw)
    jc = jw.WorkloadConfig(**base)
    tc = tw.WorkloadConfig(**{**base, "classes": tuple(
        tw.PriorityClass(**dataclasses.asdict(c)) for c in jc.classes)})
    return jc, tc


@pytest.mark.parametrize("mode", tw.ARRIVAL_MODES)
def test_generate_trace_matches_reference(mode):
    assert tw.ARRIVAL_MODES == jw.ARRIVAL_MODES
    for seed in (0, 7):
        jc, tc = _cfgs(arrival=mode, seed=seed, rate=6.0)
        assert _fields(tw.generate_trace(tc)) == \
            _fields(jw.generate_trace(jc))


def test_scale_trace_and_files_match_reference(tmp_path):
    jc, tc = _cfgs(arrival="bursty", n_requests=16)
    trace = tw.generate_trace(tc)
    assert _fields(tw.scale_trace(trace, 0.25)) == \
        _fields(jw.scale_trace(jw.generate_trace(jc), 0.25))
    mine, theirs = tmp_path / "port.jsonl", tmp_path / "ref.jsonl"
    tw.save_trace(str(mine), trace)
    jw.save_trace(str(theirs), jw.generate_trace(jc))
    assert tw.load_trace(str(mine)) == trace
    assert _fields(tw.load_trace(str(theirs))) == _fields(trace)
    assert _fields(jw.load_trace(str(mine))) == _fields(trace)


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(j_reduced("yi-9b"), dtype="float32")
    tcfg = dataclasses.replace(t_reduced("yi-9b"), dtype="float32")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    model = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jcfg, tcfg, jp, model, {}


@pytest.mark.parametrize("order", ["fifo", "edf"])
def test_replay_open_loop_serves_reference_tokens(setup, order):
    """Arrival times land on each engine's own measured clock, so which
    requests share a tick may differ; every request's tokens may not."""
    jcfg, tcfg, jp, model, donors = setup
    cls = tw.PriorityClass("only", priority=0, weight=1.0, slo_s=30.0,
                           prompt_range=(4, 20), max_new_range=(2, 6))
    wl = tw.WorkloadConfig(n_requests=8, vocab_size=tcfg.vocab_size,
                           arrival="bursty", rate=200.0, classes=(cls,),
                           seed=1)
    trace = tw.generate_trace(wl)
    kw = dict(max_len=64, num_slots=2, page_size=8, chunk_prefill=8,
              admission_order=order, shed_expired=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got = tw.replay_open_loop(TEngine(tcfg, model, device="cpu", **kw),
                                  trace)
    finally:
        torch.set_num_threads(n)
    jeng = JEngine(jcfg, jp, jit_donor=donors.get("engine"), **kw)
    donors.setdefault("engine", jeng)
    want = jw.replay_open_loop(jeng, [jw.TraceRequest(*dataclasses.astuple(r))
                                      for r in trace])
    assert got.submitted == want.submitted == len(trace) == len(got.results)
    assert [(r.rid, r.tokens, r.status) for r in got.results] == \
        [(r.rid, r.tokens, r.status) for r in want.results]
    assert got.wall_s > 0.0
