"""The port's ServeEngine against the JAX ServeEngine on the same prompts
and weights (float32 smoke yi-9b, num_slots=2, page_size=8, max_len=64):
identical tokens, statuses, TransferLedger bytes and KV peaks, a balanced
free list, and submit <= admit <= first_token <= finish on every record —
for k_block 1 and 8, FIFO and EDF admission, refills, shedding and
cancellation."""
import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

from repro.config import reduced_config as j_reduced
from repro.models import model as JM
from repro.train.serve_loop import AdmissionController as JAdmission
from repro.train.serve_loop import ServeEngine as JEngine
from repro_torch.bridge import params_from_jax
from repro_torch.config import reduced_config as t_reduced
from repro_torch.train.serve_loop import AdmissionController as TAdmission
from repro_torch.train.serve_loop import ServeEngine as TEngine

MAX_LEN, NUM_SLOTS, PAGE = 64, 2, 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads; one thread keeps
    these tests from crowding timing-sensitive tests on other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(j_reduced("yi-9b"), dtype="float32")
    tcfg = dataclasses.replace(t_reduced("yi-9b"), dtype="float32")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    model = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    # one JAX engine per k_block donates its jitted callables to the rest
    # of the module's JAX engines, so each shape compiles once
    donors = {}
    return jcfg, tcfg, jp, model, donors


def _engines(setup, k_block, **kw):
    jcfg, tcfg, jp, model, donors = setup
    common = dict(max_len=MAX_LEN, num_slots=NUM_SLOTS, page_size=PAGE,
                  k_block=k_block, **kw)
    je = JEngine(jcfg, jp, jit_donor=donors.get(k_block),
                 admission=JAdmission(NUM_SLOTS, host_rate=3.0,
                                      csd_rate=1.0), **common)
    donors.setdefault(k_block, je)
    te = TEngine(tcfg, model, device="cpu",
                 admission=TAdmission(NUM_SLOTS, host_rate=3.0,
                                      csd_rate=1.0), **common)
    return je, te


def _compare(je, te, jres, tres):
    # tiers are left out: the admission controller refits its host:CSD
    # shares from measured wall-clock service times, in both packages
    key = lambda r: (r.rid, r.tokens, r.status, r.priority)
    assert [key(r) for r in tres] == [key(r) for r in jres]
    js, ts = je.stats, te.stats
    assert (ts.requests, ts.tokens, ts.decode_steps, ts.shed_requests) == \
        (js.requests, js.tokens, js.decode_steps, js.shed_requests)
    for name in ("ledger", "baseline"):
        a, b = getattr(ts, name), getattr(js, name)
        assert (a.link_bytes, a.kv_bytes) == (b.link_bytes, b.kv_bytes)
    for k in ("peak_kv_bytes", "dense_kv_bytes", "pool_kv_bytes",
              "live_kv_bytes"):
        assert te.kv_stats()[k] == je.kv_stats()[k]
    assert te.pager.peak_pages == je.pager.peak_pages
    te.pager.check_balanced()
    assert (te.page_table == -1).all()
    for rec in ts.latency.records:
        assert rec.submit_t <= rec.admit_t <= rec.first_token_t \
            <= rec.finish_t or rec.status == "shed"
        if rec.status == "ok":
            assert math.isfinite(rec.first_token_t)


def _serve(engine, prompts, max_news, **submit_kw):
    for i, (p, m) in enumerate(zip(prompts, max_news)):
        engine.submit(p, max_new=m, **{k: v[i] for k, v in submit_kw.items()})
    return engine.run_until_complete()


@pytest.mark.parametrize("k_block", [1, 8])
def test_fixed_prompts_match_jax(setup, rng, k_block):
    vocab = setup[1].vocab_size
    prompts = [rng.integers(0, vocab, n).tolist() for n in (5, 9, 13)]
    je, te = _engines(setup, k_block)
    jres = _serve(je, prompts, [3, 6, 4])
    tres = _serve(te, prompts, [3, 6, 4])
    _compare(je, te, jres, tres)


@pytest.mark.parametrize("k_block,seed", [(1, 11), (8, 11), (8, 12)])
def test_random_ragged_refills_match_jax(setup, k_block, seed):
    """More requests than slots, ragged prompt lengths and budgets: slots
    refill mid-decode, pages are freed and reused."""
    rng = np.random.default_rng(seed)
    vocab = setup[1].vocab_size
    n = int(rng.integers(5, 8))
    prompts = [rng.integers(0, vocab, int(rng.integers(2, 30))).tolist()
               for _ in range(n)]
    max_news = [int(rng.integers(1, 10)) for _ in range(n)]
    je, te = _engines(setup, k_block)
    _compare(je, te, _serve(je, prompts, max_news),
             _serve(te, prompts, max_news))


def test_edf_matches_jax_and_fifo(setup, rng):
    vocab = setup[1].vocab_size
    prompts = [rng.integers(0, vocab, n).tolist() for n in (6, 10, 4, 12)]
    deadlines = [8.0, 0.5, 4.0, 0.1]
    outs = {}
    for order in ("fifo", "edf"):
        je, te = _engines(setup, 8, admission_order=order, shed_expired=False)
        jres = _serve(je, prompts, [4, 3, 5, 2], deadline_s=deadlines)
        tres = _serve(te, prompts, [4, 3, 5, 2], deadline_s=deadlines)
        _compare(je, te, jres, tres)
        outs[order] = [r.tokens for r in tres]
    assert outs["edf"] == outs["fifo"]


def test_shed_expired_matches_jax(setup, rng):
    vocab = setup[1].vocab_size
    prompts = [rng.integers(0, vocab, n).tolist() for n in (7, 5, 9, 6)]
    deadlines = [-1.0, 1e9, -1.0, 1e9]
    je, te = _engines(setup, 8, admission_order="edf", shed_expired=True)
    jres = _serve(je, prompts, [3, 4, 2, 5], deadline_s=deadlines)
    tres = _serve(te, prompts, [3, 4, 2, 5], deadline_s=deadlines)
    _compare(je, te, jres, tres)
    assert [r.status for r in tres] == ["shed", "ok", "shed", "ok"]
    assert te.stats.latency.shed == 2


@pytest.mark.parametrize("k_block", [1, 8])
def test_cancel_matches_jax(setup, rng, k_block):
    """Cancel one in-flight and one queued request after the first tick;
    the survivors' tokens, ledgers and pages match the reference."""
    vocab = setup[1].vocab_size
    prompts = [rng.integers(0, vocab, n).tolist() for n in (8, 11, 5)]
    je, te = _engines(setup, k_block)
    wasted = {}
    for name, eng in (("jax", je), ("torch", te)):
        rids = [eng.submit(p, max_new=12) for p in prompts]
        eng.step()
        assert eng.cancel(rids[2]) == 0.0          # still queued
        wasted[name] = eng.cancel(rids[0])         # in flight
        assert eng.cancel(999) is None
    assert wasted["torch"] is not None and wasted["jax"] is not None
    _compare(je, te, je.run_until_complete(), te.run_until_complete())


def test_tick_observation_and_clock(setup, rng):
    """The per-tick observation and the serving clock behave as in the
    reference: admitted and first-token rids per tick, a clock that only
    moves forward, and advance_clock fast-forwarding idle gaps."""
    vocab = setup[1].vocab_size
    prompts = [rng.integers(0, vocab, n).tolist() for n in (4, 6, 9)]
    je, te = _engines(setup, 8)
    for eng in (je, te):
        for p in prompts:
            eng.submit(p, max_new=3)
    while je.queue or je.num_active:
        je.step()
        t_before = te.clock
        te.step()
        assert te.clock >= t_before
        for f in ("admitted_rids", "first_token_rids", "tokens", "steps",
                  "per_step_items"):
            assert getattr(te.last_tick, f) == getattr(je.last_tick, f)
    assert not (te.queue or te.num_active)
    te.advance_clock(te.clock + 5.0)
    t = te.clock
    te.advance_clock(0.0)
    assert te.clock == t


def test_serve_cli_runs_on_cpu(monkeypatch, capsys):
    """python -m repro_torch.launch.serve --smoke --device cpu serves its
    requests through the plain path and prints the stats summary."""
    from repro_torch.launch import serve
    monkeypatch.setattr("sys.argv", [
        "serve", "--arch", "yi-9b", "--smoke", "--requests", "3",
        "--max-new", "4", "--max-len", "48", "--num-slots", "2",
        "--device", "cpu"])
    assert serve.main() == 0
    out = capsys.readouterr().out
    assert "3 requests, 12 tokens" in out and "KV[paged]" in out
