"""The port's ServeEngine against the JAX ServeEngine on the same prompts
and weights (float32 smoke models, num_slots=2, page_size=8, max_len=64):
identical tokens, statuses, TransferLedger bytes and KV peaks, a balanced
free list, and submit <= admit <= first_token <= finish on every record —
for k_block 1 and 8, FIFO and EDF admission, refills, shedding and
cancellation.  yi-9b runs every scenario on the paged layout; the strip
layout (yi-9b) and the sliding-window model (gemma3-12b: window rings of
32 rows beside a paged global layer, prompts past the window) rerun the
fixed-prompt, refill, EDF and cancel scenarios.  In the port alone, the
strip layout gives the paged layout's tokens."""
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


def _make_setup(arch):
    jcfg = dataclasses.replace(j_reduced(arch), dtype="float32")
    tcfg = dataclasses.replace(t_reduced(arch), dtype="float32")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    model = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    # one JAX engine per (k_block, layout) donates its jitted callables to
    # the rest of the module's JAX engines, so each shape compiles once
    donors = {}
    return jcfg, tcfg, jp, model, donors


@pytest.fixture(scope="module")
def setup():
    return _make_setup("yi-9b")


@pytest.fixture(scope="module")
def arch_setup(setup):
    made = {"yi-9b": setup}

    def get(arch):
        if arch not in made:
            made[arch] = _make_setup(arch)
        return made[arch]
    return get


def _engines(setup, k_block, **kw):
    jcfg, tcfg, jp, model, donors = setup
    common = dict(max_len=MAX_LEN, num_slots=NUM_SLOTS, page_size=PAGE,
                  k_block=k_block, **kw)
    key = (k_block, kw.get("kv_layout", "paged"))
    je = JEngine(jcfg, jp, jit_donor=donors.get(key),
                 admission=JAdmission(NUM_SLOTS, host_rate=3.0,
                                      csd_rate=1.0), **common)
    donors.setdefault(key, je)
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
    for k in ("layout", "peak_kv_bytes", "dense_kv_bytes", "pool_kv_bytes",
              "live_kv_bytes"):
        assert te.kv_stats()[k] == je.kv_stats()[k]
    if te.kv_layout == "paged":
        assert te.pager.peak_pages == je.pager.peak_pages
        te.pager.check_balanced()
        assert (te.page_table == -1).all()
    else:
        assert te.pager is None and je.pager is None
    for rec in ts.latency.records:
        assert rec.submit_t <= rec.admit_t <= rec.first_token_t \
            <= rec.finish_t or rec.status == "shed"
        if rec.status == "ok":
            assert math.isfinite(rec.first_token_t)


def _serve(engine, prompts, max_news, **submit_kw):
    for i, (p, m) in enumerate(zip(prompts, max_news)):
        engine.submit(p, max_new=m, **{k: v[i] for k, v in submit_kw.items()})
    return engine.run_until_complete()


# prompt lengths per model: gemma3's reach past its 32-row window (each
# then prefills in its own exact-length bucket, and its ring wraps)
FIXED = {"yi-9b": ((5, 9, 13), (3, 6, 4)),
         "gemma3-12b": ((5, 40, 50), (3, 6, 10))}
RAGGED_HI = {"yi-9b": 30, "gemma3-12b": 56}
EDF_LENS = {"yi-9b": (6, 10, 4, 12), "gemma3-12b": (6, 45, 4, 36)}
CANCEL_LENS = {"yi-9b": (8, 11, 5), "gemma3-12b": (38, 11, 5)}
# the strip layout (yi-9b) and the sliding-window model (gemma3-12b)
CASES = [("yi-9b", "strip"), ("gemma3-12b", "paged")]


def _fixed_prompts(setup, rng, k_block, arch="yi-9b", **kw):
    vocab = setup[1].vocab_size
    lens, max_news = FIXED[arch]
    prompts = [rng.integers(0, vocab, n).tolist() for n in lens]
    je, te = _engines(setup, k_block, **kw)
    jres = _serve(je, prompts, max_news)
    tres = _serve(te, prompts, max_news)
    _compare(je, te, jres, tres)
    return tres


def _ragged_refills(setup, k_block, seed, arch="yi-9b", **kw):
    rng = np.random.default_rng(seed)
    vocab = setup[1].vocab_size
    n = int(rng.integers(5, 8))
    prompts = [rng.integers(0, vocab,
                            int(rng.integers(2, RAGGED_HI[arch]))).tolist()
               for _ in range(n)]
    max_news = [int(rng.integers(1, 10)) for _ in range(n)]
    je, te = _engines(setup, k_block, **kw)
    _compare(je, te, _serve(je, prompts, max_news),
             _serve(te, prompts, max_news))


def _edf_and_fifo(setup, rng, arch="yi-9b", **kw):
    vocab = setup[1].vocab_size
    prompts = [rng.integers(0, vocab, n).tolist() for n in EDF_LENS[arch]]
    deadlines = [8.0, 0.5, 4.0, 0.1]
    outs = {}
    for order in ("fifo", "edf"):
        je, te = _engines(setup, 8, admission_order=order, shed_expired=False,
                          **kw)
        jres = _serve(je, prompts, [4, 3, 5, 2], deadline_s=deadlines)
        tres = _serve(te, prompts, [4, 3, 5, 2], deadline_s=deadlines)
        _compare(je, te, jres, tres)
        outs[order] = [r.tokens for r in tres]
    assert outs["edf"] == outs["fifo"]


def _cancel(setup, rng, k_block, arch="yi-9b", **kw):
    vocab = setup[1].vocab_size
    prompts = [rng.integers(0, vocab, n).tolist() for n in CANCEL_LENS[arch]]
    je, te = _engines(setup, k_block, **kw)
    wasted = {}
    for name, eng in (("jax", je), ("torch", te)):
        rids = [eng.submit(p, max_new=12) for p in prompts]
        eng.step()
        assert eng.cancel(rids[2]) == 0.0          # still queued
        wasted[name] = eng.cancel(rids[0])         # in flight
        assert eng.cancel(999) is None
    assert wasted["torch"] is not None and wasted["jax"] is not None
    _compare(je, te, je.run_until_complete(), te.run_until_complete())


@pytest.mark.parametrize("k_block", [1, 8])
def test_fixed_prompts_match_jax(setup, rng, k_block):
    _fixed_prompts(setup, rng, k_block)


@pytest.mark.parametrize("k_block,seed", [(1, 11), (8, 11), (8, 12)])
def test_random_ragged_refills_match_jax(setup, k_block, seed):
    """More requests than slots, ragged prompt lengths and budgets: slots
    refill mid-decode, pages are freed and reused."""
    _ragged_refills(setup, k_block, seed)


def test_edf_matches_jax_and_fifo(setup, rng):
    _edf_and_fifo(setup, rng)


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
    _cancel(setup, rng, k_block)


@pytest.mark.parametrize("k_block", [1, 8])
@pytest.mark.parametrize("arch,layout", CASES)
def test_strip_and_window_fixed_prompts_match_jax(arch_setup, rng, arch,
                                                  layout, k_block):
    _fixed_prompts(arch_setup(arch), rng, k_block, arch, kv_layout=layout)


@pytest.mark.parametrize("k_block,seed", [(1, 11), (8, 12)])
@pytest.mark.parametrize("arch,layout", CASES)
def test_strip_and_window_ragged_refills_match_jax(arch_setup, arch, layout,
                                                   k_block, seed):
    _ragged_refills(arch_setup(arch), k_block, seed, arch, kv_layout=layout)


@pytest.mark.parametrize("arch,layout", CASES)
def test_strip_and_window_edf_matches_jax_and_fifo(arch_setup, rng, arch,
                                                   layout):
    _edf_and_fifo(arch_setup(arch), rng, arch, kv_layout=layout)


@pytest.mark.parametrize("arch,layout", CASES)
def test_strip_and_window_cancel_matches_jax(arch_setup, rng, arch, layout):
    _cancel(arch_setup(arch), rng, 8, arch, kv_layout=layout)


@pytest.mark.parametrize("arch", ["yi-9b", "gemma3-12b"])
def test_port_strip_matches_paged(arch_setup, arch):
    """In the port alone: the same requests on the strip layout and on the
    paged layout give identical tokens and link bytes; the strip layout
    walks the dense strips every step, the paged one only live pages."""
    _, tcfg, _, model, _ = arch_setup(arch)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, tcfg.vocab_size,
                            int(rng.integers(2, RAGGED_HI[arch]))).tolist()
               for _ in range(5)]
    max_news = [int(rng.integers(1, 10)) for _ in range(5)]
    out = {}
    for layout in ("paged", "strip"):
        te = TEngine(tcfg, model, device="cpu", max_len=MAX_LEN,
                     num_slots=NUM_SLOTS, page_size=PAGE, k_block=8,
                     kv_layout=layout,
                     admission=TAdmission(NUM_SLOTS, host_rate=3.0,
                                          csd_rate=1.0))
        res = _serve(te, prompts, max_news)
        assert all(r.status == "ok" for r in res)
        out[layout] = ([r.tokens for r in res], te.stats)
    assert out["strip"][0] == out["paged"][0]
    paged, strip = out["paged"][1], out["strip"][1]
    assert strip.ledger.link_bytes == paged.ledger.link_bytes
    assert strip.ledger.kv_bytes == strip.baseline.kv_bytes \
        > paged.ledger.kv_bytes


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
