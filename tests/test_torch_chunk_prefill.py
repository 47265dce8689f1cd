"""Chunked prefill and prewarm in the port against the JAX package (float32
reduced yi-9b, weights carried over): the masked chunk attention within
1e-5 with pad rows and empty key rows, one chunk of ``prefill_chunk_fn``
(the same next token, the pools within 1e-5), and the engine's chunk
scenarios (the reference's decode-block and single-engine SLO scenarios)
giving the same tokens, statuses, ledger bytes and KV peaks as the
reference engine.  A prewarmed engine serves what a cold one serves, and
the reduced gemma3-12b turns chunking off as the reference does."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import reduced_config as j_reduced
from repro.kernels import ref as jref
from repro.models import model as JM
from repro.train.serve_loop import AdmissionController as JAdmission
from repro.train.serve_loop import ServeEngine as JEngine
from repro_torch.bridge import params_from_jax
from repro_torch.config import reduced_config as t_reduced
from repro_torch.kernels import ref as tref
from repro_torch.models import model as TM
from repro_torch.train.serve_loop import AdmissionController as TAdmission
from repro_torch.train.serve_loop import ServeEngine as TEngine

MAX_LEN, PAGE = 64, 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
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
    # one JAX engine per k_block lends its jitted callables to the rest
    return jcfg, tcfg, jp, model, {}


def _engines(setup, num_slots=2, k_block=8, **kw):
    jcfg, tcfg, jp, model, donors = setup
    common = dict(max_len=MAX_LEN, num_slots=num_slots, page_size=PAGE,
                  k_block=k_block)
    common.update(kw)
    je = JEngine(jcfg, jp, jit_donor=donors.get(k_block),
                 admission=JAdmission(num_slots, host_rate=3.0, csd_rate=1.0),
                 **common)
    donors.setdefault(k_block, je)
    te = TEngine(tcfg, model, device="cpu",
                 admission=TAdmission(num_slots, host_rate=3.0, csd_rate=1.0),
                 **common)
    return je, te


def _prompts(setup, rng, lens):
    return [rng.integers(0, setup[1].vocab_size, n).tolist() for n in lens]


def _compare(je, te, jres, tres):
    key = lambda r: (r.rid, r.tokens, r.status, r.priority)
    assert [key(r) for r in tres] == [key(r) for r in jres]
    js, ts = je.stats, te.stats
    assert (ts.requests, ts.tokens, ts.decode_steps, ts.shed_requests) == \
        (js.requests, js.tokens, js.decode_steps, js.shed_requests)
    for name in ("ledger", "baseline"):
        a, b = getattr(ts, name), getattr(js, name)
        assert (a.link_bytes, a.kv_bytes) == (b.link_bytes, b.kv_bytes)
    assert te.kv_stats() == je.kv_stats()
    assert te.pager.peak_pages == je.pager.peak_pages
    te.pager.check_balanced()
    assert (te.page_table == -1).all()
    for rec in ts.latency.records:
        assert rec.submit_t <= rec.admit_t <= rec.first_token_t \
            <= rec.finish_t or rec.status == "shed"


# -- the masked chunk attention and one chunk ---------------------------------


@pytest.mark.parametrize("dhv", [8, 6])
def test_chunk_attention_masked_matches_reference(dhv):
    """Pad query rows (qpos -1), a batch row with no cached key at all, and
    keys past the query (masked causally)."""
    rng = np.random.default_rng(dhv)
    B, C, S, H, Hkv, dh = 3, 6, 16, 4, 2, 8
    q = rng.standard_normal((B, C, H, dh)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, dh)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, dhv)).astype(np.float32)
    kpos = np.where(rng.random((B, S)) < 0.7, np.arange(S)[None], -1)
    kpos[1] = -1                                   # no key at all
    qpos = np.tile(np.arange(8, 8 + C), (B, 1))
    qpos[0, 4:] = -1                               # pad rows
    kpos, qpos = kpos.astype(np.int32), qpos.astype(np.int32)
    want = jref.chunk_attention_masked(*map(jnp.asarray,
                                            (q, k, v, kpos, qpos)))
    got = tref.chunk_attention_masked(*map(torch.from_numpy,
                                           (q, k, v, kpos, qpos)))
    assert got.shape == (B, C, H, dhv) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_prefill_chunk_fn_matches_reference(setup):
    """Two chunks of one slot's 13-token prompt (the second with pad
    rows): the same sampled tokens and the same pools."""
    jcfg, tcfg, jp, model, _ = setup
    n_pages = 4
    row = np.full((1, MAX_LEN // PAGE), -1, np.int32)
    row[0, :2] = [2, 0]                            # 13 rows in 2 pages
    jc = JM.init_caches(jcfg, 1, MAX_LEN, paged=True, page_size=PAGE,
                        num_pages=n_pages)
    jc = {g: dict(c, pages=jnp.broadcast_to(jnp.asarray(row)[None],
                                            c["pages"].shape))
          for g, c in jc.items()}
    tc = TM.init_caches(tcfg, 1, MAX_LEN, paged=True, page_size=PAGE,
                        num_pages=n_pages, device="cpu")
    tc = {g: dict(c, pages=torch.from_numpy(row)[None].expand(
        c["pages"].shape)) for g, c in tc.items()}
    prompt = np.random.default_rng(1).integers(0, tcfg.vocab_size, 13)
    for c0, real in ((0, 8), (8, 5)):
        tokens = np.zeros((1, 8), np.int32)
        tokens[0, :real] = prompt[c0:c0 + real]
        qpos = np.full((1, 8), -1, np.int32)
        qpos[0, :real] = np.arange(c0, c0 + real)
        last = np.asarray([real - 1], np.int32)
        jn, jc = JM.prefill_chunk_fn(jp, jc, jnp.asarray(tokens),
                                     jnp.asarray(qpos), jnp.asarray(last),
                                     jcfg)
        with torch.no_grad():
            tn, tc = TM.prefill_chunk_fn(model, tc, torch.from_numpy(tokens),
                                         torch.from_numpy(qpos),
                                         torch.from_numpy(last), tcfg)
        assert tn.tolist() == np.asarray(jn).tolist()
    for g in jc:
        for leaf in ("kp", "vp"):
            np.testing.assert_allclose(tc[g][leaf][:, :n_pages].numpy(),
                                       np.asarray(jc[g][leaf])[:, :n_pages],
                                       atol=1e-5, rtol=1e-5)


# -- the engine's chunk scenarios ----------------------------------------------


@pytest.mark.parametrize("k_block", [1, 8])
def test_chunked_engine_matches_reference(setup, k_block):
    rng = np.random.default_rng(k_block)
    prompts = _prompts(setup, rng, (5, 21, 40, 9, 30))
    je, te = _engines(setup, k_block=k_block, chunk_prefill=8)
    assert te.chunk_prefill == je.chunk_prefill == 8
    _compare(je, te, je.generate(prompts, max_new=6),
             te.generate(prompts, max_new=6))


def test_chunked_pool_equals_one_shot_and_reference(setup, rng):
    """After its three chunks a 21-token prompt holds the one-shot
    prefill's rows in the same pages (and the reference chunked engine's),
    within 1e-5, and samples the same first token."""
    prompt = _prompts(setup, rng, (21,))[0]
    je, chunked = _engines(setup, k_block=1, chunk_prefill=8)
    _, oneshot = _engines(setup, k_block=1)
    want = oneshot.generate([prompt], max_new=1)[0].tokens
    assert chunked.generate([prompt], max_new=1)[0].tokens == want
    assert je.generate([prompt], max_new=1)[0].tokens == want
    for eng in (je, chunked, oneshot):
        eng.submit(prompt, max_new=4)
        eng._admit()
    for _ in range(3):
        je._chunk_prefill_tick()
        chunked._chunk_prefill_tick()
    assert np.array_equal(oneshot.page_table, chunked.page_table)
    assert np.array_equal(je.page_table, chunked.page_table)
    pages = chunked.page_table[0, :3]

    def rows(pool):                                # the prompt's 21 rows
        pool = np.asarray(pool)[:, pages]
        return pool.reshape((pool.shape[0], -1) + pool.shape[3:])[:, :21]
    for g in chunked.caches:
        for leaf in ("kp", "vp"):
            got = rows(chunked.caches[g][leaf])
            np.testing.assert_allclose(got, rows(oneshot.caches[g][leaf]),
                                       atol=1e-5, rtol=1e-5)
            np.testing.assert_allclose(got, rows(je.caches[g][leaf]),
                                       atol=1e-5, rtol=1e-5)


def test_chunked_prefill_interleaves_decode(setup, rng):
    """A short request keeps decoding, and finishes, while a long prompt is
    still splicing chunk by chunk; both engines finish the same requests
    in the same ticks."""
    short, long_p = _prompts(setup, rng, (5, 48))
    je, te = _engines(setup, k_block=1, chunk_prefill=4)
    for eng in (je, te):
        eng.submit(short, max_new=3)
        eng.submit(long_p, max_new=2)
    finished = []
    while (te.num_active or te.pending) and not finished:
        finished = te.step()
        assert [r.tokens for r in je.step()] == [r.tokens for r in finished]
    assert finished and len(finished[0].tokens) == 3
    assert any(s.active and s.prefilling for s in te.slots)
    _compare(je, te, je.run_until_complete(), te.run_until_complete())


def test_chunk_prefill_gated_to_paged_full_attention(setup):
    """The strip layout and the sliding-window gemma3-12b fall back to
    one-shot prefill in both packages."""
    _, tcfg, _, model, _ = setup
    strip = TEngine(tcfg, model, device="cpu", max_len=MAX_LEN,
                    kv_layout="strip", chunk_prefill=8)
    assert strip.chunk_prefill is None
    g3 = dataclasses.replace(t_reduced("gemma3-12b"), dtype="float32")
    g3_model = TM.init_params(g3, torch.Generator().manual_seed(0), "cpu")
    eng = TEngine(g3, g3_model, device="cpu", max_len=MAX_LEN, num_slots=2,
                  chunk_prefill=8)
    assert eng.kv_layout == "paged" and eng.chunk_prefill is None
    jg3 = dataclasses.replace(j_reduced("gemma3-12b"), dtype="float32")
    jeng = JEngine(jg3, JM.init_params(jg3, jax.random.PRNGKey(0)),
                   max_len=MAX_LEN, num_slots=2, chunk_prefill=8)
    assert jeng.kv_layout == "paged" and jeng.chunk_prefill is None


@pytest.mark.parametrize("k_block", [1, 8])
def test_prewarm_is_token_identical_and_warms_every_site(setup, rng,
                                                         k_block):
    """A prewarmed engine serves the cold engine's (and the reference's)
    tokens, books its first calls in compile_s before the first request
    and none after, and leaves the caches, pager and stats as they were."""
    prompts = _prompts(setup, rng, (5, 12, 20))
    je, cold = _engines(setup, k_block=k_block, chunk_prefill=8)
    _, tcfg, _, model, _ = setup
    warm = TEngine(tcfg, model, device="cpu", max_len=MAX_LEN, num_slots=2,
                   page_size=PAGE, k_block=k_block, chunk_prefill=8,
                   prewarm=True,
                   admission=TAdmission(2, host_rate=3.0, csd_rate=1.0))
    assert warm.stats.compile_s > 0
    assert warm._warm_keys == {("prefill",), ("chunk",),
                               ("decode_block",) if k_block > 1
                               else ("decode",)}
    s = warm.stats
    assert (s.requests, s.tokens, s.decode_steps, s.prefill_s,
            s.decode_s, s.ledger.link_bytes) == (0, 0, 0, 0.0, 0.0, 0.0)
    assert warm.pager.num_in_use == 0 and (warm.page_table == -1).all()
    for g, c in warm.caches.items():           # only the scratch page moved
        assert not c["kp"][:, :-1].any() and not c["vp"][:, :-1].any()
    compile0 = warm.stats.compile_s
    for p in prompts:
        warm.submit(p, max_new=4)
    while warm.num_active or warm.pending:
        warm.step()
        assert warm.last_tick.compile_s == 0.0
    assert warm.stats.compile_s == compile0
    got = [r.tokens for r in warm.run_until_complete()]
    assert got == [r.tokens for r in cold.generate(prompts, max_new=4)]
    assert got == [r.tokens for r in je.generate(prompts, max_new=4)]


# -- the single-engine SLO scenarios -------------------------------------------


def _edf_prefers_earliest(eng, prompts):
    rids = [eng.submit(p, max_new=2, deadline_s=d)
            for p, d in zip(prompts[:3], (50.0, 50.0, 1.0))]
    eng.step()
    first = list(eng.last_tick.admitted_rids)
    eng.step()
    assert first == [rids[2]]
    assert eng.last_tick.admitted_rids == [rids[0]]   # FIFO within ties
    return eng.run_until_complete()


def _first_token_after_last_chunk(eng, prompts):
    rid = eng.submit(prompts[3], max_new=3)           # 24 = 3 chunks of 8
    ticks = 0
    while rid not in eng.last_tick.first_token_rids:
        assert ticks < 50
        eng.step()
        ticks += 1
    assert ticks >= 3
    res = eng.run_until_complete()
    assert res[0].ttft_s >= res[0].queue_wait_s
    return res


def _expired_queued_are_shed(eng, prompts):
    doomed = [eng.submit(p, max_new=2, deadline_s=-1.0)
              for p in prompts[:2]]
    eng.submit(prompts[2], max_new=2, deadline_s=1e9)
    res = eng.run_until_complete()
    assert [r.status for r in res if r.rid in doomed] == ["shed"] * 2
    assert eng.stats.latency.shed == 2 and eng.stats.latency.count == 1
    return res


def _mid_prefill_shed(eng, prompts):
    eng.generate([prompts[4]], max_new=2)             # warms the chunk site
    rid = eng.submit(prompts[3], max_new=2, deadline_s=eng.clock + 1e-12)
    res = eng.run_until_complete()
    shed = [r for r in res if r.rid == rid]
    assert len(shed) == 1 and shed[0].status == "shed"
    assert eng.stats.shed_wasted_s > 0.0 and shed[0].prefill_s > 0.0
    assert eng.num_active == 0
    return res


SCENARIOS = {
    "edf_prefers_earliest": (dict(num_slots=1, admission_order="edf",
                                  shed_expired=False),
                             _edf_prefers_earliest),
    "first_token_after_last_chunk": (dict(chunk_prefill=8),
                                     _first_token_after_last_chunk),
    "expired_queued_are_shed": (dict(admission_order="edf"),
                                _expired_queued_are_shed),
    "mid_prefill_shed": (dict(chunk_prefill=8), _mid_prefill_shed),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_slo_scenario_matches_reference(setup, name):
    kw, run = SCENARIOS[name]
    prompts = _prompts(setup, np.random.default_rng(5), (6, 6, 6, 24, 20))
    je, te = _engines(setup, **kw)
    _compare(je, te, run(je, prompts), run(te, prompts))


def test_chunk_budget_admits_long_prompts_faster(setup, rng):
    """chunk_budget=4 brings a 24-token prompt to its first token in fewer
    ticks than budget 1, tick for tick as the reference does."""
    prompt = _prompts(setup, rng, (24,))[0]
    ticks = {}
    for budget in (1, 4):
        je, te = _engines(setup, chunk_prefill=8, chunk_budget=budget)
        for eng in (je, te):
            rid = eng.submit(prompt, max_new=2)
            n = 0
            while rid not in eng.last_tick.first_token_rids and n < 50:
                eng.step()
                n += 1
            ticks.setdefault(budget, set()).add(n)
        _compare(je, te, je.run_until_complete(), te.run_until_complete())
    assert len(ticks[1]) == len(ticks[4]) == 1
    assert min(ticks[4]) < min(ticks[1])


def test_oversized_reservation_rejected_at_submit(setup, rng):
    _, te = _engines(setup, num_pages=2, page_size=16)
    prompt = _prompts(setup, rng, (20,))[0]
    with pytest.raises(ValueError, match="KV"):
        te.submit(prompt, max_new=44)              # needs 4 pages, has 2
    for bad in ([], list(range(MAX_LEN))):
        with pytest.raises(ValueError):
            te.submit(bad, max_new=4)
    assert te.pending == 0 and not te.records
    te.submit(prompt, max_new=4)
    assert te.pending == 1
    assert math.isnan(te.records[0].first_token_t)
