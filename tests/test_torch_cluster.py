"""The port's multi-drive cluster against the single-engine oracle and the
JAX package's cluster (float32 reduced yi-9b, weights carried over): the
same tokens, statuses, drives and spill ledgers under every routing
policy, drain and fail, tick-based fault schedules with conservation, a
failure in the middle of a chunked prefill that leaks no page, a pool
clamp that backpressures and lifts, and the donor's wiring check.  One
test runs the drives on worker threads (generous timeouts; it asserts
tokens, conservation and a clean join only), and a telemetry hub changes
no token of the engine or the cluster.  Faults are timed on the tick
basis only, and nothing asserts on wall-clock time."""
import dataclasses
import math
import threading

import jax
import numpy as np
import pytest
import torch

from repro.config import reduced_config as j_reduced
from repro.core.faults import FailureDetector as JDetector
from repro.core.faults import FaultSchedule as JFaults
from repro.models import model as JM
from repro.train.cluster_loop import ClusterEngine as JCluster
from repro.train.serve_loop import ServeEngine as JEngine
from repro_torch.bridge import params_from_jax
from repro_torch.config import reduced_config as t_reduced
from repro_torch.core.faults import DEAD, HEALTHY, FailureDetector, \
    FaultSchedule
from repro_torch.core.runtime import HeartbeatWatchdog
from repro_torch.core.telemetry import TelemetryHub
from repro_torch.train.cluster_loop import ClusterEngine
from repro_torch.train.serve_loop import ServeEngine

MAX_LEN = 64


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
    return jcfg, tcfg, jp, model


@pytest.fixture(scope="module")
def donors(setup):
    """The single engines per k_block: the port's are the oracles and the
    port clusters' donors, the reference's lend their jitted callables."""
    jcfg, tcfg, jp, model = setup
    kw = dict(max_len=MAX_LEN, num_slots=2)
    return {k: (JEngine(jcfg, jp, k_block=k, **kw),
                ServeEngine(tcfg, model, device="cpu", k_block=k, **kw))
            for k in (1, 8)}


@pytest.fixture(scope="module")
def trace(setup):
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, setup[1].vocab_size, n).tolist()
               for n in (5, 11, 7, 20, 9, 6)]
    return prompts, [1, 0, 1, 1, 0, 1]


def _pair(setup, donors, k_block=8, **kw):
    """A port cluster and a reference cluster with the same arguments."""
    jcfg, tcfg, jp, model = setup
    kw.setdefault("max_len", MAX_LEN)
    kw.setdefault("num_slots", 2)
    jkw = dict(kw)
    for name, conv in (("faults", JFaults.from_spec),
                       ("detector", lambda d: JDetector(**d))):
        if name in kw:
            jkw[name] = conv(kw[name])
    if "faults" in kw:
        kw["faults"] = FaultSchedule.from_spec(kw["faults"])
    if "detector" in kw:
        kw["detector"] = FailureDetector(**kw["detector"])
    jref, tref = donors[k_block]
    return (ClusterEngine(tcfg, model, jit_donor=tref, k_block=k_block,
                          device="cpu", **kw),
            JCluster(jcfg, jp, jit_donor=jref, k_block=k_block, **jkw))


def _oracle(donors, prompts, max_new, k_block=8):
    return [r.tokens for r in donors[k_block][1].generate(prompts, max_new)]


def _conserved_and_balanced(clu, res, n_submitted):
    statuses = [r.status for r in res]
    assert n_submitted == sum(statuses.count(s)
                              for s in ("ok", "shed", "failed"))
    for d in clu.drives:
        if d.failed or not d.has_work:
            assert d.engine.pager.num_in_use == 0
            d.engine.pager.check_balanced()


def _key(res):
    return [(r.rid, r.tokens, r.status) for r in res]


@pytest.mark.parametrize("routing", ["round_robin", "least_loaded",
                                     "data_local"])
def test_cluster_matches_oracle_and_reference(setup, donors, trace, routing):
    prompts, shards = trace
    want = _oracle(donors, prompts, 4)
    clu, jclu = _pair(setup, donors, n_drives=2, routing=routing,
                      chunk_prefill=8)
    res = clu.generate(prompts, max_new=4, shard_ids=shards)
    jres = jclu.generate(prompts, max_new=4, shard_ids=shards)
    assert [r.tokens for r in res] == want
    assert _key(res) == _key(jres)
    assert [r.drive for r in res] == [r.drive for r in jres]
    st, js = clu.stats, jclu.stats
    assert (st.completed, st.tokens, st.remote_requests) == \
        (js.completed, js.tokens, js.remote_requests)
    assert st.spill_bytes == js.spill_bytes
    assert st.link_bytes == js.link_bytes
    # the merged ledger is the drives' ledgers plus the spill ledger
    assert st.link_bytes == pytest.approx(
        sum(d.ledger.link_bytes for d in st.drives) + st.spill_bytes)
    assert clu.kv_stats() == jclu.kv_stats()
    _conserved_and_balanced(clu, res, len(prompts))
    assert st.energy_per_query_mj > 0.0


@pytest.mark.parametrize("action", ["drain", "fail"])
def test_drain_and_fail_replay_oracle_tokens(setup, donors, trace, action):
    """k_block=1 drives decode one token a tick, so the event lands
    mid-flight; requeued and restarted requests reproduce the oracle."""
    prompts = trace[0][:4]
    want = _oracle(donors, prompts, 6, k_block=1)
    clu, jclu = _pair(setup, donors, k_block=1, n_drives=2,
                      routing="round_robin", retry_backoff_s=0.0)
    moved = []
    for c in (clu, jclu):
        for p in prompts:
            c.submit(p, max_new=6)
        c.step()
        c.step()
        moved.append(getattr(c, action)(1))
    assert moved[0] == moved[1]
    assert moved[0] > 0 or action == "drain"
    res, jres = clu.run_until_complete(), jclu.run_until_complete()
    assert [r.tokens for r in res] == want
    assert _key(res) == _key(jres)
    assert clu.stats.drives[1].ledger.link_bytes > 0
    _conserved_and_balanced(clu, res, len(prompts))


FAULTS = {
    "crash": [{"drive_id": 1, "kind": "crash", "at_tick": 3}],
    "stall": [{"drive_id": 1, "kind": "stall", "at_tick": 2,
               "duration": 3}],
    "slowdown_and_clamp": [
        {"drive_id": 0, "kind": "slowdown", "at_tick": 1, "duration": 3,
         "factor": 2.0},
        {"drive_id": 1, "kind": "page_pool_clamp", "at_tick": 0,
         "duration": 5, "factor": 0.0}],
}


@pytest.mark.parametrize("name", sorted(FAULTS))
def test_tick_fault_schedule_conserves_and_replays(setup, donors, trace,
                                                   name):
    prompts = trace[0][:5]
    want = _oracle(donors, prompts, 6, k_block=1)
    clu, jclu = _pair(setup, donors, k_block=1, n_drives=2,
                      routing="round_robin", faults=FAULTS[name],
                      detector=dict(n_drives=2, suspect_ticks=2,
                                    dead_ticks=4, suspect_after_s=math.inf),
                      retry_backoff_s=0.0)
    for c in (clu, jclu):
        for p in prompts:
            c.submit(p, max_new=6)
    res, jres = clu.run_until_complete(), jclu.run_until_complete()
    assert _key(res) == _key(jres)
    assert [r.tokens for r in res if r.status == "ok"] == \
        [w for w, r in zip(want, res) if r.status == "ok"]
    for f in ("health", "faults_injected", "auto_failed_drives", "retries",
              "failed_requests"):
        assert getattr(clu.stats, f) == getattr(jclu.stats, f), f
    assert clu.stats.health == ([HEALTHY, DEAD] if name == "crash"
                                else [HEALTHY, HEALTHY])
    _conserved_and_balanced(clu, res, len(prompts))


def test_fail_mid_chunked_prefill_leaks_no_pages(setup, donors, rng):
    long_p, short_p = (rng.integers(0, setup[1].vocab_size, n).tolist()
                       for n in (24, 5))
    want = _oracle(donors, [short_p, long_p], 4, k_block=1)
    clu, _ = _pair(setup, donors, k_block=1, n_drives=2,
                   routing="round_robin", chunk_prefill=4)
    rids = [clu.submit(short_p, max_new=4), clu.submit(long_p, max_new=4)]
    clu.step()                                     # first chunk spliced
    d1 = clu.drives[1]
    assert any(s.active and s.prefilling for s in d1.engine.slots)
    assert d1.engine.pager.num_in_use > 0
    clu.fail(1)
    assert d1.engine.pager.num_in_use == 0         # partial splice freed
    d1.engine.pager.check_balanced()
    res = {r.rid: r for r in clu.run_until_complete()}
    assert sorted(res) == rids
    assert [res[r].tokens for r in rids] == want   # retried on drive 0
    _conserved_and_balanced(clu, list(res.values()), len(rids))


def test_pool_clamp_backpressures_then_lifts(setup, donors, rng):
    prompts = [rng.integers(0, setup[1].vocab_size, n).tolist()
               for n in (5, 8)]
    want = _oracle(donors, prompts, 4, k_block=1)
    clu, _ = _pair(setup, donors, k_block=1, n_drives=1, faults=[
        {"drive_id": 0, "kind": "page_pool_clamp", "at_tick": 0,
         "duration": 6, "factor": 0.0}])
    rids = [clu.submit(p, max_new=4) for p in prompts]
    for _ in range(4):
        clu.step()
    eng = clu.drives[0].engine
    assert eng.num_active == 0                     # clamp blocked admission
    assert eng.pending + len(clu.queue) == 2
    res = {r.rid: r for r in clu.run_until_complete()}
    assert [res[r].tokens for r in rids] == want
    assert eng.pool_clamp_frac == 1.0              # lifted
    _conserved_and_balanced(clu, list(res.values()), len(rids))


def test_jit_donor_rejects_mismatched_wiring(setup, donors):
    _, tcfg, _, model = setup
    ref = donors[8][1]
    for kw in (dict(k_block=2), dict(max_len=32), dict(eos_id=3)):
        args = dict(max_len=MAX_LEN, num_slots=2, device="cpu")
        args.update(kw)
        with pytest.raises(ValueError, match="jit_donor"):
            ServeEngine(tcfg, model, jit_donor=ref, **args)
    with pytest.raises(ValueError, match="jit_donor"):
        ClusterEngine(tcfg, model, jit_donor=donors[1][1], k_block=8,
                      max_len=MAX_LEN, num_slots=2, device="cpu")
    # a matching replica shares the donor's warm sites
    twin = ServeEngine(tcfg, model, jit_donor=ref, max_len=MAX_LEN,
                       num_slots=2, device="cpu")
    assert twin._warm_keys is ref._warm_keys


def test_concurrent_cluster_serves_oracle_tokens(setup, donors, trace):
    """Worker threads, one a drive, with thresholds no healthy drive can
    reach: the oracle's tokens, conservation and a clean join."""
    prompts, _ = trace
    want = _oracle(donors, prompts, 5, k_block=1)
    _, tcfg, _, model = setup
    watchdog = HeartbeatWatchdog(2, suspect_after_s=60.0, suspect_misses=10**6,
                                 dead_after_s=120.0, dead_misses=10**6)
    with ClusterEngine(tcfg, model, n_drives=2, routing="round_robin",
                       jit_donor=donors[1][1], k_block=1, max_len=MAX_LEN,
                       num_slots=2, chunk_prefill=8, concurrent=True,
                       dispatch_timeout_s=30.0, watchdog=watchdog,
                       device="cpu") as clu:
        assert all(d.engine.stats.compile_s > 0 for d in clu.drives)
        rids = [clu.submit(p, max_new=5) for p in prompts]
        res = {r.rid: r for r in clu.run_until_complete()}
        assert sorted(res) == rids
        assert [res[r].tokens for r in rids] == want
        assert clu.stats.health == [HEALTHY, HEALTHY]
        _conserved_and_balanced(clu, list(res.values()), len(rids))
    assert not [t for t in threading.enumerate()
                if t.name.startswith("drive-worker-")]


@pytest.mark.parametrize("what", ["engine", "cluster"])
def test_tracing_on_equals_tracing_off(setup, donors, trace, what):
    prompts, shards = trace
    _, tcfg, _, model = setup
    want = _oracle(donors, prompts, 4)
    hub = TelemetryHub()
    kw = dict(jit_donor=donors[8][1], max_len=MAX_LEN, num_slots=2,
              chunk_prefill=8, telemetry=hub, device="cpu")
    if what == "engine":
        got = ServeEngine(tcfg, model, **kw).generate(prompts, max_new=4)
    else:
        got = ClusterEngine(tcfg, model, n_drives=2, **kw).generate(
            prompts, max_new=4, shard_ids=shards)
    assert [r.tokens for r in got] == want
    assert hub.events_dropped == 0
    phases = {e.get("name") for e in hub.events() if isinstance(e, dict)}
    assert {"prefill", "prefill_chunk", "decode_block"} <= phases
