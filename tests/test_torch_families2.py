"""The three archs of the port's second families slice, against the JAX
package on the same weights at their float32 reduced sizes:
deepseek-v2-236b (``"mla_moe"``: MLA attention with the compressed
cache, routed and shared experts), hymba-1.5b (``"hybrid"``: window GQA
and Mamba in parallel) and xlstm-125m (``"mlstm"`` / ``"slstm"``, no
attention and no KV).

For each arch: the config and its reducer field by field; the parameter
count at full size (the port on the meta device, the reference's
``count_params``); the bridge over every leaf and each leaf's dtype in a
bf16 LM (the reference's float32 leaves stay float32); prefill logits and
caches within 1e-4 and the same next tokens; per-slot decode_fn on the
engine's strip layout step by step, logits within 1e-4, after each
package's engine splice; the reference's prefill-vs-decode-chain
contract.  Then the engine's fixed-prompt scenario against the JAX
ServeEngine (tokens, statuses, ledgers, KV peaks): hymba and xlstm at
k_block 1 and 8, deepseek-v2 at 8.

Tolerance: 1e-4 on logits of the float32 reduced models, whose values are
O(1): the two packages run the same float32 arithmetic, summed in other
orders (Mamba's doubling scan against XLA's associative scan, blocked
products against XLA's), which moves a logit by a few fp32 ulps per
layer."""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_config as j_get
from repro.config import reduced_config as j_reduced
from repro.core import embedding as j_emb
from repro.models import model as JM
from repro.models.layers import rms_norm as j_rms
from repro.train.serve_loop import AdmissionController as JAdmission
from repro.train.serve_loop import ServeEngine as JEngine
from repro.train.serve_loop import _splice_slots as j_splice
from repro_torch.bridge import params_from_jax
from repro_torch.config import get_config as t_get
from repro_torch.config import reduced_config as t_reduced
from repro_torch.core import embedding as t_emb
from repro_torch.models import model as TM
from repro_torch.models.layers import rms_norm as t_rms
from repro_torch.train.serve_loop import AdmissionController as TAdmission
from repro_torch.train.serve_loop import ServeEngine as TEngine
from repro_torch.train.serve_loop import _splice_slots as t_splice

LOGIT_ATOL = 1e-4
MAX_LEN, NUM_SLOTS = 64, 2
ARCHS = ("deepseek-v2-236b", "hymba-1.5b", "xlstm-125m")
FULL_COUNTS = {"deepseek-v2-236b": 239_375_569_920,
               "hymba-1.5b": 1_611_009_600,
               "xlstm-125m": 129_582_384}
FP32_LEAVES = ("moe.router", "ssm.dt_bias", "ssm.a_log", "ssm.d_skip",
               "core.if_bias", "core.bias")
RECURRENT = ("hymba-1.5b", "xlstm-125m")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setups():
    """Per arch, made at first use: (jcfg, tcfg, JAX params, numpy tree,
    the port's LM, the JAX engines' jit donors)."""
    made = {}

    def get(arch):
        if arch not in made:
            jcfg = dataclasses.replace(j_reduced(arch), dtype="float32")
            tcfg = dataclasses.replace(t_reduced(arch), dtype="float32")
            jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
            tree = jax.tree.map(np.asarray, jp)
            made[arch] = (jcfg, tcfg, jp, tree,
                          params_from_jax(tree, tcfg, "cpu"), {})
        return made[arch]
    return get


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _assert_caches_close(tcache, jcache):
    t = dict(_leaves(tcache))
    j = dict(_leaves(jax.tree.map(np.asarray, jcache)))
    assert set(t) == set(j)
    for name, want in j.items():
        got = t[name].numpy()
        assert got.dtype == want.dtype, name
        if name.endswith("kpos"):
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0,
                                       err_msg=name)


def _check_tokens(jl, tl, step):
    jt, tt = jl.argmax(-1), tl.argmax(-1)
    for b in np.nonzero(jt != tt)[0]:
        top2 = np.sort(jl[b])[-2:]
        pytest.fail(f"step {step} slot {b}: token {tt[b]} vs reference "
                    f"{jt[b]}, top-2 margin {top2[1] - top2[0]:.3g}")


def _tokens(cfg, rng, lengths):
    B, S = len(lengths), max(lengths)
    tokens = np.zeros((B, S), np.int32)
    for i, n in enumerate(lengths):
        tokens[i, :n] = rng.integers(0, cfg.vocab_size, n)
    return tokens, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_reducer_match_the_reference(arch):
    assert dataclasses.asdict(t_get(arch)) == dataclasses.asdict(j_get(arch))
    assert dataclasses.asdict(t_reduced(arch)) == \
        dataclasses.asdict(j_reduced(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_match_the_reference_at_full_size(arch):
    tcfg, jcfg = t_get(arch), j_get(arch)
    assert TM.count_params(tcfg) == JM.count_params(jcfg) == \
        tcfg.param_count() == FULL_COUNTS[arch]
    assert tcfg.active_param_count() == jcfg.active_param_count()
    assert (tcfg.active_param_count() < tcfg.param_count()) == \
        (tcfg.moe is not None)


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_carries_every_leaf_and_its_dtype(setups, arch):
    jcfg, tcfg, _, tree, model, _ = setups(arch)
    state = model.state_dict()
    gs = len(TM.group_pattern(tcfg))
    names = set()
    for path, leaf in _leaves(tree):
        keys = path.split(".")
        if keys[0] == "blocks":
            j = int(keys[1][1:])
            for g in range(leaf.shape[0]):
                name = ".".join(["blocks", str(g * gs + j)] + keys[2:])
                np.testing.assert_array_equal(state[name].numpy(), leaf[g])
                names.add(name)
        else:
            np.testing.assert_array_equal(state[path].numpy(), leaf)
            names.add(path)
    assert names == set(state)
    # in bf16 the reference's float32 leaves stay float32 through the
    # bridge; every other leaf takes the model dtype
    # (the reference's bf16 tree: its abstract leaves' dtypes on the
    # float32 values)
    jb = dataclasses.replace(jcfg, dtype="bfloat16")
    tb = dataclasses.replace(tcfg, dtype="bfloat16")
    jtree = jax.tree.map(lambda a, s: np.asarray(jnp.asarray(a, s.dtype)),
                         tree, JM.abstract_params(jb))
    bf = params_from_jax(jtree, tb, "cpu")
    jdtypes = {}
    for path, leaf in _leaves(jtree):
        jdtypes[path.split(".", 2)[-1] if path.startswith("blocks")
                else path] = leaf.dtype
    for name, t in bf.state_dict().items():
        want = torch.float32 if name.endswith(FP32_LEAVES) \
            else torch.bfloat16
        assert t.dtype == want, name
        key = name.split(".", 2)[-1] if name.startswith("blocks") else name
        assert str(jdtypes[key]) == str(want).removeprefix("torch."), name
    # a fresh init agrees with the reference on every leaf's dtype too
    fresh = TM.LM(tb, "meta")
    assert {n: t.dtype for n, t in fresh.state_dict().items()} == \
        {n: t.dtype for n, t in bf.state_dict().items()}


def _prefill(setup, data, lens):
    jcfg, tcfg, jp, _, model, _ = setup
    S = data.shape[1]
    jx = jp["embed"]["table"][data]
    jx, jcache, _ = JM.run_blocks(jp, jx, jnp.arange(S, dtype=jnp.int32),
                                  jcfg, JM.LOCAL, None, "prefill")
    jx = j_rms(jx[np.arange(len(lens)), lens - 1], jp["final_norm"],
               jcfg.norm_eps)
    jl = np.asarray(j_emb.sharded_logits_last(jx, JM._head_table(jp, jcfg),
                                              JM.LOCAL, jcfg))
    with torch.no_grad():
        tx = model.embed.table[torch.from_numpy(data).long()]
        tx, tcache = TM.run_blocks(model, tx, torch.arange(
            S, dtype=torch.int32), tcfg, None, "prefill")
        tx = t_rms(tx[torch.arange(len(lens)), torch.from_numpy(lens).long()
                      - 1], model.final_norm, tcfg.norm_eps)
        tl = t_emb.sharded_logits_last(tx, model.head_table(), tcfg).numpy()
    return jl, tl, jcache, tcache


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax(setups, arch):
    """Ragged prompts, one of 21 rows (past the reduced chunk size of 16,
    and not a multiple of it): last-row logits, every cache leaf, and
    prefill_fn's next tokens."""
    setup = setups(arch)
    jcfg, tcfg, jp, _, model, _ = setup
    data, lens = _tokens(tcfg, np.random.default_rng(1), [21, 5, 9])
    jl, tl, jcache, tcache = _prefill(setup, data, lens)
    np.testing.assert_allclose(tl, jl, atol=LOGIT_ATOL, rtol=0)
    _check_tokens(jl, tl, "prefill")
    _assert_caches_close(tcache, jcache)
    jnxt, _ = JM.prefill_fn(jp, {"tokens": jnp.asarray(data),
                                 "lengths": jnp.asarray(lens)}, jcfg)
    with torch.no_grad():
        tnxt, _ = TM.prefill_fn(model, {"tokens": torch.from_numpy(data),
                                        "lengths": torch.from_numpy(lens)},
                                tcfg)
    assert tnxt.tolist() == np.asarray(jnxt).tolist() == \
        jl.argmax(-1).tolist()


@functools.partial(jax.jit, static_argnums=4)
def _decode_logits_jax(jp, caches, tok, pos, jcfg):
    x = jp["embed"]["table"][tok[:, None]]
    x, caches, _ = JM.run_blocks(jp, x, pos, jcfg, JM.LOCAL, caches,
                                 "decode")
    x = j_rms(x[:, -1], jp["final_norm"], jcfg.norm_eps)
    return j_emb.sharded_logits_last(x, JM._head_table(jp, jcfg), JM.LOCAL,
                                     jcfg), caches


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_fn_matches_jax_step_by_step(setups, arch):
    """Prefill spliced into per-slot strips by each package's engine
    splice, then 8 per-slot decode steps: logits and caches within 1e-4,
    identical greedy tokens.  The recurrent archs prefill prompts of one
    length, as the engine's exact-length buckets give them; deepseek-v2's
    are ragged."""
    jcfg, tcfg, jp, _, model, _ = setups(arch)
    lengths = [9, 9, 9] if arch in RECURRENT else [11, 4, 7]
    B = len(lengths)
    data, lens = _tokens(tcfg, np.random.default_rng(2), lengths)
    jnxt, jpre = JM.prefill_fn(jp, {"tokens": jnp.asarray(data),
                                    "lengths": jnp.asarray(lens)}, jcfg)
    with torch.no_grad():
        tnxt, tpre = TM.prefill_fn(model, {"tokens": torch.from_numpy(data),
                                           "lengths": torch.from_numpy(lens)},
                                   tcfg)
    assert tnxt.tolist() == np.asarray(jnxt).tolist()
    jc = JM.init_caches(jcfg, B, MAX_LEN, per_slot=True)
    jc = j_splice(jc, jpre, list(range(B)), lengths)
    tc = TM.init_caches(tcfg, B, MAX_LEN, per_slot=True, device="cpu")
    tc = t_splice(tc, tpre, list(range(B)), lengths)
    _assert_caches_close(tc, jc)
    tok, pos = np.array(jnxt, np.int32), lens.copy()
    for step in range(8):
        jl, jc = _decode_logits_jax(jp, jc, jnp.asarray(tok),
                                    jnp.asarray(pos), jcfg)
        jl = np.asarray(jl)
        with torch.no_grad():
            x = model.embed.table[torch.from_numpy(tok[:, None]).long()]
            x, tc = TM.run_blocks(model, x, torch.from_numpy(pos), tcfg, tc,
                                  "decode")
            x = t_rms(x[:, -1], model.final_norm, tcfg.norm_eps)
            tl = t_emb.sharded_logits_last(x, model.head_table(),
                                           tcfg).numpy()
        np.testing.assert_allclose(tl, jl, atol=LOGIT_ATOL, rtol=0)
        _check_tokens(jl, tl, step)
        tok = jl.argmax(-1).astype(np.int32)
        pos = pos + 1
    _assert_caches_close(tc, jc)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_decode_chain(setups, arch):
    """The reference's cache-integrity contract on the port: one prefill
    of 12 tokens gives the token that feeding them one by one through
    uniform decode_fn steps (shared-track caches) gives."""
    _, tcfg, _, _, model, _ = setups(arch)
    B, S = 2, 12
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, tcfg.vocab_size, (B, S)).astype(np.int32))
    with torch.no_grad():
        nxt_pre, _ = TM.prefill_fn(model, {"tokens": toks}, tcfg)
        caches = TM.init_caches(tcfg, B, S + 2, device="cpu")
        for t in range(S):
            nxt_seq, caches = TM.decode_fn(model, caches, toks[:, t:t + 1],
                                           torch.tensor(t, dtype=torch.int32),
                                           tcfg)
    assert nxt_pre.tolist() == nxt_seq.tolist()


# -- the serve engine ----------------------------------------------------------


def _engines(setup, k_block):
    jcfg, tcfg, jp, _, model, donors = setup
    common = dict(max_len=MAX_LEN, num_slots=NUM_SLOTS, k_block=k_block)
    je = JEngine(jcfg, jp, jit_donor=donors.get(k_block),
                 admission=JAdmission(NUM_SLOTS, host_rate=3.0,
                                      csd_rate=1.0), **common)
    donors.setdefault(k_block, je)
    te = TEngine(tcfg, model, device="cpu",
                 admission=TAdmission(NUM_SLOTS, host_rate=3.0,
                                      csd_rate=1.0), **common)
    return je, te


def _serve(engine, prompts, max_news):
    for p, m in zip(prompts, max_news):
        engine.submit(p, max_new=m)
    return engine.run_until_complete()


@pytest.mark.parametrize("arch,k_block", [
    ("hymba-1.5b", 1), ("hymba-1.5b", 8), ("xlstm-125m", 1),
    ("xlstm-125m", 8), ("deepseek-v2-236b", 8)])
def test_fixed_prompts_serve_matches_jax(setups, arch, k_block):
    """Prompts of 5, 21 (past a reduced chunk), 13 and 5 tokens on two
    slots, so slots are refilled: the same tokens, statuses, ledgers and
    KV footprint as the reference's engine, on the strip layout (these
    stacks have no paged layer); the recurrent stacks take exact-length
    buckets, deepseek-v2's padded ones."""
    setup = setups(arch)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, setup[1].vocab_size, n).tolist()
               for n in (5, 21, 13, 5)]
    je, te = _engines(setup, k_block)
    assert te.kv_layout == je.kv_layout == "strip"
    assert te.chunk_prefill is None and je.chunk_prefill is None
    for n in (5, 13, 21):
        assert te._bucket_len(n) == je._bucket_len(n)
    assert (te._bucket_len(5) == 5) == (arch in RECURRENT)
    max_news = (3, 6, 4, 5)
    jres, tres = _serve(je, prompts, max_news), _serve(te, prompts, max_news)
    key = lambda r: (r.rid, r.tokens, r.status, r.priority)   # noqa: E731
    assert [key(r) for r in tres] == [key(r) for r in jres]
    assert all(r.status == "ok" for r in tres)
    js, ts = je.stats, te.stats
    assert (ts.requests, ts.tokens, ts.decode_steps, ts.shed_requests) == \
        (js.requests, js.tokens, js.decode_steps, js.shed_requests)
    for name in ("ledger", "baseline"):
        a, b = getattr(ts, name), getattr(js, name)
        assert (a.link_bytes, a.kv_bytes) == (b.link_bytes, b.kv_bytes)
    assert te.kv_stats() == je.kv_stats()
    for rec in ts.latency.records:
        assert rec.submit_t <= rec.admit_t <= rec.first_token_t \
            <= rec.finish_t
        assert math.isfinite(rec.first_token_t)
