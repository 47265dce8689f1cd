"""The five archs this slice ports, against the JAX package on the same
weights at their float32 reduced sizes: starcoder2-15b and llama3-405b
(dense GQA, untied heads, RoPE bases 1e5 / 5e5), llama4-scout-17b-a16e
(``"moe"`` blocks: 8 experts top-1 and a shared expert), musicgen-large
(MHA, tied embeddings) and chameleon-34b, the last two prefilling on a
modality frontend's ``embeddings`` and decoding on tokens.

For each arch: the config and its reducer field by field; the parameter
count and the active count at full size (the port on the meta device);
the bridge over every leaf (the MoE router stays float32 in a bf16 LM);
prefill logits within 1e-4 and the same next tokens; per-slot decode_fn
on the paged pool step by step (a flip is reported with its margin).
Then llama4 and starcoder2 serve the engine's fixed-prompt scenario at
k_block 1 and 8 against the JAX ServeEngine (tokens, statuses, ledger
bytes, KV peaks), llama4 serves it chunked against the reference's
chunked engine, and the frontend stubs give the reference's outputs bit
for bit."""
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
from repro.models import frontend as j_frontend
from repro.models import model as JM
from repro.models.layers import rms_norm as j_rms
from repro.train.serve_loop import AdmissionController as JAdmission
from repro.train.serve_loop import ServeEngine as JEngine
from repro.train.serve_loop import _splice_slots as j_splice
from repro_torch.bridge import params_from_jax
from repro_torch.config import get_config as t_get
from repro_torch.config import reduced_config as t_reduced
from repro_torch.core import embedding as t_emb
from repro_torch.models import frontend as t_frontend
from repro_torch.models import model as TM
from repro_torch.models.layers import rms_norm as t_rms
from repro_torch.train.serve_loop import AdmissionController as TAdmission
from repro_torch.train.serve_loop import ServeEngine as TEngine
from repro_torch.train.serve_loop import _splice_slots as t_splice

LOGIT_ATOL = 1e-4
MAX_LEN, PS, NUM_SLOTS = 64, 8, 2
ARCHS = ("starcoder2-15b", "llama3-405b", "llama4-scout-17b-a16e",
         "musicgen-large", "chameleon-34b")
SERVED = ("llama4-scout-17b-a16e", "starcoder2-15b")


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


def _check_tokens(jl, tl, step):
    """Identical argmax, or a report of the flip with its margin."""
    jt, tt = jl.argmax(-1), tl.argmax(-1)
    for b in np.nonzero(jt != tt)[0]:
        top2 = np.sort(jl[b])[-2:]
        pytest.fail(f"step {step} slot {b}: token {tt[b]} vs reference "
                    f"{jt[b]}, top-2 margin {top2[1] - top2[0]:.3g}")


def _batch(cfg, rng, lengths):
    """Right-padded prompts: token ids, or frontend embeddings for the
    frontend archs (rows past a prompt's length are zeros)."""
    B, S = len(lengths), max(lengths)
    lens = np.asarray(lengths, np.int32)
    if cfg.frontend:
        emb = np.zeros((B, S, cfg.d_model), np.float32)
        for i, n in enumerate(lengths):
            emb[i, :n] = rng.standard_normal((n, cfg.d_model))
        return "embeddings", emb, lens
    tokens = np.zeros((B, S), np.int32)
    for i, n in enumerate(lengths):
        tokens[i, :n] = rng.integers(0, cfg.vocab_size, n)
    return "tokens", tokens, lens


@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_reducer_match_the_reference(arch):
    assert dataclasses.asdict(t_get(arch)) == dataclasses.asdict(j_get(arch))
    assert dataclasses.asdict(t_reduced(arch)) == \
        dataclasses.asdict(j_reduced(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_match_the_reference_at_full_size(arch):
    tcfg, jcfg = t_get(arch), j_get(arch)
    assert TM.count_params(tcfg) == JM.count_params(jcfg) == \
        tcfg.param_count()
    assert tcfg.active_param_count() == jcfg.active_param_count()
    if tcfg.moe is None:
        assert tcfg.active_param_count() == tcfg.param_count()
    else:
        assert tcfg.active_param_count() < tcfg.param_count()


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_carries_every_leaf(setups, arch):
    jcfg, tcfg, _, tree, model, _ = setups(arch)
    state = model.state_dict()
    gs = len(TM.group_pattern(tcfg))
    names = set()
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [p.key for p in path]
        if keys[0] == "blocks":
            j = int(keys[1][1:])
            for g in range(leaf.shape[0]):
                name = ".".join(["blocks", str(g * gs + j)] + keys[2:])
                np.testing.assert_array_equal(state[name].numpy(), leaf[g])
                names.add(name)
        else:
            name = ".".join(keys)
            np.testing.assert_array_equal(state[name].numpy(), leaf)
            names.add(name)
    assert names == set(state)
    assert ("head" in tree) == (not tcfg.tie_embeddings)
    if tcfg.moe is None:
        return
    # in bf16 the MoE router stays float32 through the bridge, as in the
    # reference; every other leaf takes the model dtype
    jb = dataclasses.replace(jcfg, dtype="bfloat16")
    tb = dataclasses.replace(tcfg, dtype="bfloat16")
    bf = params_from_jax(jax.tree.map(
        np.asarray, JM.init_params(jb, jax.random.PRNGKey(1))), tb, "cpu")
    for name, t in bf.state_dict().items():
        want = torch.float32 if name.endswith("moe.router") \
            else torch.bfloat16
        assert t.dtype == want, name


def _prefill_logits(setup, kind, data, lens):
    """Both packages' last-row logits and caches of one prefill."""
    jcfg, tcfg, jp, _, model, _ = setup
    S = data.shape[1]
    jx = jp["embed"]["table"][data] if kind == "tokens" else jnp.asarray(data)
    jx, jcache, _ = JM.run_blocks(jp, jx, jnp.arange(S, dtype=jnp.int32),
                                  jcfg, JM.LOCAL, None, "prefill")
    jx = j_rms(jx[np.arange(len(lens)), lens - 1], jp["final_norm"],
               jcfg.norm_eps)
    jl = np.asarray(j_emb.sharded_logits_last(jx, JM._head_table(jp, jcfg),
                                              JM.LOCAL, jcfg))
    with torch.no_grad():
        tx = model.embed.table[torch.from_numpy(data).long()] \
            if kind == "tokens" else torch.from_numpy(data)
        tx, tcache = TM.run_blocks(model, tx, torch.arange(
            S, dtype=torch.int32), tcfg, None, "prefill")
        tx = t_rms(tx[torch.arange(len(lens)), torch.from_numpy(lens).long()
                      - 1], model.final_norm, tcfg.norm_eps)
        tl = t_emb.sharded_logits_last(tx, model.head_table(), tcfg).numpy()
    return jl, tl, jcache, tcache


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax(setups, arch):
    setup = setups(arch)
    jcfg, tcfg, jp, _, model, _ = setup
    kind, data, lens = _batch(tcfg, np.random.default_rng(1), [13, 5, 9])
    jl, tl, jcache, tcache = _prefill_logits(setup, kind, data, lens)
    np.testing.assert_allclose(tl, jl, atol=LOGIT_ATOL, rtol=0)
    _check_tokens(jl, tl, "prefill")
    for leaf in ("k", "v"):
        np.testing.assert_allclose(tcache["b0"][leaf].numpy(),
                                   np.asarray(jcache["b0"][leaf]),
                                   atol=LOGIT_ATOL, rtol=0)
    jnxt, _ = JM.prefill_fn(jp, {kind: jnp.asarray(data),
                                 "lengths": jnp.asarray(lens)}, jcfg)
    with torch.no_grad():
        tnxt, _ = TM.prefill_fn(model, {kind: torch.from_numpy(data),
                                        "lengths": torch.from_numpy(lens)},
                                tcfg)
    assert tnxt.dtype == torch.int32
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
    """Prefill (on embeddings for the frontend archs) spliced into the
    paged pool by each package's engine splice, then 8 per-slot decode
    steps on tokens: logits within 1e-4, identical greedy tokens."""
    jcfg, tcfg, jp, _, model, _ = setups(arch)
    lengths = [11, 4, 7]
    B = len(lengths)
    kind, data, lens = _batch(tcfg, np.random.default_rng(2), lengths)
    jnxt, jpre = JM.prefill_fn(jp, {kind: jnp.asarray(data),
                                    "lengths": jnp.asarray(lens)}, jcfg)
    with torch.no_grad():
        tnxt, tpre = TM.prefill_fn(model, {kind: torch.from_numpy(data),
                                           "lengths": torch.from_numpy(lens)},
                                   tcfg)
    assert tnxt.tolist() == np.asarray(jnxt).tolist()
    table = np.full((B, MAX_LEN // PS), -1, np.int32)
    used = 0
    for b, n in enumerate(lengths):      # pages for the prompt + 8 steps
        k = -(-(n + 8) // PS)
        table[b, :k] = np.arange(used, used + k)
        used += k
    jc = JM.init_caches(jcfg, B, MAX_LEN, paged=True, page_size=PS)
    jc = {g: dict(c, pages=jnp.broadcast_to(jnp.asarray(table)[None],
                                            c["pages"].shape))
          for g, c in jc.items()}
    jc = j_splice(jc, jpre, list(range(B)), lengths, table, PS)
    tc = TM.init_caches(tcfg, B, MAX_LEN, paged=True, page_size=PS,
                        device="cpu")
    for c in tc.values():
        c["pages"][:] = torch.from_numpy(table)
    tc = t_splice(tc, tpre, list(range(B)), lengths, table, PS)
    tok, pos = np.array(jnxt, np.int32), lens.copy()
    jn, _ = JM.decode_fn(jp, jc, jnp.asarray(tok[:, None]), jnp.asarray(pos),
                         jcfg)
    with torch.no_grad():
        tn, _ = TM.decode_fn(model, {g: {k: t.clone() for k, t in c.items()}
                                     for g, c in tc.items()},
                             torch.from_numpy(tok[:, None]),
                             torch.from_numpy(pos), tcfg)
    assert tn.tolist() == np.asarray(jn).tolist()
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


# -- the serve engine ----------------------------------------------------------


def _engines(setup, k_block, **kw):
    jcfg, tcfg, jp, _, model, donors = setup
    common = dict(max_len=MAX_LEN, num_slots=NUM_SLOTS, page_size=PS,
                  k_block=k_block, **kw)
    key = (k_block, kw.get("chunk_prefill"))
    je = JEngine(jcfg, jp, jit_donor=donors.get(key),
                 admission=JAdmission(NUM_SLOTS, host_rate=3.0,
                                      csd_rate=1.0), **common)
    donors.setdefault(key, je)
    te = TEngine(tcfg, model, device="cpu",
                 admission=TAdmission(NUM_SLOTS, host_rate=3.0,
                                      csd_rate=1.0), **common)
    return je, te


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
    assert te.kv_layout == je.kv_layout == "paged"
    assert te.pager.peak_pages == je.pager.peak_pages
    te.pager.check_balanced()
    assert (te.page_table == -1).all()
    for rec in ts.latency.records:
        assert rec.submit_t <= rec.admit_t <= rec.first_token_t \
            <= rec.finish_t
        assert math.isfinite(rec.first_token_t)


def _serve(engine, prompts, max_news):
    for p, m in zip(prompts, max_news):
        engine.submit(p, max_new=m)
    return engine.run_until_complete()


@pytest.mark.parametrize("k_block", [1, 8])
@pytest.mark.parametrize("arch", SERVED)
def test_fixed_prompts_serve_matches_jax(setups, arch, k_block):
    setup = setups(arch)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, setup[1].vocab_size, n).tolist()
               for n in (5, 9, 13)]
    je, te = _engines(setup, k_block)
    _compare(je, te, _serve(je, prompts, (3, 6, 4)),
             _serve(te, prompts, (3, 6, 4)))


@pytest.mark.parametrize("k_block,prewarm", [(1, False), (8, True)])
def test_llama4_chunked_serve_matches_reference(setups, k_block, prewarm):
    """llama4's ``"moe"`` stack chunks (8-row chunks, prompts of up to 30
    tokens) in both packages, the port's engine cold and prewarmed: the
    same tokens, statuses, ledgers and KV peaks as the reference's
    chunked engine, and the one-shot tokens."""
    setup = setups("llama4-scout-17b-a16e")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, setup[1].vocab_size, n).tolist()
               for n in (5, 21, 30, 9)]
    je, te = _engines(setup, k_block, chunk_prefill=8)
    assert te.chunk_prefill == je.chunk_prefill == 8
    if prewarm:                        # the port's engine only
        te.prewarm()
        assert te._warm_keys == {("prefill",), ("chunk",),
                                 ("decode_block",)}
    tres = _serve(te, prompts, (4, 3, 5, 2))
    _compare(je, te, _serve(je, prompts, (4, 3, 5, 2)), tres)
    _, oneshot = _engines(setup, k_block)
    assert [r.tokens for r in _serve(oneshot, prompts, (4, 3, 5, 2))] == \
        [r.tokens for r in tres]


# -- the frontend stubs --------------------------------------------------------


def test_audio_frontend_is_the_reference_bit_for_bit():
    wave = np.random.default_rng(5).standard_normal((2, 16_000 * 3 // 2))
    for arch in ("musicgen-large",):
        jfe = j_frontend.AudioFrontendStub(j_reduced(arch))
        tfe = t_frontend.AudioFrontendStub(t_reduced(arch))
        for seed in (0, 3):
            (je, jt), (te, tt) = jfe.encode(wave, seed), tfe.encode(wave,
                                                                    seed)
            assert te.dtype == je.dtype and tt.dtype == jt.dtype
            np.testing.assert_array_equal(te, je)
            np.testing.assert_array_equal(tt, jt)
        assert te.shape == (2, 75, t_reduced(arch).d_model)
    full = t_frontend.AudioFrontendStub(t_get("musicgen-large"))
    emb, tok = full.encode(wave[:, :3200])
    assert emb.shape == (2, 10, 2048) and tok.max() < 2048


def test_vq_frontend_is_the_reference_bit_for_bit():
    images = np.random.default_rng(6).random((2, 40, 56, 3))
    jfe = j_frontend.VQFrontendStub(j_reduced("chameleon-34b"), patch=8)
    tfe = t_frontend.VQFrontendStub(t_reduced("chameleon-34b"), patch=8)
    for seed in (0, 9):
        (je, jc), (te, tc) = jfe.encode(images, seed), tfe.encode(images,
                                                                  seed)
        assert te.dtype == je.dtype and tc.dtype == jc.dtype
        np.testing.assert_array_equal(te, je)
        np.testing.assert_array_equal(tc, jc)
    assert te.shape == (2, 5 * 7, t_reduced("chameleon-34b").d_model)
