"""The port's gemma3-12b path against the JAX reference on the same weights,
at the float32 smoke size (6 layers: five sliding-window layers of window
32 with RoPE base 1e4, one global layer with base 1e6, tied embeddings):
the config and its reducer, the parameter bridge over the 6-block group,
prefill with the window ring caches, uniform-position decode_fn against
shared-track caches, and the serve engine's per-slot decode_fn and fused
decode block against mixed caches (paged global layers beside per-slot
window rings).  Prompts run past the 32-row window so the rings wrap.

Logits must agree within atol 1e-4 (fp32 accumulated in another order)
and greedy tokens must be identical step by step; a flip is reported with
its top-2 logit margin."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import reduced_config as j_reduced
from repro.configs import gemma3_12b as j_gemma
from repro.core import embedding as j_emb
from repro.models import model as JM
from repro.models.layers import rms_norm as j_rms
from repro.train.serve_loop import _splice_slots as j_splice
from repro_torch.bridge import params_from_jax
from repro_torch.config import get_config as t_get
from repro_torch.config import reduced_config as t_reduced
from repro_torch.core import embedding as t_emb
from repro_torch.models import model as TM
from repro_torch.models.layers import rms_norm as t_rms
from repro_torch.train.serve_loop import _splice_slots as t_splice

LOGIT_ATOL = 1e-4
MAX_LEN, PS = 96, 8
_JCFG = dataclasses.replace(j_reduced("gemma3-12b"), dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads; one thread keeps
    these tests from crowding timing-sensitive tests on other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cfgs():
    return _JCFG, dataclasses.replace(t_reduced("gemma3-12b"),
                                      dtype="float32")


@pytest.fixture(scope="module")
def weights(cfgs):
    jcfg, tcfg = cfgs
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jp)
    return jp, tree, params_from_jax(tree, tcfg, "cpu")


def _check_tokens(jl, tl, step):
    """Identical argmax, or a report of the flip with its margin."""
    jt, tt = jl.argmax(-1), tl.argmax(-1)
    for b in np.nonzero(jt != tt)[0]:
        top2 = np.sort(jl[b])[-2:]
        pytest.fail(f"step {step} slot {b}: token {tt[b]} vs reference "
                    f"{jt[b]}, top-2 margin {top2[1] - top2[0]:.3g}")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_config_and_reducer_match_the_reference(cfgs):
    jcfg, tcfg = cfgs
    assert dataclasses.asdict(t_get("gemma3-12b")) == \
        dataclasses.asdict(j_gemma.CONFIG)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.num_layers == 6 and tcfg.attn.window == 32
    assert TM.group_pattern(tcfg) == ("local",) * 5 + ("attn",)


def test_params_from_jax_roundtrips_every_leaf(cfgs, weights):
    jcfg, tcfg = cfgs
    _, tree, model = weights
    state = model.state_dict()
    assert "head" not in tree                     # tied embeddings
    assert model.head_table() is model.embed.table
    names = set()
    gs = len(TM.group_pattern(tcfg))
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
    assert TM.count_params(tcfg) == JM.count_params(jcfg)
    assert TM.count_params(t_get("gemma3-12b")) == \
        JM.count_params(j_gemma.CONFIG)


def _prompts(rng, lengths, vocab):
    S = max(lengths)
    tokens = np.zeros((len(lengths), S), np.int32)
    for i, n in enumerate(lengths):
        tokens[i, :n] = rng.integers(0, vocab, n)
    return tokens, np.asarray(lengths, np.int32)


def _logits_jax(jp, x, jcfg):
    x = j_rms(x, jp["final_norm"], jcfg.norm_eps)
    return j_emb.sharded_logits_last(x, jp["embed"]["table"], JM.LOCAL, jcfg)


def _logits_torch(model, x, tcfg):
    x = t_rms(x, model.final_norm, tcfg.norm_eps)
    return t_emb.sharded_logits_last(x, model.head_table(), tcfg).numpy()


def test_prefill_matches_jax(cfgs, weights, rng):
    """Logits, next tokens and every group's caches: the window rings
    (rolled so slot = pos % 32, kpos -1 past a short prompt) and the
    global layer's full K/V."""
    jcfg, tcfg = cfgs
    jp, _, model = weights
    tokens, lengths = _prompts(rng, [45, 20, 38], tcfg.vocab_size)
    S = tokens.shape[1]
    for sq in (S, 21):                    # the ring wraps, and it does not
        tk = tokens[:, :sq]
        lens = np.minimum(lengths, sq)
        x = jp["embed"]["table"][tk]
        jx, jcache, _ = JM.run_blocks(jp, x, jnp.arange(sq, dtype=jnp.int32),
                                      jcfg, JM.LOCAL, None, "prefill")
        jl = np.asarray(_logits_jax(jp, jx[np.arange(3), lens - 1], jcfg))
        with torch.no_grad():
            x = model.embed.table[torch.from_numpy(tk).long()]
            tx, tcache = TM.run_blocks(model, x,
                                       torch.arange(sq, dtype=torch.int32),
                                       tcfg, None, "prefill")
            tl = _logits_torch(model, tx[torch.arange(3),
                                         torch.from_numpy(lens).long() - 1],
                               tcfg)
            tnxt, _ = TM.prefill_fn(model, {
                "tokens": torch.from_numpy(tk),
                "lengths": torch.from_numpy(lens)}, tcfg)
        np.testing.assert_allclose(tl, jl, atol=LOGIT_ATOL, rtol=0)
        _check_tokens(jl, tl, f"prefill {sq}")
        jnxt, _ = JM.prefill_fn(jp, {"tokens": jnp.asarray(tk),
                                     "lengths": jnp.asarray(lens)}, jcfg)
        assert tnxt.tolist() == np.asarray(jnxt).tolist()
        assert set(tcache) == set(jcache) == {f"b{j}" for j in range(6)}
        for g in tcache:
            assert tcache[g]["kpos"].tolist() == \
                np.asarray(jcache[g]["kpos"]).tolist()
            for leaf in ("k", "v"):
                np.testing.assert_allclose(tcache[g][leaf].numpy(),
                                           np.asarray(jcache[g][leaf]),
                                           atol=LOGIT_ATOL, rtol=0)
        assert tcache["b0"]["k"].shape[2] == 32               # the ring
        assert tcache["b5"]["k"].shape[2] == sq               # global


@jax.jit
def _uniform_logits_jax(jp, caches, tok, pos):
    x = jp["embed"]["table"][tok[:, None]]
    x, caches, _ = JM.run_blocks(jp, x, pos[None], _JCFG, JM.LOCAL, caches,
                                 "decode")
    return _logits_jax(jp, x[:, -1], _JCFG), caches


def test_uniform_decode_fn_matches_jax(cfgs, weights, rng):
    """decode_fn with one scalar position for the batch against shared
    kpos (S,) caches (the isp-decode kernel's Pallas layout), fed a
    45-token prompt step by step: the rings wrap past 32, and the last
    step's token equals prefill's."""
    jcfg, tcfg = cfgs
    jp, _, model = weights
    B, S = 2, 45
    toks = rng.integers(0, tcfg.vocab_size, (B, S)).astype(np.int32)
    jc = JM.init_caches(jcfg, B, 64)
    tc = TM.init_caches(tcfg, B, 64, device="cpu")
    assert tc["b0"]["kpos"].shape == (1, 32)
    assert tc["b5"]["kpos"].shape == (1, 64)
    for t in range(S):
        jl, jc = _uniform_logits_jax(jp, jc, jnp.asarray(toks[:, t]),
                                     jnp.int32(t))
        jl = np.asarray(jl)
        with torch.no_grad():
            x = model.embed.table[torch.from_numpy(toks[:, t:t + 1]).long()]
            x, tc = TM.run_blocks(model, x, torch.tensor([t],
                                                         dtype=torch.int32),
                                  tcfg, tc, "decode")
            tl = _logits_torch(model, x[:, -1], tcfg)
        np.testing.assert_allclose(tl, jl, atol=LOGIT_ATOL, rtol=0)
        _check_tokens(jl, tl, t)
    for g in tc:
        assert tc[g]["kpos"].tolist() == np.asarray(jc[g]["kpos"]).tolist()
    # decode_fn itself, on the last token against fresh caches filled
    # through it, gives prefill's next token
    tc = TM.init_caches(tcfg, B, 64, device="cpu")
    with torch.no_grad():
        for t in range(S):
            nxt, tc = TM.decode_fn(model, tc,
                                   torch.from_numpy(toks[:, t:t + 1]),
                                   torch.tensor(t, dtype=torch.int32), tcfg)
        pre, _ = TM.prefill_fn(model, {"tokens": torch.from_numpy(toks)},
                               tcfg)
    assert nxt.tolist() == pre.tolist() == jl.argmax(-1).tolist()


def _engine_caches(cfgs, weights, rng, lengths):
    """Both packages' serve-layout caches (paged global layer, per-slot
    window rings) after prefilling ``lengths`` into slots 0..n-1 through
    each package's engine splice, with identical page tables."""
    jcfg, tcfg = cfgs
    jp, _, model = weights
    B = len(lengths)
    tokens, lens = _prompts(rng, lengths, tcfg.vocab_size)
    jnxt, jpre = JM.prefill_fn(jp, {"tokens": jnp.asarray(tokens),
                                    "lengths": jnp.asarray(lens)}, jcfg)
    with torch.no_grad():
        tnxt, tpre = TM.prefill_fn(model, {"tokens": torch.from_numpy(tokens),
                                           "lengths": torch.from_numpy(lens)},
                                   tcfg)
    maxp = MAX_LEN // PS
    table = np.full((B, maxp), -1, np.int32)
    nxt_page = 0
    for b, n in enumerate(lengths):      # pages for the prompt + 12 steps
        k = -(-(n + 12) // PS)
        table[b, :k] = np.arange(nxt_page, nxt_page + k)
        nxt_page += k
    jc = JM.init_caches(jcfg, B, MAX_LEN, paged=True, page_size=PS)
    jc = {g: dict(c, pages=jnp.broadcast_to(jnp.asarray(table)[None],
                                            c["pages"].shape))
          if "pages" in c else c for g, c in jc.items()}
    jc = j_splice(jc, jpre, list(range(B)), list(lengths), table, PS)
    tc = TM.init_caches(tcfg, B, MAX_LEN, paged=True, page_size=PS,
                        device="cpu")
    assert "pages" in tc["b5"] and tc["b0"]["kpos"].shape == (1, B, 32)
    tc["b5"]["pages"][:] = torch.from_numpy(table)
    tc = t_splice(tc, tpre, list(range(B)), list(lengths), table, PS)
    assert tnxt.tolist() == np.asarray(jnxt).tolist()
    for g in range(5):
        assert tc[f"b{g}"]["kpos"].tolist() == \
            np.asarray(jc[f"b{g}"]["kpos"]).tolist()
    return jc, tc, np.array(jnxt), np.array(lens)


@jax.jit
def _slot_logits_jax(jp, caches, tok, pos):
    x = jp["embed"]["table"][tok[:, None]]
    x, caches, _ = JM.run_blocks(jp, x, pos, _JCFG, JM.LOCAL, caches,
                                 "decode")
    return _logits_jax(jp, x[:, -1], _JCFG), caches


def test_engine_decode_fn_matches_jax_step_by_step(cfgs, weights, rng):
    """Per-slot positions against the engine's mixed caches, 10 steps:
    slot 0 starts past the window, slot 2 crosses it mid-way."""
    jcfg, tcfg = cfgs
    jp, _, model = weights
    jc, tc, tok, lens = _engine_caches(cfgs, weights, rng, [40, 9, 27])
    pos = lens.astype(np.int32)
    jn, _ = JM.decode_fn(jp, jc, jnp.asarray(tok[:, None]), jnp.asarray(pos),
                         jcfg)
    with torch.no_grad():
        tn, _ = TM.decode_fn(model, {g: {k: t.clone() for k, t in c.items()}
                                     for g, c in tc.items()},
                             torch.from_numpy(tok[:, None]),
                             torch.from_numpy(pos), tcfg)
    assert tn.tolist() == np.asarray(jn).tolist()
    for step in range(10):
        jl, jc = _slot_logits_jax(jp, jc, jnp.asarray(tok), jnp.asarray(pos))
        jl = np.asarray(jl)
        with torch.no_grad():
            x = model.embed.table[torch.from_numpy(tok[:, None]).long()]
            x, tc = TM.run_blocks(model, x, torch.from_numpy(pos), tcfg, tc,
                                  "decode")
            tl = _logits_torch(model, x[:, -1], tcfg)
        np.testing.assert_allclose(tl, jl, atol=LOGIT_ATOL, rtol=0)
        _check_tokens(jl, tl, step)
        tok = jl.argmax(-1).astype(np.int32)
        pos = pos + 1
    for g in range(5):
        assert tc[f"b{g}"]["kpos"].tolist() == \
            np.asarray(jc[f"b{g}"]["kpos"]).tolist()


def test_decode_block_fn_matches_jax(cfgs, weights, rng):
    """The eager K-step loop against the reference's while_loop on mixed
    caches: the same (K, B) block with -1 for silent slots, the same early
    exit and final slot state, and the same ring rows (finished slots'
    rows and kpos stamps stay untouched)."""
    jcfg, tcfg = cfgs
    jp, _, model = weights
    jc, tc, tok, lens = _engine_caches(cfgs, weights, rng, [30, 6, 44, 3])
    alive = np.asarray([True, True, False, True])
    remaining = np.asarray([7, 2, 4, 3], np.int32)
    pos = lens.astype(np.int32)
    kw = dict(k_steps=8, eos_id=None, max_len=MAX_LEN)
    jout = JM.decode_block_fn(jp, jc, jnp.asarray(tok), jnp.asarray(pos),
                              jnp.asarray(alive), jnp.asarray(remaining),
                              jcfg, **kw)
    with torch.no_grad():
        tout = TM.decode_block_fn(model, tc, torch.from_numpy(tok),
                                  torch.from_numpy(pos),
                                  torch.from_numpy(alive),
                                  torch.from_numpy(remaining), tcfg, **kw)
    assert int(tout[1]) == int(jout[1]) == 7       # early exit: all done
    for t, j in zip(tout[:6], jout[:6]):
        assert _np(t).tolist() == _np(j).tolist()
    assert (_np(tout[0])[:, 2] == -1).all()        # the dead slot is silent
    for g in range(5):
        name = f"b{g}"
        assert tout[6][name]["kpos"].tolist() == \
            np.asarray(jout[6][name]["kpos"]).tolist()
        for leaf in ("k", "v"):
            np.testing.assert_allclose(tout[6][name][leaf].numpy(),
                                       np.asarray(jout[6][name][leaf]),
                                       atol=LOGIT_ATOL, rtol=0)
