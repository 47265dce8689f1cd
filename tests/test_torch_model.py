"""The port's model (repro_torch.models) against the JAX reference on the
same weights: the parameter bridge, prefill, per-step decode and the
fused K-step decode block, at the float32 smoke size of yi-9b.

Logits must agree within atol 1e-4 and greedy tokens must be identical
step by step.  A token flip is reported with its top-2 logit margin (a
flip at a near tie would not be a fault, but the seeds here must not
produce one)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import reduced_config as j_reduced
from repro.core import embedding as j_emb
from repro.models import model as JM
from repro.models.layers import rms_norm as j_rms
from repro.train.serve_loop import _splice_slots as j_splice
from repro_torch.bridge import params_from_jax
from repro_torch.config import reduced_config as t_reduced
from repro_torch.core import embedding as t_emb
from repro_torch.models import model as TM
from repro_torch.models.layers import rms_norm as t_rms
from repro_torch.train.serve_loop import _splice_slots as t_splice

LOGIT_ATOL = 1e-4
MAX_LEN, PS = 48, 8
_JCFG = dataclasses.replace(j_reduced("yi-9b"), dtype="float32")


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
    return _JCFG, dataclasses.replace(t_reduced("yi-9b"), dtype="float32")


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


def test_params_from_jax_roundtrips_every_leaf(cfgs, weights):
    jcfg, tcfg = cfgs
    _, tree, model = weights
    state = model.state_dict()
    names = set()
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [p.key for p in path]
        if keys[0] == "blocks":
            gs = len(TM.group_pattern(tcfg))
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


def _prompts(rng, lengths, vocab):
    S = max(lengths)
    tokens = np.zeros((len(lengths), S), np.int32)
    for i, n in enumerate(lengths):
        tokens[i, :n] = rng.integers(0, vocab, n)
    return tokens, np.asarray(lengths, np.int32)


def _prefill_logits_jax(jp, jcfg, tokens, lengths):
    x = jp["embed"]["table"][tokens]
    S = tokens.shape[1]
    x, caches, _ = JM.run_blocks(jp, x, jnp.arange(S, dtype=jnp.int32), jcfg,
                                 JM.LOCAL, None, "prefill")
    x = j_rms(x, jp["final_norm"], jcfg.norm_eps)
    last = x[jnp.arange(len(lengths)), lengths - 1]
    return np.asarray(j_emb.sharded_logits_last(last, jp["head"]["w_head"],
                                                JM.LOCAL, jcfg)), caches


def _prefill_logits_torch(model, tcfg, tokens, lengths):
    x = model.embed.table[torch.from_numpy(tokens).long()]
    S = tokens.shape[1]
    x, caches = TM.run_blocks(model, x, torch.arange(S, dtype=torch.int32),
                              tcfg, None, "prefill")
    x = t_rms(x, model.final_norm, tcfg.norm_eps)
    last = x[torch.arange(len(lengths)), torch.from_numpy(lengths).long() - 1]
    return t_emb.sharded_logits_last(last, model.head_table(),
                                     tcfg).numpy(), caches


def test_prefill_matches_jax(cfgs, weights, rng):
    jcfg, tcfg = cfgs
    jp, _, model = weights
    tokens, lengths = _prompts(rng, [13, 5, 9], tcfg.vocab_size)
    with torch.no_grad():
        tl, tcache = _prefill_logits_torch(model, tcfg, tokens, lengths)
        tnxt, tcache2 = TM.prefill_fn(model, {
            "tokens": torch.from_numpy(tokens),
            "lengths": torch.from_numpy(lengths)}, tcfg)
    jl, jcache = _prefill_logits_jax(jp, jcfg, tokens, lengths)
    jnxt, _ = JM.prefill_fn(jp, {"tokens": jnp.asarray(tokens),
                                 "lengths": jnp.asarray(lengths)}, jcfg)
    np.testing.assert_allclose(tl, jl, atol=LOGIT_ATOL, rtol=0)
    _check_tokens(jl, tl, "prefill")
    assert tnxt.dtype == torch.int32
    assert tnxt.tolist() == np.asarray(jnxt).tolist() == jl.argmax(-1).tolist()
    for leaf in ("k", "v"):
        np.testing.assert_allclose(tcache["b0"][leaf].numpy(),
                                   np.asarray(jcache["b0"][leaf]),
                                   atol=LOGIT_ATOL, rtol=0)
        assert torch.equal(tcache["b0"][leaf], tcache2["b0"][leaf])
    assert tcache["b0"]["kpos"].tolist() == \
        np.asarray(jcache["b0"]["kpos"]).tolist()


def _paged_setup(cfgs, weights, rng, lengths):
    """Both packages' paged caches after prefilling ``lengths`` into
    slots 0..n-1 (page tables identical)."""
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
    for b, n in enumerate(lengths):      # pages for the prompt + 8 steps
        k = -(-(n + 8) // PS)
        table[b, :k] = np.arange(nxt_page, nxt_page + k)
        nxt_page += k
    jc = JM.init_caches(jcfg, B, MAX_LEN, paged=True, page_size=PS)
    jc = {g: dict(c, pages=jnp.broadcast_to(jnp.asarray(table)[None],
                                            c["pages"].shape))
          for g, c in jc.items()}
    jc = j_splice(jc, jpre, list(range(B)), list(lengths), table, PS)
    tc = TM.init_caches(tcfg, B, MAX_LEN, paged=True, page_size=PS,
                        device="cpu")
    for c in tc.values():
        c["pages"][:] = torch.from_numpy(table)
    tc = t_splice(tc, tpre, list(range(B)), list(lengths), table, PS)
    assert tnxt.tolist() == np.asarray(jnxt).tolist()
    return jc, tc, np.array(jnxt), np.array(lens)


@jax.jit
def _decode_logits_jax(jp, caches, tok, pos):
    jcfg = _JCFG
    x = jp["embed"]["table"][tok[:, None]]
    x, caches, _ = JM.run_blocks(jp, x, jnp.asarray(pos), jcfg, JM.LOCAL,
                                 caches, "decode")
    x = j_rms(x, jp["final_norm"], jcfg.norm_eps)
    return j_emb.sharded_logits_last(x[:, -1], jp["head"]["w_head"],
                                     JM.LOCAL, jcfg), caches


def _decode_logits_torch(model, tcfg, caches, tok, pos):
    x = model.embed.table[torch.from_numpy(tok[:, None]).long()]
    x, caches = TM.run_blocks(model, x, torch.from_numpy(pos), tcfg, caches,
                              "decode")
    x = t_rms(x, model.final_norm, tcfg.norm_eps)
    return t_emb.sharded_logits_last(x[:, -1], model.head_table(),
                                     tcfg).numpy(), caches


def test_decode_fn_matches_jax_step_by_step(cfgs, weights, rng):
    jcfg, tcfg = cfgs
    jp, _, model = weights
    jc, tc, tok, lens = _paged_setup(cfgs, weights, rng, [11, 4, 7])
    pos = lens.astype(np.int32)
    # decode_fn itself: same token as the reference on the first step
    jn, _ = JM.decode_fn(jp, jc, jnp.asarray(tok[:, None]), jnp.asarray(pos),
                         jcfg)
    with torch.no_grad():
        tn, _ = TM.decode_fn(model, tc, torch.from_numpy(tok[:, None]),
                             torch.from_numpy(pos), tcfg)
    assert tn.tolist() == np.asarray(jn).tolist()
    for step in range(6):
        jl, jc = _decode_logits_jax(jp, jc, jnp.asarray(tok),
                                    jnp.asarray(pos))
        jl = np.asarray(jl)
        with torch.no_grad():
            tl, tc = _decode_logits_torch(model, tcfg, tc, tok, pos)
        np.testing.assert_allclose(tl, jl, atol=LOGIT_ATOL, rtol=0)
        _check_tokens(jl, tl, step)
        tok = jl.argmax(-1).astype(np.int32)
        pos = pos + 1


def test_decode_block_fn_matches_jax(cfgs, weights, rng):
    """The eager K-step loop against the reference's while_loop: same
    (K, B) block with -1 for silent slots, same early exit, same final
    slot state, same pool rows (finished slots write only to scratch)."""
    jcfg, tcfg = cfgs
    jp, _, model = weights
    jc, tc, tok, lens = _paged_setup(cfgs, weights, rng, [9, 6, 12, 3])
    alive = np.asarray([True, True, False, True])
    remaining = np.asarray([5, 2, 4, 3], np.int32)
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
    assert int(tout[1]) == int(jout[1]) == 5       # early exit: all done
    for t, j in zip(tout[:6], jout[:6]):
        assert _np(t).tolist() == _np(j).tolist()
    assert (_np(tout[0])[:, 2] == -1).all()        # the dead slot is silent
    scratch = tc["b0"]["kp"].shape[1] - 1
    for leaf in ("kp", "vp"):
        np.testing.assert_allclose(
            tout[6]["b0"][leaf].numpy()[:, :scratch],
            np.asarray(jout[6]["b0"][leaf])[:, :scratch],
            atol=LOGIT_ATOL, rtol=0)
