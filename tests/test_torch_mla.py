"""The port's MLA (multi-head latent attention) against the JAX package on
the same inputs, in float32: ``ops.flash_attention``'s plain path at a q/k
head dim that differs from the v head dim; the absorbed decode partial
and attention over the compressed cache; ``mla_apply`` in prefill and in
decode on a shared track and on per-slot tracks with a write mask; the
refusal of a prefill chunk; and the flash wrapper's shape checks for the
kernel's (192, 128) instantiation, which run on the CPU without a launch.

Shapes: the reduced deepseek-v2 config (4 heads, compressed rank 16, rope
8, nope 16, v 16, q rank 1536) and, for the attention op, deepseek-v2's
own qk 192 / v 128 at 4 heads.  Inputs come from numpy generators.

Tolerance: 1e-5 absolute on O(1) float32 outputs (the same products and
online softmax summed in other orders: a few fp32 ulps)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import reduced_config as j_reduced
from repro.core import decode_attention as j_da
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro.models import attention as j_attn
from repro.models.layers import KeyGen
from repro_torch.config import reduced_config as t_reduced
from repro_torch.core import decode_attention as t_da
from repro_torch.kernels import flash_attention as t_fa
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref
from repro_torch.models import attention as t_attn

ATOL = 1e-5
ARCH = "deepseek-v2-236b"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cfgs():
    return (dataclasses.replace(j_reduced(ARCH), dtype="float32"),
            dataclasses.replace(t_reduced(ARCH), dtype="float32"))


@pytest.fixture(scope="module")
def weights(cfgs):
    """The reference's MLA weights and the port's module holding them."""
    jcfg, tcfg = cfgs
    jp = j_attn.mla_params(jcfg, KeyGen(jax.random.PRNGKey(0)), jnp.float32)
    # non-zero norm scales, so the norms are exercised too
    rng = np.random.default_rng(0)
    jp = {k: (jnp.asarray(rng.standard_normal(v.shape) * 0.1, v.dtype)
              if k.endswith("norm") else v) for k, v in jp.items()}
    mod = t_attn.MLA(tcfg, torch.float32, "cpu")
    assert set(dict(mod.named_parameters())) == set(jp)
    with torch.no_grad():
        for k, v in jp.items():
            getattr(mod, k).copy_(_t(v))
    return jp, mod


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=0)


@pytest.mark.parametrize("window,q_offset", [(None, 0), (None, 5), (7, 3)])
def test_flash_plain_path_at_qk_192_v_128(window, q_offset):
    rng = np.random.default_rng(1)
    B, Sq, Skv, H, Hkv = 2, 13, 13 + q_offset, 4, 4
    q = rng.standard_normal((B, Sq, H, 192)).astype(np.float32)
    k = rng.standard_normal((B, Skv, Hkv, 192)).astype(np.float32)
    v = rng.standard_normal((B, Skv, Hkv, 128)).astype(np.float32)
    kw = dict(causal=True, window=window, q_offset=q_offset, scale=0.07,
              q_chunk=8, kv_chunk=8)
    want = j_ops.flash_attention(q, k, v, impl="jnp", **kw)
    got = t_ops.flash_attention(_t(q), _t(k), _t(v), **kw)
    assert got.shape == (B, Sq, H, 128)
    _close(got, want)


def test_flash_wrapper_shape_checks_for_192_128():
    """The kernel's head-dim pairs, checked from shapes alone: (192, 128)
    passes the shape check and then needs a CUDA tensor; any other unequal
    pair, or a v whose leading dims differ from k's, is refused."""
    q = torch.zeros(1, 4, 2, 192)
    k = torch.zeros(1, 4, 2, 192)
    t_fa.check_shapes(q, k, torch.zeros(1, 4, 2, 128))
    with pytest.raises(ValueError, match="CUDA kernel got a tensor on cpu"):
        t_fa.flash_attention(q, k, torch.zeros(1, 4, 2, 128))
    for dqk, dv in ((192, 192), (128, 192), (192, 64), (240, 128),
                    (64, 128)):
        with pytest.raises(ValueError, match="head dims"):
            t_fa.flash_attention(torch.zeros(1, 4, 2, dqk),
                                 torch.zeros(1, 4, 2, dqk),
                                 torch.zeros(1, 4, 2, dv))
    with pytest.raises(ValueError, match="shapes"):
        t_fa.check_shapes(q, k, torch.zeros(1, 5, 2, 128))
    with pytest.raises(ValueError, match="shapes"):
        t_fa.check_shapes(q, torch.zeros(1, 4, 2, 128),
                          torch.zeros(1, 4, 2, 128))
    assert (192, 128) in t_fa.HEAD_DIMS


def _mla_decode_inputs(rng, per_slot):
    B, H, S, R, r, n = 3, 4, 20, 16, 8, 16
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    q_nope, q_rope, ckv, krope = f(B, H, n), f(B, H, r), f(B, S, R), \
        f(B, S, r)
    wk_b = f(R, H, n) * 0.25
    if per_slot:
        kpos = np.full((B, S), -1, np.int32)
        cur = np.array([4, 0, 19], np.int32)
        for b, c in enumerate(cur):
            kpos[b, :c + 1] = np.arange(c + 1)
        kpos[1] = -1                      # an empty slot
    else:
        kpos = np.where(np.arange(S) < 11, np.arange(S), -1).astype(np.int32)
        cur = np.int32(10)
    return q_nope, q_rope, ckv, krope, kpos, cur, wk_b


@pytest.mark.parametrize("per_slot", [False, True])
def test_mla_decode_partial_and_attention_match_reference(per_slot):
    rng = np.random.default_rng(2)
    q_nope, q_rope, ckv, krope, kpos, cur, wk_b = _mla_decode_inputs(
        rng, per_slot)
    scale = 24 ** -0.5
    q_eff = np.einsum("bhn,rhn->bhr", q_nope, wk_b)
    want = j_ref.mla_decode_scores_partial(q_eff, q_rope, ckv, krope, kpos,
                                           cur, scale=scale)
    got = t_ref.mla_decode_scores_partial(_t(q_eff), _t(q_rope), _t(ckv),
                                          _t(krope), _t(kpos), _t(cur),
                                          scale=scale)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g, w)
    if per_slot:                          # the empty slot: exact zeros
        assert float(got[0][1].abs().max()) == 0.0
        assert float(got[1][1].abs().max()) == 0.0
        assert bool((got[2][1] == t_ref.NEG_INF).all())
    want = j_da.mla_decode_attention(q_nope, q_rope, ckv, krope, kpos, cur,
                                     wk_b, scale=scale, plan=None)
    got = t_da.mla_decode_attention(_t(q_nope), _t(q_rope), _t(ckv),
                                    _t(krope), _t(kpos), _t(cur), _t(wk_b),
                                    scale=scale)
    assert got.shape == (3, 4, 16) and got.dtype == torch.float32
    _close(got, want)


def test_mla_prefill_matches_reference(cfgs, weights):
    jcfg, tcfg = cfgs
    jp, mod = weights
    rng = np.random.default_rng(3)
    B, S = 2, 19
    x = rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)
    jout, jc = j_attn.mla_apply(jp, x, pos, jcfg, None, None, "prefill")
    with torch.no_grad():
        tout, tc = t_attn.mla_apply(mod, _t(x), _t(pos), tcfg, None,
                                    "prefill")
    _close(tout, jout)
    assert set(tc) == set(jc) == {"ckv", "krope", "kpos"}
    _close(tc["ckv"], jc["ckv"])
    _close(tc["krope"], jc["krope"])
    np.testing.assert_array_equal(tc["kpos"].numpy(), np.asarray(jc["kpos"]))


@pytest.mark.parametrize("per_slot", [False, True])
def test_mla_decode_matches_reference(cfgs, weights, per_slot):
    """Two decode steps after a prefill of 9 rows, on a shared track (one
    position) or per-slot tracks (positions 9 and 5) with the second
    slot's write masked off in the second step."""
    jcfg, tcfg = cfgs
    jp, mod = weights
    rng = np.random.default_rng(4)
    B, S, max_len = 2, 9, 16
    x = rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    _, jpre = j_attn.mla_apply(jp, x, np.arange(S, dtype=np.int32), jcfg,
                               None, None, "prefill")
    jc = j_attn.init_mla_cache(jcfg, B, max_len, jnp.float32)
    jc = {k: v.at[:, :S].set(jpre[k]) for k, v in jc.items()
          if k != "kpos"} | {"kpos": jc["kpos"].at[:S].set(jpre["kpos"])}
    if per_slot:
        kpos = np.full((B, max_len), -1, np.int32)
        kpos[0, :9] = np.arange(9)
        kpos[1, :5] = np.arange(5)
        jc["kpos"] = jnp.asarray(kpos)
    tc = {k: _t(v).clone() for k, v in jc.items()}
    pos = np.array([9, 5], np.int32) if per_slot else np.array([9],
                                                                np.int32)
    for step, mask in enumerate((None, np.array([True, False]))):
        if not per_slot:
            mask = None
        xs = rng.standard_normal((B, 1, tcfg.d_model)).astype(np.float32)
        jout, jc = j_attn.mla_apply(jp, xs, pos, jcfg, None, jc, "decode",
                                    write_mask=mask)
        with torch.no_grad():
            tout, tc = t_attn.mla_apply(
                mod, _t(xs), _t(pos), tcfg, tc, "decode",
                write_mask=None if mask is None else _t(mask))
        _close(tout, jout)
        for k in ("ckv", "krope"):
            _close(tc[k], jc[k])
        np.testing.assert_array_equal(tc["kpos"].numpy(),
                                      np.asarray(jc["kpos"]))
        pos = pos + 1


def test_mla_chunk_mode_raises(cfgs, weights):
    _, tcfg = cfgs
    _, mod = weights
    x = torch.zeros(1, 4, tcfg.d_model)
    with pytest.raises(NotImplementedError, match="chunked prefill"):
        t_attn.mla_apply(mod, x, torch.zeros(1, 4, dtype=torch.int32), tcfg,
                         {}, "chunk")
