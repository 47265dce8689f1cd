"""The port's recurrent mixers (repro_torch.models.ssm) against the JAX
package's (repro.models.ssm) on the same weights and inputs, in float32:
Mamba at the reduced hymba-1.5b config, mLSTM and sLSTM at the reduced
xlstm-125m config (chunk size 16).  Prefill at S = 21 (not a multiple of
the chunk size, so the last chunk is ragged), from zero state and from a
given state, with the state it returns; then decode steps chained from
that state, outputs and states.  Also the port's own oracles: chained
``mlstm_step_ref`` steps against the chunkwise form, and the doubling
scan against a sequential scan.

Tolerance: 1e-5 absolute on outputs and states of O(1) (the same float32
arithmetic summed in another order: Mamba's doubling scan against XLA's
associative scan, mLSTM's chunk products against XLA's).  The mLSTM
matrix memory ``C`` grows to O(10) over 21 steps, so states are compared
at 1e-5 relative as well."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import reduced_config as j_reduced
from repro.models import ssm as j_ssm
from repro.models.layers import KeyGen
from repro_torch.config import reduced_config as t_reduced
from repro_torch.models import ssm as t_ssm

ATOL = 1e-5
S = 21
KINDS = {  # kind -> (arch, JAX params fn, port module, JAX apply, port apply)
    "mamba": ("hymba-1.5b", j_ssm.mamba_params, t_ssm.Mamba,
              j_ssm.mamba_apply, t_ssm.mamba_apply),
    "mlstm": ("xlstm-125m", j_ssm.mlstm_params, t_ssm.MLSTM,
              j_ssm.mlstm_apply, t_ssm.mlstm_apply),
    "slstm": ("xlstm-125m", j_ssm.slstm_params, t_ssm.SLSTM,
              j_ssm.slstm_apply, t_ssm.slstm_apply),
}


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, name=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=ATOL, err_msg=name)


def _states_close(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == _t(want[k]).dtype, k
        _close(got[k], want[k], k)


@pytest.fixture(scope="module")
def mixers():
    """Per kind: (jcfg, tcfg, JAX params, the port's module on them).  The
    zero-initialised scales and biases are redrawn small, so every
    parameter takes part."""
    out = {}
    rng = np.random.default_rng(0)
    for kind, (arch, jparams, tmod, _, _) in KINDS.items():
        jcfg = dataclasses.replace(j_reduced(arch), dtype="float32")
        tcfg = dataclasses.replace(t_reduced(arch), dtype="float32")
        jp = jparams(jcfg, KeyGen(jax.random.PRNGKey(1)), jnp.float32)
        jp = {k: (v + jnp.asarray(rng.standard_normal(v.shape) * 0.1,
                                  v.dtype)
                  if k in ("conv_b", "out_norm", "dt_bias") else v)
              for k, v in jp.items()}
        mod = tmod(tcfg, torch.float32, "cpu")
        assert set(dict(mod.named_parameters())) == set(jp)
        with torch.no_grad():
            for k, v in jp.items():
                getattr(mod, k).copy_(_t(v))
        out[kind] = (jcfg, tcfg, jp, mod)
    return out


@pytest.mark.parametrize("kind", list(KINDS))
def test_prefill_then_decode_match_reference(mixers, kind):
    """Prefill 21 rows from zero state, then 3 decode steps from its
    state, then a second prefill of 21 rows from the state the decode
    left: outputs and states at every stage."""
    jcfg, tcfg, jp, mod = mixers[kind]
    _, _, _, japply, tapply = KINDS[kind]
    rng = np.random.default_rng(list(KINDS).index(kind))
    B, D = 2, tcfg.d_model
    assert S % tcfg.ssm.chunk_size and S > tcfg.ssm.chunk_size
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    jy, jc = japply(jp, x, jcfg, None, None, "prefill")
    with torch.no_grad():
        ty, tc = tapply(mod, _t(x), tcfg, None, "prefill")
    _close(ty, jy, "prefill out")
    _states_close(tc, jc)
    for step in range(3):
        xs = rng.standard_normal((B, 1, D)).astype(np.float32)
        jy, jc = japply(jp, xs, jcfg, None, jc, "decode")
        with torch.no_grad():
            before = {k: v for k, v in tc.items()}
            ty, tc2 = tapply(mod, _t(xs), tcfg, tc, "decode")
        assert tc2 is tc and all(tc[k] is before[k] for k in tc), \
            "decode updates the given cache in place"
        _close(ty, jy, f"decode {step} out")
        _states_close(tc, jc)
    jy, jc = japply(jp, x, jcfg, None, jc, "prefill")
    with torch.no_grad():
        ty, tc = tapply(mod, _t(x), tcfg, tc, "prefill")
    _close(ty, jy, "prefill from a state")
    _states_close(tc, jc)


def test_mlstm_step_chain_equals_chunkwise():
    """The per-step form chained over 21 steps equals the chunkwise form
    over chunks of 8 (the last ragged), outputs and final state."""
    rng = np.random.default_rng(5)
    B, L, nh, dh = 2, 21, 3, 8
    f = lambda *s: torch.from_numpy(   # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    q, k, v = f(B, L, nh, dh), f(B, L, nh, dh), f(B, L, nh, dh)
    li = f(B, L, nh)
    lf = torch.nn.functional.logsigmoid(f(B, L, nh) + 2.0)
    state0 = (f(B, nh, dh, dh) * 0.1, f(B, nh, dh) * 0.1, f(B, nh) * 0.1)
    st, hs = state0, []
    for t in range(L):
        h, st = t_ssm.mlstm_step_ref(q[:, t], k[:, t], v[:, t], li[:, t],
                                     lf[:, t], st)
        hs.append(h)
    want_h = torch.stack(hs, dim=1)
    pad = (-L) % 8
    padt = lambda t, val=0.0: torch.nn.functional.pad(   # noqa: E731
        t, (0, 0) * (t.dim() - 2) + (0, pad), value=val)
    qp, kp, vp, lfp, lip = padt(q), padt(k), padt(v), padt(lf), \
        padt(li, -1e30)
    ck, hs = state0, []
    for c0 in range(0, L + pad, 8):
        sl = slice(c0, c0 + 8)
        ck, h = t_ssm._mlstm_chunk(ck, qp[:, sl], kp[:, sl], vp[:, sl],
                                   lip[:, sl], lfp[:, sl])
        hs.append(h)
    got_h = torch.cat(hs, dim=1)[:, :L]
    np.testing.assert_allclose(got_h.numpy(), want_h.numpy(), atol=1e-4,
                               rtol=1e-4)
    # the stabiliser m differs between the forms; C and n only up to the
    # common factor exp(m), so compare the normalised state
    for a, b in zip(ck[:2], st[:2]):
        sa = torch.exp(ck[2]).reshape(ck[2].shape + (1,) * (a.dim() - 2))
        sb = torch.exp(st[2]).reshape(st[2].shape + (1,) * (b.dim() - 2))
        np.testing.assert_allclose((a * sa).numpy(), (b * sb).numpy(),
                                   atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("L", [1, 2, 7, 16, 37])
def test_doubling_scan_equals_sequential_scan(L):
    rng = np.random.default_rng(L)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, L, 3, 4)).astype(
        np.float32))
    b = torch.from_numpy(rng.standard_normal((2, L, 3, 4)).astype(
        np.float32))
    h0 = torch.from_numpy(rng.standard_normal((2, 3, 4)).astype(np.float32))
    want, h = [], h0
    for t in range(L):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    acc, hs = t_ssm.doubling_scan(a.clone(), b.clone())
    got = acc * h0[:, None] + hs
    np.testing.assert_allclose(got.numpy(), torch.stack(want, 1).numpy(),
                               atol=1e-5, rtol=1e-5)
