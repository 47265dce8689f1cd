"""The recurrent mixers in train mode: the port's Mamba, mLSTM and sLSTM
(``repro_torch.models.ssm``) recompute each chunk in the backward, as the
reference's checkpointed chunk bodies do (``repro/models/ssm.py``).

(a) Outputs and gradients (the input's and every weight's) in float32
    against ``jax.grad`` of the reference's ``*_apply(mode="train")`` on
    the same weights: Mamba at the reduced hymba-1.5b config, mLSTM and
    sLSTM at the reduced xlstm-125m config, ``chunk_size`` 8 and S = 37
    (four whole chunks and a ragged tail).  Tolerances: outputs 1e-5
    absolute and relative (``tests/test_torch_ssm.py``'s: the same fp32
    arithmetic summed in another order), each gradient within 1e-4 of its
    largest magnitude (``tests/test_torch_train_archs.py``'s).
(b) The bytes saved for the backward (``saved_tensors_hooks``, distinct
    storages, the weights and the input left out) stay per chunk: doubling
    ``chunk_size`` at fixed S moves Mamba's total by at most 10%, and
    doubling S at fixed ``chunk_size`` at most doubles each mixer's total,
    plus 10%.  Without the per-chunk recompute Mamba keeps every level of
    its doubling scan, 2·log2(L) + 2 tensors of (B, L, d_in, N) a chunk.
(c) The HBM bytes that ``analysis/op_trace`` counts for one sLSTM forward
    and backward grow by at most 2.2x from S = 64 to S = 128: the rows are
    taken with one ``unbind`` a chunk, so the backward writes one stacked
    gradient, where a row read as ``xg[:, t]`` writes a whole (B, S, 4d)
    gradient for every row.
(d) The chunk checkpoints nest inside the per-block remat: the reduced
    hymba-1.5b and xlstm-125m give the same loss and gradients, bit for
    bit, with ``remat`` "dots" as with "none"; and under the remat a
    block keeps only its input past the forward (the storages live after
    it grow by one (B, S, D) input a block), not its chunks' states.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import reduced_config as j_reduced
from repro.models import ssm as j_ssm
from repro.models.layers import KeyGen
from repro_torch.analysis.op_trace import OpRecorder, totals
from repro_torch.config import reduced_config as t_reduced
from repro_torch.models import model as TM
from repro_torch.models import ssm as t_ssm

ATOL = 1e-5
GRAD_REL = 1e-4
CHUNK = 8
S = 37
B = 2
KINDS = {  # kind -> (arch, JAX params fn, port module, JAX apply, port apply)
    "mamba": ("hymba-1.5b", j_ssm.mamba_params, t_ssm.Mamba,
              j_ssm.mamba_apply, t_ssm.mamba_apply),
    "mlstm": ("xlstm-125m", j_ssm.mlstm_params, t_ssm.MLSTM,
              j_ssm.mlstm_apply, t_ssm.mlstm_apply),
    "slstm": ("xlstm-125m", j_ssm.slstm_params, t_ssm.SLSTM,
              j_ssm.slstm_apply, t_ssm.slstm_apply),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _chunked(cfg, chunk: int):
    return dataclasses.replace(cfg, dtype="float32", ssm=dataclasses.replace(
        cfg.ssm, chunk_size=chunk))


def _mixer(kind: str, chunk: int = CHUNK):
    """(jcfg, tcfg, JAX params, the port's module on them).  The
    zero-initialised scales and biases are redrawn small, so every
    parameter takes part."""
    arch, jparams, tmod, _, _ = KINDS[kind]
    jcfg = _chunked(j_reduced(arch), chunk)
    tcfg = _chunked(t_reduced(arch), chunk)
    rng = np.random.default_rng(list(KINDS).index(kind))
    jp = jparams(jcfg, KeyGen(jax.random.PRNGKey(3)), jnp.float32)
    jp = {k: (v + jnp.asarray(rng.standard_normal(v.shape) * 0.1, v.dtype)
              if k in ("conv_b", "out_norm", "dt_bias") else v)
          for k, v in jp.items()}
    mod = tmod(tcfg, torch.float32, "cpu")
    assert set(dict(mod.named_parameters())) == set(jp)
    with torch.no_grad():
        for k, v in jp.items():
            getattr(mod, k).copy_(torch.from_numpy(np.array(v)))
    mod.requires_grad_(True)
    return jcfg, tcfg, jp, mod


@pytest.mark.parametrize("kind", list(KINDS))
def test_train_mode_matches_reference_gradients(kind):
    """(a): y and d(sum(y * w))/d(x, every weight) against jax.grad."""
    jcfg, tcfg, jp, mod = _mixer(kind)
    japply, tapply = KINDS[kind][3], KINDS[kind][4]
    assert S % CHUNK and S // CHUNK == 4
    rng = np.random.default_rng(10 + list(KINDS).index(kind))
    x = rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    w = rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32)

    def jloss(params, xs):
        y, cache = japply(params, xs, jcfg, None, None, "train")
        assert cache is None
        return jnp.sum(y * w), y

    (_, jy), (jg, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    ty, cache = tapply(mod, tx, tcfg, None, "train")
    assert cache is None
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               atol=ATOL, rtol=ATOL)
    named = dict(mod.named_parameters())
    grads = torch.autograd.grad((ty * torch.from_numpy(w)).sum(),
                                [tx] + list(named.values()))
    want = {"x": np.asarray(jgx), **{k: np.asarray(jg[k]) for k in named}}
    for name, g in zip(want, grads):
        got = g.numpy()
        assert got.shape == want[name].shape and np.isfinite(got).all(), name
        scale = max(float(np.abs(want[name]).max()), 1e-30)
        err = float(np.abs(got - want[name]).max())
        assert err <= GRAD_REL * scale, (kind, name, err, scale)


def _saved_bytes(kind: str, chunk: int, seq: int) -> int:
    """Bytes of the distinct storages that one train-mode forward saves
    for its backward, less the weights' and the input's."""
    _, tcfg, _, mod = _mixer(kind, chunk)
    x = torch.randn(B, seq, tcfg.d_model,
                    generator=torch.Generator().manual_seed(seq),
                    requires_grad=True)
    skip = {p.untyped_storage()._cdata for p in mod.parameters()}
    skip.add(x.untyped_storage()._cdata)
    seen = {}

    def pack(t):
        st = t.untyped_storage()
        if st._cdata not in skip:
            seen[st._cdata] = st.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y, _ = KINDS[kind][4](mod, x, tcfg, None, "train")
    y.sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
    return sum(seen.values())


def test_mamba_saved_bytes_do_not_grow_with_the_chunk():
    """(b): the scan's levels are recomputed, not kept."""
    small, large = _saved_bytes("mamba", CHUNK, S), \
        _saved_bytes("mamba", 2 * CHUNK, S)
    assert small > 0
    assert abs(large / small - 1) <= 0.10, (small, large)


@pytest.mark.parametrize("kind", list(KINDS))
def test_saved_bytes_grow_at_most_linearly_in_the_sequence(kind):
    """(b): twice the rows at the same chunk size keep at most twice the
    bytes, plus 10%."""
    one, two = _saved_bytes(kind, CHUNK, S), _saved_bytes(kind, CHUNK, 2 * S)
    assert 0 < one < two <= 2.2 * one, (kind, one, two)


def _slstm_counted_bytes(seq: int) -> float:
    _, tcfg, _, mod = _mixer("slstm")
    x = torch.randn(B, seq, tcfg.d_model,
                    generator=torch.Generator().manual_seed(seq),
                    requires_grad=True)
    rec = OpRecorder()
    with rec:
        y, _ = t_ssm.slstm_apply(mod, x, tcfg, None, "train")
        y.sum().backward()
    return totals(rec.records).hbm_bytes


def test_slstm_counted_bytes_grow_linearly():
    """(c): one forward and backward at 128 rows against 64."""
    one, two = _slstm_counted_bytes(64), _slstm_counted_bytes(128)
    assert 0 < one < two <= 2.2 * one, (one, two, two / one)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "xlstm-125m"])
def test_block_remat_nests_the_chunk_checkpoints(arch):
    """(d): loss and every gradient leaf equal with and without remat."""
    rng = np.random.default_rng(7)
    base = _chunked(t_reduced(arch), CHUNK)
    batch = {k: torch.from_numpy(rng.integers(0, base.vocab_size, (B, S)))
             for k in ("tokens", "labels")}
    got = []
    for remat in ("none", "dots"):
        cfg = dataclasses.replace(base, remat=remat)
        model = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        model.requires_grad_(True)
        loss, _ = TM.loss_fn(model, batch, cfg)
        named = dict(model.named_parameters())
        got.append((loss.detach(), torch.autograd.grad(
            loss, list(named.values()))))
    (l0, g0), (l1, g1) = got
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def _live_after_forward(arch: str, layers: int) -> int:
    """Bytes of the storages that the forward of ``loss_fn`` allocates and
    leaves alive for the backward, under remat "dots"."""
    cfg = dataclasses.replace(_chunked(t_reduced(arch), CHUNK),
                              remat="dots", num_layers=layers)
    model = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    model.requires_grad_(True)
    batch = {k: torch.zeros((B, S), dtype=torch.long)
             for k in ("tokens", "labels")}
    rec = OpRecorder()
    with rec:
        loss, _ = TM.loss_fn(model, batch, cfg)
        live = rec.live_bytes
        loss.backward()
    return live


@pytest.mark.parametrize("arch", ["hymba-1.5b", "xlstm-125m"])
def test_block_remat_keeps_only_block_inputs(arch):
    """(d): two more blocks keep two more block inputs alive, and nothing
    of their chunks (mLSTM's state is (B, nh, dh, dh) a chunk)."""
    width = t_reduced(arch).d_model
    extra = _live_after_forward(arch, 4) - _live_after_forward(arch, 2)
    assert 0 < extra <= 2 * B * S * width * 4 * 1.1, (arch, extra)
