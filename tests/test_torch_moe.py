"""The port's MoE (repro_torch.models.moe and the ``"moe"`` block) against
the JAX package on the same inputs, at the reduced llama4-scout config (8
experts of d_ff 32, top-1, one shared expert) and a top-2 variant: the
router's gates, experts and probabilities (an exact tie goes to the lower
expert id, as ``jax.lax.top_k``), the load-balancing loss, ``dense_moe``
and the shared-expert sum, in float32 and bfloat16; the init's
distribution; and the refusal of expert parallelism, which is not
ported.

Tolerances: float32 within 1e-5 (the same products summed in another
order).  bfloat16: both packages round the same intermediates (g, u, the
fp32 silu cast back, h, the expert outputs, the combine) to bfloat16, so
they part only where an fp32 sum in another order rounds to the
neighbouring bfloat16 value; such a flip moves a value by one ulp and
reaches the output through one more product, so the outputs agree within
4 bf16 ulps of the largest output (4 * 2**-8 * max|y|)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import reduced_config as j_reduced
from repro.models import blocks as j_blocks
from repro.models import model as JM
from repro.models import moe as j_moe
from repro.models.layers import KeyGen
from repro_torch import sharding as sh
from repro_torch.config import reduced_config as t_reduced
from repro_torch.models import blocks as t_blocks
from repro_torch.models import model as TM
from repro_torch.models import moe as t_moe

ARCH = "llama4-scout-17b-a16e"
F32_ATOL = 1e-5
BF16_ULPS = 4
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(top_k, dtype="float32"):
    jcfg = dataclasses.replace(j_reduced(ARCH), dtype=dtype)
    tcfg = dataclasses.replace(t_reduced(ARCH), dtype=dtype)
    if top_k != jcfg.moe.top_k:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, top_k=top_k))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe, top_k=top_k))
    return jcfg, tcfg


def _params(jcfg, dtype):
    """The reference's MoE weights as numpy, and both packages' tensors."""
    jp = j_moe.moe_params(jcfg, KeyGen(jax.random.PRNGKey(3)), dtype[0])
    arrs = {k: np.asarray(v) for k, v in jp.items()}
    tp = {k: torch.from_numpy(np.array(v, np.float32)).to(
        torch.float32 if k == "router" else dtype[1])
        for k, v in arrs.items()}
    return jp, tp


def _x(jcfg, dtype, seed=0, shape=(3, 7)):
    x = np.random.default_rng(seed).standard_normal(
        shape + (jcfg.d_model,)).astype(np.float32)
    return jnp.asarray(x, dtype[0]), torch.from_numpy(x).to(dtype[1])


def _close(got, want, dtype_name):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert np.isfinite(got).all()
    if dtype_name == "float32":
        atol = F32_ATOL
    else:
        atol = BF16_ULPS * 2.0 ** -8 * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def test_reduced_config_is_the_reference_llama4():
    jcfg, tcfg = _cfgs(1)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    m = tcfg.moe
    assert (m.num_experts, m.top_k, m.num_shared_experts, m.d_ff_expert) \
        == (8, 1, 1, 32)
    assert tcfg.layer_pattern == ("moe", "moe")


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_router_matches_reference(top_k, dtype_name):
    dtype = DTYPES[dtype_name]
    jcfg, tcfg = _cfgs(top_k, dtype_name)
    jp, tp = _params(jcfg, dtype)
    jx, tx = _x(jcfg, dtype)
    jg, je, jpr = j_moe._router(jp, jx, jcfg)
    tg, te, tpr = t_moe._router(tp["router"], tx, tcfg)
    assert tg.dtype == tpr.dtype == torch.float32
    assert te.tolist() == np.asarray(je).tolist()
    np.testing.assert_allclose(tpr.numpy(), np.asarray(jpr), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tg.sum(-1).numpy(), 1.0, atol=1e-6)
    aux_t = t_moe.aux_load_loss(tpr, te, tcfg)
    aux_j = j_moe.aux_load_loss(jpr, je, jcfg)
    np.testing.assert_allclose(float(aux_t), float(aux_j), atol=1e-6,
                               rtol=1e-6)


@pytest.mark.parametrize("top_k", [1, 2])
def test_router_exact_ties_go_to_the_lower_expert(top_k):
    """Router columns 5 and 2 equal and largest, 6 and 1 equal next: the
    logits are exact in any summation order (multiples of 0.5), so the
    ties are exact, and both packages pick 2 before 5 (and 1 before 6)."""
    jcfg, tcfg = _cfgs(top_k)
    d, e = jcfg.d_model, jcfg.moe.num_experts
    rng = np.random.default_rng(7)
    x = rng.integers(1, 3, (4, d)).astype(np.float32)
    router = np.full((d, e), -0.5, np.float32)
    router[:, 2] = router[:, 5] = 1.0
    router[:, 1] = router[:, 6] = 0.5
    jg, je, _ = j_moe._router({"router": jnp.asarray(router)},
                              jnp.asarray(x), jcfg)
    tg, te, _ = t_moe._router(torch.from_numpy(router), torch.from_numpy(x),
                              tcfg)
    want = [[2], [2, 5]][top_k - 1]
    assert np.asarray(je).tolist() == [want] * 4
    assert te.tolist() == [want] * 4
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    # an all-zero router: every expert ties, the lowest ids win
    zero = np.zeros((d, e), np.float32)
    _, je, jpr = j_moe._router({"router": jnp.asarray(zero)}, jnp.asarray(x),
                               jcfg)
    _, te, tpr = t_moe._router(torch.from_numpy(zero), torch.from_numpy(x),
                               tcfg)
    assert te.tolist() == np.asarray(je).tolist() == \
        [list(range(top_k))] * 4
    np.testing.assert_array_equal(tpr.numpy(), np.asarray(jpr))


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_dense_moe_matches_reference(top_k, dtype_name):
    dtype = DTYPES[dtype_name]
    jcfg, tcfg = _cfgs(top_k, dtype_name)
    jp, tp = _params(jcfg, dtype)
    jx, tx = _x(jcfg, dtype, seed=top_k)
    routed = ("router", "we_gate", "we_up", "we_down")
    jy, jaux = j_moe.dense_moe({k: jp[k] for k in routed}, jx, jcfg)
    ty, taux = t_moe.dense_moe({k: tp[k] for k in routed}, tx, tcfg)
    assert ty.shape == tx.shape and ty.dtype == tx.dtype
    _close(ty, jy, dtype_name)
    np.testing.assert_allclose(float(taux), float(jaux), atol=1e-6,
                               rtol=1e-6)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_apply_moe_adds_the_shared_expert(dtype_name):
    """The block's MoE (routed experts + the shared expert's gated MLP)
    against the reference's ``apply_moe`` without a mesh, and against the
    routed part plus the shared MLP computed apart."""
    dtype = DTYPES[dtype_name]
    jcfg, tcfg = _cfgs(1, dtype_name)
    jp, tp = _params(jcfg, dtype)
    jx, tx = _x(jcfg, dtype, seed=5)
    moe = t_blocks.MoE(tcfg, dtype[1], "cpu")
    with torch.no_grad():
        for k, v in tp.items():
            getattr(moe, k).copy_(v)
    assert moe.router.dtype == torch.float32
    jy, _ = j_blocks.apply_moe(jp, jx, jcfg, JM.LOCAL, "prefill")
    with torch.no_grad():
        ty, _ = t_blocks.apply_moe(moe, tx, tcfg)
        routed, _ = t_moe.dense_moe(tp, tx, tcfg)
        shared = t_blocks.swiglu(tx, tp["ws_gate"], tp["ws_up"],
                                 tp["ws_down"])
    _close(ty, jy, dtype_name)
    assert torch.equal(ty, routed + shared)
    assert shared.abs().max() > 0


class _FakeMesh:
    """A stand-in DeviceMesh with axes ("data", "model") of the given
    sizes: apply_moe reads only the model axis's size."""

    def __init__(self, data, model):
        self.mesh_dim_names = ("data", "model")
        self._sizes = (data, model)

    def size(self, i):
        return self._sizes[i]


@pytest.mark.parametrize("model_ranks,raises", [
    (2, True), (4, True), (8, True), (1, False), (3, False)])
def test_expert_parallel_recipe_is_refused(model_ranks, raises):
    """A recipe whose model axis has more than one rank dividing the
    experts is where the reference takes expert parallelism (its plans
    keep ``ep`` on): the port takes it too, in serving and, no longer
    refused, in training — the all_to_all route for a prefill or train
    step whose sequence the axis divides, the psum route in decode or
    where it does not.  Elsewhere (one rank, a rank count that does not
    divide 8 experts) the reference runs dense_moe, and so does the port,
    in every mode.  The expert-parallel routes' numbers are held to the
    reference on gloo meshes in ``test_torch_sharded_blocks.py`` (serve)
    and ``test_torch_sharded_train.py`` (the loss and its gradients)."""
    jcfg, tcfg = _cfgs(1)
    _, tp = _params(jcfg, DTYPES["float32"])
    moe = t_blocks.MoE(tcfg, torch.float32, "cpu")
    with torch.no_grad():
        for k, v in tp.items():
            getattr(moe, k).copy_(v)
    plan = sh.ParallelPlan(mesh=_FakeMesh(1, model_ranks),
                           data_axes=("data",), model_axis="model")
    recipe = sh.ShardingRecipe(plan=plan, batch_axes=(), seq_axes=())
    x = torch.zeros((2, 3, tcfg.d_model))
    if raises:
        for mode in ("prefill", "train"):
            assert t_blocks.moe_route(tcfg, recipe, mode, 3) == "ep_decode"
            assert t_blocks.moe_route(tcfg, recipe, mode,
                                      model_ranks) == "ep_prefill"
        assert t_blocks.moe_route(tcfg, recipe, "decode",
                                  model_ranks) == "ep_decode"
    else:
        for mode in ("train", "prefill", "decode"):
            assert t_blocks.moe_route(tcfg, recipe, mode, 3) == "dense"
        y, _ = t_blocks.apply_moe(moe, x, tcfg, recipe)
        assert y.shape == x.shape


def test_init_draws_the_reference_distribution():
    """A bf16 LM keeps its routers in float32; the expert stacks take
    std E ** -0.5 (dense_init's fan-in is their first axis, the expert
    count) and the router d_model ** -0.5, each times 0.8796, the std of a
    unit normal truncated to [-2, 2] — the reference's draws, measured on
    the reference's own init at the same shapes."""
    tcfg = t_reduced(ARCH)
    jcfg = j_reduced(ARCH)
    model = TM.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    e, d = tcfg.moe.num_experts, tcfg.d_model
    trunc = 0.8796
    for i, b in enumerate(model.blocks):
        assert b.moe.router.dtype == torch.float32
        assert b.moe.we_gate.dtype == torch.bfloat16
        assert float(b.moe.router.std()) == pytest.approx(
            trunc * d ** -0.5, rel=0.1)
        for name in ("we_gate", "we_up", "we_down"):
            std = float(getattr(b.moe, name).float().std())
            ref = float(np.asarray(jp["blocks"]["b0"]["moe"][name][i],
                                   np.float32).std())
            assert std == pytest.approx(trunc * e ** -0.5, rel=0.05)
            assert std == pytest.approx(ref, rel=0.05)
    assert jp["blocks"]["b0"]["moe"]["router"].dtype == jnp.float32
    assert TM.count_params(tcfg) == JM.count_params(jcfg)
    assert TM.count_params(tcfg, active_only=True) == \
        JM.count_params(jcfg, active_only=True)
