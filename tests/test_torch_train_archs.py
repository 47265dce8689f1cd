"""Training on every architecture: the port's ``loss_fn`` and its
gradients against the JAX package's on the same weights.

For each of the ten assigned archs at its float32 reduced size, on
``test_arch_smoke.py``'s batch shape (B = 2, S = 24, tokens or a
frontend's embeddings, three labels of -1): loss, xent, aux and tokens
within 1e-5 of the reference's ``loss_fn``; every gradient leaf (the
reference's ``jax.grad`` mapped to the port's names by
``bridge.state_from_jax``) within 1e-4 of the leaf's max magnitude; and
one AdamW step at lr 1e-2 lowers the port's loss, as in
``test_arch_smoke.py``.

Tolerances: the two packages run the same float32 arithmetic in other
orders (blocked products, Mamba's doubling scan against XLA's associative
scan, the flash backward's chunk sums), a few fp32 ulps per layer on O(1)
losses; 1e-4 of a leaf's largest gradient leaves room for the cancellation
in the small leaves of the reduced models."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import reduced_config as j_reduced
from repro.configs import ASSIGNED
from repro.models import model as JM
from repro_torch.bridge import params_from_jax, state_from_jax
from repro_torch.config import reduced_config as t_reduced
from repro_torch.models import model as TM
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update

LOSS_ATOL = 1e-5
GRAD_REL = 1e-4
B, S = 2, 24


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(cfg, seed: int):
    rng = np.random.default_rng(seed)
    if cfg.frontend:
        b = {"embeddings": rng.normal(size=(B, S, cfg.d_model)).astype(
            np.float32)}
    else:
        b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
            np.int32)}
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[0, :3] = -1
    b["labels"] = labels
    return b


@pytest.fixture(scope="module")
def cases():
    """Per arch, made at first use: (tcfg, numpy batch, the reference's
    loss, metrics and gradients by the port's names, numpy weights)."""
    made = {}

    def get(arch):
        if arch not in made:
            jcfg = dataclasses.replace(j_reduced(arch), dtype="float32")
            tcfg = dataclasses.replace(t_reduced(arch), dtype="float32")
            jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
            batch = _batch(jcfg, ASSIGNED.index(arch))
            jb = {k: jnp.asarray(v) for k, v in batch.items()}
            (loss, metrics), grads = jax.value_and_grad(
                JM.loss_fn, has_aux=True)(jp, jb, jcfg)
            made[arch] = (tcfg, batch, float(loss),
                          {k: float(v) for k, v in metrics.items()},
                          state_from_jax(jax.tree.map(np.asarray, grads),
                                         tcfg),
                          jax.tree.map(np.asarray, jp))
        return made[arch]
    return get


def _port(tcfg, batch, weights):
    model = params_from_jax(weights, tcfg, device="cpu")
    model.requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    return model, tb


@pytest.mark.parametrize("arch", ASSIGNED)
def test_loss_matches_reference(arch, cases):
    tcfg, batch, jloss, jmetrics, _, weights = cases(arch)
    model, tb = _port(tcfg, batch, weights)
    with torch.no_grad():
        loss, metrics = TM.loss_fn(model, tb, tcfg)
    assert abs(float(loss) - jloss) <= LOSS_ATOL, (float(loss), jloss)
    for k in ("xent", "aux", "tokens"):
        assert abs(float(metrics[k]) - jmetrics[k]) <= LOSS_ATOL, k
    assert float(metrics["tokens"]) == B * S - 3
    if tcfg.moe:
        assert float(metrics["aux"]) > 0


@pytest.mark.parametrize("arch", ASSIGNED)
def test_gradients_match_reference(arch, cases):
    tcfg, batch, _, _, jgrads, weights = cases(arch)
    model, tb = _port(tcfg, batch, weights)
    loss, _ = TM.loss_fn(model, tb, tcfg)
    named = dict(model.named_parameters())
    assert set(named) == set(jgrads)
    gs = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    for (name, p), g in zip(named.items(), gs):
        want = jgrads[name]
        got = np.zeros_like(want) if g is None else g.numpy()
        assert got.shape == want.shape, name
        assert np.isfinite(got).all(), name
        scale = max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(got - want).max())
        assert err <= GRAD_REL * scale, (name, err, scale)


@pytest.mark.parametrize("arch", ASSIGNED)
def test_one_adamw_step_lowers_the_loss(arch, cases):
    tcfg, batch, _, _, _, weights = cases(arch)
    model, tb = _port(tcfg, batch, weights)
    loss, _ = TM.loss_fn(model, tb, tcfg)
    named = dict(model.named_parameters())
    gs = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    grads = {n: torch.zeros_like(p) if g is None else g
             for (n, p), g in zip(named.items(), gs)}
    ocfg = AdamWConfig(lr=1e-2)
    opt = adamw_init(named, ocfg)
    adamw_update(named, grads, opt, ocfg)
    assert int(opt["step"]) == 1
    with torch.no_grad():
        loss2, _ = TM.loss_fn(model, tb, tcfg)
    assert float(loss2) < float(loss.detach()), (float(loss2),
                                                 float(loss.detach()))
