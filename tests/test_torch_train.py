"""The port's training slice against the JAX package on the CPU: the flash
forward with its log-sum-exp and the differentiable flash op, AdamW and
the cosine schedule, the chunked cross-entropy, ``build_train_step``, the
data pipeline, checkpoints and restart-exact resume, and the failure
injector behind the train CLI.  Same numpy inputs from a seed on both
sides; every tolerance is stated where it is used (float32 throughout)."""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import reduced_config as j_reduced
from repro.core import embedding as j_emb
from repro.data import pipeline as j_pipe
from repro.kernels import flash_attention as j_flash
from repro.kernels import ref as j_ref
from repro.launch import steps as j_steps
from repro.models import model as JM
from repro.optim import adamw as j_adamw
from repro.optim import schedule as j_sched
from repro_torch.bridge import params_from_jax, state_from_jax
from repro_torch.checkpoint import checkpoint as t_ckpt
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.config import ShapeConfig
from repro_torch.config import reduced_config as t_reduced
from repro_torch.core import embedding as t_emb
from repro_torch.data import pipeline as t_pipe
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref
from repro_torch.launch import elastic
from repro_torch.launch import steps as t_steps
from repro_torch.launch import train as t_train_cli
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               clip_by_global_norm, cosine_schedule)
from repro_torch.sharding import make_plan, make_recipe
from repro_torch.train.train_loop import TrainConfig, train

# (B, Sq, Skv, H, Hkv, dh, dv, window, q_offset, chunk): GQA groups 1, 4
# and 5, Sq not a multiple of the chunk, a window with q_offset, MLA's
# qk 192 / v 128, and rows that see no key at all (q_offset past Skv's
# window)
FLASH_CASES = {
    "group1": (2, 40, 40, 4, 4, 16, 16, None, 0, 16),
    "group4": (2, 40, 40, 8, 2, 16, 16, None, 0, 16),
    "group5": (1, 33, 33, 10, 2, 16, 16, None, 0, 16),
    "window_qoffset": (2, 24, 56, 4, 2, 16, 16, 20, 32, 16),
    "qk192_v128": (1, 20, 20, 2, 2, 192, 128, None, 0, 8),
    "empty_rows": (1, 8, 24, 2, 1, 16, 16, 8, 40, 8),
}
FWD_ATOL = 1e-5          # fp32 forward: same online softmax, other sums
GRAD_REL = 1e-5          # of each gradient's max magnitude


def _qkv(case, seed=0):
    B, Sq, Skv, H, Hkv, dh, dv, *_ = case
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Sq, H, dh)).astype(np.float32),
            rng.normal(size=(B, Skv, Hkv, dh)).astype(np.float32),
            rng.normal(size=(B, Skv, Hkv, dv)).astype(np.float32),
            rng.normal(size=(B, Sq, H, dv)).astype(np.float32))


def _kw(case):
    *_, window, q_offset, chunk = case
    return dict(causal=True, window=window, q_offset=q_offset,
                q_chunk=chunk, kv_chunk=chunk)


@pytest.mark.parametrize("name", sorted(FLASH_CASES))
def test_flash_forward_with_lse_matches_reference(name):
    """``ref.chunked_attention(return_lse=True)`` against the reference's
    ``_flash_fwd_impl`` (out and lse), and out against the Pallas kernel
    in interpret mode where it runs (uniform head dims, every row seeing
    a key)."""
    case = FLASH_CASES[name]
    q, k, v, _ = _qkv(case)
    kw = _kw(case)
    out, lse = t_ref.chunked_attention(*map(torch.from_numpy, (q, k, v)),
                                       return_lse=True, **kw)
    jout, jlse = j_ref.chunked_attention(*map(jnp.asarray, (q, k, v)),
                                         return_lse=True, **kw)
    assert out.shape == jout.shape and lse.shape == jlse.shape
    assert lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0,
                               atol=FWD_ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=1e-6,
                               atol=FWD_ATOL)
    plain = t_ref.chunked_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    assert torch.equal(plain, out)
    if name in ("qk192_v128", "empty_rows"):
        return
    pallas = j_flash.flash_attention(*map(jnp.asarray, (q, k, v)),
                                     window=kw["window"],
                                     q_offset=kw["q_offset"], interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), rtol=0,
                               atol=FWD_ATOL)


def _close_rel(got, want, rel, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (what, err, scale)


@pytest.mark.parametrize("name", sorted(FLASH_CASES))
def test_flash_gradients_match_reference_vjp(name):
    """dq, dk, dv of the differentiable ``ops.flash_attention`` (the plain
    forward with lse, then ``ref.flash_attention_bwd``) against
    ``jax.vjp`` of the reference's ``chunked_attention`` (its custom_vjp)
    on the same cotangent, and against autograd through
    ``ref.naive_attention`` where every row sees a key."""
    case = FLASH_CASES[name]
    q, k, v, dout = _qkv(case, seed=1)
    kw = _kw(case)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    t_ops.reset_launch_counts()
    out = t_ops.flash_attention(tq, tk, tv, **kw)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(dout))
    assert sum(t_ops.launch_counts().values()) == 0
    jfn = lambda a, b, c: j_ref.chunked_attention(a, b, c, **kw)  # noqa
    _, vjp = jax.vjp(jfn, *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(dout))
    for g, w, what in zip(got, want, "qkv"):
        assert g.shape == w.shape
        _close_rel(g.numpy(), np.asarray(w), GRAD_REL, f"d{what} vs vjp")
    if name == "empty_rows":
        return
    nq, nk, nv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    nout = t_ref.naive_attention(nq, nk, nv, causal=True,
                                 window=kw["window"], q_offset=kw["q_offset"])
    naive = torch.autograd.grad(nout, (nq, nk, nv), torch.from_numpy(dout))
    for g, w, what in zip(got, naive, "qkv"):
        _close_rel(g.numpy(), w.numpy(), GRAD_REL, f"d{what} vs naive")


def test_flash_without_grad_is_the_plain_forward():
    """Grad off, or no input requiring it: the forward alone (no autograd
    node, no lse) — what every serve path runs."""
    q, k, v, _ = _qkv(FLASH_CASES["group4"])
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    kw = _kw(FLASH_CASES["group4"])
    out = t_ops.flash_attention(tq, tk, tv, **kw)
    assert out.grad_fn is None
    tq.requires_grad_(True)
    with torch.no_grad():
        out2 = t_ops.flash_attention(tq, tk, tv, **kw)
    assert out2.grad_fn is None and torch.equal(out, out2)


# --- optimizer and schedule --------------------------------------------------

OPT_ATOL = 1e-6


def _opt_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w1": rng.normal(size=(4, 3)).astype(np.float32),
            "w2": rng.normal(size=(5,)).astype(np.float32),
            "w3": rng.normal(size=(2, 3, 2)).astype(np.float32)}


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_matches_reference_three_steps(state_dtype):
    """Three steps from the same weights and gradients, the clip active
    (global norm ~ 5 against clip_norm 0.5): parameters and grad_norm
    within 1e-6; with bf16 moments, the moments within one bf16 ulp (the
    same fp32 value may round to a neighbour after a last-bit
    difference)."""
    cfg = AdamWConfig(lr=1e-2, clip_norm=0.5, state_dtype=state_dtype)
    jcfg = j_adamw.AdamWConfig(lr=1e-2, clip_norm=0.5,
                               state_dtype=state_dtype)
    w = _opt_tree(0)
    jp = {k: jnp.asarray(a) for k, a in w.items()}
    jstate = j_adamw.adamw_init(jp, jcfg)
    tp = {k: torch.from_numpy(a.copy()) for k, a in w.items()}
    tstate = adamw_init(tp, cfg)
    for step in range(3):
        g = _opt_tree(10 + step)
        scale = j_sched.cosine_schedule(step, warmup=1, total=5)
        jp, jstate, jm = j_adamw.adamw_update(
            jp, {k: jnp.asarray(a) for k, a in g.items()}, jstate, jcfg,
            scale)
        tm = adamw_update(tp, {k: torch.from_numpy(a) for k, a in g.items()},
                          tstate, cfg,
                          cosine_schedule(tstate["step"], warmup=1, total=5))
        assert float(jm["grad_norm"]) > 1.0
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= \
            OPT_ATOL * float(jm["grad_norm"])
        for k in w:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=0, atol=OPT_ATOL)
            for mom in ("m", "v"):
                got = tstate[mom][k].float().numpy()
                want = np.asarray(jstate[mom][k], np.float32)
                assert str(tstate[mom][k].dtype).endswith(state_dtype)
                tol = np.abs(want) * 2.0 ** -7 if state_dtype == "bfloat16" \
                    else OPT_ATOL * np.maximum(np.abs(want), 1e-3)
                assert (np.abs(got - want) <= tol).all(), (k, mom)
        assert int(tstate["step"]) == int(jstate["step"]) == step + 1
        assert tstate["step"].dtype == torch.int32


def test_clip_by_global_norm_matches_reference():
    g = _opt_tree(3)
    jc, jn = j_adamw.clip_by_global_norm({k: jnp.asarray(a)
                                          for k, a in g.items()}, 1.0)
    tc, tn = clip_by_global_norm({k: torch.from_numpy(a)
                                  for k, a in g.items()}, 1.0)
    assert abs(float(tn) - float(jn)) <= OPT_ATOL * float(jn)
    for k in g:
        assert tc[k].dtype == torch.float32
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), rtol=0,
                                   atol=OPT_ATOL)
    # below the limit: unscaled
    tc, _ = clip_by_global_norm({k: torch.from_numpy(a)
                                 for k, a in g.items()}, 1e6)
    for k in g:
        np.testing.assert_array_equal(tc[k].numpy(), g[k])


def test_cosine_schedule_matches_reference():
    for kw in (dict(warmup=3, total=10), dict(warmup=0, total=7),
               dict(warmup=100, total=10_000, min_ratio=0.1)):
        total = kw["total"]
        for step in list(range(total + 6)) + [5000, 10_003]:
            got = cosine_schedule(step, **kw)
            assert got.dtype == torch.float32
            want = float(j_sched.cosine_schedule(step, **kw))
            assert abs(float(got) - want) <= OPT_ATOL, (kw, step)
        got = cosine_schedule(torch.tensor(4, dtype=torch.int32), **kw)
        assert abs(float(got) - float(j_sched.cosine_schedule(4, **kw))) \
            <= OPT_ATOL


# --- cross-entropy -----------------------------------------------------------


def test_dense_chunked_xent_matches_reference():
    """Per-token losses and the masked mean's gradients (x and the head)
    at a chunk (4) that does not divide B * S (14), a padded vocabulary
    (50 of 64 rows) and -1 labels masked as ``loss_fn`` masks them."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 7, 16)).astype(np.float32)
    w = rng.normal(size=(64, 16)).astype(np.float32) * 0.3
    labels = rng.integers(0, 50, (2, 7)).astype(np.int32)
    labels[1, 2] = labels[0, 6] = -1

    def j_loss(x, w):
        per = j_emb._dense_chunked_xent(x, w, jnp.maximum(labels, 0), 50, 4)
        mask = (labels >= 0).astype(jnp.float32)
        return (per * mask).sum() / mask.sum(), per

    (jl, jper), jg = jax.value_and_grad(j_loss, argnums=(0, 1),
                                        has_aux=True)(jnp.asarray(x),
                                                      jnp.asarray(w))
    tx, tw = (torch.from_numpy(a).requires_grad_(True) for a in (x, w))
    tl = torch.from_numpy(labels)
    per = t_emb._dense_chunked_xent(tx, tw, torch.clamp(tl, min=0), 50, 4)
    mask = (tl >= 0).float()
    loss = (per * mask).sum() / mask.sum()
    np.testing.assert_allclose(per.detach().numpy(), np.asarray(jper),
                               rtol=0, atol=1e-5)
    assert abs(float(loss.detach()) - float(jl)) <= 1e-5
    got = torch.autograd.grad(loss, (tx, tw))
    for g, want in zip(got, jg):
        _close_rel(g.numpy(), np.asarray(want), 1e-5, "xent grad")
    assert float(got[1][50:].abs().max()) == 0.0   # pad rows get nothing


def test_vocab_sharded_loss_head_raises():
    """A plan whose model axis holds the vocabulary (here a stand-in with
    one rank on it) takes the sharded loss head, which is not ported."""
    cfg = dataclasses.replace(t_reduced("yi-9b"), dtype="float32")
    plan = types.SimpleNamespace(mesh=object(), model_axis="model",
                                 axis_size=lambda name: 1)
    with pytest.raises(NotImplementedError, match="item 5"):
        t_emb.sharded_xent(torch.zeros(1, 2, cfg.d_model),
                           torch.zeros(cfg.padded_vocab, cfg.d_model),
                           torch.zeros(1, 2, dtype=torch.int32), cfg, plan)


# --- build_train_step --------------------------------------------------------

STEP_ATOL = 1e-5


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_reference(accum):
    """Three steps from bridged weights over the port's ShardedLoader
    batches against the reference's build_train_step on the local recipe:
    parameters, loss and grad_norm within 1e-5."""
    jcfg = dataclasses.replace(j_reduced("yi-9b"), dtype="float32")
    tcfg = dataclasses.replace(t_reduced("yi-9b"), dtype="float32")
    dcfg = t_pipe.DataConfig(seq_len=16, global_batch=4,
                             vocab_size=tcfg.vocab_size, seed=3)
    loader = t_pipe.ShardedLoader(
        t_pipe.SyntheticTokenSource(dcfg.vocab_size, dcfg.seed), dcfg)
    sk = {"warmup": 2, "total": 10}
    jopt = j_adamw.AdamWConfig(lr=1e-3)
    jstep, _ = j_steps.build_train_step(jcfg, JM.LOCAL, jopt, sk, accum)
    jstep = jax.jit(jstep)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(2))
    jstate = j_adamw.adamw_init(jp, jopt)
    model = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    recipe = make_recipe(make_plan(None, tcfg), tcfg, ShapeConfig(16, 4))
    tstep, _ = t_steps.build_train_step(tcfg, recipe, AdamWConfig(lr=1e-3),
                                        sk, accum, device="cpu")
    tstate = adamw_init(dict(model.named_parameters()), AdamWConfig(lr=1e-3))
    for step in range(3):
        batch = loader.global_batch_at(step)
        jp, jstate, jm = jstep(jp, jstate,
                               {k: jnp.asarray(v) for k, v in batch.items()})
        _, _, tm = tstep(model, tstate, batch)
        for k in ("loss", "grad_norm", "xent", "aux", "tokens"):
            assert abs(float(tm[k]) - float(jm[k])) <= STEP_ATOL, (step, k)
    want = state_from_jax(jax.tree.map(np.asarray, jp), tcfg)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name], rtol=0,
                                   atol=STEP_ATOL, err_msg=name)


def test_train_step_refuses_a_mesh():
    cfg = dataclasses.replace(t_reduced("yi-9b"), dtype="float32")
    recipe = make_recipe(make_plan(None, cfg), cfg, ShapeConfig(8, 2))
    meshed = dataclasses.replace(recipe, plan=dataclasses.replace(
        recipe.plan, mesh=_CpuMesh()))
    with pytest.raises(NotImplementedError, match="item 5"):
        t_steps.build_train_step(cfg, meshed, device="cpu")


class _CpuMesh:
    device_type = "cpu"


# --- data pipeline -----------------------------------------------------------


def test_pipeline_batches_equal_the_reference(tmp_path):
    """Bit-equal batches: synthetic source over several steps, hosts and
    shares (and after a rebalance), and a memmap file that wraps."""
    for seq, gb, hosts, shares in ((16, 8, 1, None), (33, 6, 3, None),
                                   (8, 10, 2, {"host0": 7, "host1": 3})):
        jc = j_pipe.DataConfig(seq_len=seq, global_batch=gb, vocab_size=977,
                               seed=4)
        tc = t_pipe.DataConfig(seq_len=seq, global_batch=gb, vocab_size=977,
                               seed=4)
        jl = j_pipe.ShardedLoader(j_pipe.SyntheticTokenSource(977, 4), jc,
                                  shares=shares, num_hosts=hosts)
        tl = t_pipe.ShardedLoader(t_pipe.SyntheticTokenSource(977, 4), tc,
                                  shares=shares, num_hosts=hosts)
        for step in (0, 1, 7, 4099):
            for h in sorted(jl.shares):
                a, b = jl.batch_at(step, h), tl.batch_at(step, h)
                for k in ("tokens", "labels"):
                    assert a[k].dtype == b[k].dtype
                    np.testing.assert_array_equal(a[k], b[k])
            np.testing.assert_array_equal(
                jl.global_batch_at(step)["tokens"],
                tl.global_batch_at(step)["tokens"])
    toks = np.arange(1500) % 613
    j_pipe.write_token_file(tmp_path / "j.bin", toks)
    t_pipe.write_token_file(tmp_path / "t.bin", toks)
    assert (tmp_path / "j.bin").read_bytes() == \
        (tmp_path / "t.bin").read_bytes()
    cfg = t_pipe.DataConfig(seq_len=31, global_batch=4, vocab_size=613)
    jl = j_pipe.ShardedLoader(j_pipe.MemmapTokenSource(tmp_path / "j.bin"),
                              cfg)
    tl = t_pipe.ShardedLoader(t_pipe.MemmapTokenSource(tmp_path / "t.bin"),
                              cfg)
    for step in range(14):              # 128 tokens a step: wraps past 1500
        a, b = jl.global_batch_at(step), tl.global_batch_at(step)
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        np.testing.assert_array_equal(a["labels"], b["labels"])


# --- checkpoints -------------------------------------------------------------


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": torch.from_numpy(rng.normal(size=(4, 3)).astype(np.float32)),
            "b": {"c": torch.from_numpy(rng.integers(0, 5, (2,)).astype(
                np.int32)),
                  "d": torch.from_numpy(rng.normal(size=(5,)).astype(
                      np.float32)).to(torch.bfloat16)}}


def _leaves(tree):
    return list(t_ckpt._flatten(tree).items())


def test_checkpoint_roundtrip_with_bf16(tmp_path):
    tree = _tree(0)
    save_checkpoint(tmp_path, 7, tree)
    assert latest_step(tmp_path) == 7
    man = (tmp_path / "step_000000007" / "manifest.json").read_text()
    assert '"bfloat16"' in man
    template = {"a": torch.zeros(4, 3), "b": {
        "c": torch.zeros(2, dtype=torch.int32),
        "d": torch.zeros(5, dtype=torch.bfloat16)}}
    got, manifest = restore_checkpoint(tmp_path, template)
    assert manifest["step"] == 7
    for (ka, a), (kb, b) in zip(_leaves(tree), _leaves(got)):
        assert ka == kb and a.dtype == b.dtype
        assert torch.equal(a, b), ka


def test_uncommitted_checkpoint_ignored(tmp_path):
    save_checkpoint(tmp_path, 3, _tree(0))
    (tmp_path / "step_000000009").mkdir()    # a crash mid-save: no .done
    assert latest_step(tmp_path) == 3


def test_manager_async_and_gc(tmp_path):
    tree = _tree(0)
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        mgr.save_async(s, tree)
    mgr.wait()
    assert latest_step(tmp_path) == 4
    assert len(list(tmp_path.glob("step_*.done"))) == 2


class _DeferredThread:
    """A thread whose target runs only at join(): whatever the writer
    does, it does after the caller's next move."""

    def __init__(self, target, daemon=None):
        self.target = target

    def start(self):
        pass

    def join(self):
        self.target()


def test_save_async_snapshots_before_returning(tmp_path, monkeypatch):
    """The optimizer updates parameters in place right after a save: the
    checkpoint must hold the values at save_async, not at the write.  The
    writer is deferred until wait(), so a snapshot taken on the writer
    thread would see the mutation."""
    monkeypatch.setattr(t_ckpt, "threading",
                        types.SimpleNamespace(Thread=_DeferredThread))
    tree = _tree(1)
    before = {k: v.clone() for k, v in t_ckpt._flatten(tree).items()}
    mgr = CheckpointManager(tmp_path)
    mgr.save_async(5, tree)
    with torch.no_grad():
        for v in t_ckpt._flatten(tree).values():
            v.add_(1)
    mgr.wait()
    got, _ = mgr.restore(_tree(2))
    for k, v in t_ckpt._flatten(got).items():
        assert torch.equal(v, before[k]), k


def test_restart_exact_resume(tmp_path):
    """Train 6 steps; train 3, stop, resume to 6: the same parameters and
    optimizer state within 1e-5 (the reference's test, on the port)."""
    cfg = dataclasses.replace(t_reduced("yi-9b"), dtype="float32")
    dcfg = t_pipe.DataConfig(seq_len=16, global_batch=2,
                             vocab_size=cfg.vocab_size)
    full = train(cfg, dcfg, TrainConfig(steps=6, log_every=100,
                                        ckpt_every=100), device="cpu")
    d = tmp_path / "ck"
    train(cfg, dcfg, TrainConfig(steps=3, log_every=100, ckpt_every=3,
                                 ckpt_dir=str(d)), device="cpu")
    assert latest_step(d) == 3
    resumed = train(cfg, dcfg, TrainConfig(steps=6, log_every=100,
                                           ckpt_every=100, ckpt_dir=str(d)),
                    device="cpu")
    assert resumed.step == 6 and latest_step(d) == 6
    a = dict(full.params.named_parameters())
    for n, p in resumed.params.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), a[n].detach().numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=n)
    for mom in ("m", "v"):
        for n, t in resumed.opt_state[mom].items():
            np.testing.assert_allclose(t.numpy(),
                                       full.opt_state[mom][n].numpy(),
                                       rtol=1e-5, atol=1e-5)
    assert int(resumed.opt_state["step"]) == 6


# --- the failure injector and the train CLI ----------------------------------


class _Died(Exception):
    pass


def test_failure_injector_kills_once_and_cli_resumes(tmp_path, monkeypatch,
                                                     capsys):
    """``REPRO_FAIL_AT_STEP`` kills the CLI's run at that step (os._exit(42),
    caught here), once: the marker lets the relaunch run through, resuming
    from whatever step was committed, to the uninterrupted run's weights."""
    codes = []

    def fake_exit(code):
        codes.append(code)
        raise _Died()

    monkeypatch.setattr(elastic.os, "_exit", fake_exit)
    monkeypatch.setenv("REPRO_FAIL_AT_STEP", "3")
    monkeypatch.setenv("REPRO_FAIL_MARKER", str(tmp_path / "marker"))
    inj = elastic.FailureInjector(None)
    inj.maybe_fail(2)
    assert codes == []
    ck = tmp_path / "ck"
    argv = ["--arch", "yi-9b", "--smoke", "--steps", "4", "--global-batch",
            "2", "--seq-len", "16", "--ckpt-every", "1", "--log-every", "1",
            "--ckpt-dir", str(ck), "--device", "cpu"]
    with pytest.raises(_Died):
        t_train_cli.main(argv)
    assert codes == [42] and (tmp_path / "marker").read_text() == "3"
    assert t_train_cli.main(argv) == 0
    out = capsys.readouterr().out
    assert "[elastic] injected failure at step 3" in out
    assert "[train] done at step 4" in out
    cfg = t_reduced("yi-9b")
    restored, man = restore_checkpoint(ck, {"params": dict(
        _fresh(cfg).named_parameters())})
    assert man["step"] == 4
    clean = train(cfg, t_pipe.DataConfig(seq_len=16, global_batch=2,
                                         vocab_size=cfg.vocab_size),
                  TrainConfig(steps=4, log_every=100, ckpt_every=100),
                  device="cpu")
    for n, p in clean.params.named_parameters():
        assert torch.equal(p.detach(), restored["params"][n]), n
    assert codes == [42]


def _fresh(cfg):
    from repro_torch.models import model as TM
    return TM.LM(cfg, "cpu")


def test_supervise_relaunches_until_clean_exit():
    """``supervise`` counts a failed attempt and relaunches; a command that
    never succeeds spends the restart budget."""
    import sys
    ok = elastic.supervise([sys.executable, "-c", "pass"], backoff_s=0.0)
    assert ok.restarts == 0 and ok.returncode == 0
    bad = elastic.supervise([sys.executable, "-c", "raise SystemExit(3)"],
                            max_restarts=1, backoff_s=0.0)
    assert bad.restarts == 1 and bad.returncode == 3 and len(bad.log) == 2
