"""float16 end to end, on the CPU: a config with ``dtype="float16"`` (and
``optimizer_state_dtype="float16"``) serves and trains in the port as in
the JAX package, and each kernel's plain path takes fp16 as the
reference's Pallas kernel does (interpret mode).

* Serve: the reduced yi-9b, gemma3-12b, deepseek-v2-236b, hymba-1.5b and
  xlstm-125m in float16, the port's CPU engine against the reference's
  ``ServeEngine`` on the same weights (the port's ``init_params`` drawn in
  fp16, stacked as the reference's leaves and bridged back with
  ``params_from_jax``): the same tokens.
* Train: ``loss_fn`` and every gradient leaf of yi-9b and deepseek-v2 in
  float16 against ``jax.value_and_grad``; two AdamW steps with float16
  moments from those gradients; a float16 checkpoint written by the port
  restores bit-equal in the port and in the reference.
* Kernels: the plain flash (with lse), paged and isp decode, gather (with
  weights, and with ``shard_rows``), pool and top-k (with exact ties) in
  fp16 against the reference's jnp oracle and its Pallas kernel in
  interpret mode; the op counter's fp16 bounds of flash and top-k, both
  at the fp16 tensor peak.
  (tests/test_torch_kernel_domain.py holds the wrappers' dtype check: it
  takes float16 and refuses float64.)

Tolerances, each fp16 rounding being at most 2**-11 of a value:
* losses within ``LOSS_ATOL`` 1e-4: both sides run the same fp16 model and
  round activations to fp16 at other places (measured 1.3e-5 on O(5)
  losses); gradient leaves within ``GRAD_REL`` 1e-2 of the leaf's largest
  value: each side rounds every gradient to fp16 after sums in other
  orders over two layers (measured 2.8e-3);
* AdamW: parameters and moments within two fp16 ulps of the reference's
  (the same fp32 update rounded to fp16; the inputs may already differ by
  one ulp after the first step);
* flash: out within ``FLASH_ATOL`` 4e-3 (one fp16 ulp of a value below 4
  is at most 2**-9; both sides round fp32 sums to fp16), lse within 1e-5
  (fp32 sums of the same fp32 scores); decode partials within 2e-5 (fp32
  sums of products of the same fp16 inputs, in other orders);
* gather: exact without weights, within one fp16 ulp with them against
  the Pallas kernel (it scales in fp32 and rounds once, the plain path
  multiplies in fp16); pool: within 1e-5 plus one fp16 ulp (2**-10
  relative) of the pooled absolute terms for the Pallas kernel;
* top-k: scores within 1e-5 (fp32 sums of exact fp16 values), ids equal
  where separated, exact ties bit-equal.

The CUDA kernels' fp16 instantiations run only on the card:
``python3 chip_smoke.py --fp16`` holds them against these plain paths."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as j_ckpt
from repro.config import reduced_config as j_reduced
from repro.kernels import flash_attention as j_flash
from repro.kernels import isp_decode as j_isp
from repro.kernels import isp_gather as j_ig
from repro.kernels import paged_decode as j_paged
from repro.kernels import ref as j_ref
from repro.kernels import topk_similarity as j_tk
from repro.models import model as JM
from repro.optim import adamw as j_adamw
from repro.train.serve_loop import ServeEngine as JEngine
from repro_torch.analysis import op_trace
from repro_torch.analysis.roofline import bound, peak_flops
from repro_torch.bridge import params_from_jax, state_from_jax
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.config import reduced_config as t_reduced
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref
from repro_torch.models import model as TM
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.train.serve_loop import ServeEngine as TEngine

SERVE_ARCHS = ("yi-9b", "gemma3-12b", "deepseek-v2-236b", "hymba-1.5b",
               "xlstm-125m")
TRAIN_ARCHS = ("yi-9b", "deepseek-v2-236b")
LOSS_ATOL = 1e-4
GRAD_REL = 1e-2
FLASH_ATOL = 4e-3
LSE_ATOL = 1e-5
DECODE_ATOL = 2e-5
TOPK_ATOL = 1e-5
FP16_ULP = 2.0 ** -10      # one fp16 ulp, relative to the value, at most
B, S = 2, 24               # the loss batch (test_torch_train_archs.py's)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fp16(cfg):
    return dataclasses.replace(cfg, dtype="float16",
                               optimizer_state_dtype="float16")


def _put(tree, path, leaf):
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = leaf


@pytest.fixture(scope="module")
def weights():
    """Per arch, made at first use: the port's ``init_params`` (seed 0) in
    float16 as the reference's pytree of numpy leaves (block layer
    g * group_size + j is index g of ``blocks/b{j}``)."""
    made = {}

    def get(arch):
        if arch not in made:
            cfg = _fp16(t_reduced(arch))
            gs = len(TM.group_pattern(cfg))
            with torch.no_grad():
                state = TM.init_params(cfg, torch.Generator().manual_seed(0),
                                       device="cpu").state_dict()
            tree, stacked = {}, {}
            for name, t in state.items():
                parts = name.split(".")
                if parts[0] == "blocks":
                    li = int(parts[1])
                    key = ("blocks", f"b{li % gs}", *parts[2:])
                    stacked.setdefault(key, {})[li // gs] = t.numpy()
                else:
                    _put(tree, parts, t.numpy())
            for key, by_g in stacked.items():
                _put(tree, key, np.stack([by_g[g] for g in range(len(by_g))]))
            assert {str(a.dtype) for a in jax.tree.leaves(tree)} >= \
                {"float16"}
            made[arch] = tree
        return made[arch]
    return get


def test_float16_is_a_dtype_of_the_port():
    """``torch_dtype`` and AdamW's state take "float16", as the
    reference's ``jnp.dtype(cfg.dtype)`` does."""
    cfg = _fp16(t_reduced("yi-9b"))
    assert TM.torch_dtype(cfg) == torch.float16
    st = adamw_init({"w": torch.zeros(3, dtype=torch.float16)},
                    AdamWConfig(state_dtype=cfg.optimizer_state_dtype))
    assert st["m"]["w"].dtype == st["v"]["w"].dtype == torch.float16


# -- serving ------------------------------------------------------------------


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_serve_float16_gives_the_reference_tokens(arch, weights):
    """Two prompts (5 and 7 tokens), 6 new tokens each, paged, k_block 1,
    through both engines on the same fp16 weights: every request ok and
    the same tokens."""
    jcfg, tcfg = _fp16(j_reduced(arch)), _fp16(t_reduced(arch))
    w = weights(arch)
    model = params_from_jax(w, tcfg, "cpu")
    common = dict(max_len=32, num_slots=2, page_size=8, k_block=1)
    je = JEngine(jcfg, jax.tree.map(jnp.asarray, w), **common)
    te = TEngine(tcfg, model, device="cpu", **common)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, tcfg.vocab_size, n).tolist() for n in (5, 7)]
    for eng in (je, te):
        for p in prompts:
            eng.submit(p, max_new=6)
    jres, tres = je.run_until_complete(), te.run_until_complete()
    assert [r.status for r in tres] == ["ok", "ok"]
    assert [r.tokens for r in tres] == [r.tokens for r in jres]


# -- training -----------------------------------------------------------------


@pytest.fixture(scope="module")
def grads(weights):
    """Per arch: (batch, the reference's loss and its gradients by the
    port's names, in fp32 numpy) of ``loss_fn`` in float16."""
    made = {}

    def get(arch):
        if arch not in made:
            jcfg = _fp16(j_reduced(arch))
            rng = np.random.default_rng(3)
            batch = {"tokens": rng.integers(0, jcfg.vocab_size,
                                            (B, S)).astype(np.int32)}
            labels = rng.integers(0, jcfg.vocab_size, (B, S)).astype(
                np.int32)
            labels[0, :3] = -1
            batch["labels"] = labels
            fn = jax.jit(jax.value_and_grad(JM.loss_fn, has_aux=True),
                         static_argnums=2)
            (loss, _), g = fn(jax.tree.map(jnp.asarray, weights(arch)),
                              {k: jnp.asarray(v) for k, v in batch.items()},
                              jcfg)
            made[arch] = (batch, float(loss), state_from_jax(
                jax.tree.map(lambda x: np.asarray(x, np.float32), g),
                _fp16(t_reduced(arch))))
        return made[arch]
    return get


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_loss_and_gradients_float16_match_reference(arch, weights, grads):
    tcfg = _fp16(t_reduced(arch))
    batch, jloss, jgrads = grads(arch)
    model = params_from_jax(weights(arch), tcfg, "cpu")
    model.requires_grad_(True)
    loss, _ = TM.loss_fn(model, {k: torch.from_numpy(v)
                                 for k, v in batch.items()}, tcfg)
    assert abs(float(loss) - jloss) <= LOSS_ATOL, (float(loss), jloss)
    named = dict(model.named_parameters())
    assert set(named) == set(jgrads)
    gs = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    for (name, p), g in zip(named.items(), gs):
        want = jgrads[name]
        got = np.zeros_like(want) if g is None else g.float().numpy()
        assert g is None or g.dtype == p.dtype, name
        assert np.isfinite(got).all(), name
        scale = max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(got - want).max()) <= GRAD_REL * scale, name


def test_two_adamw_steps_with_float16_moments(weights, grads):
    """yi-9b's fp16 weights and the reference's fp16 gradients (the
    second step's scaled by 0.5), two steps of both optimizers with
    ``optimizer_state_dtype`` "float16" (the clip active: lr 1e-2,
    clip_norm 0.5): parameters, moments and grad norms agree."""
    arch = "yi-9b"
    tcfg = _fp16(t_reduced(arch))
    jcfg = j_adamw.AdamWConfig(lr=1e-2, clip_norm=0.5,
                               state_dtype=tcfg.optimizer_state_dtype)
    cfg = AdamWConfig(lr=1e-2, clip_norm=0.5,
                      state_dtype=tcfg.optimizer_state_dtype)
    _, _, g = grads(arch)
    state = TM.init_params(tcfg, torch.Generator().manual_seed(0),
                           device="cpu").state_dict()
    tp = {k: v.clone() for k, v in state.items()}
    jp = {k: jnp.asarray(v.numpy()) for k, v in state.items()}
    tst, jst = adamw_init(tp, cfg), j_adamw.adamw_init(jp, jcfg)
    for step in range(2):
        gk = {k: (g[k] * (0.5 ** step)).astype(np.float16) for k in tp}
        jp, jst, jm = j_adamw.adamw_update(
            jp, {k: jnp.asarray(a) for k, a in gk.items()}, jst, jcfg)
        tm = adamw_update(tp, {k: torch.from_numpy(a) for k, a in gk.items()},
                          tst, cfg)
        assert float(jm["grad_norm"]) > 0.5
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= \
            1e-5 * float(jm["grad_norm"])
        for k in tp:
            pairs = [(tp[k], jp[k])] + [(tst[m][k], jst[m][k])
                                        for m in ("m", "v")]
            for got, want in pairs:
                assert got.dtype == torch.float16, k
                a = got.float().numpy()
                b = np.asarray(want, np.float32)
                tol = 2 * FP16_ULP * np.maximum(np.abs(b), 2.0 ** -14)
                assert (np.abs(a - b) <= tol).all(), (k, step)
    assert int(tst["step"]) == int(jst["step"]) == 2


def test_float16_checkpoint_round_trip(tmp_path):
    """fp16 leaves written by the port (numpy's own float16, tagged in the
    manifest) restore bit-equal in the port and in the reference."""
    rng = np.random.default_rng(4)
    a = rng.normal(size=(5, 3)).astype(np.float16)
    a[0, 0], a[0, 1] = np.float16(65504.0), np.float16(2.0 ** -24)
    tree = {"p": {"w": torch.from_numpy(a.copy())},
            "s": torch.tensor(3, dtype=torch.int32)}
    save_checkpoint(tmp_path, 2, tree)
    man = (tmp_path / "step_000000002" / "manifest.json").read_text()
    assert '"float16"' in man
    got, _ = restore_checkpoint(tmp_path, {
        "p": {"w": torch.zeros(5, 3, dtype=torch.float16)},
        "s": torch.zeros((), dtype=torch.int32)})
    assert got["p"]["w"].dtype == torch.float16
    assert torch.equal(got["p"]["w"], tree["p"]["w"])
    jgot, _ = j_ckpt.restore_checkpoint(tmp_path, {
        "p": {"w": jnp.zeros((5, 3), jnp.float16)},
        "s": jnp.zeros((), jnp.int32)})
    assert jgot["p"]["w"].dtype == jnp.float16
    np.testing.assert_array_equal(np.asarray(jgot["p"]["w"]), a)


# -- the kernels' plain paths -------------------------------------------------


def _both(x: np.ndarray):
    """The same fp16 values as a JAX array and a torch tensor."""
    h = np.asarray(x, np.float16)
    return jnp.asarray(h), torch.from_numpy(h.copy())


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("shape", [
    # (B, Sq, Skv, H, Hkv, dh, window, q_offset)
    (2, 64, 64, 4, 2, 16, None, 0),
    (1, 40, 72, 4, 2, 16, 24, 32),
])
def test_flash_plain_float16_with_lse(rng, shape):
    Bq, Sq, Skv, H, Hkv, dh, win, qoff = shape
    (jq, tq), (jk, tk), (jv, tv) = (
        _both(rng.normal(size=s))
        for s in ((Bq, Sq, H, dh), (Bq, Skv, Hkv, dh), (Bq, Skv, Hkv, dh)))
    kw = dict(window=win, q_offset=qoff, q_chunk=32, kv_chunk=32)
    out, lse = t_ref.chunked_attention(tq, tk, tv, return_lse=True, **kw)
    assert out.dtype == torch.float16 and lse.dtype == torch.float32
    assert torch.equal(t_ops.flash_attention(tq, tk, tv, **kw), out)
    jout, jlse = j_ref.chunked_attention(jq, jk, jv, return_lse=True, **kw)
    np.testing.assert_allclose(_np(out), _np(jout), atol=FLASH_ATOL, rtol=0)
    np.testing.assert_allclose(_np(lse), _np(jlse), atol=LSE_ATOL, rtol=0)
    pallas = j_flash.flash_attention(jq, jk, jv, window=win, q_offset=qoff,
                                     q_block=32, kv_block=32, interpret=True)
    np.testing.assert_allclose(_np(out), _np(pallas), atol=FLASH_ATOL,
                               rtol=0)
    assert np.isfinite(_np(out)).all()


def _pool(rng, Bq, Hkv, dh, P=12, ps=8, maxp=5):
    """Random page tables with ragged fill levels, slot 1 empty."""
    kpool = rng.normal(size=(P + 1, ps, Hkv, dh))
    vpool = rng.normal(size=(P + 1, ps, Hkv, dh))
    perm = rng.permutation(P)
    tables, cur, used = [], [], 0
    for b in range(Bq):
        n = 0 if b == 1 else int(rng.integers(1, min(maxp, P - used) + 1))
        row = np.full(maxp, -1, np.int32)
        row[:n] = perm[used: used + n]
        used += n
        tables.append(row)
        cur.append(int(rng.integers(0, n * ps)) if n else 0)
    return kpool, vpool, np.stack(tables), np.asarray(cur, np.int32)


@pytest.mark.parametrize("window", [None, 11])
def test_paged_decode_plain_float16(rng, window):
    q = rng.normal(size=(3, 8, 16))
    kpool, vpool, pages, cur = _pool(rng, 3, 4, 16)
    (jq, tq), (jk, tk), (jv, tv) = (_both(a) for a in (q, kpool, vpool))
    got = t_ops.paged_decode_partial(tq, tk, tv, torch.from_numpy(pages),
                                     torch.from_numpy(cur), window=window)
    args = (jq, jk, jv, jnp.asarray(pages), jnp.asarray(cur))
    for want in (j_paged.paged_decode_partial_ref(*args, window=window),
                 j_paged.paged_decode_partial(*args, window=window,
                                              interpret=True)):
        for a, b in zip(got, want):
            assert a.dtype == torch.float32
            np.testing.assert_allclose(_np(a), _np(b), atol=DECODE_ATOL,
                                       rtol=DECODE_ATOL)


def test_isp_decode_plain_float16(rng):
    """The Pallas layout (a shared track kpos (S,), scalar cur) against
    the Pallas kernel, and per-slot tracks against the jnp oracle."""
    Bq, Sk, H, Hkv, dh = 3, 40, 8, 4, 16
    (jq, tq), (jk, tk), (jv, tv) = (
        _both(rng.normal(size=s))
        for s in ((Bq, H, dh), (Bq, Sk, Hkv, dh), (Bq, Sk, Hkv, dh)))
    kpos = np.where(np.arange(Sk) < 30, np.arange(Sk), -1).astype(np.int32)
    got = t_ops.decode_partial(tq, tk, tv, torch.from_numpy(kpos), 25)
    want = j_isp.decode_partial(jq, jk, jv, jnp.asarray(kpos), jnp.int32(25),
                                kv_block=16, interpret=True)
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), _np(b), atol=DECODE_ATOL,
                                   rtol=DECODE_ATOL)
    slot = np.stack([np.where(np.arange(Sk) <= c, np.arange(Sk), -1)
                     for c in (3, 39, 17)]).astype(np.int32)
    cur = np.asarray([3, 39, 17], np.int32)
    got = t_ops.decode_partial(tq, tk, tv, torch.from_numpy(slot),
                               torch.from_numpy(cur), window=9)
    want = j_ref.decode_partial_masked(jq, jk, jv, jnp.asarray(slot),
                                       jnp.asarray(cur), window=9)
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), _np(b), atol=DECODE_ATOL,
                                   rtol=DECODE_ATOL)


@pytest.mark.parametrize("weighted", [False, True])
def test_gather_plain_float16(rng, weighted):
    """Ids below, inside and above the shard (offset 16, 64 rows)."""
    jt, tt = _both(rng.normal(size=(64, 40)))
    idx = rng.integers(-10, 120, (33,)).astype(np.int32)
    w = rng.normal(size=(33,)).astype(np.float32) if weighted else None
    tw = None if w is None else torch.from_numpy(w)
    jw = None if w is None else jnp.asarray(w)
    got = t_ops.isp_gather(tt, torch.from_numpy(idx), shard_offset=16,
                           weights=tw)
    assert got.dtype == torch.float16 and got.shape == (33, 40)
    want = j_ref.isp_gather(jt, jnp.asarray(idx), shard_offset=16, weights=jw)
    np.testing.assert_array_equal(_np(got), _np(want))
    pallas = j_ig.isp_gather(jt, jnp.asarray(idx), shard_offset=16,
                             weights=jw, idx_block=8, d_block=16,
                             interpret=True)
    diff = np.abs(_np(got) - _np(pallas))
    if weighted:
        assert (diff <= FP16_ULP * np.abs(_np(pallas))).all()
    else:
        assert not diff.any()


def test_gather_shard_rows_matches_reference(rng):
    """``shard_rows`` < V_loc: ids at or past shard_offset + shard_rows
    give zeros, as the reference's plain ``isp_gather`` gives them
    (fp32 and fp16), through ``ops.isp_gather`` and its gradient; more
    rows than the table's raise ValueError."""
    table = rng.normal(size=(64, 12)).astype(np.float32)
    idx = rng.integers(-5, 90, (41,)).astype(np.int32)
    w = rng.normal(size=(41,)).astype(np.float32)
    for dt in ("float32", "float16"):
        jt = jnp.asarray(table, jnp.dtype(dt))
        tt = torch.from_numpy(np.asarray(jt, np.float32)).to(
            getattr(torch, dt))
        for weights in (None, w):
            got = t_ops.isp_gather(
                tt, torch.from_numpy(idx), shard_offset=10, shard_rows=37,
                weights=None if weights is None else torch.from_numpy(weights))
            want = j_ref.isp_gather(
                jt, jnp.asarray(idx), shard_offset=10, shard_rows=37,
                weights=None if weights is None else jnp.asarray(weights))
            np.testing.assert_array_equal(_np(got), _np(want))
    out = (idx < 10) | (idx >= 47)
    assert out.sum() > 3 and (idx >= 74).sum() > 0
    # the gradient of the table and the weights, against jax.vjp
    tt = torch.from_numpy(table).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    gout = rng.normal(size=(41, 12)).astype(np.float32)
    got = t_ops.isp_gather(tt, torch.from_numpy(idx), shard_offset=10,
                           shard_rows=37, weights=tw)
    dt_, dw_ = torch.autograd.grad(got, (tt, tw), torch.from_numpy(gout))
    _, vjp = jax.vjp(lambda a, b: j_ref.isp_gather(
        a, jnp.asarray(idx), shard_offset=10, shard_rows=37, weights=b),
        jnp.asarray(table), jnp.asarray(w))
    jdt, jdw = vjp(jnp.asarray(gout))
    np.testing.assert_allclose(dt_.numpy(), np.asarray(jdt), atol=1e-5)
    np.testing.assert_allclose(dw_.numpy(), np.asarray(jdw), atol=1e-5)
    with pytest.raises(ValueError, match="shard_rows"):
        t_ops.isp_gather(torch.from_numpy(table), torch.from_numpy(idx),
                         shard_rows=65)


@pytest.mark.parametrize("weighted", [False, True])
def test_pool_plain_float16(rng, weighted):
    jt, tt = _both(rng.normal(size=(64, 40)))
    idx = rng.integers(-10, 120, (33,)).astype(np.int32)
    seg = rng.integers(0, 7, (33,)).astype(np.int32)
    seg[::5] = -1
    w = rng.normal(size=(33,)).astype(np.float32) if weighted else None
    tw = None if w is None else torch.from_numpy(w)
    jw = None if w is None else jnp.asarray(w)
    got = t_ops.isp_gather_pool(tt, torch.from_numpy(idx),
                                torch.from_numpy(seg), 7, shard_offset=16,
                                weights=tw)
    assert got.dtype == torch.float32 and got.shape == (7, 40)
    want = j_ref.isp_gather_pool(jt, jnp.asarray(idx), jnp.asarray(seg), 7,
                                 shard_offset=16, weights=jw)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=0)
    pallas = j_ig.isp_gather_pool(jt, jnp.asarray(idx), jnp.asarray(seg), 7,
                                  shard_offset=16, weights=jw, idx_block=8,
                                  d_block=16, interpret=True)
    slack = 0.0
    if weighted:
        slack = FP16_ULP * _np(t_ops.isp_gather_pool(
            tt.abs(), torch.from_numpy(idx), torch.from_numpy(seg), 7,
            shard_offset=16, weights=tw.abs()))
    assert (np.abs(_np(got) - _np(pallas)) <= 1e-5 + slack).all()


def test_topk_plain_float16_with_ties(rng):
    """A corpus of random fp16 rows, and one of +-1 rows (norm 4: every
    score exact, each row three times): the plain path against the jnp
    oracle and the Pallas kernel; the tie case bit-equal."""
    q = rng.normal(size=(9, 24)).astype(np.float32)
    jc, tc = _both(rng.normal(size=(130, 24)))
    got_s, got_i = t_ops.topk_similarity(torch.from_numpy(q), tc, 5)
    for ws, wi in (j_ref.topk_similarity(jnp.asarray(q), jc, 5),
                   j_tk.topk_similarity(jnp.asarray(q), jc, 5, q_block=4,
                                        corpus_tile=32, interpret=True)):
        np.testing.assert_allclose(got_s.numpy(), np.asarray(ws),
                                   atol=TOPK_ATOL, rtol=0)
        gap = np.abs(np.diff(np.asarray(ws), axis=1)).min(axis=1)
        sep = gap > TOPK_ATOL
        np.testing.assert_array_equal(got_i.numpy()[sep],
                                      np.asarray(wi)[sep])
    D, N, Q, k = 32, 96, 6, 12

    def signs(n):
        x = np.zeros((n, D), np.float32)
        for r in range(n):
            cols = rng.choice(D, 16, replace=False)
            x[r, cols] = rng.choice([-1.0, 1.0], 16)
        return x

    c = signs(N // 3)
    c = np.concatenate([c, c[::-1], c])
    qt = np.concatenate([signs(Q - 2), c[5:6], c[40:41]])
    jc, tc = _both(c)
    got_s, got_i = t_ops.topk_similarity(torch.from_numpy(qt), tc, k)
    ws, wi = j_ref.topk_similarity(jnp.asarray(qt), jc, k)
    assert (np.diff(np.asarray(ws), axis=1) == 0).sum() > Q, "too few ties"
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(wi))
    _, pi = j_tk.topk_similarity(jnp.asarray(qt), jc, k, q_block=4,
                                 corpus_tile=32, interpret=True)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(pi))


# -- the op counter -----------------------------------------------------------


def test_op_counter_float16_bounds():
    """Flash in fp16 is bounded at the fp16 tensor peak (the bf16 one),
    and so is top-k over an fp16 corpus, with the corpus read at two
    bytes an element."""
    q = torch.zeros(8, 704, 32, 128, dtype=torch.float16)
    k = torch.zeros(8, 704, 4, 128, dtype=torch.float16)
    c = op_trace.KERNEL_COSTS["flash_attention"](q, k, k)
    assert c.dtype == "float16" and peak_flops(c.dtype) == 989e12
    ms, by = bound(c.bytes, c.flops, c.dtype)
    assert by == "operations" and ms == pytest.approx(c.flops / 989e12 * 1e3)
    assert c.bytes == 2 * (q.numel() * 2 + k.numel() * 2)
    queries = torch.zeros(50, 128)
    corpus = torch.zeros(58_000, 128, dtype=torch.float16)
    c = op_trace.KERNEL_COSTS["topk_similarity"](queries, corpus, 10)
    assert c.dtype == "float16" and peak_flops(c.dtype) == 989e12
    assert c.flops == 2 * 50 * 58_000 * 128
    assert c.bytes == 50 * 128 * 4 + 58_000 * 128 * 2 + 50 * 10 * 8
