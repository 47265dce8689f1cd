"""The port's sharded serve path against the JAX package's, on the CPU.

Meshes (1, 2), (1, 4) and (2, 2) over ("data", "model"), each with FSDP
off and on, for reduced gemma3-12b and reduced yi-9b in float32:

* the reference runs in one subprocess per mesh, with
  ``--xla_force_host_platform_device_count=4`` and ``AxisType.Auto`` axes
  (JAX 0.9's default Explicit axes make ``_ring_update`` raise a
  ``ShardingTypeError``), and hands its results over as ``.npz``;
* the port runs one process per rank (``torch.multiprocessing.spawn``),
  joined in a ``gloo`` group through a ``FileStore`` under the test's
  temporary directory, with the reference's weights carried across by
  ``bridge.params_from_jax(..., plan=...)`` and cut to each rank's shard.

Both get the same numpy inputs.  Every mesh is spawned once and all checks
run inside; the tests below compare what each rank holds with the
reference's global arrays cut to that rank's piece.  Tolerances: the
embedding lookups, tokens and key positions are exact; K/V caches and the
decode attention output agree within 1e-5 (float32 products and sums in
another order).
"""
import os
import subprocess
import sys
import textwrap
import time
from dataclasses import replace
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = Path(__file__).resolve().parents[1]
MESHES = [(1, 2), (1, 4), (2, 2)]
ARCHS = ("gemma3-12b", "yi-9b")
B, S = 4, 16            # prefill batch and prompt length
SMAX, T0, STEPS = 16, 6, 6  # decode strip length, first position, steps
FED = 3                 # decode steps fed prompt tokens; the rest greedy
TIE_A, TIE_B = 5, 256 - 7   # rows of the first and the last vocab shard
V_CUT = 250             # a vocabulary that leaves 6 pad rows of 256
K_STEPS = 4             # the fused decode block on per-slot strips
H, HKV, DH = 8, 4, 16   # the direct decode-attention check
TIMEOUT = 240           # seconds for a mesh's ranks, and for the reference

JAX_SCRIPT = r'''
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from dataclasses import replace
from jax.sharding import AxisType
from repro.config import ShapeConfig, reduced_config
from repro.core import decode_attention as DA
from repro.core import embedding as E
from repro.models import model as M
from repro.sharding import make_plan, make_recipe

work, d, m = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
B, S, SMAX, T0, STEPS, FED, K = (int(a) for a in sys.argv[4:11])
inp = np.load(os.path.join(work, "inputs.npz"))
mesh = jax.make_mesh((d, m), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2,
                     devices=jax.devices()[:d * m])
out = {}


def tree(arch):
    t = {}
    pre = arch + "/param/"
    for key in inp.files:
        if key.startswith(pre):
            node = t
            *path, leaf = key[len(pre):].split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = jnp.asarray(inp[key])
    return t


for arch in ("gemma3-12b", "yi-9b"):
    cfg = replace(reduced_config(arch), dtype="float32")
    params = tree(arch)
    toks = jnp.asarray(inp[arch + "/tokens"])
    for fsdp in (False, True):
        key = f"{arch}/{fsdp}"
        plan = make_plan(mesh, cfg, fsdp=fsdp)
        rp = make_recipe(plan, cfg, ShapeConfig("p", S, B, "prefill"))
        rd = make_recipe(plan, cfg, ShapeConfig("d", SMAX, B, "decode"))
        out[key + "/seq_axes"] = np.asarray(",".join(rd.seq_axes))
        table = params["embed"]["table"]
        for name, seq in (("psum", False), ("seq", True)):
            f = jax.jit(lambda t, x, seq=seq: E.embed_lookup(t, x, rp,
                                                             seq_sharded=seq))
            out[f"{key}/emb_{name}"] = np.asarray(f(table, toks))
        nxt, caches = jax.jit(lambda p, x: M.prefill_fn(
            p, {"tokens": x}, cfg, rp))(params, toks)
        out[key + "/prefill_nxt"] = np.asarray(nxt)
        for g, leaves in caches.items():
            for name, t in leaves.items():
                out[f"{key}/pcache/{g}/{name}"] = np.asarray(t)
        dec = jax.jit(lambda p, c, t, pos: M.decode_fn(p, c, t, pos, cfg, rd))
        c = M.init_caches(cfg, B, SMAX)
        tok, got = toks[:, :1], []
        for t in range(STEPS):
            o, c = dec(params, c, tok, jnp.int32(T0 + t))
            got.append(np.asarray(o))
            tok = toks[:, t + 1:t + 2] if t + 1 < FED \
                else o[:, None].astype(jnp.int32)
        out[key + "/decode"] = np.stack(got)
        if not fsdp:
            blk = jax.jit(lambda p, c, *s: M.decode_block_fn(
                p, c, *s, cfg, rd, k_steps=K, eos_id=None, max_len=SMAX))
            o = blk(params, M.init_caches(cfg, B, SMAX, per_slot=True),
                    *(jnp.asarray(inp["block/" + n])
                      for n in ("tok", "pos", "alive", "rem")))
            for n, i in (("out", 0), ("n", 1), ("pos", 3), ("alive", 4)):
                out[f"{arch}/block_{n}"] = np.asarray(o[i])
        if arch == "yi-9b":
            x, w = jnp.asarray(inp["tie/x"]), jnp.asarray(inp["tie/w"])
            g = jax.jit(lambda x, w: E.greedy_sample(x, w, rd, cfg))
            out[key + "/tie"] = np.asarray(g(x, w))
            cv = replace(cfg, vocab_size=int(sys.argv[11]))
            f = jax.jit(lambda x, w: E.sharded_logits_last(x, w, rd, cv))
            out[key + "/logits"] = np.asarray(f(x, w))
            out["tie_local"] = np.asarray(E.greedy_sample(x, w, M.LOCAL,
                                                          cfg))
            if not fsdp:
                # an odd batch leaves the data axis to the sequence, which
                # then spans ("data", "model") on the (2, 2) mesh
                rt = make_recipe(plan, cfg, ShapeConfig("t", SMAX, 3,
                                                        "decode"))
                out["tuple_seq_axes"] = np.asarray(",".join(rt.seq_axes))
                q, k, v = (jnp.asarray(inp["attn/" + n]) for n in "qkv")
                for lay, kp, window, r in (("shared", "shared", None, rd),
                                           ("ring", "ring", 8, rd),
                                           ("tuple", "shared", None, rt)):
                    f = jax.jit(lambda q, k, v, kp, cur, window=window, r=r:
                                DA.decode_attention(q, k, v, kp, cur,
                                                    window=window, plan=r))
                    out["attn_" + lay] = np.asarray(f(
                        q, k, v, jnp.asarray(inp[f"attn/{kp}_kpos"]),
                        jnp.asarray(inp[f"attn/{kp}_cur"])))
np.savez(os.path.join(work, f"ref_{d}x{m}.npz"), **out)
print("OK")
'''


def _inputs(work: Path) -> None:
    """Weights (the reference's init_params, seed 0) and every input, made
    once with numpy and shared by both packages through ``inputs.npz``."""
    import jax
    from repro.config import reduced_config
    from repro.models import model as JM

    rng = np.random.default_rng(0)
    inp = {}
    for arch in ARCHS:
        cfg = replace(reduced_config(arch), dtype="float32")
        params = JM.init_params(cfg, jax.random.PRNGKey(0))
        for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
            name = "/".join(str(p.key) for p in path)
            inp[f"{arch}/param/{name}"] = np.asarray(leaf)
        inp[arch + "/tokens"] = rng.integers(0, cfg.vocab_size,
                                             (B, S)).astype(np.int32)
    # an exact cross-shard tie: rows TIE_A and TIE_B are equal and win every
    # row, in integer arithmetic that float32 carries exactly
    d = reduced_config("yi-9b").d_model
    x = rng.integers(1, 4, (B, d)).astype(np.float32)
    w = rng.integers(-2, 3, (256, d)).astype(np.float32)
    w[TIE_A] = w[TIE_B] = 3.0
    inp["tie/x"], inp["tie/w"] = x, w
    for n in "qkv":
        shape = (B, H, DH) if n == "q" else (B, SMAX, HKV, DH)
        inp["attn/" + n] = rng.normal(size=shape).astype(np.float32)
    inp["attn/shared_kpos"] = np.r_[np.arange(12),
                                    -np.ones(SMAX - 12)].astype(np.int32)
    inp["attn/shared_cur"] = np.asarray(11, np.int32)
    cur = np.asarray([3, 15, 26, 40], np.int32)       # ring slots wrapped
    kpos = np.full((B, SMAX), -1, np.int32)
    for b, c in enumerate(cur):
        for p in range(max(0, c - SMAX + 1), c + 1):
            kpos[b, p % SMAX] = p
    inp["attn/ring_kpos"], inp["attn/ring_cur"] = kpos, cur
    inp["block/tok"] = rng.integers(0, 256, B).astype(np.int32)
    inp["block/pos"] = np.asarray([6, 9, 13, 2], np.int32)
    inp["block/alive"] = np.asarray([True, True, False, True])
    inp["block/rem"] = np.asarray([4, 2, 3, 4], np.int32)
    np.savez(work / "inputs.npz", **inp)


def _tree(inp, arch: str):
    out = {}
    pre = arch + "/param/"
    for key in inp.files:
        if key.startswith(pre):
            node = out
            *path, leaf = key[len(pre):].split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = inp[key]
    return out


def _rank_main(rank: int, world: int, mesh_shape, work: str) -> None:
    """One rank of the port's run on a (data, model) gloo mesh: writes what
    this rank holds and computes to ``rank{rank}_{d}x{m}.npz``."""
    from repro_torch import sharding as sh
    from repro_torch.bridge import params_from_jax
    from repro_torch.config import ShapeConfig, reduced_config
    from repro_torch.core import embedding as temb
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import model as TM

    torch.set_num_threads(1)
    d, m = mesh_shape
    dist.init_process_group(
        "gloo", init_method=f"file://{work}/store_{d}x{m}", rank=rank,
        world_size=world, timeout=timedelta(seconds=TIMEOUT))
    try:
        mesh = make_debug_mesh(d, m, device="cpu")
        inp = np.load(os.path.join(work, "inputs.npz"))
        out = {}
        for arch in ARCHS:
            cfg = replace(reduced_config(arch), dtype="float32")
            tree = _tree(inp, arch)
            toks = torch.from_numpy(inp[arch + "/tokens"])
            for fsdp in (False, True):
                key = f"{arch}/{fsdp}"
                plan = sh.make_plan(mesh, cfg, fsdp=fsdp)
                rp = sh.make_recipe(plan, cfg, ShapeConfig(S, B))
                rd = sh.make_recipe(plan, cfg, ShapeConfig(SMAX, B))
                model = params_from_jax(tree, cfg, device="cpu", plan=rp)
                rows = sh.batch_rows(rp, B)
                out[key + "/seq_axes"] = np.asarray(",".join(rd.seq_axes))
                with torch.no_grad():
                    for name, seq in (("psum", False), ("seq", True)):
                        out[f"{key}/emb_{name}"] = temb.embed_lookup(
                            model.embed.table, toks[rows], cfg, rp,
                            seq_sharded=seq).numpy()
                    prefill = steps.build_prefill_step(cfg, rp, device="cpu")
                    nxt, caches = prefill(model, {"tokens": toks})
                    out[key + "/prefill_nxt"] = nxt.numpy()
                    for g, leaves in caches.items():
                        for name, t in leaves.items():
                            out[f"{key}/pcache/{g}/{name}"] = t.numpy()
                    c = TM.init_caches(cfg, B, SMAX, device="cpu", plan=rd)
                    decode = steps.build_decode_step(cfg, rd, device="cpu")
                    tok, got = toks[:, :1], []
                    for t in range(STEPS):
                        o, c = decode(model, c, tok, T0 + t)
                        got.append(o.numpy())
                        tok = toks[:, t + 1:t + 2] if t + 1 < FED \
                            else o[:, None]
                    out[key + "/decode"] = np.stack(got)
                    if not fsdp:
                        block = steps.build_decode_block_step(
                            cfg, rd, k_steps=K_STEPS, eos_id=None,
                            max_len=SMAX, device="cpu")
                        o = block(model, TM.init_caches(
                            cfg, B, SMAX, per_slot=True, device="cpu",
                            plan=rd), *(inp["block/" + n] for n in (
                                "tok", "pos", "alive", "rem")))
                        for n, i in (("out", 0), ("n", 1), ("pos", 3),
                                     ("alive", 4)):
                            out[f"{arch}/block_{n}"] = np.asarray(o[i])
                    if arch == "yi-9b":
                        x = torch.from_numpy(inp["tie/x"])[rows]
                        w = torch.from_numpy(inp["tie/w"])
                        vr, vc = sh.vocab_slices(rd, cfg)
                        out[key + "/tie"] = temb.greedy_sample(
                            x, w[vr, vc], cfg, rd).numpy()
                        cv = replace(cfg, vocab_size=V_CUT)
                        vr, vc = sh.vocab_slices(rd, cv)
                        out[key + "/logits"] = temb.sharded_logits_last(
                            x, w[vr, vc], cv, rd).numpy()
                        if not fsdp:
                            rt = sh.make_recipe(plan, cfg,
                                                ShapeConfig(SMAX, 3))
                            out["tuple_seq_axes"] = np.asarray(
                                ",".join(rt.seq_axes))
                            _attention(inp, rd, rt, out)
        out["rows"] = np.asarray([rows.start, rows.stop])
        out["model_rank"] = np.asarray(sh.axis_index(rd, "model"))
        np.savez(os.path.join(work, f"rank{rank}_{d}x{m}.npz"), **out)
    finally:
        dist.destroy_process_group()


def _attention(inp, rd, rt, out) -> None:
    """The sharded decode attention on this rank's rows of the batch and
    block of the strip: both kpos layouts under the decode recipe, and the
    shared layout under ``rt``, whose sequence axes may be a tuple."""
    from repro_torch import sharding as sh
    from repro_torch.core import decode_attention as tda
    for lay, kp, window, recipe in (("shared", "shared", None, rd),
                                    ("ring", "ring", 8, rd),
                                    ("tuple", "shared", None, rt)):
        rows = sh.batch_rows(recipe, B)
        n = sh.axes_size(recipe, recipe.seq_axes)
        r = sh.axis_index(recipe, recipe.seq_axes)
        blk = slice(r * SMAX // n, (r + 1) * SMAX // n)
        q, k, v = (torch.from_numpy(inp["attn/" + x])[rows] for x in "qkv")
        kpos = torch.from_numpy(inp[f"attn/{kp}_kpos"])
        cur = torch.from_numpy(inp[f"attn/{kp}_cur"])
        if kp == "ring":
            kpos, cur = kpos[rows], cur[rows]
        out["attn_" + lay] = tda.decode_attention(
            q, k[:, blk], v[:, blk], kpos[..., blk], cur, window=window,
            plan=recipe).numpy()
        out[f"attn_{lay}_rows"] = np.asarray([rows.start, rows.stop])


def _spawn(mesh, work: Path):
    """Run the port's ranks for ``mesh``; the ranks' results, or the error
    that stopped them."""
    d, m = mesh
    ctx = mp.start_processes(_rank_main, args=(d * m, mesh, str(work)),
                             nprocs=d * m, join=False, start_method="spawn")
    deadline = time.monotonic() + TIMEOUT
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"mesh {mesh}: ranks still running after "
                                   f"{TIMEOUT} s")
    except Exception as e:      # reported by this mesh's tests
        return f"{type(e).__name__}: {e}"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [dict(np.load(work / f"rank{r}_{d}x{m}.npz"))
            for r in range(d * m)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("sharded_serve")
    _inputs(work)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    args = [str(a) for a in (B, S, SMAX, T0, STEPS, FED, K_STEPS, V_CUT)]
    procs = {mesh: subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(JAX_SCRIPT), str(work),
         str(mesh[0]), str(mesh[1]), *args], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for mesh in MESHES}
    try:
        port = {mesh: _spawn(mesh, work) for mesh in MESHES}
        ref = {}
        for mesh, p in procs.items():
            try:
                _, err = p.communicate(timeout=TIMEOUT)
            except subprocess.TimeoutExpired:
                ref[mesh] = f"reference for {mesh} timed out"
                continue
            ref[mesh] = dict(np.load(work / f"ref_{mesh[0]}x{mesh[1]}.npz")) \
                if p.returncode == 0 else f"reference failed:\n{err[-3000:]}"
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    return {mesh: (ref[mesh], port[mesh]) for mesh in MESHES}


def _get(runs, mesh):
    ref, ranks = runs[mesh]
    assert not isinstance(ref, str), ref
    assert not isinstance(ranks, str), ranks
    return ref, ranks


def _cases():
    return [(f"{arch}/{fsdp}", arch) for arch in ARCHS
            for fsdp in (False, True)]


@pytest.mark.parametrize("mesh", MESHES)
def test_embed_lookup_is_exact(runs, mesh):
    """Both variants of the ISP lookup give each rank exactly its piece of
    the reference's: its batch rows (psum) and its S/tp slice of them
    (sequence-parallel)."""
    ref, ranks = _get(runs, mesh)
    tp = mesh[1]
    for key, _ in _cases():
        for got in ranks:
            rows = slice(*got["rows"])
            r = int(got["model_rank"])
            np.testing.assert_array_equal(got[key + "/emb_psum"],
                                          ref[key + "/emb_psum"][rows])
            blk = slice(r * S // tp, (r + 1) * S // tp)
            np.testing.assert_array_equal(got[key + "/emb_seq"],
                                          ref[key + "/emb_seq"][rows, blk])


@pytest.mark.parametrize("mesh", MESHES)
def test_greedy_tie_goes_to_the_higher_shard(runs, mesh):
    """Rows TIE_A (first shard) and TIE_B (last shard) tie exactly: the
    reference's sharded greedy picks the higher id where the unsharded
    argmax picks the lower, and the port picks as the reference does."""
    ref, ranks = _get(runs, mesh)
    assert (ref["tie_local"] == TIE_A).all()
    for fsdp in (False, True):
        key = f"yi-9b/{fsdp}/tie"
        assert (ref[key] == TIE_B).all()
        for got in ranks:
            np.testing.assert_array_equal(got[key],
                                          ref[key][slice(*got["rows"])])


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_logits_keep_pad_columns_at_minus_inf(runs, mesh):
    """With a vocabulary of V_CUT that pads to 256, each rank's all-gathered
    logits are exactly its batch rows of the reference's (B, 256): every
    shard in its place, and the pad columns at -inf, not sliced off.  The
    inputs are small integers, so float32 carries the products exactly."""
    ref, ranks = _get(runs, mesh)
    for fsdp in (False, True):
        key = f"yi-9b/{fsdp}/logits"
        want = ref[key]
        assert want.shape == (B, 256)
        assert np.isneginf(want[:, V_CUT:]).all()
        assert np.isfinite(want[:, :V_CUT]).all()
        for got in ranks:
            np.testing.assert_array_equal(got[key],
                                          want[slice(*got["rows"])])


@pytest.mark.parametrize("mesh", MESHES)
def test_prefill_tokens_and_caches(runs, mesh):
    """Every rank returns the reference's (B,) next tokens, and keeps its
    batch rows and its block of each strip of the prefill caches."""
    ref, ranks = _get(runs, mesh)
    for key, _ in _cases():
        for got in ranks:
            np.testing.assert_array_equal(got[key + "/prefill_nxt"],
                                          ref[key + "/prefill_nxt"])
            rows = slice(*got["rows"])
            r, n = int(got["model_rank"]), mesh[1]
            leaves = [k for k in got if k.startswith(key + "/pcache/")]
            assert leaves
            for leaf in leaves:
                want = ref[leaf]
                s = want.shape[-1] // n if leaf.endswith("kpos") \
                    else want.shape[2] // n
                blk = slice(r * s, (r + 1) * s)
                if leaf.endswith("kpos"):
                    np.testing.assert_array_equal(got[leaf], want[:, blk])
                else:
                    np.testing.assert_allclose(got[leaf],
                                               want[:, rows, blk],
                                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("mesh", MESHES)
def test_uniform_decode_tokens(runs, mesh):
    """6 uniform decode_fn steps against sequence-sharded strips (seq axes
    ("model",), so the partials are combined and only the owner of a row
    writes it) give the reference's tokens on every rank."""
    ref, ranks = _get(runs, mesh)
    for key, _ in _cases():
        assert str(ref[key + "/seq_axes"]) == "model"
        for got in ranks:
            assert str(got[key + "/seq_axes"]) == "model"
            np.testing.assert_array_equal(got[key + "/decode"],
                                          ref[key + "/decode"])


@pytest.mark.parametrize("mesh", MESHES)
def test_decode_block_on_per_slot_strips(runs, mesh):
    """The fused K-step decode block on per-slot strips (kpos (B, S/n)
    on each rank): slots at different positions, one not alive, one
    running out of budget, one reaching the end of the strip; the same
    (K, B) block, step count and final slot state as the reference."""
    ref, ranks = _get(runs, mesh)
    for arch in ARCHS:
        assert int(ref[arch + "/block_n"]) >= 2
        for got in ranks:
            for n in ("out", "n", "pos", "alive"):
                np.testing.assert_array_equal(got[f"{arch}/block_{n}"],
                                              ref[f"{arch}/block_{n}"])


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_decode_attention(runs, mesh):
    """The sharded decode attention over each rank's block of the strip,
    shared (S,) and per-slot ring (B, S) tracks, within 1e-5 of the
    reference's; with an odd batch on the (2, 2) mesh the strip spans the
    axis tuple ("data", "model")."""
    ref, ranks = _get(runs, mesh)
    want_axes = "data,model" if mesh == (2, 2) else "model"
    assert str(ref["tuple_seq_axes"]) == want_axes
    for got in ranks:
        assert str(got["tuple_seq_axes"]) == want_axes
        for lay in ("shared", "ring", "tuple"):
            rows = slice(*got[f"attn_{lay}_rows"])
            np.testing.assert_allclose(got["attn_" + lay],
                                       ref["attn_" + lay][rows],
                                       atol=1e-5, rtol=1e-5)
