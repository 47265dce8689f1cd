"""The port's block weights, caches and tokens under the reference's
sharded layouts, against the JAX package's, on the CPU.

Meshes (1, 2) and (2, 2) over ("data", "model") for six reduced configs in
float32: yi-9b (dense GQA), gemma3-12b (sliding-window rings),
llama4-scout-17b-a16e (8 experts: expert parallelism over the model axis),
deepseek-v2-236b (MLA + expert parallelism), hymba-1.5b (attention beside
Mamba) and xlstm-125m (mLSTM and sLSTM).  FSDP off on both meshes, and on
on the (2, 2) mesh: its axis is "data", which the (1, 2) mesh holds once,
so FSDP there cuts nothing and would repeat the FSDP-off case.

* The weights are the port's ``init_params`` (seed 0, the reference's
  distributions), the tokens numpy's (seed 0); this process writes both to
  ``inputs.npz`` in the reference's stacked layout.
* The reference runs once, in one subprocess, with four host devices
  (``--xla_force_host_platform_device_count``), ``AxisType.Auto`` axes and
  a single-threaded XLA CPU client; on each mesh in turn: prefill (logits,
  next tokens and caches), greedy decode and the fused K-step block under
  its GSPMD layout, and the specs of its parameters (``param_specs``) and
  caches (``cache_sharding``), which it hands over as strings.  A mesh
  changes the dense configs' values only in the order of float sums, so
  it computes those on the (2, 2) mesh alone and holds every mesh to
  them; the MoE configs' values, which expert parallelism's capacity
  bound makes depend on the mesh, it computes on each.  On the (1, 2)
  mesh it also runs the MoE configs' prefill with ``ep`` off.
* The port runs one process per rank (``torch.multiprocessing.spawn``,
  one thread each) in a ``gloo`` group, with the weights cut to each
  rank's piece by ``bridge.params_from_jax(..., plan=...)``.  The
  Megatron-SP residual stream turns on only from 1e9 parameters, so the
  SP cases lower ``blocks.SP_MIN_PARAMS`` in the rank processes; the
  reference, which gives the same numbers with or without SP, stays as it
  is.
* Each rank also serves a few requests through ``ServeEngine(recipe=...)``
  and through the same engine with no recipe: five configs on the (1, 2)
  mesh, two on the (2, 2) mesh, whose data axis splits the slots.
* ``test_param_specs_match_the_reference`` holds ``param_specs`` to the
  reference's in this process, on stand-in meshes whose axes divide some
  dimensions and not others (no collective runs).

The ranks run beside the reference, the (1, 2) mesh's and then the
(2, 2) mesh's; every check reads their saved results.  Tolerances: parameter pieces and tokens
are exact; logits and cache pieces agree within 1e-5 (float32 sums in
another order: row-parallel products summed over ranks, decode partials
combined across the sequence blocks).
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
MESHES = [(1, 2), (2, 2)]
ARCHS = ("yi-9b", "gemma3-12b", "llama4-scout-17b-a16e", "deepseek-v2-236b",
         "hymba-1.5b", "xlstm-125m")
B, S = 4, 16            # prefill batch and prompt length
SMAX, T0, STEPS, FED = 16, 6, 4, 2   # decode strips, first position, steps
K_STEPS = 4             # the fused decode block on per-slot strips
TOL = 1e-5
TIMEOUT = 900           # seconds for everything the fixture starts
ENGINE_CASES = [        # (mesh, arch, kv layout, chunked prefill)
    ((1, 2), "yi-9b", "paged", 0), ((1, 2), "yi-9b", "paged", 8),
    ((1, 2), "llama4-scout-17b-a16e", "paged", 8),
    ((1, 2), "deepseek-v2-236b", "paged", 0),
    ((1, 2), "hymba-1.5b", "paged", 0),
    ((2, 2), "yi-9b", "paged", 8), ((2, 2), "deepseek-v2-236b", "paged", 0)]

JAX_SCRIPT = r'''
import os, sys
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_cpu_multi_thread_eigen=false "
                           "intra_op_parallelism_threads=1 "
                           "--xla_backend_optimization_level=0 "
                           "--xla_llvm_disable_expensive_passes=true")
import jax, jax.numpy as jnp, numpy as np
from dataclasses import replace
from jax.sharding import AxisType
from repro.config import ShapeConfig, reduced_config
from repro.core import embedding as E
from repro.launch import steps as ST
from repro.models import model as M
from repro.models.layers import rms_norm
from repro.sharding import make_plan, make_recipe, param_specs

work = sys.argv[1]
B, S, SMAX, T0, STEPS, FED, K = (int(a) for a in sys.argv[2:9])
archs = sys.argv[9].split(",")
meshes = [tuple(int(n) for n in m.split("x")) for m in sys.argv[10].split(",")]
inp = dict(np.load(os.path.join(work, "inputs.npz")))
out = {}


def spec_str(spec):
    return "|".join(",".join(a) if isinstance(a, tuple) else (a or "")
                    for a in spec)


def put_specs(prefix, tree):
    for path, spec in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)
            )[0]:
        name = "/".join(str(p.key) for p in path)
        out[f"{prefix}/{name}"] = np.asarray(spec_str(spec))


def tree(arch):
    t = {}
    pre = arch + "/param/"
    for key in inp:
        if key.startswith(pre):
            node = t
            *path, leaf = key[len(pre):].split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = jnp.asarray(inp[key])
    return t


for d, m in meshes:
    mesh = jax.make_mesh((d, m), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:d * m])
    out = {}
    for arch in archs:
        cfg = replace(reduced_config(arch), dtype="float32")
        params = tree(arch)
        toks = jnp.asarray(inp[arch + "/tokens"])
        for fsdp in ((False, True) if d > 1 else (False,)):
            plan = make_plan(mesh, cfg, fsdp=fsdp)
            put_specs(f"{arch}/{fsdp}/pspec", param_specs(
                plan, M.abstract_params(cfg)))
        plan = make_plan(mesh, cfg, fsdp=False)
        rp = make_recipe(plan, cfg, ShapeConfig("p", S, B, "prefill"))
        rd = make_recipe(plan, cfg, ShapeConfig("d", SMAX, B, "decode"))

        def prefill(p, x, rp=rp):
            h = M._embed_input(p, {"tokens": x}, cfg, rp, "prefill")
            h, caches, _ = M.run_blocks(p, h, jnp.arange(S, dtype=jnp.int32),
                                        cfg, rp, None, "prefill")
            last = rms_norm(h, p["final_norm"], cfg.norm_eps)[:, -1]
            w = p["embed"]["table"] if cfg.tie_embeddings \
                else p["head"]["w_head"]
            return (E.sharded_logits_last(last, w, rp, cfg),
                    E.greedy_sample(last, w, rp, cfg), caches)

        if cfg.moe is None and (d, m) != meshes[-1]:
            # a dense config's values do not depend on the mesh (only the
            # order of float sums does): the last mesh's serve every mesh
            shapes = jax.eval_shape(prefill, params, toks)[2]
            put_specs(arch + "/cspec", ST.cache_sharding(rp, cfg, shapes))
            continue
        logits, nxt, caches = jax.jit(prefill)(params, toks)
        if cfg.moe is not None and (d, m) == meshes[0]:
            # expert parallelism off: the dense route under TP
            noep = make_recipe(replace(plan, ep=False), cfg,
                               ShapeConfig("p", S, B, "prefill"))
            out[arch + "/noep_logits"] = np.asarray(jax.jit(
                lambda p, x: prefill(p, x, noep)[0])(params, toks))
        out[arch + "/logits"] = np.asarray(logits)
        out[arch + "/prefill_nxt"] = np.asarray(nxt)
        shapes = jax.tree.map(lambda t: jax.ShapeDtypeStruct(t.shape, t.dtype),
                              caches)
        put_specs(arch + "/cspec", ST.cache_sharding(rp, cfg, shapes))
        for path, t in jax.tree_util.tree_flatten_with_path(caches)[0]:
            name = "/".join(str(p.key) for p in path)
            out[f"{arch}/pcache/{name}"] = np.asarray(t)
        dec = jax.jit(lambda p, c, t, pos: M.decode_fn(p, c, t, pos, cfg, rd))
        c = M.init_caches(cfg, B, SMAX)
        tok, got = toks[:, :1], []
        for t in range(STEPS):
            o, c = dec(params, c, tok, jnp.int32(T0 + t))
            # host arrays between steps: one compile, whatever layout the
            # step's outputs came back in
            c = jax.tree.map(np.asarray, c)
            got.append(np.asarray(o))
            tok = np.asarray(toks[:, t + 1:t + 2] if t + 1 < FED
                             else o[:, None].astype(jnp.int32))
        out[arch + "/decode"] = np.stack(got)
        blk = jax.jit(lambda p, c, *s: M.decode_block_fn(
            p, c, *s, cfg, rd, k_steps=K, eos_id=None, max_len=SMAX))
        o = blk(params, M.init_caches(cfg, B, SMAX, per_slot=True),
                *(jnp.asarray(inp["block/" + n])
                  for n in ("tok", "pos", "alive", "rem")))
        for n, i in (("out", 0), ("n", 1), ("pos", 3), ("alive", 4)):
            out[f"{arch}/block_{n}"] = np.asarray(o[i])
    np.savez(os.path.join(work, f"ref_{d}x{m}.tmp.npz"), **out)
    os.replace(os.path.join(work, f"ref_{d}x{m}.tmp.npz"),
               os.path.join(work, f"ref_{d}x{m}.npz"))
print("OK")
'''


def _fsdp(mesh):
    """FSDP settings run on ``mesh``: on only where the data axis (the
    FSDP axis) has more than one rank."""
    return (False, True) if mesh[0] > 1 else (False,)


def _make_inputs(path) -> None:
    """The weights (the port's ``init_params``, seed 0, stacked as the
    reference's ``blocks/b{j}`` leaves: layer g * group_size + j is index
    g of b{j}) and every input, for the reference and the ranks."""
    from repro_torch.config import reduced_config
    from repro_torch.models import model as TM

    rng = np.random.default_rng(0)
    inp = {}
    for arch in ARCHS:
        cfg = replace(reduced_config(arch), dtype="float32")
        gs = len(TM.group_pattern(cfg))
        with torch.no_grad():
            state = TM.init_params(cfg, torch.Generator().manual_seed(0),
                                   device="cpu").state_dict()
        stacked = {}
        for name, t in state.items():
            parts = name.split(".")
            if parts[0] == "blocks":
                li = int(parts[1])
                key = "/".join([f"blocks/b{li % gs}"] + parts[2:])
                stacked.setdefault(key, {})[li // gs] = t.numpy()
            else:
                inp[f"{arch}/param/{name.replace('.', '/')}"] = t.numpy()
        for key, by_g in stacked.items():
            inp[f"{arch}/param/{key}"] = np.stack(
                [by_g[g] for g in range(len(by_g))])
        inp[arch + "/tokens"] = rng.integers(0, cfg.vocab_size,
                                             (B, S)).astype(np.int32)
    inp["block/tok"] = rng.integers(0, 256, B).astype(np.int32)
    inp["block/pos"] = np.asarray([6, 9, 13, 2], np.int32)
    inp["block/alive"] = np.asarray([True, True, False, True])
    inp["block/rem"] = np.asarray([4, 2, 3, 4], np.int32)
    inp["engine/prompts"] = rng.integers(0, 256, (6, 21)).astype(np.int32)
    np.savez(path, **inp)


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


def _prefill(model, toks, cfg, recipe):
    """The port's prefill_fn, returning the last position's logits too:
    the embedding (sequence-sharded under SP), the blocks, the final norm
    and the vocabulary-sharded head."""
    from repro_torch import sharding as sh
    from repro_torch.core import embedding as temb
    from repro_torch.models import blocks as tblk
    from repro_torch.models import model as TM
    from repro_torch.models.layers import rms_norm

    sp = tblk.sp_enabled(cfg, recipe, S, "prefill")
    x = temb.embed_lookup(model.embed.table,
                          toks[sh.batch_rows(recipe, B)], cfg, recipe,
                          seq_sharded=sp)
    x, caches = TM.run_blocks(model, x, torch.arange(S, dtype=torch.int32),
                              cfg, None, "prefill", plan=recipe, sp=sp)
    x = tblk.sp_gather(x, recipe, sp)
    last = rms_norm(x, sh.leaf(model, "final_norm", recipe),
                    cfg.norm_eps)[:, -1]
    logits = temb.sharded_logits_last(last, model.head_table(), cfg, recipe)
    nxt = temb.greedy_sample(last, model.head_table(), cfg, recipe)
    return logits, sh.gather_batch(recipe, nxt, B), caches


def _serve(cfg, model, recipe, prompts, layout, chunk):
    """Tokens, ledgers and the KV peak of a few requests through the
    engine."""
    from repro_torch.train.serve_loop import ServeEngine
    eng = ServeEngine(cfg, model, recipe, max_len=64, num_slots=4,
                      k_block=4, kv_layout=layout, page_size=8,
                      chunk_prefill=chunk or None, device="cpu")
    res = eng.generate([p[:n] for p, n in zip(prompts, (21, 5, 13, 9, 17,
                                                         3))], max_new=6)
    led = [getattr(lg, f) for lg in (eng.ledger, eng.baseline)
           for f in ("link_bytes", "local_bytes", "output_bytes", "kv_bytes")]
    return {"tokens": np.asarray([t for r in res for t in r.tokens]),
            "lens": np.asarray([len(r.tokens) for r in res]),
            "ledger": np.asarray(led),
            "kv_peak": np.asarray(eng.kv_stats()["peak_kv_bytes"]),
            "layout": np.asarray(eng.kv_layout),
            "chunked": np.asarray(eng.chunk_prefill or 0)}


def _rank_main(rank: int, world: int, mesh_shape, work: str) -> None:
    """One rank of the port's run on a (data, model) gloo mesh: writes what
    this rank holds and computes to ``rank{rank}_{d}x{m}.npz``."""
    from repro_torch import sharding as sh
    from repro_torch.bridge import params_from_jax
    from repro_torch.config import ShapeConfig, reduced_config
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import blocks as tblk
    from repro_torch.models import model as TM

    torch.set_num_threads(1)
    d, m = mesh_shape
    dist.init_process_group(
        "gloo", init_method=f"file://{work}/store_{d}x{m}", rank=rank,
        world_size=world, timeout=timedelta(seconds=TIMEOUT))
    sp_min = tblk.SP_MIN_PARAMS
    try:
        mesh = make_debug_mesh(d, m, device="cpu")
        inp = np.load(os.path.join(work, "inputs.npz"))
        out = {"coords": np.asarray([mesh.get_local_rank("data"),
                                     mesh.get_local_rank("model")])}
        for arch in ARCHS:
            cfg = replace(reduced_config(arch), dtype="float32")
            tree = _tree(inp, arch)
            toks = torch.from_numpy(inp[arch + "/tokens"])
            for fsdp in _fsdp(mesh_shape):
                key = f"{arch}/{fsdp}"
                plan = sh.make_plan(mesh, cfg, fsdp=fsdp)
                rp = sh.make_recipe(plan, cfg, ShapeConfig(S, B))
                rd = sh.make_recipe(plan, cfg, ShapeConfig(SMAX, B))
                model = params_from_jax(tree, cfg, device="cpu", plan=rp)
                for name, p in model.named_parameters():
                    out[f"{key}/param/{name}"] = p.detach().numpy()
                with torch.no_grad():
                    for sp in (False, True):
                        tblk.SP_MIN_PARAMS = 0 if sp else sp_min
                        logits, nxt, caches = _prefill(model, toks, cfg, rp)
                        out[f"{key}/{sp}/sp_on"] = np.asarray(
                            tblk.sp_enabled(cfg, rp, S, "prefill"))
                        out[f"{key}/{sp}/logits"] = logits.numpy()
                        out[f"{key}/{sp}/prefill_nxt"] = nxt.numpy()
                        for name, t in TM._flat(caches):
                            out[f"{key}/{sp}/pcache/{name.replace('.', '/')}"
                                ] = t.numpy()
                    tblk.SP_MIN_PARAMS = sp_min
                    c = TM.init_caches(cfg, B, SMAX, device="cpu", plan=rd)
                    decode = steps.build_decode_step(cfg, rd, device="cpu")
                    tok, got = toks[:, :1], []
                    for t in range(STEPS):
                        o, c = decode(model, c, tok, T0 + t)
                        got.append(o.numpy())
                        tok = toks[:, t + 1:t + 2] if t + 1 < FED \
                            else o[:, None]
                    out[key + "/decode"] = np.stack(got)
                    block = steps.build_decode_block_step(
                        cfg, rd, k_steps=K_STEPS, eos_id=None, max_len=SMAX,
                        device="cpu")
                    o = block(model, TM.init_caches(
                        cfg, B, SMAX, per_slot=True, device="cpu", plan=rd),
                        *(inp["block/" + n] for n in (
                            "tok", "pos", "alive", "rem")))
                    for n, i in (("out", 0), ("n", 1), ("pos", 3),
                                 ("alive", 4)):
                        out[f"{key}/block_{n}"] = np.asarray(o[i])
            if cfg.moe is not None and mesh_shape == MESHES[0]:
                # expert parallelism off: the dense route under TP
                rp = sh.make_recipe(replace(sh.make_plan(mesh, cfg), ep=False),
                                    cfg, ShapeConfig(S, B))
                model = params_from_jax(tree, cfg, device="cpu", plan=rp)
                with torch.no_grad():
                    out[arch + "/noep_logits"] = _prefill(model, toks, cfg,
                                                          rp)[0].numpy()
                out[arch + "/noep_route"] = np.asarray(
                    tblk.moe_route(cfg, rp, "prefill", S))
        _engines(inp, mesh, out)
        np.savez(os.path.join(work, f"rank{rank}_{d}x{m}.npz"), **out)
    finally:
        tblk.SP_MIN_PARAMS = sp_min
        dist.destroy_process_group()


def _engines(inp, mesh, out) -> None:
    """This mesh's ENGINE_CASES engines with the mesh's recipe (SP in
    prefill) and with none."""
    from repro_torch import sharding as sh
    from repro_torch.bridge import params_from_jax
    from repro_torch.config import ShapeConfig, reduced_config
    from repro_torch.models import blocks as tblk

    prompts = inp["engine/prompts"]
    sp_min = tblk.SP_MIN_PARAMS
    for shape, arch, layout, chunk in ENGINE_CASES:
        if shape != tuple(mesh.shape):
            continue
        cfg = replace(reduced_config(arch), dtype="float32")
        if cfg.moe:
            # full capacity: expert parallelism drops no assignment, so it
            # computes what the dense path does (the reference's own
            # exactness regime, test_ep_moe_exact_at_full_capacity)
            cfg = replace(cfg, moe=replace(
                cfg.moe, capacity_factor=float(cfg.moe.num_experts)))
        tree = _tree(inp, arch)
        recipe = sh.make_recipe(sh.make_plan(mesh, cfg), cfg,
                                ShapeConfig(64, 4))
        key = f"engine/{arch}/{layout}/{chunk}"
        with torch.no_grad():
            local = params_from_jax(tree, cfg, device="cpu")
            for name, v in _serve(cfg, local, None, prompts, layout,
                                  chunk).items():
                out[f"{key}/none/{name}"] = v
            sharded = params_from_jax(tree, cfg, device="cpu", plan=recipe)
            try:
                tblk.SP_MIN_PARAMS = 0
                for name, v in _serve(cfg, sharded, recipe, prompts, layout,
                                      chunk).items():
                    out[f"{key}/recipe/{name}"] = v
            finally:
                tblk.SP_MIN_PARAMS = sp_min
        out[key + "/seq_axes"] = np.asarray(",".join(recipe.seq_axes))


def _wait(ctx, mesh, deadline):
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
    return None


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The inputs, then the reference (both meshes, one process) with the
    ranks beside it, mesh by mesh: at most five processes beside this
    one."""
    work = tmp_path_factory.mktemp("sharded_blocks")
    _make_inputs(work / "inputs.npz")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    args = [str(a) for a in (B, S, SMAX, T0, STEPS, FED, K_STEPS)]
    ref = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(JAX_SCRIPT), str(work), *args,
         ",".join(ARCHS), ",".join(f"{d}x{m}" for d, m in MESHES)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    deadline = time.monotonic() + TIMEOUT
    port = {}
    try:
        for mesh in MESHES:
            d, m = mesh
            ctx = mp.start_processes(
                _rank_main, args=(d * m, mesh, str(work)), nprocs=d * m,
                join=False, start_method="spawn")
            port[mesh] = _wait(ctx, mesh, deadline) or [
                dict(np.load(work / f"rank{r}_{d}x{m}.npz"))
                for r in range(d * m)]
        try:
            _, err = ref.communicate(
                timeout=max(deadline - time.monotonic(), 1.0))
            err = f"reference failed:\n{err[-3000:]}" if ref.returncode \
                else ""
        except subprocess.TimeoutExpired:
            err = "the reference timed out"
    finally:
        if ref.poll() is None:
            ref.kill()
    out, refs = {}, {}
    for mesh in MESHES:
        path = work / f"ref_{mesh[0]}x{mesh[1]}.npz"
        refs[mesh] = err or (dict(np.load(path)) if path.exists()
                             else "the reference wrote no results")
    for mesh in MESHES:
        ref = refs[mesh]
        if not isinstance(ref, str) and not isinstance(refs[MESHES[-1]], str):
            # the dense configs' values, from the last mesh
            ref = {**refs[MESHES[-1]], **ref}
        out[mesh] = (ref, port[mesh])
    out["inputs"] = dict(np.load(work / "inputs.npz"))
    return out


def _get(runs, mesh):
    ref, ranks = runs[mesh]
    assert not isinstance(ref, str), ref
    assert not isinstance(ranks, str), ranks
    return ref, ranks


def _piece(arr, spec: str, coords, mesh, lead: int = 0):
    """This rank's piece of the global ``arr`` by a reference spec string
    ("|"-separated dims, each "", an axis or "a,b"), skipping ``lead``
    leading dims of ``arr`` that the spec does not cover."""
    sizes = {"data": mesh[0], "model": mesh[1]}
    coord = {"data": int(coords[0]), "model": int(coords[1])}
    idx = [slice(None)] * arr.ndim
    for i, axes in enumerate(spec.split("|") if spec else []):
        if not axes:
            continue
        n, c = 1, 0
        for a in axes.split(","):
            n, c = n * sizes[a], c * sizes[a] + coord[a]
        dim = lead + i
        b = arr.shape[dim] // n
        idx[dim] = slice(c * b, (c + 1) * b)
    return arr[tuple(idx)]


def _cases():
    return [(mesh, arch, fsdp) for mesh in MESHES for arch in ARCHS
            for fsdp in _fsdp(mesh)]


def _id(case):
    return "-".join(str(c) for c in case)


@pytest.mark.parametrize("mesh,arch,fsdp", _cases(),
                         ids=[_id(c) for c in _cases()])
def test_param_pieces_follow_the_reference_specs(runs, mesh, arch, fsdp):
    """Every parameter a rank holds is exactly its piece of the reference's
    global leaf as the reference's ``param_specs`` cut it (block leaves
    are stacked there: layer g * group_size + j is index g of b{j})."""
    from repro_torch.config import reduced_config
    ref, ranks = _get(runs, mesh)
    inp = runs["inputs"]
    gs = reduced_config(arch).group_size
    pre = f"{arch}/{fsdp}/param/"
    for got in ranks:
        names = [k for k in got if k.startswith(pre)]
        assert names
        split = 0
        for key in names:
            name = key[len(pre):]
            parts = name.split(".")
            if parts[0] == "blocks":
                li = int(parts[1])
                path = f"blocks/b{li % gs}/" + "/".join(parts[2:])
                spec = str(ref[f"{arch}/{fsdp}/pspec/{path}"])
                want = _piece(inp[f"{arch}/param/{path}"], spec,
                              got["coords"], mesh)[li // gs]
                spec = spec.split("|", 1)[1] if "|" in spec else ""
            else:
                path = name.replace(".", "/")
                spec = str(ref[f"{arch}/{fsdp}/pspec/{path}"])
                want = _piece(inp[f"{arch}/param/{path}"], spec,
                              got["coords"], mesh)
            split += bool(spec.replace("|", ""))
            np.testing.assert_array_equal(got[key], want, err_msg=name)
        assert split > 0        # the mesh cut some of the leaves


@pytest.mark.parametrize("mesh,arch,fsdp", _cases(),
                         ids=[_id(c) for c in _cases()])
@pytest.mark.parametrize("sp", [False, True], ids=["nosp", "sp"])
def test_prefill_logits_tokens_and_cache_pieces(runs, mesh, arch, fsdp, sp):
    """Prefill on every rank: the last position's logits (B, V_pad) within
    1e-5 of the reference's, its next tokens exact, and each cache leaf's
    piece — the reference's global cache cut by its own
    ``cache_sharding`` specs — within 1e-5; with the Megatron-SP residual
    stream on and off."""
    ref, ranks = _get(runs, mesh)
    key = f"{arch}/{fsdp}/{sp}"
    for got in ranks:
        assert bool(got[key + "/sp_on"]) == sp
        rows = _piece(np.arange(B), "data" if mesh[0] > 1 else "",
                      got["coords"], mesh)
        np.testing.assert_allclose(got[key + "/logits"],
                                   ref[arch + "/logits"][rows], atol=TOL,
                                   rtol=TOL)
        np.testing.assert_array_equal(got[key + "/prefill_nxt"],
                                      ref[arch + "/prefill_nxt"])
        leaves = [k for k in got if k.startswith(key + "/pcache/")]
        assert leaves
        for leaf in leaves:
            name = leaf[len(key + "/pcache/"):]
            want = _piece(ref[f"{arch}/pcache/{name}"],
                          str(ref[f"{arch}/cspec/{name}"]), got["coords"],
                          mesh)
            np.testing.assert_allclose(got[leaf], want, atol=TOL, rtol=TOL,
                                       err_msg=name)


@pytest.mark.parametrize("mesh,arch,fsdp", _cases(),
                         ids=[_id(c) for c in _cases()])
def test_decode_and_block_tokens(runs, mesh, arch, fsdp):
    """Uniform decode steps against sequence-sharded strips (the first
    steps fed, the rest greedy) and the fused K-step block on per-slot
    strips give the reference's tokens, step count and slot state on every
    rank."""
    ref, ranks = _get(runs, mesh)
    key = f"{arch}/{fsdp}"
    assert int(ref[arch + "/block_n"]) >= 2
    for got in ranks:
        np.testing.assert_array_equal(got[key + "/decode"],
                                      ref[arch + "/decode"])
        for n in ("out", "n", "pos", "alive"):
            np.testing.assert_array_equal(got[f"{key}/block_{n}"],
                                          ref[f"{arch}/block_{n}"])


@pytest.mark.parametrize("mesh,arch,layout,chunk", ENGINE_CASES,
                         ids=[_id(c) for c in ENGINE_CASES])
def test_engine_with_recipe_matches_no_recipe(runs, mesh, arch, layout,
                                              chunk):
    """ServeEngine(recipe=...) — sequence axes ("model",), SP in prefill,
    the paged pools read through their strip view on each rank's block,
    MLA and ring strips in blocks, experts by rank, and on the (2, 2) mesh
    the slots split over the data axis — gives every rank the tokens,
    ledgers and KV peak of the same engine with no recipe.  The MoE configs run at full expert capacity:
    below it the expert-parallel prefill drops assignments that the dense
    path keeps, in the reference as here, and the two engines differ by
    design."""
    _, ranks = _get(runs, mesh)
    key = f"engine/{arch}/{layout}/{chunk}"
    for got in ranks:
        assert str(got[key + "/seq_axes"]) == "model"
        for name in ("tokens", "lens", "ledger", "kv_peak", "layout",
                     "chunked"):
            np.testing.assert_array_equal(got[f"{key}/recipe/{name}"],
                                          got[f"{key}/none/{name}"],
                                          err_msg=name)
        assert int(got[key + "/none/lens"].sum()) > 0
    if chunk:
        assert int(ranks[0][key + "/none/chunked"]) == chunk


@pytest.mark.parametrize("arch", [a for a in ARCHS if a.startswith(
    ("llama4", "deepseek"))])
def test_moe_prefill_with_expert_parallelism_off(runs, arch):
    """A plan with ``ep`` off takes the dense route on the (1, 2) mesh —
    every expert gathered whole on each rank, the shared experts and
    attention still TP — and gives the reference's logits with ``ep`` off
    within 1e-5 on every rank."""
    ref, ranks = _get(runs, MESHES[0])
    for got in ranks:
        assert str(got[arch + "/noep_route"]) == "dense"
        np.testing.assert_allclose(got[arch + "/noep_logits"],
                                   ref[arch + "/noep_logits"], atol=TOL,
                                   rtol=TOL)


class _JaxMesh:
    """A stand-in for a JAX mesh: the reference's plans read only its axis
    names and sizes."""

    def __init__(self, d, m):
        self.axis_names = ("data", "model")
        self.shape = {"data": d, "model": m}


class _TorchMesh:
    """A stand-in for a DeviceMesh: specs read only the axis sizes."""

    def __init__(self, d, m):
        self.mesh_dim_names = ("data", "model")
        self._sizes = (d, m)

    def size(self, i):
        return self._sizes[i]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", [(3, 2), (2, 4), (1, 3), (8, 1)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_param_specs_match_the_reference(arch, shape):
    """``sharding.param_specs`` gives every parameter the reference's
    ``param_specs`` spec (block leaves unstacked), FSDP off and on, on mesh
    shapes whose axes divide some dimensions and not others — a dimension
    an axis does not divide stays whole, as the reference replicates it
    (a 3-way FSDP axis does not divide d_model 64, so the vocabulary
    tables keep their columns whole).  The rank processes of this module
    import it, so JAX is imported here, not at the top."""
    import jax
    from repro.config import reduced_config as j_reduced
    from repro.models import model as JM
    from repro.sharding import make_plan as j_plan, param_specs as j_specs
    from repro_torch import sharding as sh
    from repro_torch.config import reduced_config
    from repro_torch.launch.steps import params_sharding

    cfg = replace(reduced_config(arch), dtype="float32")
    jcfg = replace(j_reduced(arch), dtype="float32")
    gs = cfg.group_size
    for fsdp in (False, True):
        want = {}
        for path, spec in jax.tree_util.tree_flatten_with_path(
                j_specs(j_plan(_JaxMesh(*shape), jcfg, fsdp=fsdp),
                        JM.abstract_params(jcfg)),
                is_leaf=lambda x: type(x).__name__ == "PartitionSpec")[0]:
            want["/".join(str(p.key) for p in path)] = tuple(spec)
        plan = sh.make_plan(_TorchMesh(*shape), cfg, fsdp=fsdp)
        recipe = sh.ShardingRecipe(plan=plan, batch_axes=(), seq_axes=())
        seen = set()
        for name, spec in params_sharding(recipe, cfg).items():
            parts = name.split(".")
            if parts[0] == "blocks":
                key = "/".join([f"blocks/b{int(parts[1]) % gs}"] + parts[2:])
                ref = want[key][1:]            # unstacked
            else:
                key = name.replace(".", "/")
                ref = want[key]
            seen.add(key)
            ref = ref + (None,) * (len(spec) - len(ref))
            assert spec == ref, (fsdp, name, spec, ref)
        assert seen == set(want)

