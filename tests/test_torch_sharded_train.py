"""Training under a mesh: the port's loss, gradient pieces and AdamW
steps on gloo ranks against the JAX package's on the same mesh, on the
CPU.

Meshes (1, 2) and (2, 2) over ("data", "model"), FSDP off on the first
and on on the second (its data axis, which the (1, 2) mesh holds once),
for six reduced configs in float32: yi-9b, gemma3-12b (sliding-window
layers), hymba-1.5b (attention beside Mamba) and xlstm-125m (mLSTM and
sLSTM) — TP, the vocab-sharded lookup and loss head, Megatron-SP — and
llama4-scout-17b-a16e and deepseek-v2-236b (MLA) with expert parallelism
over the model axis at full capacity (``capacity_factor`` = the expert
count, so no assignment is dropped).

* The weights are the port's ``init_params`` (seed 0), the tokens and
  labels numpy's (seed 0; a few labels -1, masked); this process writes
  them to ``inputs.npz`` in the reference's stacked layout.
* The reference runs once, in one subprocess, with four host devices,
  ``AxisType.Auto`` axes and a single-threaded XLA CPU client: on each
  mesh, two steps of ``build_train_step`` (the metrics, then the
  parameters and the moments).  The first step's learning rate is 0 (the
  schedule warms up from 0), so its metrics are the loss of the weights
  given, and its m, (1 - b1) times the clipped gradient, gives the global
  gradient of ``loss_fn``: one compile a config and mesh.  A mesh changes a dense config's
  values only in the order of float sums, so those come from the (2, 2)
  mesh alone and hold both meshes; the MoE configs' loss depends on the
  mesh (each rank's load loss over its own tokens, averaged), so theirs
  come from each.  It also hands over its parameter specs, by which the
  global arrays are cut into the pieces a rank must hold.
* The port runs one process per rank (``torch.multiprocessing.spawn``,
  one thread each) in a ``gloo`` group: ``steps.loss_and_grads`` and two
  steps of ``steps.build_train_step`` on weights cut by
  ``bridge.params_from_jax(..., plan=...)``.  The Megatron-SP residual
  stream turns on only from 1e9 parameters, so the ranks lower
  ``blocks.SP_MIN_PARAMS`` to reach it; on the (1, 2) mesh they also
  take the gradients with SP off.  The reference gives the same numbers
  with SP or without, and stays as it is.
* Port-side only: ``optim.compressed_psum`` against the exact sum over
  the (1, 2) mesh's model axis; a checkpoint saved on (1, 2) restored on
  (2, 2) with FSDP and on no mesh; ``train_loop.train(mesh=...)`` for 4
  steps against 2 steps, a stop and a resume to 4.

Tolerances: the loss and metrics within 1e-5 (float32 sums in another
order); every gradient piece within 1e-4 of its leaf's max |grad|; the
gradient norm within 1e-5 relative; after two steps, v within the
tolerance of ``test_adamw_matches_reference_three_steps``
(test_torch_train.py: OPT_ATOL of max(|v|, 1e-3)), m within the
gradients' tolerance, and the parameters within that test's OPT_ATOL
but for at most one element in a thousand, which AdamW's normalised
update moves by its float-noise gradient, and within PARAM_ATOL
everywhere.  Restores and the resume are exact.
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
MESHES = [((1, 2), False), ((2, 2), True)]       # (shape, fsdp)
ARCHS = ("yi-9b", "gemma3-12b", "hymba-1.5b", "xlstm-125m",
         "llama4-scout-17b-a16e", "deepseek-v2-236b")
B, S = 4, 16
LR = 1e-3
SCHEDULE = {"warmup": 2, "total": 10}
STEPS = 2
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4          # of the leaf's max |grad|
NORM_RTOL = 1e-5
OPT_ATOL = 1e-6
# AdamW's update m / (sqrt(v) + 1e-8) normalises each gradient element, so
# an element whose gradient is at the float-noise level moves by up to lr
# either way, with the order of float sums: without a mesh the port and
# the reference already differ by up to 3.1e-5 here after two steps.  A
# wrong piece moves most of a leaf's elements; these few move alone.
PARAM_ATOL = 1e-4        # a twentieth of the 2 * LR two steps can move
PARAM_OUTLIERS = 1e-3    # the share of elements past OPT_ATOL
PSUM_SEEDS = 64
TIMEOUT = 900            # seconds for everything the fixture starts

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
from repro.launch import steps as ST
from repro.models import model as M
from repro.optim import AdamWConfig, adamw_init
from repro.sharding import make_plan, make_recipe, param_specs

work = sys.argv[1]
B, S, STEPS = (int(a) for a in sys.argv[2:5])
LR = float(sys.argv[5])
warmup, total = (int(a) for a in sys.argv[6:8])
archs = sys.argv[8].split(",")
meshes = [(tuple(int(n) for n in m.rstrip("f").split("x")), m.endswith("f"))
          for m in sys.argv[9].split(",")]
inp = dict(np.load(os.path.join(work, "inputs.npz")))


def spec_str(spec):
    return "|".join(",".join(a) if isinstance(a, tuple) else (a or "")
                    for a in spec)


def flat(tree, is_leaf=None):
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=is_leaf)[0]:
        yield "/".join(str(p.key) for p in path), leaf


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


for (d, m), fsdp in meshes:
    mesh = jax.make_mesh((d, m), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:d * m])
    out = {}
    for arch in archs:
        cfg = replace(reduced_config(arch), dtype="float32")
        if cfg.moe:
            cfg = replace(cfg, moe=replace(
                cfg.moe, capacity_factor=float(cfg.moe.num_experts)))
        plan = make_plan(mesh, cfg, fsdp=fsdp)
        for name, spec in flat(param_specs(plan, M.abstract_params(cfg)),
                               lambda x: isinstance(
                                   x, jax.sharding.PartitionSpec)):
            out[f"{arch}/pspec/{name}"] = np.asarray(spec_str(spec))
        if cfg.moe is None and ((d, m), fsdp) != meshes[-1]:
            # a dense config's values do not depend on the mesh (only the
            # order of float sums does): the last mesh's serve every mesh
            continue
        rec = make_recipe(plan, cfg, ShapeConfig("t", S, B, "train"))
        params = tree(arch)
        batch = {"tokens": jnp.asarray(inp[arch + "/tokens"]),
                 "labels": jnp.asarray(inp[arch + "/labels"])}
        opt_cfg = AdamWConfig(lr=LR)
        step, _ = ST.build_train_step(cfg, rec, opt_cfg,
                                      {"warmup": warmup, "total": total}, 1)
        opt = adamw_init(params, opt_cfg)
        # compiled once: a jitted call would compile again for the
        # layouts the first step's outputs come back in
        step = jax.jit(step).lower(params, opt, batch).compile()
        for i in range(STEPS):
            params, opt, met = step(params, opt, batch)
            for k, v in met.items():
                out[f"{arch}/step{i}/{k}"] = np.asarray(v)
            if i == 0:
                # the first step's learning rate is 0 (warmup from 0), so
                # its loss and gradients are those of the weights given;
                # its m is (1 - b1) times the gradient clipped by scale
                gn = np.float32(met["grad_norm"])
                scale = np.minimum(np.float32(1.0), np.float32(
                    opt_cfg.clip_norm) / np.maximum(gn, np.float32(1e-9)))
                for k in ("loss", "xent", "aux", "tokens"):
                    out[f"{arch}/{k}"] = np.asarray(met[k])
                for name, mm in flat(opt["m"]):
                    out[f"{arch}/grad/{name}"] = np.asarray(mm) / np.float32(
                        1 - opt_cfg.b1) / scale
        for part, t in (("param", params), ("m", opt["m"]), ("v", opt["v"])):
            for name, a in flat(t):
                out[f"{arch}/after/{part}/{name}"] = np.asarray(a)
    tag = f"{d}x{m}"
    np.savez(os.path.join(work, f"ref_{tag}.tmp.npz"), **out)
    os.replace(os.path.join(work, f"ref_{tag}.tmp.npz"),
               os.path.join(work, f"ref_{tag}.npz"))
print("OK")
'''


def _cfg(arch):
    from repro_torch.config import reduced_config
    cfg = replace(reduced_config(arch), dtype="float32")
    if cfg.moe:
        cfg = replace(cfg, moe=replace(
            cfg.moe, capacity_factor=float(cfg.moe.num_experts)))
    return cfg


def _make_inputs(path) -> None:
    """The weights (the port's ``init_params``, seed 0, stacked as the
    reference's ``blocks/b{j}`` leaves: layer g * group_size + j is index
    g of b{j}), tokens and labels (a few masked) for both sides."""
    from repro_torch.models import model as TM

    rng = np.random.default_rng(0)
    inp = {}
    for arch in ARCHS:
        cfg = _cfg(arch)
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
        labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        labels[0, :3] = -1
        labels[2, -2:] = -1
        inp[arch + "/labels"] = labels
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


def _pieces(prefix, named, out) -> None:
    for name, t in named:
        out[f"{prefix}/{name}"] = t.detach().float().numpy().copy()


def _rank_main(rank: int, world: int, mesh_shape, fsdp: bool,
               work: str) -> None:
    """One rank of the port's run on a (data, model) gloo mesh: writes what
    this rank holds and computes to ``rank{rank}_{d}x{m}.npz``."""
    from repro_torch import sharding as sh
    from repro_torch.bridge import params_from_jax
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.config import ShapeConfig
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import blocks as tblk
    from repro_torch.optim import AdamWConfig, adamw_init, compressed_psum

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
            cfg = _cfg(arch)
            plan = sh.make_plan(mesh, cfg, fsdp=fsdp)
            recipe = sh.make_recipe(plan, cfg, ShapeConfig(S, B))
            batch = {k: torch.from_numpy(inp[f"{arch}/{k}"])
                     for k in ("tokens", "labels")}
            model = params_from_jax(_tree(inp, arch), cfg, device="cpu",
                                    plan=recipe)
            for sp in ((True, False) if d == 1 else (True,)):
                tblk.SP_MIN_PARAMS = 0 if sp else sp_min
                key = f"{arch}/{sp}"
                out[key + "/sp_on"] = np.asarray(
                    tblk.sp_enabled(cfg, recipe, S, "train"))
                loss, met, grads = steps.loss_and_grads(model, batch, cfg,
                                                        recipe)
                out[key + "/loss"] = loss.numpy()
                for k, v in met.items():
                    out[f"{key}/{k}"] = v.numpy()
                _pieces(key + "/grad", grads.items(), out)
            tblk.SP_MIN_PARAMS = 0
            opt_cfg = AdamWConfig(lr=LR)
            step, _ = steps.build_train_step(cfg, recipe, opt_cfg, SCHEDULE,
                                             1, device="cpu")
            opt = adamw_init(dict(model.named_parameters()), opt_cfg)
            for i in range(STEPS):
                _, _, met = step(model, opt, batch)
                for k, v in met.items():
                    out[f"{arch}/step{i}/{k}"] = v.detach().numpy()
            _pieces(arch + "/after/param", model.named_parameters(), out)
            for part in ("m", "v"):
                _pieces(f"{arch}/after/{part}", opt[part].items(), out)
            tblk.SP_MIN_PARAMS = sp_min
            if arch == "yi-9b":
                tree = {"params": dict(model.named_parameters()),
                        "opt": opt}
                specs = {"params": model.specs,
                         "opt": {"m": model.specs, "v": model.specs,
                                 "step": ()}}
                if mesh_shape == MESHES[0][0]:
                    save_checkpoint(Path(work) / "ckpt", STEPS, tree,
                                    plan=recipe, specs=specs)
                    dist.barrier()
                else:
                    _accum_step(inp, cfg, recipe, batch, out)
                    got, man = restore_checkpoint(Path(work) / "ckpt", tree,
                                                  plan=recipe)
                    out["restore/step"] = np.asarray(man["step"])
                    _pieces("restore/params", got["params"].items(), out)
                    for part in ("m", "v"):
                        _pieces(f"restore/{part}", got["opt"][part].items(),
                                out)
        if mesh_shape == MESHES[0][0]:
            _psum_and_resume(mesh, work, out, compressed_psum)
        np.savez(os.path.join(work, f"rank{rank}_{d}x{m}.npz"), **out)
    finally:
        tblk.SP_MIN_PARAMS = sp_min
        dist.destroy_process_group()


ACCUM = 2


def _accum_step(inp, cfg, recipe, batch, out, prefix="accum"):
    """One ``build_train_step`` step at accum ACCUM from the inputs'
    weights: its metrics and this rank's m (the first step's lr is 0, so
    m is (1 - b1) times the clipped gradient of the ACCUM microbatches)."""
    from repro_torch.bridge import params_from_jax
    from repro_torch.launch import steps
    from repro_torch.optim import AdamWConfig, adamw_init

    model = params_from_jax(_tree(inp, "yi-9b"), cfg, device="cpu",
                            plan=recipe)
    opt_cfg = AdamWConfig(lr=LR)
    step, _ = steps.build_train_step(cfg, recipe, opt_cfg, SCHEDULE, ACCUM,
                                     device="cpu")
    opt = adamw_init(dict(model.named_parameters()), opt_cfg)
    _, _, met = step(model, opt, batch)
    for k, v in met.items():
        out[f"{prefix}/{k}"] = v.detach().numpy()
    _pieces(prefix + "/m", opt["m"].items(), out)


def _psum_and_resume(mesh, work, out, compressed_psum) -> None:
    """On the (1, 2) mesh: ``compressed_psum`` over the model axis for
    PSUM_SEEDS seeds, and the uninterrupted and resumed ``train`` runs."""
    from repro_torch import sharding as sh
    from repro_torch.config import ShapeConfig
    from repro_torch.data import DataConfig
    from repro_torch.train.train_loop import TrainConfig, train

    r = mesh.get_local_rank("model")
    cfg = _cfg("yi-9b")
    plan = sh.make_recipe(sh.make_plan(mesh, cfg), cfg, ShapeConfig(S, B))
    x = torch.from_numpy(np.random.default_rng(7).normal(
        size=(2, 8, 64)).astype(np.float32))[r]
    got = [compressed_psum(x, plan, "model",
                           torch.Generator().manual_seed(1000 * s + r))
           for s in range(PSUM_SEEDS)]
    out["psum/got"] = torch.stack(got).numpy()
    dcfg = DataConfig(seq_len=S, global_batch=B, vocab_size=cfg.vocab_size)
    kw = dict(log_every=100, lr=LR, warmup=SCHEDULE["warmup"])
    full = train(cfg, dcfg, TrainConfig(steps=4, ckpt_every=100, **kw),
                 mesh=mesh, device="cpu")
    ck = str(Path(work) / "resume")
    train(cfg, dcfg, TrainConfig(steps=2, ckpt_every=2, ckpt_dir=ck, **kw),
          mesh=mesh, device="cpu")
    resumed = train(cfg, dcfg, TrainConfig(steps=4, ckpt_every=100,
                                           ckpt_dir=ck, **kw),
                    mesh=mesh, device="cpu")
    out["resume/steps"] = np.asarray([full.step, resumed.step])
    for tag, st in (("full", full), ("resumed", resumed)):
        _pieces(f"resume/{tag}/param", st.params.named_parameters(), out)
        for part in ("m", "v"):
            _pieces(f"resume/{tag}/{part}", st.opt_state[part].items(), out)


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


def _tag(mesh) -> str:
    return f"{mesh[0]}x{mesh[1]}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The inputs, then the reference (both meshes, one process) with the
    ranks beside it, mesh by mesh: at most five processes beside this
    one."""
    work = tmp_path_factory.mktemp("sharded_train")
    _make_inputs(work / "inputs.npz")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    args = [str(a) for a in (B, S, STEPS, LR, SCHEDULE["warmup"],
                             SCHEDULE["total"])]
    ref = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(JAX_SCRIPT), str(work), *args,
         ",".join(ARCHS),
         ",".join(_tag(mesh) + ("f" if fsdp else "") for mesh, fsdp in MESHES)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    deadline = time.monotonic() + TIMEOUT
    port = {}
    try:
        for mesh, fsdp in MESHES:
            d, m = mesh
            ctx = mp.start_processes(
                _rank_main, args=(d * m, mesh, fsdp, str(work)),
                nprocs=d * m, join=False, start_method="spawn")
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
    refs = {}
    for mesh, _ in MESHES:
        path = work / f"ref_{_tag(mesh)}.npz"
        refs[mesh] = err or (dict(np.load(path)) if path.exists()
                             else "the reference wrote no results")
    last = MESHES[-1][0]
    out = {}
    for mesh, _ in MESHES:
        ref = refs[mesh]
        if not isinstance(ref, str) and not isinstance(refs[last], str):
            # the dense configs' values, from the last mesh; the specs of
            # this mesh
            ref = {**{k: v for k, v in refs[last].items()
                      if "/pspec/" not in k}, **ref}
        out[mesh] = (ref, port[mesh])
    out["inputs"] = dict(np.load(work / "inputs.npz"))
    out["work"] = work
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


def _want(ref, arch, kind, name, coords, mesh, gs):
    """The reference's global leaf ``name`` (a port state-dict name) of
    kind ``grad`` / ``after/param`` / ``after/m`` / ``after/v``, cut to
    the piece of the rank at ``coords`` by the reference's spec; also
    the whole leaf (the layer's slice of a stacked one)."""
    parts = name.split(".")
    if parts[0] == "blocks":
        li = int(parts[1])
        path = f"blocks/b{li % gs}/" + "/".join(parts[2:])
        whole = ref[f"{arch}/{kind}/{path}"]
        spec = str(ref[f"{arch}/pspec/{path}"])
        return _piece(whole, spec, coords, mesh)[li // gs], whole[li // gs]
    path = name.replace(".", "/")
    whole = ref[f"{arch}/{kind}/{path}"]
    return _piece(whole, str(ref[f"{arch}/pspec/{path}"]), coords,
                  mesh), whole


def _cases(with_sp: bool = True):
    return [(mesh, fsdp, arch, sp) for mesh, fsdp in MESHES for arch in ARCHS
            for sp in ((True, False) if with_sp and mesh[0] == 1
                       else (True,))]


def _id(case):
    return "-".join(str(c) for c in case)


@pytest.mark.parametrize("mesh,fsdp,arch,sp", _cases(),
                         ids=[_id(c) for c in _cases()])
def test_loss_and_metrics_match_reference(runs, mesh, fsdp, arch, sp):
    """The loss, the cross-entropy, the load loss and the token count on
    every rank within LOSS_TOL of the reference's ``loss_fn`` on the same
    mesh (the MoE configs' load loss is the reference's mesh value: each
    rank's over its own tokens, averaged over the mesh)."""
    ref, ranks = _get(runs, mesh)
    key = f"{arch}/{sp}"
    for got in ranks:
        assert bool(got[key + "/sp_on"]) == sp
        for k in ("loss", "xent", "aux", "tokens"):
            assert abs(float(got[f"{key}/{k}"]) - float(ref[f"{arch}/{k}"])) \
                <= LOSS_TOL, (k, float(got[f"{key}/{k}"]),
                              float(ref[f"{arch}/{k}"]))
    assert float(ref[arch + "/tokens"]) == B * S - 5


@pytest.mark.parametrize("mesh,fsdp,arch,sp", _cases(),
                         ids=[_id(c) for c in _cases()])
def test_gradient_pieces_match_reference(runs, mesh, fsdp, arch, sp):
    """Every rank's piece of every parameter's gradient — the embedding
    table and the head through the vocab-sharded lookup and loss, the
    routers, the norms, the FSDP pieces — within GRAD_TOL of the leaf's
    max |grad| of the reference's global gradient cut by its specs, and
    the embedding's and the head's pieces nonzero."""
    ref, ranks = _get(runs, mesh)
    gs = _cfg(arch).group_size
    pre = f"{arch}/{sp}/grad/"
    for got in ranks:
        names = [k[len(pre):] for k in got if k.startswith(pre)]
        assert names
        for name in names:
            want, whole = _want(ref, arch, "grad", name, got["coords"], mesh,
                                gs)
            scale = max(float(np.abs(whole).max()), 1e-30)
            err = float(np.abs(got[pre + name] - want).max()) / scale
            assert err <= GRAD_TOL, (name, err)
        for name in ("embed.table", "head.w_head"):
            if pre + name in got:
                assert float(np.abs(got[pre + name]).max()) > 0, name


@pytest.mark.parametrize("mesh,fsdp,arch,sp", _cases(False),
                         ids=[_id(c) for c in _cases(False)])
def test_two_steps_match_reference(runs, mesh, fsdp, arch, sp):
    """Two steps of ``build_train_step`` (SP on where it applies): each
    step's loss within LOSS_TOL and global gradient norm within NORM_RTOL
    of the reference's ``build_train_step`` on the same mesh; then every
    rank's pieces of the moments and parameters: v within OPT_ATOL of
    max(|v|, 1e-3) and m within GRAD_TOL of the leaf's max |m| (m is
    linear in the gradients, so it takes their tolerance); the
    parameters within OPT_ATOL on all but PARAM_OUTLIERS of a config's
    elements and within PARAM_ATOL on every one (see PARAM_ATOL)."""
    ref, ranks = _get(runs, mesh)
    gs = _cfg(arch).group_size
    for got in ranks:
        for i in range(STEPS):
            pre = f"{arch}/step{i}/"
            assert abs(float(got[pre + "loss"]) - float(ref[pre + "loss"])) \
                <= LOSS_TOL
            gn = float(ref[pre + "grad_norm"])
            assert abs(float(got[pre + "grad_norm"]) - gn) <= NORM_RTOL * gn
        off, total = 0, 0
        for part in ("param", "m", "v"):
            pre = f"{arch}/after/{part}/"
            names = [k[len(pre):] for k in got if k.startswith(pre)]
            assert names
            for name in names:
                want, whole = _want(ref, arch, "after/" + part, name,
                                    got["coords"], mesh, gs)
                err = np.abs(got[pre + name] - want)
                if part == "param":
                    assert float(err.max()) <= PARAM_ATOL, (name, err.max())
                    off += int((err > OPT_ATOL).sum())
                    total += err.size
                elif part == "m":
                    assert float(err.max()) <= GRAD_TOL * float(
                        np.abs(whole).max()), (name, err.max())
                else:
                    assert (err <= OPT_ATOL * np.maximum(
                        np.abs(want), 1e-3)).all(), (name, err.max())
        assert off <= PARAM_OUTLIERS * total, (off, total)


def test_compressed_psum_matches_psum(runs):
    """int8 ``compressed_psum`` over the (1, 2) mesh's model axis: within
    the reference test's bound (2 ranks x 2 x amax / 127) of the exact
    sum on every rank and seed, the same on both ranks, and unbiased: the
    mean error over PSUM_SEEDS seeds is within 4 standard errors of 0
    (a rounding error has variance at most 1/4 step² a rank)."""
    _, ranks = _get(runs, MESHES[0][0])
    x = np.random.default_rng(7).normal(size=(2, 8, 64)).astype(np.float32)
    want = x.sum(0)
    amax = float(np.abs(x).max())
    got = [r["psum/got"] for r in ranks]
    np.testing.assert_array_equal(got[0], got[1])
    err = got[0] - want[None]
    assert float(np.abs(err).max()) <= 2 * 2 * amax / 127.0 + 1e-6
    step = amax / 127.0
    se = np.sqrt(2 * 0.25 * step ** 2 / PSUM_SEEDS)
    assert float(np.abs(err.mean(0)).max()) <= 4 * se
    assert float(np.abs(err).max()) > 0        # it did round


def test_checkpoint_restores_on_another_mesh(runs):
    """yi-9b's state after two steps on (1, 2), saved as global arrays,
    restores on (2, 2) with FSDP: every rank's restored piece of every
    parameter and moment equals the saved global array cut by the
    (2, 2) mesh's specs, exactly."""
    ref, ranks = _get(runs, MESHES[1][0])
    gs = _cfg("yi-9b").group_size
    saved = _saved_global(runs)
    for got in ranks:
        assert int(got["restore/step"]) == STEPS
        for part in ("params", "m", "v"):
            pre = f"restore/{part}/"
            names = [k[len(pre):] for k in got if k.startswith(pre)]
            assert names
            for name in names:
                path = name.replace(".", "/")
                if name.startswith("blocks."):
                    li = int(name.split(".")[1])
                    path = f"blocks/b{li % gs}/" + "/".join(
                        name.split(".")[2:])
                spec = str(ref[f"yi-9b/pspec/{path}"])
                if name.startswith("blocks."):
                    spec = spec.split("|", 1)[1] if "|" in spec else ""
                want = _piece(saved[part][name], spec, got["coords"],
                              MESHES[1][0])
                np.testing.assert_array_equal(got[pre + name], want,
                                              err_msg=name)


def _saved_global(runs):
    """The (1, 2) ranks' saved checkpoint restored with no mesh: the
    global arrays, by part and name."""
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.models import model as TM
    from repro_torch.optim import AdamWConfig, adamw_init
    work = runs["work"]
    cfg = _cfg("yi-9b")
    model = TM.LM(cfg, "cpu")
    params = dict(model.named_parameters())
    tree = {"params": params, "opt": adamw_init(params, AdamWConfig())}
    got, _ = restore_checkpoint(work / "ckpt", tree)
    return {"params": {n: t.numpy() for n, t in got["params"].items()},
            "m": {n: t.numpy() for n, t in got["opt"]["m"].items()},
            "v": {n: t.numpy() for n, t in got["opt"]["v"].items()}}


def test_checkpoint_restores_on_no_mesh(runs):
    """The same checkpoint restored with no mesh holds the global arrays:
    each (1, 2) rank's piece of every parameter and moment after the two
    steps is exactly that global array cut by the (1, 2) specs."""
    ref, ranks = _get(runs, MESHES[0][0])
    gs = _cfg("yi-9b").group_size
    saved = _saved_global(runs)
    for got in ranks:
        for part, pre in (("params", "yi-9b/after/param/"),
                          ("m", "yi-9b/after/m/"), ("v", "yi-9b/after/v/")):
            names = [k[len(pre):] for k in got if k.startswith(pre)]
            assert names
            for name in names:
                path = name.replace(".", "/")
                if name.startswith("blocks."):
                    li = int(name.split(".")[1])
                    path = f"blocks/b{li % gs}/" + "/".join(
                        name.split(".")[2:])
                spec = str(ref[f"yi-9b/pspec/{path}"])
                if name.startswith("blocks."):
                    spec = spec.split("|", 1)[1] if "|" in spec else ""
                want = _piece(saved[part][name], spec, got["coords"],
                              MESHES[0][0])
                np.testing.assert_array_equal(got[pre + name], want,
                                              err_msg=name)


def test_accumulated_step_matches_no_mesh(runs):
    """A step of ``build_train_step`` at accum ACCUM on the (2, 2) mesh
    with FSDP (each microbatch of B / ACCUM rows split over the data axis
    by its own recipe; the ranks' shares summed once) against the same
    step with no mesh, yi-9b: the metrics within LOSS_TOL (grad_norm
    within NORM_RTOL) and every rank's m piece within GRAD_TOL of the
    leaf's max |m| of the no-mesh m cut by the (2, 2) specs."""
    from repro_torch.config import ShapeConfig
    from repro_torch.sharding import make_plan, make_recipe
    ref, ranks = _get(runs, MESHES[1][0])
    inp = np.load(runs["work"] / "inputs.npz")
    cfg = _cfg("yi-9b")
    batch = {k: torch.from_numpy(inp[f"yi-9b/{k}"])
             for k in ("tokens", "labels")}
    local = {}
    _accum_step(inp, cfg, make_recipe(make_plan(None, cfg), cfg,
                                      ShapeConfig(S, B)), batch, local)
    gs = cfg.group_size
    for got in ranks:
        for k in ("loss", "xent", "aux", "tokens"):
            assert abs(float(got[f"accum/{k}"]) - float(local[f"accum/{k}"])) \
                <= LOSS_TOL, k
        gn = float(local["accum/grad_norm"])
        assert abs(float(got["accum/grad_norm"]) - gn) <= NORM_RTOL * gn
        names = [k[len("accum/m/"):] for k in got if k.startswith("accum/m/")]
        assert names
        for name in names:
            whole = local["accum/m/" + name]
            path = name.replace(".", "/")
            if name.startswith("blocks."):
                path = f"blocks/b{int(name.split('.')[1]) % gs}/" + "/".join(
                    name.split(".")[2:])
            spec = str(ref[f"yi-9b/pspec/{path}"])
            if name.startswith("blocks."):
                spec = spec.split("|", 1)[1] if "|" in spec else ""
            want = _piece(whole, spec, got["coords"], MESHES[1][0])
            err = float(np.abs(got["accum/m/" + name] - want).max())
            assert err <= GRAD_TOL * max(float(np.abs(whole).max()), 1e-30), \
                (name, err)


def test_resume_is_bit_equal(runs):
    """``train_loop.train(mesh=...)`` on (1, 2): 2 steps with a
    checkpoint, then a run to 4 that resumes from it, ends with every
    rank's parameter and moment pieces bit-equal to a run of 4 steps
    without a stop."""
    _, ranks = _get(runs, MESHES[0][0])
    for got in ranks:
        assert got["resume/steps"].tolist() == [4, 4]
        for part in ("param", "m", "v"):
            pre = f"resume/full/{part}/"
            names = [k[len(pre):] for k in got if k.startswith(pre)]
            assert names
            for name in names:
                np.testing.assert_array_equal(
                    got[f"resume/resumed/{part}/{name}"], got[pre + name],
                    err_msg=name)


@pytest.mark.parametrize("dtype,offset,weighted", [
    (torch.float32, 0, False), (torch.float32, 24, True),
    (torch.bfloat16, 40, False)])
def test_isp_gather_backward_matches_autograd(dtype, offset, weighted):
    """``ops.isp_gather``'s backward (a masked scatter-add into the table
    shard, float32 accumulation) against autograd through the plain
    ``isp_gather_ref`` on the CPU: ids repeat, some fall outside the
    shard (they add nothing), with and without weights.  The table's
    gradient within 1e-6 (fp32) or one bf16 rounding of the fp32 sum;
    the weights' within 1e-5."""
    from repro_torch.kernels import isp_gather as ig
    from repro_torch.kernels import ops

    rng = np.random.default_rng(3)
    v_loc, d = 32, 24
    table = torch.from_numpy(rng.normal(size=(v_loc, d)).astype(
        np.float32)).to(dtype)
    ids = torch.from_numpy(rng.integers(0, 96, (3, 20)).astype(np.int32))
    ids[0, :4] = offset + 5                     # a repeated id
    w = torch.from_numpy(rng.normal(size=(3, 20)).astype(np.float32)) \
        if weighted else None
    g = torch.from_numpy(rng.normal(size=(3, 20, d)).astype(np.float32))

    def grads(fn):
        t = table.clone().requires_grad_(True)
        ww = None if w is None else w.clone().requires_grad_(True)
        out = fn(t, ids, shard_offset=offset, weights=ww)
        out.float().backward(g.to(out.dtype).float())
        return t.grad, None if ww is None else ww.grad, out.detach()

    got_t, got_w, got_out = grads(ops.isp_gather)
    want_t, want_w, want_out = grads(ig.isp_gather_ref)
    torch.testing.assert_close(got_out, want_out, rtol=0, atol=0)
    local = ids.long() - offset
    owned = ((local >= 0) & (local < v_loc))
    assert 0 < int(owned.sum()) < ids.numel()
    exact = torch.zeros((v_loc, d), dtype=torch.float32)
    rows = g.to(dtype).float() * (1.0 if w is None else w[..., None])
    exact.index_add_(0, local[owned], rows[owned])
    if dtype == torch.float32:
        torch.testing.assert_close(got_t, want_t, rtol=0, atol=1e-6)
    else:
        torch.testing.assert_close(got_t, exact.to(dtype), rtol=0, atol=0)
        torch.testing.assert_close(got_t.float(), want_t.float(), rtol=0,
                                   atol=float(exact.abs().max()) * 2 ** -6)
    untouched = torch.ones(v_loc, dtype=torch.bool)
    untouched[local[owned].unique()] = False
    assert float(got_t[untouched].abs().max()) == 0.0
    if weighted:
        torch.testing.assert_close(got_w, want_w, rtol=0, atol=1e-5)


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


@pytest.mark.parametrize("arch", ["yi-9b", "deepseek-v2-236b",
                                  "musicgen-large"])
@pytest.mark.parametrize("shape", [(2, 2), (4, 1), (3, 2)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_opt_and_batch_sharding_match_the_reference(arch, shape):
    """``steps.opt_sharding`` (the moments as the parameters, the step
    whole) and ``steps.batch_sharding`` (the rows over the batch axes;
    a frontend's embeddings (B, S, D)) give the reference's specs, FSDP
    on, on stand-in meshes whose data axis divides the batch of 4 or not
    (3).  No collective runs; JAX is imported here, not at the top, as
    the rank processes import this module."""
    import jax
    from repro.config import ShapeConfig as JShape
    from repro.config import reduced_config as j_reduced
    from repro.launch import steps as JST
    from repro.sharding import ShardingRecipe as JRecipe
    from repro.sharding import batch_spec as j_batch_spec
    from repro.sharding import make_plan as j_plan
    from repro_torch import sharding as sh
    from repro_torch.config import ShapeConfig, reduced_config
    from repro_torch.launch import steps

    jcfg = replace(j_reduced(arch), dtype="float32")
    cfg = replace(reduced_config(arch), dtype="float32")
    jp = j_plan(_JaxMesh(*shape), jcfg, fsdp=True)
    jrec = JRecipe(plan=jp, batch_axes=j_batch_spec(jp, B)[0], seq_axes=())
    plan = sh.make_plan(_TorchMesh(*shape), cfg, fsdp=True)
    rec = sh.ShardingRecipe(plan=plan, batch_axes=sh.batch_spec(plan, B),
                            seq_axes=())
    assert rec.batch_axes == jrec.batch_axes
    gs = cfg.group_size
    jopt = JST.opt_sharding(jrec, jcfg)
    opt = steps.opt_sharding(rec, cfg)
    assert tuple(jopt["step"]) == opt["step"] == ()
    for part in ("m", "v"):
        want = {"/".join(str(p.key) for p in path): tuple(spec)
                for path, spec in jax.tree_util.tree_flatten_with_path(
                    jopt[part], is_leaf=lambda x: type(x).__name__ ==
                    "PartitionSpec")[0]}
        for name, spec in opt[part].items():
            parts = name.split(".")
            if parts[0] == "blocks":
                key = "/".join([f"blocks/b{int(parts[1]) % gs}"] + parts[2:])
                ref = want[key][1:]
            else:
                ref = want[name.replace(".", "/")]
            assert spec == ref + (None,) * (len(spec) - len(ref)), \
                (part, name, spec, ref)
    jb = JST.batch_sharding(jrec, jcfg, JShape("t", S, B, "train"))
    tb = steps.batch_sharding(rec, cfg, ShapeConfig(S, B))
    assert set(jb) == set(tb)

    def axes(entry):        # ("data",) and "data" name the same split
        return None if entry is None else sh._axes(entry)
    for k, spec in tb.items():
        ref = tuple(jb[k])
        ref = ref + (None,) * (len(spec) - len(ref))
        assert [axes(e) for e in spec] == [axes(e) for e in ref], \
            (k, spec, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_compress_round_trip(dtype):
    """``int8_compress`` / ``int8_decompress`` (the reference's, port-side):
    int8 codes within [-127, 127], the scale max|x| / 127, every element
    back within one step (the scale), the mean error within 4 standard
    errors of 0 (stochastic rounding is unbiased), and all zeros kept
    exact with scale 1."""
    from repro_torch.optim import int8_compress, int8_decompress
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(64, 256)).astype(np.float32)).to(dtype)
    q, scale = int8_compress(x, torch.Generator().manual_seed(0))
    assert q.dtype == torch.int8 and int(q.abs().max()) <= 127
    x32 = x.float()
    assert float(scale) == pytest.approx(float(x32.abs().max()) / 127.0)
    err = int8_decompress(q, scale) - x32
    assert float(err.abs().max()) <= float(scale) * (1 + 1e-6)
    se = float(scale) * np.sqrt(0.25 / err.numel())
    assert abs(float(err.mean())) <= 4 * se
    q0, s0 = int8_compress(torch.zeros(8), torch.Generator().manual_seed(1))
    assert float(s0) == 1.0 and int(q0.abs().max()) == 0
