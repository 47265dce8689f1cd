"""The port's dry-run (``launch/dryrun.py``) and what it rests on, against
the JAX package:

* the production cells: ``SHAPES``, ``ASSIGNED`` and ``shape_applicable``
  equal the reference's;
* model FLOPs: ``count_flops_params``, ``count_params`` (all and active)
  and ``model_flops_for`` equal the reference's exactly, for all 10 archs
  x 4 shapes at full size (the reference's side is ``jax.eval_shape``,
  the port's builds its model on ``meta``: nothing is allocated);
* every parameter's local shape under the port's production plan (a fake
  process group of 256 or 512 ranks) equals the reference's
  ``param_specs`` cut on an ``AbstractMesh`` of the same shape, for all 10
  archs at full size on (16, 16) and (2, 16, 16), FSDP by the heuristic
  (None) and on;
* ``run_cell`` on the (2, 2) and (2, 2, 2) debug meshes (fake group,
  ``meta``) for every reduced arch x {train, prefill, decode}: each cell
  ends ``ok``, and its parameter and optimizer argument bytes equal the
  sum of the reference's local shapes (the port's counterpart of the
  reference's ``test_dryrun_compiles_small_mesh_all_archs``, which runs
  ``jax.make_mesh`` with its defaults and is red at the parent).

All in-process, on the CPU; exact equalities (integer counts)."""
import math

import jax
import pytest
from jax.sharding import AbstractMesh

from repro.analysis.roofline import model_flops_for as j_model_flops
from repro.config import SHAPES as J_SHAPES
from repro.config import get_config as j_get
from repro.config import reduced_config as j_reduced
from repro.config import shape_applicable as j_applicable
from repro.configs import ASSIGNED as J_ASSIGNED
from repro.models import model as JM
from repro.sharding import make_plan as j_plan
from repro.sharding import param_specs as j_specs
from repro_torch.analysis.roofline import model_flops_for
from repro_torch.config import SHAPES, ShapeConfig, get_config, \
    reduced_config, shape_applicable
from repro_torch.configs import ASSIGNED
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_group, make_production_mesh
from repro_torch.models import model as TM
from repro_torch.sharding import make_plan

MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}
# small cells of the debug meshes: every kind at a length the recurrent
# archs step through quickly
DEBUG_SHAPES = [ShapeConfig(32, 8, kind, kind)
                for kind in ("train", "prefill", "decode")]


def _ref_local_shapes(jcfg, mesh_shape, names, fsdp, itemsize=False):
    """Each reference leaf's local shape under its ``param_specs`` on an
    ``AbstractMesh``, block leaves unstacked, by the port's name layout
    (``blocks/b{j}/...`` for block position j); with ``itemsize``, each
    with its dtype's bytes."""
    sizes = dict(zip(names, mesh_shape))
    specs = j_specs(j_plan(AbstractMesh(mesh_shape, names), jcfg, fsdp=fsdp),
                    JM.abstract_params(jcfg))
    shapes = JM.abstract_params(jcfg)
    flat_s = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: type(x).__name__ == "PartitionSpec")[0]
    flat_a = dict((tuple(str(p.key) for p in path), leaf) for path, leaf
                  in jax.tree_util.tree_flatten_with_path(shapes)[0])
    out = {}
    for path, spec in flat_s:
        key = tuple(str(p.key) for p in path)
        shape = list(flat_a[key].shape)
        spec = tuple(spec) + (None,) * (len(shape) - len(spec))
        for d, ax in enumerate(spec):
            for a in ((ax,) if isinstance(ax, str) else ax or ()):
                shape[d] //= sizes[a]
        if key[0] == "blocks":
            shape = shape[1:]                   # unstacked
        out["/".join(key)] = tuple(shape)
        if itemsize:
            out["/".join(key)] = (tuple(shape), flat_a[key].dtype.itemsize)
    return out


def _port_key(cfg, name):
    parts = name.split(".")
    if parts[0] == "blocks":
        return "/".join([f"blocks/b{int(parts[1]) % cfg.group_size}"]
                        + parts[2:])
    return "/".join(parts)


def test_cells_match_the_reference():
    assert ASSIGNED == J_ASSIGNED
    assert list(SHAPES) == list(J_SHAPES)
    for name, s in SHAPES.items():
        j = J_SHAPES[name]
        assert (s.name, s.seq_len, s.global_batch, s.kind, s.tokens) == \
            (j.name, j.seq_len, j.global_batch, j.kind, j.tokens)
    for arch in ASSIGNED:
        for name in SHAPES:
            assert shape_applicable(get_config(arch), SHAPES[name]) == \
                j_applicable(j_get(arch), J_SHAPES[name])
    # a bare ShapeConfig(seq_len, global_batch) stays a train cell
    assert ShapeConfig(8, 2).kind == "train" and ShapeConfig(8, 2).tokens == 16


@pytest.mark.parametrize("arch", ASSIGNED)
def test_model_flops_match_the_reference(arch):
    cfg, jcfg = get_config(arch), j_get(arch)
    assert TM.count_flops_params(cfg) == JM.count_flops_params(jcfg)
    assert TM.count_flops_params(cfg, active_only=False) == \
        JM.count_flops_params(jcfg, active_only=False)
    assert TM.count_params(cfg) == JM.count_params(jcfg)
    assert TM.count_params(cfg, active_only=True) == \
        JM.count_params(jcfg, active_only=True)
    for name in SHAPES:
        assert model_flops_for(cfg, SHAPES[name]) == \
            j_model_flops(jcfg, J_SHAPES[name]), name


@pytest.mark.parametrize("arch", ASSIGNED)
def test_production_local_shapes_match_the_reference(arch):
    cfg, jcfg = get_config(arch), j_get(arch)
    for kind, (mesh_shape, names) in MESHES.items():
        for fsdp in (None, True):
            want = _ref_local_shapes(jcfg, mesh_shape, names, fsdp)
            with fake_group(math.prod(mesh_shape)):
                mesh = make_production_mesh(multi_pod=kind == "multipod",
                                            device="cpu")
                assert tuple(mesh.mesh_dim_names) == names
                plan = make_plan(mesh, cfg, fsdp=fsdp)
                got = {_port_key(cfg, n): tuple(p.shape) for n, p in
                       TM.abstract_params(cfg, plan).named_parameters()}
            assert set(got) == set(want), (kind, fsdp)
            for key, shape in got.items():
                assert shape == want[key], (kind, fsdp, key, shape,
                                            want[key])


def test_production_mesh_needs_its_ranks():
    with fake_group(8):
        with pytest.raises(ValueError, match="256"):
            make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        make_production_mesh(device="cpu")


@pytest.mark.parametrize("arch", ASSIGNED)
def test_run_cell_on_debug_meshes(arch):
    """Every reduced cell traces on (2, 2) and (2, 2, 2); the argument
    bytes of the parameters (this rank's pieces) and of the AdamW state
    (two moments in the state dtype and an int32 step) equal those of the
    reference's local shapes."""
    cfg = reduced_config(arch)
    jcfg = j_reduced(arch)
    st = {"float32": 4, "bfloat16": 2}[cfg.optimizer_state_dtype]
    for kind, (mesh_shape, names) in {
            "2x2": ((2, 2), ("data", "model")),
            "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}.items():
        local = _ref_local_shapes(jcfg, mesh_shape, names, None, True)
        # block leaves repeat once per layer group
        reps = {k: TM.num_groups(cfg) if k.startswith("blocks/") else 1
                for k in local}
        nbytes = sum(math.prod(s) * el * reps[k]
                     for k, (s, el) in local.items())
        for shape in DEBUG_SHAPES:
            r = dryrun.run_cell(cfg, shape, kind, None, verbose=False)
            assert r["status"] == "ok", (kind, shape.kind)
            mem = r["memory"]
            assert mem["params"] == nbytes, (kind, shape.kind)
            if shape.kind == "train":
                n = sum(math.prod(s) * reps[k]
                        for k, (s, _) in local.items())
                assert mem["optimizer"] == 2 * n * st + 4
            assert r["bytes_per_device"] == mem["argument_bytes"] \
                + mem["temp_bytes"]
            assert r["roofline"]["chips"] == math.prod(mesh_shape)
            assert r["dot_flops"] > 0 and r["hbm_bytes"] > 0
            sites = r["kernel_sites"]
            if shape.kind != "decode" and any(
                    k not in ("mlstm", "slstm") for k in cfg.block_pattern):
                assert sites.get("flash_attention", 0) >= 1, sites
