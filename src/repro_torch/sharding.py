"""Sharding plans on ``torch.distributed`` (port of ``repro/sharding.py``).

``ParallelPlan`` holds a ``DeviceMesh`` and the roles of its axes;
``ShardingRecipe`` adds the batch axes and the KV-sequence axes of one
(arch, shape) cell.  Where the reference describes global arrays with
``PartitionSpec``s and lets GSPMD place them, each rank here holds only its
own piece, and the helpers below say which piece and over which process
group a collective runs:

  axis_index / axis_group  this rank's coordinate on, and the group of, an
                           axis or a tuple of axes;
  shard_range              this rank's block of a dimension split over axes
                           (the whole dimension where they do not divide it,
                           as the reference replicates then);
  vocab_slices             the rows (model axis) and columns (FSDP axis) of
                           a vocabulary table this rank stores;
  gather_batch             per-rank batch rows back to the global batch.

Axis roles:
  data axis ("data")   — batch / FSDP storage sharding
  model axis ("model") — vocabulary (table and head), KV spans at decode

Only the vocabulary tables are sharded in this port; every block weight is
replicated on each rank, which computes the same function as the
reference's GSPMD layout of the blocks.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.config import ModelConfig, ShapeConfig

Axes = Union[str, Tuple[str, ...]]


def _axes(axes: Optional[Axes]) -> Tuple[str, ...]:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


@dataclass(frozen=True)
class ParallelPlan:
    mesh: Optional[object] = None            # torch DeviceMesh
    data_axes: Tuple[str, ...] = ()          # ("data",)
    model_axis: Optional[str] = None         # "model"
    fsdp: bool = False                       # shard vocab columns over data
    # process groups of axis tuples, made at first use
    _groups: Dict[Tuple[str, ...], object] = field(
        default_factory=dict, compare=False, repr=False, hash=False)

    def axis_size(self, name: Optional[str]) -> int:
        if self.mesh is None or name is None:
            return 1
        return self.mesh.size(self.mesh.mesh_dim_names.index(name))

    @property
    def fsdp_axis(self) -> Optional[str]:
        # the innermost data axis, so that a leading "pod" axis would stay
        # pure data parallelism (the ISP rule for slow links)
        return self.data_axes[-1] if self.fsdp and self.data_axes else None


def make_plan(mesh, cfg: Optional[ModelConfig] = None, *,
              fsdp: Optional[bool] = None) -> ParallelPlan:
    """The mesh's "model" axis holds the vocabulary and the KV spans; every
    other axis is a data axis."""
    if mesh is None:
        return ParallelPlan()
    axes = tuple(mesh.mesh_dim_names)
    model_axis = "model" if "model" in axes else None
    data_axes = tuple(a for a in axes if a != model_axis)
    if fsdp is None:
        # heuristic: large models need param/optim sharding over data
        fsdp = cfg is not None and cfg.param_count() > 3_000_000_000
    return ParallelPlan(mesh=mesh, data_axes=data_axes, model_axis=model_axis,
                        fsdp=bool(fsdp))


def batch_spec(plan: ParallelPlan, global_batch: int) -> Tuple[str, ...]:
    """Data axes that divide the batch, in mesh order."""
    if plan.mesh is None:
        return ()
    axes = []
    rem = global_batch
    for a in plan.data_axes:
        sz = plan.axis_size(a)
        if rem % sz == 0:
            axes.append(a)
            rem //= sz
    return tuple(axes)


def seq_axes_for_cache(plan: ParallelPlan, batch_axes: Tuple[str, ...],
                       seq_len: int) -> Tuple[str, ...]:
    """Axes available to shard the KV sequence dim (ISP decode spans)."""
    if plan.mesh is None:
        return ()
    axes = [a for a in (plan.data_axes + ((plan.model_axis,)
                                          if plan.model_axis else ()))
            if a not in batch_axes and a is not None]
    out = []
    rem = seq_len
    for a in axes:
        sz = plan.axis_size(a)
        if rem % sz == 0 and sz > 1:
            out.append(a)
            rem //= sz
    return tuple(out)


@dataclass(frozen=True)
class ShardingRecipe:
    """Everything the step builders need for one (arch, shape, mesh) cell."""
    plan: ParallelPlan
    batch_axes: Tuple[str, ...]
    seq_axes: Tuple[str, ...]          # KV-span sharding at decode

    # passthroughs (models/core take a recipe as ``plan``)
    @property
    def mesh(self):
        return self.plan.mesh

    @property
    def model_axis(self):
        return self.plan.model_axis

    @property
    def fsdp_axis(self):
        return self.plan.fsdp_axis

    def axis_size(self, name: Optional[str]) -> int:
        return self.plan.axis_size(name)


def make_recipe(plan: ParallelPlan, cfg: ModelConfig,
                shape: ShapeConfig) -> ShardingRecipe:
    b_axes = batch_spec(plan, shape.global_batch)
    # ring caches for local layers have length `window`; global caches `seq`.
    # choose seq axes that divide the *smaller* of the two so one recipe fits
    # both cache families.
    seq_len = shape.seq_len
    if any(k == "local" for k in cfg.layer_pattern):
        seq_len = min(seq_len, cfg.attn.window)
    s_axes = seq_axes_for_cache(plan, b_axes, seq_len)
    return ShardingRecipe(plan=plan, batch_axes=b_axes, seq_axes=s_axes)


# ---------------------------------------------------------------------------
# This rank's piece
# ---------------------------------------------------------------------------


def _base(plan) -> ParallelPlan:
    return plan.plan if isinstance(plan, ShardingRecipe) else plan


def axes_size(plan, axes: Optional[Axes]) -> int:
    return math.prod(plan.axis_size(a) for a in _axes(axes))


def axis_index(plan, axes: Optional[Axes]) -> int:
    """This rank's row-major coordinate over ``axes`` (0 for none)."""
    idx = 0
    for a in _axes(axes):
        idx = idx * plan.axis_size(a) + plan.mesh.get_local_rank(a)
    return idx


def axis_group(plan, axes: Axes):
    """The process group of the ranks that differ from this one only on
    ``axes``.  Group ranks follow the row-major coordinate over ``axes``,
    so collectives that concatenate do so in coordinate order."""
    axes = _axes(axes)
    mesh = plan.mesh
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    base = _base(plan)
    group = base._groups.get(axes)
    if group is None:
        names = list(mesh.mesh_dim_names)
        layout = mesh.mesh
        # fix this rank's coordinate on every other axis
        for i in reversed(range(len(names))):
            if names[i] not in axes:
                layout = layout.select(i, mesh.get_local_rank(names[i]))
                names.pop(i)
        ranks = layout.permute(*[names.index(a) for a in axes]).flatten()
        ranks = ranks.tolist()
        if ranks != sorted(ranks):
            raise ValueError(f"axes {axes} are not in mesh order")
        group = dist.new_group(ranks, use_local_synchronization=True)
        base._groups[axes] = group
    return group


def shard_range(plan, axes: Optional[Axes], n: int) -> Tuple[int, int]:
    """[start, stop) of this rank's block of a dimension of ``n`` split over
    ``axes``; the whole dimension where the axes do not divide it (or there
    is no mesh), which the reference replicates."""
    if plan is None or plan.mesh is None:
        return 0, n
    size = axes_size(plan, axes)
    if size <= 1 or n % size:
        return 0, n
    b = n // size
    i = axis_index(plan, axes)
    return i * b, (i + 1) * b


def batch_rows(plan, n: int) -> slice:
    """This rank's rows of a global batch of ``n``."""
    axes = plan.batch_axes if plan is not None and plan.mesh is not None \
        else ()
    return slice(*shard_range(plan, axes, n))


def gather_batch(plan, local: torch.Tensor, n: int) -> torch.Tensor:
    """Every rank's ``batch_rows`` of a per-row result, concatenated back
    into the global batch of ``n`` rows on every rank."""
    rows = batch_rows(plan, n)
    if rows.stop - rows.start == n:
        return local
    size = n // (rows.stop - rows.start)
    out = local.new_empty((size * local.shape[0],) + tuple(local.shape[1:]))
    dist.all_gather_into_tensor(out, local.contiguous(),
                                group=axis_group(plan, plan.batch_axes))
    return out


def vocab_sharded(plan, cfg: ModelConfig) -> bool:
    """Whether the vocabulary tables are sharded over the model axis: a
    plan with a mesh and a model axis that divides the padded vocabulary
    (else the reference falls back to the replicated table)."""
    return (plan is not None and plan.mesh is not None
            and plan.model_axis is not None
            and cfg.padded_vocab % plan.axis_size(plan.model_axis) == 0)


def vocab_slices(plan, cfg: ModelConfig) -> Tuple[slice, slice]:
    """Rows and columns of a (padded_vocab, d_model) vocabulary table that
    this rank stores: rows by model rank, columns by FSDP rank (the
    reference's ``P(model, fsdp)``); the whole table where the vocabulary
    is not sharded."""
    if not vocab_sharded(plan, cfg):
        return slice(None), slice(None)
    rows = slice(*shard_range(plan, plan.model_axis, cfg.padded_vocab))
    cols = slice(None)
    fs = plan.fsdp_axis
    if fs and plan.axis_size(fs) > 1:
        if cfg.d_model % plan.axis_size(fs):
            raise ValueError(f"FSDP axis {fs} ({plan.axis_size(fs)} ranks) "
                             f"does not divide d_model {cfg.d_model}")
        cols = slice(*shard_range(plan, fs, cfg.d_model))
    return rows, cols
