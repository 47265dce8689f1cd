"""Sharding plans on ``torch.distributed`` (port of ``repro/sharding.py``).

``ParallelPlan`` holds a ``DeviceMesh`` and the roles of its axes;
``ShardingRecipe`` adds the batch axes and the KV-sequence axes of one
(arch, shape) cell.  Where the reference describes global arrays with
``PartitionSpec``s and lets GSPMD place them, each rank here holds only its
own piece, and the helpers below say which piece and over which process
group a collective runs:

  param_specs / leaf_spec  the reference's ``_RULES``: which dimension of
                           each parameter is split over the model axis
                           (TP: heads, d_ff, experts, vocabulary) and which
                           over the FSDP axis (storage), keyed on the
                           parameter's last name; ``cut`` takes this rank's
                           piece of a global array by such a spec;
  axis_index / axis_group  this rank's coordinate on, and the group of, an
                           axis or a tuple of axes;
  shard_range              this rank's block of a dimension split over axes
                           (the whole dimension where they do not divide it,
                           as the reference replicates then);
  all_reduce / all_gather / reduce_scatter / all_to_all
                           the collectives the blocks run over an axis
                           group (no-ops over one rank), each with its
                           adjoint as its backward;
  leaf                     a module's parameter at use: its FSDP pieces
                           all-gathered (the model-axis split kept, unless
                           the caller wants the whole leaf);
  vocab_slices             the rows (model axis) and columns (FSDP axis) of
                           a vocabulary table this rank stores;
  gather_batch             per-rank batch rows back to the global batch;
  sync_grads / global_sumsq
                           each parameter's gradient summed over the axes
                           it is replicated on, and the global gradient
                           norm's sum of squares from the pieces.

Axis roles:
  data axes ("data")   — batch / FSDP storage sharding
  model axis ("model") — TP (heads, d_ff, vocabulary), EP (experts), SP
                         (the sequence of the residual stream in prefill
                         and train), KV spans at decode

Every block weight is stored as ``param_specs`` cuts it, and the blocks
compute on their pieces (``models/``): column-parallel inputs, a
row-parallel output reduced over the model axis, experts by rank.
"""
from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.analysis import op_trace
from repro_torch.config import ModelConfig, ShapeConfig

Axes = Union[str, Tuple[str, ...]]
Spec = Tuple[Optional[Axes], ...]      # one entry (axis, axes or None) a dim


def _axes(axes: Optional[Axes]) -> Tuple[str, ...]:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


@dataclass(frozen=True)
class ParallelPlan:
    mesh: Optional[object] = None            # torch DeviceMesh
    data_axes: Tuple[str, ...] = ()          # ("data",)
    model_axis: Optional[str] = None         # "model"
    fsdp: bool = False                       # shard params over data
    ep: bool = True                          # expert parallelism for MoE
    # process groups of axis tuples, made at first use
    _groups: Dict[Tuple[str, ...], object] = field(
        default_factory=dict, compare=False, repr=False, hash=False)

    def axis_size(self, name: Optional[str]) -> int:
        if self.mesh is None or name is None:
            return 1
        return self.mesh.size(self.mesh.mesh_dim_names.index(name))

    @property
    def fsdp_axis(self) -> Optional[Axes]:
        # a "pod" axis stays pure data parallelism (the ISP rule for slow
        # links); without a model axis the parameters shard over every
        # other data axis, else over the innermost one
        if not (self.fsdp and self.data_axes):
            return None
        inner = tuple(a for a in self.data_axes if a != "pod")
        if self.model_axis is None and len(inner) > 1:
            return inner
        return self.data_axes[-1]

    def _fits(self, dim: int, axis: Optional[Axes]) -> bool:
        n = math.prod(self.axis_size(a) for a in _axes(axis))
        return axis is not None and n > 1 and dim % n == 0

    def shard_dims(self, shape: Sequence[int], prefs) -> Spec:
        """prefs: ordered [(dim, axis)]; the first fit per dim and axis
        wins, as in the reference."""
        if self.mesh is None:
            return (None,) * len(shape)
        assign: Dict[int, Axes] = {}
        used = set()
        for dim, axis in prefs:
            if dim < len(shape) and axis not in used and dim not in assign \
                    and self._fits(shape[dim], axis):
                assign[dim] = axis
                used.add(axis)
        return tuple(assign.get(i) for i in range(len(shape)))


def make_plan(mesh, cfg: Optional[ModelConfig] = None, *,
              fsdp: Optional[bool] = None) -> ParallelPlan:
    """The mesh's "model" axis holds TP, EP, SP, the vocabulary and the KV
    spans; every other axis is a data axis."""
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

    @property
    def data_axes(self):
        return self.plan.data_axes

    @property
    def ep(self):
        return self.plan.ep

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
# Parameter specs by name (the reference's _RULES)
# ---------------------------------------------------------------------------

# leaf-name regex -> preference list builder(shape) -> [(dim, role)]; roles:
# "tp" = the model axis, "fsdp" = the FSDP data axis.  The port's parameters
# are unstacked (one per layer), so dims index the reference's unstacked
# shape directly.
_RULES = [
    # embeddings / output head: vocab over model, d_model over data
    (r"(table|w_head)$", lambda s: [(0, "tp"), (1, "fsdp")]),
    # attention projections
    (r"wq$", lambda s: [(1, "tp"), (0, "fsdp")]),
    (r"(wk|wv)$", lambda s: [(1, "tp"), (0, "fsdp")]),
    (r"wo$", lambda s: [(0, "tp"), (2, "fsdp")]),
    # MLA projections
    (r"(wq_b|wk_b|wv_b)$", lambda s: [(1, "tp"), (0, "fsdp")]),
    (r"(wq_a|wkv_a)$", lambda s: [(0, "fsdp")]),
    # MLPs (swiglu + xlstm/ssm projections)
    (r"(w_gate|w_up|ws_gate|ws_up|w_in|w_pf1|w_x)$",
     lambda s: [(len(s) - 1, "tp"), (0, "fsdp")]),
    (r"(w_down|ws_down|w_out|w_pf2|w_dt)$",
     lambda s: [(0, "tp"), (len(s) - 1, "fsdp")]),
    # MoE experts: E over model, D over data
    (r"(we_gate|we_up|we_down)$", lambda s: [(0, "tp"), (1, "fsdp")]),
    (r"router$", lambda s: []),
    # mamba/xlstm channel-wise tensors: shard channel dim over model
    (r"(conv_w|conv_b|a_log|d_skip|dt_bias)$",
     lambda s: [(len(s) - 1 if s[-1] > 64 else 0, "tp")]),
    (r"w_if$", lambda s: [(0, "tp")]),
]


def leaf_spec(plan, name: str, shape: Sequence[int]) -> Spec:
    """Spec of the parameter ``name`` (a dotted state-dict name; the rules
    key on its last part) of global ``shape``: the reference's
    ``_leaf_spec`` on the unstacked leaf."""
    base = _base(plan)
    leaf = name.rsplit(".", 1)[-1]
    for pat, prefs_fn in _RULES:
        if re.search(pat, leaf):
            prefs = [(dim, base.model_axis if role == "tp"
                      else base.fsdp_axis)
                     for dim, role in prefs_fn(tuple(shape))]
            return base.shard_dims(shape, prefs)
    # default: replicate; fsdp models shard the largest divisible dim over
    # data
    if base.fsdp_axis and len(shape) > 0:
        dims = sorted(range(len(shape)), key=lambda i: -shape[i])
        return base.shard_dims(shape, [(dims[0], base.fsdp_axis)])
    return (None,) * len(shape)


def param_specs(plan, shapes: Dict[str, Sequence[int]]) -> Dict[str, Spec]:
    """``leaf_spec`` of every parameter, by name."""
    return {name: leaf_spec(plan, name, shape)
            for name, shape in shapes.items()}


def sharded(spec: Optional[Spec]) -> bool:
    return spec is not None and any(a is not None for a in spec)


def local_shape(plan, spec: Optional[Spec], shape: Sequence[int]
                ) -> Tuple[int, ...]:
    """The shape of this rank's piece of a leaf of global ``shape``."""
    if not sharded(spec):
        return tuple(shape)
    return tuple(n // axes_size(plan, a) if a is not None else n
                 for n, a in zip(shape, spec))


def cut(plan, spec: Optional[Spec], arr):
    """This rank's piece of the global array ``arr`` (numpy or torch)."""
    if not sharded(spec):
        return arr
    idx = tuple(slice(*shard_range(plan, a, n)) if a is not None
                else slice(None) for n, a in zip(arr.shape, spec))
    return arr[idx]


# ---------------------------------------------------------------------------
# This rank's piece
# ---------------------------------------------------------------------------


def _base(plan) -> ParallelPlan:
    return plan.plan if isinstance(plan, ShardingRecipe) else plan


def axes_size(plan, axes: Optional[Axes]) -> int:
    if plan is None:
        return 1
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


def tp_split(plan, n: int) -> Tuple[int, int]:
    """This rank's block of a dimension of ``n`` split over the model axis
    (all of it where the axis does not divide it)."""
    if plan is None or plan.mesh is None:
        return 0, n
    return shard_range(plan, plan.model_axis, n)


# ---------------------------------------------------------------------------
# Collectives over an axis group
# ---------------------------------------------------------------------------


def _size(plan, axes) -> int:
    if plan is None or plan.mesh is None or not _axes(axes):
        return 1
    return axes_size(plan, axes)


def _grad(x: torch.Tensor) -> bool:
    """Whether a collective on ``x`` must be differentiable."""
    return torch.is_grad_enabled() and x.requires_grad


# Every collective goes through the four helpers below, which record it
# (kind, bytes, group size) under the analysis layer's recorder
# (``analysis.op_trace.collective``); outside one that is a no-op.


def _gather(x: torch.Tensor, n: int, group, dim: int) -> torch.Tensor:
    x = x.contiguous()
    buf = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    op_trace.collective("all-gather", x, buf, group)
    dist.all_gather_into_tensor(buf, x, group=group)
    return torch.cat(buf.chunk(n), dim=dim)


def _scatter(x: torch.Tensor, n: int, group, dim: int) -> torch.Tensor:
    chunks = torch.stack(x.chunk(n, dim=dim)).contiguous()
    out = chunks.new_empty(chunks.shape[1:])
    op_trace.collective("reduce-scatter", chunks, out, group)
    dist.reduce_scatter_tensor(out.view(-1), chunks.view(-1), group=group)
    return out


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    out = torch.empty_like(x)
    op_trace.collective("all-to-all", x, out, group)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


def reduce_in_group(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> None:
    """All-reduce ``x`` over ``group`` in place."""
    op_trace.collective("all-reduce", x, x, group)
    dist.all_reduce(x, op=op, group=group)


# Each collective's backward is its adjoint over the ranks: every rank's
# copy of a value that is replicated over an axis is its own node of the
# global graph, so the gradient a rank holds of such a copy is only its
# share, and the true gradient is the sum of the shares.  The train step
# seeds each rank's (replicated) loss with 1 / (ranks in the mesh) and sums
# each parameter's gradient over the axes it is replicated on
# (``sync_grads``).  Under that convention the adjoints are exact at every
# site, whatever the ranks do downstream — split work (a column-parallel
# product) or the same work on each (Mamba on its gathered leaves):
#   all_reduce     -> all_reduce (a row-parallel output's partial sums each
#                     get the sum of every rank's share of the gradient;
#                     this all-reduce stands where Megatron's "f" puts its
#                     backward all-reduce, at the column-parallel entry:
#                     one all-reduce of (B, S, D) a mixer either way)
#   all_gather     -> reduce_scatter (each rank's block gets the sum of
#                     every rank's share of its gradient)
#   reduce_scatter -> all_gather
#   all_to_all     -> the same all_to_all (block j of the gradient goes
#                     back to the rank it came from)
# and a rank's own block of a replicated value (``own_block``) is a slice,
# whose gradient is that rank's share.


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.contiguous().clone()
        reduce_in_group(out, group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        reduce_in_group(g, ctx.group)
        return g, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n, group, dim):
        ctx.n, ctx.group, ctx.dim = n, group, dim
        return _gather(x, n, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g, ctx.n, ctx.group, ctx.dim), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n, group, dim):
        ctx.n, ctx.group, ctx.dim = n, group, dim
        return _scatter(x, n, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.n, ctx.group, ctx.dim), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


def all_reduce(plan, x: torch.Tensor, axes, op=dist.ReduceOp.SUM
               ) -> torch.Tensor:
    """The sum (or ``op``) of ``x`` over ``axes``: in place without a
    gradient, into a new tensor with one (sums only; see the adjoints
    above)."""
    if _size(plan, axes) == 1:
        return x
    group = axis_group(plan, axes)
    if _grad(x):
        if op != dist.ReduceOp.SUM:
            raise ValueError("only the sum over ranks has a gradient")
        return _AllReduce.apply(x, group)
    reduce_in_group(x, group, op)
    return x


def all_gather(plan, x: torch.Tensor, axes, dim: int) -> torch.Tensor:
    """Every rank's ``x`` over ``axes``, concatenated along ``dim`` in
    coordinate order (the reference's tiled ``all_gather``)."""
    n = _size(plan, axes)
    if n == 1:
        return x
    group = axis_group(plan, axes)
    if _grad(x):
        return _AllGather.apply(x, n, group, dim)
    return _gather(x, n, group, dim)


def reduce_scatter(plan, x: torch.Tensor, axes, dim: int) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of ``x`` over ``axes``
    (the reference's tiled ``psum_scatter``)."""
    n = _size(plan, axes)
    if n == 1:
        return x
    group = axis_group(plan, axes)
    if _grad(x):
        return _ReduceScatter.apply(x, n, group, dim)
    return _scatter(x, n, group, dim)


def own_block(plan, x: torch.Tensor, axes, dim: int) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` over ``axes``."""
    lo, hi = shard_range(plan, axes, x.shape[dim])
    return x.narrow(dim, lo, hi - lo)


def all_to_all(plan, x: torch.Tensor, axes) -> torch.Tensor:
    """Block j of ``x``'s first dim goes to the rank of coordinate j over
    ``axes``; the blocks received come back stacked along the first dim in
    source order."""
    if _size(plan, axes) == 1:
        return x
    group = axis_group(plan, axes)
    if _grad(x):
        return _AllToAll.apply(x, group)
    return _exchange(x, group)


# ---------------------------------------------------------------------------
# Parameters at use
# ---------------------------------------------------------------------------


def spec_of(module, name: str) -> Optional[Spec]:
    """The spec a module's parameter ``name`` was stored by (None where it
    is whole)."""
    return getattr(module, "_specs", {}).get(name)


def split_on_model(plan, module, name: str, dim: int) -> bool:
    """Whether dimension ``dim`` of the module's parameter is split over
    the model axis."""
    spec = spec_of(module, name)
    return spec is not None and plan is not None and \
        spec[dim] is not None and spec[dim] == plan.model_axis


def leaf(module, name: str, plan, full: bool = False) -> torch.Tensor:
    """The module's parameter ``name`` at use: every dimension split over
    the FSDP axis all-gathered (the reference's storage gather), and with
    ``full`` the model-axis splits too, so the whole leaf."""
    t = getattr(module, name)
    spec = spec_of(module, name)
    if not sharded(spec):
        return t
    for dim, a in enumerate(spec):
        if a is not None and (full or a != plan.model_axis):
            t = all_gather(plan, t, a, dim)
    return t


# ---------------------------------------------------------------------------
# Batch rows and vocabulary tables
# ---------------------------------------------------------------------------


def batch_rows(plan, n: int) -> slice:
    """This rank's rows of a global batch of ``n``."""
    axes = plan.batch_axes if plan is not None and plan.mesh is not None \
        else ()
    return slice(*shard_range(plan, axes, n))


def token_axes(plan, sp: bool = False) -> Tuple[str, ...]:
    """The axes that split a batch's tokens among the ranks, in mesh
    order: the batch axes, and the model axis under the sequence-parallel
    residual stream (``sp``)."""
    if plan is None or plan.mesh is None:
        return ()
    axes = set(plan.batch_axes) | ({plan.model_axis} if sp else set())
    return tuple(a for a in plan.mesh.mesh_dim_names if a in axes)


def gather_batch(plan, local: torch.Tensor, n: int) -> torch.Tensor:
    """Every rank's ``batch_rows`` of a per-row result, concatenated back
    into the global batch of ``n`` rows on every rank."""
    rows = batch_rows(plan, n)
    if rows.stop - rows.start == n:
        return local
    return all_gather(plan, local, plan.batch_axes, 0)


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
    reference's ``P(model, fsdp)``), each whole where its axis does not
    divide it."""
    if plan is None or plan.mesh is None:
        return slice(None), slice(None)
    spec = leaf_spec(plan, "table", (cfg.padded_vocab, cfg.d_model))
    return tuple(slice(*shard_range(plan, a, n)) if a is not None
                 else slice(None)
                 for n, a in zip((cfg.padded_vocab, cfg.d_model), spec))


def table_spec(plan, cfg: ModelConfig) -> Optional[Spec]:
    """The spec of a vocabulary table (None without a mesh)."""
    if plan is None or plan.mesh is None:
        return None
    return leaf_spec(plan, "table", (cfg.padded_vocab, cfg.d_model))



# ---------------------------------------------------------------------------
# Gradients of the pieces
# ---------------------------------------------------------------------------


def mesh_size(plan) -> int:
    """The number of ranks in the plan's mesh (1 without one)."""
    if plan is None or plan.mesh is None:
        return 1
    return math.prod(plan.axis_size(a) for a in plan.mesh.mesh_dim_names)


def _split_axes(spec: Optional[Spec]) -> Tuple[str, ...]:
    return tuple(a for entry in (spec or ()) for a in _axes(entry))


def replicated_axes(plan, spec: Optional[Spec]) -> Tuple[str, ...]:
    """The mesh axes, in mesh order, over which a leaf of ``spec`` is held
    whole on every rank (every axis without a mesh: none)."""
    if plan is None or plan.mesh is None:
        return ()
    split = _split_axes(spec)
    return tuple(a for a in plan.mesh.mesh_dim_names
                 if a not in split and plan.axis_size(a) > 1)


_BUCKET = 1 << 20    # leaves of fewer elements share one all-reduce


def _bucketed(plan, by_axes: Dict[Tuple[str, ...], list]) -> None:
    """All-reduce (sum) each group of tensors over its axes, in place, in
    float32: the small ones of a group in one collective, each large one
    alone (groups and tensors in a fixed order)."""
    for axes in sorted(by_axes):
        if not axes:
            continue
        group = axis_group(plan, axes)
        small = [t for t in by_axes[axes] if t.numel() < _BUCKET]
        for t in by_axes[axes]:
            if t.numel() >= _BUCKET:
                f = t.float()
                reduce_in_group(f, group)
                t.copy_(f)
        if small:
            flat = torch.cat([t.reshape(-1).float() for t in small])
            reduce_in_group(flat, group)
            for t, part in zip(small, flat.split([t.numel()
                                                   for t in small])):
                t.copy_(part.view_as(t))


@torch.no_grad()
def sync_grads(plan, specs: Dict[str, Spec],
               grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each rank's share of each parameter's gradient (the step seeds the
    replicated loss with 1 / mesh_size) summed, in place, over the mesh
    axes the parameter is replicated on: the data axes for every leaf
    that FSDP does not split (whose gather's reduce-scatter sums over its
    axis), the model axis for every leaf it does not split (norms,
    routers, MLA's low-rank projections, and pieces of work every rank
    repeats).  The result is this rank's piece of the global gradient,
    the same on every rank that holds the piece; ``grads`` is returned.
    Nothing to do without a mesh."""
    if plan is None or plan.mesh is None:
        return grads
    by_axes: Dict[Tuple[str, ...], list] = {}
    for n in sorted(grads):
        by_axes.setdefault(replicated_axes(plan, specs.get(n)), []).append(
            grads[n])
    _bucketed(plan, by_axes)
    return grads


@torch.no_grad()
def global_sumsq(plan, specs: Dict[str, Spec],
                 tensors: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The float32 sum of squares of the global leaves of which
    ``tensors`` are this rank's pieces (each the same on the ranks that
    hold it): each piece's sum summed over the axes that split its leaf,
    and counted once over the axes it is replicated on."""
    by_axes: Dict[Tuple[str, ...], list] = {}
    for n in sorted(tensors):
        axes = ()
        if plan is not None and plan.mesh is not None:
            split = _split_axes(specs.get(n))
            axes = tuple(a for a in plan.mesh.mesh_dim_names if a in split)
        by_axes.setdefault(axes, []).append(
            tensors[n].float().square().sum())
    sums = {axes: torch.stack(v).sum().reshape(1)
            for axes, v in by_axes.items()}
    _bucketed(plan, {a: [t] for a, t in sums.items()})
    return torch.stack([t[0] for t in sums.values()]).sum()
