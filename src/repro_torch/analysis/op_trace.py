"""Op records of one step: the counterpart of the reference's
``analysis/hlo.py``.

The reference compiles a step and walks its optimized HLO.  Here a step
runs eagerly (on the card, on the CPU, or on ``meta`` tensors under a
fake process group in the dry-run) inside ``OpRecorder``, a
``TorchDispatchMode`` that sees every aten op the step dispatches, the
backward's included, and records for each:

  * FLOPs: the products (``mm``, ``bmm``, ``addmm``, ``baddbmm``,
    convolutions, attention) by the formulas of ``torch.utils.flop_counter``
    at their operands' dtype; one per output element for every other op
    that computes, as ``hlo.py`` counts its fused elementwise ops;
  * HBM bytes: each input read once, each output written once.  An op whose
    outputs alias an input by its schema (views, ``expand``,
    ``as_strided``, ``_unsafe_view``, ``detach``) moves nothing, like
    ``hlo.py``'s ``_NO_TRAFFIC``; an input broadcast by a zero stride is
    read once; an in-place scatter (``index_put_``, ``index_add_``, ...)
    moves the rows it writes, not its whole destination, as ``hlo.py``
    counts a ``dynamic-update-slice``.  In eager mode each op is a kernel, so these are the step's
    bytes, not an estimate at fusion granularity;
  * collectives, which ``sharding.py``'s helpers record (``collective``):
    kind, group size g and wire bytes with the ring factors of ``hlo.py``:
    all-gather result·(g-1)/g, reduce-scatter operand·(g-1)/g, all-reduce
    2·operand·(g-1)/g, all-to-all operand·(g-1)/g.  The ``c10d`` ops
    themselves are not counted again;
  * the kernel sites: each entry point of ``kernels/ops.py`` that has a
    hand-written kernel records one op, ``kernel:<name>``, with the
    operations and bytes that kernel needs for these inputs
    (``KERNEL_COSTS``: each input byte read once, each output byte written
    once, causal or windowed pairs only, valid keys only; the bound column
    of PERF.md counts them so), and the ops inside the call are not
    counted, whichever path computes it.  On ``meta`` the site builds its
    outputs' shapes and dtypes and runs nothing.  With ``sites="plain"``
    no site is recorded and its plain version's ops are counted as they
    run (what the reference's CPU HLO computes; its Pallas calls count 0).

Temp bytes are the peak of the live bytes of the storages the step
allocates: each new storage is tracked until it is freed
(``weakref.finalize`` on it), and the storages that exist before (the
arguments) are left out.  This takes the place of ``memory_analysis()``.

Identical records are kept once with a count (``OpRecord.count``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import weakref
from dataclasses import dataclass
from typing import Callable, Dict, List, NamedTuple, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

# ops that only allocate: no bytes moved, no work (their storage is tracked)
_ALLOC_ONLY = {"aten::empty", "aten::empty_like", "aten::new_empty",
               "aten::empty_strided", "aten::new_empty_strided"}
# in-place ops that overwrite their destination without reading it
_OVERWRITE = {"aten::copy_", "aten::fill_", "aten::zero_"}
# in-place ops that write only the indexed rows of their destination: the
# position of the rows written (read first where they accumulate)
_SCATTER = {"aten::index_put_": 2, "aten::index_add_": 3,
            "aten::index_copy_": 3, "aten::scatter_": 3,
            "aten::scatter_add_": 3}
_ACCUMULATE = {"aten::index_add_", "aten::scatter_add_"}
# collectives are recorded by sharding.py with their group sizes
_COLLECTIVE_NS = ("c10d", "_c10d_functional")


@dataclass
class OpRecord:
    op: str                    # aten::mm, kernel:<name>, collective:<kind>
    kind: str                  # dot | elementwise | view | kernel | collective
    dtype: str                 # operand dtype (the peak its FLOPs run at)
    flops: float = 0.0         # products and kernel sites
    elementwise: float = 0.0   # one per output element of the other ops
    bytes: float = 0.0         # HBM bytes
    wire_bytes: float = 0.0    # collectives: bytes on the wire a rank
    coll_kind: str = ""
    group: int = 0
    count: int = 1

    def key(self):
        return (self.op, self.kind, self.dtype, self.flops, self.elementwise,
                self.bytes, self.wire_bytes, self.coll_kind, self.group)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class Cost(NamedTuple):
    """A kernel site's operations (at the peak of ``dtype``) and bytes."""
    flops: float
    bytes: float
    dtype: str


def dtype_name(dtype) -> str:
    return dtype if isinstance(dtype, str) else str(dtype).split(".")[-1]


def _nbytes(t: torch.Tensor) -> int:
    """Bytes of ``t`` read once: a dimension broadcast by a zero stride
    holds one element."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _tensors(x, out: list) -> list:
    """The tensors in nested lists, tuples and dicts (a cheaper
    ``tree_flatten`` for op arguments and results)."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _tensors(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _tensors(v, out)
    return out


def _on_meta(*ts) -> bool:
    return any(isinstance(t, torch.Tensor) and t.device.type == "meta"
               for t in ts)


# ---------------------------------------------------------------------------
# The kernel sites: operations and bytes a kernel needs for its inputs
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=4096)
def attn_pairs(sq: int, skv: int, causal: bool = True,
               window: Optional[int] = None, q_offset: int = 0) -> int:
    """(query, key) pairs attention computes: query row i sits at position
    ``q_offset + i`` and sees keys j <= its position (causal) and within
    ``window`` rows of it."""
    if not causal:
        return sq * skv
    total = 0
    for i in range(sq):
        pos = q_offset + i
        hi = min(pos, skv - 1)
        lo = 0 if window is None else max(0, pos - window + 1)
        total += max(0, hi - lo + 1)
    return total


def flash_cost(q, k, v, causal=True, window=None, q_offset=0, scale=None,
               q_chunk=512, kv_chunk=512, return_lse=False) -> Cost:
    """2·(dqk + dv) operations a (query, key) pair and head; q, k, v and
    the output (B, Sq, H, dv) once, and the fp32 lse (B, Sq, H) if
    written."""
    B, Sq, H, dqk = q.shape
    dv = v.shape[-1]
    pairs = attn_pairs(Sq, k.shape[1], bool(causal), window, int(q_offset))
    nbytes = _nbytes(q) + _nbytes(k) + _nbytes(v) \
        + B * Sq * H * dv * q.element_size()
    if return_lse:
        nbytes += B * Sq * H * 4
    return Cost(2 * (dqk + dv) * pairs * B * H, nbytes, dtype_name(q.dtype))


def _decode_cost(q, k, v, valid: int, extra: int) -> Cost:
    """Decode partials: q once, K and V rows of the ``valid`` keys once,
    the fp32 (acc, l, m) written; 2·(dk + dv) operations a key and head."""
    B, H, dk = q.shape
    Hkv, dv = k.shape[-2], v.shape[-1]
    nbytes = _nbytes(q) + valid * Hkv * (dk * k.element_size()
                                         + dv * v.element_size()) \
        + extra + B * H * dv * 4 + 2 * B * H * 4
    return Cost(2 * (dk + dv) * valid * H, nbytes, dtype_name(q.dtype))


def paged_decode_cost(q, kpool, vpool, pages, cur_pos, window=None,
                      scale=None) -> Cost:
    """Valid keys: the rows of allocated pages at positions <= cur_pos
    (and within ``window``); on ``meta`` every row of the page table's
    span (within ``window``).  Page table and positions read once."""
    B, maxp = pages.shape
    ps = kpool.shape[1]
    cur = torch.as_tensor(cur_pos)
    if _on_meta(pages, cur):
        per = maxp * ps if window is None else min(maxp * ps, window)
        valid = B * per
    else:
        pos = torch.arange(maxp * ps, device=pages.device).view(maxp, ps)
        c = cur.to(pages.device).reshape(-1, 1, 1)
        ok = (pages[..., None] >= 0) & (pos[None] <= c)
        if window is not None:
            ok = ok & (pos[None] > c - window)
        valid = int(ok.sum())
    return _decode_cost(q, kpool, vpool, valid,
                        _nbytes(pages) + cur.numel() * cur.element_size())


def decode_partial_cost(q, k, v, kpos, cur_pos, window=None,
                        scale=None) -> Cost:
    """Valid keys: strip rows whose position is >= 0, <= cur_pos and
    within ``window``; on ``meta`` every row (within ``window``).  The
    position track and positions read once."""
    B, S = q.shape[0], k.shape[1]
    cur = torch.as_tensor(cur_pos)
    if _on_meta(kpos, cur):
        valid = B * (S if window is None else min(S, window))
    else:
        from repro_torch.kernels.ref import _decode_valid_mask
        valid = int(_decode_valid_mask(kpos, cur.to(kpos.device),
                                       window).expand(B, S).sum())
    return _decode_cost(q, k, v, valid,
                        _nbytes(kpos) + cur.numel() * cur.element_size())


def _on_shard(indices, offset: int, rows: int):
    if _on_meta(indices):
        return None
    return (indices >= offset) & (indices < offset + rows)


def isp_gather_cost(table, indices, shard_offset=0, weights=None) -> Cost:
    """The rows of ids on this shard read once (all of them on ``meta``),
    every output row written, the ids and weights read once."""
    n, (rows, D) = indices.numel(), table.shape
    ok = _on_shard(indices, int(shard_offset), rows)
    n_on = n if ok is None else int(ok.sum())
    nbytes = (n_on + n) * D * table.element_size() + _nbytes(indices)
    if weights is not None:
        nbytes += _nbytes(weights)
    return Cost(0, nbytes, dtype_name(table.dtype))


def isp_gather_pool_cost(table, indices, segment_ids, num_segments,
                         shard_offset=0, weights=None) -> Cost:
    """Each distinct table row an id on this shard names read once (on
    ``meta``: as many as there are ids, at most the shard's rows), the ids,
    segment ids and weights once, the fp32 (num_segments, D) written;
    2·D operations (a multiply and an add) an id on the shard, in fp32."""
    rows, D = table.shape
    ok = _on_shard(indices, int(shard_offset), rows)
    if ok is None:
        n_on = indices.numel()
        distinct = min(n_on, rows)
    else:
        n_on = int(ok.sum())
        distinct = int(torch.unique(indices[ok]).numel())
    nbytes = _nbytes(indices) + _nbytes(segment_ids) \
        + distinct * D * table.element_size() + num_segments * D * 4
    if weights is not None:
        nbytes += _nbytes(weights)
    return Cost(2 * n_on * D, nbytes, "float32")


def topk_similarity_cost(queries, corpus, k) -> Cost:
    """One (Q, N) product over D at the tensor cores' peak for the corpus
    dtype (TF32 for fp32); queries and corpus read once, the fp32 scores
    and int32 ids written."""
    Q, D = queries.shape
    N = corpus.shape[0]
    tc = "bfloat16" if corpus.dtype == torch.bfloat16 else "tf32"
    nbytes = _nbytes(queries) + _nbytes(corpus) + Q * k * 8
    return Cost(2 * Q * N * D, nbytes, tc)


def _flash_out(q, k, v, causal=True, window=None, q_offset=0, scale=None,
               q_chunk=512, kv_chunk=512, return_lse=False):
    B, Sq, H, _ = q.shape
    out = q.new_empty((B, Sq, H, v.shape[-1]))
    if return_lse:
        return out, q.new_empty((B, Sq, H), dtype=torch.float32)
    return out


def _partial_out(q, k, v, *a, **kw):
    B, H, _ = q.shape
    f32 = torch.float32
    return (q.new_empty((B, H, v.shape[-1]), dtype=f32),
            q.new_empty((B, H), dtype=f32), q.new_empty((B, H), dtype=f32))


KERNEL_COSTS: Dict[str, Callable[..., Cost]] = {
    "flash_attention": flash_cost,
    "paged_decode": paged_decode_cost,
    "isp_decode": decode_partial_cost,
    "isp_gather": isp_gather_cost,
    "isp_gather_pool": isp_gather_pool_cost,
    "topk_similarity": topk_similarity_cost,
}

# the shapes and dtypes of a kernel's outputs, for a site on ``meta``
_META_OUT = {
    "flash_attention": _flash_out,
    "paged_decode": _partial_out,
    "isp_decode": _partial_out,
    "isp_gather": lambda table, indices, shard_offset=0, weights=None:
        table.new_empty(tuple(indices.shape) + (table.shape[1],)),
    "isp_gather_pool": lambda table, indices, segment_ids, num_segments,
        shard_offset=0, weights=None: table.new_empty(
            (num_segments, table.shape[1]), dtype=torch.float32),
    "topk_similarity": lambda queries, corpus, k: (
        queries.new_empty((queries.shape[0], k), dtype=torch.float32),
        queries.new_empty((queries.shape[0], k), dtype=torch.int32)),
}


# ---------------------------------------------------------------------------
# The recorder
# ---------------------------------------------------------------------------

_ACTIVE: List["OpRecorder"] = []


def active() -> Optional["OpRecorder"]:
    """The recorder a step runs under, if any."""
    return _ACTIVE[-1] if _ACTIVE else None


@contextlib.contextmanager
def paused():
    """Nothing that runs inside is recorded or tracked (a step's one-time
    checks, which are not part of the step)."""
    rec = active()
    if rec is None:
        yield
        return
    rec._paused += 1
    try:
        yield
    finally:
        rec._paused -= 1


def kernel_site(name: str):
    """Decorator for a kernel entry point of ``kernels/ops.py``: outside a
    recorder the call runs as it is; inside one it is one record
    (``OpRecorder.site``)."""
    def wrap(fn):
        @functools.wraps(fn)
        def entry(*args, **kwargs):
            rec = active()
            if rec is None:
                return fn(*args, **kwargs)
            return rec.site(name, fn, args, kwargs)
        return entry
    return wrap


def collective(kind: str, operand: torch.Tensor, result: torch.Tensor,
               group) -> None:
    """Record one collective of ``sharding.py`` over ``group`` (nothing
    outside a recorder)."""
    rec = active()
    if rec is None:
        return
    import torch.distributed as dist
    g = dist.get_world_size(group)
    ob, rb = operand.numel() * operand.element_size(), \
        result.numel() * result.element_size()
    factor = (g - 1) / g
    wire = {"all-gather": rb * factor, "reduce-scatter": ob * factor,
            "all-reduce": 2.0 * ob * factor,
            "all-to-all": ob * factor}[kind]
    rec.add(OpRecord(op=f"collective:{kind}", kind="collective",
                     dtype=dtype_name(operand.dtype), bytes=ob + rb,
                     wire_bytes=wire, coll_kind=kind, group=g))


class OpRecorder(TorchDispatchMode):
    """Records the ops of what runs inside it (see the module's doc).

    ``sites``: "kernel" (a kernel entry point is one record with its
    kernel's cost) or "plain" (the plain version's ops are counted).
    ``device``: the device type whose storages count in the temp bytes
    (every device's by default)."""

    def __init__(self, sites: str = "kernel", device: Optional[str] = None):
        super().__init__()
        if sites not in ("kernel", "plain"):
            raise ValueError(f"sites must be 'kernel' or 'plain', not "
                             f"{sites!r}")
        self.sites = sites
        self.device = device
        self._paused = 0
        self._agg: Dict[tuple, OpRecord] = {}
        self._quiet = 0
        self._live: Dict[int, int] = {}
        self.live_bytes = 0
        self.peak_bytes = 0

    # -- entering and leaving --------------------------------------------
    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _ACTIVE.remove(self)

    # -- records -----------------------------------------------------------
    def add(self, rec: OpRecord) -> None:
        if self._quiet or self._paused:
            return
        k = rec.key()
        have = self._agg.get(k)
        if have is None:
            self._agg[k] = rec
        else:
            have.count += rec.count

    @property
    def records(self) -> List[OpRecord]:
        return list(self._agg.values())

    # -- storages ----------------------------------------------------------
    def _free(self, key: int, n: int) -> None:
        if self._live.pop(key, None) is not None:
            self.live_bytes -= n

    def _track(self, t: torch.Tensor) -> None:
        if self.device is not None and t.device.type != self.device:
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, key, n)

    # -- kernel sites ------------------------------------------------------
    def site(self, name: str, fn, args, kwargs):
        if self.sites == "plain" or self._quiet or self._paused:
            return fn(*args, **kwargs)
        cost = KERNEL_COSTS[name](*args, **kwargs)
        self._quiet += 1
        try:
            if _on_meta(*_tensors(kwargs, _tensors(args, []))):
                out = _META_OUT[name](*args, **kwargs)
            else:
                out = fn(*args, **kwargs)
        finally:
            self._quiet -= 1
        self.add(OpRecord(op=f"kernel:{name}", kind="kernel",
                          dtype=cost.dtype, flops=float(cost.flops),
                          bytes=float(cost.bytes)))
        return out

    # -- every aten op -----------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._paused or func.namespace in _COLLECTIVE_NS:
            return out
        name = func._schema.name
        returns = func._schema.returns
        aliased = any(r.alias_info is not None for r in returns)
        outs = _tensors(out, [])
        ins = _tensors(kwargs, _tensors(args, []))
        in_place = aliased and any(r.alias_info.is_write for r in returns
                                   if r.alias_info is not None)
        if not aliased:
            seen = {t.untyped_storage()._cdata for t in ins}
            for t in outs:
                if t.untyped_storage()._cdata not in seen:
                    self._track(t)
        if self._quiet:
            return out
        dtype = dtype_name((ins or outs)[0].dtype) if (ins or outs) else ""
        if aliased and not in_place:
            self.add(OpRecord(op=name, kind="view", dtype=dtype))
            return out
        if name in _ALLOC_ONLY:
            return out
        if name in _SCATTER:
            # the destination's indexed rows only: the values read and
            # written (and the rows read where they accumulate)
            vals = args[_SCATTER[name]]
            vb = vals.numel() * vals.element_size() \
                if isinstance(vals, torch.Tensor) else 0
            acc = name in _ACCUMULATE or (
                name == "aten::index_put_" and bool(
                    args[3] if len(args) > 3 else
                    kwargs.get("accumulate", False)))
            nbytes = sum(_nbytes(t) for t in ins[1:]) + vb * (2 if acc
                                                              else 1)
        else:
            read = ins[1:] if name in _OVERWRITE else ins
            nbytes = sum(_nbytes(t) for t in read) \
                + sum(t.numel() * t.element_size() for t in outs)
        packet = func._overloadpacket
        if packet in flop_registry:
            flops = float(flop_registry[packet](*args, **kwargs,
                                                out_val=out))
            self.add(OpRecord(op=name, kind="dot", dtype=dtype, flops=flops,
                              bytes=float(nbytes)))
        else:
            ew = float(sum(t.numel() for t in outs))
            self.add(OpRecord(op=name, kind="elementwise", dtype=dtype,
                              elementwise=ew, bytes=float(nbytes)))
        return out


# ---------------------------------------------------------------------------
# Totals
# ---------------------------------------------------------------------------


@dataclass
class Totals:
    """Sums over a step's records."""
    dot_flops_by_dtype: Dict[str, float]
    elementwise_flops: float
    hbm_bytes: float
    collective_bytes: float
    bytes_by_kind: Dict[str, float]      # collective wire bytes by kind
    count_by_kind: Dict[str, float]      # collectives by kind
    kernel_sites: Dict[str, int]         # launches a kernel site counts

    @property
    def dot_flops(self) -> float:
        return sum(self.dot_flops_by_dtype.values())


def totals(records) -> Totals:
    by_dtype: Dict[str, float] = {}
    ew = hbm = coll = 0.0
    by_kind: Dict[str, float] = {}
    n_kind: Dict[str, float] = {}
    sites: Dict[str, int] = {}
    for r in records:
        r = r if isinstance(r, OpRecord) else OpRecord(**r)
        c = r.count
        if r.flops:
            by_dtype[r.dtype] = by_dtype.get(r.dtype, 0.0) + c * r.flops
        ew += c * r.elementwise
        hbm += c * r.bytes
        if r.coll_kind:
            coll += c * r.wire_bytes
            by_kind[r.coll_kind] = by_kind.get(r.coll_kind, 0.0) \
                + c * r.wire_bytes
            n_kind[r.coll_kind] = n_kind.get(r.coll_kind, 0) + c
        if r.kind == "kernel":
            site = r.op.split(":", 1)[1]
            sites[site] = sites.get(site, 0) + c
    return Totals(by_dtype, ew, hbm, coll, by_kind, n_kind, sites)
