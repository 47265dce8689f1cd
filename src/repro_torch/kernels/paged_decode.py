"""Ragged decode attention over a paged KV pool: the CUDA kernel
(``csrc/paged_decode.cu``) and its plain PyTorch version.

Port of ``repro/kernels/paged_decode.py``.  Each batch slot owns a page
table mapping logical pages to physical pool pages, and slots sit at
different positions; the kernel walks each slot's table and computes its
masked single-query GQA attention as combinable fp32 partials.

The kernel is split-K flash-decoding: ``split_plan`` cuts the logical
page axis into ``n_split`` spans from the shapes alone, one block per
(slot, kv head, span) computes a partial, and a second pass merges them.
``paged_decode_partial_split_ref`` is the plain version of that plan and
merge; the tests hold it against the unsplit plain version.

The kernel takes every head dim from 1 to ``MAX_HEAD_DIM`` (256), as the
reference's kernel takes any, and any group ``H // Hkv``: the GQA
families' dims and the smoke configs' 16 stage a page's rows at dh, every
other dim at its lane class's width (``staged_width``).

``paged_decode_partial`` launches the kernel and takes CUDA tensors only;
``kernels/ops.py`` sends CPU tensors to ``paged_decode_partial_ref``.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.core import kv_pages
from repro_torch.kernels import build, ref

NEG_INF = ref.NEG_INF
# The split grid aims at BLOCKS_PER_SM blocks on each SM as if every slot
# were full.  Slots are ragged: most spans hold no valid key and exit at
# once, and the longest slot's span sets the time, so the spans are kept
# short; the floor keeps a block's two-stage page pipeline busy.
SPAN_FLOOR = 4            # logical pages a split covers at least
BLOCKS_PER_SM = ref.SPLIT_BLOCKS_PER_SM
SMEM_MAX = 232448         # shared memory one block may use on sm_90
MAX_HEAD_DIM = 256        # the widest lane class: 32 lanes of 8 dims a key
# head dims with an instantiation of their own (csrc/paged_decode.cu's
# switch): their rows are staged at dh elements
_OWN_DIMS = (16, 32, 64, 128, 240, 256)


def staged_width(dh: int) -> int:
    """Elements a staged K/V row takes in the kernel's shared memory: dh
    for the dims with an instantiation of their own, else 8 lanes' worth of
    the lane class (dh / 8 rounded up to a power of two, at least 4) that
    holds dh, as in isp_decode."""
    if dh in _OWN_DIMS:
        return dh
    return 8 * max(4, 1 << (-(-dh // 8) - 1).bit_length())


# (span, n_split) over the logical pages: ref.split_plan, shared with
# isp_decode; shapes only, nothing is read from the device
split_plan = functools.partial(ref.split_plan, floor=SPAN_FLOOR)


def paged_decode_partial_ref(q, kpool, vpool, pages, cur_pos, *,
                             window: Optional[int] = None,
                             scale: Optional[float] = None):
    """Plain version: gather the paged pool into the per-slot strip view
    and run the strip-path partial on it.

    q: (B, H, dh); kpool/vpool: (P(+scratch), ps, Hkv, dh); pages:
    (B, maxp) int32; cur_pos: (B,) or scalar int32.
    Returns (acc (B,H,dhv) f32, l (B,H) f32, m (B,H) f32).
    """
    ps = kpool.shape[1]
    k, v, kpos = kv_pages.pages_to_strips((kpool, vpool), pages, ps)
    cur = torch.as_tensor(cur_pos, dtype=torch.int32, device=q.device)
    if cur.dim() == 0:
        cur = cur.expand(q.shape[0])
    return ref.decode_partial_masked(q, k, v, kpos, cur, window=window,
                                     scale=scale)


def paged_decode_partial_split_ref(q, kpool, vpool, pages, cur_pos, *,
                                   span: int,
                                   window: Optional[int] = None,
                                   scale: Optional[float] = None):
    """Plain version of the kernel's split plan: the plain partial over
    each span of ``span`` logical pages, merged by ``ref.merge_partials``
    (the kernel's second pass).  Same arguments and results as
    ``paged_decode_partial_ref``."""
    ps, maxp = kpool.shape[1], pages.shape[1]
    k, v, kpos = kv_pages.pages_to_strips((kpool, vpool), pages, ps)
    cur = torch.as_tensor(cur_pos, dtype=torch.int32, device=q.device)
    if cur.dim() == 0:
        cur = cur.expand(q.shape[0])
    parts = [ref.decode_partial_masked(q, k[:, sl], v[:, sl], kpos[:, sl],
                                       cur, window=window, scale=scale)
             for sl in (slice(lp * ps, min(lp + span, maxp) * ps)
                        for lp in range(0, maxp, span))]
    return ref.merge_partials(*(torch.stack(x) for x in zip(*parts)))


def check_shapes(q, kpool, vpool, pages) -> None:
    """Raise unless q (B, H, dh), kpool/vpool (P(+scratch), ps, Hkv, dh)
    and pages (B, maxp) int32 fit the kernel: H a multiple of Hkv (any
    group), 1 <= dh <= ``MAX_HEAD_DIM``, and two stages of a page's K and
    V within a block's shared memory.  Reads only shapes and dtypes, so it
    runs on any device."""
    if q.dim() != 3 or kpool.dim() != 4:
        raise ValueError(f"paged_decode: q must be 3-D and the pools 4-D, "
                         f"got {tuple(q.shape)}, {tuple(kpool.shape)}")
    B, H, dh = q.shape
    _, ps, Hkv, dhk = kpool.shape
    if vpool.shape != kpool.shape or dhk != dh or H % Hkv:
        raise ValueError(f"paged_decode: shapes q {tuple(q.shape)}, kpool "
                         f"{tuple(kpool.shape)}, vpool {tuple(vpool.shape)}")
    if not 1 <= dh <= MAX_HEAD_DIM:
        raise ValueError(f"paged_decode: head dim {dh} is past the kernel's "
                         f"limit of {MAX_HEAD_DIM}")
    if 4 * ps * staged_width(dh) * q.element_size() > SMEM_MAX:
        raise ValueError(f"paged_decode: page_size {ps} too large for the "
                         f"kernel's shared-memory page buffers")
    if pages.dtype != torch.int32 or pages.dim() != 2 or pages.shape[0] != B:
        raise ValueError(f"paged_decode: pages must be (B, maxp) int32, got "
                         f"{tuple(pages.shape)} {pages.dtype}")


def paged_decode_partial(q, kpool, vpool, pages, cur_pos, *,
                         window: Optional[int] = None,
                         scale: Optional[float] = None):
    """Launch the CUDA kernel.  Same arguments and results as
    ``paged_decode_partial_ref``; every tensor must be a contiguous CUDA
    tensor on an sm_90 device (q and pools one of float32, bfloat16 and
    float16, pages and cur_pos int32).  The pools are read in place, by
    their layout."""
    B, H, dh = q.shape
    code = build.dtype_code("paged_decode", q, kpool, vpool)
    build.check_device(q)
    check_shapes(q, kpool, vpool, pages)
    ps, Hkv = kpool.shape[1], kpool.shape[2]
    cur = torch.as_tensor(cur_pos, dtype=torch.int32, device=q.device)
    if cur.dim() == 0:
        cur = cur.expand(B)
    cur = cur.contiguous()
    if window is not None and window <= 0:
        raise ValueError(f"paged_decode: window must be positive, got "
                         f"{window}")
    for name, t in (("q", q), ("kpool", kpool), ("vpool", vpool),
                    ("pages", pages)):
        if not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"paged_decode: {name} must be contiguous on "
                             f"{q.device}")
        if name != "pages" and t.data_ptr() % 16:
            raise ValueError(f"paged_decode: {name} must start on a 16-byte "
                             f"boundary (the kernel copies 16-byte vectors)")
    scale = dh ** -0.5 if scale is None else scale
    maxp = pages.shape[1]
    span, n_split = split_plan(
        B, Hkv, maxp,
        torch.cuda.get_device_properties(q.device).multi_processor_count)
    f32 = dict(dtype=torch.float32, device=q.device)
    acc, l, m = (torch.empty(s, **f32) for s in ((B, H, dh), (B, H), (B, H)))
    # fp32 split partials, merged by the kernel's second pass
    scratch = (torch.empty((B, H, n_split, dh), **f32),
               torch.empty((B, H, n_split), **f32),
               torch.empty((B, H, n_split), **f32))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = build.entry("paged_decode")(
        q.data_ptr(), kpool.data_ptr(), vpool.data_ptr(), pages.data_ptr(),
        cur.data_ptr(), acc.data_ptr(), l.data_ptr(), m.data_ptr(),
        *(t.data_ptr() for t in scratch), B, H, Hkv, dh, ps, maxp,
        -1 if window is None else int(window), span, n_split, float(scale),
        code, stream)
    build.check_status("paged_decode", status)
    return acc, l, m
