"""Decode attention over a dense KV strip masked by explicit key positions:
the CUDA kernel (``csrc/isp_decode.cu``) and its plain PyTorch version.

Port of ``repro/kernels/isp_decode.py``.  The strip ``k/v (B, S, Hkv, dh)``
carries a position per row (``kpos``, -1 = empty), so the same kernel
serves full strips, sliding windows and ring buffers.  It takes both
layouts of the reference: one shared track ``kpos (S,)`` with a scalar
``cur_pos`` (uniform-position decode), and per-slot tracks ``kpos (B, S)``
with ``cur_pos (B,)`` (the serve engine's strips and window rings, which
the reference sends to its jnp path).

The kernel is split-K flash-decoding: ``split_plan`` cuts the strip's rows
into ``n_split`` spans from the shapes alone, one block per (slot, kv
head, span) computes a partial over its span's valid rows, and a second
pass merges them.  ``decode_partial_split_ref`` is the plain version of
that plan and merge; the tests hold it against the unsplit plain version.

``decode_partial`` launches the kernel and takes CUDA tensors only;
``kernels/ops.py`` sends CPU tensors to ``decode_partial_ref``.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.kernels import build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# The split grid aims at BLOCKS_PER_SM blocks on each SM.  Ring rows are not
# sorted by position, so every span reads its positions and may find few
# valid rows; the floor keeps a block's two-stage row pipeline busy, and the
# cap bounds the block's list of valid rows in shared memory.
ROW_FLOOR = 64            # strip rows a span covers at least
SPAN_MAX = 1024           # strip rows a span covers at most
BLOCKS_PER_SM = ref.SPLIT_BLOCKS_PER_SM

decode_partial_ref = ref.decode_partial_masked


# (span, n_split) over the strip's rows: ref.split_plan, shared with
# paged_decode; shapes only, nothing is read from the device
split_plan = functools.partial(ref.split_plan, floor=ROW_FLOOR, cap=SPAN_MAX)


def decode_partial_split_ref(q, k, v, kpos, cur_pos, *, span: int,
                             window: Optional[int] = None,
                             scale: Optional[float] = None):
    """Plain version of the kernel's split plan: the plain partial over
    each span of ``span`` strip rows, merged by ``ref.merge_partials`` (the
    kernel's second pass).  Same arguments and results as
    ``decode_partial_ref``."""
    parts = [decode_partial_ref(q, k[:, s0:s0 + span], v[:, s0:s0 + span],
                                kpos[..., s0:s0 + span], cur_pos,
                                window=window, scale=scale)
             for s0 in range(0, k.shape[1], span)]
    return ref.merge_partials(*(torch.stack(x) for x in zip(*parts)))


def check_shapes(q, k, v, kpos) -> None:
    """Raise unless q (B, H, dh), k/v (B, S, Hkv, dh) with a contiguous
    head dim and kpos (S,) or (B, S) fit the kernel: H a multiple of Hkv
    and dh at most 256.  Reads only shapes and strides, so it runs on any
    device."""
    if q.dim() != 3 or k.dim() != 4:
        raise ValueError(f"isp_decode: q must be 3-D and k/v 4-D, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}")
    B, H, dh = q.shape
    Bk, S, Hkv, dhk = k.shape
    if v.shape != k.shape or Bk != B or dhk != dh or H % Hkv:
        raise ValueError(f"isp_decode: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if dh > 256:
        raise ValueError(f"isp_decode: head dim {dh} not supported by the "
                         f"kernel")
    if k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("isp_decode: k/v need a contiguous head dim")
    if kpos.shape not in ((S,), (B, S)):
        raise ValueError(f"isp_decode: kpos must be (S,) or (B, S), got "
                         f"{tuple(kpos.shape)}")


def decode_partial(q, k, v, kpos, cur_pos, *, window: Optional[int] = None,
                   scale: Optional[float] = None):
    """Launch the CUDA kernel.  Same arguments and results as
    ``decode_partial_ref``: q (B, H, dh); k/v (B, S, Hkv, dh) with a
    contiguous head dim (read in place by their strides); kpos (S,) or
    (B, S) int32; cur_pos scalar or (B,).  q, k and v share one dtype
    (float32 or bfloat16) on an sm_90 device.  Returns (acc (B,H,dh) f32,
    l (B,H) f32, m (B,H) f32)."""
    B, H, dh = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    build.check_device(q)
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"isp_decode: q/k/v must share one dtype of "
                        f"{list(_DTYPES)}, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    check_shapes(q, k, v, kpos)
    if window is not None and window <= 0:
        raise ValueError(f"isp_decode: window must be positive, got {window}")
    kpos = kpos.to(torch.int32).contiguous()
    cur = torch.as_tensor(cur_pos, dtype=torch.int32,
                          device=q.device).contiguous()
    if cur.shape not in ((), (B,)):
        raise ValueError(f"isp_decode: cur_pos must be scalar or (B,), got "
                         f"{tuple(cur.shape)}")
    q = q.contiguous()
    for name, t in (("k", k), ("v", v), ("kpos", kpos), ("cur", cur)):
        if t.device != q.device:
            raise ValueError(f"isp_decode: {name} must be on {q.device}")
    scale = dh ** -0.5 if scale is None else scale
    epc = 16 // q.element_size()    # elements in a 16-byte copy
    vec = int(dh % epc == 0 and all(
        st % epc == 0 for st in (*k.stride()[:3], *v.stride()[:3]))
        and k.data_ptr() % 16 == 0 and v.data_ptr() % 16 == 0)
    span, n_split = split_plan(
        B, Hkv, S,
        torch.cuda.get_device_properties(q.device).multi_processor_count)
    f32 = dict(dtype=torch.float32, device=q.device)
    acc, l, m = (torch.empty(s, **f32) for s in ((B, H, dh), (B, H), (B, H)))
    # fp32 split partials, merged by the kernel's second pass
    scratch = (torch.empty((B, H, n_split, dh), **f32),
               torch.empty((B, H, n_split), **f32),
               torch.empty((B, H, n_split), **f32))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = build.entry("isp_decode")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kpos.data_ptr(),
        cur.data_ptr(), acc.data_ptr(), l.data_ptr(), m.data_ptr(),
        *(t.data_ptr() for t in scratch), B, H, Hkv, dh, S,
        *k.stride()[:3], *v.stride()[:3],
        S if kpos.dim() == 2 else 0, 1 if cur.dim() == 1 else 0,
        -1 if window is None else int(window), span, n_split, vec,
        float(scale), _DTYPES[q.dtype], stream)
    build.check_status("isp_decode", status)
    return acc, l, m
