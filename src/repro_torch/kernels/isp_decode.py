"""Decode attention over a dense KV strip masked by explicit key positions:
the CUDA kernel (``csrc/isp_decode.cu``) and its plain PyTorch version.

Port of ``repro/kernels/isp_decode.py``.  The strip ``k/v (B, S, Hkv, dh)``
carries a position per row (``kpos``, -1 = empty), so the same kernel
serves full strips, sliding windows and ring buffers.  It takes both
layouts of the reference: one shared track ``kpos (S,)`` with a scalar
``cur_pos`` (uniform-position decode), and per-slot tracks ``kpos (B, S)``
with ``cur_pos (B,)`` (the serve engine's strips and window rings, which
the reference sends to its jnp path).

``decode_partial`` launches the kernel and takes CUDA tensors only;
``kernels/ops.py`` sends CPU tensors to ``decode_partial_ref``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

decode_partial_ref = ref.decode_partial_masked


def _heads_per_block(group: int, dh: int) -> int:
    """Query heads one block keeps in registers: the largest of 8, 4, 2, 1
    that divides the GQA group and fits 32 values per lane."""
    dpl = 2 if dh <= 64 else 4 if dh <= 128 else 8
    return next(gc for gc in (8, 4, 2, 1)
                if gc * dpl <= 32 and group % gc == 0)


def decode_partial(q, k, v, kpos, cur_pos, *, window: Optional[int] = None,
                   scale: Optional[float] = None):
    """Launch the CUDA kernel.  Same arguments and results as
    ``decode_partial_ref``: q (B, H, dh); k/v (B, S, Hkv, dh) with a
    contiguous head dim (read in place by their strides); kpos (S,) or
    (B, S) int32; cur_pos scalar or (B,).  q, k and v share one dtype
    (float32 or bfloat16) on an sm_90 device.  Returns (acc (B,H,dh) f32,
    l (B,H) f32, m (B,H) f32)."""
    B, H, dh = q.shape
    Bk, S, Hkv, dhk = k.shape
    build.check_device(q)
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"isp_decode: q/k/v must share one dtype of "
                        f"{list(_DTYPES)}, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if v.shape != k.shape or Bk != B or dhk != dh or H % Hkv:
        raise ValueError(f"isp_decode: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if dh > 256:
        raise ValueError(f"isp_decode: head dim {dh} not supported by the "
                         f"kernel")
    if k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("isp_decode: k/v need a contiguous head dim")
    if window is not None and window <= 0:
        raise ValueError(f"isp_decode: window must be positive, got {window}")
    kpos = kpos.to(torch.int32).contiguous()
    if kpos.shape not in ((S,), (B, S)):
        raise ValueError(f"isp_decode: kpos must be (S,) or (B, S), got "
                         f"{tuple(kpos.shape)}")
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
    acc = torch.empty((B, H, dh), dtype=torch.float32, device=q.device)
    l = torch.empty((B, H), dtype=torch.float32, device=q.device)
    m = torch.empty((B, H), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = build.entry("isp_decode")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kpos.data_ptr(),
        cur.data_ptr(), acc.data_ptr(), l.data_ptr(), m.data_ptr(),
        B, H, Hkv, dh, S, *k.stride()[:3], *v.stride()[:3],
        S if kpos.dim() == 2 else 0, 1 if cur.dim() == 1 else 0,
        -1 if window is None else int(window), _heads_per_block(H // Hkv, dh),
        float(scale), _DTYPES[q.dtype], stream)
    build.check_status("isp_decode", status)
    return acc, l, m
