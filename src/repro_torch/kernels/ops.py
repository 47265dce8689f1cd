"""Dispatch of the attention ops by the device of their tensors.

  * a CUDA tensor launches the hand-written kernel (``csrc/*.cu``), which
    raises if it cannot be built or launched, or if the device is not
    sm_90; there is no fallback to the plain version on a GPU;
  * a CPU tensor takes the plain PyTorch version (``ref.py``).

Launches are counted per kernel in ``build.LAUNCHES`` (see
``launch_counts`` / ``reset_launch_counts``).
"""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_decode as pd
from repro_torch.kernels import ref


def _on_cpu(t) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"no kernel or plain path for tensors on {t.device}")


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None, q_offset: int = 0,
                    scale: Optional[float] = None, q_chunk: int = 512,
                    kv_chunk: int = 512):
    """Causal attention.  q: (B,Sq,H,dh); k/v: (B,Skv,Hkv,dh).  The chunk
    sizes shape only the plain path."""
    if _on_cpu(q):
        return ref.chunked_attention(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset, scale=scale,
                                     q_chunk=q_chunk, kv_chunk=kv_chunk)
    return fa.flash_attention(q, k, v, causal=causal, window=window,
                              q_offset=q_offset, scale=scale)


def paged_decode_partial(q, kpool, vpool, pages, cur_pos, *,
                         window: Optional[int] = None,
                         scale: Optional[float] = None):
    """Ragged decode partial over a paged KV pool.  q: (B,H,dh); pools
    (P(+scratch), page_size, Hkv, dh); pages (B,maxp) int32; cur_pos (B,).
    Returns (acc fp32 (B,H,dh), l (B,H), m (B,H))."""
    if _on_cpu(q):
        return pd.paged_decode_partial_ref(q, kpool, vpool, pages, cur_pos,
                                           window=window, scale=scale)
    return pd.paged_decode_partial(q, kpool, vpool, pages, cur_pos,
                                   window=window, scale=scale)


def launch_counts() -> Dict[str, int]:
    """Kernel launches per kernel since the last reset."""
    return dict(build.LAUNCHES)


def reset_launch_counts() -> None:
    build.reset_launches()
