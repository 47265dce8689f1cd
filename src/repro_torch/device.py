"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU:
``device=None`` means CUDA, and without a CUDA device they raise rather
than carry on on the CPU.  On CUDA, TF32 is switched off for matrix
products and cuDNN so float32 math stays float32 (TF32 keeps about three
decimal digits; the reference computes in full float32).
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain PyTorch path")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
