"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, loaded with ``ctypes``.  Builds happen at
first use, from the sources in this package only, into
``build/repro_torch_kernels/`` at the repository root (listed in
``.gitignore``), keyed by a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so a fresh checkout builds everything on
its first call and a warm one builds nothing.
All missing libraries are compiled in parallel, one ``nvcc`` per source.

Nothing here runs at import time: the CPU tests import every module, and
a machine without the CUDA toolkit has no ``nvcc``.

``LAUNCHES`` counts kernel launches per kernel name; a wrapper adds one
right after its kernel launched, and nowhere else.  The cluster's drive
workers launch from several threads, so the counts and the loading of the
libraries go under one lock (``LOCK``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v")

# kernel name -> (source basename, C entry point, argtypes)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
KERNELS = {
    "paged_decode": ("paged_decode.cu", "repro_paged_decode",
                     [_P] * 11 + [_I] * 9 + [_F, _I, _P]),
    "flash_attention": ("flash_attention.cu", "repro_flash_attention",
                        [_P] * 4 + [_I] * 10 + [_F, _I, _P]),
    "isp_decode": ("isp_decode.cu", "repro_isp_decode",
                   [_P] * 11 + [_I] * 5 + [_L] * 6 + [_I] * 6
                   + [_F, _I, _P]),
    "isp_gather": ("isp_gather.cu", "repro_isp_gather",
                   [_P] * 4 + [_L, _L, _I, _L] + [_I] * 5 + [_P]),
    "isp_gather_pool": ("isp_gather_pool.cu", "repro_isp_gather_pool",
                        [_P] * 5 + [_L, _L, _I, _L] + [_I] * 5 + [_P]),
    "topk_similarity": ("topk_similarity.cu", "repro_topk_similarity",
                        [_P] * 6 + [_I] * 9 + [_P]),
}

LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}
BUILD_LOGS: Dict[str, str] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}
LOCK = threading.RLock()


def reset_launches() -> None:
    with LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def launch_counts() -> Dict[str, int]:
    with LOCK:
        return dict(LAUNCHES)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "of repro_torch cannot be built")
    return found


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / KERNELS[name][0]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):   # device code shared by sources
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[List[str]] = None) -> float:
    """Compile every listed kernel whose library is missing, all in
    parallel; returns the wall seconds spent.  Raises on a failed build."""
    with LOCK:
        return _build(list(KERNELS) if names is None else names)


def _build(names: List[str]) -> float:
    todo = [n for n in names if not _target(n).exists()]
    if not todo:
        return 0.0
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for n in todo:
        tmp = _target(n).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / KERNELS[n][0])]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    failed = []
    for n, (tmp, p) in procs.items():
        out, _ = p.communicate()
        BUILD_LOGS[n] = out
        if p.returncode != 0:
            failed.append(f"{n}: nvcc exited {p.returncode}\n{out}")
            continue
        os.replace(tmp, _target(n))
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built and loaded once a
    process (under ``LOCK``, so that threads never load it twice)."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_target(name)))
            fn = getattr(lib, KERNELS[name][1])
            fn.argtypes = KERNELS[name][2]
            fn.restype = ctypes.c_int
            _LIBS[name] = lib
    return lib


def entry(name: str):
    """The C entry point of kernel ``name``."""
    return getattr(library(name), KERNELS[name][1])


def check_device(t) -> None:
    """Raise unless ``t`` lives on an sm_90 CUDA device."""
    import torch
    if t.device.type != "cuda":
        raise ValueError(f"CUDA kernel got a tensor on {t.device}")
    cap = torch.cuda.get_device_capability(t.device)
    if cap != (9, 0):
        raise RuntimeError(f"the repro_torch kernels are built for sm_90a; "
                           f"{torch.cuda.get_device_name(t.device)} is "
                           f"sm_{cap[0]}{cap[1]}")


def check_status(name: str, status: int) -> None:
    if status != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {status}")
    with LOCK:
        LAUNCHES[name] += 1
