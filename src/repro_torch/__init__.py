"""PyTorch/CUDA port of the ``repro`` serving system.

The JAX package ``repro`` is the reference; this package serves the same
requests with the same tokens, ledgers and stats on an NVIDIA H100, with
the attention kernels written by hand in CUDA C++ for sm_90a
(``kernels/csrc``).  It imports torch, numpy and the standard library only.
"""
