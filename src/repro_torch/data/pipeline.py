"""Deterministic sharded data pipeline (a copy of
``repro/data/pipeline.py``: numpy only, imported by the port's trainer).

The OCFS2 "send indexes, not data" protocol becomes a pure function: every
worker derives its slice of step ``s`` from (step, host_id, shares) alone —
no dispatcher process, no shared-filesystem locking, and restart-exact
(checkpointing the pipeline = storing the step integer).

Sources:
  SyntheticTokenSource — hash-based deterministic tokens (tests, dry-runs)
  MemmapTokenSource    — binary .bin file of uint16/uint32 tokens, mmap'd
                         so each worker reads only its own byte ranges (the
                         in-storage path: bytes the worker doesn't own are
                         never read).

The loader supports heterogeneous per-host shares (the paper's batch ratio)
via ``shares``: host h gets ``shares[h]`` of every global batch.
"""
from __future__ import annotations

import dataclasses
import hashlib
import pathlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    vocab_size: int
    seed: int = 0


class SyntheticTokenSource:
    """Deterministic pseudo-random tokens: token[i] = h(seed, i) % vocab."""

    def __init__(self, vocab_size: int, seed: int = 0):
        self.vocab = int(vocab_size)
        self.seed = int(seed)

    def read(self, start: int, count: int) -> np.ndarray:
        # counter-based generation — O(1) seek, restart-exact
        blocks = []
        blk = 1 << 16
        b0, b1 = start // blk, (start + count - 1) // blk
        for b in range(b0, b1 + 1):
            rng = np.random.default_rng((self.seed << 32) ^ b)
            blocks.append(rng.integers(0, self.vocab, blk, dtype=np.int64))
        cat = np.concatenate(blocks)
        off = start - b0 * blk
        return cat[off: off + count].astype(np.int32)

    def __len__(self) -> int:
        return 1 << 62


class MemmapTokenSource:
    """Token stream backed by a flat binary file (np.memmap, read-only)."""

    def __init__(self, path, dtype=np.uint16):
        self.path = pathlib.Path(path)
        self.arr = np.memmap(self.path, dtype=dtype, mode="r")

    def read(self, start: int, count: int) -> np.ndarray:
        n = len(self.arr)
        idx = (start + np.arange(count)) % n       # wrap (epoch boundary)
        return self.arr[idx].astype(np.int32)

    def __len__(self) -> int:
        return len(self.arr)


def write_token_file(path, tokens: np.ndarray, dtype=np.uint16) -> None:
    np.asarray(tokens, dtype=dtype).tofile(path)


class ShardedLoader:
    """Per-host batch loader with heterogeneous shares.

    Global batch b of step s covers token span
      [s * global_batch * (seq+1), (s+1) * global_batch * (seq+1))
    split contiguously by per-host shares; host h reads only its own span —
    that is the ISP property (bytes never visit a coordinator).
    """

    def __init__(self, source, cfg: DataConfig,
                 shares: Optional[Dict[str, int]] = None,
                 host: str = "host0", num_hosts: int = 1):
        self.source = source
        self.cfg = cfg
        self.host = host
        if shares is None:
            base = cfg.global_batch // num_hosts
            shares = {f"host{i}": base for i in range(num_hosts)}
            shares[f"host{num_hosts - 1}"] += cfg.global_batch - base * num_hosts
        assert sum(shares.values()) == cfg.global_batch, shares
        self.shares = dict(shares)

    def set_shares(self, shares: Dict[str, int]) -> None:
        """Straggler rebalancing entry point (paper's batch-ratio rule)."""
        assert sum(shares.values()) == self.cfg.global_batch
        self.shares = dict(shares)

    def _host_offset(self, host: str) -> int:
        off = 0
        for h in sorted(self.shares):
            if h == host:
                return off
            off += self.shares[h]
        raise KeyError(host)

    def batch_at(self, step: int, host: Optional[str] = None) -> Dict[str, np.ndarray]:
        """Returns {"tokens": (share, seq), "labels": (share, seq)}."""
        host = host or self.host
        cfg = self.cfg
        stride = cfg.seq_len + 1
        base = step * cfg.global_batch * stride
        off = self._host_offset(host)
        n = self.shares[host]
        flat = self.source.read(base + off * stride, n * stride)
        seqs = flat.reshape(n, stride)
        return {"tokens": seqs[:, :-1].copy(), "labels": seqs[:, 1:].copy()}

    def global_batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Assemble the full global batch (tests / single-host training)."""
        parts = [self.batch_at(step, h) for h in sorted(self.shares)]
        return {k: np.concatenate([p[k] for p in parts], axis=0)
                for k in parts[0]}
