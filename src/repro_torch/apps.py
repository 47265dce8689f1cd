"""The paper's three NLP applications (port of ``benchmarks/apps.py``).

Each app provides:
  * the compute of one query batch (the work a node performs), through the
    port's kernel ops: the recommender's cosine top-10
    (``ops.topk_similarity``) and the sentiment app's bag of embeddings
    (``ops.isp_gather_pool``), then a (d, 2) head and an argmax;
  * the paper's single-node rates (host Xeon vs CSD A53), batch sizes,
    dataset bytes and Fig. 5 / Table I end points, which drive the pull
    scheduler's cluster simulation (``core/scheduler.py``).

The batch functions draw the reference's numpy values from the caller's
``rng`` in the reference's order, so one seed gives both packages the same
inputs.  ``device=None`` means CUDA (``device.resolve_device``); the results
come back as numpy arrays.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops


@dataclass(frozen=True)
class AppSpec:
    name: str
    host_rate: float          # items/s, paper single-node measurement
    csd_rate: float
    batch_size: int           # paper's per-CSD batch
    total_items: int          # dataset size used in the paper run
    dataset_bytes: float
    output_bytes: float
    paper_host_only: float    # Fig. 5 end points
    paper_with_36: float
    paper_csd_fraction: float
    paper_energy_host_mj: float
    paper_energy_csd_mj: float


APPS: Dict[str, AppSpec] = {
    "speech_to_text": AppSpec(
        "speech_to_text", host_rate=102.0, csd_rate=5.3, batch_size=6,
        total_items=225_715, dataset_bytes=3.8e9, output_bytes=1.2e6,
        paper_host_only=96.0, paper_with_36=296.0, paper_csd_fraction=0.68,
        paper_energy_host_mj=5021.0, paper_energy_csd_mj=1662.0),
    "recommender": AppSpec(
        "recommender", host_rate=600.0, csd_rate=25.8, batch_size=50,
        total_items=290_000, dataset_bytes=1.1e9, output_bytes=12e6,
        paper_host_only=579.0, paper_with_36=1506.0, paper_csd_fraction=0.64,
        paper_energy_host_mj=832.0, paper_energy_csd_mj=327.0),
    "sentiment": AppSpec(
        "sentiment", host_rate=9_800.0, csd_rate=380.0, batch_size=40_000,
        total_items=8_000_000, dataset_bytes=1.6e9, output_bytes=8e6,
        paper_host_only=9_496.0, paper_with_36=20_994.0,
        paper_csd_fraction=0.56,
        paper_energy_host_mj=51.0, paper_energy_csd_mj=23.0),
}


# --- real per-batch compute (the work each node would run) -------------------


def _on(x: np.ndarray, dtype, dev) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x).astype(dtype)).to(dev)


def recommender_inputs(rng: np.random.Generator, n_queries: int = 64,
                       corpus: int = 2048, d: int = 128, device=None):
    """The recommender batch's queries (n_queries, d) and movie matrix
    (corpus, d), float32, drawn in the reference's order."""
    dev = resolve_device(device)
    q = _on(rng.normal(size=(n_queries, d)), np.float32, dev)
    c = _on(rng.normal(size=(corpus, d)), np.float32, dev)
    return q, c


def recommender_query_batch(rng: np.random.Generator, n_queries: int = 64,
                            corpus: int = 2048, d: int = 128, k: int = 10,
                            device=None) -> np.ndarray:
    """Cosine-similarity top-10 over the movie matrix (paper §IV-B2)."""
    q, c = recommender_inputs(rng, n_queries, corpus, d, device)
    _, ids = ops.topk_similarity(q, c, k)
    return ids.cpu().numpy()


def sentiment_inputs(rng: np.random.Generator, n_queries: int = 256,
                     vocab: int = 4096, d: int = 64, device=None):
    """The sentiment batch: ids (n_queries * 12,) int32, their review ids,
    the (vocab, d) embedding table and the (d, 2) head, float32, drawn in
    the reference's order."""
    dev = resolve_device(device)
    lens = 12
    idx = _on(rng.integers(0, vocab, (n_queries * lens,)), np.int32, dev)
    seg = torch.arange(n_queries, dtype=torch.int32,
                       device=dev).repeat_interleave(lens)
    table = _on(rng.normal(size=(vocab, d)), np.float32, dev)
    w = _on(rng.normal(size=(d, 2)), np.float32, dev)
    return idx, seg, table, w


def sentiment_query_batch(rng: np.random.Generator, n_queries: int = 256,
                          vocab: int = 4096, d: int = 64,
                          device=None) -> np.ndarray:
    """Bag-of-embeddings classifier: ISP gather+pool then a linear head —
    the RecSSD-style embedding-bag offload (paper §II)."""
    idx, seg, table, w = sentiment_inputs(rng, n_queries, vocab, d, device)
    pooled = ops.isp_gather_pool(table, idx, seg, n_queries)
    logits = pooled @ w
    return logits.argmax(-1).cpu().numpy()


def speech_decode_batch(rng: np.random.Generator, n_frames: int = 64,
                        d: int = 80, vocab: int = 512,
                        device=None) -> np.ndarray:
    """Greedy CTC-style frame decoding stand-in for the Vosk pipeline."""
    dev = resolve_device(device)
    frames = _on(rng.normal(size=(1, n_frames, d)), np.float32, dev)
    w = _on(rng.normal(size=(d, vocab)), np.float32, dev)
    logits = frames @ w
    return logits.argmax(-1).cpu().numpy()
