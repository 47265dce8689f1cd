"""Cosine-similarity top-k over a corpus: the CUDA kernel
(``csrc/topk_similarity.cu``) and its plain PyTorch version.

Port of ``repro/kernels/topk_similarity.py::topk_similarity``, the
recommender's hot spot (paper §IV-B2): the kernel L2-normalises the
queries in fp32 (eps 1e-9), as the Pallas wrapper does, and reads the
corpus once, in its own dtype, taking each row's norm from its staged tile;
it forms ``(q^ . c) / max(|c|, 1e-9)`` on the tensor cores
at fp32 accuracy (3xTF32 for an fp32 corpus, three bf16 parts of q^ for a
bf16 one), keeping each query's k best (score, id) pairs, the lower id
first on equal scores (``jax.lax.top_k``'s order).  Only (Q, k) scores and
ids leave the kernel.

``topk_similarity`` launches the kernel and takes CUDA tensors only;
``kernels/ops.py`` sends CPU tensors to ``topk_similarity_ref``.  The two
sum each dot product in another order, so scores agree within fp32
rounding and ids agree wherever a score is separated from its neighbours
by more than that; where scores are exactly equal the ids are the same.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

topk_similarity_ref = ref.topk_similarity

K_MAX = 32       # the kernel's per-warp lists hold at most 32 entries
_QB, _CT = 64, 64     # queries a block, corpus rows a tile
_MERGE_ENTRIES = 6144    # splits * k the merge pass stages (48 KB)
_TOO_WIDE = -1           # the C entry's status: D does not fit its tiles


def _splits(nq: int, n: int, k: int, sms: int):
    """Split the corpus so that the (query block, split) grid holds about
    two blocks per SM, with at most _MERGE_ENTRIES partial entries a query;
    returns (splits, rows per split)."""
    qblocks = -(-nq // _QB)
    tiles = -(-n // _CT)
    want = max(1, min(tiles, -(-2 * sms // qblocks), _MERGE_ENTRIES // k))
    rows = -(-tiles // want) * _CT
    return -(-n // rows), rows


def topk_similarity(queries, corpus, k: int):
    """Launch the CUDA kernel.  queries: (Q, D), corpus: (N, D), float32
    or bfloat16 on one sm_90 device; 0 < k <= min(N, 32); D at most 640
    for a float32 corpus, 496 for bfloat16 (the kernel refuses a wider
    one, and the wrapper raises ValueError).  Returns
    (scores float32 (Q, k), ids int32 (Q, k))."""
    build.check_device(queries)
    if queries.dim() != 2 or corpus.dim() != 2 or \
            queries.shape[1] != corpus.shape[1]:
        raise ValueError(f"topk_similarity: queries (Q, D) and corpus (N, D) "
                         f"expected, got {tuple(queries.shape)} and "
                         f"{tuple(corpus.shape)}")
    if corpus.device != queries.device:
        raise ValueError(f"topk_similarity: corpus must be on "
                         f"{queries.device}")
    for name, t in (("queries", queries), ("corpus", corpus)):
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"topk_similarity: {name} must be float32 or "
                            f"bfloat16, got {t.dtype}")
    (nq, d), n = queries.shape, corpus.shape[0]
    if not 0 < k <= min(n, K_MAX):
        raise ValueError(f"topk_similarity: k={k} must lie in [1, "
                         f"min(N={n}, {K_MAX})]")
    bf16 = corpus.dtype == torch.bfloat16
    if corpus.stride(1) != 1 or corpus.stride(0) < d:
        corpus = corpus.contiguous()      # the kernel reads rows in place
    qf = queries.float().contiguous()     # the kernel normalises them
    dev = queries.device
    scores = torch.empty((nq, k), dtype=torch.float32, device=dev)
    ids = torch.empty((nq, k), dtype=torch.int32, device=dev)
    if nq == 0:
        return scores, ids
    ldc, esz = corpus.stride(0), corpus.element_size()
    vec = int((d * esz) % 16 == 0 and (ldc * esz) % 16 == 0
              and corpus.data_ptr() % 16 == 0)
    splits, rows = _splits(nq, n, k, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    ps = torch.empty((splits, nq, k), dtype=torch.float32, device=dev)
    pi = torch.empty((splits, nq, k), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    status = build.entry("topk_similarity")(
        qf.data_ptr(), corpus.data_ptr(), ps.data_ptr(), pi.data_ptr(),
        scores.data_ptr(), ids.data_ptr(), nq, n, d, ldc, k, splits, rows,
        vec, int(bf16), stream)
    if status == _TOO_WIDE:
        raise ValueError(f"topk_similarity: D={d} does not fit the kernel's "
                         f"shared-memory tiles (D <= 640 for a float32 "
                         f"corpus, 496 for bfloat16)")
    build.check_status("topk_similarity", status)
    return scores, ids
