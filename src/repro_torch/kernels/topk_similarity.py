"""Cosine-similarity top-k over a corpus: the CUDA kernel
(``csrc/topk_similarity.cu``) and its plain PyTorch version.

Port of ``repro/kernels/topk_similarity.py::topk_similarity``, the
recommender's hot spot (paper §IV-B2): both operands are L2-normalised in
fp32 (eps 1e-9) outside the kernel, as the Pallas wrapper does, and the
kernel forms the fp32 dot products and keeps each query's k best
(score, id) pairs, the lower id first on equal scores (``jax.lax.top_k``'s
order).  Only (Q, k) scores and ids leave the kernel.

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

K_MAX = 32       # the kernel's per-thread lists hold at most 32 entries
_QB, _CT = 64, 64        # queries per block, corpus rows per tile (the .cu)
_MERGE_ENTRIES = 6144    # splits * k the merge pass stages (48 KB)
_SMEM_MAX = 232448       # shared memory one block may use on an H100


def _row_stride(dp: int) -> int:
    """Shared-memory row stride in floats (``row_stride`` in the .cu)."""
    g = dp // 4
    return 4 * (g + 1 + (g & 1))


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
    or bfloat16 on one sm_90 device; 0 < k <= min(N, 32).  Returns
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
    dp = -(-d // 4) * 4
    if (_QB + _CT) * _row_stride(dp) * 4 > _SMEM_MAX:
        raise ValueError(f"topk_similarity: D={d} does not fit the kernel's "
                         f"shared-memory tiles")
    qn = torch.nn.functional.normalize(queries.float(), dim=-1, eps=1e-9)
    cn = torch.nn.functional.normalize(corpus.float(), dim=-1, eps=1e-9)
    if dp != d:       # zero columns leave every dot product as it was
        qn = torch.nn.functional.pad(qn, (0, dp - d))
        cn = torch.nn.functional.pad(cn, (0, dp - d))
    qn, cn = qn.contiguous(), cn.contiguous()
    dev = queries.device
    scores = torch.empty((nq, k), dtype=torch.float32, device=dev)
    ids = torch.empty((nq, k), dtype=torch.int32, device=dev)
    if nq == 0:
        return scores, ids
    splits, rows = _splits(nq, n, k, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    ps = torch.empty((splits, nq, k), dtype=torch.float32, device=dev)
    pi = torch.empty((splits, nq, k), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    status = build.entry("topk_similarity")(
        qn.data_ptr(), cn.data_ptr(), ps.data_ptr(), pi.data_ptr(),
        scores.data_ptr(), ids.data_ptr(), nq, n, dp, k, splits, rows, stream)
    build.check_status("topk_similarity", status)
    return scores, ids
