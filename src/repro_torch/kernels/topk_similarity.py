"""Cosine-similarity top-k over a corpus: the CUDA kernel
(``csrc/topk_similarity.cu``) and its plain PyTorch version.

Port of ``repro/kernels/topk_similarity.py::topk_similarity``, the
recommender's hot spot (paper §IV-B2): the kernel L2-normalises the
queries in fp32 (eps 1e-9), as the Pallas wrapper does, and reads the
corpus once, in its own dtype, taking each row's norm from its staged tile;
it forms ``(q^ . c) / max(|c|, 1e-9)`` on the tensor cores
at fp32 accuracy (3xTF32 for an fp32 corpus, three bf16 parts of q^ for a
bf16 one, two TF32 parts of q^ against the exact fp16 values for an fp16
one), keeping each query's k best (score, id) pairs, the lower id
first on equal scores (``jax.lax.top_k``'s order).  Only (Q, k) scores and
ids leave the kernel.

The kernel takes any D and every k up to ``min(N, K_MAX)`` (1024), as the
reference's kernel takes any: for D past one 128-column chunk the queries
are normalised once into a scratch and staged a column chunk at a time
beside the corpus's, so shared memory does not grow with D; for k past 32
each query's running list lives in its split's slice of the partial
lists, sorted, and the merge pass merges the splits' sorted lists.

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

K_MAX = 1024     # the largest k the kernel takes
_K_LANES = 32    # k up to this: a warp's lists a lane an entry
_QB, _CT, _KC = 64, 64, 128   # queries a block, corpus rows a tile,
                              # columns a stage
_MERGE_ENTRIES = 6144    # k <= 32: splits * k the merge pass stages (48 KB)
# k > 32: the sorted lists the merge pass's warp holds (4 a lane), and the
# entries a block's shared memory stages (232448 bytes, 8 an entry)
_SPLITS_BIG = 128
_MERGE_ENTRIES_BIG = 232448 // 8


def _splits(nq: int, n: int, k: int, sms: int):
    """Split the corpus so that the (query block, split) grid holds about
    two blocks per SM, within what the merge pass stages: splits * k <=
    _MERGE_ENTRIES for k <= 32, else at most _SPLITS_BIG lists and
    splits * k <= _MERGE_ENTRIES_BIG; returns (splits, rows per split)."""
    qblocks = -(-nq // _QB)
    tiles = -(-n // _CT)
    cap = _MERGE_ENTRIES // k if k <= _K_LANES else \
        min(_SPLITS_BIG, _MERGE_ENTRIES_BIG // k)
    want = max(1, min(tiles, -(-2 * sms // qblocks), cap))
    rows = -(-tiles // want) * _CT
    return -(-n // rows), rows


def topk_similarity(queries, corpus, k: int):
    """Launch the CUDA kernel.  queries: (Q, D), corpus: (N, D), float32,
    bfloat16 or float16 on one sm_90 device; 0 < k <= min(N, ``K_MAX``),
    any D.  Returns (scores float32 (Q, k), ids int32 (Q, k))."""
    build.dtype_code("topk_similarity", queries)
    code = build.dtype_code("topk_similarity", corpus)
    build.check_device(queries)
    if queries.dim() != 2 or corpus.dim() != 2 or \
            queries.shape[1] != corpus.shape[1]:
        raise ValueError(f"topk_similarity: queries (Q, D) and corpus (N, D) "
                         f"expected, got {tuple(queries.shape)} and "
                         f"{tuple(corpus.shape)}")
    if corpus.device != queries.device:
        raise ValueError(f"topk_similarity: corpus must be on "
                         f"{queries.device}")
    (nq, d), n = queries.shape, corpus.shape[0]
    if not 0 < k <= min(n, K_MAX):
        raise ValueError(f"topk_similarity: k={k} must lie in [1, "
                         f"min(N={n}, {K_MAX})]")
    bf16 = code == build.DTYPE_CODES["bfloat16"]
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
    qn = None
    if d > _KC:       # the normalised queries, staged a chunk at a time:
        # three bf16 parts for a bf16 corpus, else q^ in fp32
        step = 16 if bf16 else 8            # the product's k-step
        qn = torch.empty((3 if bf16 else 1, nq, -(-d // step) * step),
                         dtype=torch.bfloat16 if bf16 else torch.float32,
                         device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    status = build.entry("topk_similarity")(
        qf.data_ptr(), corpus.data_ptr(), ps.data_ptr(), pi.data_ptr(),
        scores.data_ptr(), ids.data_ptr(),
        None if qn is None else qn.data_ptr(), nq, n, d, ldc, k, splits,
        rows, vec, code, stream)
    build.check_status("topk_similarity", status)
    return scores, ids
