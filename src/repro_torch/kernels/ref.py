"""Plain PyTorch versions of the kernels, and the chunked attention
backward (``flash_attention_bwd``) that training runs on every device.

These are the port's counterparts of ``repro/kernels/ref.py`` and keep its
conventions: ``NEG_INF = -1e30`` (not -inf), fp32 ``(acc, l, m)`` decode
partials, and the ``l == 0 -> 1`` guard.  A CPU tensor takes these paths
(``kernels/ops.py``); on the card they are what the CUDA kernels are held
against.

Layout conventions:
  q:      (B, Sq, H,   Dh)
  k, v:   (B, Skv, Hkv, Dh)       H % Hkv == 0 (GQA: q head h reads h // g)
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e30
SPLIT_BLOCKS_PER_SM = 8   # split-K decode grids aim at this many blocks an SM


def naive_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None, q_offset: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Full-materialization attention (small shapes only)."""
    B, Sq, H, dh = q.shape
    _, Skv, Hkv, _ = k.shape
    g = H // Hkv
    scale = dh ** -0.5 if scale is None else scale
    qg = q.reshape(B, Sq, Hkv, g, dh).float()
    s = torch.einsum("bqhgd,bkhd->bqhgk", qg, k.float()) * scale
    qpos = q_offset + torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqhgk,bkhd->bqhgd", p, v.float())
    return out.reshape(B, Sq, H, v.shape[-1]).to(q.dtype)


def _pad_axis(x, multiple: int, axis: int):
    pad = (-x.shape[axis]) % multiple
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def _kv_chunk_starts(window, q_offset, q_chunk, kv_chunk, nq_idx: int,
                     skv_padded: int):
    """Starts of the kv chunks visited by q chunk ``nq_idx``."""
    kc = kv_chunk
    if window is None:
        return list(range(0, skv_padded, kc))
    span = window + q_chunk + kc
    n_chunks = -(-span // kc)
    q_hi = q_offset + (nq_idx + 1) * q_chunk
    base = q_hi - n_chunks * kc
    base = min(max(base, 0), max(skv_padded - n_chunks * kc, 0))
    base = (base // kc) * kc
    return [base + i * kc for i in range(n_chunks)]


def _pad_qkv(q, k, v, window, qc: int, kc: int):
    """q padded to whole q chunks, k/v to whole kv chunks and, with a
    window, to at least the span a windowed q chunk slices (the
    reference's padding)."""
    qp = _pad_axis(q, qc, 1)
    kp = _pad_axis(k, kc, 1)
    vp = _pad_axis(v, kc, 1)
    if window is not None:
        need = (-(-(window + qc + kc) // kc)) * kc
        if kp.shape[1] < need:
            kp = _pad_axis(kp, need, 1)
            vp = _pad_axis(vp, need, 1)
    return qp, kp, vp


def _block_scores(qblk, kblk, qpos, kpos, skv: int, causal: bool,
                  window, scale: float):
    """Scaled fp32 scores (B, qc, Hkv, g, kc) of one (q chunk, kv chunk)
    block with the reference's masks at -1e30."""
    s = torch.einsum("bqhgd,bkhd->bqhgk", qblk, kblk) * scale
    mask = kpos[None, :] < skv
    if causal:
        mask = mask & (kpos[None, :] <= qpos[:, None])
    if window is not None:
        mask = mask & (kpos[None, :] > qpos[:, None] - window)
    return torch.where(mask[None, :, None, None, :], s, NEG_INF)


def chunked_attention(q, k, v, *, causal: bool = True,
                      window: Optional[int] = None, q_offset: int = 0,
                      scale: Optional[float] = None, q_chunk: int = 512,
                      kv_chunk: int = 512, return_lse: bool = False):
    """Chunked online-softmax attention, the forward of the reference's
    ``chunked_attention`` (``_flash_fwd_impl``): the same chunking, the same
    -1e30 masking with no mask on ``p``, and the same ``l == 0`` guard.
    Returns (B, Sq, H, dhv) in q's dtype, or with ``return_lse`` (out, lse
    (B, Sq, H) float32), ``lse = m + log(l_safe)`` as in the reference (a
    row that sees no key counts its masked scores in ``l``, so its lse is
    -1e30 and its output the mean of the values its chunks visit)."""
    B, Sq, H, dh = q.shape
    dhv = v.shape[-1]
    _, Skv, Hkv, _ = k.shape
    g = H // Hkv
    scale = dh ** -0.5 if scale is None else scale
    qc = min(q_chunk, Sq)
    kc = min(kv_chunk, Skv)
    qp, kp, vp = _pad_qkv(q, k, v, window, qc, kc)
    sq_p, skv_p = qp.shape[1], kp.shape[1]
    nq = sq_p // qc
    kf, vf = kp.float(), vp.float()
    outs, lses = [], []
    for qi in range(nq):
        qblk = qp[:, qi * qc:(qi + 1) * qc].reshape(B, qc, Hkv, g, dh).float()
        qpos = q_offset + qi * qc + torch.arange(qc, device=q.device)
        m = torch.full((B, qc, Hkv, g), NEG_INF, device=q.device)
        l = torch.zeros((B, qc, Hkv, g), device=q.device)
        acc = torch.zeros((B, qc, Hkv, g, dhv), device=q.device)
        for start in _kv_chunk_starts(window, q_offset, qc, kc, qi, skv_p):
            kblk = kf[:, start:start + kc]
            vblk = vf[:, start:start + kc]
            kpos = start + torch.arange(kc, device=q.device)
            s = _block_scores(qblk, kblk, qpos, kpos, Skv, causal, window,
                              scale)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum("bqhgk,bkhd->bqhgd",
                                                        p, vblk)
            m = m_new
        l_safe = torch.where(l == 0, torch.ones_like(l), l)
        outs.append((acc / l_safe[..., None]).to(q.dtype))
        if return_lse:
            lses.append(m + torch.log(l_safe))
    out = torch.cat(outs, dim=1).reshape(B, sq_p, H, dhv)[:, :Sq]
    if not return_lse:
        return out
    return out, torch.cat(lses, dim=1).reshape(B, sq_p, H)[:, :Sq]


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True,
                        window: Optional[int] = None, q_offset: int = 0,
                        scale: Optional[float] = None, q_chunk: int = 512,
                        kv_chunk: int = 512):
    """The attention backward of the reference's ``custom_vjp``
    (``_flash_bwd_impl``): scores recomputed chunk by chunk from q, k and
    the forward's ``lse``, ``p = exp(s - lse)``, ``delta = rowsum(dout *
    out)`` in fp32, ``ds = p (dout v^T - delta) scale``; the same chunks
    (every kv chunk for a causal q chunk, the window's span otherwise),
    masks and -1e30; dq per q chunk, dk/dv accumulated in fp32 over the q
    chunks.  q: (B, Sq, H, dh); k: (B, Skv, Hkv, dh); v (B, Skv, Hkv, dv);
    out/dout (B, Sq, H, dv); lse (B, Sq, H) float32.  Returns (dq, dk, dv)
    in q's, k's and v's dtypes.  Plain tensor code on every device (the
    reference has no Pallas backward), so no launch is counted."""
    B, Sq, H, dh = q.shape
    dhv = v.shape[-1]
    _, Skv, Hkv, _ = k.shape
    g = H // Hkv
    scale = dh ** -0.5 if scale is None else scale
    qc = min(q_chunk, Sq)
    kc = min(kv_chunk, Skv)
    qp, kp, vp = _pad_qkv(q, k, v, window, qc, kc)
    op = _pad_axis(out, qc, 1)
    dop = _pad_axis(dout, qc, 1)
    lsep = _pad_axis(lse, qc, 1)
    sq_p, skv_p = qp.shape[1], kp.shape[1]
    nq = sq_p // qc
    delta = (dop.float() * op.float()).sum(dim=-1)              # (B, Sq, H)
    kf, vf = kp.float(), vp.float()
    dk = torch.zeros((B, skv_p, Hkv, dh), dtype=torch.float32,
                     device=q.device)
    dv = torch.zeros((B, skv_p, Hkv, dhv), dtype=torch.float32,
                     device=q.device)
    dqs = []
    for qi in range(nq):
        rows = slice(qi * qc, (qi + 1) * qc)
        qblk = qp[:, rows].reshape(B, qc, Hkv, g, dh).float()
        doblk = dop[:, rows].reshape(B, qc, Hkv, g, dhv).float()
        lseblk = lsep[:, rows].reshape(B, qc, Hkv, g)
        dlblk = delta[:, rows].reshape(B, qc, Hkv, g)
        qpos = q_offset + qi * qc + torch.arange(qc, device=q.device)
        dq = torch.zeros((B, qc, Hkv, g, dh), dtype=torch.float32,
                         device=q.device)
        for start in _kv_chunk_starts(window, q_offset, qc, kc, qi, skv_p):
            kblk = kf[:, start:start + kc]
            vblk = vf[:, start:start + kc]
            kpos = start + torch.arange(kc, device=q.device)
            s = _block_scores(qblk, kblk, qpos, kpos, Skv, causal, window,
                              scale)
            p = torch.exp(s - lseblk[..., None])              # (B,qc,Hkv,g,kc)
            dp = torch.einsum("bqhgd,bkhd->bqhgk", doblk, vblk)
            ds = p * (dp - dlblk[..., None]) * scale
            dq += torch.einsum("bqhgk,bkhd->bqhgd", ds, kblk)
            dk[:, start:start + kc] += torch.einsum("bqhgk,bqhgd->bkhd", ds,
                                                    qblk)
            dv[:, start:start + kc] += torch.einsum("bqhgk,bqhgd->bkhd", p,
                                                    doblk)
        dqs.append(dq)
    dq = torch.cat(dqs, dim=1).reshape(B, sq_p, H, dh)[:, :Sq]
    return (dq.to(q.dtype), dk[:, :Skv].to(k.dtype),
            dv[:, :Skv].to(v.dtype))


def _decode_valid_mask(kpos, cur_pos, window: Optional[int] = None):
    """Validity mask for decode attention, broadcast to (B*, S).

    kpos: (S,) shared cache positions or (B, S) per-slot positions;
    cur_pos: scalar or (B,) per-slot positions.
    """
    kposb = kpos if kpos.dim() == 2 else kpos[None, :]
    cur = torch.as_tensor(cur_pos, device=kpos.device)
    curb = cur[:, None] if cur.dim() == 1 else cur
    valid = (kposb >= 0) & (kposb <= curb)
    if window is not None:
        valid = valid & (kposb > curb - window)
    return valid


def decode_partial_masked(q, k, v, kpos, cur_pos, *,
                          window: Optional[int] = None,
                          scale: Optional[float] = None):
    """Decode partial with explicit per-slot global positions.

    q: (B, H, dh); k/v: (B, S, Hkv, dh); kpos: (S,) or (B, S) int32 (-1 =
    empty); cur_pos: scalar or (B,).  Returns (acc (B,H,dhv) fp32,
    l (B,H) fp32, m (B,H) fp32).
    """
    B, H, dh = q.shape
    _, S, Hkv, dhv = v.shape
    g = H // Hkv
    scale = dh ** -0.5 if scale is None else scale
    qg = q.reshape(B, Hkv, g, dh).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k.float()) * scale
    valid = _decode_valid_mask(kpos, cur_pos, window)[:, None, None, :]
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    p = torch.where(valid, p, 0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum("bhgk,bkhd->bhgd", p, v.float())
    return acc.reshape(B, H, dhv), l.reshape(B, H), m.reshape(B, H)


def chunk_attention_masked(q, k, v, kpos, qpos, *,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Prefill-continuation attention: a chunk of queries at explicit
    positions against a cached span with explicit key positions.

    q: (B, C, H, dh); k/v: (B, S, Hkv, dh[v]); kpos: (B, S) int32 global
    position of each cache row (-1 = empty); qpos: (B, C) int32 query
    positions (-1 = pad row).  Key j is visible to query i iff
    ``kpos[j] >= 0 and kpos[j] <= qpos[i]``: the chunk's own rows are in
    the cache already, so this is causal attention over prefix + chunk.
    Returns (B, C, H, dhv) in q's dtype (pad rows are finite garbage).
    """
    B, C, H, dh = q.shape
    Hkv, dhv = v.shape[2], v.shape[3]
    g = H // Hkv
    scale = dh ** -0.5 if scale is None else scale
    qg = q.reshape(B, C, Hkv, g, dh).float()
    s = torch.einsum("bchgd,bkhd->bchgk", qg, k.float()) * scale
    valid = (kpos[:, None, :] >= 0) & (qpos[:, :, None] >= 0) \
        & (kpos[:, None, :] <= qpos[:, :, None])
    valid = valid[:, :, None, None, :]
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = torch.where(valid, p, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bchgk,bkhd->bchgd", p, v.float())
    out = out / torch.where(l == 0, torch.ones_like(l), l)
    return out.reshape(B, C, H, dhv).to(q.dtype)


def merge_partials(acc, l, m, axis: int = 0):
    """Merge flash-decoding partials along ``axis`` into one unnormalised
    ``(acc, l, m)``: m = max m_i, l = sum l_i e^(m_i - m), acc = sum
    acc_i e^(m_i - m).  An all-empty set (every m_i = -1e30, l_i = 0)
    stays empty: its weights are e^0 = 1 times zeros."""
    m_glob = m.amax(dim=axis, keepdim=True)
    w = torch.exp(m - m_glob)
    return ((acc * w[..., None]).sum(dim=axis), (l * w).sum(dim=axis),
            m_glob.squeeze(axis))


def split_plan(batch: int, kv_heads: int, units: int, num_sms: int, *,
               floor: int, cap: Optional[int] = None) -> Tuple[int, int]:
    """``(span, n_split)`` of a split-K decode launch, cutting ``units``
    (paged decode's logical pages, isp decode's strip rows) into spans of
    ``span``: at least ``floor`` (or every unit), at most ``cap``, as many
    as the floor allows up to a grid (batch, kv_heads, n_split) of
    ``SPLIT_BLOCKS_PER_SM`` blocks on each of ``num_sms`` SMs.  Shapes
    only: nothing is read from the device."""
    target = -(-SPLIT_BLOCKS_PER_SM * num_sms // max(1, batch * kv_heads))
    span = max(floor, units // target)
    if cap is not None:
        span = min(span, cap)
    span = min(span, max(1, units))
    return span, max(1, -(-units // span))


def mla_decode_scores_partial(q_eff, q_rope, ckv, krope, kpos, cur_pos, *,
                              scale: float):
    """MLA absorbed decode partial over a compressed-KV span, in fp32.

    q_eff: (B, H, R), q_nope already absorbed through wk_b; q_rope:
    (B, H, r); ckv: (B, S, R); krope: (B, S, r); kpos (S,) with a scalar
    cur_pos, or (B, S) with cur_pos (B,).  Returns (acc (B, H, R), l, m)
    partials, ``acc`` the probability-weighted sum of ckv rows; masked
    scores are -1e30 and their p exactly 0."""
    ckv32 = ckv.float()
    s = torch.einsum("bhr,bsr->bhs", q_eff.float(), ckv32)
    s = s + torch.einsum("bhr,bsr->bhs", q_rope.float(), krope.float())
    s = s * scale
    valid = _decode_valid_mask(kpos, cur_pos)[:, None, :]
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    p = torch.where(valid, p, 0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum("bhs,bsr->bhr", p, ckv32)
    return acc, l, m


def combine_partials(acc, l, m, axis: int = 0):
    """Merge flash-decoding partials along ``axis`` (stacked shards)."""
    acc, l, _ = merge_partials(acc, l, m, axis)
    l = torch.where(l == 0, torch.ones_like(l), l)
    return acc / l[..., None]


def shard_rows_of(table, shard_rows=None) -> int:
    """The rows of ``table`` a gather may read: ``shard_rows``, or all of
    them by default; raises ValueError past the table's rows."""
    if shard_rows is None:
        return table.shape[0]
    if not 0 <= shard_rows <= table.shape[0]:
        raise ValueError(f"isp_gather: shard_rows={shard_rows} must lie in "
                         f"[0, {table.shape[0]}], the table's rows")
    return int(shard_rows)


def isp_gather(table, indices, shard_offset: int = 0, weights=None,
               shard_rows=None):
    """Gather rows of a (local) table shard for global ``indices``.

    Rows outside [shard_offset, shard_offset + shard_rows) contribute zeros
    — summing across shards reconstructs the full gather.  This is the
    paper's "send indexes, not data": indices travel, table rows do not.

    table: (V_local, D); indices: (...,) int; weights: optional (...,) scale,
    applied in the table's dtype; shard_rows: at most V_local (the
    default).  Returns (..., D) in the table's dtype.
    """
    v_local = shard_rows_of(table, shard_rows)
    local = indices.long() - shard_offset
    in_range = (local >= 0) & (local < v_local)
    safe = torch.clamp(local, 0, v_local - 1)
    rows = table[safe]
    rows = torch.where(in_range[..., None], rows,
                       torch.zeros((), dtype=table.dtype, device=table.device))
    if weights is not None:
        rows = rows * weights[..., None].to(rows.dtype)
    return rows


def isp_gather_pool(table, indices, segment_ids, num_segments: int,
                    shard_offset: int = 0, weights=None):
    """RecSSD-style fused gather + segment-sum pooling (on-shard
    aggregation): the masked gather of ``isp_gather`` (weights applied in
    the table's dtype), cast to fp32, summed per segment.  Ids outside the
    shard give zero rows; segment ids outside [0, num_segments) are dropped,
    as ``jax.ops.segment_sum`` drops them.

    indices/segment_ids: (N,) int.  Returns (num_segments, D) float32.
    """
    rows = isp_gather(table, indices.reshape(-1), shard_offset,
                      weights=None if weights is None
                      else weights.reshape(-1)).float()
    seg = segment_ids.reshape(-1).long()
    keep = (seg >= 0) & (seg < num_segments)
    out = torch.zeros((num_segments, table.shape[1]), dtype=torch.float32,
                      device=table.device)
    return out.index_add_(0, seg[keep], rows[keep])


def topk_similarity(queries, corpus, k: int):
    """Cosine top-k.  queries: (Q, D); corpus: (N, D).  Both are cast to
    fp32 and L2-normalised (``x / max(|x|, 1e-9)``); the similarities are
    one fp32 product (TF32 off).  On equal scores the lower corpus id comes
    first, as ``jax.lax.top_k`` orders them.  Returns (scores f32 (Q, k),
    ids int32 (Q, k)); raises for k > N."""
    n = corpus.shape[0]
    if not 0 <= k <= n:
        raise ValueError(f"topk_similarity: k={k} must lie in [0, N={n}]")
    qn = torch.nn.functional.normalize(queries.float(), dim=-1, eps=1e-9)
    cn = torch.nn.functional.normalize(corpus.float(), dim=-1, eps=1e-9)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        sims = qn @ cn.mT
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    scores, ids = torch.sort(sims, dim=-1, descending=True, stable=True)
    return scores[:, :k], ids[:, :k].to(torch.int32)
