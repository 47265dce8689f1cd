"""Recurrent sequence mixers: Mamba, mLSTM, sLSTM (port of
``repro/models/ssm.py``: train, prefill and decode).

Each takes (module, x, cfg, cache, mode) and returns (y, new_cache) with a
constant-size recurrent state — the "resident state" analogue of the
paper's in-storage data: at decode time the state never leaves the card.
The reference has no Pallas kernel here, so neither does the port: these
are plain tensor code on every device, and no launch is counted.

Under a sharding recipe the leaves are stored as ``sharding.param_specs``
cuts them (TP on the channel and projection dims, FSDP on the others), and
Mamba's ``conv`` / ``ssm`` caches hold this rank's channels, as the
reference's ``_cache_leaf_spec`` lays them out (the xLSTM states are
whole).  The mixers take the second of the two routes a port could take:
each leaf is gathered whole at use, every rank runs the whole recurrence
on its batch rows, and a rank keeps only its channels of the Mamba state
(gathered back whole at the next decode step).  Channel-parallel compute
would not stay per channel: Mamba's ``w_x`` contracts all d_in channels
into dt, B and C, ``w_in``'s split puts x on one rank and its gate z on
the other, mLSTM's output norm spans d_in and sLSTM's recurrence mixes
every gate of a head; each would need its own collective inside the
recurrence, where these mixers are small.  The output is whole on every
rank (no partial sum).

Numerics:
  * Mamba: selective scan, chunk by chunk with the state carried across
    chunks, as the reference's ``lax.scan``; inside a chunk a doubling
    (Hillis–Steele) scan takes the place of ``jax.lax.associative_scan``,
    which PyTorch lacks.  The sums run in another order than XLA's, so the
    tests hold it to an fp32 tolerance.  The (B, L, d_in, N) products live
    one chunk at a time.
  * mLSTM: the chunkwise-parallel form of the stabilised matrix-memory
    recurrence, equal up to rounding to the per-step form
    (``mlstm_step_ref``, which decode runs).
  * sLSTM: sequential (the gates feed back the previous h): a loop over
    the prompt's steps, in chunks of ``chunk_size`` rows.

In train mode with grad enabled each chunk runs under a non-reentrant
``torch.utils.checkpoint``, as the reference's ``jax.checkpoint`` on its
chunk bodies: the backward keeps only each chunk's inputs and carry, and
recomputes the chunk's intermediates (Mamba's (B, L, d_in, N) scan
levels, mLSTM's (B, L, L, nh) weights, sLSTM's steps).  This nests
inside the per-block remat.  The chunks are taken with one ``split`` (and
sLSTM's rows with one ``unbind`` a chunk), so the backward writes each
input gradient once, not once a chunk or a row.  Values are the same
with or without the checkpoint.

Parameters keep the reference's layouts and dtypes: Mamba's ``dt_bias``,
``a_log`` and ``d_skip``, mLSTM's ``if_bias`` and sLSTM's ``bias`` are
float32 in any model dtype.  The recurrent caches are float32 (Mamba's
``conv`` window is in the model dtype).  Decode updates a given cache in
place; prefill returns new state; train is prefill's math from a zero
state, differentiable (no in-place update of a tensor autograd keeps), and
returns no state (None), as the reference's guards on ``mode in
("decode", "prefill")`` do.  A padded prefill would integrate pad tokens
into the state, so the serve engine gives recurrent stacks exact-length
buckets.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import sharding as sh
from repro_torch.config import ModelConfig
from repro_torch.models.layers import dense_init, empty_param, rms_norm

_FP32_LEAVES = ("dt_bias", "a_log", "d_skip", "if_bias", "bias")


class _Params(nn.Module):
    """Parameters named and shaped by ``shapes``; the reference's float32
    leaves stay float32 whatever ``dtype`` is."""

    def __init__(self, shapes: Dict[str, tuple], dtype, device):
        super().__init__()
        for name, shape in shapes.items():
            dt = torch.float32 if name in _FP32_LEAVES else dtype
            setattr(self, name, empty_param(shape, dt, device))


def _mm(x, w):
    """(..., K) @ (K, ...) -> (..., ...): a product over x's last axis and
    w's first, whatever w's trailing shape."""
    out = x.reshape(-1, x.shape[-1]) @ w.reshape(w.shape[0], -1)
    return out.reshape(tuple(x.shape[:-1]) + tuple(w.shape[1:]))


def _chunked(mode: str, fn, *args):
    """``fn(*args)``: one chunk of a mixer.  In train mode with grad on, it
    runs under a non-reentrant checkpoint (recomputed in the backward,
    only ``args`` kept), as the reference checkpoints its chunk bodies.
    Each tensor is an argument of its own: the checkpoint would hold a
    tuple's tensors outside the saved-tensor hooks, so past an enclosing
    checkpoint (the block remat), for the whole forward."""
    if mode == "train" and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


def _write_state(cache, new: Dict[str, torch.Tensor]):
    """Decode: copy the new state into the given cache's tensors (views of
    the engine's stacked caches) and return that cache."""
    for name, t in new.items():
        cache[name].copy_(t)
    return cache


class _Whole:
    """A mixer's leaves at use, each gathered whole over the mesh
    (``sharding.leaf``)."""

    def __init__(self, p, plan):
        self._p, self._plan = p, plan

    def __getattr__(self, name):
        return sh.leaf(self._p, name, self._plan, full=True)


def _whole(p, plan):
    return p if plan is None or plan.mesh is None else _Whole(p, plan)


def _channels(plan, t, dim: int, d_in: int, gather: bool):
    """Mamba state leaf ``t`` between its whole channels (``gather``: this
    rank's block all-gathered over the model axis) and this rank's block
    (the model axis splits the d_in channels where it divides them)."""
    lo, hi = sh.tp_split(plan, d_in)
    if hi - lo == d_in:
        return t
    if gather:
        return sh.all_gather(plan, t, plan.model_axis, dim)
    return t.narrow(dim, lo, hi - lo)


# ---------------------------------------------------------------------------
# Mamba selective SSM
# ---------------------------------------------------------------------------


def _mamba_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    s = cfg.ssm
    d = cfg.d_model
    d_in = s.expand * d
    dt_rank = s.dt_rank or -(-d // 16)
    return {"w_in": (d, 2 * d_in), "conv_w": (s.conv_width, d_in),
            "conv_b": (d_in,), "w_x": (d_in, dt_rank + 2 * s.state_dim),
            "w_dt": (dt_rank, d_in), "dt_bias": (d_in,),
            "a_log": (d_in, s.state_dim), "d_skip": (d_in,),
            "w_out": (d_in, d)}


class Mamba(_Params):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__(_mamba_shapes(cfg), dtype, device)


def mamba_params(cfg: ModelConfig, generator: torch.Generator, dtype,
                 device) -> Dict[str, torch.Tensor]:
    """Fresh Mamba weights with the reference's distribution: a_log =
    log(1..N) per channel, dt_bias 0 and d_skip 1 (float32), the conv at
    std conv_width ** -0.5 and w_dt at dt_rank ** -0.5."""
    s = cfg.ssm
    sh = _mamba_shapes(cfg)
    kw = dict(generator=generator, dtype=dtype, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    d_in, n = sh["a_log"]
    return {
        "w_in": dense_init(sh["w_in"], **kw),
        "conv_w": dense_init(sh["conv_w"], scale=s.conv_width ** -0.5, **kw),
        "conv_b": torch.zeros(sh["conv_b"], dtype=dtype, device=device),
        "w_x": dense_init(sh["w_x"], **kw),
        "w_dt": dense_init(sh["w_dt"], scale=sh["w_dt"][0] ** -0.5, **kw),
        "dt_bias": torch.zeros((d_in,), **f32),
        "a_log": torch.log(torch.arange(1, n + 1, **f32)).expand(
            d_in, n).clone(),
        "d_skip": torch.ones((d_in,), **f32),
        "w_out": dense_init(sh["w_out"], **kw),
    }


def doubling_scan(a, b, inplace: bool = True):
    """Inclusive scan of h_t = a_t * h_{t-1} + b_t along axis 1 from h = 0,
    by doubling: log2 L passes of b[t] += a[t] * b[t - o]; a[t] *= a[t - o]
    for o = 1, 2, 4, ...  Returns (A, H): A_t the product a_0 .. a_t and
    H_t the state at t; the state from h0 is A_t * h0 + H_t.  ``a`` and
    ``b`` are consumed (updated in place) unless ``inplace`` is false, as
    training needs: a chunk's backward reads the tensors of every pass
    (recomputed under the chunk's checkpoint, ``_chunked``)."""
    L = a.shape[1]
    o = 1
    while o < L:
        if inplace:
            b[:, o:] += a[:, o:] * b[:, :-o]
            a[:, o:] *= a[:, :-o].clone()
        else:
            b = torch.cat([b[:, :o], b[:, o:] + a[:, o:] * b[:, :-o]], 1)
            a = torch.cat([a[:, :o], a[:, o:] * a[:, :-o]], 1)
        o *= 2
    return a, b


def _mamba_chunk(dt, xdt, bmat, cmat, a, h0, inplace: bool):
    """One chunk of the selective scan from state h0 (B, d_in, N): dt, xdt
    (B, l, d_in), bmat, cmat (B, l, N) float32, a (d_in, N).  Returns (y
    (B, l, d_in), the state after the chunk's last row)."""
    da = torch.exp(dt[..., None] * a)                         # (B, l, d_in, N)
    dbx = xdt[..., None] * bmat[:, :, None, :]
    acc, h_all = doubling_scan(da, dbx, inplace=inplace)
    if inplace:
        h_all += acc * h0[:, None]
    else:
        h_all = h_all + acc * h0[:, None]
    del acc, da, dbx
    y = torch.einsum("bsen,bsn->bse", h_all, cmat)
    return y, h_all[:, -1].clone()


def mamba_apply(p: Mamba, x, cfg: ModelConfig, cache: Optional[Dict] = None,
                mode: str = "prefill", plan=None):
    """x: (B, S, D).  Cache: {"conv": (B, W-1, d_in) model dtype, "ssm":
    (B, d_in, N) float32}, this rank's channels under a ``plan``.  prefill
    starts from ``cache`` (zeros without one) and returns the state after
    the last row; decode (S = 1) updates ``cache`` in place; train is
    prefill out of place, with no state returned.  Returns (out (B, S, D),
    new_cache)."""
    s = cfg.ssm
    B, S, D = x.shape
    d_in = s.expand * D
    N, W = s.state_dim, s.conv_width
    p = _whole(p, plan)
    if cache is not None:
        whole = {"conv": _channels(plan, cache["conv"], 2, d_in, True),
                 "ssm": _channels(plan, cache["ssm"], 1, d_in, True)}
    else:
        whole = None

    xz = _mm(x, p.w_in)
    xs, z = xz[..., :d_in], xz[..., d_in:]
    if mode == "decode":
        if cache is None:
            raise ValueError("decode needs a cache")
        conv_in = torch.cat([whole["conv"], xs], dim=1)      # (B, W, d_in)
        new_conv = conv_in[:, 1:]
    else:
        conv_in = F.pad(xs, (0, 0, W - 1, 0))
        new_conv = conv_in[:, conv_in.shape[1] - (W - 1):]
    xc = conv_in[:, 0:S] * p.conv_w[0]
    for i in range(1, W):
        xc = xc + conv_in[:, i:i + S] * p.conv_w[i]
    xc = F.silu((xc + p.conv_b).float()).to(x.dtype)

    proj = _mm(xc, p.w_x)
    dt_rank = proj.shape[-1] - 2 * N
    dt = _mm(proj[..., :dt_rank], p.w_dt).float()
    dt = F.softplus(dt + p.dt_bias)                           # (B, S, d_in)
    bmat = proj[..., dt_rank:dt_rank + N].float()
    cmat = proj[..., dt_rank + N:].float()
    a = -torch.exp(p.a_log)                                   # (d_in, N)
    xdt = dt * xc.float()

    h0 = whole["ssm"].float() if cache is not None else x.new_zeros(
        (B, d_in, N), dtype=torch.float32)
    if mode == "decode":
        h = torch.exp(dt[:, 0, :, None] * a) * h0 \
            + xdt[:, 0, :, None] * bmat[:, 0, None, :]
        y = torch.einsum("ben,bn->be", h, cmat[:, 0])[:, None]
        h_last = h
    else:
        L = min(s.chunk_size, S)
        ys = []
        h_last = h0
        for dt_c, xdt_c, b_c, c_c in zip(
                *(t.split(L, dim=1) for t in (dt, xdt, bmat, cmat))):
            y_c, h_last = _chunked(mode, _mamba_chunk, dt_c, xdt_c, b_c, c_c,
                                   a, h_last, mode != "train")
            ys.append(y_c)
        y = torch.cat(ys, dim=1)

    y = y + p.d_skip * xc.float()
    y = y * F.silu(z.float())
    out = _mm(y.to(x.dtype), p.w_out)
    if mode == "train":
        return out, None
    new = {"conv": _channels(plan, new_conv.to(x.dtype), 2, d_in, False),
           "ssm": _channels(plan, h_last.float(), 1, d_in, False)}
    if mode == "decode":
        return out, _write_state(cache, new)
    return out, new


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype, device,
                     plan=None):
    s = cfg.ssm
    lo, hi = sh.tp_split(plan, s.expand * cfg.d_model)
    d_in = hi - lo
    return {"conv": torch.zeros((batch, s.conv_width - 1, d_in), dtype=dtype,
                                device=device),
            "ssm": torch.zeros((batch, d_in, s.state_dim),
                               dtype=torch.float32, device=device)}


# ---------------------------------------------------------------------------
# mLSTM (matrix memory), chunkwise parallel
# ---------------------------------------------------------------------------


def _mlstm_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    s = cfg.ssm
    d = cfg.d_model
    d_in = s.expand * d
    nh = s.num_heads
    dh = d_in // nh
    return {"w_up": (d, 2 * d_in), "wq": (d_in, nh, dh),
            "wk": (d_in, nh, dh), "wv": (d_in, nh, dh),
            "w_if": (d_in, 2 * nh), "if_bias": (2 * nh,),
            "out_norm": (d_in,), "w_down": (d_in, d)}


class MLSTM(_Params):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__(_mlstm_shapes(cfg), dtype, device)


def mlstm_params(cfg: ModelConfig, generator: torch.Generator, dtype,
                 device) -> Dict[str, torch.Tensor]:
    """Fresh mLSTM weights with the reference's distribution: the gate
    projection at std 0.01, the input gates' bias 0 and the forget gates'
    3 (float32), a zero output-norm scale."""
    sh = _mlstm_shapes(cfg)
    nh = cfg.ssm.num_heads
    kw = dict(generator=generator, dtype=dtype, device=device)
    out = {}
    for name, shape in sh.items():
        if name == "if_bias":
            out[name] = torch.cat([torch.zeros(nh), 3.0 * torch.ones(nh)]).to(
                device=device, dtype=torch.float32)
        elif name == "out_norm":
            out[name] = torch.zeros(shape, dtype=dtype, device=device)
        elif name == "w_if":
            out[name] = dense_init(shape, scale=0.01, **kw)
        else:
            out[name] = dense_init(shape, **kw)
    return out


def mlstm_step_ref(q, k, v, li, lf, state):
    """Stabilised per-step mLSTM (the decode step, and the chunkwise form's
    oracle).  q, k, v: (B, nh, dh); li, lf: (B, nh) log-space gates; state:
    (C, n, m).  Returns (h (B, nh, dh), new state)."""
    C, n, m = state
    k = k / (q.shape[-1] ** 0.5)
    m_new = torch.maximum(lf + m, li)
    i_p = torch.exp(li - m_new)
    f_p = torch.exp(lf + m - m_new)
    C = f_p[..., None, None] * C + i_p[..., None, None] * (
        k[..., :, None] * v[..., None, :])
    n = f_p[..., None] * n + i_p[..., None] * k
    num = torch.einsum("bhk,bhkv->bhv", q, C)
    den = torch.maximum(torch.einsum("bhk,bhk->bh", q, n).abs(),
                        torch.exp(-m_new))
    return num / den[..., None], (C, n, m_new)


def _mlstm_chunk(state, q, k, v, li, lf):
    """Chunkwise-parallel mLSTM over one chunk of length L.  state: (C (B,
    nh, dh, dh), n (B, nh, dh), m (B, nh)); q, k, v: (B, L, nh, dh) fp32;
    li, lf: (B, L, nh) fp32.  Returns (new state, h (B, L, nh, dh))."""
    C, n, m = state
    L = q.shape[1]
    k = k / (q.shape[-1] ** 0.5)
    b = torch.cumsum(lf, dim=1)                              # (B, L, nh)
    g = b + m[:, None]                                       # decay to t
    # intra-chunk log weights D[t, s] = b_t - b_s + li_s (s <= t)
    dmat = b[:, :, None] - b[:, None, :] + li[:, None, :, :]   # (B,L,L,nh)
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=q.device))
    dmat = torch.where(tri[None, :, :, None], dmat, -1e30)
    m_t = torch.maximum(g, dmat.amax(dim=2))                 # (B, L, nh)
    s_qk = torch.einsum("blhd,bshd->blsh", q, k)
    sw = s_qk * torch.exp(dmat - m_t[:, :, None])
    num = torch.einsum("blsh,bshv->blhv", sw, v)
    den = sw.sum(dim=2)
    w_inter = torch.exp(g - m_t)
    num = num + w_inter[..., None] * torch.einsum("blhk,bhkv->blhv", q, C)
    den = den + w_inter * torch.einsum("blhk,bhk->blh", q, n)
    h = num / torch.maximum(den.abs(), torch.exp(-m_t))[..., None]
    b_l = b[:, -1]                                           # (B, nh)
    m_new = torch.maximum(b_l + m, (b_l[:, None] - b + li).amax(dim=1))
    w_st = torch.exp(b_l[:, None] - b + li - m_new[:, None])   # (B, L, nh)
    decay = torch.exp(b_l + m - m_new)
    C_new = decay[..., None, None] * C + torch.einsum(
        "blh,blhk,blhv->bhkv", w_st, k, v)
    n_new = decay[..., None] * n + torch.einsum("blh,blhk->bhk", w_st, k)
    return (C_new, n_new, m_new), h


def _mlstm_chunk_flat(C, n, m, q, k, v, li, lf):
    """``_mlstm_chunk`` with the state's tensors as arguments
    (``_chunked``)."""
    return _mlstm_chunk((C, n, m), q, k, v, li, lf)


def mlstm_apply(p: MLSTM, x, cfg: ModelConfig, cache: Optional[Dict] = None,
                mode: str = "prefill", plan=None):
    """xLSTM mLSTM block core (pre-up-projection).  Cache: {"C" (B, nh, dh,
    dh), "n" (B, nh, dh), "m" (B, nh)}, all float32.  prefill pads the
    prompt to whole chunks with input gates of -1e30 (the pads are no-ops
    on the state); decode runs the per-step form and updates ``cache`` in
    place."""
    s = cfg.ssm
    B, S, D = x.shape
    d_in = s.expand * D
    nh = s.num_heads
    dh = d_in // nh
    p = _whole(p, plan)

    up = _mm(x, p.w_up)
    xin, gate = up[..., :d_in], up[..., d_in:]
    q = _mm(xin, p.wq).float()
    k = _mm(xin, p.wk).float()
    v = _mm(xin, p.wv).float()
    gif = _mm(xin, p.w_if).float() + p.if_bias
    li, lf = gif[..., :nh], F.logsigmoid(gif[..., nh:])       # (B, S, nh)

    if cache is not None:
        state = (cache["C"].float(), cache["n"].float(), cache["m"].float())
    else:
        state = (x.new_zeros((B, nh, dh, dh), dtype=torch.float32),
                 x.new_zeros((B, nh, dh), dtype=torch.float32),
                 x.new_zeros((B, nh), dtype=torch.float32))

    if mode == "decode":
        h, state = mlstm_step_ref(q[:, 0], k[:, 0], v[:, 0], li[:, 0],
                                  lf[:, 0], state)
        h = h[:, None]
    else:
        L = min(s.chunk_size, S)
        pad = (-S) % L
        if pad:
            padt = lambda t, val=0.0: F.pad(   # noqa: E731
                t, (0, 0) * (t.dim() - 2) + (0, pad), value=val)
            q, k, v, lf = padt(q), padt(k), padt(v), padt(lf)
            li = padt(li, -1e30)
        hs = []
        for chunk in zip(*(t.split(L, dim=1) for t in (q, k, v, li, lf))):
            state, h = _chunked(mode, _mlstm_chunk_flat, *state, *chunk)
            hs.append(h)
        h = torch.cat(hs, dim=1)[:, :S]

    h = rms_norm(h.reshape(B, -1, d_in).to(x.dtype), p.out_norm,
                 cfg.norm_eps)
    h = h * F.silu(gate.float()).to(x.dtype)
    out = _mm(h, p.w_down)
    if mode == "train":
        return out, None
    new = dict(zip(("C", "n", "m"), state))
    if mode == "decode":
        return out, _write_state(cache, new)
    return out, new


def init_mlstm_cache(cfg: ModelConfig, batch: int, device):
    s = cfg.ssm
    nh = s.num_heads
    dh = s.expand * cfg.d_model // nh
    kw = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, nh, dh, dh), **kw),
            "n": torch.zeros((batch, nh, dh), **kw),
            "m": torch.zeros((batch, nh), **kw)}


# ---------------------------------------------------------------------------
# sLSTM (scalar memory, recurrent gate feedback)
# ---------------------------------------------------------------------------


def _slstm_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    s = cfg.ssm
    d = cfg.d_model
    nh = s.num_heads
    dh = d // nh
    f = int(d * s.slstm_proj_factor)
    return {"w_x": (d, 4 * d), "r_h": (nh, dh, 4 * dh), "bias": (4 * d,),
            "out_norm": (d,), "w_pf1": (d, f), "w_pf2": (f, d)}


class SLSTM(_Params):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__(_slstm_shapes(cfg), dtype, device)


def slstm_params(cfg: ModelConfig, generator: torch.Generator, dtype,
                 device) -> Dict[str, torch.Tensor]:
    """Fresh sLSTM weights with the reference's distribution: the
    block-diagonal recurrent weights at std dh ** -0.5, the forget gates'
    bias 3 and the others' 0 (float32), a zero output-norm scale."""
    sh = _slstm_shapes(cfg)
    d = cfg.d_model
    kw = dict(generator=generator, dtype=dtype, device=device)
    return {
        "w_x": dense_init(sh["w_x"], **kw),
        "r_h": dense_init(sh["r_h"], scale=sh["r_h"][1] ** -0.5, **kw),
        "bias": torch.cat([torch.zeros(2 * d), 3.0 * torch.ones(d),
                           torch.zeros(d)]).to(device=device,
                                               dtype=torch.float32),
        "out_norm": torch.zeros(sh["out_norm"], dtype=dtype, device=device),
        "w_pf1": dense_init(sh["w_pf1"], **kw),
        "w_pf2": dense_init(sh["w_pf2"], **kw),
    }


def _slstm_step(r_h, nh: int, dh: int, carry, x_t):
    """One sLSTM step.  carry: (c, n, m, h), each (B, nh, dh) fp32; x_t:
    (B, 4d) fp32 input-gate pre-activations; r_h (nh, dh, 4dh) fp32."""
    c, n, m, h = carry
    rec = torch.einsum("bhk,hkf->bhf", h, r_h)
    gates = x_t.reshape(x_t.shape[0], nh, 4 * dh) + rec
    z_t, i_t, f_t, o_t = gates.split(dh, dim=-1)
    lf = F.logsigmoid(f_t)
    m_new = torch.maximum(lf + m, i_t)
    i_p = torch.exp(i_t - m_new)
    f_p = torch.exp(lf + m - m_new)
    c_new = f_p * c + i_p * torch.tanh(z_t)
    n_new = f_p * n + i_p
    h_new = torch.sigmoid(o_t) * c_new / torch.clamp(n_new, min=1e-6)
    return c_new, n_new, m_new, h_new


def _slstm_rows(r_h, nh: int, dh: int, xg, *carry):
    """sLSTM steps over one chunk's rows xg (B, l, 4d) fp32 from
    ``carry`` (c, n, m, h): (the carry after the last row, h (B, l, nh,
    dh))."""
    hs = []
    for x_t in xg.unbind(1):
        carry = _slstm_step(r_h, nh, dh, carry, x_t)
        hs.append(carry[3])
    return carry, torch.stack(hs, dim=1)


def slstm_apply(p: SLSTM, x, cfg: ModelConfig, cache: Optional[Dict] = None,
                mode: str = "prefill", plan=None):
    """sLSTM core and its gelu up-projection.  Cache: {"c", "n", "m", "h"},
    each (B, nh, dh) float32.  prefill steps through the S rows one by one,
    in chunks of ``chunk_size`` rows as the reference scans them (its
    padded steps keep the carry, so stopping at S is the same); decode
    takes one step and updates ``cache`` in place."""
    s = cfg.ssm
    B, S, D = x.shape
    nh = s.num_heads
    dh = D // nh
    p = _whole(p, plan)
    xg = _mm(x, p.w_x).float() + p.bias                     # (B, S, 4d)
    if cache is not None:
        carry = (cache["c"], cache["n"], cache["m"], cache["h"])
    else:
        zero = x.new_zeros((B, nh, dh), dtype=torch.float32)
        carry = (zero, zero, zero, zero)
    r_h = p.r_h.float()
    hs = []
    for xg_c in xg.split(min(s.chunk_size, S), dim=1):
        carry, h = _chunked(mode, _slstm_rows, r_h, nh, dh, xg_c, *carry)
        hs.append(h)
    h_all = torch.cat(hs, dim=1).reshape(B, S, D)
    h_all = rms_norm(h_all.to(x.dtype), p.out_norm, cfg.norm_eps)
    y = _mm(h_all, p.w_pf1)
    y = F.gelu(y.float(), approximate="tanh").to(x.dtype)
    out = _mm(y, p.w_pf2)
    if mode == "train":
        return out, None
    new = dict(zip(("c", "n", "m", "h"), carry))
    if mode == "decode":
        return out, _write_state(cache, new)
    return out, new


def init_slstm_cache(cfg: ModelConfig, batch: int, device):
    nh = cfg.ssm.num_heads
    dh = cfg.d_model // nh
    return {name: torch.zeros((batch, nh, dh), dtype=torch.float32,
                              device=device) for name in ("c", "n", "m", "h")}
