"""The kernels' input domain, on the CPU: the head dims, groups, widths and
k that the reference's Pallas kernels take and the card's kernels now take
too.

* The shape checks of flash, paged decode and isp decode (what each CUDA
  wrapper applies before it launches) take every head dim of the domain
  phase's sweep at groups up to 71, and refuse a head dim of 257 and the
  unequal (q/k, v) pairs other than (24, 16) and (192, 128), each with a
  message that names the limit.
* The six wrappers' dtype check, which runs before the device check, takes
  float16 beside float32 and bfloat16 and refuses float64 with a
  TypeError naming the three.
* The plain flash and paged decode at dh 80, 96 and 256, and at a group of
  48, against the JAX package: its jnp oracle and (float32) its Pallas
  kernel in interpret mode, as the reference's own tests run it, under
  ``FLASH_TOL`` / ``PAGED_TOL`` of tests/test_torch_kernels.py.
* The plain top-k at (Q=7, N=1100, D=768, k=100) and (7, 1100, 37, 33)
  against the reference's ``topk_similarity(interpret=True)``.
* Top-k's split plan for every k up to K_MAX covers the corpus and stays
  within what the merge pass stages.
* The CPU engine on the domain phase's five head shapes (phi-2, phi-3-mini,
  gemma-2-9b, starcoderbase's and falcon's MQA on the reduced yi-9b) gives
  the reference engine's tokens on bridged weights, and every kernel call
  it makes passes that kernel's shape check.

The CUDA kernels run only on the card: ``chip_smoke.py --domain`` holds
them against these plain versions at the same shapes."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import reduced_config as j_reduced
from repro.kernels import flash_attention as j_flash
from repro.kernels import paged_decode as j_paged
from repro.kernels import ref as j_ref
from repro.kernels import topk_similarity as j_tk
from repro.models import model as JM
from repro.train.serve_loop import ServeEngine as JEngine
from repro_torch.bridge import params_from_jax
from repro_torch.config import reduced_config as t_reduced
from repro_torch.kernels import build as t_build
from repro_torch.kernels import flash_attention as t_flash
from repro_torch.kernels import isp_decode as t_isp
from repro_torch.kernels import isp_gather as t_ig
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import paged_decode as t_paged
from repro_torch.kernels import topk_similarity as t_tk
from repro_torch.train.serve_loop import ServeEngine as TEngine

# as in tests/test_torch_kernels.py
PAGED_TOL = {"float32": dict(atol=5e-6, rtol=5e-6),
             "bfloat16": dict(atol=2e-2, rtol=2e-2)}
FLASH_TOL = {"float32": dict(atol=3e-5, rtol=3e-5),
             "bfloat16": dict(atol=5e-2, rtol=5e-2)}
# chip_smoke.py's DOMAIN_DIMS and groups, and DOMAIN_SERVE_HEADS
DIMS = (5, 8, 37, 80, 96, 112, 160, 176, 200, 256)
GROUPS = ((8, 8), (8, 2), (48, 1), (71, 1))
SERVE_HEADS = (("phi-2", (32, 32, 80)), ("phi-3-mini", (32, 32, 96)),
               ("gemma-2-9b", (16, 8, 256)),
               ("starcoderbase-15b", (48, 1, 128)),
               ("falcon-7b", (71, 1, 64)))
D_MODEL = 64          # the engine test's width (the card's phase: 256)
ON_CPU = "CUDA kernel got a tensor on cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(x: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(x, jnp.dtype(dtype))
    t = torch.from_numpy(np.array(j, np.float32)).to(getattr(torch, dtype))
    return j, t


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _pool(rng, B, Hkv, dh, P=12, ps=8, maxp=5):
    """Random non-overlapping page tables with ragged fill levels (the
    generator of tests/test_torch_kernels.py), one slot empty."""
    kpool = rng.normal(size=(P + 1, ps, Hkv, dh))
    vpool = rng.normal(size=(P + 1, ps, Hkv, dh))
    perm = rng.permutation(P)
    tables, cur, used = [], [], 0
    for b in range(B):
        n = 0 if b == 1 else int(rng.integers(1, min(maxp, P - used) + 1))
        row = np.full(maxp, -1, np.int32)
        row[:n] = perm[used: used + n]
        used += n
        tables.append(row)
        cur.append(int(rng.integers(0, n * ps)) if n else 0)
    return kpool, vpool, np.stack(tables), np.asarray(cur, np.int32)


# -- the shape checks ---------------------------------------------------------


@pytest.mark.parametrize("H,Hkv", GROUPS)
@pytest.mark.parametrize("dh", DIMS)
def test_shape_checks_take_every_head_dim_and_group(dh, H, Hkv):
    """Each check passes; each wrapper then needs a CUDA tensor (no plain
    fallback)."""
    q, k = torch.zeros(1, 3, H, dh), torch.zeros(1, 3, Hkv, dh)
    t_flash.check_shapes(q, k, k)
    with pytest.raises(ValueError, match=ON_CPU):
        t_flash.flash_attention(q, k, k)
    qd = torch.zeros(2, H, dh)
    pool = torch.zeros(5, 16, Hkv, dh)
    pages = torch.zeros(2, 4, dtype=torch.int32)
    t_paged.check_shapes(qd, pool, pool, pages)
    with pytest.raises(ValueError, match=ON_CPU):
        t_paged.paged_decode_partial(qd, pool, pool, pages,
                                     torch.zeros(2, dtype=torch.int32))
    strip = torch.zeros(2, 32, Hkv, dh)
    t_isp.check_shapes(qd, strip, strip, torch.zeros(32, dtype=torch.int32))
    with pytest.raises(ValueError, match=ON_CPU):
        t_isp.decode_partial(qd, strip, strip,
                             torch.zeros(32, dtype=torch.int32), 0)


def test_shape_checks_refuse_past_the_domain():
    """A head dim past 256 and the unequal pairs the reference refuses
    raise, each naming the limit; the two unequal pairs taken pass."""
    q = torch.zeros(1, 3, 4, 257)
    with pytest.raises(ValueError, match="limit of 256"):
        t_flash.check_shapes(q, q, q)
    with pytest.raises(ValueError, match="limit of 256"):
        t_paged.check_shapes(torch.zeros(2, 4, 257),
                             torch.zeros(5, 16, 4, 257),
                             torch.zeros(5, 16, 4, 257),
                             torch.zeros(2, 4, dtype=torch.int32))
    with pytest.raises(ValueError, match="limit of 256"):
        t_isp.check_shapes(torch.zeros(2, 4, 257), torch.zeros(2, 8, 4, 257),
                           torch.zeros(2, 8, 4, 257),
                           torch.zeros(8, dtype=torch.int32))
    for dqk, dv in ((128, 192), (192, 64), (240, 128), (64, 128), (96, 80),
                    (16, 24)):
        with pytest.raises(ValueError, match=r"\(24, 16\), \(192, 128\)"):
            t_flash.check_shapes(torch.zeros(1, 3, 4, dqk),
                                 torch.zeros(1, 3, 4, dqk),
                                 torch.zeros(1, 3, 4, dv))
    for dqk, dv in t_flash.UNEQUAL_DIMS:
        t_flash.check_shapes(torch.zeros(1, 3, 4, dqk),
                             torch.zeros(1, 3, 4, dqk),
                             torch.zeros(1, 3, 4, dv))
    assert t_paged.staged_width(80) == 128 and t_paged.staged_width(37) == 64
    assert t_paged.staged_width(240) == 240


def test_wrappers_take_float16_and_refuse_float64():
    """Each CUDA wrapper's dtype check (which runs before it needs the
    card) passes float16, so a CPU tensor then meets the device check;
    float64 raises TypeError naming the three dtypes."""
    for dt, err, match in ((torch.float16, ValueError, ON_CPU),
                           (torch.float64, TypeError,
                            r"\['float32', 'bfloat16', 'float16'\]")):
        q, kv = torch.zeros(1, 3, 4, 16, dtype=dt), torch.zeros(
            1, 3, 2, 16, dtype=dt)
        qd, pool = torch.zeros(2, 4, 16, dtype=dt), torch.zeros(
            5, 8, 2, 16, dtype=dt)
        pages = torch.zeros(2, 3, dtype=torch.int32)
        strip = torch.zeros(2, 8, 2, 16, dtype=dt)
        table, ids = torch.zeros(10, 16, dtype=dt), torch.zeros(
            4, dtype=torch.int32)
        calls = (
            lambda: t_flash.flash_attention(q, kv, kv),
            lambda: t_paged.paged_decode_partial(qd, pool, pool, pages, 0),
            lambda: t_isp.decode_partial(qd, strip, strip,
                                         torch.zeros(8, dtype=torch.int32),
                                         0),
            lambda: t_ig.isp_gather(table, ids),
            lambda: t_ig.isp_gather_pool(table, ids, ids, 2),
            lambda: t_tk.topk_similarity(torch.zeros(2, 16), table, 3))
        for call in calls:
            with pytest.raises(err, match=match):
                call()
    assert t_build.DTYPE_CODES == {"float32": 0, "bfloat16": 1,
                                   "float16": 2}


# -- the plain versions against the JAX package -------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,Hkv,dh", [(4, 2, 80), (4, 2, 96), (4, 2, 256),
                                      (48, 1, 32)])
def test_flash_plain_matches_jax_at_new_head_dims(rng, dtype, H, Hkv, dh):
    """Causal with a window and a q_offset: the plain path (32-row chunks,
    Sq not a multiple of them) against the jnp oracle and, in float32,
    the Pallas kernel in interpret mode (one block of 64 rows a batch row
    and head)."""
    B, Sq, Skv, win, qoff = 1, 40, 56, 24, 16
    (jq, tq), (jk, tk), (jv, tv) = (
        _both(rng.normal(size=s), dtype)
        for s in ((B, Sq, H, dh), (B, Skv, Hkv, dh), (B, Skv, Hkv, dh)))
    t_flash.check_shapes(tq, tk, tv)
    got = t_flash.flash_attention_ref(tq, tk, tv, window=win, q_offset=qoff,
                                      q_chunk=32, kv_chunk=32)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    want_ref = j_ref.chunked_attention(jq, jk, jv, window=win, q_offset=qoff,
                                       q_chunk=32, kv_chunk=32)
    wants = [want_ref]
    if dtype == "float32":
        wants.append(j_flash.flash_attention(jq, jk, jv, window=win,
                                             q_offset=qoff, q_block=64,
                                             kv_block=64, interpret=True))
    for want in wants:
        np.testing.assert_allclose(_np(got), _np(want), **FLASH_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,Hkv,dh", [(4, 2, 80), (4, 2, 96), (4, 2, 256),
                                      (48, 1, 32)])
def test_paged_plain_matches_jax_at_new_head_dims(rng, dtype, H, Hkv, dh):
    """Ragged slots (one empty), with and without a window: the plain path
    against the jnp oracle, and in float32 with the window against the
    Pallas kernel in interpret mode."""
    B = 3
    kpool, vpool, pages, cur = _pool(rng, B, Hkv, dh, P=8, maxp=3)
    (jq, tq), (jk, tk), (jv, tv) = (
        _both(a, dtype) for a in (rng.normal(size=(B, H, dh)), kpool, vpool))
    t_paged.check_shapes(tq, tk, tv, torch.from_numpy(pages))
    for window in (None, 11):
        got = t_paged.paged_decode_partial_ref(
            tq, tk, tv, torch.from_numpy(pages), torch.from_numpy(cur),
            window=window)
        wants = [j_paged.paged_decode_partial_ref(
            jq, jk, jv, jnp.asarray(pages), jnp.asarray(cur), window=window)]
        if window is not None and dtype == "float32":
            wants.append(j_paged.paged_decode_partial(
                jq, jk, jv, jnp.asarray(pages), jnp.asarray(cur),
                window=window, interpret=True))
        for want in wants:
            for a, b in zip(got, want):
                assert a.dtype == torch.float32
                np.testing.assert_allclose(_np(a), _np(b),
                                           **PAGED_TOL[dtype])
        assert float(got[1][1].abs().max()) == 0.0     # the empty slot


# (Q, N, D, k, near-tie places): the counts read on this seed's draws with
# one torch thread, 8 of 700 at D 768 and none at D 37
@pytest.mark.parametrize("Q,N,D,k,n_near", [(7, 1100, 768, 100, 8),
                                            (7, 1100, 37, 33, 0)])
def test_topk_plain_matches_pallas_at_wide_d_and_large_k(rng, Q, N, D, k,
                                                        n_near):
    """Scores within 1e-5; ids equal but where the plain version's two
    neighbouring scores (or the k-th and (k+1)-th) lie within 1e-6, and
    exactly ``n_near`` such places."""
    q = rng.normal(size=(Q, D)).astype(np.float32)
    c = rng.normal(size=(N, D)).astype(np.float32)
    gs, gi = (x.numpy() for x in t_ops.topk_similarity(
        torch.from_numpy(q), torch.from_numpy(c), k))
    assert gs.shape == gi.shape == (Q, k)
    ws, wi = (np.asarray(x) for x in j_tk.topk_similarity(
        jnp.asarray(q), jnp.asarray(c), k, interpret=True))
    np.testing.assert_allclose(gs, ws, atol=1e-5, rtol=0)
    nxt, _ = t_tk.topk_similarity_ref(torch.from_numpy(q),
                                      torch.from_numpy(c), k + 1)
    s = np.concatenate([ws, nxt.numpy()[:, k:]], axis=1)
    gap = np.abs(np.diff(s, axis=1))
    lo = np.concatenate([np.full((Q, 1), np.inf), gap[:, :-1]], axis=1)
    near = (gap < 1e-6) | (lo < 1e-6)
    differ = gi != wi
    assert not (differ & ~near).any()
    assert int(near.sum()) == n_near, int(near.sum())


@pytest.mark.parametrize("nq,n,sms", [(50, 58000, 132), (256, 58000, 132),
                                      (7, 1100, 132), (70, 2100, 132),
                                      (1, 1024, 8), (700, 300_000, 132)])
def test_topk_split_plan_covers_n_within_the_merge_budget(nq, n, sms):
    """For every k up to min(N, K_MAX): the splits cover [0, N) with none
    empty, rows a split are whole tiles, and the merge pass's staging
    holds splits * k entries (k <= 32: 6144 in 48 KB; above: 128 lists at
    most, 8 bytes an entry within a block's shared memory)."""
    for k in range(1, min(n, t_tk.K_MAX) + 1):
        splits, rows = t_tk._splits(nq, n, k, sms)
        assert rows % t_tk._CT == 0 and rows > 0
        assert splits * rows >= n > (splits - 1) * rows
        if k <= t_tk._K_LANES:
            assert splits * k <= t_tk._MERGE_ENTRIES
        else:
            assert splits <= t_tk._SPLITS_BIG
            assert splits * k * 8 <= t_paged.SMEM_MAX


# -- the engine on the domain phase's head shapes ------------------------------


@pytest.mark.parametrize("tag,heads", SERVE_HEADS,
                         ids=[t for t, _ in SERVE_HEADS])
def test_engine_serves_domain_heads_as_the_reference(monkeypatch, tag,
                                                     heads):
    """The reduced yi-9b with the heads replaced, float32, on bridged
    weights: the port's CPU engine (paged, k_block 1) gives the reference
    engine's tokens, and each flash and paged-decode call passes its
    kernel's shape check."""
    H, Hkv, dh = heads
    kw = dict(num_heads=H, num_kv_heads=Hkv, head_dim=dh, d_model=D_MODEL,
              dtype="float32")
    jcfg = dataclasses.replace(j_reduced("yi-9b"), **kw)
    tcfg = dataclasses.replace(t_reduced("yi-9b"), **kw)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    model = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    seen = {"flash": 0, "paged": 0}

    def checked(name, check, key):
        orig = getattr(t_ops, name)

        def run(*args, **kw):
            check(*args[:4])
            seen[key] += 1
            return orig(*args, **kw)
        monkeypatch.setattr(t_ops, name, run)
    checked("flash_attention", lambda q, k, v, *_: t_flash.check_shapes(
        q, k, v), "flash")
    checked("paged_decode_partial", t_paged.check_shapes, "paged")
    common = dict(max_len=32, num_slots=2, page_size=8, k_block=1)
    je = JEngine(jcfg, jp, **common)
    te = TEngine(tcfg, model, device="cpu", **common)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, tcfg.vocab_size, n).tolist() for n in (5, 7)]
    for eng in (je, te):
        for p in prompts:
            eng.submit(p, max_new=6)
    jres, tres = je.run_until_complete(), te.run_until_complete()
    assert [r.status for r in tres] == ["ok", "ok"]
    assert [r.tokens for r in tres] == [r.tokens for r in jres]
    assert seen["flash"] > 0 and seen["paged"] > 0, seen
