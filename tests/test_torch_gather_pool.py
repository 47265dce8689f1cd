"""The port's fused gather + segment sum (repro_torch.kernels.isp_gather
.isp_gather_pool and ops.isp_gather_pool) against the JAX reference on the
same numpy inputs: the jnp oracle ``ref.isp_gather_pool`` and the Pallas
kernel in interpret mode at test_kernels.py::test_pallas_gather_pool's
sizes (a 64 x 40 table, 33 ids in -10..120, 7 segments, offset 16,
idx_block=8, d_block=16); plus the sentiment app's query batch
(benchmarks/apps.py) at a reduced size and the sharded pool of
examples/isp_embedding_demo.py.

Tolerances: the plain version takes the oracle's products (weights applied
in the table's dtype, then fp32) and sums them per segment in another
order, so the two agree within fp32 rounding of sums of a few terms:
atol 1e-5.  The Pallas kernel scales in fp32; with weights in bfloat16
each of its terms may differ from the oracle's by one bf16 ulp (2**-7
relative), so it is held within 2**-7 of the pooled absolute terms.  The
shard sum matches the dense pool within the demo's atol of 1e-4.  The CUDA
kernel runs only on the card, where ``chip_smoke.py`` holds it against
this plain path."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import apps
from repro.kernels import isp_gather as j_ig
from repro.kernels import ref as j_ref
from repro_torch.kernels import build as t_build
from repro_torch.kernels import isp_gather as t_ig
from repro_torch.kernels import ops as t_ops

ATOL = 1e-5
BF16_ULP = 2.0 ** -7


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("bad_segments", [False, True])
def test_plain_pool_matches_reference(rng, dtype, weighted, bad_segments):
    """Ids below, inside and above the shard; with ``bad_segments`` the
    segment ids also take -1 and num_segments, which are dropped."""
    table = np.array(jnp.asarray(rng.normal(size=(64, 40)),
                                 jnp.dtype(dtype)), np.float32)
    idx = rng.integers(-10, 120, (33,)).astype(np.int32)
    seg = rng.integers(0, 7, (33,)).astype(np.int32)
    if bad_segments:
        seg[::5] = -1
        seg[2::6] = 7
    w = rng.normal(size=(33,)).astype(np.float32) if weighted else None
    jt = jnp.asarray(table, jnp.dtype(dtype))
    tt = torch.from_numpy(table).to(getattr(torch, dtype))
    jw = None if w is None else jnp.asarray(w)
    tw = None if w is None else torch.from_numpy(w)
    got = t_ops.isp_gather_pool(tt, torch.from_numpy(idx),
                                torch.from_numpy(seg), 7, shard_offset=16,
                                weights=tw)
    assert got.dtype == torch.float32 and got.shape == (7, 40)
    want = j_ref.isp_gather_pool(jt, jnp.asarray(idx), jnp.asarray(seg), 7,
                                 shard_offset=16, weights=jw)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL, rtol=0)
    pallas = j_ig.isp_gather_pool(jt, jnp.asarray(idx), jnp.asarray(seg), 7,
                                  shard_offset=16, weights=jw, idx_block=8,
                                  d_block=16, interpret=True)
    slack = 0.0
    if weighted and dtype == "bfloat16":
        slack = BF16_ULP * _np(t_ops.isp_gather_pool(
            tt.abs(), torch.from_numpy(idx), torch.from_numpy(seg), 7,
            shard_offset=16, weights=tw.abs()))
    assert (np.abs(_np(got) - _np(pallas)) <= ATOL + slack).all()
    kept = (idx >= 16) & (idx < 80) & (seg >= 0) & (seg < 7)
    assert kept.sum() > 3 and (~kept).sum() > 3
    empty = np.setdiff1d(np.arange(7), seg[kept])
    assert not _np(got)[empty].any(), "a segment with no id must stay zero"


def test_shards_sum_to_the_dense_pool(rng):
    """examples/isp_embedding_demo.py's layout, reduced: a 1024 x 32 table
    in 16 shards of 64 rows, 512 ids in 32 segments, with -1 ids and
    segment ids -1 and 32 dropped; the shards' pools sum to the dense
    pool."""
    V, D, TP, n, S = 1024, 32, 16, 512, 32
    table = torch.from_numpy(rng.normal(size=(V, D)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, V, (n,)).astype(np.int32))
    seg = torch.from_numpy(rng.integers(0, S, (n,)).astype(np.int32))
    idx[::17] = -1
    seg[1::13] = -1
    seg[2::11] = S
    vloc = V // TP
    got = sum(t_ops.isp_gather_pool(table[i * vloc:(i + 1) * vloc], idx, seg,
                                    S, shard_offset=i * vloc)
              for i in range(TP))
    keep = (idx >= 0) & (seg >= 0) & (seg < S)
    dense = torch.zeros(S, D).index_add_(0, seg[keep].long(),
                                         table[idx[keep].long()])
    torch.testing.assert_close(got, dense, atol=1e-4, rtol=0)


def test_sentiment_query_batch():
    """apps.sentiment_query_batch at a reduced size (64 reviews of 12 ids
    over a 512 x 64 table): the port's pool, head and argmax give the app's
    predictions wherever the two logits differ by more than 1e-4."""
    n, vocab, d = 64, 512, 64
    want = apps.sentiment_query_batch(np.random.default_rng(7), n_queries=n,
                                      vocab=vocab, d=d)
    rng = np.random.default_rng(7)                  # the app's inputs again
    idx = rng.integers(0, vocab, (n * 12,)).astype(np.int32)
    seg = np.repeat(np.arange(n), 12).astype(np.int32)
    table = rng.normal(size=(vocab, d)).astype(np.float32)
    w = rng.normal(size=(d, 2)).astype(np.float32)
    pooled = t_ops.isp_gather_pool(torch.from_numpy(table),
                                   torch.from_numpy(idx),
                                   torch.from_numpy(seg), n)
    logits = pooled @ torch.from_numpy(w)
    preds = logits.argmax(-1).numpy()
    clear = (logits[:, 0] - logits[:, 1]).abs().numpy() > 1e-4
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(preds[clear], want[clear])
    j_pool = j_ref.isp_gather_pool(jnp.asarray(table), jnp.asarray(idx),
                                   jnp.asarray(seg), n)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(j_pool), atol=ATOL,
                               rtol=0)


def test_ops_takes_the_plain_version_on_cpu(rng):
    """A CPU tensor takes the plain version and counts no launch; the
    kernel wrapper refuses a CPU tensor rather than fall back."""
    table = torch.from_numpy(rng.normal(size=(32, 8)).astype(np.float32))
    ids = torch.tensor([0, 5, 40, -1, 7], dtype=torch.int32)
    seg = torch.tensor([0, 1, 1, 0, 2], dtype=torch.int32)
    t_ops.reset_launch_counts()
    got = t_ops.isp_gather_pool(table, ids, seg, 3)
    assert torch.equal(got, t_ig.isp_gather_pool_ref(table, ids, seg, 3))
    assert torch.equal(got[1], table[5])
    assert t_ops.launch_counts()["isp_gather_pool"] == 0
    assert "isp_gather_pool" in t_build.KERNELS
    with pytest.raises(ValueError, match="CUDA kernel got a tensor on cpu"):
        t_ig.isp_gather_pool(table, ids, seg, 3)
