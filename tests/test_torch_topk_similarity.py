"""The port's cosine top-k (repro_torch.kernels.topk_similarity and
ops.topk_similarity) against the JAX reference on the same numpy inputs:
the jnp oracle ``ref.topk_similarity`` (``jax.lax.top_k`` over one fp32
product) and the Pallas kernel in interpret mode at
test_kernels.py::test_pallas_topk's sizes and blocks; plus the recommender
app's query batch (benchmarks/apps.py) at a reduced size, and the paper's
Table I energy model (core/energy.py) against ``repro.core.energy``.

Tolerances: scores within atol 1e-5.  Each score is a dot product of two
unit vectors (|s| <= 1) summed in fp32 in another order by XLA, the Pallas
kernel and PyTorch, and the norms themselves are summed in another order;
that moves a score by a few fp32 ulps of 1, far below 1e-5.  Ids must be
equal wherever a score is separated from its neighbours in the list, and
from the (k+1)-th score, by more than that tolerance; where scores are
exactly equal (the tie case, whose products and norms are exact in fp32)
ids must be equal everywhere: the lower id first.  The CUDA kernel runs
only on the card, where ``chip_smoke.py`` holds it against this plain
path."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import apps
from repro.core import energy as j_energy
from repro.kernels import ref as j_ref
from repro.kernels import topk_similarity as j_tk
from repro_torch.core import energy as t_energy
from repro_torch.kernels import build as t_build
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import topk_similarity as t_tk

ATOL = 1e-5


def _separated(scores: np.ndarray, next_best: np.ndarray) -> np.ndarray:
    """(Q, k) mask of the entries whose score lies more than ATOL from its
    neighbours in the list and from the (k+1)-th score."""
    s = np.concatenate([scores, next_best[:, None]], axis=1)
    gap = np.abs(np.diff(s, axis=1))
    lo = np.concatenate([np.full((len(s), 1), np.inf), gap[:, :-1]], axis=1)
    return (gap > ATOL) & (lo > ATOL)


def _hold(got, want_s, want_i, k_plus_1_score):
    gs, gi = (x.numpy() for x in got)
    assert gs.dtype == np.float32 and gi.dtype == np.int32
    np.testing.assert_allclose(gs, np.asarray(want_s), atol=ATOL, rtol=0)
    sep = _separated(np.asarray(want_s), k_plus_1_score)
    assert sep.mean() > 0.5
    np.testing.assert_array_equal(gi[sep], np.asarray(want_i)[sep])


def _next_best(q: np.ndarray, c: np.ndarray, k: int) -> np.ndarray:
    """The (k+1)-th best score per query (-inf where N == k)."""
    s, _ = j_ref.topk_similarity(jnp.asarray(q), jnp.asarray(c),
                                 min(k + 1, len(c)))
    s = np.asarray(s)
    return s[:, k] if k < len(c) else np.full(len(q), -np.inf, np.float32)


@pytest.mark.parametrize("corpus_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Q,N,D,k", [(9, 130, 24, 5), (4, 32, 8, 3)])
def test_plain_topk_matches_reference(rng, corpus_dtype, Q, N, D, k):
    """The plain path (ops on CPU tensors) against the jnp oracle and the
    Pallas kernel in interpret mode (q_block=4, corpus_tile=32: a padded
    query block and a padded corpus tile at (9, 130))."""
    q = rng.normal(size=(Q, D)).astype(np.float32)
    c = np.array(jnp.asarray(rng.normal(size=(N, D)),
                             jnp.dtype(corpus_dtype)), np.float32)
    jc = jnp.asarray(c, jnp.dtype(corpus_dtype))
    tc = torch.from_numpy(c).to(getattr(torch, corpus_dtype))
    got = t_ops.topk_similarity(torch.from_numpy(q), tc, k)
    assert got[0].shape == got[1].shape == (Q, k)
    nxt = _next_best(q, c, k)
    ws, wi = j_ref.topk_similarity(jnp.asarray(q), jc, k)
    _hold(got, ws, wi, nxt)
    ps, pi = j_tk.topk_similarity(jnp.asarray(q), jc, k, q_block=4,
                                  corpus_tile=32, interpret=True)
    _hold(got, ps, pi, nxt)


def test_exact_ties_take_the_lower_id(rng):
    """Rows with 16 entries of +-1 have norm 4, so normalising and every
    dot product are exact in fp32, and the corpus repeats rows: many scores
    are equal, and the ids must be jax.lax.top_k's (lower id first) and the
    Pallas kernel's."""
    D, N, Q, k = 32, 96, 6, 12

    def signs(n):
        x = np.zeros((n, D), np.float32)
        for r in range(n):
            cols = rng.choice(D, 16, replace=False)
            x[r, cols] = rng.choice([-1.0, 1.0], 16)
        return x

    c = signs(N // 3)
    c = np.concatenate([c, c[::-1], c])             # every row three times
    q = np.concatenate([signs(Q - 2), c[5:6], c[40:41]])
    got_s, got_i = t_ops.topk_similarity(torch.from_numpy(q),
                                         torch.from_numpy(c), k)
    ws, wi = j_ref.topk_similarity(jnp.asarray(q), jnp.asarray(c), k)
    vals = np.asarray(jax.lax.top_k(jnp.asarray(q @ c.T / 16.0), k)[1])
    np.testing.assert_array_equal(np.asarray(wi), vals)
    assert (np.diff(np.asarray(ws), axis=1) == 0).sum() > Q, "too few ties"
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(wi))
    _, pi = j_tk.topk_similarity(jnp.asarray(q), jnp.asarray(c), k,
                                 q_block=4, corpus_tile=32, interpret=True)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(pi))


def test_recommender_query_batch():
    """apps.recommender_query_batch at a reduced size (12 queries over a
    500 x 128 movie matrix, top 10): the port's ids on the same inputs."""
    nq, n, d = 12, 500, 128
    want_ids = apps.recommender_query_batch(np.random.default_rng(5),
                                            n_queries=nq, corpus=n, d=d)
    rng = np.random.default_rng(5)                  # the app's inputs again
    q = rng.normal(size=(nq, d)).astype(np.float32)
    c = rng.normal(size=(n, d)).astype(np.float32)
    got = t_ops.topk_similarity(torch.from_numpy(q), torch.from_numpy(c), 10)
    ws, wi = j_ref.topk_similarity(jnp.asarray(q), jnp.asarray(c), 10)
    np.testing.assert_array_equal(np.asarray(wi), want_ids)
    _hold(got, ws, want_ids, _next_best(q, c, 10))


def test_ops_takes_the_plain_version_on_cpu(rng):
    """A CPU tensor takes the plain version and counts no launch; the
    kernel wrapper refuses a CPU tensor; k > N raises as jax.lax.top_k
    does."""
    q = torch.from_numpy(rng.normal(size=(3, 8)).astype(np.float32))
    c = torch.from_numpy(rng.normal(size=(20, 8)).astype(np.float32))
    t_ops.reset_launch_counts()
    s, i = t_ops.topk_similarity(q, c, 4)
    assert i.dtype == torch.int32 and s.dtype == torch.float32
    assert t_ops.launch_counts()["topk_similarity"] == 0
    assert "topk_similarity" in t_build.KERNELS
    with pytest.raises(ValueError, match="CUDA kernel got a tensor on cpu"):
        t_tk.topk_similarity(q, c, 4)
    with pytest.raises(ValueError, match="k=21"):
        t_ops.topk_similarity(q, c, 21)


@pytest.mark.parametrize("nq,n,k", [(50, 58_000, 10), (256, 58_000, 10),
                                    (70, 1000, 32), (1, 5, 5),
                                    (4, 1_000_000, 32)])
def test_kernel_corpus_splits_cover_the_corpus(nq, n, k):
    """The wrapper's split of the corpus over blocks: whole tiles, every
    split non-empty, every row in exactly one split, at most 6144 partial
    entries a query for the merge pass, and at the recommender's shapes
    at least one block per SM of an H100 (132)."""
    splits, rows = t_tk._splits(nq, n, k, 132)
    assert rows % t_tk._CT == 0
    assert (splits - 1) * rows < n <= splits * rows
    assert splits * k <= t_tk._MERGE_ENTRIES
    if n == 58_000:
        assert -(-nq // t_tk._QB) * splits >= 132


@pytest.mark.parametrize("qps,n_active,paper_mj", [
    (96.0, 0, 5021.0), (296.0, 36, 1662.0), (579.0, 0, 832.0),
    (1506.0, 36, 327.0), (9496.0, 0, 50.8), (20994.0, 36, 23.4)])
def test_energy_reproduces_table1(qps, n_active, paper_mj):
    """The port's copy of the Table I model gives the reference's numbers
    (the same arithmetic: equal to 1e-12) and so the published ones."""
    got = t_energy.energy_per_query_mj(qps, n_active)
    assert got == pytest.approx(j_energy.energy_per_query_mj(qps, n_active),
                                rel=1e-12)
    assert abs(got - paper_mj) < (2.0 if paper_mj > 100 else 1.0)
    assert t_energy.server_power(n_active) == j_energy.server_power(n_active)
    assert t_energy.energy_saving(qps, 2 * qps) == pytest.approx(
        j_energy.energy_saving(qps, 2 * qps), rel=1e-12)
