"""The port's NLP applications (``repro_torch/apps.py``) against the
reference's ``benchmarks/apps.py`` on the CPU: the paper's rates and end
points field by field, and each query batch from the same seed.

Tolerances: the recommender's ids must be equal exactly (at 16 queries
over 256 movies no two scores of a query lie within the plain paths'
rounding of each other).  The sentiment and speech predictions are
argmaxes of fp32 products summed in another order by XLA and PyTorch; a
prediction may differ only where the reference's top-2 logit margin is
under 1e-5, and the count of such places is asserted."""
import dataclasses

import numpy as np
import pytest

from benchmarks import apps as j_apps
from repro_torch import apps as t_apps

MARGIN = 1e-5


def _margins(logits: np.ndarray) -> np.ndarray:
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


def test_app_specs_equal_the_reference():
    assert list(t_apps.APPS) == list(j_apps.APPS)
    assert [f.name for f in dataclasses.fields(t_apps.AppSpec)] == \
        [f.name for f in dataclasses.fields(j_apps.AppSpec)]
    for name, spec in j_apps.APPS.items():
        assert dataclasses.asdict(t_apps.APPS[name]) == \
            dataclasses.asdict(spec), name


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_recommender_ids_equal_the_reference(seed):
    want = j_apps.recommender_query_batch(np.random.default_rng(seed),
                                          n_queries=16, corpus=256)
    got = t_apps.recommender_query_batch(np.random.default_rng(seed),
                                         n_queries=16, corpus=256,
                                         device="cpu")
    assert got.shape == want.shape == (16, 10)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sentiment_predictions_equal_the_reference(seed):
    n = 64
    want = j_apps.sentiment_query_batch(np.random.default_rng(seed),
                                        n_queries=n)
    got = t_apps.sentiment_query_batch(np.random.default_rng(seed),
                                       n_queries=n, device="cpu")
    # the reference's logits in float64 from the same draws
    idx, seg, table, w = (t.numpy().astype(np.float64) if t.is_floating_point()
                          else t.numpy() for t in t_apps.sentiment_inputs(
                              np.random.default_rng(seed), n_queries=n,
                              device="cpu"))
    pooled = np.zeros((n, table.shape[1]))
    np.add.at(pooled, seg, table[idx])
    near = _margins(pooled @ w) < MARGIN
    assert got.shape == want.shape == (n,)
    assert int(near.sum()) == 0
    np.testing.assert_array_equal(got[~near], want[~near])
    assert 0 < got.mean() < 1


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_speech_decode_equals_the_reference(seed):
    want = j_apps.speech_decode_batch(np.random.default_rng(seed))
    got = t_apps.speech_decode_batch(np.random.default_rng(seed),
                                     device="cpu")
    rng = np.random.default_rng(seed)
    frames = rng.normal(size=(1, 64, 80)).astype(np.float32)
    w = rng.normal(size=(80, 512)).astype(np.float32)
    near = _margins(frames.astype(np.float64) @ w.astype(np.float64)) \
        < MARGIN
    assert got.shape == want.shape == (1, 64)
    assert int(near.sum()) == 0
    np.testing.assert_array_equal(got[~near], want[~near])
