"""The port's metrics (leaf_tpu_torch.training.metrics, numpy only) against
the JAX package's, which call scikit-learn.

Within 1e-12 (float64 on both sides) on random scores, on tied scores
(quantized to a few levels, so most thresholds merge), and with a class
that has no positive example (and one with no negative). The per-class
curves of ``calculate_stats`` are compared point for point: sklearn's
``roc_curve`` drops collinear points, and the ``[0::1000]`` subsampling
would expose any point the port kept or dropped differently.
"""

import warnings

import numpy as np
import pytest

from leaf_tpu.training import metrics as jmetrics
from leaf_tpu_torch.training import metrics

TOL = 1e-12


def _scores(kind: str, n: int, c: int, seed: int = 0):
    rng = np.random.RandomState(seed)
    target = (rng.rand(n, c) < 0.3).astype(np.float64)
    output = rng.randn(n, c) + 1.5 * target
    if kind == "tied":
        output = np.round(output * 2) / 2     # ~12 distinct levels
    if kind == "no_positive":
        target[:, 1] = 0.0
    if kind == "no_negative":
        target[:, 2] = 1.0
    return output, target


def _assert_close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(a, b, rtol=0, atol=TOL, equal_nan=True)


KINDS = ["random", "tied", "no_positive", "no_negative"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", [7, 2500])
def test_calculate_stats_matches_jax(kind, n):
    output, target = _scores(kind, n, 4)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = metrics.calculate_stats(output, target)
        want = jmetrics.calculate_stats(output, target)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in g:
            _assert_close(g[key], w[key])


@pytest.mark.parametrize("kind", ["random", "tied"])
def test_roc_curve_keeps_sklearns_points(kind):
    from sklearn.metrics import roc_curve
    output, target = _scores(kind, 3000, 1, seed=3)
    fpr, tpr = metrics.roc_curve(target[:, 0], output[:, 0])
    want_fpr, want_tpr, _ = roc_curve(target[:, 0], output[:, 0])
    assert fpr.shape[0] < 3001   # collinear points were dropped
    _assert_close(fpr, want_fpr)
    _assert_close(tpr, want_tpr)


@pytest.mark.parametrize("mode", ["macro", "micro", "weighted", "samples"])
@pytest.mark.parametrize("kind", KINDS)
def test_calculate_mAP_matches_jax(mode, kind):
    output, target = _scores(kind, 300, 5, seed=1)
    preds = np.array_split(output, 4)
    gts = np.array_split(target, 4)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = metrics.calculate_mAP(preds, gts, mode=mode)
        want = jmetrics.calculate_mAP(preds, gts, mode=mode)
    assert isinstance(got, float)
    _assert_close(got, want)


def test_calculate_mAP_mixup_binarizes_soft_targets():
    output, target = _scores("random", 200, 5, seed=2)
    soft = target * 0.7 + 0.1
    _assert_close(metrics.calculate_mAP([output], [soft], mixup=True),
                  jmetrics.calculate_mAP([output], [soft], mixup=True))


def test_accuracy_matches_jax():
    rng = np.random.RandomState(4)
    logits = rng.randn(64, 35)
    logits[:, 3] = logits[:, 5]            # tied columns
    y = rng.randint(0, 35, 64)
    got, gp = metrics.accuracy(logits, y, topk=(1, 5))
    want, wp = jmetrics.accuracy(logits, y, topk=(1, 5))
    assert got == want
    np.testing.assert_array_equal(gp, wp)


@pytest.mark.parametrize("auc", [0.5, 0.73, 0.99, 1e-3])
def test_d_prime_matches_jax(auc):
    _assert_close(metrics.d_prime(auc), jmetrics.d_prime(auc))


@pytest.mark.parametrize("n", [2, 5, 30])
def test_mean_confidence_interval_matches_jax(n):
    data = np.random.RandomState(n).rand(n)
    for got, want in zip(metrics.mean_confidence_interval(data, 0.9),
                         jmetrics.mean_confidence_interval(data, 0.9)):
        _assert_close(got, want)
