"""Evaluation metrics: top-k accuracy, mAP, per-class AP/AUC, d-prime,
confidence intervals — in numpy.

``leaf_tpu.training.metrics`` (after reference utilities/metrics_helper.py)
computes these with scikit-learn, which the card's machine does not have.
Here the curves are sklearn's (1.x) own algorithm, reimplemented:

- the thresholds are the distinct scores in descending order; tied scores
  share one threshold;
- ``roc_curve`` drops the points collinear with their neighbours
  (``drop_intermediate=True``: a point stays where the second difference
  of fps or tps is non-zero, and at both ends) and starts at (0, 0);
  ``precision_recall_curve`` keeps every threshold and ends at (1, 0);
- AP is the step integral −Σ Δrecall · precision, clipped at 0;
  AUC is the trapezoid under the ROC curve;
- a class with no positive gets recall 1 at every threshold (AP 0) and a
  NaN tpr, hence a NaN AUC; a class with no negative a NaN fpr and AUC.

So ``calculate_stats``' curves, subsampled ``[0::1000]``, match sklearn's
point for point, not only their areas. scipy gives ``norm.ppf`` and
``t.ppf`` and nothing else.
"""

from __future__ import annotations

import warnings
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

# numpy 2 renamed trapz
_trapezoid = getattr(np, "trapezoid", None) or np.trapz

__all__ = ["accuracy", "d_prime", "calculate_stats",
           "mean_confidence_interval", "calculate_mAP", "roc_curve",
           "precision_recall_curve", "average_precision", "roc_auc"]


def accuracy(output: np.ndarray, target: np.ndarray,
             topk: Sequence[int] = (1, 5)) -> Tuple[List[float], np.ndarray]:
    """Precision@k over logits (samples, classes); returns percentages
    (reference: metrics_helper.py:12-24)."""
    output = np.asarray(output)
    target = np.asarray(target)
    maxk = max(topk)
    batch_size = target.shape[0]
    # top-maxk indices, descending
    pred = np.argsort(-output, axis=1)[:, :maxk].T  # (maxk, B)
    correct = pred == target.reshape(1, -1)
    res = []
    for k in topk:
        correct_k = correct[:k].reshape(-1).sum(dtype=np.float64)
        res.append(float(correct_k * 100.0 / batch_size))
    return res, pred


def d_prime(auc: float) -> float:
    """d' = Φ⁻¹(auc)·√2 (reference: metrics_helper.py:40-43)."""
    from scipy.stats import norm
    return float(norm.ppf(auc) * np.sqrt(2.0))


def _binary_inputs(y_true, y_score) -> Tuple[np.ndarray, np.ndarray]:
    y_true = np.asarray(y_true, dtype=np.float64).reshape(-1)
    y_score = np.asarray(y_score, dtype=np.float64).reshape(-1)
    if y_true.shape != y_score.shape:
        raise ValueError(f"y_true {y_true.shape} and y_score {y_score.shape} "
                         "differ in length")
    if not (np.isfinite(y_true).all() and np.isfinite(y_score).all()):
        raise ValueError("Input contains NaN or infinity.")
    if not np.isin(y_true, (0.0, 1.0)).all():
        raise ValueError("y_true must hold binary labels in {0, 1}")
    return y_true, y_score


def _clf_curve(y_true, y_score):
    """(fps, tps) at each distinct score, descending (sklearn's
    ``confusion_matrix_at_thresholds``)."""
    y_true, y_score = _binary_inputs(y_true, y_score)
    order = np.argsort(-y_score, kind="stable")
    y_score, y_true = y_score[order], y_true[order]
    idx = np.r_[np.nonzero(np.diff(y_score))[0], y_true.size - 1]
    tps = np.cumsum(y_true, dtype=np.float64)[idx]
    fps = 1.0 + idx.astype(np.float64) - tps
    return fps, tps


def roc_curve(y_true, y_score) -> Tuple[np.ndarray, np.ndarray]:
    """(fpr, tpr) as ``sklearn.metrics.roc_curve`` (drop_intermediate)."""
    fps, tps = _clf_curve(y_true, y_score)
    if fps.shape[0] > 2:
        keep = np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)),
                     True]
        fps, tps = fps[keep], tps[keep]
    tps = np.r_[0.0, tps]
    fps = np.r_[0.0, fps]
    if fps[-1] <= 0:
        warnings.warn("No negative samples in y_true, false positive value "
                      "should be meaningless")
        fpr = np.full(fps.shape, np.nan)
    else:
        fpr = fps / fps[-1]
    if tps[-1] <= 0:
        warnings.warn("No positive samples in y_true, true positive value "
                      "should be meaningless")
        tpr = np.full(tps.shape, np.nan)
    else:
        tpr = tps / tps[-1]
    return fpr, tpr


def precision_recall_curve(y_true, y_score) -> Tuple[np.ndarray, np.ndarray]:
    """(precision, recall) as ``sklearn.metrics.precision_recall_curve``."""
    fps, tps = _clf_curve(y_true, y_score)
    precision = tps / (tps + fps)  # tps + fps ≥ 1 at every threshold
    if tps[-1] == 0:
        warnings.warn("No positive class found in y_true, recall is set to "
                      "one for all thresholds.")
        recall = np.ones_like(tps)
    else:
        recall = tps / tps[-1]
    return np.r_[precision[::-1], 1.0], np.r_[recall[::-1], 0.0]


def average_precision(y_true, y_score) -> float:
    """Binary AP (``average_precision_score`` of one class)."""
    precision, recall = precision_recall_curve(y_true, y_score)
    return float(max(0.0, -np.sum(np.diff(recall) * precision[:-1])))


def roc_auc(y_true, y_score) -> float:
    """Binary ROC AUC (``roc_auc_score`` of one class); NaN, with a
    warning, when y_true holds one class only."""
    if np.unique(np.asarray(y_true)).shape[0] != 2:
        warnings.warn("Only one class is present in y_true. ROC AUC score "
                      "is not defined in that case.")
        return float("nan")
    fpr, tpr = roc_curve(y_true, y_score)
    dx = np.diff(fpr)
    direction = 1.0
    if np.any(dx < 0):
        if not np.all(dx <= 0):
            raise ValueError(f"x is neither increasing nor decreasing : {fpr}.")
        direction = -1.0
    return float(direction * _trapezoid(tpr, fpr))


def calculate_stats(output: np.ndarray, target: np.ndarray,
                    class_indices: Optional[Iterable[int]] = None) -> List[dict]:
    """Per-class AP / AUC / PR / ROC (reference: metrics_helper.py:46-89)."""
    output = np.asarray(output, dtype=np.float64)
    target = np.asarray(target, dtype=np.float64)
    classes_num = target.shape[-1]
    if class_indices is None:
        class_indices = range(classes_num)
    out = []
    for k in class_indices:
        avg_precision = average_precision(target[:, k], output[:, k])
        auc = roc_auc(target[:, k], output[:, k])
        precisions, recalls = precision_recall_curve(target[:, k],
                                                     output[:, k])
        fpr, tpr = roc_curve(target[:, k], output[:, k])
        save_every = 1000
        out.append({
            "precisions": precisions[0::save_every],
            "recalls": recalls[0::save_every],
            "AP": avg_precision,
            "fpr": fpr[0::save_every],
            "fnr": 1.0 - tpr[0::save_every],
            "auc": auc,
        })
    return out


def mean_confidence_interval(data: Sequence[float],
                             confidence: float = 0.95) -> Tuple[float, float]:
    """(mean, half-width of the t CI) — the README's ±x numbers
    (reference: metrics_helper.py:92-97)."""
    from scipy.stats import t as student_t
    a = 1.0 * np.array(data)
    n = len(a)
    m, se = np.mean(a), np.std(a, ddof=1) / np.sqrt(n)
    h = se * student_t.ppf((1 + confidence) / 2.0, n - 1)
    return float(m), float(h)


def _average_precision_score(gts: np.ndarray, preds: np.ndarray,
                             average: Optional[str]):
    """``sklearn.metrics.average_precision_score`` for binary and k-hot
    targets."""
    if gts.ndim == 1 or gts.shape[1] == 1:  # sklearn's "binary" target
        return average_precision(gts, preds)
    if average == "micro":
        return average_precision(gts.ravel(), preds.ravel())
    axis = 0 if average == "samples" else 1
    scores = np.array([average_precision(np.take(gts, c, axis=axis),
                                         np.take(preds, c, axis=axis))
                       for c in range(gts.shape[axis])])
    if average is None:
        return scores
    if average == "weighted":
        weights = gts.sum(axis=0)
        if np.isclose(weights.sum(), 0.0):
            return 0
        scores[weights == 0] = 0
        return float(np.average(scores, weights=weights))
    if average in ("macro", "samples"):
        return float(np.average(scores))
    raise ValueError(f"average has to be one of (None, 'micro', 'macro', "
                     f"'weighted', 'samples'), got {average!r}")


def calculate_mAP(preds, gts, mixup: bool = False,
                  mode: str = "macro") -> float:
    """Mean average precision over concatenated batch lists; mixed-up soft
    targets binarized at 0.5 (reference: metrics_helper.py:100-107)."""
    preds = np.concatenate(
        [np.asarray(p, dtype=np.float64) for p in preds], axis=0)
    gts = np.concatenate(
        [np.asarray(g, dtype=np.float64) for g in gts], axis=0)
    if mixup:
        gts = (gts >= 0.5).astype(gts.dtype)
    return float(_average_precision_score(gts, preds, mode))
