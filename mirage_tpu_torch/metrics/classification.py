"""Classification metrics in numpy: BAcc, AUROC, AP, F1 and MCC.

The port's own copy of ``mirage_tpu/metrics/classification.py`` (reference
mutils/classification.py:248-266), which makes the sklearn calls
``balanced_accuracy_score``, ``roc_auc_score(one-hot, probs,
multi_class="ovr", average="weighted")``, ``average_precision_score(one-hot,
probs, average="weighted")``, ``f1_score(average="weighted",
zero_division=0)`` and ``matthews_corrcoef``. The card's machine has no
sklearn, so each is written here in numpy with sklearn's semantics: the
curves over distinct score thresholds (ties form one step), the trapezoid
under the ROC curve, the uninterpolated step sum for AP, support-weighted
averages in which a class absent from the labels weighs nothing (its
undefined AUROC included), and the labels present in either the truth or
the prediction for the confusion-matrix metrics.
"""

from collections import OrderedDict
from typing import Optional

import numpy as np


def _confusion(y_true, y_pred):
    """Confusion matrix over the sorted labels present in either."""
    labels = np.unique(np.concatenate([y_true, y_pred]))
    t = np.searchsorted(labels, y_true)
    p = np.searchsorted(labels, y_pred)
    cm = np.zeros((len(labels), len(labels)), np.int64)
    np.add.at(cm, (t, p), 1)
    return cm


def balanced_accuracy(y_true, y_pred) -> float:
    """The mean recall over the classes present in y_true."""
    cm = _confusion(np.asarray(y_true), np.asarray(y_pred))
    support = cm.sum(axis=1)
    present = support > 0
    return float(np.mean(np.diag(cm)[present] / support[present]))


def weighted_f1(y_true, y_pred) -> float:
    """Per-class F1 = 2·tp / (true + predicted), 0 where both are 0,
    averaged with the true counts as weights."""
    cm = _confusion(np.asarray(y_true), np.asarray(y_pred))
    tp = np.diag(cm).astype(np.float64)
    true_sum, pred_sum = cm.sum(axis=1), cm.sum(axis=0)
    denom = (true_sum + pred_sum).astype(np.float64)
    f1 = np.zeros_like(tp)
    np.divide(2.0 * tp, denom, out=f1, where=denom != 0)
    return float(np.average(f1, weights=true_sum))


def matthews_corrcoef(y_true, y_pred) -> float:
    """Multiclass MCC from the confusion matrix (0 where undefined)."""
    cm = _confusion(np.asarray(y_true), np.asarray(y_pred))
    t_sum = cm.sum(axis=1, dtype=np.float64)
    p_sum = cm.sum(axis=0, dtype=np.float64)
    n_correct = np.trace(cm, dtype=np.float64)
    n = p_sum.sum()
    cov_ytyp = n_correct * n - np.dot(t_sum, p_sum)
    cov_ypyp = n ** 2 - np.dot(p_sum, p_sum)
    cov_ytyt = n ** 2 - np.dot(t_sum, t_sum)
    if cov_ypyp * cov_ytyt == 0:
        return 0.0
    return float(cov_ytyp / np.sqrt(cov_ytyt * cov_ypyp))


def _threshold_counts(y, score):
    """(fps, tps) at each distinct score, scores descending; y in {0, 1}."""
    order = np.argsort(score, kind="stable")[::-1]
    score, y = score[order], y[order].astype(np.float64)
    idx = np.r_[np.nonzero(np.diff(score))[0], y.size - 1]
    tps = np.cumsum(y)[idx]
    return 1.0 + idx - tps, tps


def binary_auroc(y, score) -> float:
    """Area under the ROC curve (trapezoids between distinct thresholds);
    NaN when y holds one class."""
    if len(np.unique(y)) != 2:
        return float("nan")
    fps, tps = _threshold_counts(y, score)
    if fps.size > 2:  # drop collinear points, as sklearn's roc_curve does
        keep = np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)),
                     True]
        fps, tps = fps[keep], tps[keep]
    fpr = np.r_[0.0, fps] / fps[-1]
    tpr = np.r_[0.0, tps] / tps[-1]
    return float(np.trapezoid(tpr, fpr))


def binary_average_precision(y, score) -> float:
    """Σ (R_k − R_{k−1})·P_k over the distinct thresholds (no
    interpolation); recall is 1 throughout when y has no positive."""
    fps, tps = _threshold_counts(y, score)
    ps = tps + fps
    precision = np.zeros_like(tps)
    np.divide(tps, ps, out=precision, where=ps != 0)
    recall = np.ones_like(tps) if tps[-1] == 0 else tps / tps[-1]
    precision = np.r_[precision[::-1], 1.0]
    recall = np.r_[recall[::-1], 0.0]
    return float(max(0.0, -np.sum(np.diff(recall) * precision[:-1])))


def _weighted_ovr(metric, onehot, probs) -> float:
    """metric per one-vs-rest column, averaged with the column supports as
    weights (a zero-weight column counts as 0, even where undefined)."""
    weights = onehot.sum(axis=0)
    scores = np.array([metric(onehot[:, c], probs[:, c])
                       for c in range(onehot.shape[1])])
    scores[weights == 0] = 0
    return float(np.average(scores, weights=weights))


def compute_cls_metrics(y_true, probs, *, loss: Optional[float] = None,
                        epoch=None):
    """y_true: (N,) int labels; probs: (N, C) softmax scores. Returns the
    reference's CSV row: epoch, loss, bacc, auroc, ap, f1, mcc."""
    y_true = np.asarray(y_true)
    probs = np.asarray(probs)
    y_pred = probs.argmax(axis=1)
    onehot = np.eye(probs.shape[1])[y_true]
    return OrderedDict({
        "epoch": epoch,
        "loss": loss,
        "bacc": balanced_accuracy(y_true, y_pred),
        "auroc": _weighted_ovr(binary_auroc, onehot, probs),
        "ap": _weighted_ovr(binary_average_precision, onehot, probs),
        "f1": weighted_f1(y_true, y_pred),
        "mcc": matthews_corrcoef(y_true, y_pred),
    })
