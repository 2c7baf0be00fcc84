"""Clustering evaluation (counterpart of
``ssrg_tpu/train/clustering_metrics.py``): accuracy and macro-F1 under the
best cluster-to-class assignment (the Hungarian step,
``scipy.optimize.linear_sum_assignment``), normalized mutual information
(arithmetic normalization) and the adjusted Rand index, in numpy. The
reference computes the last three with scikit-learn, which the port does
not need; the definitions below are scikit-learn's.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

_EPS = np.finfo(np.float64).eps


def _contingency(true_labels: np.ndarray, pred_labels: np.ndarray) -> np.ndarray:
    """Counts ``[n_classes, n_clusters]`` of each (class, cluster) pair."""
    _, ti = np.unique(true_labels, return_inverse=True)
    _, pi = np.unique(pred_labels, return_inverse=True)
    counts = np.zeros((ti.max() + 1, pi.max() + 1), np.int64)
    np.add.at(counts, (ti, pi), 1)
    return counts


def _f1_macro(true_labels: np.ndarray, pred_labels: np.ndarray) -> float:
    """Mean over the labels of either array of ``2 tp / (2 tp + fp + fn)``
    (0 for a label with no true positive)."""
    scores = []
    for label in np.union1d(true_labels, pred_labels):
        t, p = true_labels == label, pred_labels == label
        tp = float(np.sum(t & p))
        denom = 2 * tp + float(np.sum(~t & p)) + float(np.sum(t & ~p))
        scores.append(2 * tp / denom if tp else 0.0)
    return float(np.mean(scores))


def clustering_accuracy(true_labels: np.ndarray, pred_labels: np.ndarray) -> Dict[str, float]:
    """Accuracy and macro-F1 under the optimal cluster-to-class assignment;
    a cluster left without a class counts as label -1."""
    from scipy.optimize import linear_sum_assignment

    true_labels = np.asarray(true_labels)
    pred_labels = np.asarray(pred_labels)
    classes = np.unique(true_labels)
    clusters = np.unique(pred_labels)
    cost = np.zeros((clusters.shape[0], classes.shape[0]))
    for i, c in enumerate(clusters):
        mask = pred_labels == c
        for j, k in enumerate(classes):
            cost[i, j] = np.sum(true_labels[mask] == k)
    row, col = linear_sum_assignment(-cost)
    mapping = {clusters[i]: classes[j] for i, j in zip(row, col)}
    remapped = np.asarray([mapping.get(p, -1) for p in pred_labels])
    return {"acc": float(np.mean(remapped == true_labels)),
            "f1_macro": _f1_macro(true_labels, remapped)}


def _entropy(counts: np.ndarray) -> float:
    counts = counts[counts > 0].astype(np.float64)
    total = counts.sum()
    return float(-np.sum((counts / total) * (np.log(counts) - np.log(total))))


def normalized_mutual_info(true_labels: np.ndarray, pred_labels: np.ndarray) -> float:
    """Mutual information over the mean of the two entropies (1 when both
    labelings are one class, or empty)."""
    c = _contingency(np.asarray(true_labels), np.asarray(pred_labels))
    if c.shape[0] == c.shape[1] == 1:
        return 1.0
    rows, cols = c.sum(axis=1), c.sum(axis=0)
    if rows.size == 1 or cols.size == 1:
        return 0.0
    nzx, nzy = np.nonzero(c)
    nz = c[nzx, nzy].astype(np.float64)
    total = float(c.sum())
    p = nz / total
    outer = rows[nzx].astype(np.int64) * cols[nzy].astype(np.int64)
    terms = p * (np.log(nz) - np.log(total)) + p * (-np.log(outer) + 2 * np.log(total))
    terms = np.where(np.abs(terms) < _EPS, 0.0, terms)
    mi = float(np.clip(terms.sum(), 0.0, None))
    if mi < _EPS:
        return 0.0
    normalizer = max((_entropy(rows) + _entropy(cols)) / 2, _EPS)
    return mi / normalizer


def adjusted_rand_index(true_labels: np.ndarray, pred_labels: np.ndarray) -> float:
    """The adjusted Rand index from the pair confusion matrix (1 when no
    pair is split or joined differently)."""
    c = _contingency(np.asarray(true_labels), np.asarray(pred_labels))
    n = int(c.sum())
    sum_squares = int((c.astype(np.int64) ** 2).sum())
    rows, cols = c.sum(axis=1).astype(np.int64), c.sum(axis=0).astype(np.int64)
    tp = sum_squares - n
    fp = int((c @ cols).sum()) - sum_squares
    fn = int((c.T @ rows).sum()) - sum_squares
    tn = n * n - fp - fn - sum_squares
    if fn == 0 and fp == 0:
        return 1.0
    return 2.0 * (tp * tn - fn * fp) / ((tp + fn) * (fn + tn) + (tp + fp) * (fp + tn))


def evaluation_cluster_model_from_label(true_labels: np.ndarray,
                                        pred_labels: np.ndarray) -> Dict[str, float]:
    """Accuracy, macro-F1, NMI and ARI."""
    out = clustering_accuracy(true_labels, pred_labels)
    out["nmi"] = normalized_mutual_info(true_labels, pred_labels)
    out["ari"] = adjusted_rand_index(true_labels, pred_labels)
    return out
