"""Evaluation metrics on the host, in numpy (counterpart of
`ecamp_tpu/train/eval_metrics.py`, copied so that the port imports nothing
of the JAX package).

AUROC replaces sklearn.roc_auc_score (Classification/train.py:65-71) with a
tie-aware rank statistic (identical values).
"""

from __future__ import annotations

from typing import List

import numpy as np


def roc_auc(scores: np.ndarray, labels: np.ndarray) -> float:
    """Binary AUROC via average ranks (equals sklearn.roc_auc_score)."""
    scores = np.asarray(scores, dtype=np.float64).ravel()
    labels = np.asarray(labels).ravel().astype(bool)
    n_pos = int(labels.sum())
    n_neg = labels.size - n_pos
    if n_pos == 0 or n_neg == 0:
        raise ValueError("roc_auc needs both classes present")
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty(scores.size, dtype=np.float64)
    sorted_scores = scores[order]
    i = 0
    while i < scores.size:
        j = i
        while j + 1 < scores.size and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        ranks[order[i:j + 1]] = 0.5 * ((i + 1) + (j + 1))
        i = j + 1
    pos_rank_sum = ranks[labels].sum()
    return float((pos_rank_sum - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def multilabel_auc(scores: np.ndarray, labels: np.ndarray) -> List[float]:
    """Per-class AUROC (Classification/train.py:65-71). A class whose eval
    split holds only one label value gets NaN instead of failing the run;
    average with nanmean."""
    out = []
    for i in range(scores.shape[1]):
        try:
            out.append(roc_auc(scores[:, i], labels[:, i]))
        except ValueError:
            out.append(float("nan"))
    return out


def accuracy(preds: np.ndarray, labels: np.ndarray) -> float:
    """simple_accuracy (Classification/train.py:74-77)."""
    return float(((np.asarray(preds) == np.asarray(labels)) * 1).mean())


def dice_scores(probs: np.ndarray, truth: np.ndarray,
                threshold: float = 0.5) -> np.ndarray:
    """Per-sample dice with the empty-mask convention
    (Segmentation/train.py:191-213): empty gt -> 1.0 iff pred empty else 0;
    non-empty gt -> 2|p∩t| / (|p|+|t|)."""
    b = truth.shape[0]
    p = (probs.reshape(b, -1) > threshold).astype(np.float64)
    t = (truth.reshape(b, -1) > 0.5).astype(np.float64)
    t_sum = t.sum(-1)
    p_sum = p.sum(-1)
    dice = np.where(
        t_sum == 0,
        (p_sum == 0).astype(np.float64),
        2.0 * (p * t).sum(-1) / np.maximum((p + t).sum(-1), 1e-12),
    )
    return dice
