"""Grounding-stage self-evaluation: per-query tIoU and multi-bin F1.

Behavior-parity with reference models/grd_model_v5.py:578-665 (eval_tiou /
eval_f1score): for each unique query, compare its kept bins' spans against
all duplicate GT spans of that query; recall counts GT spans hit at a tIoU
threshold, precision counts kept bins.  A copy of the JAX package's
``evaluation/grounding_eval.py`` (numpy on the host).
"""
from __future__ import annotations

import numpy as np


def _tiou(d1, d2):
    """d1 (n,2), d2 (m,2) -> (n, m); 0 where disjoint."""
    a0, a1 = d1[:, None, 0], d1[:, None, 1]
    b0, b1 = d2[None, :, 0], d2[None, :, 1]
    inter = np.minimum(a1, b1) - np.maximum(a0, b0)
    union = np.maximum(a1, b1) - np.minimum(a0, b0)
    t = inter / np.maximum(union, 1e-12)
    return np.where((a1 >= b0) & (b1 >= a0), t, 0.0)


def grounding_tiou(pred_spans, bins_mask, targets, groups):
    """Mean of per-duplicate best tIoU.

    pred_spans: (U, K1, 2) normalized spans per unique query.
    bins_mask: (U, K1) kept bins.
    targets: (P, 2) normalized GT spans (all duplicates).
    groups: list of index arrays, groups[u] = duplicate rows of unique u.
    """
    tious = []
    for u, rows in enumerate(groups):
        se = pred_spans[u][bins_mask[u]]
        if se.size == 0:
            tious.extend([0.0] * len(rows))
            continue
        t = _tiou(targets[rows], se)
        tious.extend(t.max(-1).tolist())
    return np.asarray(tious)


def grounding_f1(pred_spans, bins_mask, targets, groups, tiou_ths=(0.5,)):
    """Recall / precision / F1 over kept bins at the given tIoU thresholds."""
    n_hits = {th: 0.0 for th in tiou_ths}
    n_tgts = 0
    n_preds = 0
    for u, rows in enumerate(groups):
        se = pred_spans[u][bins_mask[u]]
        n_tgts += len(rows)
        n_preds += se.shape[0]
        if se.size == 0:
            continue
        t = _tiou(targets[rows], se)
        for th in tiou_ths:
            n_hits[th] += float(((t > th).sum(-1) > 0).sum())
    out = {}
    for th in tiou_ths:
        r = n_hits[th] / max(n_tgts, 1)
        p = n_hits[th] / max(n_preds, 1)
        out[th] = {"recall": r, "precision": p,
                   "f1": 2 * p * r / (p + r + 1e-6)}
    return out
