"""Temporal action-detection mAP (reference
VidVRD-helper/evaluation/action_detection.py:6-123).

A copy of the JAX package's ``evaluation/action_detection.py`` on the
port's ``metrics.voc_ap`` and ``metrics.viou``: the challenge toolkit's
bookkeeping, kept as it is because equal metric values are the contract
(see ``evaluation/metrics.py``).  No CLI calls it; it is a library
function.
"""
from __future__ import annotations

import numpy as np

from .metrics import viou, voc_ap


def _detection_scores_per_class(gt_actions, pred_actions, viou_threshold):
    pred_actions = sorted(pred_actions, key=lambda x: x["score"],
                          reverse=True)
    gt_detected = np.zeros((len(gt_actions),), dtype=bool)
    hit_scores = np.full((len(pred_actions),), -np.inf)
    for pred_idx, pred in enumerate(pred_actions):
        ov_max, k_max = -float("inf"), -1
        for gt_idx, gt in enumerate(gt_actions):
            if gt_detected[gt_idx] or pred["id"] != gt["id"]:
                continue
            ov = viou(pred["trajectory"], pred["duration"],
                      gt["trajectory"], gt["duration"])
            if ov >= viou_threshold and ov > ov_max:
                ov_max, k_max = ov, gt_idx
        if k_max >= 0:
            hit_scores[pred_idx] = pred["score"]
            gt_detected[k_max] = True
    tp = np.isfinite(hit_scores)
    cum_tp = np.cumsum(tp).astype(np.float32)
    cum_fp = np.cumsum(~tp).astype(np.float32)
    rec = cum_tp / np.maximum(len(gt_actions), np.finfo(np.float32).eps)
    prec = cum_tp / np.maximum(cum_tp + cum_fp, np.finfo(np.float32).eps)
    return prec, rec, hit_scores


def eval_action(groundtruth, prediction, viou_threshold=0.5):
    """groundtruth/prediction: {vid: [{category, duration, trajectory,
    (score)}]}; per-class AP averaged over GT classes."""
    gt_classes = {t["category"] for ts in groundtruth.values() for t in ts}
    pred_by_class = {}
    for vid, tracks in prediction.items():
        for traj in tracks:
            pred_by_class.setdefault(traj["category"], []).append({
                "id": vid, "score": traj["score"],
                "duration": traj["duration"],
                "trajectory": traj["trajectory"]})
    ap_class = {}
    for action in gt_classes:
        gts = []
        for vid, tracks in groundtruth.items():
            for traj in tracks:
                if traj["category"] == action:
                    gts.append({"id": vid, "duration": traj["duration"],
                                "trajectory": traj["trajectory"]})
        preds = pred_by_class.get(action, [])
        if not preds:
            ap_class[action] = 0.0
            continue
        prec, rec, _ = _detection_scores_per_class(gts, preds,
                                                   viou_threshold)
        ap_class[action] = voc_ap(rec, prec)
    mean_ap = (sum(ap_class.values()) / len(gt_classes)) if gt_classes else 0.
    return mean_ap, sorted(ap_class.items())
