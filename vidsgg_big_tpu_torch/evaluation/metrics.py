"""Relation-detection evaluation (challenge-JSON protocol).

Behavior-parity reimplementation of the VidVRD-helper metrics
(reference VidVRDhelperEvalAPIs/visual_relation_detection.py:7-223 and
common.py:4-106): per-video greedy matching of predictions to GT (same
triplet names, min(sub, obj) vIoU >= threshold) in descending score order,
VOC AP averaged over videos (mAP), dataset-level Recall@K by global score
sort, and tagging Precision@K — with the per-frame python vIoU loop replaced
by vectorized numpy and per-pair memoization (the eval hot spot).

Provenance note: this module deliberately tracks the *public challenge
evaluation protocol* (the ImageNet-VidVRD / VidOR toolkit, itself derived
from py-faster-rcnn's ``voc_ap``) closely, including bookkeeping structure
and variable naming, because bit-identical metric values against that
toolkit are the correctness contract (tests/test_eval.py asserts it for the
JAX package's copy; tests/test_torch_eval.py holds this copy to that one).
Only the hot paths (vIoU, per-prediction GT scans) are restructured.
"""
from __future__ import annotations

from collections import defaultdict

import numpy as np


def voc_ap(rec, prec, use_07_metric: bool = False) -> float:
    """VOC AP from recall/precision curves (continuous by default)."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = np.max(prec[rec >= t]) if np.sum(rec >= t) > 0 else 0
            ap += p / 11.0
        return ap
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = np.maximum(mpre[i - 1], mpre[i])
    i = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[i + 1] - mrec[i]) * mpre[i + 1]))


def viou(traj_1, duration_1, traj_2, duration_2) -> float:
    """Volumetric IoU of two trajectories with half-open [s, e) durations.

    Same numeric contract as reference common.py:65-106, vectorized.
    """
    d1s, d1e = duration_1
    d2s, d2e = duration_2
    if d1s >= d2e or d1e <= d2s:
        return 0.0
    t1 = np.asarray(traj_1, dtype=np.float64)
    t2 = np.asarray(traj_2, dtype=np.float64)
    s, e = max(d1s, d2s), min(d1e, d2e)
    a = t1[s - d1s:e - d1s]
    b = t2[s - d2s:e - d2s]
    lt = np.maximum(a[:, :2], b[:, :2])
    rb = np.minimum(a[:, 2:4], b[:, 2:4])
    wh = np.clip(rb - lt + 1, 0, None)
    v_overlap = (wh[:, 0] * wh[:, 1]).sum()
    v1 = ((t1[:, 2] - t1[:, 0] + 1) * (t1[:, 3] - t1[:, 1] + 1)).sum()
    v2 = ((t2[:, 2] - t2[:, 0] + 1) * (t2[:, 3] - t2[:, 1] + 1)).sum()
    return float(v_overlap) / float(v1 + v2 - v_overlap)


def eval_detection_scores(gt_relations, pred_relations, viou_threshold,
                          return_gt2det: bool = False):
    """Greedy score-ordered matching (reference semantics, incl. stable sort
    on score ties and the ov>ov_max strict-improvement rule)."""
    pred_relations = sorted(pred_relations, key=lambda x: x["score"],
                            reverse=True)
    gt_detected = np.zeros((len(gt_relations),), dtype=bool)
    gt2det_ids = np.full((len(gt_relations),), -1, dtype=int)
    hit_scores = np.full((len(pred_relations),), -np.inf)

    # index gts by triplet so each prediction only scans same-triplet gts
    by_triplet = defaultdict(list)
    for gi, g in enumerate(gt_relations):
        by_triplet[tuple(g["triplet"])].append(gi)

    for pred_idx, pred in enumerate(pred_relations):
        ov_max = -float("inf")
        k_max = -1
        for gt_idx in by_triplet.get(tuple(pred["triplet"]), ()):
            if gt_detected[gt_idx]:
                continue
            gt = gt_relations[gt_idx]
            s_iou = viou(pred["sub_traj"], pred["duration"],
                         gt["sub_traj"], gt["duration"])
            o_iou = viou(pred["obj_traj"], pred["duration"],
                         gt["obj_traj"], gt["duration"])
            ov = min(s_iou, o_iou)
            if ov >= viou_threshold and ov > ov_max:
                ov_max = ov
                k_max = gt_idx
        if k_max >= 0:
            hit_scores[pred_idx] = pred["score"]
            gt_detected[k_max] = True
            gt2det_ids[k_max] = pred_idx
    tp = np.isfinite(hit_scores)
    cum_tp = np.cumsum(tp).astype(np.float32)
    cum_fp = np.cumsum(~tp).astype(np.float32)
    rec = cum_tp / np.maximum(len(gt_relations), np.finfo(np.float32).eps)
    prec = cum_tp / np.maximum(cum_tp + cum_fp, np.finfo(np.float32).eps)
    if return_gt2det:
        return prec, rec, hit_scores, gt2det_ids
    return prec, rec, hit_scores


def eval_tagging_scores(gt_relations, pred_relations):
    pred_relations = sorted(pred_relations, key=lambda x: x["score"],
                            reverse=True)
    gt_triplets = set(tuple(r["triplet"]) for r in gt_relations)
    pred_triplets = []
    hit_scores = []
    for r in pred_relations:
        triplet = tuple(r["triplet"])
        if triplet not in pred_triplets:
            pred_triplets.append(triplet)
            hit_scores.append(r["score"])
    hit_scores = np.asarray(hit_scores)
    for i, t in enumerate(pred_triplets):
        if t not in gt_triplets:
            hit_scores[i] = -np.inf
    tp = np.isfinite(hit_scores)
    cum_tp = np.cumsum(tp).astype(np.float32)
    cum_fp = np.cumsum(~tp).astype(np.float32)
    rec = cum_tp / np.maximum(len(gt_triplets), np.finfo(np.float32).eps)
    prec = cum_tp / np.maximum(cum_tp + cum_fp, np.finfo(np.float32).eps)
    return prec, rec, hit_scores


def evaluate(groundtruth, prediction, viou_threshold=0.5,
             det_nreturns=(50, 100), tag_nreturns=(1, 5, 10),
             return_hit_infos: bool = False):
    """Dataset-level mAP / Recall@K / tagging Precision@K.

    groundtruth/prediction: {video_name: [relation dicts]}.
    """
    video_ap = {}
    tot_scores = defaultdict(list)
    tot_tp = defaultdict(list)
    prec_at_n = defaultdict(list)
    tot_gt_relations = 0
    det_infos = {}
    for vid, gt_relations in groundtruth.items():
        if len(gt_relations) == 0:
            continue
        tot_gt_relations += len(gt_relations)
        predict_relations = prediction.get(vid, [])
        det_prec, det_rec, det_scores, gt2det_ids = eval_detection_scores(
            gt_relations, predict_relations, viou_threshold,
            return_gt2det=True)
        det_infos[vid] = (det_scores, gt2det_ids)
        video_ap[vid] = voc_ap(det_rec, det_prec)
        tp = np.isfinite(det_scores)
        for nre in det_nreturns:
            cut_off = min(nre, det_scores.size)
            tot_scores[nre].append(det_scores[:cut_off])
            tot_tp[nre].append(tp[:cut_off])
        tag_prec, _, _ = eval_tagging_scores(gt_relations, predict_relations)
        for nre in tag_nreturns:
            cut_off = min(nre, tag_prec.size)
            prec_at_n[nre].append(tag_prec[cut_off - 1] if cut_off > 0 else 0.0)

    mean_ap = float(np.mean(list(video_ap.values()))) if video_ap else 0.0
    rec_at_n = {}
    for nre in det_nreturns:
        scores = np.concatenate(tot_scores[nre]) if tot_scores[nre] else \
            np.zeros((0,))
        tps = np.concatenate(tot_tp[nre]) if tot_tp[nre] else \
            np.zeros((0,), bool)
        sort_indices = np.argsort(scores)[::-1]
        tps = tps[sort_indices]
        cum_tp = np.cumsum(tps).astype(np.float32)
        rec = cum_tp / np.maximum(tot_gt_relations,
                                  np.finfo(np.float32).eps)
        rec_at_n[nre] = float(rec[-1]) if rec.size else 0.0
    mprec_at_n = {nre: float(np.mean(prec_at_n[nre])) if prec_at_n[nre]
                  else 0.0 for nre in tag_nreturns}
    if return_hit_infos:
        return mean_ap, rec_at_n, mprec_at_n, det_infos
    return mean_ap, rec_at_n, mprec_at_n


def eval_relation_with_gt(dataset_type=None, logger=None,
                          prediction_results=None, json_results_path=None,
                          gt_relations_path=None, gt_relations=None,
                          return_hit_infos=False):
    """Reference-compatible entry point (eval_relation_with_gt,
    reference visual_relation_detection.py:226-265) with explicit GT paths."""
    import json

    log = logger.info if logger is not None else print
    if prediction_results is None:
        log(f"loading json results from {json_results_path}")
        with open(json_results_path) as f:
            prediction_results = json.load(f)
    if gt_relations is None:
        if gt_relations_path is None:
            d = (dataset_type or "vidvrd").lower()
            gt_relations_path = (
                "datasets/GT_json_for_eval/VidVRDtest_gts.json" if d == "vidvrd"
                else "datasets/GT_json_for_eval/VidORval_gts.json")
        with open(gt_relations_path) as f:
            gt_relations = json.load(f)
    log(f"Computing average precision AP over {len(gt_relations)} videos...")
    out = evaluate(gt_relations, prediction_results, viou_threshold=0.5,
                   return_hit_infos=return_hit_infos)
    if return_hit_infos:
        mean_ap, rec_at_n, mprec_at_n, hit_infos = out
    else:
        mean_ap, rec_at_n, mprec_at_n = out
    log(f"detection mean AP (used in challenge): {mean_ap}")
    log(f"detection recall: {rec_at_n}")
    log(f"tagging precision: {mprec_at_n}")
    if return_hit_infos:
        return mean_ap, rec_at_n, mprec_at_n, hit_infos
    return mean_ap, rec_at_n, mprec_at_n
