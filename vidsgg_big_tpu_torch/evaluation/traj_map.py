"""Trajectory-proposal quality: per-class video-object-detection mAP.

A copy of the JAX package's ``evaluation/traj_map.py`` on the port's
``metrics.voc_ap`` (behavior-parity with reference
VidVRDhelperEvalAPIs/video_object_detection.py: 3-threshold temporal IoU
overlap, VOC-07 AP by default), with the converters of reference
tools/eval_traj_mAP.py:17-132.  The overlap is a Python loop over frames on
the host, as the toolkit's: the metric is that function, so it stays one.
"""
from __future__ import annotations

import numpy as np

from .metrics import voc_ap


def _iou(b1, b2):
    w1 = b1[2] - b1[0] + 1
    h1 = b1[3] - b1[1] + 1
    w2 = b2[2] - b2[0] + 1
    h2 = b2[3] - b2[1] + 1
    ox = max(0, min(b1[2], b2[2]) - max(b1[0], b2[0]) + 1)
    oy = max(0, min(b1[3], b2[3]) - max(b1[1], b2[1]) + 1)
    inter = ox * oy
    return inter / (w1 * h1 + w2 * h2 - inter)


def trajectory_overlap(gt_trajs, pred_traj):
    """3-threshold fractional tIoU (reference video_object_detection.py:12-43)."""
    max_overlap, max_index = 0, 0
    thresh_s = (0.5, 0.7, 0.9)
    for t, gt_traj in enumerate(gt_trajs):
        top1 = top2 = top3 = 0
        total = len(set(gt_traj.keys()) | set(pred_traj.keys()))
        for fid in gt_traj:
            if fid not in pred_traj:
                continue
            s = _iou(gt_traj[fid], pred_traj[fid])
            if s >= thresh_s[0]:
                top1 += 1
                if s >= thresh_s[1]:
                    top2 += 1
                    if s >= thresh_s[2]:
                        top3 += 1
        t_iou = (top1 + top2 + top3) / (3.0 * total)
        if t_iou > max_overlap:
            max_overlap, max_index = t_iou, t
    return max_overlap, max_index


def eval_video_object(gt, pred, use_07_metric=True, thresh_t=0.5):
    """gt/pred: {vid: [{category, (score,) trajectory: {fid: box}}]}."""
    gt_classes = {t["category"] for ts in gt.values() for t in ts}
    result_class = {}
    for vid, tracks in pred.items():
        for traj in tracks:
            result_class.setdefault(traj["category"], []).append(
                [vid, traj["score"], traj["trajectory"]])

    ap_class = {}
    for c in gt_classes:
        if c not in result_class:
            ap_class[c] = 0.0
            continue
        npos = 0
        class_recs = {}
        for vid in gt:
            gt_trajs = [t["trajectory"] for t in gt[vid]
                        if t["category"] == c]
            class_recs[vid] = {"trajectories": gt_trajs,
                               "det": [False] * len(gt_trajs)}
            npos += len(gt_trajs)
        trajs = result_class[c]
        scores = np.array([t[1] for t in trajs])
        order = np.argsort(-scores)
        tp = np.zeros(len(trajs))
        fp = np.zeros(len(trajs))
        for d, idx in enumerate(order):
            vid, _, pred_traj = trajs[idx]
            rec = class_recs.get(vid, {"trajectories": [], "det": []})
            ov, oi = trajectory_overlap(rec["trajectories"], pred_traj)
            if ov >= thresh_t and not rec["det"][oi]:
                tp[d] = 1.0
                rec["det"][oi] = True
            else:
                fp[d] = 1.0
        fp, tp = np.cumsum(fp), np.cumsum(tp)
        rec_curve = tp / float(max(npos, 1))
        prec = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
        ap_class[c] = voc_ap(rec_curve, prec, use_07_metric)

    ap_sorted = sorted(ap_class.items())
    mean_ap = sum(ap for _, ap in ap_sorted) / max(len(gt_classes), 1)
    return mean_ap, ap_sorted


def record_to_traj_dicts(cat_ids, durations, boxes, id2name, scores=None):
    """Per-video records -> {fid: box} trajectory dicts (closed durations)."""
    out = []
    for i in range(len(boxes)):
        dura = durations[i]
        frame_ids = range(int(dura[0]), int(dura[1]) + 1)
        traj = {fid: list(map(float, b[:4]))
                for fid, b in zip(frame_ids, boxes[i])}
        d = {"category": id2name[int(cat_ids[i])], "trajectory": traj}
        if scores is not None:
            d["score"] = float(scores[i])
        out.append(d)
    return out
