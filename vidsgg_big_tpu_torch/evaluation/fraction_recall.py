"""Fraction recall: recall over GT 5-tuples, crediting fractional hits of
multi-duration instances (paper table 6).

A copy of the JAX package's ``evaluation/fraction_recall.py`` on the port's
``VideoGTRecord`` (behavior-parity with reference
tools/eval_fraction_recall.py:14-178): per video, group GT predicates by
their (pred, sub_cat, obj_cat, s_id, o_id) 5-tuple; each group contributes
#hits(<=k)/group_size; report recall at several k, both video-level (mean
of per-video recalls) and dataset-level (global ratio), and split into
"single"/"multiple"-duration instance subsets.
"""
from __future__ import annotations

from collections import defaultdict

import numpy as np

from ..data.types import VideoGTRecord

N_RECALLS = (50, 100, 150, 1000)


def gt_5tuples(gt: VideoGTRecord) -> np.ndarray:
    """(P, 5): [pred_cat, sub_cat, obj_cat, s_id, o_id]."""
    if gt.num_trajs == 0 or gt.num_preds == 0:
        return np.zeros((0, 5), np.int64)
    pred2so = gt.adj.argmax(-1).transpose(1, 0)      # (P, 2)
    so_cats = gt.traj_cat_ids[pred2so]
    return np.concatenate(
        [gt.pred_cat_ids[:, None], so_cats, pred2so], axis=-1).astype(
        np.int64)


def _groups(tuples: np.ndarray):
    g = defaultdict(list)
    for i, row in enumerate(tuples.tolist()):
        g[tuple(row)].append(i)
    return list(g.values())


def calculate_n_hits(tuples, gt2hit_ids, n_recalls=N_RECALLS):
    """Returns (#unique 5-tuples, {k: fractional hit count})."""
    if tuples.shape[0] == 0:
        return 0, {k: 0.0 for k in n_recalls}
    groups = _groups(tuples)
    n_hits = {}
    for k in n_recalls:
        h = 0.0
        for im in groups:
            ids = gt2hit_ids[im]
            h += float(((ids >= 0) & (ids <= k)).sum()) / len(im)
        n_hits[k] = h
    return len(groups), n_hits


def fraction_recall(gt_records, hit_infos, n_recalls=N_RECALLS,
                    reset_name=None):
    """gt_records: iterable of VideoGTRecord; hit_infos:
    {video: (hit_scores, gt2hit_ids)} from the relation eval.

    Returns dict with video-level and dataset-level recalls for overall /
    single-duration / multiple-duration subsets.
    """
    subsets = ("overall", "single", "multiple")
    total_hit = {s: {k: 0.0 for k in n_recalls} for s in subsets}
    total_gt = {s: 0 for s in subsets}
    per_video = {s: {k: [] for k in n_recalls} for s in subsets}

    for gt in gt_records:
        name = gt.video_name if reset_name is None else reset_name(
            gt.video_name)
        if name not in hit_infos:
            continue
        tuples = gt_5tuples(gt)
        _, gt2hit_ids = hit_infos[name]
        gt2hit_ids = np.asarray(gt2hit_ids)

        groups = _groups(tuples)
        singles = [i for im in groups if len(im) == 1 for i in im]
        multiples = [i for im in groups if len(im) > 1 for i in im]
        for subset, ids in (("overall", slice(None)), ("single", singles),
                            ("multiple", multiples)):
            tu = tuples[ids]
            hi = gt2hit_ids[ids]
            n_gt, n_hits = calculate_n_hits(tu, hi, n_recalls)
            total_gt[subset] += n_gt
            for k, v in n_hits.items():
                total_hit[subset][k] += v
                if n_gt > 0:
                    per_video[subset][k].append(v / n_gt)

    out = {"video_level": {}, "dataset_level": {}}
    for s in subsets:
        out["video_level"][s] = {
            k: float(np.mean(v)) if v else 0.0
            for k, v in per_video[s].items()}
        out["dataset_level"][s] = {
            k: (total_hit[s][k] / total_gt[s]) if total_gt[s] else 0.0
            for k in n_recalls}
    return out
