"""Tracklet `.npy` row-format parsers and GT annotation-JSON builders.

A copy of the JAX package's ``data/parse.py``: the same rows give the same
records field for field.  The fast parsers group rows through the port's
host packer (``data/native.py``, built with g++ at first use).

Row formats (see reference tracking_results/format_demo.py:1-26):
  * "mega" (ours): rows of len 6 (background: [fid, tid, tracklet_xywh]) or
    12+D ([fid, tid, tracklet_xywh, conf, cat_id, det_xywh, roi_feat]); the
    per-frame box is the *average* of tracklet and detector boxes
    (reference dataloaders/dataloader_vidvrd.py:236-325).
  * "pku": all rows 12+D; cat_id <= 0 marks background rows
    (reference dataloader_vidvrd.py:485-575); "pku_i3d" adds a parallel i3d
    `.npy` whose row idx aligns with the tracklet rows
    (reference dataloader_vidvrd.py:578-686).
  * "vidor": rows of len 6 are skipped entirely; per-frame box is the
    tracklet box; RoI features are concatenated with per-row classeme
    vectors (reference dataloader_vidor_v3.py:394-484).

GT annotation JSONs share one schema across VidVRD/VidOR
(reference dataloader_vidvrd.py:327-455, dataloader_vidor_v3.py:487-621).
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, Optional

import numpy as np

from ..ops.temporal import is_overlap, merge_duration_list
from . import native
from .interpolate import linear_interpolation
from .types import VideoProposalRecord, VideoGTRecord


def _check_row_len(n: int, allowed) -> None:
    if n not in allowed:
        raise ValueError(f"tracklet row of length {n}, expected one of "
                         f"{tuple(allowed)}")


def _finalize_trajs(trajs: Dict, min_frames_th: int):
    """Shared tail of every parser: majority category, short->background,
    gap interpolation; returns per-tid dicts with contiguous arrays."""
    for tid, tr in trajs.items():
        if len(tr["category_id"]) == 0:
            tr["category_id"] = 0
        else:
            tr["category_id"] = int(np.argmax(np.bincount(tr["category_id"])))
        frame_ids = tr["frame_ids"]
        start, end = min(frame_ids), max(frame_ids) + 1
        dura_len = end - start
        tr["bboxes"] = np.asarray(tr["bboxes"], dtype=np.float64)
        tr["features"] = np.asarray(tr["features"], dtype=np.float64)
        if len(frame_ids) < min_frames_th:
            tr["category_id"] = 0
        else:
            tr["duration"] = (start, end)
        if tr["category_id"] != 0 and len(frame_ids) != dura_len:
            tr["features"] = linear_interpolation(tr["features"], frame_ids)
            tr["bboxes"] = linear_interpolation(tr["bboxes"], frame_ids)
        if tr["category_id"] != 0:
            assert len(tr["bboxes"]) == dura_len
    return trajs


def _collect(trajs: Dict):
    cat_ids, boxes, feats, durations = [], [], [], []
    for tid, tr in trajs.items():
        if tr["category_id"] == 0:
            continue
        cat_ids.append(tr["category_id"])
        boxes.append(tr["bboxes"])
        feats.append(tr["features"])
        durations.append(tr["duration"])
    return cat_ids, boxes, feats, durations


def parse_tracklets_mega(track_res, dim_boxfeature: int, min_frames_th: int):
    trajs: Dict = {b[1]: None for b in track_res}
    for tid in trajs:
        trajs[tid] = dict(frame_ids=[], bboxes=[], features=[],
                          category_id=[])
    for box_info in track_res:
        if not isinstance(box_info, list):
            box_info = box_info.tolist()
        _check_row_len(len(box_info), (6, 12 + dim_boxfeature))
        frame_id, tid = box_info[0], box_info[1]
        xmin_t, ymin_t, w_t, h_t = box_info[2:6]
        bbox_t = [xmin_t, ymin_t, xmin_t + w_t, ymin_t + h_t]
        if len(box_info) == 6:
            trajs[tid]["bboxes"].append(bbox_t + [0.0])
            trajs[tid]["features"].append([0.0] * dim_boxfeature)
        else:
            conf, cat_id = box_info[6], box_info[7]
            xmin, ymin, w, h = box_info[8:12]
            bbox = [(xmin + bbox_t[0]) / 2, (ymin + bbox_t[1]) / 2,
                    (xmin + w + bbox_t[2]) / 2, (ymin + h + bbox_t[3]) / 2]
            trajs[tid]["category_id"].append(cat_id)
            trajs[tid]["features"].append(box_info[12:])
            trajs[tid]["bboxes"].append(bbox + [conf])
        trajs[tid]["frame_ids"].append(frame_id)
    return _collect(_finalize_trajs(trajs, min_frames_th))


def parse_tracklets_pku(track_res, dim_boxfeature: int, min_frames_th: int,
                        i3d_features: Optional[np.ndarray] = None,
                        dim_i3d: int = 0, zero_i3d: bool = False):
    trajs: Dict = {int(b[1]): None for b in track_res}
    for tid in trajs:
        trajs[tid] = dict(frame_ids=[], bboxes=[], features=[], i3d=[],
                          category_id=[])
    for idx, box_info in enumerate(track_res):
        if not isinstance(box_info, list):
            box_info = box_info.tolist()
        _check_row_len(len(box_info), (12 + dim_boxfeature,))
        frame_id, tid = int(box_info[0]), int(box_info[1])
        xmin_t, ymin_t, w_t, h_t = box_info[2:6]
        bbox_t = [xmin_t, ymin_t, xmin_t + w_t, ymin_t + h_t]
        confidence = box_info[6]
        cat_id = int(box_info[7])
        if cat_id <= 0:
            bbox = bbox_t + [0.0]
            roi = [0.0] * dim_boxfeature
            i3d = [0.0] * dim_i3d
        else:
            xmin, ymin, w, h = box_info[8:12]
            bbox = [(xmin + bbox_t[0]) / 2, (ymin + bbox_t[1]) / 2,
                    (xmin + w + bbox_t[2]) / 2, (ymin + h + bbox_t[3]) / 2,
                    confidence]
            roi = box_info[12:]
            i3d = (list(i3d_features[idx][12:]) if i3d_features is not None
                   else [0.0] * dim_i3d)
            trajs[tid]["category_id"].append(cat_id)
        if zero_i3d:
            i3d = [0.0] * dim_i3d
        trajs[tid]["bboxes"].append(bbox)
        trajs[tid]["i3d"].append(i3d)
        trajs[tid]["features"].append(roi)
        trajs[tid]["frame_ids"].append(frame_id)
    if dim_i3d:
        for tid, tr in trajs.items():
            roi = np.asarray(tr["features"], np.float64)
            i3d = np.asarray(tr["i3d"], np.float64)
            tr["features"] = np.concatenate([roi, i3d], axis=-1)
    for tr in trajs.values():
        tr.pop("i3d", None)
    return _collect(_finalize_trajs(trajs, min_frames_th))


def parse_tracklets_vidor(track_res, classeme: Optional[np.ndarray],
                          dim_boxfeature: int, min_frames_th: int):
    trajs: Dict = {b[1]: None for b in track_res}
    for tid in trajs:
        trajs[tid] = dict(frame_ids=[], bboxes=[], features=[], clsme=[],
                          category_id=[])
    for idx, box_info in enumerate(track_res):
        if not isinstance(box_info, list):
            box_info = box_info.tolist()
        _check_row_len(len(box_info), (6, 12 + dim_boxfeature))
        if len(box_info) == 6:
            continue
        frame_id, tid = box_info[0], box_info[1]
        xmin_t, ymin_t, w_t, h_t = box_info[2:6]
        confidence = box_info[6]
        trajs[tid]["bboxes"].append(
            [xmin_t, ymin_t, xmin_t + w_t, ymin_t + h_t, confidence])
        trajs[tid]["category_id"].append(int(box_info[7]))
        trajs[tid]["features"].append(box_info[12:])
        trajs[tid]["frame_ids"].append(frame_id)
        if classeme is not None:
            trajs[tid]["clsme"].append(classeme[idx])
    # drop tids that only had len-6 rows
    trajs = {k: v for k, v in trajs.items() if len(v["frame_ids"]) > 0}
    if classeme is not None:
        for tr in trajs.values():
            roi = np.asarray(tr["features"], np.float64)
            cl = np.asarray(tr["clsme"], np.float64)
            tr["features"] = np.concatenate([roi, cl], axis=-1)
    for tr in trajs.values():
        tr.pop("clsme", None)
    return _collect(_finalize_trajs(trajs, min_frames_th))


def build_proposal_record(video_name: str, parsed, max_proposal: int,
                          score_th: Optional[float] = None,
                          video_len: int = 0, video_wh=(0, 0)
                          ) -> VideoProposalRecord:
    """Score clipping + top-k truncation -> host record (reference
    dataloader_vidvrd.py:30-52 / dataloader_vidor_v3.py:33-68)."""
    cat_ids, boxes_with_score, feats, durations = parsed
    scores = [float(np.mean(b[:, 4])) for b in
              (np.asarray(bb, np.float64) for bb in boxes_with_score)]
    boxes = [np.asarray(bb, np.float32)[:, :4] for bb in boxes_with_score]
    cat_ids = np.asarray(cat_ids, np.int32)
    scores = np.asarray(scores, np.float32)
    durations = np.asarray(durations, np.int64).reshape(-1, 2).copy()
    durations[:, 1] -= 1    # closed interval
    keep = np.arange(len(boxes))
    if score_th is not None:
        keep = keep[scores > score_th]
    keep = keep[np.argsort(-scores[keep], kind="stable")][:max_proposal]
    return VideoProposalRecord(
        video_name=video_name, video_len=video_len, video_wh=tuple(video_wh),
        cat_ids=cat_ids[keep], scores=scores[keep],
        durations=durations[keep].astype(np.int32),
        boxes=[boxes[i] for i in keep],
        features=[np.asarray(feats[i], np.float32) for i in keep])


def parse_gt_annotation(video_name: str, video_anno: dict,
                        enti_name2id: Dict[str, int],
                        pred_name2id: Dict[str, int],
                        max_preds: int = 0,
                        truncate: bool = False) -> VideoGTRecord:
    """Annotation JSON -> GT record (shared VidVRD/VidOR schema)."""
    video_len = len(video_anno["trajectories"])
    video_wh = (video_anno["width"], video_anno["height"])

    traj_categories = video_anno["subject/objects"]
    tid2category = {t["tid"]: t["category"] for t in traj_categories}
    trajs = {t["tid"]: dict(all_bboxes=[], frame_ids=[]) for t in
             traj_categories}
    for frame_id, frame_anno in enumerate(video_anno["trajectories"]):
        for bbox_anno in frame_anno:
            tid = bbox_anno["tid"]
            b = bbox_anno["bbox"]
            trajs[tid]["all_bboxes"].append(
                [b["xmin"], b["ymin"], b["xmax"], b["ymax"]])
            trajs[tid]["frame_ids"].append(frame_id)
            trajs[tid]["category_id"] = enti_name2id[tid2category[tid]]

    traj_cat_ids, traj_durations, traj_bboxes = [], [], []
    tid2idx = {}
    for idx, (tid, tr) in enumerate(trajs.items()):
        frame_ids = tr["frame_ids"]
        start, end = min(frame_ids), max(frame_ids) + 1
        boxes = linear_interpolation(
            np.asarray(tr["all_bboxes"], np.float64), frame_ids)
        traj_cat_ids.append(tr["category_id"])
        traj_durations.append((start, end))
        traj_bboxes.append(boxes.astype(np.float32))
        tid2idx[tid] = idx
    traj_cat_ids = np.asarray(traj_cat_ids, np.int32)
    traj_durations = np.asarray(traj_durations, np.int64).reshape(-1, 2)
    num_trajs = len(traj_cat_ids)

    # merge fragmented relation durations
    trituple2durations = defaultdict(list)
    for pred in video_anno["relation_instances"]:
        key = (pred["subject_tid"], pred["predicate"], pred["object_tid"])
        trituple2durations[key].append((pred["begin_fid"], pred["end_fid"]))
    pred_cat_ids, pred_durations, trituples = [], [], []
    for key, durations in trituple2durations.items():
        merged = merge_duration_list(durations)
        for duration in merged:
            trituples.append(key)
            pred_cat_ids.append(pred_name2id[key[1]])
            pred_durations.append(duration)
    num_preds = len(pred_cat_ids)
    pred_durations = np.asarray(pred_durations, np.int64).reshape(-1, 2)

    adj_s = np.zeros((num_preds, num_trajs), np.float32)
    adj_o = np.zeros((num_preds, num_trajs), np.float32)
    for idx, (subj_tid, _, obj_tid) in enumerate(trituples):
        pd = tuple(pred_durations[idx])
        si, oi = tid2idx[subj_tid], tid2idx[obj_tid]
        if is_overlap(pd, tuple(traj_durations[si])):
            adj_s[idx, si] = 1
        if is_overlap(pd, tuple(traj_durations[oi])):
            adj_o[idx, oi] = 1
    if not ((adj_s.sum(-1) == 1).all() and (adj_o.sum(-1) == 1).all()):
        raise ValueError(f"video {video_name}: a relation overlaps no "
                         "subject or object trajectory")

    rec = VideoGTRecord(
        video_name=video_name, video_len=video_len, video_wh=video_wh,
        traj_cat_ids=traj_cat_ids,
        traj_durations=(traj_durations - np.array([0, 1])).astype(np.int32),
        traj_boxes=traj_bboxes,
        pred_cat_ids=np.asarray(pred_cat_ids, np.int32),
        pred_durations=(pred_durations - np.array([0, 1])).astype(np.float32),
        adj=np.stack([adj_s, adj_o], axis=0))
    if truncate and max_preds and rec.num_preds > max_preds:
        rec = VideoGTRecord(
            video_name=rec.video_name, video_len=rec.video_len,
            video_wh=rec.video_wh, traj_cat_ids=rec.traj_cat_ids,
            traj_durations=rec.traj_durations, traj_boxes=rec.traj_boxes,
            pred_cat_ids=rec.pred_cat_ids[:max_preds],
            pred_durations=rec.pred_durations[:max_preds],
            adj=rec.adj[:, :max_preds])
    return rec


def _bulk_rows(track_res, picks):
    """Bulk-convert a subset of ragged rows into one float64 matrix (the
    single O(R) python pass an object-dtype .npy costs; everything after is
    whole-array numpy)."""
    if picks.size == 0:
        return np.zeros((0, 0), np.float64)
    return np.asarray([list(track_res[i]) for i in picks], np.float64)


def _fast_tail(rows, bboxes5, feats, vote_mask, off, tids, min_frames_th):
    """Shared per-trajectory tail of the fast parsers: majority category
    (over rows where ``vote_mask``), short->background, gap interpolation.
    Matches _finalize_trajs + _collect; trajectories come out tid-sorted
    (real tracker .npy files are (tid, fid)-sorted already)."""
    cat_ids, out_boxes, out_feats, durations = [], [], [], []
    for g in range(len(tids)):
        s, e = off[g], off[g + 1]
        votes = rows[s:e, 7][vote_mask[s:e]].astype(np.int64)
        if votes.size == 0 or (e - s) < min_frames_th:
            continue
        cat = int(np.argmax(np.bincount(votes)))
        if cat == 0:
            continue
        frame_ids = rows[s:e, 0].astype(np.int64)
        b = bboxes5[s:e]
        f = feats[s:e]
        if frame_ids[-1] - frame_ids[0] + 1 != e - s:
            b = linear_interpolation(b, frame_ids)
            f = linear_interpolation(f, frame_ids)
        cat_ids.append(cat)
        out_boxes.append(b)
        out_feats.append(f)
        durations.append((int(frame_ids[0]), int(frame_ids[-1]) + 1))
    return cat_ids, out_boxes, out_feats, durations


def parse_tracklets_mega_fast(track_res, dim_boxfeature: int,
                              min_frames_th: int):
    """Vectorized fast path for mega-format rows (reference
    dataloader_vidvrd.py:236-325): len-6 background rows keep the tracklet
    box with zero conf/features; len-12+D rows average tracklet and detector
    boxes and vote on the category.  Behavior parity with
    :func:`parse_tracklets_mega` on (tid, fid)-sorted inputs; handles both
    uniform (R, 12+D) float arrays and object arrays of mixed row lengths.
    """
    c = 12 + dim_boxfeature
    if isinstance(track_res, np.ndarray) and track_res.ndim == 2 and \
            track_res.dtype != object:
        _check_row_len(track_res.shape[1], (6, c))
        if track_res.shape[1] == 6:          # all-background file
            rows = np.zeros((track_res.shape[0], c), np.float64)
            rows[:, :6] = track_res
            is_full = np.zeros(rows.shape[0], bool)
        else:
            rows = np.asarray(track_res, np.float64)
            is_full = np.ones(rows.shape[0], bool)
    else:
        lens = np.fromiter((len(r) for r in track_res), np.int64,
                           len(track_res))
        for n in set(lens.tolist()):
            _check_row_len(n, (6, c))
        rows = np.zeros((len(track_res), c), np.float64)
        i6 = np.flatnonzero(lens == 6)
        ifull = np.flatnonzero(lens == c)
        if i6.size:
            rows[i6, :6] = _bulk_rows(track_res, i6)
        if ifull.size:
            rows[ifull] = _bulk_rows(track_res, ifull)
        is_full = lens == c
    if rows.shape[0] == 0:
        return [], [], [], []
    order, off, tids = native.group_tracklet_rows(rows)
    rows = rows[order]
    is_full = is_full[order]

    tl = rows[:, 2:6].copy()
    tl[:, 2] += tl[:, 0]
    tl[:, 3] += tl[:, 1]                                  # tracklet xyxy
    det = rows[:, 8:12].copy()
    det[:, 2] += det[:, 0]
    det[:, 3] += det[:, 1]                                # detector xyxy
    boxes = np.where(is_full[:, None], (tl + det) / 2, tl)
    conf = np.where(is_full, rows[:, 6], 0.0)
    bboxes5 = np.concatenate([boxes, conf[:, None]], axis=1)
    feats = np.where(is_full[:, None], rows[:, 12:], 0.0)
    return _fast_tail(rows, bboxes5, feats, is_full, off, tids,
                      min_frames_th)


def parse_tracklets_vidor_fast(track_res, classeme: Optional[np.ndarray],
                               dim_boxfeature: int, min_frames_th: int):
    """Vectorized fast path for vidor-format rows (reference
    dataloader_vidor_v3.py:394-484): len-6 rows are skipped entirely, the
    per-frame box is the tracklet box, RoI features are concatenated with
    the per-ORIGINAL-row classeme vectors.  Behavior parity with
    :func:`parse_tracklets_vidor` on (tid, fid)-sorted inputs."""
    c = 12 + dim_boxfeature
    if isinstance(track_res, np.ndarray) and track_res.ndim == 2 and \
            track_res.dtype != object:
        _check_row_len(track_res.shape[1], (6, c))
        if track_res.shape[1] == 6:
            return [], [], [], []
        rows = np.asarray(track_res, np.float64)
        orig_idx = np.arange(rows.shape[0])
    else:
        lens = np.fromiter((len(r) for r in track_res), np.int64,
                           len(track_res))
        for n in set(lens.tolist()):
            _check_row_len(n, (6, c))
        orig_idx = np.flatnonzero(lens == c)
        rows = _bulk_rows(track_res, orig_idx)
    if rows.shape[0] == 0:
        return [], [], [], []
    order, off, tids = native.group_tracklet_rows(rows)
    rows = rows[order]

    tl = rows[:, 2:6].copy()
    tl[:, 2] += tl[:, 0]
    tl[:, 3] += tl[:, 1]
    bboxes5 = np.concatenate([tl, rows[:, 6:7]], axis=1)
    feats = rows[:, 12:]
    if classeme is not None:
        cl = np.asarray(classeme, np.float64)[orig_idx][order]
        feats = np.concatenate([feats, cl], axis=1)
    all_rows = np.ones(rows.shape[0], bool)
    return _fast_tail(rows, bboxes5, feats, all_rows, off, tids,
                      min_frames_th)


def parse_tracklets_pku_fast(track_res: np.ndarray, dim_boxfeature: int,
                             min_frames_th: int,
                             i3d_features: Optional[np.ndarray] = None,
                             dim_i3d: int = 0, zero_i3d: bool = False):
    """Vectorized fast path for uniform (R, 12+D) pku-format arrays.

    Exact behavior parity with :func:`parse_tracklets_pku` on (tid,
    fid)-sorted inputs; the per-row python loop is replaced by one
    group-by-tid sort in the packer library plus whole-array numpy column
    math.
    """
    if track_res.ndim != 2:
        raise ValueError(f"pku rows must be one 2-D array, not "
                         f"{track_res.shape}")
    _check_row_len(track_res.shape[1], (12 + dim_boxfeature,))
    r = track_res.shape[0]
    order, off, tids = native.group_tracklet_rows(track_res)
    rows = np.asarray(track_res, np.float64)[order]      # (R, C) sorted

    fg = rows[:, 7] > 0                                   # cat_id > 0
    tl = rows[:, 2:6].copy()
    tl[:, 2] += tl[:, 0]
    tl[:, 3] += tl[:, 1]                                  # tracklet xyxy
    det = rows[:, 8:12].copy()
    det[:, 2] += det[:, 0]
    det[:, 3] += det[:, 1]                                # detector xyxy
    boxes = np.where(fg[:, None], (tl + det) / 2, tl)     # (R, 4)
    conf = np.where(fg, rows[:, 6], 0.0)
    bboxes5 = np.concatenate([boxes, conf[:, None]], axis=1)
    feats = np.where(fg[:, None], rows[:, 12:], 0.0)
    if dim_i3d:
        if i3d_features is not None and not zero_i3d:
            i3d = np.asarray(i3d_features, np.float64)[order][:, 12:]
            i3d = np.where(fg[:, None], i3d, 0.0)
        else:
            i3d = np.zeros((r, dim_i3d))
        feats = np.concatenate([feats, i3d], axis=1)

    cat_ids, out_boxes, out_feats, durations = [], [], [], []
    for g in range(len(tids)):
        s, e = off[g], off[g + 1]
        cats = rows[s:e, 7].astype(np.int64)
        cats = cats[cats > 0]
        if cats.size == 0 or (e - s) < min_frames_th:
            continue
        cat = int(np.argmax(np.bincount(cats)))
        frame_ids = rows[s:e, 0].astype(np.int64)
        b = bboxes5[s:e]
        f = feats[s:e]
        if frame_ids[-1] - frame_ids[0] + 1 != e - s:
            b = linear_interpolation(b, frame_ids)
            f = linear_interpolation(f, frame_ids)
        cat_ids.append(cat)
        out_boxes.append(b)
        out_feats.append(f)
        durations.append((int(frame_ids[0]), int(frame_ids[-1]) + 1))
    return cat_ids, out_boxes, out_feats, durations
