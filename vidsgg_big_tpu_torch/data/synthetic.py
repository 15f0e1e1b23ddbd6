"""Synthetic video scene-graph data for tests and benchmarks.

Generates structurally-faithful random videos: tracklet proposals with RoI
features, ground-truth trajectories, and predicate instances whose adjacency
one-hots mirror the real annotation contract (row sums == 1, predicate
durations inside subject∩object overlap — reference
dataloaders/dataloader_vidvrd.py:327-455).  Proposals are noisy copies of GT
trajectories plus distractors so that vIoU-based alignment has real signal.

A copy of the JAX package's ``data/synthetic.py``: the same seed gives
byte-identical records in both packages.
"""
from __future__ import annotations

import numpy as np

from .types import VideoProposalRecord, VideoGTRecord


def _random_walk_boxes(rng, n_frames, wh):
    w, h = wh
    cx = rng.uniform(0.2, 0.8) * w
    cy = rng.uniform(0.2, 0.8) * h
    bw = rng.uniform(0.08, 0.3) * w
    bh = rng.uniform(0.08, 0.3) * h
    steps = rng.normal(0, 0.004 * w, size=(n_frames, 2)).cumsum(0)
    cxs = np.clip(cx + steps[:, 0], bw / 2, w - bw / 2)
    cys = np.clip(cy + steps[:, 1], bh / 2, h - bh / 2)
    boxes = np.stack(
        [cxs - bw / 2, cys - bh / 2, cxs + bw / 2, cys + bh / 2], axis=1)
    return boxes.astype(np.float32)


def make_video(seed: int, *, video_len: int = 120, n_gt_trajs: int = 5,
               n_preds: int = 8, n_distractors: int = 3, feat_dim: int = 64,
               num_enti_cats: int = 36, num_pred_cats: int = 133,
               wh=(640, 360), name: str | None = None):
    """Returns (VideoProposalRecord, VideoGTRecord)."""
    rng = np.random.default_rng(seed)
    name = name or f"synth_{seed:06d}"
    w, h = wh

    # --- GT trajectories ---
    traj_cats, traj_durs, traj_boxes = [], [], []
    for i in range(n_gt_trajs):
        s = int(rng.integers(0, max(1, video_len // 3)))
        e = int(rng.integers(s + video_len // 2, video_len))  # half-open end
        e = min(e, video_len)
        traj_cats.append(int(rng.integers(1, num_enti_cats)))
        traj_durs.append((s, e - 1))  # closed
        traj_boxes.append(_random_walk_boxes(rng, e - s, wh))
    traj_cats = np.asarray(traj_cats, np.int32)
    traj_durs = np.asarray(traj_durs, np.int32)

    # --- predicates: pick (s, o) pairs with temporal overlap ---
    pred_cats, pred_durs, adj_s, adj_o = [], [], [], []
    tries = 0
    while len(pred_cats) < n_preds and tries < 50 * n_preds:
        tries += 1
        si, oi = rng.choice(n_gt_trajs, size=2, replace=False)
        inter_s = max(traj_durs[si, 0], traj_durs[oi, 0])
        inter_e = min(traj_durs[si, 1], traj_durs[oi, 1])
        if inter_e - inter_s < 4:
            continue
        # real VidVRD/VidOR relations span most of the subject∩object
        # overlap; trim at most ~15% from each side so a stage-1 prediction
        # (whose temporal extent IS the overlap) can reach vIoU >= 0.5
        span = inter_e - inter_s
        ps = inter_s + int(rng.integers(0, max(span // 7, 1)))
        pe = inter_e - int(rng.integers(0, max(span // 7, 1)))
        pred_cats.append(int(rng.integers(1, num_pred_cats)))
        pred_durs.append((ps, pe))
        srow = np.zeros(n_gt_trajs, np.float32); srow[si] = 1
        orow = np.zeros(n_gt_trajs, np.float32); orow[oi] = 1
        adj_s.append(srow)
        adj_o.append(orow)
    p = len(pred_cats)
    adj = np.stack([np.stack(adj_s), np.stack(adj_o)], axis=0) if p else \
        np.zeros((2, 0, n_gt_trajs), np.float32)

    gt = VideoGTRecord(
        video_name=name, video_len=video_len, video_wh=wh,
        traj_cat_ids=traj_cats, traj_durations=traj_durs,
        traj_boxes=traj_boxes,
        pred_cat_ids=np.asarray(pred_cats, np.int32),
        pred_durations=np.asarray(pred_durs, np.float32).reshape(p, 2),
        adj=adj)

    # --- proposals: jittered GT + distractors ---
    cat_ids, scores, durs, boxes, feats = [], [], [], [], []
    for i in range(n_gt_trajs):
        s, e = traj_durs[i]
        ds = max(0, s + int(rng.integers(-5, 6)))
        de = min(video_len - 1, e + int(rng.integers(-5, 6)))
        if de - ds < 2:
            ds, de = int(s), int(e)
        L = de - ds + 1
        src = traj_boxes[i]
        idx = np.clip(np.arange(ds, de + 1) - s, 0, src.shape[0] - 1)
        noise = rng.normal(0, 0.01 * w, size=(L, 4)).astype(np.float32)
        boxes.append(src[idx] + noise)
        cat_ids.append(traj_cats[i])
        scores.append(float(rng.uniform(0.5, 1.0)))
        durs.append((ds, de))
        feats.append(rng.normal(0, 1, size=(L, feat_dim)).astype(np.float32))
    for _ in range(n_distractors):
        s = int(rng.integers(0, video_len - 10))
        e = int(rng.integers(s + 8, min(s + 60, video_len)))
        L = e - s
        boxes.append(_random_walk_boxes(rng, L, wh))
        cat_ids.append(int(rng.integers(1, num_enti_cats)))
        scores.append(float(rng.uniform(0.1, 0.6)))
        durs.append((s, e - 1))
        feats.append(rng.normal(0, 1, size=(L, feat_dim)).astype(np.float32))

    prop = VideoProposalRecord(
        video_name=name, video_len=video_len, video_wh=wh,
        cat_ids=np.asarray(cat_ids, np.int32),
        scores=np.asarray(scores, np.float32),
        durations=np.asarray(durs, np.int32),
        boxes=boxes, features=feats)
    return prop, gt


def make_dataset(n_videos: int, seed: int = 0, **kw):
    return [make_video(seed * 10_000 + i, **kw) for i in range(n_videos)]
