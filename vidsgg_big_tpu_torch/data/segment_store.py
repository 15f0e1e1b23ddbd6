"""Per-segment relation-feature store for the MM'17 segment baseline.

A copy of the JAX package's ``data/segment_store.py``: the same files, and a
synthetic writer whose numpy draws follow JAX's call for call, so one seed
and config write equal arrays and equal JSON in both packages.

The reference baseline consumes *precomputed* per-segment artifacts — object
trajectory proposals (dlib-tracked, reference
VidVRD-helper/baseline/trajectory.py:161-180) and pair relation features
(h5 files with ``pairs/feats/iou/trackid``, reference
baseline/feature.py:118-142); the code that produces them is offline and not
part of the repo, exactly like the MEGA/deepSORT tracklets of the main
models.  This module is the equivalent contract: one ``.npz`` per
(video, segment) holding

  pairs     (P, 2)   int    ordered proposal-index pairs
  feats     (P, D)   f32    raw relation features (preprocess at load)
  iou       (N, N)   f32    segment trajectory IoU (proposals + GT rows)
  trackid   (N,)     int    GT track id per row, -1 for proposals
  traj_rois (N, 30, 4) f32  per-row segment boxes (ltrb)
  traj_cats (N,)     int    per-row category (for debugging/visualization)
  gt_insts  (K, 5)   int    (tid1, tid2, s_cid, pid, o_cid) active here

plus ``index.json`` (per split: video -> frame_count + segment list) and
``gt.json`` (challenge-format GT for evaluation).  A synthetic writer
fabricates a learnable dataset in this exact layout for smoke tests.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

import numpy as np

from ..evaluation.association import (segment_video, get_segment_signature,
                                      cubic_iou)
from ..models.segment_baseline import SegmentBaselineConfig


class SegmentStore:
    def __init__(self, root: str):
        self.root = root
        with open(os.path.join(root, "index.json")) as f:
            self.index = json.load(f)
        with open(os.path.join(root, "config.json")) as f:
            self.cfg = SegmentBaselineConfig.from_dict(json.load(f))

    def splits(self):
        return sorted(self.index)

    def segments(self, split: str) -> List[Tuple[str, int, int]]:
        out = []
        for vid, info in sorted(self.index[split].items()):
            out += [(vid, fs, fe) for fs, fe in info["segments"]]
        return out

    def load(self, vid: str, fstart: int, fend: int) -> dict:
        path = os.path.join(self.root, vid,
                            get_segment_signature(vid, fstart, fend) + ".npz")
        with np.load(path) as z:
            return {k: z[k] for k in z.files}

    def groundtruth(self) -> dict:
        with open(os.path.join(self.root, "gt.json")) as f:
            return json.load(f)

    def observed_train_triplets(self) -> np.ndarray:
        """Ordered unique (s, p, o) over the train split's GT instances
        (reference model.py:66-75 builds the same from dataset.get_triplets)."""
        seen = {}
        for vid, fs, fe in self.segments("train"):
            for tid1, tid2, s, p, o in self.load(vid, fs, fe)["gt_insts"]:
                seen.setdefault((int(s), int(p), int(o)), len(seen))
        trips = sorted(seen, key=seen.get)
        return np.asarray(trips, np.int64).reshape(-1, 3)


def _random_walk_boxes(rng, n_frames, wh=(320, 240)):
    w, h = wh
    bw, bh = rng.uniform(30, 90), rng.uniform(30, 90)
    cx, cy = rng.uniform(bw, w - bw), rng.uniform(bh, h - bh)
    boxes = np.empty((n_frames, 4), np.float32)
    for t in range(n_frames):
        cx = np.clip(cx + rng.normal(0, 2.0), bw / 2, w - bw / 2)
        cy = np.clip(cy + rng.normal(0, 2.0), bh / 2, h - bh / 2)
        boxes[t] = (cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2)
    return boxes


def _classeme(rng, cat, n_cats):
    v = rng.uniform(0, 0.05, n_cats).astype(np.float32)
    v[cat] += 0.8
    return v / v.sum()


def write_synthetic_segments(root: str, n_videos: int = 6,
                             n_test_videos: int = 3, seed: int = 0,
                             cfg: SegmentBaselineConfig = None) -> str:
    """Fabricate a small learnable dataset in the store layout.

    Positive pairs carry their predicate's signature in the first
    relative-position block (which the preprocess leaves unnormalized), so a
    linear model can fit it; classemes encode the category.
    """
    if cfg is None:
        cfg = SegmentBaselineConfig(
            feature_dim=2 * 6 + (8 + 3) * 16, num_obj_cats=6,
            num_pred_cats=8, block_size=16, pair_topk=5, seg_topk=60)
    nc, npred, blk = cfg.num_obj_cats, cfg.num_pred_cats, cfg.block_size
    assert npred <= blk, "predicate signature must fit in one block"
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    index: Dict[str, dict] = {"train": {}, "test": {}}
    gt_json: Dict[str, list] = {}

    for v in range(n_videos + n_test_videos):
        split = "train" if v < n_videos else "test"
        vid = f"synthetic_{split}_{v:04d}"
        n_frames = int(rng.integers(60, 136))
        n_objs = int(rng.integers(3, 6))
        cats = rng.integers(0, nc, n_objs)
        trajs = [_random_walk_boxes(rng, n_frames) for _ in range(n_objs)]
        rels = []
        for _ in range(int(rng.integers(2, 5))):
            t1, t2 = rng.choice(n_objs, 2, replace=False)
            pid = int(rng.integers(0, npred))
            # Align durations to the 15-frame segment grid so relations
            # land on segment_video(0, n_frames)'s windows (unaligned
            # durations matched only when lo % 15 == 0, leaving the
            # synthetic train split nearly labelless).
            lo = 15 * int(rng.integers(0, (n_frames - 30) // 15 + 1))
            hi = lo + 15 * int(rng.integers(2, (n_frames - lo) // 15 + 1))
            rels.append((int(t1), int(t2), int(cats[t1]), pid,
                         int(cats[t2]), lo, hi))

        segs = segment_video(0, n_frames)
        index[split][vid] = {"frame_count": n_frames, "segments": segs}
        os.makedirs(os.path.join(root, vid), exist_ok=True)
        gt_json[vid] = [{
            "triplet": [int(s), int(p), int(o)],   # ids; names applied later
            "duration": [lo, hi],
            "sub_traj": trajs[t1][lo:hi].tolist(),
            "obj_traj": trajs[t2][lo:hi].tolist(),
        } for (t1, t2, s, p, o, lo, hi) in rels]

        for fs, fe in segs:
            # proposals: jittered GT + distractors, then exact GT rows
            rows, row_cats, trackid, src_tid = [], [], [], []
            for tid in range(n_objs):
                rows.append(trajs[tid][fs:fe] +
                            rng.normal(0, 1.5, (fe - fs, 4)).astype(np.float32))
                row_cats.append(cats[tid])
                trackid.append(-1)
                src_tid.append(tid)
            for _ in range(int(rng.integers(1, 3))):
                rows.append(_random_walk_boxes(rng, fe - fs))
                row_cats.append(int(rng.integers(0, nc)))
                trackid.append(-1)
                src_tid.append(-1)
            for tid in range(n_objs):
                rows.append(trajs[tid][fs:fe])
                row_cats.append(cats[tid])
                trackid.append(tid)
                src_tid.append(tid)
            traj_rois = np.stack(rows)                       # (N, 30, 4)
            n = len(rows)
            iou = cubic_iou(traj_rois, traj_rois).astype(np.float32)

            # A relation is active in every segment its duration covers
            # (with grid-aligned lo this equals membership in
            # segment_video(lo, hi), the reference's association rule).
            active = [(t1, t2, s, p, o) for (t1, t2, s, p, o, lo, hi) in rels
                      if fs >= lo and fe <= hi]
            pairs = np.asarray([(i, j) for i in range(n) for j in range(n)
                                if i != j], np.int64)
            feats = np.zeros((len(pairs), cfg.feature_dim), np.float32)
            clsm = np.stack([_classeme(rng, c, nc) for c in row_cats])
            feats[:, :nc] = clsm[pairs[:, 0]]
            feats[:, nc:2 * nc] = clsm[pairs[:, 1]]
            feats[:, 2 * nc:] = np.abs(
                rng.normal(0, 0.3, (len(pairs), feats.shape[1] - 2 * nc)))
            relpos0 = 2 * nc + 8 * blk                       # 1st relpos block
            for k, (i, j) in enumerate(pairs):
                for (t1, t2, s, p, o) in active:
                    if src_tid[i] == t1 and src_tid[j] == t2:
                        feats[k, relpos0 + p] += 3.0
            gt_insts = np.asarray(active, np.int64).reshape(-1, 5)
            np.savez_compressed(
                os.path.join(root, vid,
                             get_segment_signature(vid, fs, fe) + ".npz"),
                pairs=pairs, feats=feats, iou=iou,
                trackid=np.asarray(trackid, np.int64),
                traj_rois=traj_rois,
                traj_cats=np.asarray(row_cats, np.int64),
                gt_insts=gt_insts)

    with open(os.path.join(root, "index.json"), "w") as f:
        json.dump(index, f)
    with open(os.path.join(root, "gt.json"), "w") as f:
        json.dump(gt_json, f)
    with open(os.path.join(root, "config.json"), "w") as f:
        json.dump(cfg.__dict__, f)
    return root
