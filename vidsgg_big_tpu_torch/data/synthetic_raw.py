"""Write synthetic datasets in the reference's on-disk layout.

Port of the JAX package's ``data/synthetic_raw.py``: proposal ``.npy``
files (mega / pku / vidor row formats), annotation JSONs, classeme files
and I3D clip features, so that the on-disk pipeline (parsers, caches,
bucketing, training, eval) runs end to end without the VidVRD / VidOR data.
With the same arguments both packages write the same bytes; the rows are
built with whole-array numpy here (the same float64 values as JAX's row
loop).  ``recipe`` (``n_gt_trajs``, ``n_distractors``, ``n_preds``) is
forwarded to ``synthetic.make_video``: ``chip_smoke.py`` writes splits at
the full-size record recipes with it.
"""
from __future__ import annotations

import json
import os

import numpy as np

from ..utils import categories as cats
from .synthetic import make_video


def _annotation_from_gt(gt, dataset_type: str = "vidvrd") -> dict:
    frames = [[] for _ in range(gt.video_len)]
    entities = []
    if dataset_type == "vidvrd":
        names, pred_names = cats.VIDVRD_ENTITIES, cats.VIDVRD_PREDICATES
    else:
        names, pred_names = cats.VIDOR_ENTITIES, cats.VIDOR_PREDICATES
    for tid in range(gt.num_trajs):
        entities.append({"tid": tid,
                         "category": names[int(gt.traj_cat_ids[tid])]})
        s, e = gt.traj_durations[tid]
        for k, f in enumerate(range(int(s), int(e) + 1)):
            b = gt.traj_boxes[tid][k]
            frames[f].append({"tid": tid, "bbox": {
                "xmin": float(b[0]), "ymin": float(b[1]),
                "xmax": float(b[2]), "ymax": float(b[3])}})
    rels = []
    pred2so = gt.adj.argmax(-1) if gt.num_preds else np.zeros((2, 0))
    for p in range(gt.num_preds):
        rels.append({
            "subject_tid": int(pred2so[0, p]),
            "object_tid": int(pred2so[1, p]),
            "predicate": pred_names[int(gt.pred_cat_ids[p])],
            "begin_fid": int(gt.pred_durations[p, 0]),
            "end_fid": int(gt.pred_durations[p, 1]) + 1,
        })
    return {"video_id": gt.video_name, "trajectories": frames,
            "subject/objects": entities, "relation_instances": rels,
            "width": int(gt.video_wh[0]), "height": int(gt.video_wh[1])}


def _rows_from_proposal(prop, dim_feat: int, rng):
    """Raw rows whose parse reproduces ``prop`` (det box == tracklet box,
    so the mega-format averaging is the identity), float64, and one
    300-wide classeme row per row drawn from ``rng``."""
    blocks = []
    for i in range(prop.num_proposals):
        s, e = (int(v) for v in prop.durations[i])
        n = e - s + 1
        if prop.boxes[i].shape[0] != n:
            raise ValueError(f"{prop.video_name}: proposal {i} has "
                             f"{prop.boxes[i].shape[0]} boxes for {n} frames")
        b = prop.boxes[i].astype(np.float64)
        xywh = np.stack([b[:, 0], b[:, 1], b[:, 2] - b[:, 0],
                         b[:, 3] - b[:, 1]], axis=1)
        blk = np.empty((n, 12 + dim_feat))
        blk[:, 0] = np.arange(s, e + 1)
        blk[:, 1] = i
        blk[:, 2:6] = xywh
        blk[:, 6] = float(prop.scores[i])
        blk[:, 7] = int(prop.cat_ids[i])
        blk[:, 8:12] = xywh
        blk[:, 12:] = prop.features[i][:, :dim_feat]
        blocks.append(blk)
    if not blocks:
        return np.array([], dtype=float), np.zeros((0, 300), np.float32)
    rows = np.concatenate(blocks, axis=0)
    # one draw of shape (R, 300) gives the stream of R draws of 300
    classeme = rng.normal(0, 0.3, (rows.shape[0], 300)).astype(np.float32)
    return rows, classeme


def write_synthetic_vidvrd(root: str, n_videos: int = 8, split: str = "test",
                           fmt: str = "pku_i3d", dim_feat: int = 64,
                           dim_i3d: int = 16, seed: int = 0,
                           video_len: int = 120, **recipe):
    """Returns the dataset-config kwargs pointing at the written files."""
    ann_dir = os.path.join(root, "vidvrd-dataset")
    prop_dir = os.path.join(root, "proposals")
    i3d_dir = os.path.join(root, "i3d")
    os.makedirs(os.path.join(ann_dir, split), exist_ok=True)
    os.makedirs(prop_dir, exist_ok=True)
    os.makedirs(i3d_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    total_feat = dim_feat + (dim_i3d if fmt == "pku_i3d" else 0)
    for v in range(n_videos):
        name = f"ILSVRC2015_synth_{seed:02d}{v:06d}"
        prop, gt = make_video(seed * 1000 + v, video_len=video_len,
                              feat_dim=total_feat,
                              num_enti_cats=36, num_pred_cats=133,
                              name=name, **recipe)
        with open(os.path.join(ann_dir, split, name + ".json"), "w") as f:
            json.dump(_annotation_from_gt(gt), f)
        rows, _ = _rows_from_proposal(prop, dim_feat, rng)
        if fmt == "pku_i3d":
            # i3d rows parallel to tracklet rows: first 12 cols ignored
            i3d_rows = np.zeros((rows.shape[0], 12 + dim_i3d))
            r = 0
            for i in range(prop.num_proposals):
                L = prop.boxes[i].shape[0]
                i3d_rows[r:r + L, 12:] = prop.features[i][:, dim_feat:]
                r += L
            np.save(os.path.join(i3d_dir, name + ".npy"), i3d_rows)
        np.save(os.path.join(prop_dir, name + ".npy"), rows)
    cfg = dict(split=split, ann_dir=ann_dir, proposal_dir=prop_dir,
               dim_boxfeature=dim_feat, min_frames_th=5, max_proposal=50,
               # cache_tag varies with everything that changes record
               # content, so a root rewritten at other widths, formats or
               # recipes never reuses cached records
               max_preds=100,
               cache_tag=f"SYNTH_{fmt}_{dim_feat}x{dim_i3d}" + _recipe_tag(
                   video_len, recipe),
               fmt=fmt,
               cache_dir=os.path.join(root, "cache"))
    if fmt == "pku_i3d":
        cfg.update(i3d_dir=i3d_dir, dim_i3d=dim_i3d)
    return cfg


def _recipe_tag(video_len: int, recipe: dict) -> str:
    """'' for the default recipe (the JAX package's tag), else the recipe's
    numbers."""
    if not recipe:
        return ""
    return f"_L{video_len}_" + "_".join(f"{k}{recipe[k]}"
                                        for k in sorted(recipe))


def _write_video_file(path: str, video_len: int, wh) -> None:
    """Write a tiny real video (MJPG/avi) so the annotation-free test-split
    ingestion can read video_len/wh from the file itself (needs OpenCV)."""
    import cv2

    w, h = int(wh[0]), int(wh[1])
    out = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 25, (w, h))
    frame = np.zeros((h, w, 3), np.uint8)
    for _ in range(video_len):
        out.write(frame)
    out.release()


def write_synthetic_vidor(root: str, n_videos: int = 6, split: str = "val",
                          dim_feat: int = 64, seed: int = 0,
                          video_len: int = 120, clip_len: int = 16,
                          with_video_features: bool = True,
                          wh=(96, 64), **recipe):
    """Returns the dataset-config kwargs pointing at the written files."""
    sub = {"train": "training", "val": "validation", "test": None}[split]
    ann_dir = os.path.join(root, "vidor", "annotation")
    prop_dir = os.path.join(root, "vidor", f"proposals_{split}_freq1")
    clsme_dir = os.path.join(root, "vidor", "classeme")
    feat_dir = os.path.join(root, "vidor", "clip_features")
    video_dir = os.path.join(root, "vidor", "video")
    os.makedirs(prop_dir, exist_ok=True)
    os.makedirs(clsme_dir, exist_ok=True)
    os.makedirs(feat_dir, exist_ok=True)
    rng = np.random.default_rng(seed + 7)
    for v in range(n_videos):
        group = f"{v % 2:04d}"
        vid = f"{2000000000 + seed * 1000 + v}"
        name = f"{group}_{vid}"
        prop, gt = make_video(seed * 2000 + v, video_len=video_len,
                              feat_dim=dim_feat, num_enti_cats=81,
                              num_pred_cats=51, name=name, wh=wh, **recipe)
        if sub is not None:
            os.makedirs(os.path.join(ann_dir, sub, group), exist_ok=True)
            with open(os.path.join(ann_dir, sub, group, vid + ".json"),
                      "w") as f:
                json.dump(_annotation_from_gt(gt, "vidor"), f)
        else:
            # test split: no annotations; video_len/wh live in the video
            os.makedirs(os.path.join(video_dir, group), exist_ok=True)
            _write_video_file(os.path.join(video_dir, group, vid + ".avi"),
                              video_len, wh)
        rows, classeme = _rows_from_proposal(prop, dim_feat, rng)
        np.save(os.path.join(prop_dir, name + ".npy"), rows)
        np.save(os.path.join(clsme_dir, name + "_clsme.npy"), classeme)
        if with_video_features:
            n_clips = max(2, (video_len - clip_len) // (clip_len // 2) + 1)
            np.save(os.path.join(feat_dir, name + ".npy"),
                    rng.normal(size=(n_clips, 1024)).astype(np.float32))
    return dict(split=split, ann_dir=ann_dir, proposal_dir=prop_dir,
                classeme_dir=clsme_dir, max_proposal=180, max_preds=200,
                score_th=0.4, dim_boxfeature=dim_feat, min_frames_th=5,
                cache_tag=f"SYNTH_vidor_{dim_feat}" + _recipe_tag(
                    video_len, recipe),
                video_dir=video_dir if sub is None else None,
                video_feature_dir=feat_dir if with_video_features else None,
                cache_dir=os.path.join(root, "cache"))
