"""Annotation / prediction visualization (VidVRD-helper visualize.py
equivalent): render tracklet boxes and relation labels onto video frames
with OpenCV.

A copy of the JAX package's ``utils/visualize.py``; host code with no
device path.  OpenCV is imported when a frame is read or drawn, and a host
without it (the H100 host has none) raises there naming the missing module,
as ``data/video_io.py`` does; importing this module needs no OpenCV.
"""
from __future__ import annotations

import os

import numpy as np

_COLORS = [(230, 25, 75), (60, 180, 75), (255, 225, 25), (0, 130, 200),
           (245, 130, 48), (145, 30, 180), (70, 240, 240), (240, 50, 230),
           (210, 245, 60), (250, 190, 190), (0, 128, 128), (230, 190, 255)]


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            "visualisation needs OpenCV (the cv2 module), which this host "
            "lacks") from e
    return cv2


def read_video_frames(path: str):
    """Decode a whole video into a list of HxWx3 uint8 frames."""
    cv2 = _cv2()

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video: {path}")
    frames = []
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(frame)
    finally:
        cap.release()
    return frames


def prediction_insts(relations, topk: int = 10):
    """Challenge-format prediction relations of one video -> renderable
    (object_insts, relation_insts): the top-k scoring relations' subject /
    object trajectories become boxed tracklets, the triplets become captions.
    Prediction trajectories start at duration[0] (half-open [start, end),
    the challenge-JSON convention)."""
    rels = sorted(relations, key=lambda r: -float(r.get("score", 0.0)))[:topk]
    objs, rinsts = [], []
    for i, r in enumerate(rels):
        s, _ = r["duration"]
        for j, (role, cat) in enumerate(
                [("sub_traj", r["triplet"][0]), ("obj_traj", r["triplet"][2])]):
            objs.append({
                "tid": 2 * i + j,
                "category": f"{cat}({r.get('score', 0.0):.2f})",
                "trajectory": {str(s + k): b
                               for k, b in enumerate(r.get(role, []))}})
        rinsts.append({"triplet": list(r["triplet"]),
                       "duration": tuple(r["duration"])})
    return objs, rinsts


def render_video_annotations(frames, object_insts, relation_insts=None,
                             out_path=None, fps: int = 25):
    """Draw per-frame boxes (+ optional active relation captions).

    frames: list of HxWx3 uint8 images (or an int video_len to render onto
      blank canvases).
    object_insts: [{tid, category, trajectory: {fid(str|int): xyxy}}].
    relation_insts: optional [{triplet, duration [s, e), subject_tid,
      object_tid}].
    out_path: if set, writes an .mp4/.avi via cv2.VideoWriter; returns the
      rendered frame list either way.
    """
    cv2 = _cv2()

    if isinstance(frames, int):
        frames = [np.full((360, 640, 3), 255, np.uint8)
                  for _ in range(frames)]
    frames = [f.copy() for f in frames]

    for inst in object_insts:
        color = _COLORS[inst["tid"] % len(_COLORS)]
        for fid, box in inst["trajectory"].items():
            fid = int(fid)
            if not (0 <= fid < len(frames)):
                continue
            x1, y1, x2, y2 = (int(round(v)) for v in box)
            cv2.rectangle(frames[fid], (x1, y1), (x2, y2), color, 2)
            cv2.putText(frames[fid], f"{inst['category']}#{inst['tid']}",
                        (x1, max(y1 - 4, 10)), cv2.FONT_HERSHEY_SIMPLEX,
                        0.45, color, 1, cv2.LINE_AA)

    if relation_insts:
        for fid in range(len(frames)):
            captions = [
                " ".join(r["triplet"]) for r in relation_insts
                if r["duration"][0] <= fid < r["duration"][1]]
            for k, cap in enumerate(captions[:6]):
                cv2.putText(frames[fid], cap, (8, 18 + 16 * k),
                            cv2.FONT_HERSHEY_SIMPLEX, 0.5, (0, 0, 0), 1,
                            cv2.LINE_AA)

    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        h, w = frames[0].shape[:2]
        fourcc = cv2.VideoWriter_fourcc(*"mp4v")
        writer = cv2.VideoWriter(out_path, fourcc, fps, (w, h))
        for f in frames:
            writer.write(f)
        writer.release()
    return frames
