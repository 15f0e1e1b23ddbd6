"""Video metadata via OpenCV (VidOR test-split ingestion).

A copy of the JAX package's ``data/video_io.py``.  OpenCV is imported when
a video is read; a host without it (the H100 host has none) raises naming
the missing module, so only the annotation-free VidOR test split needs it.

The reference obtains test-split ``video_len`` / ``width`` / ``height`` by
decoding the whole video (reference dataloaders/dataloader_vidor.py:447-455
via ``VidRead2ImgNpLits``, utils/utils_func.py:180-192).  We decode-count
too: CAP_PROP_FRAME_COUNT is a container-header *estimate* that can differ
from the decoded frame count on VFR or slightly corrupt files, and
``video_len`` feeds temporal normalization and the challenge-JSON durations
— a wrong value would be silently baked into the per-video record cache.
The count runs once per video at ingestion; the ``.npz`` cache makes every
later access free.
"""
from __future__ import annotations

import os


def get_video_info(path: str):
    """Returns (n_frames, (width, height)) of a video file, by decoding."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            f"reading {path} needs OpenCV (the cv2 module), which this host "
            "lacks: only the annotation-free VidOR test split reads videos"
        ) from e

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video: {path}")
    try:
        w = int(round(cap.get(cv2.CAP_PROP_FRAME_WIDTH)))
        h = int(round(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)))
        n = 0
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            if n == 0 and (w <= 0 or h <= 0):
                h, w = frame.shape[:2]
            n += 1
    finally:
        cap.release()
    return n, (w, h)


def find_video_file(video_dir: str, group: str, vid: str) -> str:
    """Locate <video_dir>/<group>/<vid>.<ext> for common containers."""
    for ext in (".mp4", ".avi", ".mkv", ".webm"):
        p = os.path.join(video_dir, group, vid + ext)
        if os.path.exists(p):
            return p
    raise FileNotFoundError(
        f"no video file for {group}/{vid} under {video_dir}")
