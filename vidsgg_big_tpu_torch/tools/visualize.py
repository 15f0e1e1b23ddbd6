"""Render GT annotations or prediction-JSON relations onto videos.

Port of the JAX package's ``tools/visualize.py`` (capability parity with
reference VidVRD-helper/visualize.py:28-151); host code with no device
path, drawn with OpenCV (imported at use: a host without ``cv2`` raises
naming it).

Modes:
  GT:          --anno FILE_OR_DIR  (annotation JSONs in the dataset layout)
  predictions: --prediction_json FILE  (challenge-format {vid: [relations]}
               or {"results": {...}} as packaged for submission)

Frames come from --video_dir when given (<video_dir>/<video_id>.mp4, or the
VidOR <group>/<id> layout); otherwise boxes are drawn onto blank canvases
sized from the annotation (GT mode) or --canvas (prediction mode).

  python -m vidsgg_big_tpu_torch.tools.visualize --synthetic 2 \\
      --synthetic_root /tmp/split --out_dir /tmp/visualized
"""
from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np

from ..data.annotations import (object_insts_from_anno,
                                relation_insts_from_anno)
from ..utils.visualize import (prediction_insts, read_video_frames,
                               render_video_annotations)


def _find_video(video_dir, video_id):
    cands = [os.path.join(video_dir, video_id + ext)
             for ext in (".mp4", ".avi", ".mkv", ".webm")]
    if "_" in video_id:  # VidOR <group>_<id> naming
        group, vid = video_id.split("_", 1)
        cands += [os.path.join(video_dir, group, vid + ext)
                  for ext in (".mp4", ".avi", ".mkv", ".webm")]
    for p in cands:
        if os.path.exists(p):
            return p
    return None


def _frames_for(args, video_id, video_len, wh):
    if args.video_dir:
        path = _find_video(args.video_dir, video_id)
        if path is not None:
            return read_video_frames(path)
        print(f"  [warn] no video file for {video_id} under "
              f"{args.video_dir}; rendering blank canvas")
    w, h = wh
    return [np.full((int(h), int(w), 3), 255, np.uint8)
            for _ in range(video_len)]


def render_gt(args, anno_paths):
    outs = []
    for path in anno_paths[: args.max_videos or len(anno_paths)]:
        with open(path) as f:
            anno = json.load(f)
        vid = anno.get("video_id",
                       os.path.splitext(os.path.basename(path))[0])
        frames = _frames_for(args, vid, len(anno["trajectories"]),
                             (anno.get("width", 640),
                              anno.get("height", 360)))
        # GT relation durations are half-open [begin_fid, end_fid), same as
        # the renderer's caption convention
        out_path = os.path.join(args.out_dir, f"{vid}.mp4")
        render_video_annotations(
            frames, object_insts_from_anno(anno),
            relation_insts_from_anno(anno, no_traj=True),
            out_path=out_path, fps=args.fps)
        outs.append(out_path)
        print(f"rendered {vid} ({len(frames)} frames) -> {out_path}")
    return outs


def render_predictions(args):
    with open(args.prediction_json) as f:
        preds = json.load(f)
    if "results" in preds and isinstance(preds["results"], dict):
        preds = preds["results"]  # submission packaging (tools/cvt_results)
    outs = []
    for vid, relations in list(preds.items())[: args.max_videos or
                                              len(preds)]:
        if not relations:
            continue
        objs, rels = prediction_insts(relations, topk=args.topk)
        video_len = max((r["duration"][1] for r in rels), default=0)
        w, h = (int(v) for v in args.canvas.split("x"))
        frames = _frames_for(args, vid, video_len, (w, h))
        out_path = os.path.join(args.out_dir, f"{vid}.mp4")
        render_video_annotations(frames, objs, rels, out_path=out_path,
                                 fps=args.fps)
        outs.append(out_path)
        print(f"rendered {vid} top-{args.topk} predictions -> {out_path}")
    return outs


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--anno", type=str, default=None,
                        help="annotation JSON file or directory (GT mode)")
    parser.add_argument("--prediction_json", type=str, default=None,
                        help="challenge-format predictions "
                             "(eval CLI --save_json_results output)")
    parser.add_argument("--video_dir", type=str, default=None,
                        help="root of raw videos; omit to render boxes onto "
                             "blank canvases")
    parser.add_argument("--out_dir", type=str, default="visualized")
    parser.add_argument("--topk", type=int, default=10,
                        help="predictions per video to draw")
    parser.add_argument("--max_videos", type=int, default=0,
                        help="limit rendered videos (0 = all)")
    parser.add_argument("--fps", type=int, default=25)
    parser.add_argument("--canvas", type=str, default="640x360",
                        help="WxH blank canvas for prediction mode without "
                             "--video_dir")
    parser.add_argument("--synthetic", type=int, default=0)
    parser.add_argument("--synthetic_root", type=str, default=None)
    return parser.parse_args(argv)


def main(argv=None):
    """Render as the flags say; returns the written video paths."""
    args = parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    if args.synthetic:
        from ..data import synthetic_raw
        root = args.synthetic_root or os.path.join("datasets", "synthetic")
        cfg = synthetic_raw.write_synthetic_vidvrd(
            root, n_videos=args.synthetic, split="test")
        args.anno = os.path.join(cfg["ann_dir"], "test")
    if args.prediction_json:
        return render_predictions(args)
    if not args.anno:
        raise SystemExit("pass --anno, --prediction_json, or --synthetic")
    if os.path.isdir(args.anno):
        anno_paths = sorted(glob.glob(os.path.join(args.anno, "*.json")))
        if not anno_paths:
            raise SystemExit(f"no annotation JSONs under {args.anno}")
    else:
        anno_paths = [args.anno]
    return render_gt(args, anno_paths)


if __name__ == "__main__":
    main()
