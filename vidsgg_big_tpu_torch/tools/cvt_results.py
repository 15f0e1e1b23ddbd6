"""Package a prediction JSON for the challenge server: one
``{video}.json.xz`` a video and ``submission.zip`` of them.

Counterpart of the JAX package's ``tools/cvt_results.py`` (capability-parity
with reference utils/cvt_result.py, without os.system).  Run as

    python -m vidsgg_big_tpu_torch.tools.cvt_results \\
        --results_json experiments/exp4/VidORval_predict_relations_torch.json \\
        --output_dir submission

on the JSON that ``eval_vidor --save_json_results`` (or ``eval_vidvrd``)
writes.
"""
from __future__ import annotations

import argparse
import json
import lzma
import os
import zipfile


def main(argv=None) -> dict:
    """Write the files; returns {"n_videos", "zip_path"}."""
    args = parse_args(argv)
    with open(args.results_json) as f:
        results = json.load(f)
    os.makedirs(args.output_dir, exist_ok=True)
    xz_paths = []
    for video_name, rels in results.items():
        p = os.path.join(args.output_dir, f"{video_name}.json.xz")
        with lzma.open(p, "wt") as f:
            json.dump({"results": {video_name: rels}}, f)
        xz_paths.append(p)
    zip_path = os.path.join(args.output_dir, "submission.zip")
    with zipfile.ZipFile(zip_path, "w") as z:
        for p in xz_paths:
            z.write(p, arcname=os.path.basename(p))
    print(f"packaged {len(xz_paths)} videos into {zip_path}")
    return {"n_videos": len(xz_paths), "zip_path": zip_path}


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--results_json", type=str, required=True)
    parser.add_argument("--output_dir", type=str, default="submission")
    return parser.parse_args(argv)


if __name__ == "__main__":
    main()
