"""Write the challenge GT JSON of one split of an annotation tree.

Counterpart of the JAX package's ``tools/prepare_gts_for_eval.py``
(capability-parity with reference VidVRD-helper/prepare_gts_for_eval.py).
Run as

    python -m vidsgg_big_tpu_torch.tools.prepare_gts_for_eval \\
        --dataset_type vidor --anno_rpath datasets/vidor/annotation \\
        --split validation --save_path VidORval_gts.json

(VidVRD's splits are ``train`` / ``test`` under the annotation root,
VidOR's ``training`` / ``validation``).  The eval CLIs read the file with
``--gt_json``.
"""
from __future__ import annotations

import argparse

from ..data.annotations import VidOR, VidVRD, prepare_gts_for_eval


def main(argv=None) -> dict:
    """Write the GT JSON; returns {video: relation instances}."""
    args = parse_args(argv)
    cls = VidVRD if args.dataset_type == "vidvrd" else VidOR
    dataset = cls(args.anno_rpath, splits=[args.split])
    gts = prepare_gts_for_eval(dataset, args.split, args.save_path)
    print(f"wrote GT for {len(gts)} videos to {args.save_path}")
    return gts


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--dataset_type", type=str, default="vidvrd",
                        choices=("vidvrd", "vidor"))
    parser.add_argument("--anno_rpath", type=str, required=True)
    parser.add_argument("--split", type=str, default="test")
    parser.add_argument("--save_path", type=str, required=True)
    return parser.parse_args(argv)


if __name__ == "__main__":
    main()
