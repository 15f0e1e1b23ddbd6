"""Tracklet-proposal quality: per-class trajectory mAP of a split's
proposals against its GT trajectories.

Counterpart of the JAX package's ``tools/eval_traj_mAP.py``
(capability-parity with reference tools/eval_traj_mAP.py).  Run as

    python -m vidsgg_big_tpu_torch.tools.eval_traj_mAP \\
        --cfg_path experiments/exp4/config_.py --dataset_type vidor

to score the config's ``{split}_dataset_config`` split (``--split``,
default test) in the reference layout; ``--use_pku`` names VidVRD
proposals with the PKU vocabulary; ``--synthetic N --synthetic_root DIR``
writes that split first.  The overlap is the challenge toolkit's Python
loop over frames, on the host: its seconds are logged.
"""
from __future__ import annotations

import argparse
import os
import time

from ..evaluation.traj_map import eval_video_object, record_to_traj_dicts
from ..utils.categories import get_vocab
from ..utils.config import parse_config_py
from ..utils.logger import create_logger
from .common import make_dataset


def main(argv=None) -> dict:
    """Trajectory mAP as the flags say; returns {"mean_ap", "ap_class",
    "n_videos", "read_seconds", "eval_seconds"}."""
    args = parse_args(argv)
    log_dir = os.path.join(os.path.dirname(args.cfg_path), "logfile")
    os.makedirs(log_dir, exist_ok=True)
    logger = create_logger(os.path.join(log_dir, "eval_traj_mAP.log"))
    t0 = time.perf_counter()
    all_cfgs = parse_config_py(args.cfg_path)
    dataset, _ = make_dataset(all_cfgs[f"{args.split}_dataset_config"],
                              args.dataset_type, synthetic=args.synthetic,
                              synthetic_root=args.synthetic_root)
    id2name, _ = get_vocab(args.dataset_type, use_pku=args.use_pku)
    gt_id2name, _ = get_vocab(args.dataset_type)

    gt_results, proposal_results = {}, {}
    for item in dataset:
        prop, gt = item[-2], item[-1]
        gt_results[gt.video_name] = record_to_traj_dicts(
            gt.traj_cat_ids, gt.traj_durations, gt.traj_boxes, gt_id2name)
        proposal_results[gt.video_name] = record_to_traj_dicts(
            prop.cat_ids, prop.durations, prop.boxes, id2name,
            scores=prop.scores)
    t1 = time.perf_counter()
    mean_ap, ap_class = eval_video_object(gt_results, proposal_results)
    t2 = time.perf_counter()
    for i, (category, ap) in enumerate(ap_class):
        logger.info(f"{i+1:>2}{category:>20}\t{ap:.4f}")
    logger.info(f"{'mean AP':>22}\t{mean_ap:.4f}")
    logger.info(f"{len(gt_results)} videos read in {t1 - t0:.3f} s, scored "
                f"in {t2 - t1:.3f} s on the host")
    return dict(mean_ap=mean_ap, ap_class=ap_class,
                n_videos=len(gt_results), read_seconds=t1 - t0,
                eval_seconds=t2 - t1)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--cfg_path", type=str, required=True)
    parser.add_argument("--dataset_type", type=str, default="vidor",
                        choices=("vidvrd", "vidor"))
    parser.add_argument("--split", type=str, default="test",
                        help="the config's {split}_dataset_config")
    parser.add_argument("--use_pku", action="store_true",
                        help="name VidVRD proposals with the PKU entities")
    parser.add_argument("--synthetic", type=int, default=0,
                        help="write N synthetic videos in the reference "
                             "layout under --synthetic_root first and read "
                             "them")
    parser.add_argument("--synthetic_root", type=str, default=None)
    return parser.parse_args(argv)


if __name__ == "__main__":
    main()
