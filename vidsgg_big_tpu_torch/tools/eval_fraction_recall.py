"""Fraction recall (paper table 6) from the hit infos that ``eval_vidor
--save_hit_infos`` writes.

Counterpart of the JAX package's ``tools/eval_fraction_recall.py``
(capability-parity with reference tools/eval_fraction_recall.py).  Run as

    python -m vidsgg_big_tpu_torch.tools.eval_fraction_recall \\
        --cfg_path experiments/exp4/config_.py \\
        --hit_info_path experiments/exp4/hit_infos_torch.pkl

to read the GT records of the config's ``test_dataset_config`` split (only
them: ``dataset.get_data(name)[1]``, never the clip features of
``__getitem__``); ``--synthetic N --synthetic_root DIR`` writes that split
first, as the eval CLIs do.  The hit infos are {video: (detection scores,
GT-to-detection ids)} of numpy arrays, the same pickle in both packages.
Runs on the host.
"""
from __future__ import annotations

import argparse
import os
import pickle
import time

from ..evaluation.fraction_recall import fraction_recall
from ..utils.config import parse_config_py
from ..utils.logger import create_logger
from .common import make_dataset


def reset_name(video_name: str) -> str:
    """A VidOR record's name ("group_vid") as the relation eval keys it."""
    parts = video_name.split("_")
    return parts[1] if len(parts) == 2 else video_name


def main(argv=None) -> dict:
    """Fraction recall as the flags say; returns {"video_level",
    "dataset_level"} recalls and the host seconds."""
    args = parse_args(argv)
    experiment_dir = args.experiment_dir or os.path.dirname(args.cfg_path)
    log_dir = os.path.join(experiment_dir, "logfile")
    os.makedirs(log_dir, exist_ok=True)
    logger = create_logger(os.path.join(
        log_dir, os.path.basename(args.hit_info_path) + ".log"))
    t0 = time.perf_counter()
    all_cfgs = parse_config_py(args.cfg_path)
    dataset, _ = make_dataset(all_cfgs["test_dataset_config"], "vidor",
                              synthetic=args.synthetic,
                              synthetic_root=args.synthetic_root)
    with open(args.hit_info_path, "rb") as f:
        hit_infos = pickle.load(f)
    logger.info(f"hit infos loaded from {args.hit_info_path}")
    gts = (dataset.get_data(n)[1] for n in dataset.video_name_list)
    out = fraction_recall(gts, hit_infos, reset_name=reset_name)
    logger.info("---------------video-level----------------")
    for s in ("overall", "single", "multiple"):
        logger.info(f"{s}{out['video_level'][s]}")
    logger.info("---------------dataset-level----------------")
    for s in ("overall", "single", "multiple"):
        logger.info(f"{s}{out['dataset_level'][s]}")
    seconds = time.perf_counter() - t0
    logger.info(f"fraction recall of {len(hit_infos)} videos in "
                f"{seconds:.3f} s on the host")
    return dict(out, n_videos=len(hit_infos), seconds=seconds)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--cfg_path", type=str, required=True)
    parser.add_argument("--hit_info_path", type=str, required=True)
    parser.add_argument("--experiment_dir", type=str, default=None,
                        help="log directory's parent (default: the "
                             "config's directory)")
    parser.add_argument("--synthetic", type=int, default=0,
                        help="write N synthetic VidOR videos in the "
                             "reference layout under --synthetic_root "
                             "first and read them")
    parser.add_argument("--synthetic_root", type=str, default=None)
    return parser.parse_args(argv)


if __name__ == "__main__":
    main()
