"""Dataset smoke test: one split through the port's real input pipeline.

Counterpart of the JAX package's ``tools/dataloader_demo.py`` (reference
tools/dataloader_demo.py:13-53, the "verify your data is set up" gate).
Run as

    python -m vidsgg_big_tpu_torch.tools.dataloader_demo \\
        --cfg_path experiments/exp2/config_.py --split test [--device cpu]

It reads the config's split in the reference layout once (parsing each
video and writing its ``.npz`` cache, or loading the cache), then streams
it again from the cache through ``bucketed_batches`` (batches of 2, as the
JAX CLI) into the pinned slots
of a ``StagingRing`` on a prefetch thread and ships every batch to
``--device`` (default the card; raises without one unless ``--device
cpu``).  It prints the videos, proposals and GT predicates, the batches of
each (N, T) bucket with their padding waste (the data to retune the
ladders on a real split) and the pipeline summary of
``tools/common.pipeline_summary``.  ``--dataset_class`` picks the
reference demo config's ``{class}_{split}_dataset_config``; ``--synthetic N
--synthetic_root DIR`` writes N videos in that layout first.
"""
from __future__ import annotations

import argparse
import json

from ..data.bucketing import BucketSpec, bucketed_batches
from ..data.prefetch import prefetch
from ..data.transfer import StagingRing
from ..utils.config import parse_config_py
from ..utils.device import resolve_device
from .common import make_dataset, pipeline_summary

BATCH_SIZE = 2     # the JAX CLI's


def dataset_config(args):
    """(dataset config, dataset type) the flags pick, as the JAX CLI."""
    if not args.cfg_path:
        return {"split": args.split}, args.dataset_type
    all_cfgs = parse_config_py(args.cfg_path)
    plain = ("train_dataset_config" if args.split.startswith("train")
             else "test_dataset_config")
    if not args.dataset_class:
        return all_cfgs[plain], args.dataset_type
    # the reference's demo config defines pku / pku_i3d / vidvrd-prefixed
    # dataset dicts; VidOR configs carry plain train / test keys
    key = f"{args.dataset_class}_{args.split}_dataset_config"
    if key not in all_cfgs and args.dataset_class == "vidor":
        key = plain
    dataset_type = ("vidor" if args.dataset_class == "vidor"
                    else args.dataset_type)
    return all_cfgs[key], dataset_type


def main(argv=None) -> dict:
    """Run the demo; returns its counts and the pipeline summary."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg, dataset_type = dataset_config(args)
    dataset, cfg = make_dataset(cfg, dataset_type, synthetic=args.synthetic,
                                synthetic_root=args.synthetic_root,
                                fmt=args.fmt)
    print(f"dataset: {len(dataset)} videos (config: {cfg})")
    n_videos = n_props = n_preds = max_t = 0
    feat_dim = None
    for item in dataset:
        prop, gt = item[-2], item[-1]
        if feat_dim is None:
            feat_dim = (prop.features[0].shape[1] if prop.num_proposals
                        else 0)
        n_videos += 1
        n_props += prop.num_proposals
        n_preds += 0 if gt is None else gt.num_preds
        max_t = max(max_t, prop.max_frames)
    print(f"iterated {n_videos} videos: {n_props} proposals, "
          f"{n_preds} gt predicates, max_frames={max_t}")

    spec = BucketSpec(feat_dim=feat_dim or 0)
    buckets, videos, pad_cost = {}, {}, {}
    ring = StagingRing(device)
    try:
        for key, rows, props, gts in prefetch(bucketed_batches(
                ((it[-2], it[-1]) for it in dataset), spec, BATCH_SIZE,
                staging=ring)):
            props, gts = ring.ship((props, gts))
            n, t = key[:2]
            if tuple(props.feats.shape[1:3]) != (n, t):
                raise AssertionError(f"batch {tuple(props.feats.shape)} "
                                     f"in bucket {key}")
            buckets[(n, t)] = buckets.get((n, t), 0) + 1
            videos[(n, t)] = videos.get((n, t), 0) + len(rows)
            real = sum(r[0].num_proposals * min(r[0].max_frames, t)
                       for r in rows)
            pad_cost[(n, t)] = (pad_cost.get((n, t), 0)
                                + len(rows) * n * t - real)
    finally:
        ring.close()
    print(f"bucket histogram ({len(buckets)} shapes):")
    total_cells = sum(videos[k] * k[0] * k[1] for k in buckets)
    for k in sorted(buckets):
        waste = pad_cost[k] / max(videos[k] * k[0] * k[1], 1)
        print(f"  N={k[0]:>4} T={k[1]:>5}: {videos[k]:>6} videos "
              f"{buckets[k]:>5} batches  pad-waste {waste:5.1%}")
    overall = sum(pad_cost.values()) / max(total_cells, 1)
    print(f"overall padding waste: {overall:.1%} of (N*T) cells")
    summary = pipeline_summary(ring, dataset)
    print(f"pipeline on {device}: {json.dumps(summary)}")
    print("dataloader demo OK")
    return dict(n_videos=n_videos, n_proposals=n_props, n_preds=n_preds,
                max_frames=max_t, n_batches=sum(buckets.values()),
                buckets={f"{n}x{t}": c for (n, t), c in
                         sorted(buckets.items())},
                padding_waste=overall, pipeline=summary, device=str(device))


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--cfg_path", type=str, default=None)
    parser.add_argument("--dataset_type", type=str, default="vidvrd",
                        choices=("vidvrd", "vidor"))
    parser.add_argument("--split", type=str, default="test")
    parser.add_argument("--dataset_class", type=str, default=None,
                        help="reference-style preset selector (pku|pku_i3d|"
                             "vidvrd|vidor): reads the config key "
                             "{dataset_class}_{split}_dataset_config, as "
                             "reference tools/dataloader_demo.py:40 does "
                             "with experiments/demo/config_.py")
    parser.add_argument("--fmt", type=str, default=None,
                        choices=("mega", "pku", "pku_i3d"),
                        help="VidVRD tracklet format")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device the batches are shipped to "
                             "(default cuda; pass cpu to run without a "
                             "card)")
    parser.add_argument("--synthetic", type=int, default=0,
                        help="write N synthetic videos in the reference "
                             "layout under --synthetic_root first and "
                             "read them")
    parser.add_argument("--synthetic_root", type=str, default=None)
    return parser.parse_args(argv)


if __name__ == "__main__":
    main()
