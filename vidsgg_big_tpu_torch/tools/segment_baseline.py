"""Train/detect entry point of the MM'17 segment-proposal baseline.

Port of the JAX package's ``tools/segment_baseline.py`` (reference
VidVRD-helper/baseline.py:61-123): ``--train`` fits the linear predicate
model over the observed training triplets; ``--detect`` predicts
short-term relations per 30-frame segment on ``--device``, links them with
greedy relational association on the host, evaluates against the GT, and
writes ``baseline_relation_prediction.json``.

The weights file is JAX's ``segment_baseline_weights.npz`` (``kernel`` in
flax's (in, out) layout, ``bias``, ``triplet_ids``), so either package's
``--detect`` reads the other's ``--train``.  The first weights come from
``torch.Generator().manual_seed(--rng_seed)``, not JAX's PRNG, so a train
run matches JAX's only from the same first weights.

With ``--synthetic N`` a learnable synthetic dataset is written in the
segment-store layout first (the reference's offline dlib/iDT feature
extraction is not in the repository, like the MEGA tracklets):

  python -m vidsgg_big_tpu_torch.tools.segment_baseline --train --detect \\
      --synthetic 6 --synthetic_root datasets/synthetic_segments \\
      --output_dir out_segbase [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import time
from collections import defaultdict

import numpy as np
import torch

from ..data.segment_store import SegmentStore, write_synthetic_segments
from ..evaluation.association import (Trajectory,
                                      greedy_relational_association)
from ..evaluation.metrics import evaluate
from ..models.segment_baseline import (
    WEIGHTS_FILE, SegmentBaseline, SegmentBaselineConfig,
    build_baseline_train_step, feature_preprocess, load_weights,
    predict_segment_pairs, predictions_to_host, sample_positive_pairs,
    save_weights)
from ..utils.categories import VIDVRD_ENTITIES, VIDVRD_PREDICATES
from ..utils.device import resolve_device
from ..utils.logger import create_logger


def _names(cfg: SegmentBaselineConfig):
    """Category-id -> name tables for the no-background baseline id space."""
    objs = (VIDVRD_ENTITIES[1:] * 3)[:cfg.num_obj_cats]
    preds = (VIDVRD_PREDICATES[1:] * 3)[:cfg.num_pred_cats]
    return objs, preds


def pair_bucket(p: int) -> int:
    """The JAX CLI's padded pair count: the power of two at or above p
    (at least 2)."""
    return 1 << max(p - 1, 1).bit_length()


def train(store: SegmentStore, args, logger, device) -> dict:
    """Fit the model; writes the weights file.  Returns {"losses": [the
    loss of every step], "ms_per_iter": host ms a step, sampling and
    loading included}."""
    cfg = store.cfg
    model = SegmentBaseline(
        cfg, generator=torch.Generator().manual_seed(args.rng_seed)).to(
            device)
    triplet_ids = store.observed_train_triplets()
    triplet_index = {tuple(t): i for i, t in enumerate(triplet_ids)}
    logger.info(f"{len(triplet_ids)} observed training triplets")

    optimizer = torch.optim.Adam(model.parameters(), lr=cfg.learning_rate)
    step = build_baseline_train_step(model, optimizer)
    tids = torch.as_tensor(triplet_ids, device=device)

    rng = np.random.default_rng(args.rng_seed)
    segs = store.segments("train")
    bs = args.batch_size
    feats_buf = np.zeros((bs, cfg.feature_dim), np.float32)
    labels_buf = np.zeros((bs,), np.int64)
    valid = torch.ones((bs,), dtype=torch.bool, device=device)
    fill = 0
    it = 0
    losses = []
    t0 = time.time()
    while it < args.max_iter:
        vid, fs, fe = segs[int(rng.integers(len(segs)))]
        seg = store.load(vid, fs, fe)
        rows, labels = sample_positive_pairs(
            seg["pairs"], seg["iou"], seg["trackid"],
            [tuple(int(x) for x in r) for r in seg["gt_insts"]],
            rng, min(args.max_sampling_in_batch, bs - fill), triplet_index)
        if len(rows) == 0:
            continue
        f = feature_preprocess(seg["feats"][rows], cfg)
        feats_buf[fill:fill + len(rows)] = f
        labels_buf[fill:fill + len(rows)] = labels
        fill += len(rows)
        if fill < bs:
            continue
        loss = step(torch.from_numpy(feats_buf).to(device),
                    torch.from_numpy(labels_buf).to(device), valid, tids)
        losses.append(float(loss))
        fill = 0
        it += 1
        if it % args.display_freq == 0 or it == args.max_iter:
            logger.info(f"iter {it}/{args.max_iter} loss {losses[-1]:.4f} "
                        f"({(time.time() - t0):.1f}s)")
    seconds = time.time() - t0

    os.makedirs(args.output_dir, exist_ok=True)
    save_weights(os.path.join(args.output_dir, WEIGHTS_FILE), model,
                 triplet_ids)
    logger.info(f"saved weights to {args.output_dir}")
    return {"losses": losses,
            "ms_per_iter": 1e3 * seconds / max(args.max_iter, 1)}


def detect(store: SegmentStore, args, logger, device) -> dict:
    """Predict, associate and evaluate the test split; writes the
    prediction JSON.  Returns the metrics, the relation count, the largest
    pair bucket and the association's host seconds."""
    cfg = store.cfg
    model = SegmentBaseline(cfg).to(device)
    load_weights(os.path.join(args.output_dir, WEIGHTS_FILE), model)
    model.eval()

    def predict(feats, valid):
        # padded to JAX's power-of-two pair buckets: the padded rows score
        # -inf, and the finite predictions do not depend on the bucket
        p = len(feats)
        bucket = pair_bucket(p)
        fpad = np.zeros((bucket, cfg.feature_dim), np.float32)
        fpad[:p] = feats
        vpad = np.zeros((bucket,), bool)
        vpad[:p] = valid
        return predict_segment_pairs(model, torch.from_numpy(fpad).to(device),
                                     torch.from_numpy(vpad).to(device))

    video_st, trajs_lookup = defaultdict(list), {}
    max_pairs = 0
    for vid, fs, fe in store.segments("test"):
        seg = store.load(vid, fs, fe)
        trackid, pairs = seg["trackid"], seg["pairs"]
        # test pairs: both members must be proposals (reference model.py:135)
        test = (trackid[pairs[:, 0]] < 0) & (trackid[pairs[:, 1]] < 0)
        pairs = pairs[test]
        if len(pairs) == 0:
            continue
        max_pairs = max(max_pairs, len(pairs))
        feats = feature_preprocess(seg["feats"][test], cfg)
        scores, sto = predict(feats, np.ones((len(pairs),), bool))
        preds = predictions_to_host(scores, sto, pairs)
        key = (vid, int(fs), int(fe))
        video_st[vid].append((key, preds))
        trajs_lookup[key] = [
            Trajectory(int(fs), int(fe), rois) for rois in seg["traj_rois"]]

    obj_names, pred_names = _names(cfg)
    results = {}
    t0 = time.perf_counter()
    for vid, st_rels in video_st.items():
        results[vid] = greedy_relational_association(
            st_rels, trajs_lookup, obj_names, pred_names,
            max_traj_num_in_clip=args.max_traj_num_in_clip)
    association_seconds = time.perf_counter() - t0
    os.makedirs(args.output_dir, exist_ok=True)
    out_path = os.path.join(args.output_dir,
                            "baseline_relation_prediction.json")
    with open(out_path, "w") as f:
        json.dump({"version": "VERSION 1.0", "results": results}, f)
    n_relations = sum(map(len, results.values()))
    logger.info(f"saved {n_relations} relations to {out_path}")

    # every test-split GT video participates: videos with no predictions
    # contribute AP 0 (evaluate() treats missing prediction keys as empty),
    # matching the challenge protocol's average over all GT videos
    test_vids = set(store.index["test"])
    gt = {}
    for vid, rels in store.groundtruth().items():
        if vid not in test_vids:
            continue
        gt[vid] = [dict(r, triplet=[obj_names[r["triplet"][0]],
                                    pred_names[r["triplet"][1]],
                                    obj_names[r["triplet"][2]]])
                   for r in rels]
    mean_ap, rec_at_n, prec_at_n = evaluate(gt, results)
    metrics = {"detection_mAP": round(mean_ap, 4),
               "recall@50": round(rec_at_n[50], 4),
               "recall@100": round(rec_at_n[100], 4),
               "tagging_P@1": round(prec_at_n[1], 4)}
    logger.info(json.dumps(metrics))
    return {"metrics": metrics, "n_relations": n_relations,
            "max_pair_bucket": pair_bucket(max_pairs) if max_pairs else 0,
            "association_seconds": association_seconds}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="VidVRD segment baseline")
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--detect", action="store_true")
    ap.add_argument("--data_root", type=str, default=None)
    ap.add_argument("--synthetic", type=int, default=0)
    ap.add_argument("--synthetic_root", type=str,
                    default="datasets/synthetic_segments")
    ap.add_argument("--output_dir", type=str, default="output_segbase")
    # reference training params (reference baseline.py:64-77)
    ap.add_argument("--rng_seed", type=int, default=1701)
    ap.add_argument("--max_sampling_in_batch", type=int, default=32)
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--max_iter", type=int, default=200)
    ap.add_argument("--display_freq", type=int, default=20)
    ap.add_argument("--max_traj_num_in_clip", type=int, default=100)
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Train and/or detect as the flags say; returns {"train": ...,
    "detect": ...} for the parts that ran."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    os.makedirs(args.output_dir, exist_ok=True)
    logger = create_logger(os.path.join(args.output_dir,
                                        "segment_baseline.log"))
    root = args.data_root
    if args.synthetic:
        root = write_synthetic_segments(args.synthetic_root,
                                        n_videos=args.synthetic)
        logger.info(f"synthetic segment data at {root}")
    if not root:
        raise SystemExit("--data_root or --synthetic required")
    store = SegmentStore(root)

    out = {}
    if args.train:
        out["train"] = train(store, args, logger, device)
    if args.detect:
        out["detect"] = detect(store, args, logger, device)
    if not (args.train or args.detect):
        print("nothing to do: pass --train and/or --detect")
    return out


if __name__ == "__main__":
    main()
