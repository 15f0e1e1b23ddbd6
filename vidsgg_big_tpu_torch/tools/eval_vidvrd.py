"""Evaluate BIG-C v10 on VidVRD with the port: bucketed inference on the
card, challenge-format conversion, relation-detection metrics.

Counterpart of the JAX package's ``tools/eval_vidvrd.py`` (its GT comes from
the records' own graphs, the reference's *_our_gt.py path).  Run as

    python -m vidsgg_big_tpu_torch.tools.eval_vidvrd \\
        --cfg_path experiments/exp2/config_.py --synthetic 16 \\
        --synthetic_model_dims --batch_size 8 [--device cpu]

This slice reads no dataset from disk: ``--synthetic N`` draws N in-memory
records from ``data/synthetic.make_video``, as bench.py does.  Reading the
on-disk VidVRD splits is a later slice of the port.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ..data.bucketing import BucketSpec, bucketed_batches
from ..data.synthetic import make_video
from ..evaluation.convert import EvalFmtCvtor
from ..evaluation.metrics import eval_relation_with_gt
from ..models.big_c import BigC, BigCConfig, load_bias_matrix
from ..models.transplant import strip_module_prefix
from ..train.steps import build_infer_step
from ..utils.config import parse_config_py
from ..utils.device import resolve_device, strict_float32
from ..utils.logger import create_logger

# bench.py's full-size record recipe and serving geometry (bench.py:22-24,
# 79-87): 12 GT + 34 distractor tracklets per 480-frame video, packed at
# N=50 tracklets x T=256 frames
FULL_SIZE_RECIPE = dict(video_len=480, n_gt_trajs=12, n_preds=16,
                        n_distractors=34)
FULL_SIZE_BUCKETS = dict(n_ladder=(50,), t_ladder=(256,))
# feature widths without --synthetic_model_dims (the JAX CLIs' synthetic
# default: 64 RoI + 16 I3D channels)
SMALL_DIMS = (64, 16)
# seed of the random weights when no checkpoint is given
WEIGHT_SEED = 0


def synthetic_records(n_videos: int, cfg: BigCConfig, model_dims: bool):
    """(proposal, GT) records, generated lazily, and their feature width."""
    if model_dims:
        feat, recipe = cfg.dim_feat + (cfg.dim_i3d or 0), FULL_SIZE_RECIPE
    else:
        feat, recipe = sum(SMALL_DIMS), {}
    records = (make_video(i, feat_dim=feat, num_enti_cats=cfg.num_enti_cats,
                          num_pred_cats=cfg.num_pred_cats, **recipe)
               for i in range(n_videos))
    return records, feat


def _table(path, shape):
    """A .npy table from the config, or zeros where it is absent."""
    if path and os.path.exists(path):
        arr = np.load(path).astype(np.float32)
        if arr.shape != tuple(shape):
            raise ValueError(f"{path}: shape {arr.shape} != {shape}")
        return arr
    return np.zeros(shape, np.float32)


def build_model(cfg: BigCConfig, model_config: dict, ckpt_path=None) -> BigC:
    """BigC on the CPU: random weights from ``WEIGHT_SEED`` and the config's
    tables, or a reference-named checkpoint (``module.`` prefixes
    stripped)."""
    e, c = cfg.num_enti_cats, cfg.num_pred_cats
    model = BigC(cfg, enti_name_emb=_table(model_config.get(
        "EntiNameEmb_path"), (e, cfg.dim_clsme)),
        generator=torch.Generator().manual_seed(WEIGHT_SEED))
    load_bias_matrix(model, _table(model_config.get("bias_matrix_path"),
                                   (e, e, c)))
    if ckpt_path:
        sd = torch.load(ckpt_path, map_location="cpu", weights_only=True)
        model.load_state_dict(strip_module_prefix(sd), strict=True)
    return model


def inference_then_eval(args) -> dict:
    device = resolve_device(args.device)
    strict_float32()
    experiment_dir = args.output_dir or os.path.dirname(args.cfg_path)
    log_dir = os.path.join(experiment_dir, "logfile")
    os.makedirs(log_dir, exist_ok=True)
    logger = create_logger(os.path.join(log_dir, "eval_torch.log"))
    all_cfgs = parse_config_py(args.cfg_path)
    model_config = all_cfgs["model_config"]
    topk = args.topk or all_cfgs.get("inference_config", {}).get("topk", 10)
    if args.compute_dtype:
        model_config = dict(model_config, compute_dtype=args.compute_dtype)
    cfg = BigCConfig.from_dict(model_config, variant="v10")
    if not args.synthetic:
        raise SystemExit("this port reads no VidVRD split from disk yet; "
                         "pass --synthetic N")
    records, feat_dim = synthetic_records(args.synthetic, cfg,
                                          args.synthetic_model_dims)
    spec = BucketSpec(feat_dim=feat_dim, **(
        FULL_SIZE_BUCKETS if args.synthetic_model_dims else {}))

    model = build_model(cfg, model_config, args.ckpt_path)
    if args.ckpt_path:
        logger.info(f"loaded checkpoint {args.ckpt_path}")
    infer = build_infer_step(model.to(device), topk=topk)
    feat_dtype = getattr(torch, args.feat_dtype)
    convertor = EvalFmtCvtor("vidvrd")
    predict_relations, gt_relations = {}, {}
    n_videos = n_batches = 0
    infer_s = 0.0
    logger.info(f"start inference on {device}...")
    for _, rows, props, _ in bucketed_batches(records, spec, args.batch_size,
                                              with_gt=False):
        props = props.to(device, feats=feat_dtype)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        trip = infer(props).numpy()       # the host copy ends the device work
        infer_s += time.perf_counter() - t0
        n_batches += 1
        # batch remainders repeat the last video; the dict update dedups them
        for i, (prop, gt) in enumerate(rows):
            predict_relations.update(
                convertor.to_eval_format_pr(prop, trip.video(i)))
            gt_relations.update(convertor.to_eval_format_gt(gt))
            n_videos += 1
    logger.info(f"inference done on {n_videos} videos in {n_batches} "
                f"batches, {infer_s:.3f} s in forward + triplets")

    mean_ap, rec_at_n, prec_at_n = eval_relation_with_gt(
        dataset_type="vidvrd", logger=logger,
        prediction_results=predict_relations, gt_relations=gt_relations)
    metrics = {"mAP": float(mean_ap),
               "recall": {str(k): float(v) for k, v in rec_at_n.items()},
               "precision": {str(k): float(v) for k, v in prec_at_n.items()}}
    if args.metrics_json:
        os.makedirs(os.path.dirname(os.path.abspath(args.metrics_json)),
                    exist_ok=True)
        with open(args.metrics_json, "w") as f:
            json.dump(metrics, f, indent=1)
        logger.info(f"metrics json saved at {args.metrics_json}")
    if args.save_json_results:
        p = os.path.join(experiment_dir,
                         "VidVRDtest_predict_relations_torch.json")
        with open(p, "w") as f:
            json.dump(predict_relations, f)
        logger.info(f"predict_relations saved at {p}")
    return dict(metrics, n_videos=n_videos, n_batches=n_batches,
                n_relations=sum(len(v) for v in predict_relations.values()),
                infer_seconds=infer_s, device=str(device))


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--cfg_path", type=str, required=True)
    parser.add_argument("--ckpt_path", type=str, default=None,
                        help="torch state_dict in the reference parameter "
                             "names ('module.' prefixes are stripped); "
                             "default: random weights from a fixed seed")
    parser.add_argument("--output_dir", type=str, default=None,
                        help="log and result directory (default: the "
                             "config's directory)")
    parser.add_argument("--topk", type=int, default=None)
    parser.add_argument("--batch_size", type=int, default=1)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default cuda; pass cpu to run "
                             "without a card)")
    parser.add_argument("--metrics_json", type=str, default=None,
                        help="write {mAP, recall@K, tagging P@K} as JSON")
    parser.add_argument("--save_json_results", action="store_true")
    parser.add_argument("--feat_dtype", type=str, default="float32",
                        choices=("float32", "bfloat16"),
                        help="feature dtype on the device (packing is "
                             "float32; the cast follows the copy)")
    parser.add_argument("--compute_dtype", type=str, default=None,
                        choices=("float32", "bfloat16"),
                        help="override the model compute dtype "
                             "(config key compute_dtype)")
    parser.add_argument("--synthetic", type=int, default=0,
                        help="evaluate on N in-memory synthetic videos from "
                             "data/synthetic.make_video (as bench.py); "
                             "on-disk splits are not read yet")
    parser.add_argument("--synthetic_model_dims", action="store_true",
                        help="full-size synthetic videos: features at the "
                             "config's dims and bench.py's recipe, packed "
                             "at N=50 tracklets x T=256 frames")
    return parser.parse_args(argv)


def main(argv=None) -> dict:
    return inference_then_eval(parse_args(argv))


if __name__ == "__main__":
    main()
