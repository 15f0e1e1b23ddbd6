"""Evaluate BIG-C v10 on VidVRD with the port: bucketed inference on the
card, challenge-format conversion, relation-detection metrics.

Counterpart of the JAX package's ``tools/eval_vidvrd.py`` (its GT comes from
the records' own graphs, the reference's *_our_gt.py path).  Run as

    python -m vidsgg_big_tpu_torch.tools.eval_vidvrd \\
        --cfg_path experiments/exp2/config_.py --synthetic 16 \\
        --synthetic_model_dims --batch_size 8 [--device cpu]

This slice reads no dataset from disk: ``--synthetic N`` draws N in-memory
records from ``data/synthetic.make_video``, as bench.py does.  Reading the
on-disk VidVRD splits is a later slice of the port.  ``--ckpt_path`` takes a
reference-named ``state_dict`` file or the checkpoint directory of
``tools/train_vidvrd`` (its newest ``ckpt_*.pt``), as the JAX CLI serves
its trainer's checkpoints.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ..data.bucketing import BucketSpec, bucketed_batches
from ..data.synthetic_vidvrd import (FULL_SIZE_BUCKETS,
                                     SyntheticVidVRDSet)
from ..evaluation.convert import EvalFmtCvtor
from ..evaluation.metrics import eval_relation_with_gt
from ..models.big_c import BigC, BigCConfig, load_bias_matrix
from ..models.transplant import strip_module_prefix
from ..train.steps import build_infer_step
from ..train.train_state import checkpoint_steps
from ..utils.config import parse_config_py
from ..utils.device import resolve_device, strict_float32
from ..utils.logger import create_logger

# seed of the random weights when no checkpoint is given
WEIGHT_SEED = 0


def synthetic_records(n_videos: int, cfg: BigCConfig, model_dims: bool):
    """(proposal, GT) records, generated lazily, and their feature width."""
    data = SyntheticVidVRDSet(n_videos, cfg, model_dims)
    return (data[i] for i in range(n_videos)), data.feat_dim


def _table(path, shape):
    """A .npy table from the config, or zeros where it is absent."""
    if path and os.path.exists(path):
        arr = np.load(path).astype(np.float32)
        if arr.shape != tuple(shape):
            raise ValueError(f"{path}: shape {arr.shape} != {shape}")
        return arr
    return np.zeros(shape, np.float32)


def load_state(ckpt_path: str) -> dict:
    """The model ``state_dict`` at ``ckpt_path``: a reference-named file
    (``module.`` prefixes stripped), or a ``tools/train_vidvrd`` checkpoint
    directory, whose newest ``ckpt_*.pt`` holds it under ``model``."""
    if os.path.isdir(ckpt_path):
        steps = checkpoint_steps(ckpt_path)
        if not steps:
            raise FileNotFoundError(f"no ckpt_*.pt in {ckpt_path}")
        ckpt_path = os.path.join(ckpt_path, f"ckpt_{steps[-1]}.pt")
        return torch.load(ckpt_path, map_location="cpu",
                          weights_only=True)["model"]
    sd = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    return strip_module_prefix(sd)


def build_model(cfg: BigCConfig, model_config: dict, ckpt_path=None,
                seed: int = WEIGHT_SEED) -> BigC:
    """BigC on the CPU: random weights from ``seed`` and the config's name
    and bias tables (zeros where their files are absent), or the weights of
    a checkpoint (:func:`load_state`)."""
    e, c = cfg.num_enti_cats, cfg.num_pred_cats
    model = BigC(cfg, enti_name_emb=_table(model_config.get(
        "EntiNameEmb_path"), (e, cfg.dim_clsme)),
        generator=torch.Generator().manual_seed(seed))
    load_bias_matrix(model, _table(model_config.get("bias_matrix_path"),
                                   (e, e, c)))
    if ckpt_path:
        model.load_state_dict(load_state(ckpt_path), strict=True)
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
                             "names ('module.' prefixes are stripped), or a "
                             "train_vidvrd checkpoint directory (its newest "
                             "ckpt_*.pt); default: random weights from a "
                             "fixed seed")
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
