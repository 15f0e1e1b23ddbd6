"""Evaluate BIG-C v10 on VidVRD with the port: bucketed inference on the
card, challenge-format conversion, relation-detection metrics.

Counterpart of the JAX package's ``tools/eval_vidvrd.py``.  Run as

    python -m vidsgg_big_tpu_torch.tools.eval_vidvrd \\
        --cfg_path experiments/exp2/config_.py --batch_size 8 [--device cpu]

to read the config's ``test_dataset_config`` split in the reference layout
(tracklet ``.npy`` files in the ``mega``, ``pku`` or ``pku_i3d`` format,
``--fmt`` / ``--use_pku``; annotation JSONs; a per-video ``.npz`` cache
under ``cache_dir``), with the GT of its annotations or of ``--gt_json``.
``--synthetic N --synthetic_root DIR`` first writes N videos in that layout
under DIR (``data/synthetic_raw``) and reads them; ``--synthetic N`` alone
draws N in-memory records from ``data/synthetic.make_video`` instead, as
bench.py does (with ``--synthetic_model_dims`` at bench.py's full-size
recipe, packed at N=50 x T=256).  ``--ckpt_path`` takes a reference-named
``state_dict`` file or the checkpoint directory of ``tools/train_vidvrd``
(its newest ``ckpt_*.pt``); ``--tables_path`` a ``tables.npz`` of the
frozen name embedding (and v7 position table).  ``--feat_dtype int8`` is
exp2's quantized serving path: features packed as int8 with a scale per
video, the encoder's first visual layer an int8 product.  Batches are
packed on a prefetch thread into reused pinned slots and copied to the card
on a copy stream (``data/transfer.StagingRing``).  ``--data_parallel``
(every card) and ``--mesh D[,M]`` shard each batch over D data ranks and
the model's MLPs, FFNs and attention heads over M (``parallel/``), as the
JAX CLI; each rank stages its rows, the triplets come back to every rank
and rank 0 scores and writes them.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from ..data.bucketing import BucketSpec, bucketed_batches
from ..data.prefetch import prefetch
from ..data.synthetic_vidvrd import (FULL_SIZE_BUCKETS,
                                     SyntheticVidVRDSet)
from ..data.transfer import StagingRing
from ..evaluation.convert import EvalFmtCvtor
from ..evaluation.metrics import eval_relation_with_gt
from ..models.big_c import BigC, BigCConfig, load_bias_matrix
from ..models.transplant import strip_module_prefix
from ..parallel.sharding import shard_params
from ..train.steps import build_infer_step
from ..train.train_state import checkpoint_steps
from ..utils.config import parse_config_py
from ..utils.device import resolve_device, strict_float32
from .common import (add_mesh_args, check_divisible, first_feat_dim, launch,
                     load_side_tables, load_table, make_dataset, mesh_shape,
                     pipeline_summary, rank_logger, row_shard)

# seed of the random weights when no checkpoint is given
WEIGHT_SEED = 0


def synthetic_records(n_videos: int, cfg: BigCConfig, model_dims: bool):
    """(proposal, GT) records, generated lazily, and their feature width."""
    data = SyntheticVidVRDSet(n_videos, cfg, model_dims)
    return (data[i] for i in range(n_videos)), data.feat_dim


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
                seed: int = WEIGHT_SEED, tables_path=None) -> BigC:
    """BigC on the CPU: random weights from ``seed`` and the config's name
    and bias tables (zeros where their files are absent), the name table
    and v7 position table of ``tables_path`` where given
    (``common.load_side_tables``), or the weights of a checkpoint
    (:func:`load_state`)."""
    e, c = cfg.num_enti_cats, cfg.num_pred_cats
    enti_emb, pos_tab = load_side_tables(tables_path, load_table(
        model_config.get("EntiNameEmb_path"), (e, cfg.dim_clsme)))
    model = BigC(cfg, enti_name_emb=enti_emb,
                 generator=torch.Generator().manual_seed(seed),
                 pos_emb_table=pos_tab)
    load_bias_matrix(model, load_table(model_config.get("bias_matrix_path"),
                                   (e, e, c)))
    if ckpt_path:
        model.load_state_dict(load_state(ckpt_path), strict=True)
    return model


def split_records(args, cfg: BigCConfig, model_config: dict, split_cfg):
    """(records, feature width, spec extras, dataset or None): the
    in-memory synthetic records with ``--synthetic`` alone, else the split
    of ``split_cfg`` in the reference layout (first written under
    ``--synthetic_root`` with ``--synthetic``)."""
    if args.synthetic and not args.synthetic_root:
        data = SyntheticVidVRDSet(args.synthetic, cfg,
                                  args.synthetic_model_dims)
        extra = FULL_SIZE_BUCKETS if args.synthetic_model_dims else {}
        return ((data[i] for i in range(args.synthetic)), data.feat_dim,
                extra, None)
    dims = ({"dim_feat": model_config["dim_feat"],
             "dim_i3d": model_config.get("dim_i3d")}
            if args.synthetic_model_dims else {})
    # an explicit --fmt wins (exp1 is PKU without I3D: --use_pku --fmt
    # pku); --use_pku alone means pku_i3d; with neither, the config's fmt
    fmt = args.fmt or ("pku_i3d" if args.use_pku else None)
    dataset, _ = make_dataset(split_cfg, "vidvrd", synthetic=args.synthetic,
                              synthetic_root=args.synthetic_root, fmt=fmt,
                              **dims)
    feat_dim = first_feat_dim(item[0] for item in dataset)
    return iter(dataset), feat_dim, {}, dataset


def inference_then_eval(args, mesh=None):
    """Inference, then the metrics; ``mesh`` makes it one rank of a sharded
    run, whose rank 0 returns the metrics (the others None)."""
    device = resolve_device(args.device) if mesh is None else mesh.device
    strict_float32()
    experiment_dir = args.output_dir or os.path.dirname(args.cfg_path)
    log_dir = os.path.join(experiment_dir, "logfile")
    os.makedirs(log_dir, exist_ok=True)
    logger, writes = rank_logger(os.path.join(log_dir, "eval_torch.log"), mesh)
    all_cfgs = parse_config_py(args.cfg_path)
    model_config = all_cfgs["model_config"]
    topk = args.topk or all_cfgs.get("inference_config", {}).get("topk", 10)
    if args.compute_dtype:
        model_config = dict(model_config, compute_dtype=args.compute_dtype)
    cfg = BigCConfig.from_dict(model_config, variant="v10")
    t0 = time.perf_counter()
    records, feat_dim, extra, dataset = split_records(
        args, cfg, model_config, all_cfgs.get("test_dataset_config", {}))
    if dataset is not None:
        logger.info(f"dataset: {len(dataset)} videos")
    spec = BucketSpec(feat_dim=feat_dim, feat_dtype=args.feat_dtype, **extra)

    model = build_model(cfg, model_config, args.ckpt_path,
                        tables_path=args.tables_path)
    if args.ckpt_path:
        logger.info(f"loaded checkpoint {args.ckpt_path}")
    model = model.to(device)
    if mesh is not None:
        shard_params(model, mesh)
        logger.info(f"inference over {mesh}: {len(model.tp_plan)} "
                    "tensor-parallel parameters")
    infer = build_infer_step(model, topk=topk, mesh=mesh)
    convertor = EvalFmtCvtor("vidvrd")
    predict_relations = {}
    # the GT graphs are collected in the streaming pass (they are small)
    gt_relations = {} if not args.gt_json else None
    n_videos = n_batches = 0
    infer_s = 0.0
    ring = StagingRing(device)
    logger.info(f"start inference on {device}...")
    try:
        for _, rows, props, _ in prefetch(bucketed_batches(
                records, spec, args.batch_size, with_gt=False,
                staging=ring, shard=row_shard(mesh))):
            props = ring.ship(props)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t1 = time.perf_counter()
            trip = infer(props).numpy()   # the host copy ends the device work
            infer_s += time.perf_counter() - t1
            n_batches += 1
            # batch remainders repeat the last video; the dict update
            # dedups them
            for i, (prop, gt) in enumerate(rows):
                predict_relations.update(convertor.to_eval_format_pr(
                    prop, trip.video(i), use_pku=args.use_pku))
                if gt_relations is not None and gt is not None:
                    gt_relations.update(convertor.to_eval_format_gt(gt))
                n_videos += 1
    finally:
        ring.close()
    wall_s = time.perf_counter() - t0
    logger.info(f"inference done on {n_videos} videos in {n_batches} "
                f"batches, {infer_s:.3f} s in forward + triplets, "
                f"{wall_s:.3f} s from the split's first read")
    if not writes:
        return None

    mean_ap, rec_at_n, prec_at_n = eval_relation_with_gt(
        dataset_type="vidvrd", logger=logger,
        prediction_results=predict_relations, gt_relations=gt_relations,
        gt_relations_path=args.gt_json)
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
                infer_seconds=infer_s, wall_seconds=wall_s,
                pipeline=pipeline_summary(ring, dataset),
                device=str(device),
                mesh=None if mesh is None else [mesh.n_data, mesh.n_model])


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
                        choices=("float32", "bfloat16", "int8"),
                        help="feature dtype on the device: bfloat16 is a "
                             "cast after the copy; int8 is packed on the "
                             "host with a scale per video, and the "
                             "encoder's first visual layer runs as an int8 "
                             "product")
    parser.add_argument("--compute_dtype", type=str, default=None,
                        choices=("float32", "bfloat16"),
                        help="override the model compute dtype "
                             "(config key compute_dtype)")
    parser.add_argument("--use_pku", action="store_true",
                        help="PKU tracklets: pku_i3d format (unless --fmt) "
                             "and PKU entity names")
    parser.add_argument("--fmt", type=str, default=None,
                        choices=("mega", "pku", "pku_i3d"),
                        help="tracklet format; default the dataset "
                             "config's, or pku_i3d with --use_pku")
    parser.add_argument("--gt_json", type=str, default=None,
                        help="challenge-format GT file (default: the GT of "
                             "the split's annotations)")
    parser.add_argument("--tables_path", type=str, default=None,
                        help="tables.npz of the frozen name embedding "
                             "(enti_name_emb) and position table")
    parser.add_argument("--synthetic", type=int, default=0,
                        help="evaluate on N synthetic videos: written in "
                             "the reference layout under --synthetic_root "
                             "and read from there, or, without it, drawn "
                             "in memory from data/synthetic.make_video (as "
                             "bench.py)")
    parser.add_argument("--synthetic_root", type=str, default=None,
                        help="directory of the --synthetic split on disk")
    parser.add_argument("--synthetic_model_dims", action="store_true",
                        help="synthetic features at the config's dims (in "
                             "memory: bench.py's full-size recipe, packed "
                             "at N=50 tracklets x T=256 frames)")
    add_mesh_args(parser)
    return parser.parse_args(argv)


def main(argv=None) -> dict:
    """Evaluate as the flags say; returns rank 0's metrics."""
    args = parse_args(argv)
    shape = mesh_shape(args)
    check_divisible("batch_size", args.batch_size, shape)
    return launch(inference_then_eval, args, shape)


if __name__ == "__main__":
    main()
