"""Evaluate on VidOR with the port: BIG-C v7 (or, with ``--use_baseline``,
Base-C) classification (stage A), then, with a grounding config, the
grounding model's multi-bin temporal localisation of every predicted
triplet (stage B), then the VidOR relation-detection metrics.

Counterpart of the JAX package's ``tools/eval_vidor.py`` (the paper's
classification-then-grounding evaluation).  Run as

    python -m vidsgg_big_tpu_torch.tools.eval_vidor \\
        --cfg_path experiments/exp4/config_.py \\
        --grounding_cfg_path experiments/grounding_weights/config_.py \\
        --batch_size 4 [--device cpu]

to read the config's ``test_dataset_config`` split in the reference layout
(tracklets, classemes, annotation JSONs, a per-video ``.npz`` cache under
``cache_dir``; stage B reads each video's I3D clip features from
``video_feature_dir``), with the GT of its annotations or of
``--gt_json``; the annotation-free test split needs OpenCV for its videos'
lengths and sizes, and is scored only with ``--gt_json``.  ``--synthetic N
--synthetic_root DIR`` first writes N videos in that layout under DIR
(``data/synthetic_raw``) and reads them; ``--synthetic N`` alone draws N
in-memory VidOR-shaped records and seeded clip features instead
(``data/synthetic_vidor``).  For the paper's table-2 baseline:
``--use_baseline --cfg_path experiments/exp6/config_rt200.py``.
``--ckpt_path`` takes a reference-named ``state_dict`` file or a
``tools/train_vidor`` checkpoint directory (its newest ``ckpt_*.pt``);
``--tables_path`` a ``tables.npz`` of the frozen name embedding and v7
position table; ``--feat_dtype int8`` stores the stage-A features as int8
with a scale per video.  Batches are packed into reused pinned slots and
copied to the card on a copy stream (``data/transfer.StagingRing``), stage
A's on a prefetch thread.

``--data_parallel`` (every card) and ``--mesh D[,M]`` shard both stages'
batches over D data ranks, as the JAX CLI: stage A's BIG-C splits its MLPs,
FFNs and attention heads over M model ranks, while ``--use_baseline
--mesh`` runs every rank on the data axis (the JAX CLI's
``tools/eval_vidor.py:102-107``) and stage B's grounding model is never
split.  Each rank stages its rows, the outputs come back to every rank,
and rank 0 scores and writes.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from ..data.bucketing import (BucketSpec, bucketed_batches, pick_unbounded,
                              shard_range)
from ..data.prefetch import prefetch
from ..data.synthetic import clip_features, num_clips
from ..data.synthetic_vidor import (  # noqa: F401 (the CLIs' recipe)
    DIM_CLASSEME, FULL_SIZE_RECIPE, SMALL_DIM_FEAT, record_feat_dim,
    synthetic_records)
from ..data.transfer import StagingRing
from ..evaluation.convert import EvalFmtCvtor
from ..evaluation.metrics import eval_relation_with_gt
from ..models.base_c import BaseC, BaseCConfig
from ..models.big_c import BigCConfig, load_bias_matrix
from ..models.grounding import GroundingConfig, GroundingModel
from ..models.transplant import strip_module_prefix
from ..parallel.sharding import shard_params
from ..train.grounding_data import prepare_grounding_queries
from ..train.grounding_steps import build_grounding_infer_step
from ..train.steps import build_basec_infer_step, build_infer_step
from ..utils.config import parse_config_py
from ..utils.device import resolve_device, strict_float32
from .common import (MESH_HELP, add_mesh_args, check_divisible,
                     first_feat_dim, launch, load_side_tables, load_table,
                     make_dataset, mesh_shape, pipeline_summary, rank_logger,
                     row_shard)
from .eval_vidvrd import WEIGHT_SEED, build_model, load_state

# stage A packs tracklets on this ladder (the JAX CLI's :71-72)
STAGE_A_N_LADDER = (8, 16, 32, 64, 128, 192)
STAGE_B_MIN_BATCH = 4
# flags of the JAX CLI that this slice leaves out, with their ROADMAP item
LEFT_OUT = {"zeroshot": "A10 (zero-shot eval)",
            "save_hit_infos": "A10 (hit infos)"}


def _synthetic_seed(video_name: str) -> int:
    return int(video_name.split("_")[1])


def build_grounding_model(cfg: GroundingConfig, ckpt_path=None):
    """GroundingModel on the CPU: random weights from ``WEIGHT_SEED``, or a
    reference-named checkpoint (``module.`` prefixes stripped)."""
    model = GroundingModel(
        cfg, generator=torch.Generator().manual_seed(WEIGHT_SEED))
    if ckpt_path:
        sd = torch.load(ckpt_path, map_location="cpu", weights_only=True)
        model.load_state_dict(strip_module_prefix(sd), strict=True)
    return model


def build_basec_model(cfg: BaseCConfig, model_config: dict, ckpt_path=None,
                      seed: int = WEIGHT_SEED, tables_path=None) -> BaseC:
    """BaseC on the CPU: random weights from ``seed`` and the config's name
    and bias tables (zeros where their files are absent, as the JAX CLI's
    ``load_tables``), the name table of ``tables_path`` where given, or the
    weights of a checkpoint file or directory (``eval_vidvrd.load_state``).
    """
    e, c = cfg.num_enti_cats, cfg.num_pred_cats
    enti_emb, _ = load_side_tables(tables_path, load_table(
        model_config.get("EntiNameEmb_path"), (e, cfg.dim_clsme)))
    model = BaseC(cfg, enti_name_emb=enti_emb,
                  generator=torch.Generator().manual_seed(seed))
    load_bias_matrix(model, load_table(model_config.get("bias_matrix_path"),
                                   (e, e, c)))
    if ckpt_path:
        model.load_state_dict(load_state(ckpt_path), strict=True)
    return model


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def classify(args, logger, all_cfgs, records, feat_dim, device, mesh=None):
    """Stage A: BIG-C v7 (or Base-C) inference over ``records`` ((proposal,
    GT) pairs of ``feat_dim`` features) -> ({video: Triplets (numpy)},
    light rows (proposal without features, GT), stats).  Under ``mesh``
    each rank runs its rows of every batch (BIG-C split over the model
    ranks) and every rank gets every video's triplets."""
    mc = all_cfgs["model_config"]
    if args.compute_dtype:
        mc = dict(mc, compute_dtype=args.compute_dtype)
    topk = args.topk or all_cfgs.get("inference_config", {}).get("topk", 10)
    if args.use_baseline:
        cfg = BaseCConfig.from_dict(mc)
        model = build_basec_model(cfg, mc, args.ckpt_path,
                                  tables_path=args.tables_path)
        infer = build_basec_infer_step(model.to(device), topk=topk,
                                       mesh=mesh)
    else:
        cfg = BigCConfig.from_dict(mc, variant="v7")
        model = build_model(cfg, mc, args.ckpt_path,
                            tables_path=args.tables_path).to(device)
        if mesh is not None:
            shard_params(model, mesh)
            logger.info(f"stage A over {mesh}: {len(model.tp_plan)} "
                        "tensor-parallel parameters")
        infer = build_infer_step(model, topk=topk, mesh=mesh)
    if args.ckpt_path:
        logger.info(f"loaded stage-A checkpoint {args.ckpt_path}")
    spec = BucketSpec(feat_dim=feat_dim, n_ladder=STAGE_A_N_LADDER,
                      feat_dtype=args.feat_dtype)
    results, rows = {}, []
    n_batches, seconds = 0, 0.0
    ring = StagingRing(device)
    try:
        for _, brows, props, _ in prefetch(bucketed_batches(
                records, spec, args.batch_size, with_gt=False,
                staging=ring, shard=row_shard(mesh))):
            props = ring.ship(props)
            _sync(device)
            t0 = time.perf_counter()
            trip = infer(props).numpy()   # the host copy ends the device work
            seconds += time.perf_counter() - t0
            n_batches += 1
            for i, (prop, gt) in enumerate(brows):
                results[prop.video_name] = trip.video(i)
                # light rows for stage B and the GT: features dropped
                rows.append((dataclasses.replace(prop, features=[]), gt))
    finally:
        ring.close()
    logger.info(f"stage A done on {len(results)} videos in {n_batches} "
                f"batches, {seconds:.3f} s in forward + triplets")
    # unique valid triplets per video: stage B's query count
    triplets = [int(results[p.video_name].valid.sum()) for p, _ in rows]
    return results, rows, dict(stage_a_batches=n_batches,
                               stage_a_seconds=seconds,
                               stage_a_triplets=triplets,
                               stage_a_pipeline=pipeline_summary(ring))


def _expand_bins(prop, quint, scores3, duras, pooled, bins_probs, bins_mask):
    """(K+1)-bin expansion of one video's triplets (a copy of the JAX
    CLI's): score = cls score x bin prob, frames = round(norm span x
    video_len), clipped into the subject∩object window."""
    video_len = prop.video_len
    m, k1 = bins_mask.shape
    ds = duras[:, 0:1].astype(np.int64)
    de = duras[:, 1:2].astype(np.int64)
    fs = np.rint(pooled[..., 0] * video_len).astype(np.int64)   # (m, K1)
    fe = np.rint(pooled[..., 1] * video_len).astype(np.int64)
    fs = np.clip(fs, ds, de)
    fe = np.clip(fe, fs, de)
    scores = scores3.mean(-1)[:, None] * bins_probs             # (m, K1)
    sel = bins_mask
    if not sel.any():
        return None
    qq = np.broadcast_to(quint[:, None, :], (m, k1, 5))[sel]
    return qq, scores[sel], np.stack([fs, fe], axis=-1)[sel]


class SyntheticClips:
    """Stage B's clip features of the in-memory synthetic videos: seeded
    from the video's name and length."""

    @staticmethod
    def length(prop) -> int:
        return num_clips(prop.video_len)

    @staticmethod
    def load(prop, dim: int) -> np.ndarray:
        return clip_features(_synthetic_seed(prop.video_name),
                             prop.video_len, dim)


class DatasetClips:
    """Stage B's clip features of a split on disk (``video_feature_dir``):
    the clip count from the ``.npy`` header, the features when packed."""

    def __init__(self, dataset):
        self.dataset = dataset

    def length(self, prop) -> int:
        return self.dataset.video_feature_len(prop.video_name)

    def load(self, prop, dim: int) -> np.ndarray:
        vf = self.dataset.load_video_feature(prop.video_name)
        if vf.shape[1] != dim:
            raise ValueError(f"{prop.video_name}: clip features of width "
                             f"{vf.shape[1]}, the grounding model takes "
                             f"{dim}")
        return vf


def ground(args, logger, results, rows, device, clips, mesh=None):
    """Stage B: every valid triplet becomes a grounding query; videos are
    grouped on the (Q, T) grounding ladder (T from ``clips.length``) and
    run in batches of ``max(batch_size, 4)`` padded to one shape, their
    clip features from ``clips.load``; under ``mesh`` each rank packs and
    runs its rows of every batch.  Returns (predicted relations,
    stats)."""
    grd_cfgs = parse_config_py(args.grounding_cfg_path)
    gmc = grd_cfgs["model_config"]
    if args.compute_dtype:
        gmc = dict(gmc, compute_dtype=args.compute_dtype)
    gcfg = GroundingConfig.from_dict(gmc)
    icfg = grd_cfgs.get("inference_config", {})
    model = build_grounding_model(gcfg, args.grounding_ckpt_path)
    if args.grounding_ckpt_path:
        logger.info(f"loaded stage-B checkpoint {args.grounding_ckpt_path}")
    infer = build_grounding_infer_step(
        model.to(device), score_th=icfg.get("score_th", 0.9),
        tiou_th=icfg.get("tiou_th", 0.5),
        bins_th=args.bins_th or icfg.get("bins_th", 0.2),
        nms_th=icfg.get("nms_th", 0.8), mesh=mesh)
    cvt = EvalFmtCvtor("vidor")
    predict_relations, groups = {}, {}
    for prop, _ in rows:
        trip = results[prop.video_name]
        if not trip.valid.any():
            predict_relations[cvt._reset_video_name(prop.video_name)] = []
            continue
        v = trip.valid
        work = (prop, trip.quintuples[v], trip.scores[v], trip.dura_inters[v])
        key = (pick_unbounded(int(v.sum())),
               pick_unbounded(clips.length(prop)))
        groups.setdefault(key, []).append(work)

    b = max(args.batch_size, STAGE_B_MIN_BATCH)
    lo, hi = shard_range(b, row_shard(mesh))
    batches, seconds = [], 0.0
    ring = StagingRing(device)
    for q_bucket, t_bucket in sorted(groups):
        group = groups[(q_bucket, t_bucket)]
        logger.info(f"stage B: {len(group)} videos in (Q={q_bucket}, "
                    f"T={t_bucket}) bucket (batch {b})")
        for s in range(0, len(group), b):
            chunk = group[s:s + b]
            t0 = time.perf_counter()
            n = hi - lo
            host = ring.acquire({
                "feats": ((n, t_bucket, gcfg.dim_feat), torch.float32),
                "clip_mask": ((n, t_bucket), torch.bool),
                "clips": ((n,), torch.int64),
                "qc": ((n, q_bucket, 3), torch.int64),
                "temp": ((n, q_bucket, 2), torch.float32),
                "qm": ((n, q_bucket), torch.bool)})
            for x in host.values():
                x.zero_()
            for i, (prop, quint, _, duras) in enumerate(chunk[lo:hi]):
                vf = clips.load(prop, gcfg.dim_feat)
                nc = min(vf.shape[0], t_bucket)
                host["feats"][i, :nc] = torch.from_numpy(
                    np.asarray(vf[:nc], np.float32))
                host["clips"][i] = nc
                m = quint.shape[0]
                q_cats, q_temp, _ = prepare_grounding_queries(
                    quint, duras, None, prop.video_len)
                host["qc"][i, :m] = torch.as_tensor(q_cats)
                host["temp"][i, :m] = torch.as_tensor(q_temp)
                host["qm"][i, :m] = True
            torch.lt(torch.arange(t_bucket)[None], host["clips"][:, None],
                     out=host["clip_mask"])
            ring.pack_seconds.append(time.perf_counter() - t0)
            operands = ring.ship(tuple(host[k] for k in (
                "feats", "clip_mask", "clips", "qc", "temp", "qm")))
            _sync(device)
            t0 = time.perf_counter()
            pooled, bins_probs, bins_mask = (
                x.cpu().numpy() for x in infer(*operands))
            seconds += time.perf_counter() - t0
            batches.append([q_bucket, t_bucket, b])
            for i, (prop, quint, scores3, duras) in enumerate(chunk):
                m = quint.shape[0]
                out = _expand_bins(prop, quint, scores3, duras,
                                   pooled[i, :m], bins_probs[i, :m],
                                   bins_mask[i, :m])
                if out is None:
                    predict_relations[
                        cvt._reset_video_name(prop.video_name)] = []
                    continue
                predict_relations.update(cvt.to_eval_format_pr(prop, out))
    ring.close()
    logger.info(f"stage B done in {len(batches)} batches, {seconds:.3f} s "
                "in forward + decode")
    return predict_relations, dict(stage_b_batches=batches,
                                   stage_b_seconds=seconds,
                                   stage_b_pipeline=pipeline_summary(ring))


def split_records(args, all_cfgs, logger):
    """(records, feature width, clip source, dataset or None): the
    in-memory synthetic records with ``--synthetic`` alone, else the
    config's test split in the reference layout (first written under
    ``--synthetic_root`` with ``--synthetic``), streamed from its per-video
    cache without the clip features."""
    dim_feat = all_cfgs["model_config"]["dim_feat"]
    if args.synthetic and not args.synthetic_root:
        return (synthetic_records(args.synthetic, dim_feat,
                                  args.synthetic_model_dims),
                record_feat_dim(dim_feat, args.synthetic_model_dims),
                SyntheticClips(), None)
    dataset, _ = make_dataset(all_cfgs["test_dataset_config"], "vidor",
                              synthetic=args.synthetic,
                              synthetic_root=args.synthetic_root)
    logger.info(f"dataset: {len(dataset)} videos")
    names = dataset.video_name_list
    feat_dim = first_feat_dim(dataset.get_data(n)[0] for n in names)
    return ((dataset.get_data(n) for n in names), feat_dim,
            DatasetClips(dataset), dataset)


def inference_then_eval(args, mesh=None):
    """Both stages, then the metrics; ``mesh`` makes it one rank of a
    sharded run, whose rank 0 returns the metrics (the others None)."""
    device = resolve_device(args.device) if mesh is None else mesh.device
    strict_float32()
    experiment_dir = args.output_dir or os.path.dirname(args.cfg_path)
    log_dir = os.path.join(experiment_dir, "logfile")
    os.makedirs(log_dir, exist_ok=True)
    logger, writes = rank_logger(os.path.join(log_dir, "eval_vidor_torch.log"), mesh)
    all_cfgs = parse_config_py(args.cfg_path)
    t0 = time.perf_counter()
    records, feat_dim, clips, dataset = split_records(args, all_cfgs, logger)
    results, rows, stats = classify(args, logger, all_cfgs, records,
                                    feat_dim, device, mesh)
    if dataset is not None:
        stats["dataset_seconds"] = dict(dataset.seconds)
    cvt = EvalFmtCvtor("vidor")
    if args.grounding_cfg_path:
        if dataset is not None and not dataset.use_video_features:
            raise ValueError("--grounding_cfg_path needs the I3D clip "
                             "features of video_feature_dir in the dataset "
                             "config")
        predict_relations, b_stats = ground(args, logger, results, rows,
                                            device, clips, mesh)
        stats.update(b_stats)
    else:
        predict_relations = {}
        for prop, _ in rows:
            predict_relations.update(
                cvt.to_eval_format_pr(prop, results[prop.video_name]))
    stats["wall_seconds"] = time.perf_counter() - t0
    if not writes:
        return None
    stats.update(n_videos=len(rows), n_relations=sum(
        len(v) for v in predict_relations.values()), device=str(device),
        mesh=None if mesh is None else [mesh.n_data, mesh.n_model])
    if args.save_json_results:
        split = all_cfgs.get("test_dataset_config", {}).get("split", "val")
        p = os.path.join(experiment_dir,
                         f"VidOR{split}_predict_relations_torch.json")
        with open(p, "w") as f:
            json.dump(predict_relations, f)
        logger.info(f"predict_relations saved at {p}")
    if all(gt is None for _, gt in rows) and not args.gt_json:
        logger.info("the split has no ground truth; no metrics")
        return stats
    gt_relations = None
    if not args.gt_json:
        gt_relations = {}
        for _, gt in rows:
            gt_relations.update(cvt.to_eval_format_gt(gt))

    mean_ap, rec_at_n, prec_at_n = eval_relation_with_gt(
        dataset_type="vidor", logger=logger,
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
    return dict(metrics, **stats)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--cfg_path", type=str, required=True,
                        help="stage-A (BIG-C v7, or Base-C with "
                             "--use_baseline) experiment config")
    parser.add_argument("--use_baseline", action="store_true",
                        help="stage A is Base-C, the pairwise baseline "
                             "(exp6)")
    parser.add_argument("--grounding_cfg_path", type=str, default=None,
                        help="stage-B grounding config; without it the "
                             "stage-A triplets are scored as they are")
    ckpt_help = ("torch state_dict in the reference parameter names "
                 "('module.' prefixes are stripped); default: random "
                 "weights from a fixed seed")
    parser.add_argument("--ckpt_path", type=str, default=None,
                        help=ckpt_help + ", or a train_vidor checkpoint "
                             "directory (its newest ckpt_*.pt).  A v7 "
                             "checkpoint carries its frozen pos_embedding "
                             "table, so no --tables_path is needed")
    parser.add_argument("--grounding_ckpt_path", type=str, default=None,
                        help=ckpt_help)
    parser.add_argument("--output_dir", type=str, default=None,
                        help="log and result directory (default: the "
                             "config's directory)")
    parser.add_argument("--topk", type=int, default=None)
    parser.add_argument("--bins_th", type=float, default=None)
    parser.add_argument("--batch_size", type=int, default=1,
                        help="stage-A batch; stage B runs max(this, 4)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default cuda; pass cpu to run "
                             "without a card)")
    parser.add_argument("--metrics_json", type=str, default=None,
                        help="write {mAP, recall@K, tagging P@K} as JSON")
    parser.add_argument("--save_json_results", action="store_true")
    parser.add_argument("--feat_dtype", type=str, default="float32",
                        choices=("float32", "bfloat16", "int8"),
                        help="stage-A feature dtype on the device: bfloat16 "
                             "is a cast after the copy; int8 is packed on "
                             "the host with a scale per video, and the "
                             "encoder's first visual layer runs as an int8 "
                             "product")
    parser.add_argument("--compute_dtype", type=str, default=None,
                        choices=("float32", "bfloat16"),
                        help="override the compute dtype of both stages "
                             "(config key compute_dtype)")
    parser.add_argument("--gt_json", type=str, default=None,
                        help="challenge-format GT file (default: the GT of "
                             "the split's annotations)")
    parser.add_argument("--tables_path", type=str, default=None,
                        help="tables.npz of the frozen name embedding "
                             "(enti_name_emb) and v7 position table")
    parser.add_argument("--synthetic", type=int, default=0,
                        help="evaluate on N synthetic VidOR-shaped videos: "
                             "written in the reference layout under "
                             "--synthetic_root and read from there, or, "
                             "without it, drawn in memory with seeded I3D "
                             "clip features")
    parser.add_argument("--synthetic_root", type=str, default=None,
                        help="directory of the --synthetic split on disk")
    parser.add_argument("--synthetic_model_dims", action="store_true",
                        help="in-memory synthetic videos at full size: RoI "
                             "features at the config's dim_feat (+300 "
                             "classeme) and 2,400-frame videos with 46 "
                             "tracklets")
    add_mesh_args(parser, MESH_HELP[:-1] + " — BIG-C stage A only)")
    for flag, item in LEFT_OUT.items():
        parser.add_argument(f"--{flag}", action="store_true",
                            help=f"not ported yet (ROADMAP {item}); raises")
    return parser.parse_args(argv)


def main(argv=None) -> dict:
    """Evaluate as the flags say; returns rank 0's metrics."""
    args = parse_args(argv)
    for flag, item in LEFT_OUT.items():
        if getattr(args, flag):
            raise NotImplementedError(
                f"--{flag} is not ported yet (ROADMAP {item})")
    # JAX's quirk: the baseline under --mesh runs data parallel over every
    # device (tools/eval_vidor.py:102-107)
    shape = mesh_shape(args, tensor_parallel=not args.use_baseline)
    check_divisible("batch_size", args.batch_size, shape)
    check_divisible("the stage-B batch", max(args.batch_size,
                                             STAGE_B_MIN_BATCH), shape)
    return launch(inference_then_eval, args, shape)


if __name__ == "__main__":
    main()
