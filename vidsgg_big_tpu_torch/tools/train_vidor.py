"""Train on VidOR with the port: the BIG-C classification stage (default),
the Base-C baseline (``--train_baseline``) or the grounding stage
(``--train_grounding``), as the reference CLI's flags select them.

Counterpart of the JAX package's ``tools/train_vidor.py``
(``train_cls_stage`` + ``_generic_train`` :66-83, :336-440;
``train_baseline`` :86-188; ``train_grounding_stage`` :191-335; reference
tools/train_vidor.py:175-706).  Run as

    python -m vidsgg_big_tpu_torch.tools.train_vidor \\
        --cfg_path experiments/exp4/config_.py [--device cpu]
    python -m vidsgg_big_tpu_torch.tools.train_vidor --train_baseline \\
        --cfg_path experiments/exp6/config_.py ...
    python -m vidsgg_big_tpu_torch.tools.train_vidor --train_grounding \\
        --cfg_path experiments/grounding_weights/config_.py ...

to train on the config's ``train_dataset_config`` split in the reference
layout (tracklets in 500-video proposal shards, classemes, annotation
JSONs, and for the grounding stage the I3D clip features of
``video_feature_dir``; a per-video ``.npz`` cache under ``cache_dir``).
``--synthetic N --synthetic_root DIR`` first writes N videos in that layout
under DIR (``data/synthetic_raw``) and trains on them; ``--synthetic N``
alone draws N in-memory VidOR-shaped videos instead
(``data/synthetic_vidor``; with ``--synthetic_model_dims`` at full size).

The classification modes stream videos in a seeded shuffle per epoch into
per-(N, T) bucket batches on the default N ladder (up to 192), with GT at
``p_bucket = model_config.get("max_preds", 128)`` and the vIoU grid at
t_abs=4096, the milestones converted to iterations by ``ceil(n / batch)``;
epoch 0 fills a device record cache (``--device_cache_gb``, 4 by default, 0
off) from which later epochs assemble their batches on the card when the
split fits.  Checkpoints go to ``checkpoints_cls_<save_tag>`` /
``checkpoints_base_<save_tag>``, which ``tools/eval_vidor --ckpt_path``
serves.  The grounding stage batches on the grounding clip ladder and
starts its name tables from the config's ``EntiNameEmb_path`` /
``PredNameEmb_path`` where those files exist.  In every mode batches are
packed on a prefetch thread into reused pinned slots and copied to the card
on a copy stream (``data/transfer.StagingRing``), each step draws its
randomness from a generator of (seed + 1, global step), repeats padding a
batch are masked out of the loss, and a SIGTERM / SIGINT (or
``--stop_after_batches``) stops at a step boundary with a checkpoint that
``--from_checkpoint`` resumes exactly.  As in the JAX CLI, ``--tables_path``
is read by the classification stage only and the cache serves the
classification modes only.
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import os
import time

import numpy as np
import torch

from ..data.bucketing import (BucketSpec, iter_shuffled, pick_unbounded,
                              stream_buckets)
from ..data.device_cache import make_cache
from ..data.prefetch import prefetch
from ..data.synthetic_vidor import SyntheticGroundingSet, SyntheticVidORSet
from ..data.transfer import StagingRing, tree_map, wire_dtype
from ..data.types import GraphBatch, graph_leaves, pack_gt
from ..models.base_c import BaseCConfig
from ..models.big_c import BigCConfig
from ..models.grounding import GroundingConfig, GroundingModel
from ..train.grounding_steps import build_grounding_train_step
from ..train.loop import install_stop_handler, run_epochs
from ..train.steps import build_basec_train_step, build_train_step
from ..train.train_state import (TrainState, load_checkpoint,
                                 load_checkpoint_position)
from ..utils.config import parse_config_py
from ..utils.device import resolve_device, strict_float32
from ..utils.logger import MetricWriter, create_logger
from .common import (first_feat_dim, has_table, load_tables, make_dataset,
                     pipeline_summary, tracklet_epochs)
from .eval_vidor import build_basec_model
from .eval_vidvrd import build_model

# flags of the JAX CLI that this slice leaves out, with their ROADMAP item
LEFT_OUT = {"mesh": "A9 (multi-GPU)", "data_parallel": "A9 (multi-GPU)"}
# the GT trajectory ladder of the JAX CLI's make_batch
G_LADDER = (32, 64, 128)
# the classification modes' vIoU grid covers VidOR's video-length bound
# (JAX CLI :137, :388-390)
T_ABS = 4096
EXTRA_METRICS = {"cls": ("cls_pos", "cls_neg", "adj", "grad_norm"),
                 "base": ("cls", "grad_norm")}


def make_batch(rows, t_bucket: int, n_real: int, dim_feat: int,
               p_bucket: int, wire: torch.dtype, staging=None):
    """rows: [(clip features, GT)] padded to the batch size by repeats of
    the last video, whose GT masks are zeroed so they add nothing to the
    loss.  Returns (feats (B, T, D) in ``wire``, clip_mask, n_clips,
    GraphBatch, video_len): host tensors, in a slot of ``staging`` (a
    ``transfer.StagingRing``) where given."""
    b = len(rows)
    gb = pick_unbounded(max(gt.num_trajs for _, gt in rows), G_LADDER)
    leaves = {"feats": ((b, t_bucket, dim_feat), wire),
              "clip_mask": ((b, t_bucket), torch.bool),
              "n_clips": ((b,), torch.int64),
              "video_len": ((b,), torch.int64)}
    leaves.update({"g_" + k: v for k, v in graph_leaves(
        b, gb, 64, p_bucket).items()})
    out = (staging.acquire(leaves) if staging is not None else
           {k: torch.empty(shape, dtype=dt)
            for k, (shape, dt) in leaves.items()})
    feats = out["feats"]
    for i, (vf, gt) in enumerate(rows):
        n = min(vf.shape[0], t_bucket)
        feats[i, :n].copy_(torch.from_numpy(np.asarray(vf[:n], np.float32)))
        feats[i, n:].zero_()
        out["n_clips"][i] = n
        out["video_len"][i] = gt.video_len
    packed = [pack_gt(gt, gb, 64, p_bucket) for _, gt in rows]
    for f in dataclasses.fields(GraphBatch):
        np.stack([getattr(g, f.name) for g in packed],
                 out=out["g_" + f.name].numpy())
    real = torch.arange(b) < n_real
    out["g_traj_mask"] &= real[:, None]
    out["g_pred_mask"] &= real[:, None]
    torch.lt(torch.arange(t_bucket)[None], out["n_clips"][:, None],
             out=out["clip_mask"])
    gts = GraphBatch(**{f.name: out["g_" + f.name]
                        for f in dataclasses.fields(GraphBatch)})
    return feats, out["clip_mask"], out["n_clips"], gts, out["video_len"]


def _to_device(batch, device):
    """One grounding batch on ``device``: a plain copy, for a batch put
    once (the trainer stages its batches through a StagingRing)."""
    return tree_map(lambda x: x.to(device), batch)


def _dataset(args, all_cfgs, logger, in_memory):
    """The train split: ``in_memory()`` with ``--synthetic`` alone, else
    the config's split in the reference layout (first written under
    ``--synthetic_root`` with ``--synthetic``)."""
    if args.synthetic and not args.synthetic_root:
        dataset = in_memory()
        logger.info(f"dataset: {len(dataset)} in-memory synthetic videos")
        return dataset
    dataset, _ = make_dataset(all_cfgs["train_dataset_config"], "vidor",
                              synthetic=args.synthetic,
                              synthetic_root=args.synthetic_root)
    logger.info(f"dataset: {len(dataset)} videos")
    return dataset


def _setup(args, tag):
    """(device, experiment dir, logger, metric writer, all configs, model
    config with the --compute_dtype override, train_config), as the JAX
    CLI's ``_setup``."""
    device = resolve_device(args.device)
    strict_float32()
    experiment_dir = args.output_dir or os.path.dirname(args.cfg_path)
    log_dir = os.path.join(experiment_dir, "logfile")
    os.makedirs(log_dir, exist_ok=True)
    logger = create_logger(os.path.join(log_dir,
                                        f"train_{tag}_{args.save_tag}.log"))
    writer = MetricWriter(log_dir)
    all_cfgs = parse_config_py(args.cfg_path)
    mc = all_cfgs["model_config"]
    if args.compute_dtype:
        mc = dict(mc, compute_dtype=args.compute_dtype)
    return device, experiment_dir, logger, writer, all_cfgs, mc, \
        all_cfgs["train_config"]


def _resume(args, logger, state, ckpt_dir, iters_per_epoch):
    """(start epoch, start batch): the checkpoint's position where
    ``--from_checkpoint`` is given (its sidecar epoch is authoritative:
    bucketed epochs may run more steps than iters_per_epoch), else 0, 0."""
    if not args.from_checkpoint:
        return 0, 0
    step = load_checkpoint(ckpt_dir, state)
    epoch, start_batch = load_checkpoint_position(ckpt_dir, step)
    start_epoch = epoch if epoch is not None else step // iters_per_epoch
    logger.info(f"resumed from {ckpt_dir} at step {step} (epoch "
                f"{start_epoch}" + (f", batch {start_batch}"
                                    if start_batch else "") + ")")
    return start_epoch, start_batch


def _summary(state, ckpt_dir, writer, device, batch_size, logger,
             pipeline, n_videos):
    summary = {"step": state.step, "ckpt_dir": ckpt_dir,
               "metrics": writer.path, "device": str(device),
               "batch_size": batch_size, "n_videos": n_videos,
               "pipeline": pipeline}
    if device.type == "cuda":
        summary["max_memory_allocated"] = torch.cuda.max_memory_allocated(
            device)
        summary["memory_allocated"] = torch.cuda.memory_allocated(device)
    logger.info(f"done: {summary}")
    return summary


def train_classification(args, baseline: bool) -> dict:
    """The BIG-C v7 classification stage (JAX ``train_cls_stage`` +
    ``_generic_train``) or, with ``baseline``, Base-C (``train_baseline``):
    one loop, their own models, steps and checkpoint directories."""
    tag = "base" if baseline else "cls"
    device, experiment_dir, logger, writer, all_cfgs, mc, train_config = \
        _setup(args, tag)
    if baseline:
        cfg = BaseCConfig.from_dict(mc)
        model = build_basec_model(cfg, mc, seed=args.seed)
        if args.tables_path:
            logger.info("--tables_path is not read by the baseline mode "
                        "(as the JAX CLI)")
    else:
        cfg = BigCConfig.from_dict(mc, variant="v7")
        model = build_model(cfg, mc, seed=args.seed,
                            tables_path=args.tables_path)
    # random weights from --seed; the config's name and bias tables where
    # their files exist (zeros otherwise, as the JAX CLI's load_tables)
    model = model.to(device)
    dataset = _dataset(args, all_cfgs, logger, lambda: SyntheticVidORSet(
        args.synthetic, cfg.dim_feat, args.synthetic_model_dims))

    def row_of(item):
        return item[-2], item[-1]

    feat_dim = (dataset.feat_dim if hasattr(dataset, "feat_dim") else
                first_feat_dim(row_of(item)[0] for item in dataset))

    batch_size = args.batch_size or train_config["batch_size"]
    total_epoch = args.epochs or train_config["total_epoch"]
    # ceil: the reference converts milestone epochs to iterations through
    # len(dataloader) with drop_last=False (reference
    # tools/train_vidvrd.py:123-125); the milestones are an iteration count
    iters_per_epoch = max(-(-len(dataset) // batch_size), 1)
    milestones = [m * iters_per_epoch
                  for m in train_config["epoch_lr_milestones"]]
    state = TrainState(model, train_config["initial_lr"],
                       train_config["lr_decay"], milestones)
    wire = wire_dtype(args.feat_dtype, cfg.compute_dtype)
    # the default N ladder (tops at 192: VidOR allows max_proposal=180);
    # max_preds sits in the dataset configs, so p_bucket is 128 for exp4-6
    # as in JAX; int8 features are packed with a scale per video
    spec = BucketSpec(feat_dim=feat_dim, p_bucket=mc.get("max_preds", 128),
                      feat_dtype=str(wire).removeprefix("torch."))
    ckpt_dir = args.ckpt_path or os.path.join(
        experiment_dir, f"checkpoints_{tag}_{args.save_tag}")
    start_epoch, start_batch = _resume(args, logger, state, ckpt_dir,
                                       iters_per_epoch)
    # VidOR's train-split redirects are by content (empty or overlong
    # videos): such a video never surfaces, the cache stays incomplete and
    # is dropped after the first full epoch; every epoch stays on the host
    cache = make_cache(args, dataset, batch_size)
    ring = StagingRing(device)
    epoch_stream, preput = tracklet_epochs(dataset, spec, batch_size, ring,
                                           cache, logger, map_fn=row_of)
    build = build_basec_train_step if baseline else build_train_step
    step_fn = build(model, state, t_abs=T_ABS)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    try:
        state = run_epochs(
            state, lambda b, g: step_fn(*b[2:], generator=g), epoch_stream,
            start_epoch=start_epoch, total_epoch=total_epoch,
            base_seed=args.seed + 1, writer=writer, logger=logger,
            ckpt_dir=ckpt_dir, ckpt_every=args.ckpt_every,
            start_batch=start_batch, extra_metrics=EXTRA_METRICS[tag],
            should_stop=install_stop_handler(logger), preput=preput,
            stop_after_batches=args.stop_after_batches)
    finally:
        ring.close()
    writer.close()
    return _summary(state, ckpt_dir, writer, device, batch_size, logger,
                    pipeline_summary(ring, dataset, cache), len(dataset))


def train_grounding_stage(args) -> dict:
    device, experiment_dir, logger, writer, all_cfgs, mc, train_config = \
        _setup(args, "grd")
    cfg = GroundingConfig.from_dict(mc)
    dataset = _dataset(args, all_cfgs, logger, lambda: SyntheticGroundingSet(
        args.synthetic, cfg.dim_feat, args.synthetic_model_dims))
    if not getattr(dataset, "use_video_features", True):
        raise ValueError("the grounding stage needs video_feature_dir in "
                         "the dataset config")

    # random weights from --seed; the name tables start from the config's
    # GloVe tables where their files exist, as the JAX CLI's
    model = GroundingModel(
        cfg, generator=torch.Generator().manual_seed(args.seed))
    enti_emb, _, pred_emb = load_tables(mc, cfg.num_enti_cats,
                                        cfg.num_pred_cats, cfg.dim_clsme)
    with torch.no_grad():
        if has_table(mc, "EntiNameEmb_path"):
            model.EntiNameEmb.copy_(torch.from_numpy(enti_emb))
        if has_table(mc, "PredNameEmb_path"):
            model.PredNameEmb.copy_(torch.from_numpy(pred_emb))
    model = model.to(device)

    batch_size = args.batch_size or train_config["batch_size"]
    total_epoch = args.epochs or train_config["total_epoch"]
    # ceil: the reference converts milestone epochs to iterations through
    # len(dataloader) with drop_last=False (reference
    # tools/train_vidvrd.py:123-125); the milestones are an iteration count
    iters_per_epoch = max(-(-len(dataset) // batch_size), 1)
    milestones = [m * iters_per_epoch
                  for m in train_config["epoch_lr_milestones"]]
    state = TrainState(model, train_config["initial_lr"],
                       train_config["lr_decay"], milestones)
    p_bucket = mc.get("max_preds", 200)
    # JAX's grounding batches ship float32 for --feat_dtype int8 (its
    # make_batch knows bfloat16 and float32 only)
    wire = wire_dtype(None if args.feat_dtype == "int8" else args.feat_dtype,
                      cfg.compute_dtype)
    ring = StagingRing(device)

    def epoch_batches(epoch, skip=0):
        # the items are (clip features, GT) in memory and (clip features,
        # proposals, GT) on disk
        gen = stream_buckets(
            iter_shuffled(dataset, seed=epoch,
                          map_fn=lambda item: (item[0], item[-1])),
            lambda r: pick_unbounded(r[0].shape[0]), batch_size)
        if skip:          # resume: the stream is deterministic per epoch
            gen = itertools.islice(gen, skip, None)
        for t, rows_, n_real in gen:
            t0 = time.perf_counter()
            batch = make_batch(rows_, t, n_real, cfg.dim_feat, p_bucket,
                               wire, staging=ring)
            ring.pack_seconds.append(time.perf_counter() - t0)
            yield batch

    ckpt_dir = args.ckpt_path or os.path.join(
        experiment_dir, f"checkpoints_grd_{args.save_tag}")
    start_epoch, start_batch = _resume(args, logger, state, ckpt_dir,
                                       iters_per_epoch)

    step_fn = build_grounding_train_step(model, state)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    try:
        state = run_epochs(
            state, lambda b, g: step_fn(*b, generator=g),
            lambda epoch, skip: prefetch(epoch_batches(epoch, skip)),
            start_epoch=start_epoch, total_epoch=total_epoch,
            base_seed=args.seed + 1, writer=writer, logger=logger,
            ckpt_dir=ckpt_dir, ckpt_every=args.ckpt_every,
            start_batch=start_batch,
            should_stop=install_stop_handler(logger), preput=ring.ship,
            stop_after_batches=args.stop_after_batches)
    finally:
        ring.close()
    writer.close()
    return _summary(state, ckpt_dir, writer, device, batch_size, logger,
                    pipeline_summary(ring, dataset), len(dataset))


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--cfg_path", type=str, required=True)
    parser.add_argument("--train_baseline", action="store_true",
                        help="train Base-C, the pairwise baseline (exp6)")
    parser.add_argument("--train_grounding", action="store_true",
                        help="train the grounding stage; without either "
                             "flag, the BIG-C v7 classification stage")
    parser.add_argument("--save_tag", type=str, default="torch")
    parser.add_argument("--output_dir", type=str, default=None,
                        help="log and checkpoint directory (default: the "
                             "config's directory)")
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--ckpt_every", type=int, default=10,
                        help="checkpoint every N epochs and at the last "
                             "(default 10, the reference's cadence)")
    parser.add_argument("--from_checkpoint", action="store_true")
    parser.add_argument("--ckpt_path", type=str, default=None,
                        help="checkpoint directory (default: <output_dir>/"
                             "checkpoints_{cls,base,grd}_<save_tag>)")
    parser.add_argument("--compute_dtype", type=str, default=None,
                        choices=("float32", "bfloat16"))
    parser.add_argument("--feat_dtype", type=str, default=None,
                        choices=("float32", "bfloat16", "int8"),
                        help="feature dtype of a batch (default: bfloat16 "
                             "under bfloat16 compute, else float32); int8 "
                             "packs the tracklet features with a scale per "
                             "video (BIG-C dequantizes them once; Base-C "
                             "trains through its int8 first layer, as "
                             "JAX); the grounding stage ships float32 for "
                             "int8, as JAX")
    parser.add_argument("--stop_after_batches", type=int, default=0,
                        help="stop as on SIGTERM after this many batches "
                             "(checkpoint, exit 0)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default cuda; pass cpu to run "
                             "without a card)")
    parser.add_argument("--tables_path", type=str, default=None,
                        help="tables.npz of the frozen name embedding and "
                             "v7 position table (classification stage)")
    parser.add_argument("--device_cache_gb", type=float, default=4.0,
                        help="device memory for the record cache of the "
                             "classification modes: epochs after the first "
                             "assemble their batches on the card when the "
                             "split fits; 0 turns it off")
    parser.add_argument("--synthetic", type=int, default=0,
                        help="train on N synthetic VidOR-shaped videos: "
                             "written in the reference layout under "
                             "--synthetic_root and read from there, or, "
                             "without it, drawn in memory")
    parser.add_argument("--synthetic_root", type=str, default=None,
                        help="directory of the --synthetic split on disk")
    parser.add_argument("--synthetic_model_dims", action="store_true",
                        help="in-memory synthetic videos at full size: "
                             "2,400 frames (299 I3D clips, the T=512 "
                             "bucket), 46 tracklets with RoI features at "
                             "the config's dim_feat + 300 classeme, 12 GT "
                             "trajectories, 16 predicates")
    for flag, item in LEFT_OUT.items():
        kind = dict(action="store_true") if flag == "data_parallel" \
            else dict(default=None)
        parser.add_argument(f"--{flag}", **kind,
                            help=f"not ported yet (ROADMAP {item}); raises")
    return parser.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    for flag, item in LEFT_OUT.items():
        if getattr(args, flag) not in (None, False):
            raise NotImplementedError(
                f"--{flag} is not ported yet (ROADMAP {item})")
    if args.train_baseline:
        return train_classification(args, baseline=True)
    if args.train_grounding:
        return train_grounding_stage(args)
    return train_classification(args, baseline=False)


if __name__ == "__main__":
    main()
