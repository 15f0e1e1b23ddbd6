"""Train on VidOR with the port: the BIG-C classification stage (default),
the Base-C baseline (``--train_baseline``) or the grounding stage
(``--train_grounding``), as the reference CLI's flags select them.

Counterpart of the JAX package's ``tools/train_vidor.py``
(``train_cls_stage`` + ``_generic_train`` :66-83, :336-440;
``train_baseline`` :86-188; ``train_grounding_stage``; reference
tools/train_vidor.py:175-706).  Run as

    python -m vidsgg_big_tpu_torch.tools.train_vidor \\
        --cfg_path experiments/exp4/config_.py \\
        --synthetic 16 --synthetic_model_dims [--device cpu]
    python -m vidsgg_big_tpu_torch.tools.train_vidor --train_baseline \\
        --cfg_path experiments/exp6/config_.py --synthetic 16 ...
    python -m vidsgg_big_tpu_torch.tools.train_vidor --train_grounding \\
        --cfg_path experiments/grounding_weights/config_.py --synthetic 16 ...

The classification modes stream videos in a seeded shuffle per epoch into
per-(N, T) bucket batches on the default N ladder (up to 192), with GT at
``p_bucket = model_config.get("max_preds", 128)`` and the vIoU grid at
t_abs=4096, the milestones converted to iterations by ``ceil(n / batch)``;
checkpoints go to ``checkpoints_cls_<save_tag>`` / ``checkpoints_base_
<save_tag>``, which ``tools/eval_vidor --ckpt_path`` serves.  The grounding
stage batches on the grounding clip ladder.  In every mode each step draws
its randomness from a generator of (seed + 1, global step), repeats padding
a batch are masked out of the loss, and a SIGTERM / SIGINT (or
``--stop_after_batches``) stops at a step boundary with a checkpoint that
``--from_checkpoint`` resumes exactly.  This slice reads no dataset from
disk: ``--synthetic N`` draws N in-memory VidOR-shaped videos
(``data/synthetic_vidor``; the on-disk splits are ROADMAP item A8).
"""
from __future__ import annotations

import argparse
import itertools
import os

import numpy as np
import torch

from ..data.bucketing import (BucketSpec, bucketed_batches, iter_shuffled,
                              pick_unbounded, stream_buckets)
from ..data.synthetic_vidor import SyntheticGroundingSet, SyntheticVidORSet
from ..data.transfer import batch_to_device, to_device, wire_dtype
from ..data.types import pack_gt, stack_batches
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
from .eval_vidor import build_basec_model
from .eval_vidvrd import build_model

# flags of the JAX CLI that this slice leaves out, with their ROADMAP item
LEFT_OUT = {"mesh": "A9 (multi-GPU)", "data_parallel": "A9 (multi-GPU)",
            "synthetic_root": "A8 (on-disk data)",
            "tables_path": "A8 (on-disk data)",
            "device_cache_gb": "A8 (on-disk data)"}
# the GT trajectory ladder of the JAX CLI's make_batch
G_LADDER = (32, 64, 128)
# the classification modes' vIoU grid covers VidOR's video-length bound
# (JAX CLI :137, :388-390)
T_ABS = 4096
EXTRA_METRICS = {"cls": ("cls_pos", "cls_neg", "adj", "grad_norm"),
                 "base": ("cls", "grad_norm")}


def make_batch(rows, t_bucket: int, n_real: int, dim_feat: int,
               p_bucket: int, wire: torch.dtype):
    """rows: [(clip features, GT)] padded to the batch size by repeats of
    the last video, whose GT masks are zeroed so they add nothing to the
    loss.  Returns (feats (B, T, D) in ``wire``, clip_mask, n_clips,
    GraphBatch, video_len), CPU tensors."""
    b = len(rows)
    feats = np.zeros((b, t_bucket, dim_feat), np.float32)
    n_clips = np.zeros((b,), np.int64)
    video_len = np.zeros((b,), np.int64)
    gb = pick_unbounded(max(gt.num_trajs for _, gt in rows), G_LADDER)
    gts = []
    for i, (vf, gt) in enumerate(rows):
        n = min(vf.shape[0], t_bucket)
        feats[i, :n] = vf[:n]
        n_clips[i] = n
        video_len[i] = gt.video_len
        gts.append(pack_gt(gt, gb, 64, p_bucket))
    gts = stack_batches(gts)
    if n_real < b:
        real = np.arange(b) < n_real
        gts = gts.replace(traj_mask=gts.traj_mask & real[:, None],
                          pred_mask=gts.pred_mask & real[:, None])
    clip_mask = np.arange(t_bucket)[None] < n_clips[:, None]
    return (torch.from_numpy(feats).to(wire), torch.from_numpy(clip_mask),
            torch.from_numpy(n_clips), gts.to("cpu"),
            torch.from_numpy(video_len))


def _to_device(batch, device):
    """H2D of one batch: pinned and non-blocking on the card."""
    feats, clip_mask, n_clips, gts, video_len = batch
    gts = type(gts)(**{k: to_device(v, device) for k, v in vars(gts).items()})
    return (to_device(feats, device), to_device(clip_mask, device),
            to_device(n_clips, device), gts, to_device(video_len, device))


def _setup(args, tag):
    """(device, experiment dir, logger, metric writer, model_config with
    the --compute_dtype override, train_config), as the JAX CLI's
    ``_setup``."""
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
    return device, experiment_dir, logger, writer, mc, \
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


def _summary(state, ckpt_dir, writer, device, batch_size, logger):
    summary = {"step": state.step, "ckpt_dir": ckpt_dir,
               "metrics": writer.path, "device": str(device),
               "batch_size": batch_size}
    if device.type == "cuda":
        summary["max_memory_allocated"] = torch.cuda.max_memory_allocated(
            device)
    logger.info(f"done: {summary}")
    return summary


def train_classification(args, baseline: bool) -> dict:
    """The BIG-C v7 classification stage (JAX ``train_cls_stage`` +
    ``_generic_train``) or, with ``baseline``, Base-C (``train_baseline``):
    one loop, their own models, steps and checkpoint directories."""
    tag = "base" if baseline else "cls"
    device, experiment_dir, logger, writer, mc, train_config = _setup(
        args, tag)
    if baseline:
        cfg = BaseCConfig.from_dict(mc)
        model = build_basec_model(cfg, mc, seed=args.seed)
    else:
        cfg = BigCConfig.from_dict(mc, variant="v7")
        model = build_model(cfg, mc, seed=args.seed)
    # random weights from --seed; the config's name and bias tables where
    # their files exist (zeros otherwise, as the JAX CLI's load_tables)
    model = model.to(device)
    dataset = SyntheticVidORSet(args.synthetic, cfg.dim_feat,
                                args.synthetic_model_dims)
    logger.info(f"dataset: {len(dataset)} synthetic videos")

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
    spec = BucketSpec(feat_dim=dataset.feat_dim,
                      p_bucket=mc.get("max_preds", 128),
                      feat_dtype=args.feat_dtype or "float32")
    ckpt_dir = args.ckpt_path or os.path.join(
        experiment_dir, f"checkpoints_{tag}_{args.save_tag}")
    start_epoch, start_batch = _resume(args, logger, state, ckpt_dir,
                                       iters_per_epoch)

    def epoch_stream(epoch, skip):
        gen = bucketed_batches(iter_shuffled(dataset, seed=epoch), spec,
                               batch_size)
        if skip:          # resume: the stream is deterministic per epoch
            gen = itertools.islice(gen, skip, None)
        return gen

    def preput(batch):
        _, _, props, gts = batch
        return batch_to_device(props, gts, device, wire)

    build = build_basec_train_step if baseline else build_train_step
    step_fn = build(model, state, t_abs=T_ABS)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    state = run_epochs(
        state, lambda b, g: step_fn(*b, generator=g), epoch_stream,
        start_epoch=start_epoch, total_epoch=total_epoch,
        base_seed=args.seed + 1, writer=writer, logger=logger,
        ckpt_dir=ckpt_dir, ckpt_every=args.ckpt_every,
        start_batch=start_batch, extra_metrics=EXTRA_METRICS[tag],
        should_stop=install_stop_handler(logger), preput=preput,
        stop_after_batches=args.stop_after_batches)
    writer.close()
    return _summary(state, ckpt_dir, writer, device, batch_size, logger)


def train_grounding_stage(args) -> dict:
    device, experiment_dir, logger, writer, mc, train_config = _setup(
        args, "grd")
    cfg = GroundingConfig.from_dict(mc)
    dataset = SyntheticGroundingSet(args.synthetic, cfg.dim_feat,
                                    args.synthetic_model_dims)
    logger.info(f"dataset: {len(dataset)} synthetic videos")

    # the name tables start random: the GloVe tables of the config's
    # EntiNameEmb_path / PredNameEmb_path come with the on-disk data (A8)
    model = GroundingModel(
        cfg, generator=torch.Generator().manual_seed(args.seed)).to(device)

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

    def epoch_batches(epoch, skip=0):
        gen = stream_buckets(iter_shuffled(dataset, seed=epoch),
                             lambda r: pick_unbounded(r[0].shape[0]),
                             batch_size)
        if skip:          # resume: the stream is deterministic per epoch
            gen = itertools.islice(gen, skip, None)
        for t, rows_, n_real in gen:
            yield make_batch(rows_, t, n_real, cfg.dim_feat, p_bucket, wire)

    ckpt_dir = args.ckpt_path or os.path.join(
        experiment_dir, f"checkpoints_grd_{args.save_tag}")
    start_epoch, start_batch = _resume(args, logger, state, ckpt_dir,
                                       iters_per_epoch)

    step_fn = build_grounding_train_step(model, state)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    state = run_epochs(
        state, lambda b, g: step_fn(*b, generator=g),
        lambda epoch, skip: epoch_batches(epoch, skip),
        start_epoch=start_epoch, total_epoch=total_epoch,
        base_seed=args.seed + 1, writer=writer, logger=logger,
        ckpt_dir=ckpt_dir, ckpt_every=args.ckpt_every,
        start_batch=start_batch, should_stop=install_stop_handler(logger),
        preput=lambda b: _to_device(b, device),
        stop_after_batches=args.stop_after_batches)
    writer.close()
    return _summary(state, ckpt_dir, writer, device, batch_size, logger)


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
    parser.add_argument("--synthetic", type=int, default=0,
                        help="train on N in-memory VidOR-shaped videos "
                             "(reading the on-disk splits is ROADMAP A8)")
    parser.add_argument("--synthetic_model_dims", action="store_true",
                        help="full-size synthetic videos: 2,400 frames "
                             "(299 I3D clips, the T=512 bucket), 46 "
                             "tracklets with RoI features at the config's "
                             "dim_feat + 300 classeme, 12 GT trajectories, "
                             "16 predicates")
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
    if not args.synthetic:
        raise SystemExit("this port reads no VidOR split from disk yet "
                         "(ROADMAP A8); pass --synthetic N")
    if args.train_baseline:
        return train_classification(args, baseline=True)
    if args.train_grounding:
        return train_grounding_stage(args)
    return train_classification(args, baseline=False)


if __name__ == "__main__":
    main()
