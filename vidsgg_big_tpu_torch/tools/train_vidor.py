"""Train on VidOR with the port: the grounding stage (stage 2 of BIG).

Counterpart of ``train_grounding_stage`` in the JAX package's
``tools/train_vidor.py`` (reference tools/train_vidor.py:175-706; the flag
``--train_grounding`` selects the mode as in the reference CLI).  Run as

    python -m vidsgg_big_tpu_torch.tools.train_vidor --train_grounding \\
        --cfg_path experiments/grounding_weights/config_.py \\
        --synthetic 16 --synthetic_model_dims [--device cpu]

Videos stream in a seeded shuffle per epoch into per-T-bucket batches (the
grounding clip ladder, repeats padding a batch masked out of the loss),
each step draws its randomness from a generator of (seed + 1, global step),
and a SIGTERM / SIGINT (or ``--stop_after_batches``) stops at a step
boundary with a checkpoint that ``--from_checkpoint`` resumes exactly.
This slice reads no dataset from disk: ``--synthetic N`` draws N in-memory
VidOR-shaped videos and their I3D clip features from ``data/synthetic``
(the on-disk splits are ROADMAP item A8).  The BIG-C classification and
Base-C modes are not ported yet.
"""
from __future__ import annotations

import argparse
import itertools
import os

import numpy as np
import torch

from ..data.bucketing import iter_shuffled, pick_unbounded, stream_buckets
from ..data.synthetic import clip_features, make_vidor_video
from ..data.transfer import to_device, wire_dtype
from ..data.types import pack_gt, stack_batches
from ..models.grounding import GroundingConfig, GroundingModel
from ..train.grounding_steps import build_grounding_train_step
from ..train.loop import install_stop_handler, run_epochs
from ..train.train_state import (TrainState, load_checkpoint,
                                 load_checkpoint_position)
from ..utils.config import parse_config_py
from ..utils.device import resolve_device, strict_float32
from ..utils.logger import MetricWriter, create_logger
from .eval_vidor import FULL_SIZE_RECIPE

# flags of the JAX CLI that this slice leaves out, with their ROADMAP item
LEFT_OUT = {"train_baseline": "A7b (Base-C)", "mesh": "A9 (multi-GPU)",
            "data_parallel": "A9 (multi-GPU)"}
# the GT trajectory ladder of the JAX CLI's make_batch
G_LADDER = (32, 64, 128)
RECORD_FEAT_DIM = 4        # proposal features are not read by grounding


class SyntheticGroundingSet:
    """N in-memory VidOR-shaped videos: item i is (clip features
    (num_clips, dim_feat) float32, GT record) of ``make_vidor_video(i)``,
    made when it is read."""

    def __init__(self, n_videos: int, dim_feat: int, model_dims: bool):
        self.n, self.dim_feat = n_videos, dim_feat
        self.recipe = FULL_SIZE_RECIPE if model_dims else {}

    def __len__(self):
        return self.n

    def __getitem__(self, i: int):
        _, gt = make_vidor_video(i, feat_dim=RECORD_FEAT_DIM, **self.recipe)
        return clip_features(i, gt.video_len, self.dim_feat), gt


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


def train_grounding_stage(args) -> dict:
    device = resolve_device(args.device)
    strict_float32()
    experiment_dir = args.output_dir or os.path.dirname(args.cfg_path)
    log_dir = os.path.join(experiment_dir, "logfile")
    os.makedirs(log_dir, exist_ok=True)
    logger = create_logger(os.path.join(log_dir,
                                        f"train_grd_{args.save_tag}.log"))
    writer = MetricWriter(log_dir)
    all_cfgs = parse_config_py(args.cfg_path)
    mc = all_cfgs["model_config"]
    if args.compute_dtype:
        mc = dict(mc, compute_dtype=args.compute_dtype)
    train_config = all_cfgs["train_config"]
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
    wire = wire_dtype(args.feat_dtype, cfg.compute_dtype)

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
    start_epoch, start_batch = 0, 0
    if args.from_checkpoint:
        step = load_checkpoint(ckpt_dir, state)
        epoch, start_batch = load_checkpoint_position(ckpt_dir, step)
        start_epoch = epoch if epoch is not None else step // iters_per_epoch
        logger.info(f"resumed from {ckpt_dir} at step {step} (epoch "
                    f"{start_epoch}" + (f", batch {start_batch}"
                                        if start_batch else "") + ")")

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
    summary = {"step": state.step, "ckpt_dir": ckpt_dir,
               "metrics": writer.path, "device": str(device),
               "batch_size": batch_size}
    if device.type == "cuda":
        summary["max_memory_allocated"] = torch.cuda.max_memory_allocated(
            device)
    logger.info(f"done: {summary}")
    return summary


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--cfg_path", type=str, required=True)
    parser.add_argument("--train_grounding", action="store_true",
                        help="train the grounding stage (the one mode "
                             "ported; BIG-C classification training is "
                             "ROADMAP A5/A7b)")
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
                        help="checkpoint directory (default: "
                             "<output_dir>/checkpoints_grd_<save_tag>)")
    parser.add_argument("--compute_dtype", type=str, default=None,
                        choices=("float32", "bfloat16"))
    parser.add_argument("--feat_dtype", type=str, default=None,
                        choices=("float32", "bfloat16"),
                        help="feature dtype of a batch (default: bfloat16 "
                             "under bfloat16 compute, else float32)")
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
                             "(299 I3D clips, the T=512 bucket), 12 GT "
                             "trajectories, 16 predicates")
    for flag, item in LEFT_OUT.items():
        kind = dict(type=str, default=None) if flag == "mesh" \
            else dict(action="store_true")
        parser.add_argument(f"--{flag}", **kind,
                            help=f"not ported yet (ROADMAP {item}); raises")
    return parser.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    for flag, item in LEFT_OUT.items():
        if getattr(args, flag):
            raise NotImplementedError(
                f"--{flag} is not ported yet (ROADMAP {item})")
    if not args.train_grounding:
        raise NotImplementedError(
            "BIG-C classification training on VidOR is not ported yet "
            "(ROADMAP A5, A7b); pass --train_grounding")
    if not args.synthetic:
        raise SystemExit("this port reads no VidOR split from disk yet "
                         "(ROADMAP A8); pass --synthetic N")
    return train_grounding_stage(args)


if __name__ == "__main__":
    main()
