"""Train BIG-C v10 on VidVRD with the port.

Counterpart of the JAX package's ``tools/train_vidvrd.py`` (:28-242;
reference tools/train_vidvrd.py:41-213): Adam at ``initial_lr`` with the
epoch milestones converted to iterations, a global-norm clip at 5.0,
checkpoints with exact mid-epoch resume and a metric journal.  Run as

    python -m vidsgg_big_tpu_torch.tools.train_vidvrd \\
        --cfg_path experiments/exp2/config_.py --synthetic 16 \\
        --synthetic_model_dims [--compute_dtype bfloat16] [--device cpu]

Videos stream in a seeded shuffle per epoch into per-(N, T) bucket batches
(repeats padding a batch are masked out of the loss), each step draws its
dropout from a generator of (seed + 1, global step), and a SIGTERM / SIGINT
(or ``--stop_after_batches``) stops at a step boundary with a checkpoint
that ``--from_checkpoint`` resumes exactly.  ``tools/eval_vidvrd
--ckpt_path <output_dir>/checkpoints_<save_tag>`` serves the result.  This
slice reads no dataset from disk: ``--synthetic N`` draws N in-memory
records from ``data/synthetic.make_video``; with ``--synthetic_model_dims``
at the config's feature widths and bench.py's record recipe (46 tracklets
on the N=50 rung, T=256).
"""
from __future__ import annotations

import argparse
import itertools
import os

import torch

from ..data.bucketing import BucketSpec, bucketed_batches, iter_shuffled
from ..data.synthetic_vidvrd import FULL_SIZE_BUCKETS, SyntheticVidVRDSet
from ..data.transfer import batch_to_device, wire_dtype
from ..models.big_c import BigCConfig
from ..train.loop import install_stop_handler, run_epochs
from ..train.steps import build_train_step
from ..train.train_state import (TrainState, load_checkpoint,
                                 load_checkpoint_position)
from ..utils.config import parse_config_py
from ..utils.device import resolve_device, strict_float32
from ..utils.logger import MetricWriter, create_logger
from .eval_vidvrd import build_model

# flags of the JAX CLI that this slice leaves out, with their ROADMAP item
LEFT_OUT = {"data_parallel": "A9 (multi-GPU)", "mesh": "A9 (multi-GPU)",
            "use_pku": "A8 (on-disk data)", "fmt": "A8 (on-disk data)",
            "synthetic_root": "A8 (on-disk data)",
            "tables_path": "A8 (on-disk data)",
            "device_cache_gb": "A8 (on-disk data)"}
# the vIoU grid must cover the video-length bound (JAX CLI :133-136)
T_ABS = 4096
EXTRA_METRICS = ("cls_pos", "cls_neg", "adj", "grad_norm")


def train(args):
    """Returns (summary, TrainState)."""
    device = resolve_device(args.device)
    strict_float32()
    experiment_dir = args.output_dir or os.path.dirname(args.cfg_path)
    log_dir = os.path.join(experiment_dir, "logfile")
    os.makedirs(log_dir, exist_ok=True)
    logger = create_logger(os.path.join(log_dir,
                                        f"train_{args.save_tag}.log"))
    writer = MetricWriter(log_dir)
    all_cfgs = parse_config_py(args.cfg_path)
    model_config = all_cfgs["model_config"]
    train_config = all_cfgs["train_config"]
    if args.compute_dtype:
        model_config = dict(model_config, compute_dtype=args.compute_dtype)
    logger.info(f"model_config: {model_config}")
    logger.info(f"train_config: {train_config}")
    cfg = BigCConfig.from_dict(model_config, variant="v10")
    dataset = SyntheticVidVRDSet(args.synthetic, cfg,
                                 args.synthetic_model_dims)
    logger.info(f"dataset: {len(dataset)} synthetic videos")

    # random weights from --seed; the name and bias tables of the config
    # where their files exist (zeros otherwise, as the JAX CLI)
    model = build_model(cfg, model_config, seed=args.seed).to(device)

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
    # int8 features are packed with a scale per video; BigC dequantizes
    # them once in train mode, so the int8 wire only cuts the H2D bytes
    spec = BucketSpec(feat_dim=dataset.feat_dim, g_bucket=32,
                      p_bucket=model_config.get("max_preds", 128),
                      feat_dtype=args.feat_dtype or "float32",
                      **(FULL_SIZE_BUCKETS if args.synthetic_model_dims
                         else {}))

    ckpt_dir = os.path.join(experiment_dir, f"checkpoints_{args.save_tag}")
    start_epoch, start_batch = 0, 0
    if args.from_checkpoint:
        path = args.ckpt_path or ckpt_dir
        step = load_checkpoint(path, state)
        # the sidecar epoch is authoritative: bucketed epochs may run more
        # steps than iters_per_epoch (partial-bucket flushes)
        epoch, start_batch = load_checkpoint_position(path, step)
        start_epoch = epoch if epoch is not None else step // iters_per_epoch
        logger.info(f"resumed from {path} at step {step} (epoch "
                    f"{start_epoch}" + (f", batch {start_batch}"
                                        if start_batch else "") + ")")

    def epoch_stream(epoch, skip):
        gen = bucketed_batches(iter_shuffled(dataset, seed=epoch), spec,
                               batch_size)
        if skip:          # resume: the stream is deterministic per epoch
            gen = itertools.islice(gen, skip, None)
        return gen

    def preput(batch):
        _, _, props, gts = batch
        return batch_to_device(props, gts, device, wire)

    step_fn = build_train_step(model, state, t_abs=T_ABS)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    logger.info("start training...")
    state = run_epochs(
        state, lambda b, g: step_fn(*b, generator=g), epoch_stream,
        start_epoch=start_epoch, total_epoch=total_epoch,
        base_seed=args.seed + 1, writer=writer, logger=logger,
        ckpt_dir=ckpt_dir, ckpt_every=args.ckpt_every,
        start_batch=start_batch, extra_metrics=EXTRA_METRICS,
        should_stop=install_stop_handler(logger), preput=preput,
        stop_after_batches=args.stop_after_batches)
    writer.close()
    summary = {"step": state.step, "ckpt_dir": ckpt_dir,
               "metrics": writer.path, "device": str(device),
               "batch_size": batch_size}
    if device.type == "cuda":
        summary["max_memory_allocated"] = torch.cuda.max_memory_allocated(
            device)
    logger.info(f"done: {summary}")
    return summary, state


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--cfg_path", type=str, required=True)
    parser.add_argument("--save_tag", type=str, default="")
    parser.add_argument("--from_checkpoint", action="store_true")
    parser.add_argument("--ckpt_path", type=str, default=None,
                        help="checkpoint directory to resume from (default: "
                             "<output_dir>/checkpoints_<save_tag>, where "
                             "checkpoints are written)")
    parser.add_argument("--output_dir", type=str, default=None,
                        help="log and checkpoint directory (default: the "
                             "config's directory)")
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--ckpt_every", type=int, default=10,
                        help="checkpoint every N epochs and at the last "
                             "(default 10, the reference's cadence)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--synthetic", type=int, default=0,
                        help="train on N in-memory synthetic videos "
                             "(reading the on-disk splits is ROADMAP A8)")
    parser.add_argument("--synthetic_model_dims", action="store_true",
                        help="full-size synthetic videos: features at the "
                             "config's dims and bench.py's recipe, packed "
                             "at N=50 tracklets x T=256 frames")
    parser.add_argument("--compute_dtype", type=str, default=None,
                        choices=("float32", "bfloat16"),
                        help="override the model compute dtype")
    parser.add_argument("--feat_dtype", type=str, default=None,
                        choices=("float32", "bfloat16", "int8"),
                        help="feature dtype of a batch (default: bfloat16 "
                             "under bfloat16 compute, else float32); int8 "
                             "packs a scale per video and is dequantized "
                             "once in the model")
    parser.add_argument("--stop_after_batches", type=int, default=0,
                        help="stop as on SIGTERM after this many batches "
                             "(checkpoint, exit 0)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default cuda; pass cpu to run "
                             "without a card)")
    for flag, item in LEFT_OUT.items():
        kind = dict(action="store_true") if flag in (
            "data_parallel", "use_pku") else dict(default=None)
        parser.add_argument(f"--{flag}", **kind,
                            help=f"not ported yet (ROADMAP {item}); raises")
    return parser.parse_args(argv)


def check_args(args):
    for flag, item in LEFT_OUT.items():
        if getattr(args, flag) not in (None, False):
            raise NotImplementedError(
                f"--{flag} is not ported yet (ROADMAP {item})")
    if not args.synthetic:
        raise SystemExit("this port reads no VidVRD split from disk yet "
                         "(ROADMAP A8); pass --synthetic N")


def main(argv=None) -> dict:
    args = parse_args(argv)
    check_args(args)
    return train(args)[0]


if __name__ == "__main__":
    main()
