"""Train BIG-C v10 on VidVRD with the port.

Counterpart of the JAX package's ``tools/train_vidvrd.py`` (:28-242;
reference tools/train_vidvrd.py:41-213): Adam at ``initial_lr`` with the
epoch milestones converted to iterations, a global-norm clip at 5.0,
checkpoints with exact mid-epoch resume and a metric journal.  Run as

    python -m vidsgg_big_tpu_torch.tools.train_vidvrd \\
        --cfg_path experiments/exp2/config_.py [--compute_dtype bfloat16] \\
        [--device cpu]

to train on the config's ``train_dataset_config`` split in the reference
layout (``--fmt`` / ``--use_pku`` pick the tracklet format, as the JAX CLI;
a per-video ``.npz`` cache under ``cache_dir``).  ``--synthetic N
--synthetic_root DIR`` first writes N videos in that layout under DIR
(``data/synthetic_raw``) and trains on them; ``--synthetic N`` alone draws
N in-memory records from ``data/synthetic.make_video`` instead (with
``--synthetic_model_dims`` at bench.py's full-size recipe, on the N=50,
T=256 rung).

Videos stream in a seeded shuffle per epoch into per-(N, T) bucket batches
(repeats padding a batch are masked out of the loss), packed on a prefetch
thread into reused pinned slots and copied to the card on a copy stream one
batch ahead of their step (``data/transfer.StagingRing``).  Epoch 0 fills
a device record cache (``--device_cache_gb``, 4 by default; 0 turns it
off) from which later epochs assemble their batches on the card when the
whole split fits; the losses are the same bits either way.  Each step
draws its dropout from a generator of (seed + 1, global step), and a
SIGTERM / SIGINT (or ``--stop_after_batches``) stops at a step boundary
with a checkpoint that ``--from_checkpoint`` resumes exactly.
``tools/eval_vidvrd --ckpt_path <output_dir>/checkpoints_<save_tag>``
serves the result.

``--data_parallel`` trains over every card (one rank each) and ``--mesh
D[,M]`` over D data ranks, with the model's MLPs, FFNs and attention heads
split over M ranks (``parallel/``), as the JAX CLI's flags: every rank
walks the same batch order and stages its rows of each batch, the losses
are global means, and rank 0 writes the journal and the checkpoints,
which are the same files under any mesh.  Started plainly the CLI spawns
one rank per card (the mesh must cover them); under ``torchrun`` it joins
the ranks started there.
"""
from __future__ import annotations

import argparse
import os

import torch

from ..data.bucketing import BucketSpec
from ..data.dataset import VIDVRD_OOM_VIDEOS
from ..data.device_cache import make_cache
from ..data.synthetic_vidvrd import FULL_SIZE_BUCKETS, SyntheticVidVRDSet
from ..data.transfer import StagingRing, wire_dtype
from ..models.big_c import BigCConfig
from ..parallel.sharding import shard_params
from ..train.loop import install_stop_handler, run_epochs
from ..train.steps import build_train_step
from ..train.train_state import (TrainState, load_checkpoint,
                                 load_checkpoint_position)
from ..utils.config import parse_config_py
from ..utils.device import resolve_device, strict_float32
from .common import (add_mesh_args, check_divisible, first_feat_dim, launch,
                     make_dataset, mesh_shape, pipeline_summary,
                     rank_outputs, row_shard, tracklet_epochs)
from .eval_vidvrd import build_model

# the vIoU grid must cover the video-length bound (JAX CLI :133-136)
T_ABS = 4096
EXTRA_METRICS = ("cls_pos", "cls_neg", "adj", "grad_norm")


def train(args, mesh=None):
    """Returns (summary, TrainState); ``mesh`` makes it one rank of a
    sharded run."""
    device = resolve_device(args.device) if mesh is None else mesh.device
    strict_float32()
    experiment_dir = args.output_dir or os.path.dirname(args.cfg_path)
    log_dir = os.path.join(experiment_dir, "logfile")
    os.makedirs(log_dir, exist_ok=True)
    logger, writer = rank_outputs(
        os.path.join(log_dir, f"train_{args.save_tag}.log"), log_dir, mesh)
    all_cfgs = parse_config_py(args.cfg_path)
    model_config = all_cfgs["model_config"]
    train_config = all_cfgs["train_config"]
    if args.compute_dtype:
        model_config = dict(model_config, compute_dtype=args.compute_dtype)
    logger.info(f"model_config: {model_config}")
    logger.info(f"train_config: {train_config}")
    cfg = BigCConfig.from_dict(model_config, variant="v10")
    if args.synthetic and not args.synthetic_root:
        dataset = SyntheticVidVRDSet(args.synthetic, cfg,
                                     args.synthetic_model_dims)
        feat_dim = dataset.feat_dim
        buckets = FULL_SIZE_BUCKETS if args.synthetic_model_dims else {}
        logger.info(f"dataset: {len(dataset)} in-memory synthetic videos")
    else:
        dims = ({"dim_feat": model_config["dim_feat"],
                 "dim_i3d": model_config.get("dim_i3d")}
                if args.synthetic_model_dims else {})
        # an explicit --fmt wins (exp1 is PKU without I3D: --use_pku --fmt
        # pku); --use_pku alone means pku_i3d; else the config's fmt
        fmt = args.fmt or ("pku_i3d" if args.use_pku else None)
        dataset, _ = make_dataset(
            all_cfgs["train_dataset_config"], "vidvrd",
            synthetic=args.synthetic, synthetic_root=args.synthetic_root,
            fmt=fmt, **dims)
        feat_dim = first_feat_dim(item[0] for item in dataset)
        buckets = {}
        logger.info(f"dataset: {len(dataset)} videos")

    # random weights from --seed; the name and bias tables of the config
    # where their files exist (zeros otherwise, as the JAX CLI), the name
    # table of --tables_path where given
    model = build_model(cfg, model_config, seed=args.seed,
                        tables_path=args.tables_path).to(device)
    if mesh is not None:
        shard_params(model, mesh)
        logger.info(f"training over {mesh}: {len(model.tp_plan)} "
                    "tensor-parallel parameters")

    batch_size = args.batch_size or train_config["batch_size"]
    total_epoch = args.epochs or train_config["total_epoch"]
    # ceil: the reference converts milestone epochs to iterations through
    # len(dataloader) with drop_last=False (reference
    # tools/train_vidvrd.py:123-125); the milestones are an iteration count
    iters_per_epoch = max(-(-len(dataset) // batch_size), 1)
    milestones = [m * iters_per_epoch
                  for m in train_config["epoch_lr_milestones"]]
    state = TrainState(model, train_config["initial_lr"],
                       train_config["lr_decay"], milestones, mesh=mesh)
    wire = wire_dtype(args.feat_dtype, cfg.compute_dtype)
    # int8 features are packed with a scale per video; BigC dequantizes
    # them once in train mode, so the int8 wire only cuts the H2D bytes
    spec = BucketSpec(feat_dim=feat_dim, g_bucket=32,
                      p_bucket=model_config.get("max_preds", 128),
                      feat_dtype=str(wire).removeprefix("torch."), **buckets)

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

    # the device record cache (off at --device_cache_gb 0, under a mesh
    # and for the in-memory records, which have no name list); the train
    # split's by-name skips are redirected as the dataset redirects them
    cache = make_cache(args, dataset, batch_size, mesh=mesh, skip_names=(
        VIDVRD_OOM_VIDEOS if getattr(dataset, "split", "") == "train"
        else ()))
    ring = StagingRing(device)
    epoch_stream, preput = tracklet_epochs(dataset, spec, batch_size, ring,
                                           cache, logger,
                                           shard=row_shard(mesh))
    step_fn = build_train_step(model, state, t_abs=T_ABS)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    logger.info("start training...")
    try:
        state = run_epochs(
            state, lambda b, g: step_fn(*b[2:], generator=g), epoch_stream,
            start_epoch=start_epoch, total_epoch=total_epoch,
            base_seed=args.seed + 1, writer=writer, logger=logger,
            ckpt_dir=ckpt_dir, ckpt_every=args.ckpt_every,
            start_batch=start_batch, extra_metrics=EXTRA_METRICS,
            should_stop=install_stop_handler(logger), preput=preput,
            stop_after_batches=args.stop_after_batches)
    finally:
        ring.close()
    writer.close()
    summary = {"step": state.step, "ckpt_dir": ckpt_dir,
               "metrics": writer.path, "device": str(device),
               "batch_size": batch_size, "n_videos": len(dataset),
               "pipeline": pipeline_summary(ring, dataset, cache),
               "mesh": None if mesh is None else [mesh.n_data, mesh.n_model],
               "grad_sync_bytes": state.sync_bytes}
    if device.type == "cuda":
        summary["max_memory_allocated"] = torch.cuda.max_memory_allocated(
            device)
        summary["memory_allocated"] = torch.cuda.memory_allocated(device)
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
    parser.add_argument("--use_pku", action="store_true",
                        help="PKU tracklets: the pku_i3d format unless "
                             "--fmt says otherwise")
    parser.add_argument("--fmt", type=str, default=None,
                        choices=("mega", "pku", "pku_i3d"),
                        help="tracklet format; default the dataset "
                             "config's, or pku_i3d with --use_pku")
    parser.add_argument("--tables_path", type=str, default=None,
                        help="tables.npz of the frozen name embedding "
                             "(enti_name_emb)")
    parser.add_argument("--device_cache_gb", type=float, default=4.0,
                        help="device memory for the record cache: epochs "
                             "after the first assemble their batches on "
                             "the card when the split fits; 0 turns it "
                             "off")
    parser.add_argument("--synthetic", type=int, default=0,
                        help="train on N synthetic videos: written in the "
                             "reference layout under --synthetic_root and "
                             "read from there, or, without it, drawn in "
                             "memory")
    parser.add_argument("--synthetic_root", type=str, default=None,
                        help="directory of the --synthetic split on disk")
    parser.add_argument("--synthetic_model_dims", action="store_true",
                        help="synthetic features at the config's dims (in "
                             "memory: bench.py's full-size recipe, packed "
                             "at N=50 tracklets x T=256 frames)")
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
    add_mesh_args(parser)
    return parser.parse_args(argv)


def _rank(args, mesh):
    return train(args, mesh)[0]


def main(argv=None) -> dict:
    """Train as the flags say; returns rank 0's summary."""
    args = parse_args(argv)
    shape = mesh_shape(args)
    check_divisible("batch_size", args.batch_size or parse_config_py(
        args.cfg_path)["train_config"]["batch_size"], shape)
    return launch(_rank, args, shape)


if __name__ == "__main__":
    main()
