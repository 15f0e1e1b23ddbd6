"""Shared plumbing of the port's CLIs: datasets in the reference layout and
the side tables, as the JAX package's ``tools/common.py`` (:16-115), and
the ``--data_parallel`` / ``--mesh`` launch."""
from __future__ import annotations

import os

import numpy as np
import torch

MESH_HELP = ("explicit device mesh 'D' (data parallel) or 'D,M' (2-D data "
             "x model; tensor-parallel params over the model axis)")


def add_mesh_args(parser, mesh_help: str = MESH_HELP):
    """The JAX CLIs' ``--data_parallel`` and ``--mesh``."""
    parser.add_argument("--data_parallel", action="store_true",
                        help="data parallel over every device: one rank "
                             "per visible card (WORLD_SIZE ranks under "
                             "torchrun, one on the CPU)")
    parser.add_argument("--mesh", type=str, default=None, help=mesh_help)


def mesh_shape(args, tensor_parallel: bool = True):
    """(data ranks, model ranks) that ``--mesh`` / ``--data_parallel`` ask
    for, None without them.  ``--data_parallel`` spans every device: the
    ranks ``torchrun`` started, else the visible cards, else (on the CPU)
    one.  Without ``tensor_parallel`` (a model JAX never splits) a
    ``--mesh D,M`` runs its D x M ranks on the data axis alone."""
    from ..parallel.sharding import mesh_from_spec
    if args.mesh:
        n_data, n_model = mesh_from_spec(args.mesh)
        return (n_data, n_model) if tensor_parallel else \
            (n_data * n_model, 1)
    if not args.data_parallel:
        return None
    if "WORLD_SIZE" in os.environ:
        return int(os.environ["WORLD_SIZE"]), 1
    if torch.device(args.device).type == "cuda":
        return max(torch.cuda.device_count(), 1), 1
    return 1, 1


def check_divisible(what: str, batch: int, shape) -> None:
    """JAX's assert: the batch divides over the mesh's data axis."""
    if shape is not None and batch % shape[0]:
        raise ValueError(f"{what} {batch} must be divisible by the mesh's "
                         f"data axis ({shape[0]})")


def launch(run, args, shape):
    """``run(args, mesh)`` on the ranks of ``shape`` (``mesh_shape``), or
    ``run(args, None)`` in this process without one; returns rank 0's
    value.  See ``parallel.mesh.run_ranks``."""
    from ..parallel.mesh import run_ranks
    from ..utils.device import resolve_device
    resolve_device(args.device)
    if shape is None:
        return run(args, None)
    return run_ranks(run, args, shape[0], shape[1], args.device)


def rank_logger(log_path: str, mesh):
    """(logger, whether this rank writes): rank 0's (or the only
    process's) file logger, a silent one on the other ranks."""
    from ..utils.logger import create_logger, quiet_logger
    if mesh is not None and not mesh.is_writer:
        return quiet_logger(), False
    return create_logger(log_path), True


def rank_outputs(log_path: str, log_dir: str, mesh):
    """(logger, metric writer): files of rank 0, silent on the others."""
    from ..utils.logger import MetricWriter, NullWriter
    logger, writes = rank_logger(log_path, mesh)
    return logger, MetricWriter(log_dir) if writes else NullWriter()


def row_shard(mesh):
    """(data index, data ranks) of ``mesh``, None without one."""
    return None if mesh is None else (mesh.data_index, mesh.n_data)


def load_table(path, shape):
    """A .npy table from the config, or zeros where it is absent."""
    if path and os.path.exists(path):
        arr = np.load(path).astype(np.float32)
        if arr.shape != tuple(shape):
            raise ValueError(f"{path}: shape {arr.shape} != {shape}")
        return arr
    return np.zeros(shape, np.float32)


def load_tables(model_config, num_enti, num_pred, dim_clsme=300):
    """(EntiNameEmb, bias matrix, PredNameEmb) from the config's .npy paths,
    zeros where a file is absent (e.g. synthetic runs)."""
    return (load_table(model_config.get("EntiNameEmb_path"),
                       (num_enti, dim_clsme)),
            load_table(model_config.get("bias_matrix_path"),
                       (num_enti, num_enti, num_pred)),
            load_table(model_config.get("PredNameEmb_path"),
                       (num_pred, dim_clsme)))


def has_table(model_config, key) -> bool:
    """Whether the config names a table file that exists."""
    path = model_config.get(key)
    return bool(path) and os.path.exists(path)


def load_side_tables(tables_path, enti_emb=None):
    """``tables.npz`` (the JAX package's ``tools/convert_checkpoint.py``
    writes it) -> (enti_name_emb override or ``enti_emb``, pos_emb_table
    or None)."""
    if not tables_path:
        return enti_emb, None
    t = np.load(tables_path)
    if "enti_name_emb" in t:
        enti_emb = t["enti_name_emb"]
    pos = t["pos_emb_table"] if "pos_emb_table" in t else None
    return enti_emb, pos


def make_dataset(dataset_config, dataset_type, synthetic=0,
                 synthetic_root=None, fmt=None, dim_feat=None, dim_i3d=None):
    """The split of ``dataset_config`` in the reference layout, and the
    config it was built from.  With ``synthetic`` N, first write N videos in
    that layout under ``synthetic_root`` (``data/synthetic_raw``, at
    ``dim_feat`` / ``dim_i3d`` where given) and read those instead.
    ``fmt`` overrides a VidVRD config's tracklet format."""
    from ..data import synthetic_raw
    from ..data.dataset import VidORDataset, VidVRDDataset

    cfg = dict(dataset_config)
    if synthetic:
        root = synthetic_root or os.path.join("datasets", "synthetic")
        os.makedirs(root, exist_ok=True)
        dims = {}
        if dim_feat:
            dims["dim_feat"] = dim_feat
        if dataset_type == "vidvrd":
            if dim_i3d:
                dims["dim_i3d"] = dim_i3d
            cfg = synthetic_raw.write_synthetic_vidvrd(
                root, n_videos=synthetic, split=cfg.get("split", "test"),
                fmt=fmt or cfg.get("fmt", "pku_i3d"), **dims)
        else:
            cfg = synthetic_raw.write_synthetic_vidor(
                root, n_videos=synthetic, split=cfg.get("split", "val"),
                **dims)
    missing = [k for k in ("ann_dir", "proposal_dir") if k not in cfg]
    if missing:
        raise ValueError(f"the dataset config names no {' or '.join(missing)}"
                         ": point it at a split in the reference layout, or "
                         "pass --synthetic N")
    if dataset_type == "vidvrd":
        if fmt and not synthetic:
            cfg["fmt"] = fmt
        return VidVRDDataset(**cfg), cfg
    if not cfg.get("video_dir"):
        cfg.pop("video_dir", None)   # only the test split reads videos
    return VidORDataset(**cfg), cfg


def first_feat_dim(prop_iter):
    """Feature width of the first video with proposals (zero-proposal
    videos occur in real splits and carry no feature rows)."""
    for prop in prop_iter:
        if prop.num_proposals:
            return prop.features[0].shape[1]
    raise ValueError("every video in the split has zero proposals")


def skip_batches(gen, n: int, ring):
    """``gen`` past its first ``n`` batches (a resumed epoch), their
    staging slots freed unshipped."""
    for i, batch in enumerate(gen):
        if i < n:
            if batch[2] is not None:
                ring.discard((batch[2], batch[3]))
            continue
        yield batch


def tracklet_epochs(dataset, spec, batch_size, ring, cache=None,
                    logger=None, map_fn=None, shard=None):
    """``(epoch_stream, preput)`` of a classification trainer for
    ``train/loop.run_epochs``, as the JAX CLIs wire them: each epoch
    streams ``iter_shuffled(dataset, epoch)`` through ``bucketed_batches``
    into ``ring`` on a prefetch thread (``map_fn`` maps each item to its
    (proposal, GT) pair), or, once ``cache`` is complete, cached batch
    descriptors; ``preput`` ships a staged batch to the card (offering it to
    the cache) or assembles a cached one there.  ``shard`` = (data index,
    data ranks) stages only this rank's rows of every batch (the cache is
    off under a mesh)."""
    from ..data.bucketing import bucketed_batches, iter_shuffled
    from ..data.device_cache import cached_or_host_epoch
    from ..data.prefetch import prefetch

    def epoch_stream(epoch, skip):
        gen = cached_or_host_epoch(
            cache, epoch, logger,
            lambda: bucketed_batches(
                iter_shuffled(dataset, seed=epoch, map_fn=map_fn), spec,
                batch_size, staging=ring, shard=shard), skip=skip)
        if skip:          # resume: the stream is deterministic per epoch
            gen = skip_batches(gen, skip, ring)
        return prefetch(gen)

    def preput(batch):
        key, rows, props, gts = batch
        if props is None:                       # a cached-epoch descriptor
            props, gts = cache.assemble(key, rows)
            return key, rows, props, gts
        props, gts = ring.ship((props, gts))
        if cache is not None:
            cache.offer(key, rows, props, gts)
        return key, rows, props, gts

    return epoch_stream, preput


def pipeline_summary(ring, dataset=None, cache=None) -> dict:
    """The input pipeline's readings of a run: each batch's pack seconds
    (producer) and H2D copy (ms and bytes, device time; none on the CPU),
    the staging bytes, the dataset's parse / save / load seconds, the
    device cache's state."""
    h2d = ring.h2d_report()
    out = {"pack_s": list(ring.pack_seconds), "h2d_ms": h2d["ms"],
           "h2d_bytes": h2d["bytes"], "staging_bytes": ring.allocated_bytes}
    if getattr(dataset, "seconds", None) is not None:
        out["dataset_seconds"] = dict(dataset.seconds)
    if cache is not None:
        out["device_cache"] = cache.summary()
    return out
