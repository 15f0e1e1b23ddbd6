"""Export a model's infer step as a self-contained serving artifact.

Port of the JAX package's ``tools/export_model.py``: ``torch.export``
traces the existing infer step (``train/steps.build_infer_step``,
``build_basec_infer_step``, ``train/grounding_steps.
build_grounding_infer_step``) at one bucket's static shapes, under
``torch.no_grad()``, with the weights in the program, and
``torch.export.save`` writes it.  The kernels run inside the artifact as
the registered ops ``vidsgg_big_tpu_torch::role_attention`` and
``::composed_attention`` (``ops/role_attn.py``, ``ops/composed_attn.py``):
their CUDA kernels on the card, their plain versions on the CPU.

    python -m vidsgg_big_tpu_torch.tools.export_model \\
        --cfg_path experiments/exp2/config_.py --model bigc_vidvrd \\
        --ckpt_path ckpt_exp2 --n_bucket 50 --t_bucket 256 --batch_size 8 \\
        --feat_dtype float32 --out exp2_serving [--device cpu]

writes ``<out>/model.pt2`` and ``<out>/manifest.json`` (input shapes and
dtypes, the output type and fields, and the bucket).  Reload with
:func:`vidsgg_big_tpu_torch.utils.serving.load_exported`.  One artifact a
(N, T, B) bucket (a (Q, T, B) bucket for grounding), on the device it was
exported on.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch
from torch import nn

from ..data.synthetic import make_video
from ..data.types import TrackletBatch, pack_proposal, stack_batches
from ..models.base_c import BaseCConfig
from ..models.big_c import BigCConfig
from ..models.grounding import GroundingConfig
from ..models.triplets import Triplets
from ..train.grounding_steps import build_grounding_infer_step
from ..train.steps import build_basec_infer_step, build_infer_step
from ..utils.compile_cache import enable_compilation_cache
from ..utils.config import parse_config_py
from ..utils.device import resolve_device, strict_float32
from ..utils.serving import ARTIFACT, flat_leaves
from .eval_vidor import build_basec_model, build_grounding_model
from .eval_vidvrd import build_model

GROUNDING_INPUTS = ["video_feats", "clip_mask", "n_clips", "query_cats",
                    "temporal", "query_mask"]
GROUNDING_OUTPUTS = ["pooled_se", "bins_probs", "bins_mask"]
FEAT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
               "int8": torch.int8}


def tracklet_template(args, feat_dim, num_enti_cats, num_pred_cats,
                      video_len, device) -> TrackletBatch:
    """The JAX CLI's template batch: ``batch_size`` synthetic videos
    (``data/synthetic.make_video``) packed at the bucket, the features
    stored as ``--feat_dtype`` (int8 quantized on the host, bfloat16 a cast
    after the copy), on ``device``."""
    recs = [make_video(i, video_len=video_len, n_gt_trajs=3, n_preds=4,
                       n_distractors=2, feat_dim=feat_dim,
                       num_enti_cats=num_enti_cats,
                       num_pred_cats=num_pred_cats)[0]
            for i in range(args.batch_size)]
    host = np.int8 if args.feat_dtype == "int8" else np.float32
    batch = stack_batches([pack_proposal(r, args.n_bucket, args.t_bucket,
                                         feat_dim, dtype=host)
                           for r in recs])
    return batch.to(device, feats=FEAT_DTYPES[args.feat_dtype])


def build_model_and_params(args, model_config, device):
    """BIG-C (v10 for ``bigc_vidvrd``, v7 for ``bigc_vidor``) on ``device``
    with its weights, the template batch and its feature width."""
    variant = {"bigc_vidvrd": "v10", "bigc_vidor": "v7"}[args.model]
    cfg = BigCConfig.from_dict(model_config, variant=variant)
    # feature channels on disk: RoI + I3D for v10, RoI + the 300-d
    # classeme concat for v7 (the VidOR loaders append it; the model
    # ignores the channels it does not read)
    feat_dim = cfg.dim_feat + (cfg.dim_i3d or 0) + \
        (cfg.dim_clsme if variant == "v7" else 0)
    model = build_model(cfg, model_config, args.ckpt_path,
                        tables_path=args.tables_path).to(device)
    template = tracklet_template(args, feat_dim, cfg.num_enti_cats,
                                 cfg.num_pred_cats, 4 * args.t_bucket // 2,
                                 device)
    return model, template, feat_dim


def build_basec_and_params(args, model_config, device):
    """Base-C on ``device``, its template batch and feature width (RoI +
    the 300-d classeme concat of the VidOR files)."""
    cfg = BaseCConfig.from_dict(model_config)
    feat_dim = cfg.dim_feat + cfg.dim_clsme
    model = build_basec_model(cfg, model_config, args.ckpt_path,
                              tables_path=args.tables_path).to(device)
    template = tracklet_template(args, feat_dim, cfg.num_enti_cats,
                                 cfg.num_pred_cats, 2 * args.t_bucket,
                                 device)
    return model, template, feat_dim


def build_grounding_and_params(args, model_config, device):
    """The grounding model on ``device``, the JAX CLI's template operands
    (numpy seed 0) and the clip-feature width."""
    cfg = GroundingConfig.from_dict(model_config)
    model = build_grounding_model(cfg, args.ckpt_path).to(device)
    rng = np.random.default_rng(0)
    b, t, q = args.batch_size, args.t_bucket, args.q_bucket
    feats = rng.normal(size=(b, t, cfg.dim_feat)).astype(np.float32)
    clip_mask = np.ones((b, t), bool)
    n_clips = np.full((b,), t, np.int32)
    qc = rng.integers(1, cfg.num_enti_cats, size=(b, q, 3)).astype(np.int32)
    lo = rng.uniform(0, 0.4, size=(b, q, 1))
    temporal = np.concatenate(
        [lo, lo + rng.uniform(0.1, 0.5, size=(b, q, 1))], -1).astype(
            np.float32)
    qm = np.ones((b, q), bool)
    template = tuple(torch.from_numpy(a).to(device)
                     for a in (feats, clip_mask, n_clips, qc, temporal, qm))
    return model, template, cfg.dim_feat


class Serve(nn.Module):
    """The infer step on flat leaves: the JAX CLI's ``serve`` (:176-187).

    ``fields`` names the batch dataclass's leaves (None: the leaves are the
    infer step's operands, grounding).  Returns the output's leaves as a
    tuple.  ``model`` is the module the infer step closes over, so its
    weights are the program's."""

    def __init__(self, model, infer, fields=None):
        super().__init__()
        self.model = model
        self.infer = infer
        self.fields = fields

    def forward(self, *leaves):
        if self.fields is None:
            out = self.infer(*leaves)
        else:
            out = self.infer(TrackletBatch(**dict(zip(self.fields, leaves))))
        return tuple(flat_leaves(out))


def export_model(args) -> dict:
    """Export as ``args`` say; returns the manifest."""
    device = resolve_device(args.device)
    strict_float32()
    all_cfgs = parse_config_py(args.cfg_path)
    model_config = all_cfgs["model_config"]
    if args.compute_dtype:   # applies to every family's config
        model_config = dict(model_config, compute_dtype=args.compute_dtype)
    infer_cfg = all_cfgs.get("inference_config", {})
    topk = args.topk or infer_cfg.get("topk", 10)
    if args.model == "base_c":
        model, template, feat_dim = build_basec_and_params(
            args, model_config, device)
        infer = build_basec_infer_step(model, topk=topk)
    elif args.model == "grounding":
        model, template, feat_dim = build_grounding_and_params(
            args, model_config, device)
        infer = build_grounding_infer_step(
            model, score_th=infer_cfg.get("score_th", 0.9),
            tiou_th=infer_cfg.get("tiou_th", 0.5),
            bins_th=infer_cfg.get("bins_th", 0.2),
            nms_th=infer_cfg.get("nms_th", 0.8))
    else:
        model, template, feat_dim = build_model_and_params(
            args, model_config, device)
        infer = build_infer_step(model, topk=topk)
    fields = None if args.model == "grounding" else [
        f.name for f in dataclasses.fields(TrackletBatch)]
    leaves = flat_leaves(template)
    t0 = time.perf_counter()
    with torch.no_grad():
        program = torch.export.export(Serve(model, infer, fields),
                                      tuple(leaves))
    # the artifact keeps the inputs' shapes and dtypes, not the template
    # batch itself (1.2 GB of features at exp2's bucket)
    program.example_inputs = None
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, ARTIFACT)
    torch.export.save(program, path)
    seconds = time.perf_counter() - t0

    names = fields if fields is not None else GROUNDING_INPUTS
    inputs = {n: [list(x.shape), str(x.dtype).removeprefix("torch.")]
              for n, x in zip(names, leaves)}
    if args.model == "grounding":
        out_type, out_fields = None, GROUNDING_OUTPUTS
    else:
        out_type = f"{Triplets.__module__}.{Triplets.__qualname__}"
        out_fields = [f.name for f in dataclasses.fields(Triplets)]
    manifest = {
        "model": args.model, "topk": topk, "device": str(device),
        "batch_size": args.batch_size, "n_bucket": args.n_bucket,
        "t_bucket": args.t_bucket, "q_bucket": args.q_bucket,
        "feat_dim": feat_dim,
        # grounding reads float32 I3D clip features whatever the tracklet
        # features' storage
        "feat_dtype": ("float32" if args.model == "grounding"
                       else args.feat_dtype),
        "compute_dtype": model_config.get("compute_dtype", "float32"),
        "inputs": inputs,     # flat leaves in field order
        "output_type": out_type,
        "output_fields": out_fields,
        "ckpt_path": args.ckpt_path, "cfg_path": args.cfg_path,
        "artifact_bytes": os.path.getsize(path),
    }
    with open(os.path.join(args.out, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, default=str)
    print(f"exported {args.model} (topk={topk}, device={device}, "
          f"{manifest['artifact_bytes'] / 1e6:.1f} MB, {seconds:.1f} s) -> "
          f"{args.out}")
    return dict(manifest, export_seconds=seconds)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--cfg_path", type=str, required=True)
    parser.add_argument("--model", type=str, default="bigc_vidvrd",
                        choices=["bigc_vidvrd", "bigc_vidor", "base_c",
                                 "grounding"])
    parser.add_argument("--ckpt_path", type=str, default=None,
                        help="a checkpoint of the port (file or directory)")
    parser.add_argument("--tables_path", type=str, default=None)
    parser.add_argument("--out", type=str, required=True)
    parser.add_argument("--n_bucket", type=int, default=50)
    parser.add_argument("--t_bucket", type=int, default=256,
                        help="frame bucket (clip bucket for grounding)")
    parser.add_argument("--q_bucket", type=int, default=64,
                        help="query bucket (grounding only)")
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--topk", type=int, default=None)
    parser.add_argument("--feat_dtype", type=str, default="bfloat16",
                        choices=list(FEAT_DTYPES))
    parser.add_argument("--compute_dtype", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu: the device the "
                             "artifact runs on")
    return parser.parse_args(argv)


def main(argv=None) -> dict:
    enable_compilation_cache()
    return export_model(parse_args(argv))


if __name__ == "__main__":
    main()
