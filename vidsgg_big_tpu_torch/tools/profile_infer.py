"""Where the device time of inference goes on the card.

    python -m vidsgg_big_tpu_torch.tools.profile_infer \\
        [--model bigc|grounding] [--compute_dtype bfloat16] [--out k.json]

``--model bigc`` (default) builds the exp2 model with random weights (as
the eval entry point does), packs one full-size synthetic batch of 8 (N=50 x
T=256, 2048+832 features) on the card, and times forward + triplet
construction.  ``--model grounding`` builds the grounding_weights model
(dim_hidden 128, 10 bins) and times forward + decode on one stage-B batch at
bench.py's geometry (B=4 videos x Q=256 queries x T=512 clips, 299 valid).
Either runs 10 steps under ``torch.profiler`` and prints one JSON line:
milliseconds per batch (CUDA events), the device's busy share of that
window (kernel time over window time) and the kernels with the most device
time, each with its share and launches per batch.  The full kernel table
goes to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import os

import torch

from ..data.bucketing import BucketSpec, bucketed_batches
from ..data.synthetic import num_clips
from ..models.big_c import BigCConfig
from ..models.grounding import GroundingConfig
from ..train.grounding_steps import build_grounding_infer_step
from ..train.steps import build_infer_step
from ..utils.config import parse_config_py
from ..utils.device import card_name_and_power, resolve_device, strict_float32
from . import eval_vidor, eval_vidvrd


CFG_PATH = "experiments/exp2/config_.py"
GRD_CFG_PATH = "experiments/grounding_weights/config_.py"
BATCH, ITERS, TOP = 8, 10, 12
G_B, G_Q, G_T = 4, 256, 512        # bench.py's grounding geometry


def _bigc_step(compute_dtype, device):
    mc = dict(parse_config_py(CFG_PATH)["model_config"],
              compute_dtype=compute_dtype)
    cfg = BigCConfig.from_dict(mc)
    recs, feat = eval_vidvrd.synthetic_records(BATCH, cfg, True)
    _, _, props, _ = next(iter(bucketed_batches(
        recs, BucketSpec(feat_dim=feat, **eval_vidvrd.FULL_SIZE_BUCKETS),
        BATCH, with_gt=False)))
    props = props.to(device, feats=getattr(torch, compute_dtype))
    infer = build_infer_step(
        eval_vidvrd.build_model(cfg, mc).to(device), topk=10)
    return (lambda: infer(props)), BATCH


def _grounding_step(compute_dtype, device):
    cfgs = parse_config_py(GRD_CFG_PATH)
    icfg = cfgs["inference_config"]
    cfg = GroundingConfig.from_dict(dict(cfgs["model_config"],
                                         compute_dtype=compute_dtype))
    infer = build_grounding_infer_step(
        eval_vidor.build_grounding_model(cfg).to(device),
        score_th=icfg["score_th"], tiou_th=icfg["tiou_th"],
        bins_th=icfg["bins_th"], nms_th=icfg["nms_th"])
    g = torch.Generator().manual_seed(0)
    n = num_clips(2400)
    clips = torch.full((G_B,), n)
    clip_mask = torch.arange(G_T)[None] < clips[:, None]
    feats = torch.randn(G_B, G_T, cfg.dim_feat, generator=g) * clip_mask[
        ..., None]
    cats = torch.stack([torch.randint(1, cfg.num_enti_cats, (G_B, G_Q),
                                      generator=g),
                        torch.randint(1, cfg.num_pred_cats, (G_B, G_Q),
                                      generator=g),
                        torch.randint(1, cfg.num_enti_cats, (G_B, G_Q),
                                      generator=g)], -1)
    start = torch.rand(G_B, G_Q, generator=g) * 0.6
    temporal = torch.stack([start, start + 0.3], -1)
    qm = torch.ones(G_B, G_Q, dtype=torch.bool)
    args = [a.to(device) for a in (feats, clip_mask, clips, cats, temporal,
                                   qm)]
    return (lambda: infer(*args)), G_B


def profile(compute_dtype: str, model: str = "bigc"):
    """(summary, [(device ms, launches, kernel name)]) over ITERS batches."""
    device = resolve_device("cuda")
    strict_float32()
    step, batch = (_grounding_step if model == "grounding" else _bigc_step)(
        compute_dtype, device)
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        start.record()
        for _ in range(ITERS):
            step()
        end.record()
        torch.cuda.synchronize()
    window_ms = start.elapsed_time(end)
    rows = []
    for ev in prof.key_averages():
        if (ev.device_type == torch.autograd.DeviceType.CUDA
                and ev.self_device_time_total > 0):
            rows.append((ev.self_device_time_total / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    kernel_ms = sum(r[0] for r in rows)
    summary = {
        "card": card_name_and_power(), "torch": torch.__version__,
        "model": model, "compute_dtype": compute_dtype, "batch_size": batch,
        "ms_per_batch": window_ms / ITERS,
        "videos_per_s": batch * ITERS * 1e3 / window_ms,
        "device_busy_share": kernel_ms / window_ms if rows else None,
        "top_kernels": [
            {"kernel": k[:80], "ms_per_batch": ms / ITERS,
             "share": ms / kernel_ms, "launches_per_batch": n / ITERS}
            for ms, n, k in rows[:TOP]],
    }
    return summary, rows


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--model", default="bigc",
                        choices=("bigc", "grounding"))
    parser.add_argument("--compute_dtype", default="float32",
                        choices=("float32", "bfloat16"))
    parser.add_argument("--out", default=None,
                        help="write the full per-kernel table here (JSON)")
    args = parser.parse_args(argv)
    summary, rows = profile(args.compute_dtype, args.model)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump([{"kernel": k, "ms_per_batch": ms / ITERS,
                        "launches_per_batch": n / ITERS}
                       for ms, n, k in rows], f, indent=1)
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
