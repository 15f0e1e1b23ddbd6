"""Where the device time of inference and training goes on the card.

    python -m vidsgg_big_tpu_torch.tools.profile_infer \\
        [--model bigc|grounding|grounding_train|bigc_train|basec|\\
        basec_train] [--compute_dtype bfloat16] [--feat_dtype int8] \\
        [--out k.json]

``--model bigc`` (default) builds the exp2 model with random weights (as
the eval entry point does), packs one full-size synthetic batch of 8 (N=50 x
T=256, 2048+832 features; ``--feat_dtype int8`` packs them as int8 with a
scale per video, and the first visual layer runs as an int8 product) on the
card, and times forward + triplet construction.  ``--model basec`` builds
exp6's Base-C (rt200) and times forward + pairwise triplets on one stage-A
batch of 4 full-size synthetic VidOR videos on the N=64 rung (46 tracklets,
4,032 ordered pairs; 1024 RoI + 300 classeme features, T=4096, the bucket
of the longest videos); ``--model basec_train`` times its train step
(label assignment at t_abs=4096, BCE, backward, clip, Adam) on that batch
with its GT (32 trajectory and 128 predicate slots).  ``--model
grounding`` builds the grounding_weights model (dim_hidden 128, 10 bins) and times forward + decode on one stage-B batch at
bench.py's geometry (B=4 videos x Q=256 queries x T=512 clips, 299 valid).
``--model grounding_train`` builds the same model and times the train step
(loss, backward, clip, Adam; dropout 0.1) at bench.py's train geometry: 8
full-size synthetic videos x 64 predicate slots x T=512 (R=1024 rows in the
combined encoder).  ``--model bigc_train`` times the BIG-C train step
(forward, vIoU alignment, matching on the host, losses, backward, clip,
Adam; dropout 0.1) of the exp2 model at bench.py's BIG-C train geometry: 8
full-size videos at N=50 x T=256, 16 GT trajectories and 32 predicate
slots.  Each runs 10 steps under ``torch.profiler`` with the program's
spans recorded (``utils/spans.py``) and prints one JSON line:
milliseconds per batch (CUDA events), the device's busy share of that
window (kernel time over window time), the kernels with the most device
time, each with its share and launches per batch, and for each program
span the device ms and launches per batch of the kernels put down to it:
each kernel goes to the innermost span around the CPU op that launched it
(the profiler's kernel-to-op correlation), with its top kernels.  The full
kernel table goes to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import os

import torch

from ..data.bucketing import BucketSpec, bucketed_batches
from ..data.synthetic import clip_features, make_vidor_video, num_clips
from ..data.synthetic_vidor import SyntheticVidORSet
from ..data.synthetic_vidvrd import bench_train_batch
from ..data.transfer import batch_to_device
from ..models.base_c import BaseCConfig
from ..models.big_c import BigCConfig
from ..models.grounding import GroundingConfig
from ..train.grounding_steps import (build_grounding_infer_step,
                                     build_grounding_train_step)
from ..train.loop import step_generator
from ..train.steps import (build_basec_infer_step, build_basec_train_step,
                           build_infer_step, build_train_step)
from ..train.train_state import TrainState
from ..utils.config import parse_config_py
from ..utils.device import card_name_and_power, resolve_device, strict_float32
from ..utils.spans import recording
from . import eval_vidor, eval_vidvrd


CFG_PATH = "experiments/exp2/config_.py"
GRD_CFG_PATH = "experiments/grounding_weights/config_.py"
BASEC_CFG_PATH = "experiments/exp6/config_rt200.py"
BATCH, ITERS, TOP = 8, 10, 12
SPAN_TOP = 5          # kernels listed under each program span
# VidOR stage A's geometry: 4 videos on the N=64 rung, the T=4096 bucket
A_B, A_N, A_T = 4, 64, 4096
G_B, G_Q, G_T = 4, 256, 512        # bench.py's grounding geometry
TR_B, TR_P = 8, 64                 # bench.py's grounding train geometry


def _bigc_step(compute_dtype, device, feat_dtype=None):
    mc = dict(parse_config_py(CFG_PATH)["model_config"],
              compute_dtype=compute_dtype)
    cfg = BigCConfig.from_dict(mc)
    recs, feat = eval_vidvrd.synthetic_records(BATCH, cfg, True)
    _, _, props, _ = next(iter(bucketed_batches(
        recs, BucketSpec(feat_dim=feat, feat_dtype=feat_dtype or "float32",
                         **eval_vidvrd.FULL_SIZE_BUCKETS),
        BATCH, with_gt=False)))
    props = props.to(device, feats=getattr(torch,
                                           feat_dtype or compute_dtype))
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


def _grounding_train_step(compute_dtype, device):
    from . import train_vidor
    cfgs = parse_config_py(GRD_CFG_PATH)
    tc = cfgs["train_config"]
    cfg = GroundingConfig.from_dict(dict(cfgs["model_config"],
                                         compute_dtype=compute_dtype))
    model = eval_vidor.build_grounding_model(cfg).to(device)
    state = TrainState(model, tc["initial_lr"], tc["lr_decay"], [40, 60])
    step = build_grounding_train_step(model, state)
    rows = []
    for i in range(TR_B):
        _, gt = make_vidor_video(i, feat_dim=4,
                                 **eval_vidor.FULL_SIZE_RECIPE)
        rows.append((clip_features(i, gt.video_len, cfg.dim_feat), gt))
    batch = train_vidor._to_device(train_vidor.make_batch(
        rows, G_T, TR_B, cfg.dim_feat, TR_P, getattr(torch, compute_dtype)),
        device)
    it = iter(range(1 << 30))
    return (lambda: step(*batch, generator=step_generator(1, next(it)))), \
        TR_B


def _bigc_train_step(compute_dtype, device):
    mc = dict(parse_config_py(CFG_PATH)["model_config"],
              compute_dtype=compute_dtype)
    cfg = BigCConfig.from_dict(mc)
    model = eval_vidvrd.build_model(cfg, mc).to(device)
    # bench.py's optimizer: Adam 1e-4, one milestone past the run
    step = build_train_step(model, TrainState(model, 1e-4, 0.2, [10_000]))
    batch = bench_train_batch(cfg, BATCH, device,
                                           getattr(torch, compute_dtype))
    it = iter(range(1 << 30))
    return (lambda: step(*batch, generator=step_generator(1, next(it)))), \
        BATCH


def stage_a_batch(cfg, device, wire=torch.float32):
    """One stage-A batch of A_B full-size synthetic VidOR videos at (N=64,
    T=4096), with its GT, on ``device`` (int8 ``wire``: packed int8)."""
    data = SyntheticVidORSet(A_B, cfg.dim_feat, model_dims=True)
    spec = BucketSpec(feat_dim=data.feat_dim, n_ladder=(A_N,),
                      t_ladder=(A_T,), feat_dtype="int8"
                      if wire == torch.int8 else "float32")
    _, _, props, gts = next(iter(bucketed_batches(
        (data[i] for i in range(A_B)), spec, A_B)))
    return batch_to_device(props, gts, torch.device(device), wire)


def _basec_parts(compute_dtype, device):
    mc = dict(parse_config_py(BASEC_CFG_PATH)["model_config"],
              compute_dtype=compute_dtype)
    cfg = BaseCConfig.from_dict(mc)
    model = eval_vidor.build_basec_model(cfg, mc).to(device)
    return model, cfg, stage_a_batch(cfg, device)


def _basec_step(compute_dtype, device):
    model, _, (props, _) = _basec_parts(compute_dtype, device)
    infer = build_basec_infer_step(model, topk=3)
    return (lambda: infer(props)), A_B


def _basec_train_step(compute_dtype, device):
    model, _, batch = _basec_parts(compute_dtype, device)
    # exp6's optimizer: Adam 5e-5, one milestone past the run
    step = build_basec_train_step(
        model, TrainState(model, 5e-5, 0.2, [10_000]), t_abs=4096)
    return (lambda: step(*batch)), A_B


def profile(compute_dtype: str, model: str = "bigc", feat_dtype=None):
    """(summary, [(device ms, launches, kernel name)]) over ITERS batches."""
    device = resolve_device("cuda")
    strict_float32()
    make_step = {"bigc": _bigc_step, "grounding": _grounding_step,
                 "grounding_train": _grounding_train_step,
                 "bigc_train": _bigc_train_step, "basec": _basec_step,
                 "basec_train": _basec_train_step}
    if feat_dtype and model != "bigc":
        raise ValueError("--feat_dtype applies to --model bigc")
    step, batch = make_step[model](compute_dtype, device, **(
        {"feat_dtype": feat_dtype} if feat_dtype else {}))
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with recording() as records, \
            torch.profiler.profile(activities=acts) as prof:
        start.record()
        for _ in range(ITERS):
            step()
        end.record()
        torch.cuda.synchronize()
    window_ms = start.elapsed_time(end)
    rows = []
    for ev in prof.key_averages():
        # a user annotation (the optimizer's "Optimizer.step#Adam.step")
        # spans kernels that are counted on their own
        if (ev.device_type == torch.autograd.DeviceType.CUDA
                and ev.self_device_time_total > 0
                and not getattr(ev, "is_user_annotation", False)):
            rows.append((ev.self_device_time_total / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    kernel_ms = sum(r[0] for r in rows)
    summary = {
        "card": card_name_and_power(), "torch": torch.__version__,
        "model": model, "compute_dtype": compute_dtype,
        "feat_dtype": feat_dtype, "batch_size": batch,
        "ms_per_batch": window_ms / ITERS,
        "videos_per_s": batch * ITERS * 1e3 / window_ms,
        "device_busy_share": kernel_ms / window_ms if rows else None,
        "top_kernels": [
            {"kernel": k[:80], "ms_per_batch": ms / ITERS,
             "share": ms / kernel_ms, "launches_per_batch": n / ITERS}
            for ms, n, k in rows[:TOP]],
        "spans": span_kernels(prof.events(), {r.name for r in records}),
    }
    return summary, rows


def span_kernels(events, names) -> dict:
    """{span: {device ms, launches and top kernels per batch}} over the
    profile's ``events``: each kernel put down to the innermost span of
    ``names`` around the start of the CPU op that launched it (``(none)``
    outside every span)."""
    cpu = torch.autograd.DeviceType.CPU
    around = [(ev.time_range.start, ev.time_range.end, ev.name)
              for ev in events if ev.device_type == cpu and ev.name in names]
    table = {}
    for ev in events:
        if ev.device_type != cpu or not ev.kernels or ev.name in names:
            continue
        t = ev.time_range.start
        inside = [(e - s, n) for s, e, n in around if s <= t <= e]
        row = table.setdefault(min(inside)[1] if inside else "(none)",
                               {"ms": 0.0, "launches": 0, "kernels": {}})
        for k in ev.kernels:
            row["ms"] += k.duration / 1e3
            row["launches"] += 1
            row["kernels"][k.name] = row["kernels"].get(k.name, 0.0) + \
                k.duration / 1e3
    return {name: {"device_ms_per_batch": row["ms"] / ITERS,
                   "launches_per_batch": row["launches"] / ITERS,
                   "top_kernels": [[k[:160], ms / ITERS] for k, ms in sorted(
                       row["kernels"].items(), key=lambda kv: -kv[1])[
                           :SPAN_TOP]]}
            for name, row in sorted(table.items(),
                                    key=lambda kv: -kv[1]["ms"])}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--model", default="bigc",
                        choices=("bigc", "grounding", "grounding_train",
                                 "bigc_train", "basec", "basec_train"))
    parser.add_argument("--compute_dtype", default="float32",
                        choices=("float32", "bfloat16"))
    parser.add_argument("--feat_dtype", default=None, choices=("int8",),
                        help="--model bigc: pack the batch's features as "
                             "int8 (default: the compute dtype)")
    parser.add_argument("--out", default=None,
                        help="write the full per-kernel table here (JSON)")
    args = parser.parse_args(argv)
    summary, rows = profile(args.compute_dtype, args.model, args.feat_dtype)
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
