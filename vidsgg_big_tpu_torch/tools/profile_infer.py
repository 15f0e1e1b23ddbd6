"""Where the device time of BIG-C v10 inference goes on the card.

    python -m vidsgg_big_tpu_torch.tools.profile_infer \\
        [--compute_dtype bfloat16] [--out kernels.json]

Builds the exp2 model with random weights (as the eval entry point does),
packs one full-size synthetic batch of 8 (N=50 x T=256, 2048+832 features)
on the card, and runs forward + triplet construction 10 times under
``torch.profiler``.  Prints one JSON line: milliseconds per batch (CUDA
events), the device's busy share of that window (kernel time over window
time) and the kernels with the most device time, each with its share and
launches per batch.  The full kernel table goes to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import os

import torch

from ..data.bucketing import BucketSpec, bucketed_batches
from ..models.big_c import BigCConfig
from ..train.steps import build_infer_step
from ..utils.config import parse_config_py
from ..utils.device import card_name_and_power, resolve_device, strict_float32
from . import eval_vidvrd


CFG_PATH = "experiments/exp2/config_.py"
BATCH, ITERS, TOP = 8, 10, 12


def profile(compute_dtype: str):
    """(summary, [(device ms, launches, kernel name)]) over ITERS batches."""
    device = resolve_device("cuda")
    strict_float32()
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
    for _ in range(3):
        infer(props)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        start.record()
        for _ in range(ITERS):
            infer(props)
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
        "compute_dtype": compute_dtype, "batch_size": BATCH,
        "ms_per_batch": window_ms / ITERS,
        "videos_per_s": BATCH * ITERS * 1e3 / window_ms,
        "device_busy_share": kernel_ms / window_ms if rows else None,
        "top_kernels": [
            {"kernel": k[:80], "ms_per_batch": ms / ITERS,
             "share": ms / kernel_ms, "launches_per_batch": n / ITERS}
            for ms, n, k in rows[:TOP]],
    }
    return summary, rows


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--compute_dtype", default="float32",
                        choices=("float32", "bfloat16"))
    parser.add_argument("--out", default=None,
                        help="write the full per-kernel table here (JSON)")
    args = parser.parse_args(argv)
    summary, rows = profile(args.compute_dtype)
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
