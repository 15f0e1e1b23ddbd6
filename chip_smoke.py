#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``vidsgg_big_tpu_torch``) on one card.

Run from the root of a checkout on a host with an NVIDIA H100:

    python3 chip_smoke.py

Phases; any failure exits non-zero and prints no result line:
  1. the card's name and power limit; build every CUDA kernel with nvcc
     (one process per source, started together);
  2. every kernel against its plain PyTorch version on the card at the main
     path's shapes (role attention: exp2 N=50 and exp4 N=180, B in
     {1, 8, 32}, padded videos included), and its time at exp2 B=8 beside
     the plain version's (CUDA events);
  3. the main path at full width: BIG-C v10 inference at the VidVRD exp2
     geometry (N=50 tracklets x T=256 frames, 2048+832 features, 2 encoder
     and 6 decoder layers, Q=192, batch 8) through the eval entry point,
     in float32 and in bfloat16, with the kernels' launch counts;
  4. checks of the output: one batch's pred_logits/att on the card against
     the port's CPU run on the same weights, and the steady-state videos/s
     of forward + triplet construction;
  5. a {"kernels": [...]} line, then the {"ok": true, ...} line.
"""
import json
import math
import os
import sys
import time

import numpy as np
import torch

EXP2_CFG = "experiments/exp2/config_.py"
N_VIDEOS, BATCH = 16, 8
Q, DH, DE, DIM_ENTI = 192, 256, 512, 512      # exp2 decoder widths
OUT_DIR = os.path.join("build", "chip_smoke")   # gitignored
# H100 SXM peaks (NVIDIA data sheet, dense): memory rate and float32 on
# CUDA cores; the role-attention kernel works in float32
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12
# role attention, kernel vs plain: sums run in another order
ATT_TOL = dict(rtol=1e-5, atol=1e-6)
VAL_TOL = dict(rtol=1e-4, atol=1e-5)


def log(msg):
    print(f"[chip_smoke] {msg}", flush=True)


def cuda_ms(fn, iters=100, warmup=10):
    """Mean milliseconds per call of ``fn`` on the card (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def role_attn_inputs(b, n, seed):
    rng = np.random.default_rng(seed)
    mask = rng.uniform(size=(b, n)) > 0.2
    mask[:, 0] = True
    if b > 1:
        mask[-1] = False                    # a padded video
    arrays = (rng.normal(0, 0.3, (b, 2, Q, DH)), rng.normal(0, 0.3, (
        b, 2, n, DH)), rng.normal(0, 0.5, (b, n, DE)))
    return [torch.from_numpy(a.astype(np.float32)).cuda() for a in arrays] + [
        torch.from_numpy(mask).cuda()]


def role_attn_bound(p, e, enco, mask):
    """(bound ms, what bounds it) for one call on these inputs: each input
    read once as the kernel takes it (float32, mask int32), each output
    written once; matmul FLOPs at the float32 peak."""
    from vidsgg_big_tpu_torch.ops.role_attn import role_attention_flops
    b, _, q, dh = p.shape
    n, de = e.shape[2], enco.shape[2]
    nbytes = 4 * (p.numel() + e.numel() + enco.numel() + mask.numel()
                  + b * 2 * q * n + b * 2 * q * de)
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops = role_attention_flops(b, q, n, dh, de) / PEAK_F32_FLOP_S
    return 1e3 * max(t_bytes, t_ops), (
        "bytes" if t_bytes >= t_ops else "operations")


def check_role_attention():
    """Phase 2: kernel vs plain at exp2/exp4 shapes, timing at exp2 B=8."""
    from vidsgg_big_tpu_torch.ops.role_attn import (role_attention,
                                                    role_attention_plain)
    max_err = 0.0
    for n in (50, 180):
        for b in (1, 8, 32):
            p, e, enco, mask = role_attn_inputs(b, n, seed=b * 1000 + n)
            att, val = role_attention(p, e, enco, mask, DIM_ENTI)
            torch.cuda.synchronize()
            att_p, val_p = role_attention_plain(p, e, enco, mask, DIM_ENTI)
            torch.testing.assert_close(att, att_p, **ATT_TOL)
            torch.testing.assert_close(val, val_p, **VAL_TOL)
            if b > 1 and (att[-1].any() or val[-1].any()):
                raise AssertionError("padded video got nonzero attention")
            err = max((att - att_p).abs().max().item(),
                      (val - val_p).abs().max().item())
            max_err = max(max_err, err)
            log(f"role_attention B={b} N={n}: max |kernel - plain| = {err}")
    args = role_attn_inputs(BATCH, 50, seed=0) + [DIM_ENTI]
    # in turns, plain / kernel / kernel / plain, on one card
    times = {"plain": [], "kernel": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        fn = role_attention_plain if which == "plain" else role_attention
        times[which].append(cuda_ms(lambda: fn(*args)))
    ms, plain_ms = min(times["kernel"]), min(times["plain"])
    bound_ms, bound_by = role_attn_bound(*args[:4])
    log(f"role_attention exp2 B={BATCH} N=50: kernel {times['kernel']} ms, "
        f"plain {times['plain']} ms, bound {bound_ms} ms ({bound_by})")
    return {"name": "role_attention", "route": "cuda",
            "source": "vidsgg_big_tpu_torch/csrc/role_attn.cu",
            "replaces": "vidsgg_big_tpu/ops/pallas_role_attn.py:27",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def drive_main_path():
    """Phase 3: exp2 through the eval entry point, float32 then bfloat16."""
    from vidsgg_big_tpu_torch.ops.role_attn import role_attention
    from vidsgg_big_tpu_torch.tools import eval_vidvrd
    from vidsgg_big_tpu_torch.utils.config import parse_config_py
    n_deco = parse_config_py(EXP2_CFG)["model_config"]["n_deco_layers"]
    base = ["--cfg_path", EXP2_CFG, "--synthetic", str(N_VIDEOS),
            "--synthetic_model_dims", "--batch_size", str(BATCH),
            "--device", "cuda", "--output_dir", OUT_DIR]
    runs = {"float32": [], "bfloat16": ["--compute_dtype", "bfloat16",
                                        "--feat_dtype", "bfloat16"]}
    results, per_run = {}, {}
    role_attention.launches = 0
    for name, extra in runs.items():
        before = role_attention.launches
        t0 = time.perf_counter()
        res = eval_vidvrd.main(base + extra + [
            "--metrics_json", os.path.join(OUT_DIR, f"metrics_{name}.json")])
        res["wall_seconds"] = time.perf_counter() - t0
        per_run[name] = role_attention.launches - before
        results[name] = res
    launches = {"role_attention": role_attention.launches}
    for name, res in results.items():
        log(f"eval_vidvrd {name}: {json.dumps(res)}")
        if res["n_videos"] != N_VIDEOS or res["n_relations"] == 0:
            raise AssertionError(f"{name}: {res['n_videos']} videos, "
                                 f"{res['n_relations']} relations")
        if not math.isfinite(res["mAP"]):
            raise AssertionError(f"{name}: mAP {res['mAP']}")
        if per_run[name] != n_deco * res["n_batches"]:
            raise AssertionError(
                f"{name}: {per_run[name]} role-attention launches for "
                f"{res['n_batches']} forwards, expected {n_deco} each")
    if launches["role_attention"] == 0:
        raise AssertionError("the main path launched no role-attention "
                             "kernel")
    return launches


def check_outputs(card):
    """Phase 4: card vs CPU on one batch; steady-state videos/s."""
    from vidsgg_big_tpu_torch.data.bucketing import (BucketSpec,
                                                     bucketed_batches)
    from vidsgg_big_tpu_torch.tools import eval_vidvrd
    from vidsgg_big_tpu_torch.models.big_c import BigCConfig
    from vidsgg_big_tpu_torch.train.steps import build_infer_step
    from vidsgg_big_tpu_torch.utils.config import parse_config_py
    mc = parse_config_py(EXP2_CFG)["model_config"]
    rates = {}
    for dtype in ("float32", "bfloat16"):
        cfg = BigCConfig.from_dict(dict(mc, compute_dtype=dtype))
        recs, feat = eval_vidvrd.synthetic_records(BATCH, cfg, True)
        _, _, props, _ = next(iter(bucketed_batches(
            recs, BucketSpec(feat_dim=feat, **eval_vidvrd.FULL_SIZE_BUCKETS),
            BATCH, with_gt=False)))
        model = eval_vidvrd.build_model(cfg, mc).eval()
        if dtype == "float32":
            # same weights, same batch: the port on the CPU vs on the card
            with torch.inference_mode():
                cpu = model(props.to("cpu"))
                gpu = model.cuda()(props.to("cuda"))
            compare_cpu_gpu(cpu, gpu)
        model = model.cuda()
        dev = props.to("cuda", feats=getattr(torch, dtype))
        infer = build_infer_step(model, topk=10)
        ms = cuda_ms(lambda: infer(dev), iters=20, warmup=3)
        rates[dtype] = BATCH * 1e3 / ms
        log(f"BIG-C v10 exp2 {dtype} B={BATCH}: forward + triplets "
            f"{ms} ms/batch = {rates[dtype]} videos/s on {card}")
    return rates


def compare_cpu_gpu(cpu, gpu):
    """float32, no TF32 on either side: att within 1e-4 absolute and
    pred_logits within 1e-3 (rtol and atol) where both sides pick the same
    subject and object (argmax over att); a near tie may flip an argmax
    between two summation orders, so at most 1% of queries may differ."""
    att_c, att_g = cpu["att"], gpu["att"].cpu()
    log(f"card vs CPU: max |att| diff {(att_c - att_g).abs().max().item()}, "
        f"max |pred_logits| diff "
        f"{(cpu['pred_logits'] - gpu['pred_logits'].cpu()).abs().max().item()}")
    torch.testing.assert_close(att_g, att_c, rtol=0, atol=1e-4)
    same = (att_c.argmax(-1) == att_g.argmax(-1)).all(dim=1)    # (B, Q)
    if same.float().mean() < 0.99:
        raise AssertionError(f"argmax agrees on {same.float().mean()} of "
                             "queries")
    torch.testing.assert_close(gpu["pred_logits"].cpu()[same],
                               cpu["pred_logits"][same], rtol=1e-3, atol=1e-3)
    for out in (cpu, gpu):
        if not all(torch.isfinite(v).all() for v in out.values()):
            raise AssertionError("non-finite model output")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    from vidsgg_big_tpu_torch.ops import build
    from vidsgg_big_tpu_torch.utils.device import (card_name_and_power,
                                                   strict_float32)
    strict_float32()
    os.makedirs(OUT_DIR, exist_ok=True)
    smi = card_name_and_power()
    print(smi, flush=True)
    card = f"{smi} (torch {torch.__version__}, CUDA {torch.version.cuda})"

    t0 = time.perf_counter()
    logs = build.build(verbose=True)
    log(f"built {sorted(build.KERNELS)} in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"{name}: {line.strip()}")

    kernels = [check_role_attention()]
    launches = drive_main_path()
    for k in kernels:
        k["launches"] = launches[k["name"]]
    check_outputs(card)

    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
