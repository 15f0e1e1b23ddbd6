#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``vidsgg_big_tpu_torch``) on one card.

Run from the root of a checkout on a host with an NVIDIA H100:

    python3 chip_smoke.py

Phases; any failure exits non-zero and prints no result line:
  1. the card's name and power limit; build every CUDA kernel with nvcc
     (one process per source, started together);
  2. every kernel against its plain PyTorch version on the card at the main
     paths' shapes, and its time beside the plain version's and its bound
     (CUDA events): role attention at exp2 N=50, exp4 N=180 and the VidOR
     stage-A bucket N=192, B in {1, 8, 32}, padded videos included, timed
     at exp2 B=8; composed attention at T in {128, 512, 1024} x R in {4,
     64, 1024} rows, float32 and bfloat16, masked keys and a fully masked
     row, timed at R=1024, T=512 beside PyTorch's SDPA;
  3. the main paths at full width, each with every launch count set to 0
     just before it and read just after:
     a. BIG-C v10 inference at the VidVRD exp2 geometry (N=50 tracklets x
        T=256 frames, 2048+832 features, 2 encoder and 6 decoder layers,
        Q=192, batch 8) through the eval_vidvrd entry point;
     b. VidOR classification-then-grounding through the eval_vidor entry
        point: exp4's BIG-C v7 (6 encoder + 4 decoder layers, 1024 RoI +
        300 classeme features, 46 tracklets of 2,400-frame videos) then the
        grounding_weights model (dim_hidden 128, 10 bins) on 299-clip I3D
        features, stage A keeping 10 predicates per query, stage B batched
        at (Q, T=512) with Q reaching 256 or more;
     both in float32 and in bfloat16;
  4. checks of the output: one exp2 batch's pred_logits/att and one
     stage-B batch's regrs/conf/cls (B=4, Q=256, T=512) on the card
     against the port's CPU run on the same weights (float32); the
     steady-state exp2 videos/s, the grounding inference ms/video at that
     geometry and the two-stage videos/s;
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
EXP4_CFG = "experiments/exp4/config_.py"
GRD_CFG = "experiments/grounding_weights/config_.py"
N_VIDEOS, BATCH = 16, 8
VIDOR_VIDEOS, VIDOR_BATCH = 8, 4
# stage-A predicates kept per query on the VidOR path: the CLI's default
# where a config sets none (exp4 sets 3).  With 192 queries over 46
# tracklets it leaves 120-370 valid triplets per video, so stage B reaches
# the Q=256 and Q=512 buckets of bench's grounding geometry
VIDOR_TOPK = 10
MIN_STAGE_B_Q = 256
# bench.py's grounding geometry (bench.py:201-250): B=4 videos x Q=256
# queries x T=512 clips; the combined encoder runs 1024 rows
G_B, G_Q, G_T = 4, 256, 512
Q, DH, DE, DIM_ENTI = 192, 256, 512, 512      # exp2 decoder widths
OUT_DIR = os.path.join("build", "chip_smoke")   # gitignored
# H100 SXM peaks (NVIDIA data sheet, dense): memory rate and float32 on
# CUDA cores; the role-attention kernel works in float32
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12
PEAK_BF16_FLOP_S = 989e12          # tensor cores, dense
# role attention, kernel vs plain: sums run in another order
ATT_TOL = dict(rtol=1e-5, atol=1e-6)
VAL_TOL = dict(rtol=1e-4, atol=1e-5)
# composed attention, kernel vs plain: float32 sums run in another order;
# in bfloat16 the plain version rounds the normalised A to bf16 before the
# second product and the kernel's online softmax rounds exp(S - m) and
# divides by the row sum after it: each weight carries one bf16 rounding
# (2^-9 relative) either way, so outputs of size ~0.1 agree to about 2e-3
COMPOSED_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-5),
                torch.bfloat16: dict(rtol=1e-2, atol=1e-2)}


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


def kernel_counters():
    """Every kernel wrapper of the port, by kernel name."""
    from vidsgg_big_tpu_torch.ops.composed_attn import composed_attention
    from vidsgg_big_tpu_torch.ops.role_attn import role_attention
    return {"role_attention": role_attention,
            "composed_attention": composed_attention}


def reset_counts():
    for fn in kernel_counters().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in kernel_counters().items()}


def in_turns(fns):
    """{name: min ms} of each function, timed plain / kernel / kernel /
    plain style: every name twice, in the order given and then reversed."""
    times = {name: [] for name in fns}
    for name in list(fns) + list(fns)[::-1]:
        times[name].append(cuda_ms(fns[name], iters=5, warmup=1))
    log(f"times (ms, both turns): {times}")
    return {name: min(t) for name, t in times.items()}


def check_role_attention():
    """Phase 2: kernel vs plain at exp2/exp4/VidOR shapes, timing at exp2
    B=8."""
    from vidsgg_big_tpu_torch.ops.role_attn import (role_attention,
                                                    role_attention_plain)
    max_err = 0.0
    for n in (50, 180, 192):
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


def composed_inputs(r, t, dtype, seed):
    """Grounding-width operands (8 heads, d=128): masked keys, and for
    r > 1 one fully masked row (a padded video's rows)."""
    g = torch.Generator().manual_seed(seed)
    qh = torch.randn(r, 8, t, 128, generator=g) * 0.1
    x = torch.randn(r, t, 128, generator=g)
    vt = torch.randn(r, 8, t, 128, generator=g) * 0.2
    valid = torch.rand(r, t, generator=g) < 0.8
    valid[:, 0] = True
    if r > 1:
        valid[-1] = False
    bias = torch.where(valid, 0.0, -1e30).to(torch.float32)
    return [a.to("cuda", dtype) for a in (qh, x, vt)] + [bias.cuda()]


def composed_bound(qh, x, vt, bias):
    """(bound ms, what bounds it) for one call on these inputs: qh, x, vt
    and bias read once, out written once; 4 T^2 d FLOP per row and head at
    the peak of the inputs' type (bf16 tensor cores, f32 CUDA cores)."""
    from vidsgg_big_tpu_torch.ops.composed_attn import fused_attention_flops
    r, h, t, d = qh.shape
    nbytes = (qh.numel() + vt.numel() + 2 * x.numel()) * x.element_size() \
        + bias.numel() * 4
    peak = PEAK_BF16_FLOP_S if x.dtype == torch.bfloat16 else PEAK_F32_FLOP_S
    t_ops = fused_attention_flops(r, t, d, h) / peak
    t_bytes = nbytes / PEAK_BYTES_S
    return 1e3 * max(t_bytes, t_ops), (
        "bytes" if t_bytes >= t_ops else "operations")


def check_composed_attention():
    """Phase 2: composed attention, kernel vs plain at the grounding shapes,
    timing at R=1024, T=512 (the bench geometry's combined encoder) beside
    the plain version and PyTorch's SDPA on the same inputs."""
    import torch.nn.functional as F
    from vidsgg_big_tpu_torch.ops.composed_attn import (
        composed_attention, composed_attention_plain)
    scale = 0.25                       # 1/sqrt(hd), hd = 128 / 8
    max_err = {}
    for dtype in (torch.float32, torch.bfloat16):
        for t in (128, 512, 1024):
            for r in (4, 64, 1024):
                args = composed_inputs(r, t, dtype, seed=r + t)
                out = composed_attention(*args, scale)
                torch.cuda.synchronize()
                want = composed_attention_plain(*args, scale)
                torch.testing.assert_close(out, want, **COMPOSED_TOL[dtype])
                if not torch.isfinite(out).all():
                    raise AssertionError("non-finite composed attention")
                err = (out.float() - want.float()).abs().max().item()
                max_err[dtype] = max(max_err.get(dtype, 0.0), err)
                log(f"composed_attention {dtype} R={r} T={t}: max |kernel "
                    f"- plain| = {err}")
                del args, out, want
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        qh, x, vt, bias = composed_inputs(G_B * G_Q, G_T, dtype, seed=0)
        kv = x[:, None].expand(-1, 8, -1, -1)
        mask = bias[:, None, None, :].to(dtype)
        best = in_turns({
            "plain": lambda: composed_attention_plain(qh, x, vt, bias, scale),
            "kernel": lambda: composed_attention(qh, x, vt, bias, scale),
            "library": lambda: F.scaled_dot_product_attention(
                qh, kv, vt, attn_mask=mask, scale=scale).sum(1)})
        bound_ms, bound_by = composed_bound(qh, x, vt, bias)
        log(f"composed_attention {dtype} R={G_B * G_Q} T={G_T}: kernel "
            f"{best['kernel']} ms, plain {best['plain']} ms, SDPA "
            f"{best['library']} ms, bound {bound_ms} ms ({bound_by})")
        rows.append({
            "name": "composed_attention_" + (
                "f32" if dtype == torch.float32 else "bf16"),
            "route": "cuda",
            "source": "vidsgg_big_tpu_torch/csrc/composed_attn.cu",
            "replaces": "vidsgg_big_tpu/ops/pallas_attention.py:67",
            "max_abs_err": max_err[dtype], "ms": best["kernel"],
            "plain_ms": best["plain"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": best["library"]})
        del qh, x, vt, bias, kv, mask
        torch.cuda.empty_cache()
    return rows


def drive_exp2():
    """Phase 3a: exp2 through eval_vidvrd, float32 then bfloat16.  Returns
    the launch counts of each run, {dtype: {kernel: launches}}."""
    from vidsgg_big_tpu_torch.tools import eval_vidvrd
    from vidsgg_big_tpu_torch.utils.config import parse_config_py
    n_deco = parse_config_py(EXP2_CFG)["model_config"]["n_deco_layers"]
    base = ["--cfg_path", EXP2_CFG, "--synthetic", str(N_VIDEOS),
            "--synthetic_model_dims", "--batch_size", str(BATCH),
            "--device", "cuda", "--output_dir", OUT_DIR]
    runs = {"float32": [], "bfloat16": ["--compute_dtype", "bfloat16",
                                        "--feat_dtype", "bfloat16"]}
    results, per_run = {}, {}
    reset_counts()
    for name, extra in runs.items():
        before = read_counts()
        t0 = time.perf_counter()
        res = eval_vidvrd.main(base + extra + [
            "--metrics_json", os.path.join(OUT_DIR, f"metrics_{name}.json")])
        res["wall_seconds"] = time.perf_counter() - t0
        per_run[name] = {k: v - before[k] for k, v in read_counts().items()}
        results[name] = res
    launches = read_counts()
    for name, res in results.items():
        log(f"eval_vidvrd {name}: {json.dumps(res)}")
        if res["n_videos"] != N_VIDEOS or res["n_relations"] == 0:
            raise AssertionError(f"{name}: {res['n_videos']} videos, "
                                 f"{res['n_relations']} relations")
        if not math.isfinite(res["mAP"]):
            raise AssertionError(f"{name}: mAP {res['mAP']}")
        if per_run[name]["role_attention"] != n_deco * res["n_batches"]:
            raise AssertionError(
                f"{name}: {per_run[name]['role_attention']} role-attention "
                "launches for "
                f"{res['n_batches']} forwards, expected {n_deco} each")
    if launches["role_attention"] == 0:
        raise AssertionError("the exp2 path launched no role-attention "
                             "kernel")
    return per_run


def drive_vidor():
    """Phase 3b: exp4 + grounding_weights through eval_vidor, float32 then
    bfloat16.  Returns ({dtype: {kernel: launches}}, {dtype: result})."""
    from vidsgg_big_tpu_torch.models.grounding import (GroundingConfig,
                                                       composed_encoders)
    from vidsgg_big_tpu_torch.tools import eval_vidor
    from vidsgg_big_tpu_torch.utils.config import parse_config_py
    n_deco = parse_config_py(EXP4_CFG)["model_config"]["n_deco_layers"]
    gcfg = GroundingConfig.from_dict(parse_config_py(GRD_CFG)[
        "model_config"])
    base = ["--cfg_path", EXP4_CFG, "--grounding_cfg_path", GRD_CFG,
            "--synthetic", str(VIDOR_VIDEOS), "--synthetic_model_dims",
            "--batch_size", str(VIDOR_BATCH), "--topk", str(VIDOR_TOPK),
            "--device", "cuda", "--output_dir", OUT_DIR]
    runs = {"float32": [], "bfloat16": ["--compute_dtype", "bfloat16",
                                        "--feat_dtype", "bfloat16"]}
    results, per_run = {}, {}
    reset_counts()
    for name, extra in runs.items():
        before = read_counts()
        t0 = time.perf_counter()
        res = eval_vidor.main(base + extra + [
            "--metrics_json", os.path.join(OUT_DIR,
                                           f"metrics_vidor_{name}.json")])
        res["wall_seconds"] = time.perf_counter() - t0
        after = read_counts()
        log(f"eval_vidor {name}: {json.dumps(res)}")
        buckets = sorted({(q, t) for q, t, _ in res["stage_b_batches"]})
        log(f"eval_vidor {name}: stage-B (Q, T) buckets reached {buckets}")
        if max(q for q, _ in buckets) < MIN_STAGE_B_Q:
            raise AssertionError(f"{name}: stage B reached no Q bucket of "
                                 f"{MIN_STAGE_B_Q} or more")
        engaged = sum(len(composed_encoders(gcfg, b, q, t))
                      for q, t, b in res["stage_b_batches"])
        got = {k: after[k] - before[k] for k in after}
        if res["n_videos"] != VIDOR_VIDEOS or res["n_relations"] == 0:
            raise AssertionError(f"{name}: {res['n_videos']} videos, "
                                 f"{res['n_relations']} relations")
        if not math.isfinite(res["mAP"]):
            raise AssertionError(f"{name}: mAP {res['mAP']}")
        if got["role_attention"] != n_deco * res["stage_a_batches"]:
            raise AssertionError(
                f"{name}: {got['role_attention']} role-attention launches "
                f"for {res['stage_a_batches']} stage-A forwards, expected "
                f"{n_deco} each")
        if engaged == 0 or got["composed_attention"] != engaged:
            raise AssertionError(
                f"{name}: {got['composed_attention']} composed-attention "
                f"launches over {len(res['stage_b_batches'])} stage-B "
                f"batches, where the gate engages {engaged} encoders; "
                "expected one launch each, and at least one")
        results[name], per_run[name] = res, got
    return per_run, results


def check_outputs(card):
    """Phase 4 (exp2): card vs CPU on one batch; steady-state videos/s."""
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


def grounding_batch(seed=0):
    """One stage-B batch at the bench geometry: B=4 videos of 299 valid
    clips padded to T=512, Q=256 queries (the last video's last 56 masked),
    as numpy."""
    from vidsgg_big_tpu_torch.data.synthetic import num_clips
    rng = np.random.default_rng(seed)
    n = num_clips(2400)
    feats = np.zeros((G_B, G_T, 1024), np.float32)
    feats[:, :n] = rng.normal(size=(G_B, n, 1024))
    clips = np.full((G_B,), n, np.int64)
    clip_mask = np.arange(G_T)[None] < clips[:, None]
    cats = np.stack([rng.integers(1, 81, (G_B, G_Q)),
                     rng.integers(1, 51, (G_B, G_Q)),
                     rng.integers(1, 81, (G_B, G_Q))], -1)
    s = rng.uniform(0, 0.6, (G_B, G_Q))
    temporal = np.stack([s, s + rng.uniform(0.05, 0.4, (G_B, G_Q))],
                        -1).astype(np.float32)
    qm = np.ones((G_B, G_Q), bool)
    qm[-1, 200:] = False
    return feats, clip_mask, clips, cats, temporal, qm


def check_grounding(card):
    """Phase 4 (grounding): one stage-B batch on the card vs the port's CPU
    run (float32, same weights); grounding inference ms/video at the bench
    geometry in float32 and bfloat16."""
    from vidsgg_big_tpu_torch.models.grounding import GroundingConfig
    from vidsgg_big_tpu_torch.tools.eval_vidor import build_grounding_model
    from vidsgg_big_tpu_torch.train.grounding_steps import (
        build_grounding_infer_step)
    from vidsgg_big_tpu_torch.utils.config import parse_config_py
    gmc = parse_config_py(GRD_CFG)["model_config"]
    icfg = parse_config_py(GRD_CFG)["inference_config"]
    batch = [torch.from_numpy(a) for a in grounding_batch()]
    feats, clip_mask, clips, cats, temporal, qm = batch
    ms_per_video = {}
    for dtype in ("float32", "bfloat16"):
        model = build_grounding_model(GroundingConfig.from_dict(
            dict(gmc, compute_dtype=dtype))).eval()
        if dtype == "float32":
            t0 = time.perf_counter()
            with torch.inference_mode():
                cpu = model(feats, clip_mask, cats, temporal, qm)
                gpu = model.cuda()(*(a.cuda() for a in (
                    feats, clip_mask, cats, temporal, qm)))
            log(f"grounding batch on the CPU and the card: "
                f"{time.perf_counter() - t0:.1f} s")
            compare_grounding(cpu, [a.cpu() for a in gpu])
        infer = build_grounding_infer_step(
            model.cuda(), score_th=icfg["score_th"], tiou_th=icfg["tiou_th"],
            bins_th=icfg["bins_th"], nms_th=icfg["nms_th"])
        dev = [a.cuda() for a in batch]
        ms = cuda_ms(lambda: infer(*dev), iters=5, warmup=2)
        ms_per_video[dtype] = ms / G_B
        log(f"grounding inference {dtype} B={G_B} Q={G_Q} T={G_T}: "
            f"{ms} ms/batch = {ms / G_B} ms/video on {card}")
        del model, infer, dev
        torch.cuda.empty_cache()
    return ms_per_video


def compare_grounding(cpu, gpu):
    """float32, no TF32: regression sigmoids within 2e-3, logits within
    1e-2 + 1e-3 relative.  At the reference init the head logits reach
    +-200 (the similarity fusion amplifies activations), where float32
    sums in another order move them by about 1e-3."""
    for name, c, g in zip(("regrs", "conf", "cls"), cpu, gpu):
        log(f"grounding card vs CPU {name}: max |value| "
            f"{c.abs().max().item()}, max |diff| "
            f"{(c - g).abs().max().item()}")
        if not (torch.isfinite(c).all() and torch.isfinite(g).all()):
            raise AssertionError(f"non-finite grounding {name}")
    torch.testing.assert_close(gpu[0], cpu[0], rtol=0, atol=2e-3)
    for c, g in zip(cpu[1:], gpu[1:]):
        torch.testing.assert_close(g, c, rtol=1e-3, atol=1e-2)


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

    kernels = [check_role_attention()] + check_composed_attention()
    by_path = {"exp2_vidvrd": drive_exp2()}
    by_path["vidor_two_stage"], vidor = drive_vidor()
    # role attention runs in float32 under both compute dtypes; each
    # composed row counts the launches of its dtype's runs
    rows_of = {"role_attention": ("role_attention", ("float32", "bfloat16")),
               "composed_attention_f32": ("composed_attention", ("float32",)),
               "composed_attention_bf16": ("composed_attention",
                                           ("bfloat16",))}
    for k in kernels:
        wrapper, dtypes = rows_of[k["name"]]
        k["launches_by_path"] = {
            p: sum(c[d][wrapper] for d in dtypes)
            for p, c in by_path.items()}
        k["launches"] = sum(k["launches_by_path"].values())
    check_outputs(card)
    ms_per_video = check_grounding(card)
    for dtype, res in vidor.items():
        seconds = res["stage_a_seconds"] + res["stage_b_seconds"]
        log(f"two-stage VidOR {dtype}: {res['n_videos']} videos in "
            f"{seconds} s of forward + decode = {res['n_videos'] / seconds} "
            f"videos/s (stage A {res['stage_a_seconds']} s, stage B "
            f"{res['stage_b_seconds']} s); grounding at B={G_B} Q={G_Q} "
            f"T={G_T}: {ms_per_video[dtype]} ms/video; {card}")

    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
