#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``vidsgg_big_tpu_torch``) on one card.

Run from the root of a checkout on a host with an NVIDIA H100:

    python3 chip_smoke.py [--parent OTHER_CHECKOUT]

Phases; any failure exits non-zero and prints no result line:
  1. the card's name and power limit; build every CUDA kernel with nvcc
     (one process per source, started together);
  2. every kernel against its plain PyTorch version on the card at the main
     paths' shapes, and its time beside the plain version's and its bound
     (CUDA events): role attention at exp2 N=50, the VidOR stage-A rungs
     N=64 and 192 and exp4 N=180, B in {1, 4, 8, 32}, padded videos
     included, and on the decoder layer's views; timed on the device alone
     (a CUDA graph of 20 calls, tools/role_attn_turns.py) at exp2 B=8 N=50,
     stage A B=4 N=64 and B=4 N=192 beside the wrapper's wall time a call,
     and with ``--parent CHECKOUT`` against that checkout's kernel in turns;
     its three instances' registers, spills and TF32 HMMA; composed
     attention: the inference forward at T in {128,
     512, 1024} x R in {4, 64, 1024}, the train forward (dropout 0 and
     0.1) and the backward at T in {128, 512} x R in {4, 64, 1024} and
     (R=64, T=1024), float32 and bfloat16, masked keys and a fully masked
     row; the dropout keep-mask read out of the kernel exactly and its
     realized rate; the backward called twice on the same inputs gives the
     same bits; timed at R=1024, T=512 beside PyTorch's SDPA (forward;
     forward + backward minus forward, at dropout 0 and 0.1); the
     forward's four instances' and the backward kernels' registers and
     spills (ptxas) and their tensor-core instructions (cuobjdump: wgmma in
     bf16, TF32 mma in f32);
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
     c. the grounding train step (build_grounding_train_step) at bench.py's
        train geometry, B=8 videos x P=64 predicate slots x T=512 clips
        (R = B x 2P = 1024 rows in the combined encoder), dropout 0.1:
        ms/step, videos/s and peak memory, one composed forward and one
        backward launch per step;
     d. the train_vidor --train_grounding entry point on grounding_weights
        with full-size synthetic videos (P=200 slots: R = 3,200 rows at
        batch 8), stopped after a step as on SIGTERM and resumed from its
        checkpoint;
     e. the BIG-C train step (build_train_step) at bench.py's BIG-C train
        geometry (bench.py:145-199): 8 videos at N=50 x T=256, 2048+832
        features, Q=192, 2 + 6 layers, 16 GT trajectories and 32 predicate
        slots, dropout 0.1: ms/step, videos/s, peak memory, the host ms of
        the matching (cost copy + scipy) and of the loss, no role-attention
        launch (train mode runs its plain version);
     f. the train_vidvrd entry point on exp2 with 16 full-size synthetic
        videos at batch 8: an uninterrupted run, and a run stopped after a
        step as on SIGTERM and resumed from its checkpoint, whose losses
        must equal the uninterrupted run's bit for bit;
     g. the checkpoint of f served through eval_vidvrd --ckpt_path (8
        videos, one batch: six role-attention launches);
     each in float32 and in bfloat16;
  4. checks of the output: one exp2 batch's pred_logits/att and one
     stage-B batch's regrs/conf/cls (B=4, Q=256, T=512) on the card
     against the port's CPU run on the same weights (float32); one train
     step's loss and gradients (R=64, T=512, dropout 0) on the card against
     the CPU; one BIG-C train step (2 full-size videos, dropout 0) on the
     card against the CPU: equal assignments, the loss terms and the
     gradients; the steady-state exp2 videos/s, the grounding inference
     ms/video at that geometry and the two-stage videos/s;
  5. a {"kernels": [...]} line, then the {"ok": true, ...} line.
"""
import argparse
import copy
import dataclasses
import json
import math
import os
import sys
import tempfile
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
# H100 SXM peaks (NVIDIA data sheet, dense): memory rate, float32 on CUDA
# cores, TF32 and bf16 on the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12
PEAK_TF32_FLOP_S = 495e12
PEAK_BF16_FLOP_S = 989e12
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
# composed backward, kernel vs plain: float32 sums in another order; in
# bfloat16 both round a_d and ds to bf16 before their products and the
# gradients after, with float32 sums in another order in between: one bf16
# step (2^-8 relative) at most, ~1e-3 on gradients of size ~0.3
COMPOSED_BWD_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-5),
                    torch.bfloat16: dict(rtol=2e-2, atol=2e-3)}
DROPOUT = 0.1                      # GroundingConfig.attn_dropout
# one train step, card vs CPU (float32, no TF32, dropout 0): the loss terms
# and each gradient leaf, after sums in another order through three QANet
# blocks, the fusion and three conv heads whose logits saturate at the
# reference init
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_TOL = 1e-2
# bench.py's grounding train geometry (bench.py:253-316): 8 videos x 64
# predicate slots, positive and negative queries through one forward
TR_B, TR_P = 8, 64
TRAIN_STEPS, TRAIN_WARMUP = 10, 2
# the entry point: videos, batch and steps before the stop, by dtype (f32
# at a batch whose float32 activations fit the card's 80 GB)
ENTRY_RUNS = {"bfloat16": dict(videos=16, batch=8, stop_after=1),
              "float32": dict(videos=8, batch=4, stop_after=1)}
# the BIG-C entry point: 16 full-size videos at batch 8, two steps
BIGC_ENTRY_VIDEOS = 16
# one BIG-C train step, card vs CPU: 2 full-size videos, float32 with no
# TF32, dropout 0; the same tolerances as the grounding step's
BIGC_PARITY_B = 2
# ... and its encoder time max-pool: at most this share of the pool's bins
# may pick another frame on the card than on the CPU, each only where the
# CPU's values at the two picks lie within this much of the pool input's
# largest magnitude (a tie within the devices' rounding)
MAXPOOL_FLIP_SHARE = 1e-4
MAXPOOL_TIE_RTOL = 1e-5


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


def f32_ops_seconds(flop):
    """The least time float32 products of ``flop`` FLOP can take on the
    card: CUDA-core FMA, or 3xTF32 on the tensor cores (three TF32 products
    per product, float32's precision), whichever is less.  Every float32
    bound of the kernels' line uses it; earlier runs printed CUDA-core FMA
    alone (``flop / PEAK_F32_FLOP_S``), which the f32 rows print beside."""
    return min(flop / PEAK_F32_FLOP_S, 3 * flop / PEAK_TF32_FLOP_S)


def ops_seconds(flop, dtype):
    return flop / PEAK_BF16_FLOP_S if dtype == torch.bfloat16 else \
        f32_ops_seconds(flop)


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
    read once as the kernel takes it (float32, the mask at its own width,
    one byte for bool), each output written once; matmul FLOPs at the
    float32 peak (f32_ops_seconds)."""
    from vidsgg_big_tpu_torch.ops.role_attn import role_attention_flops
    b, _, q, dh = p.shape
    n, de = e.shape[2], enco.shape[2]
    nbytes = 4 * (p.numel() + e.numel() + enco.numel() + b * 2 * q * n
                  + b * 2 * q * de) + mask.numel() * mask.element_size()
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops = f32_ops_seconds(role_attention_flops(b, q, n, dh, de))
    return 1e3 * max(t_bytes, t_ops), (
        "bytes" if t_bytes >= t_ops else "operations")


def kernel_counters():
    """Every kernel wrapper of the port, by kernel name."""
    from vidsgg_big_tpu_torch.ops.composed_attn import (
        composed_attention, composed_attention_backward,
        composed_attention_train)
    from vidsgg_big_tpu_torch.ops.role_attn import role_attention
    return {"role_attention": role_attention,
            "composed_attention": composed_attention,
            "composed_attention_train": composed_attention_train,
            "composed_attention_backward": composed_attention_backward}


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


def check_role_attention(parent=None):
    """Phase 2: kernel vs plain at exp2/exp4/VidOR shapes, on contiguous
    operands and on the decoder layer's views; then on the device alone
    (CUDA-graph replay, role_attn_turns) at exp2 B=8 N=50, stage A B=4
    N=64 and B=4 N=192, kernel and plain in turns, the wrapper's wall time
    per call and the bound beside them; with ``parent`` (another
    checkout's root), its kernel in turns A B B A at the same shapes."""
    from vidsgg_big_tpu_torch.ops.role_attn import (role_attention,
                                                    role_attention_plain)
    from vidsgg_big_tpu_torch.tools import role_attn_turns as turns
    max_err = 0.0

    def check(p, e, enco, mask, what):
        nonlocal max_err
        att, val = role_attention(p, e, enco, mask, DIM_ENTI)
        torch.cuda.synchronize()
        att_p, val_p = role_attention_plain(p, e, enco, mask, DIM_ENTI)
        torch.testing.assert_close(att, att_p, **ATT_TOL)
        torch.testing.assert_close(val, val_p, **VAL_TOL)
        if not mask[-1].any() and (att[-1].any() or val[-1].any()):
            raise AssertionError("padded video got nonzero attention")
        err = max((att - att_p).abs().max().item(),
                  (val - val_p).abs().max().item())
        max_err = max(max_err, err)
        log(f"role_attention {what}: max |kernel - plain| = {err}")

    for n in (50, 64, 180, 192):
        for b in (1, 4, 8, 32):
            check(*role_attn_inputs(b, n, seed=b * 1000 + n),
                  f"B={b} N={n}")
    for _, b, n in turns.SHAPES:
        check(*turns.layer_inputs(b, n, seed=n), f"B={b} N={n}, views")
    shapes = {}
    for name, b, n in turns.SHAPES:
        args = turns.layer_inputs(b, n, seed=b * 1000 + n)
        times = turns.graph_turns(
            {"plain": lambda: role_attention_plain(*args, DIM_ENTI),
             "kernel": lambda: role_attention(*args, DIM_ENTI)},
            ["plain", "kernel", "kernel", "plain"])
        bound_ms, bound_by = role_attn_bound(*args)
        shapes[name] = {
            "b": b, "n": n, "device_ms": min(times["kernel"]),
            "plain_device_ms": min(times["plain"]),
            "call_ms": turns.wall_ms(lambda: role_attention(*args,
                                                            DIM_ENTI)),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "parent_device_ms": None}
        log(f"role_attention {name} (B={b}, N={n}) on the device alone "
            f"(CUDA graph of {turns.CALLS} calls, ms a call, both turns): "
            f"kernel {times['kernel']}, plain {times['plain']}; wrapper "
            f"wall {shapes[name]['call_ms']} ms a call; bound {bound_ms} "
            f"ms ({bound_by})")
    if parent is not None:
        with tempfile.TemporaryDirectory() as tmp:
            libs = turns.other_libraries([parent], tmp)
            res = turns.run_turns(libs)
        for name, r in res.items():
            shapes[name]["parent_device_ms"] = min(r[parent])
            shapes[name]["device_ms_beside_parent"] = min(r["this"])
            log(f"role_attention {name} in turns A B B A with {parent}: "
                f"parent {r[parent]} ms, this {r['this']} ms, max |this - "
                f"parent| {r['max_abs_diff'][parent]}")
    exp2 = shapes[turns.SHAPES[0][0]]
    return {"name": "role_attention", "route": "cuda",
            "source": "vidsgg_big_tpu_torch/csrc/role_attn.cu",
            "replaces": "vidsgg_big_tpu/ops/pallas_role_attn.py:27",
            "max_abs_err": max_err, "ms": exp2["device_ms"],
            "plain_ms": exp2["plain_device_ms"],
            "bound_ms": exp2["bound_ms"], "bound_by": exp2["bound_by"],
            "library_ms": None, "device_ms": exp2["device_ms"],
            "call_ms": exp2["call_ms"],
            "parent_device_ms": exp2["parent_device_ms"], "shapes": shapes}


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
    """(bound ms, what bounds it) for one forward call on these inputs,
    with or without dropout: qh, x, vt and bias read once, out written once;
    4 T^2 d FLOP per row and head at the peak of the inputs' type (bf16
    tensor cores; f32 as f32_ops_seconds)."""
    from vidsgg_big_tpu_torch.ops.composed_attn import fused_attention_flops
    r, h, t, d = qh.shape
    nbytes = (qh.numel() + vt.numel() + 2 * x.numel()) * x.element_size() \
        + bias.numel() * 4
    t_ops = ops_seconds(fused_attention_flops(r, t, d, h), x.dtype)
    t_bytes = nbytes / PEAK_BYTES_S
    return 1e3 * max(t_bytes, t_ops), (
        "bytes" if t_bytes >= t_ops else "operations")


def cuda_core_note(qh, x, backward=False):
    """For a float32 row: the bound as earlier runs printed it, operations
    at the CUDA-core FMA rate alone (the bound is now f32_ops_seconds)."""
    if x.dtype != torch.float32:
        return ""
    from vidsgg_big_tpu_torch.ops.composed_attn import fused_attention_flops
    r, h, t, d = qh.shape
    flop = fused_attention_flops(r, t, d, h, backward) - (
        fused_attention_flops(r, t, d, h) if backward else 0.0)
    return (f"; CUDA-core FMA alone, the earlier definition: "
            f"{1e3 * flop / PEAK_F32_FLOP_S} ms")


def card_seeds(r, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(-2 ** 31, 2 ** 31, (r,), dtype=torch.int32,
                         generator=g).cuda()


def composed_bwd_bound(qh, x, vt, bias):
    """(bound ms, what bounds it) of one backward call: qh, vt, x, do and
    bias read once, dqh, dvt and dx written once (the forward's statistics
    that the kernels read are their design's traffic, not the function's);
    the TPU kernel's 10 T^2 d FLOP per row and head at the inputs' peak
    (bf16 tensor cores; f32 as f32_ops_seconds)."""
    from vidsgg_big_tpu_torch.ops.composed_attn import fused_attention_flops
    r, h, t, d = qh.shape
    nbytes = 2 * (qh.numel() + vt.numel()) * x.element_size() \
        + 3 * x.numel() * x.element_size() + bias.numel() * 4
    t_ops = ops_seconds(fused_attention_flops(r, t, d, h, backward=True)
                        - fused_attention_flops(r, t, d, h), x.dtype)
    t_bytes = nbytes / PEAK_BYTES_S
    return 1e3 * max(t_bytes, t_ops), (
        "bytes" if t_bytes >= t_ops else "operations")


def check_dropout_mask(dtype):
    """The train forward's keep-mask read out exactly: with vt_h the
    identity for one head (key k -> channel k, T = d = 128) and zero for
    the others, out[q, k] is that head's dropped weight, nonzero exactly
    where the mask keeps.  Returns the realized keep rate over 8 heads x
    64 rows x 128^2 weights."""
    from vidsgg_big_tpu_torch.ops.composed_attn import composed_attention
    from vidsgg_big_tpu_torch.ops.philox import (attention_keep,
                                                 drop_threshold)
    r, t = 64, 128
    qh, x, _, _ = composed_inputs(r, t, dtype, seed=7)
    bias = torch.zeros(r, t, device="cuda")
    seeds = card_seeds(r, 7)
    want = attention_keep(seeds, 8, t, t, DROPOUT)
    kept = 0
    for h in range(8):
        vt = torch.zeros(r, 8, t, 128, device="cuda", dtype=dtype)
        vt[:, h] = torch.eye(128, device="cuda", dtype=dtype)
        out = composed_attention(qh, x, vt, bias, 0.25, DROPOUT, seeds)
        torch.cuda.synchronize()
        if not torch.equal(out != 0, want[:, h]):
            raise AssertionError(f"{dtype} head {h}: the kernel's keep-mask "
                                 "differs from the plain Philox mask")
        kept += int(want[:, h].sum())
    n = 8 * r * t * t
    rate = kept / n
    q = 1.0 - drop_threshold(DROPOUT)[0] / 2 ** 32
    if abs(rate - q) > 4 * math.sqrt(q * (1 - q) / n):
        raise AssertionError(f"keep rate {rate}, expected {q}")
    log(f"composed_attention dropout {dtype}: keep-mask equal to the plain "
        f"one on {n} weights, kept share {rate} (expected {q})")
    return rate


def check_composed_attention():
    """Phase 2: composed attention, the three kernels (inference forward,
    train forward with dropout, backward) vs their plain versions at the
    grounding shapes; timing at R=1024, T=512 (the bench geometry's
    combined encoder) beside the plain versions and PyTorch's SDPA on the
    same inputs."""
    import torch.nn.functional as F
    from vidsgg_big_tpu_torch.ops.composed_attn import (
        composed_attention, composed_attention_backward,
        composed_attention_plain, composed_attention_plain_bwd,
        composed_attention_train)
    scale = 0.25                       # 1/sqrt(hd), hd = 128 / 8
    max_err = {}
    note = lambda key, err: max_err.__setitem__(key, max(max_err.get(
        key, 0.0), err))
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
                note(("fwd", dtype), err)
                log(f"composed_attention {dtype} R={r} T={t}: max |kernel "
                    f"- plain| = {err}")
                del args, out, want
        rate = check_dropout_mask(dtype)
        for r, t in ((4, 128), (64, 128), (1024, 128), (4, 512), (64, 512),
                     (1024, 512), (64, 1024)):
            args = composed_inputs(r, t, dtype, seed=3 * r + t)
            seeds = card_seeds(r, r + t)
            do = (torch.randn(args[1].shape, generator=torch.Generator()
                              .manual_seed(r)) * 0.5).to("cuda", dtype)
            for p in (0.0, DROPOUT):
                out, stats = composed_attention_train(*args, scale, p, seeds)
                got = composed_attention_backward(*args, seeds, stats, do,
                                                  scale, p)
                again = composed_attention_backward(*args, seeds, stats, do,
                                                    scale, p)
                torch.cuda.synchronize()
                if not all(torch.equal(g, a) for g, a in zip(got, again)):
                    raise AssertionError(f"{dtype} R={r} T={t} dropout {p}: "
                                         "two backward calls differ")
                want = composed_attention_plain(*args, scale, p, seeds)
                torch.testing.assert_close(out, want, **COMPOSED_TOL[dtype])
                ferr = (out.float() - want.float()).abs().max().item()
                if p > 0:
                    note(("drop", dtype), ferr)
                want = composed_attention_plain_bwd(*args, do, scale, p,
                                                    seeds)
                errs = []
                for name, g, w in zip(("dqh", "dx", "dvt"), got, want):
                    if not torch.isfinite(g).all():
                        raise AssertionError(f"non-finite {name}")
                    torch.testing.assert_close(g, w,
                                               **COMPOSED_BWD_TOL[dtype])
                    errs.append((g.float() - w.float()).abs().max().item())
                note(("bwd", dtype), max(errs))
                log(f"composed_attention train {dtype} R={r} T={t} "
                    f"dropout={p}: forward max |kernel - plain| = {ferr}; "
                    f"backward dqh/dx/dvt {errs}, two calls bit-equal")
                del out, stats, got, again, want
            del args, seeds, do
        torch.cuda.empty_cache()
        max_err[("rate", dtype)] = rate

    rows = []
    tag = lambda dtype: "f32" if dtype == torch.float32 else "bf16"
    for dtype in (torch.float32, torch.bfloat16):
        qh, x, vt, bias = composed_inputs(G_B * G_Q, G_T, dtype, seed=0)
        seeds = card_seeds(G_B * G_Q, 0)
        kv = x[:, None].expand(-1, 8, -1, -1)
        mask = bias[:, None, None, :].to(dtype)
        best = in_turns({
            "plain": lambda: composed_attention_plain(qh, x, vt, bias, scale),
            "kernel": lambda: composed_attention(qh, x, vt, bias, scale),
            "library": lambda: F.scaled_dot_product_attention(
                qh, kv, vt, attn_mask=mask, scale=scale).sum(1)})
        drop = in_turns({
            "plain": lambda: composed_attention_plain(
                qh, x, vt, bias, scale, DROPOUT, seeds),
            "kernel": lambda: composed_attention(qh, x, vt, bias, scale,
                                                 DROPOUT, seeds),
            "library": lambda: F.scaled_dot_product_attention(
                qh, kv, vt, attn_mask=mask, scale=scale,
                dropout_p=DROPOUT).sum(1)})
        bound_ms, bound_by = composed_bound(qh, x, vt, bias)
        log(f"composed_attention {dtype} R={G_B * G_Q} T={G_T}: kernel "
            f"{best['kernel']} ms, plain {best['plain']} ms, SDPA "
            f"{best['library']} ms, bound {bound_ms} ms ({bound_by}"
            f"{cuda_core_note(qh, x)}); dropout {DROPOUT}: kernel "
            f"{drop['kernel']} ms, plain {drop['plain']} ms, SDPA "
            f"{drop['library']} ms, same bound")
        base = {"route": "cuda",
                "source": "vidsgg_big_tpu_torch/csrc/composed_attn.cu",
                "replaces": "vidsgg_big_tpu/ops/pallas_attention.py:67",
                "bound_ms": bound_ms, "bound_by": bound_by}
        rows.append(dict(base, name="composed_attention_" + tag(dtype),
                         max_abs_err=max_err[("fwd", dtype)],
                         ms=best["kernel"], plain_ms=best["plain"],
                         library_ms=best["library"]))
        rows.append(dict(base, name="composed_attention_dropout_" +
                         tag(dtype), max_abs_err=max_err[("drop", dtype)],
                         ms=drop["kernel"], plain_ms=drop["plain"],
                         library_ms=drop["library"],
                         keep_rate=max_err[("rate", dtype)]))
        # backward: the train forward's statistics, a cotangent; SDPA's
        # forward + backward of the same function minus its forward, at
        # dropout 0 and at the train step's dropout
        _, stats = composed_attention_train(qh, x, vt, bias, scale, DROPOUT,
                                            seeds)
        do = (torch.randn(x.shape, generator=torch.Generator().manual_seed(
            1)) * 0.5).to("cuda", dtype)
        lq, lkv, lv = (a.detach().clone().requires_grad_()
                       for a in (qh, x, vt))

        def sdpa_fwd_bwd(p):
            o = F.scaled_dot_product_attention(
                lq, lkv[:, None].expand(-1, 8, -1, -1), lv, attn_mask=mask,
                scale=scale, dropout_p=p).sum(1)
            o.backward(do)

        def sdpa_fwd(p):
            with torch.no_grad():
                F.scaled_dot_product_attention(
                    lq, lkv[:, None].expand(-1, 8, -1, -1), lv,
                    attn_mask=mask, scale=scale, dropout_p=p).sum(1)
        bwd = in_turns({
            "plain": lambda: composed_attention_plain_bwd(
                qh, x, vt, bias, do, scale, DROPOUT, seeds),
            "kernel": lambda: composed_attention_backward(
                qh, x, vt, bias, seeds, stats, do, scale, DROPOUT),
            # the same kernels with no keep-mask to draw: what the Philox
            # regeneration costs
            "kernel_dropout0": lambda: composed_attention_backward(
                qh, x, vt, bias, seeds, stats, do, scale, 0.0),
            "library_fwd_bwd": lambda: sdpa_fwd_bwd(0.0),
            "library_fwd": lambda: sdpa_fwd(0.0),
            "library_fwd_bwd_drop": lambda: sdpa_fwd_bwd(DROPOUT),
            "library_fwd_drop": lambda: sdpa_fwd(DROPOUT)})
        bwd_bound, bwd_by = composed_bwd_bound(qh, x, vt, bias)
        library = bwd["library_fwd_bwd"] - bwd["library_fwd"]
        library_drop = bwd["library_fwd_bwd_drop"] - bwd["library_fwd_drop"]
        log(f"composed_attention backward {dtype} R={G_B * G_Q} T={G_T} "
            f"dropout {DROPOUT}: kernel {bwd['kernel']} ms ("
            f"{bwd['kernel_dropout0']} ms at dropout 0), plain "
            f"{bwd['plain']} ms, SDPA forward+backward minus forward "
            f"{library} ms at dropout 0, {library_drop} ms at dropout "
            f"{DROPOUT}, bound {bwd_bound} ms ({bwd_by}"
            f"{cuda_core_note(qh, x, backward=True)})")
        rows.append({
            "name": "composed_attention_backward_" + tag(dtype),
            "route": "cuda",
            "source": "vidsgg_big_tpu_torch/csrc/composed_attn_bwd.cu",
            "replaces": "vidsgg_big_tpu/ops/pallas_attention.py:89",
            "max_abs_err": max_err[("bwd", dtype)], "ms": bwd["kernel"],
            "plain_ms": bwd["plain"], "bound_ms": bwd_bound,
            "bound_by": bwd_by, "library_ms": library,
            "library_dropout_ms": library_drop,
            "ms_dropout0": bwd["kernel_dropout0"]})
        del qh, x, vt, bias, kv, mask, stats, do, lq, lkv, lv
        torch.cuda.empty_cache()
    return rows


def opcode(instruction):
    """The opcode of a SASS instruction, past its predicate."""
    words = instruction.split()
    return words[1] if words[0].startswith("@") else words[0]


def kernel_code(ptxas_log, library, kernels, what):
    """{key: registers, spills (ptxas) and tensor-core instructions
    (cuobjdump of the built library)} of the kernels ``{key: name}``: wgmma
    (HGMMA) in the bf16 ones, TF32 mma.sync (HMMA ... TF32) in the f32
    ones, and the waits on wgmma that ptxas placed (WARPGROUP.DEPBAR: one
    after every HGMMA means it serialised them).  Fails where a kernel has
    none of its kind."""
    from vidsgg_big_tpu_torch.ops import build
    usage = build.ptxas_usage(ptxas_log)
    code = build.sass(build.library_path(library))
    report = {}
    for key, name in kernels.items():
        (use,) = [v for k, v in usage.items() if name in k]
        (body,) = [v for k, v in code.items() if name in k]
        ops = [opcode(i) for i in body]
        report[key] = dict(use, hgmma=sum(o.startswith("HGMMA") for o in ops),
                           tf32_hmma=sum(o.startswith("HMMA") and "TF32" in o
                                         for o in ops),
                           wgmma_waits=sum(o.startswith("WARPGROUP.DEPBAR")
                                           for o in ops))
        log(f"{what} kernel {name}: {report[key]}")
        if report[key]["hgmma" if "bf16" in key else "tf32_hmma"] == 0:
            raise AssertionError(f"{name} issues no "
                                 f"{'HGMMA' if 'bf16' in key else 'TF32 HMMA'}")
    return report


def forward_code(ptxas_log):
    """kernel_code of the forward's four instances."""
    from vidsgg_big_tpu_torch.tools.sass_compare import SOURCES
    keys = ("bf16_inference", "bf16_train", "f32_inference", "f32_train")
    return kernel_code(ptxas_log, "composed_attn",
                       dict(zip(keys, SOURCES["forward"][1])), "forward")


def role_code(ptxas_log):
    """kernel_code of the role-attention kernel's three instances, by the
    values columns of a pass: 512, 256 and 128 (De / S above 256, above
    128, up to 128)."""
    return kernel_code(ptxas_log, "role_attn",
                       {f"f32_cw{cw}": f"role_attn_kernelILi{cw}E"
                        for cw in (512, 256, 128)}, "role attention")


def backward_code(ptxas_log):
    """kernel_code of the backward's four kernels."""
    from vidsgg_big_tpu_torch.tools.sass_compare import SOURCES
    keys = ("dq_bf16", "dkv_bf16", "dq_f32", "dkv_f32")
    return kernel_code(ptxas_log, "composed_attn_bwd",
                       dict(zip(keys, SOURCES["backward"][1])), "backward")


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


def train_batch(b, p_bucket, wire, seed0=0):
    """A grounding train batch of ``b`` full-size synthetic VidOR videos
    (2,400 frames: 299 I3D clips in the T=512 bucket, 16 GT predicates in
    ``p_bucket`` slots), as the train_vidor entry point packs it (CPU)."""
    from vidsgg_big_tpu_torch.data.synthetic import (clip_features,
                                                     make_vidor_video)
    from vidsgg_big_tpu_torch.tools.eval_vidor import FULL_SIZE_RECIPE
    from vidsgg_big_tpu_torch.tools.train_vidor import make_batch
    rows = []
    for i in range(seed0, seed0 + b):
        _, gt = make_vidor_video(i, feat_dim=4, **FULL_SIZE_RECIPE)
        rows.append((clip_features(i, gt.video_len, 1024), gt))
    return make_batch(rows, G_T, b, 1024, p_bucket, wire)


def grounding_train_parts(dtype, **overrides):
    from vidsgg_big_tpu_torch.models.grounding import GroundingConfig
    from vidsgg_big_tpu_torch.tools.eval_vidor import build_grounding_model
    from vidsgg_big_tpu_torch.utils.config import parse_config_py
    cfgs = parse_config_py(GRD_CFG)
    cfg = dataclasses.replace(GroundingConfig.from_dict(dict(
        cfgs["model_config"], compute_dtype=dtype)), **overrides)
    return build_grounding_model(cfg), cfgs["train_config"]


def drive_train_step(card):
    """Phase 3c: build_grounding_train_step at bench.py's train geometry
    (B=8 videos, P=64 slots, T=512: R=1024 rows in the combined encoder),
    dropout 0.1, float32 then bfloat16.  Returns ({dtype: {kernel:
    launches}}, {dtype: result})."""
    from vidsgg_big_tpu_torch.tools.train_vidor import _to_device
    from vidsgg_big_tpu_torch.train.grounding_steps import (
        build_grounding_train_step)
    from vidsgg_big_tpu_torch.train.loop import step_generator
    from vidsgg_big_tpu_torch.train.train_state import TrainState
    per_run, results = {}, {}
    dev = torch.device("cuda")
    for dtype in ("float32", "bfloat16"):
        model, tc = grounding_train_parts(dtype)
        model = model.cuda()
        state = TrainState(model, tc["initial_lr"], tc["lr_decay"],
                           [40, 60])
        step = build_grounding_train_step(model, state)
        batch = _to_device(train_batch(TR_B, TR_P, getattr(torch, dtype)),
                           dev)
        torch.cuda.reset_peak_memory_stats()
        for i in range(TRAIN_WARMUP):
            step(*batch, generator=step_generator(1, i))["total"].item()
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        for i in range(TRAIN_STEPS):
            metrics = step(*batch, generator=step_generator(
                1, TRAIN_WARMUP + i))
        loss = metrics["total"].item()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
        log(f"grounding train step {dtype} B={TR_B} P={TR_P} T={G_T} (R="
            f"{TR_B * 2 * TR_P}): {ms} ms/step = {TR_B * 1e3 / ms} videos/s, "
            f"peak memory {peak / 2 ** 30:.2f} GiB, loss {loss}, launches "
            f"{counts} on {card}")
        if not math.isfinite(loss):
            raise AssertionError(f"{dtype}: train loss {loss}")
        if counts["composed_attention_train"] != TRAIN_STEPS or \
                counts["composed_attention_backward"] != TRAIN_STEPS or \
                counts["composed_attention"] != 0:
            raise AssertionError(
                f"{dtype}: launches {counts} over {TRAIN_STEPS} steps; "
                "expected one train forward and one backward each")
        per_run[dtype] = counts
        results[dtype] = dict(ms_per_step=ms, videos_per_s=TR_B * 1e3 / ms,
                              peak_bytes=peak, loss=loss)
        del model, state, step, batch
        torch.cuda.empty_cache()
    return per_run, results


def drive_train_entry(card):
    """Phase 3d: the train_vidor --train_grounding entry point on
    grounding_weights with full-size synthetic videos, one epoch, stopped
    after ``stop_after`` steps as on SIGTERM and resumed from the
    checkpoint; bfloat16 at the config's batch 8, float32 at batch 4.
    Returns ({dtype: {kernel: launches}}, {dtype: result})."""
    import shutil
    from vidsgg_big_tpu_torch.tools import train_vidor
    per_run, results = {}, {}
    for dtype, run in ENTRY_RUNS.items():
        out = os.path.join(OUT_DIR, f"train_vidor_{dtype}")
        shutil.rmtree(out, ignore_errors=True)
        base = ["--train_grounding", "--cfg_path", GRD_CFG, "--synthetic",
                str(run["videos"]), "--synthetic_model_dims",
                "--batch_size", str(run["batch"]), "--epochs", "1",
                "--compute_dtype", dtype, "--device", "cuda",
                "--output_dir", out]
        steps = run["videos"] // run["batch"]
        reset_counts()
        t0 = time.perf_counter()
        first = train_vidor.main(base + ["--stop_after_batches",
                                         str(run["stop_after"])])
        second = train_vidor.main(base + ["--from_checkpoint"])
        seconds = time.perf_counter() - t0
        counts = read_counts()
        with open(os.path.join(out, "logfile", "metrics.jsonl")) as f:
            losses = {r["step"]: r["value"] for r in map(json.loads, f)
                      if r["tag"] == "loss/total"}
        log(f"train_vidor {dtype} batch {run['batch']} (R="
            f"{run['batch'] * 2 * 200} rows): stopped at step "
            f"{first['step']}, resumed to {second['step']}; losses {losses};"
            f" peak memory {first['max_memory_allocated'] / 2 ** 30:.2f} / "
            f"{second['max_memory_allocated'] / 2 ** 30:.2f} GiB; "
            f"{seconds:.1f} s; launches {counts} on {card}")
        if first["step"] != run["stop_after"] or second["step"] != steps:
            raise AssertionError(f"{dtype}: steps {first['step']} then "
                                 f"{second['step']}, expected "
                                 f"{run['stop_after']} then {steps}")
        if sorted(losses) != list(range(1, steps + 1)) or not all(
                math.isfinite(v) for v in losses.values()):
            raise AssertionError(f"{dtype}: journal {losses}")
        if counts["composed_attention_train"] != steps or \
                counts["composed_attention_backward"] != steps:
            raise AssertionError(f"{dtype}: launches {counts} over {steps} "
                                 "steps")
        per_run[dtype] = counts
        results[dtype] = dict(first=first, second=second, seconds=seconds)
    return per_run, results


def bigc_train_parts(dtype, **overrides):
    """The exp2 model (random weights from eval_vidvrd's seed) and its
    config at ``dtype``, on the CPU."""
    from vidsgg_big_tpu_torch.models.big_c import BigCConfig
    from vidsgg_big_tpu_torch.tools import eval_vidvrd
    from vidsgg_big_tpu_torch.utils.config import parse_config_py
    mc = dict(parse_config_py(EXP2_CFG)["model_config"], compute_dtype=dtype)
    cfg = dataclasses.replace(BigCConfig.from_dict(mc), **overrides)
    return eval_vidvrd.build_model(cfg, mc), cfg


def time_bigc_loss(model, cfg, props, gts, reps=10):
    """On one batch's train-mode outputs (no gradient): the host ms of the
    matching (the cost's copy to the host, scipy, the assignment's copy
    back; the card idle before it), the ms of the whole loss
    (bigc_train_loss at the step's t_abs), and the loss's peak memory above
    its inputs at the entry point's t_abs=4096, each the mean of ``reps``."""
    from vidsgg_big_tpu_torch.ops.matching import hungarian
    from vidsgg_big_tpu_torch.tools.train_vidvrd import T_ABS
    from vidsgg_big_tpu_torch.train.losses import bigc_train_loss
    from vidsgg_big_tpu_torch.train.loop import step_generator
    with torch.no_grad():
        out = model(props, generator=step_generator(2, 0))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            total, _, (_, cost) = bigc_train_loss(out, props, gts, cfg)
            total.item()
        loss_ms = (time.perf_counter() - t0) * 1e3 / reps
        n_gt = gts.pred_mask.sum(-1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            hungarian(cost, n_gt)
        torch.cuda.synchronize()
        match_ms = (time.perf_counter() - t0) * 1e3 / reps
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        bigc_train_loss(out, props, gts, cfg, t_abs=T_ABS)[0].item()
        loss_peak = torch.cuda.max_memory_allocated() - base
    return match_ms, loss_ms, loss_peak


def drive_bigc_train_step(card):
    """Phase 3e: build_train_step on exp2 at bench.py's BIG-C train geometry
    (B=8, N=50, T=256, 16 GT trajectories, 32 predicate slots), dropout 0.1,
    float32 then bfloat16.  Returns ({dtype: {kernel: launches}}, {dtype:
    result})."""
    from vidsgg_big_tpu_torch.data.synthetic_vidvrd import bench_train_batch
    from vidsgg_big_tpu_torch.train.loop import step_generator
    from vidsgg_big_tpu_torch.train.steps import build_train_step
    from vidsgg_big_tpu_torch.train.train_state import TrainState
    per_run, results = {}, {}
    for dtype in ("float32", "bfloat16"):
        model, cfg = bigc_train_parts(dtype)
        model = model.cuda()
        # bench.py's optimizer: Adam 1e-4, one milestone past the run
        state = TrainState(model, 1e-4, 0.2, [10_000])
        step = build_train_step(model, state)
        batch = bench_train_batch(cfg, BATCH, "cuda", getattr(torch, dtype))
        n_gt = batch[1].traj_mask.sum(-1).tolist()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for i in range(TRAIN_WARMUP):
            step(*batch, generator=step_generator(1, i))["total"].item()
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        for i in range(TRAIN_STEPS):
            metrics = step(*batch, generator=step_generator(
                1, TRAIN_WARMUP + i))
        loss = metrics["total"].item()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
        match_ms, loss_ms, loss_peak = time_bigc_loss(model, cfg, *batch)
        log(f"BIG-C train step {dtype} exp2 B={BATCH} N=50 T=256 Q={Q} "
            f"(GT trajectories {n_gt} in 16 slots): {ms} ms/step = "
            f"{BATCH * 1e3 / ms} videos/s, peak memory "
            f"{peak / 2 ** 30:.2f} GiB, loss {loss}, grad norm "
            f"{metrics['grad_norm'].item()}; matching on the host {match_ms} "
            f"ms ({100 * match_ms / ms:.1f}% of a step), the loss {loss_ms} "
            f"ms, the loss's peak above its inputs at t_abs=4096 "
            f"{loss_peak / 2 ** 20:.1f} MiB; launches {counts} on {card}")
        if not math.isfinite(loss):
            raise AssertionError(f"{dtype}: BIG-C train loss {loss}")
        if any(counts.values()):
            raise AssertionError(f"{dtype}: kernel launches {counts} in "
                                 "train mode; role attention is plain there")
        per_run[dtype] = counts
        results[dtype] = dict(ms_per_step=ms, videos_per_s=BATCH * 1e3 / ms,
                              peak_bytes=peak, loss=loss,
                              matching_host_ms=match_ms, loss_ms=loss_ms,
                              loss_peak_bytes=loss_peak)
        del model, state, step, batch
        torch.cuda.empty_cache()
    return per_run, results


def drive_train_vidvrd(card):
    """Phase 3f: the train_vidvrd entry point on exp2, 16 full-size videos
    at batch 8 (two steps), float32 then bfloat16: one uninterrupted run,
    and one stopped after a step as on SIGTERM and resumed from its
    checkpoint; the resumed run's journal must equal the uninterrupted
    one's bit for bit.  Returns ({dtype: {kernel: launches}}, {dtype:
    checkpoint directory})."""
    import shutil
    from vidsgg_big_tpu_torch.tools import train_vidvrd
    per_run, ckpts = {}, {}
    for dtype in ("float32", "bfloat16"):
        out = os.path.join(OUT_DIR, f"train_vidvrd_{dtype}")
        shutil.rmtree(out, ignore_errors=True)
        base = ["--cfg_path", EXP2_CFG, "--synthetic",
                str(BIGC_ENTRY_VIDEOS), "--synthetic_model_dims",
                "--batch_size", str(BATCH), "--epochs", "1",
                "--compute_dtype", dtype, "--device", "cuda"]
        steps = BIGC_ENTRY_VIDEOS // BATCH
        reset_counts()
        t0 = time.perf_counter()
        full = train_vidvrd.main(base + ["--output_dir", out + "/full"])
        first = train_vidvrd.main(base + ["--output_dir", out + "/resumed",
                                          "--stop_after_batches", "1"])
        second = train_vidvrd.main(base + ["--output_dir", out + "/resumed",
                                           "--from_checkpoint"])
        seconds = time.perf_counter() - t0
        counts = read_counts()
        journals = {}
        for run in ("full", "resumed"):
            with open(os.path.join(out, run, "logfile",
                                   "metrics.jsonl")) as f:
                journals[run] = {r["step"]: r["value"]
                                 for r in map(json.loads, f)
                                 if r["tag"] == "loss/total"}
        log(f"train_vidvrd {dtype} batch {BATCH}: uninterrupted losses "
            f"{journals['full']}; stopped at step {first['step']}, resumed "
            f"to {second['step']}: losses {journals['resumed']}; peak memory "
            f"{full['max_memory_allocated'] / 2 ** 30:.2f} / "
            f"{first['max_memory_allocated'] / 2 ** 30:.2f} / "
            f"{second['max_memory_allocated'] / 2 ** 30:.2f} GiB; "
            f"{seconds:.1f} s for the three runs; launches {counts} on "
            f"{card}")
        if (full["step"], first["step"], second["step"]) != (steps, 1,
                                                            steps):
            raise AssertionError(f"{dtype}: steps {full['step']}, "
                                 f"{first['step']}, {second['step']}")
        if sorted(journals["full"]) != list(range(1, steps + 1)) or not all(
                math.isfinite(v) for v in journals["full"].values()):
            raise AssertionError(f"{dtype}: journal {journals['full']}")
        if journals["resumed"] != journals["full"]:
            raise AssertionError(f"{dtype}: the resumed run's losses "
                                 f"{journals['resumed']} differ from the "
                                 f"uninterrupted run's {journals['full']}")
        if any(counts.values()):
            raise AssertionError(f"{dtype}: kernel launches {counts} in "
                                 "training")
        per_run[dtype] = counts
        ckpts[dtype] = full["ckpt_dir"]
    return per_run, ckpts


def serve_trained(card, ckpts):
    """Phase 3g: each dtype's trained checkpoint served through
    eval_vidvrd --ckpt_path at that dtype, 8 full-size videos in one batch.
    Returns {dtype: {kernel: launches}}."""
    from vidsgg_big_tpu_torch.tools import eval_vidvrd
    from vidsgg_big_tpu_torch.utils.config import parse_config_py
    n_deco = parse_config_py(EXP2_CFG)["model_config"]["n_deco_layers"]
    per_run = {}
    for dtype, ckpt in ckpts.items():
        reset_counts()
        res = eval_vidvrd.main([
            "--cfg_path", EXP2_CFG, "--ckpt_path", ckpt, "--synthetic",
            str(BATCH), "--synthetic_model_dims", "--batch_size", str(BATCH),
            "--compute_dtype", dtype, "--feat_dtype", dtype, "--device",
            "cuda", "--output_dir", OUT_DIR, "--metrics_json",
            os.path.join(OUT_DIR, f"metrics_trained_{dtype}.json")])
        counts = read_counts()
        log(f"eval_vidvrd of the {dtype}-trained checkpoint {ckpt}: "
            f"{json.dumps(res)}; launches {counts} on {card}")
        if counts["role_attention"] != n_deco * res["n_batches"] or \
                res["n_batches"] != 1:
            raise AssertionError(
                f"{dtype}: {counts['role_attention']} role-attention "
                f"launches for {res['n_batches']} forwards, expected "
                f"{n_deco} each")
        if not math.isfinite(res["mAP"]) or res["n_relations"] == 0:
            raise AssertionError(f"{dtype}: mAP {res['mAP']}, "
                                 f"{res['n_relations']} relations")
        per_run[dtype] = counts
    return per_run


def amax_routing(x, out_len):
    """How torch.amax's backward spreads each bin's gradient over the bin
    (adaptive_max_pool1d over the time axis of x (n, L, E), L a multiple of
    out_len): 1 / #maxima at each maximum, 0 elsewhere; (n, out_len,
    L / out_len, E)."""
    n, length, e = x.shape
    b = x.reshape(n, out_len, length // out_len, e)
    top = b == b.amax(2, keepdim=True)
    return top / top.sum(2, keepdim=True)


def routed_max_pool(routing, seen):
    """adaptive_max_pool1d with the forward of torch.amax and a backward
    that spreads each bin's gradient by ``routing`` (amax_routing of
    another run); the pooled input is appended to ``seen``."""
    def pool(x, out_len, axis=-2):
        seen.append(x.detach())
        n, length, e = x.shape
        b = x.reshape(n, out_len, length // out_len, e)
        return b.detach().amax(2) + ((b - b.detach()) * routing).sum(2)
    return pool


def check_bigc_train_parity():
    """Phase 4 (BIG-C training): one train step's loss and gradients on the
    card against the port's CPU run on the same weights and batch (2
    full-size videos at bench.py's train geometry, float32, dropout 0):
    the assignments must be equal, the loss terms within TRAIN_LOSS_RTOL,
    every gradient within TRAIN_GRAD_TOL of its leaf's scale.  Where an
    assignment differs, the two solutions' costs under the CPU's cost
    matrix are printed before the failure.

    The tracklet encoder's time max-pool picks one of 32 frames per bin
    and channel; where two frames' values lie within the two devices'
    rounding (a few 1e-6), the card may pick the other, and the gradients
    below the pool then differ by a whole frame's contribution (a few
    bins in 10^5 on an H100, moving conv_feat2enti.weight's gradient by
    about 1% of its scale).  So the card's backward spreads each bin's gradient as the CPU's torch.amax
    does (routed_max_pool; the forward is the card's own amax), and the
    card's own picks are held apart: at most MAXPOOL_FLIP_SHARE of the bins
    may differ from the CPU's, each a tie within MAXPOOL_TIE_RTOL of the
    pool input's scale on the CPU's values."""
    from vidsgg_big_tpu_torch.models import big_c
    from vidsgg_big_tpu_torch.data.synthetic_vidvrd import bench_train_batch
    from vidsgg_big_tpu_torch.train.losses import bigc_train_loss
    model, cfg = bigc_train_parts("float32", dropout=0.0)
    batch = bench_train_batch(cfg, BIGC_PARITY_B, "cpu", torch.float32,
                              seed0=20)
    pooled, real_pool = [], big_c.adaptive_max_pool1d

    def run(m, props, gts, pool):
        big_c.adaptive_max_pool1d = pool
        try:
            m.train()
            m.zero_grad()
            # at build_train_step's default t_abs, as phase 3e
            total, terms, (q4g, cost) = bigc_train_loss(m(props), props,
                                                        gts, cfg)
            total.backward()
        finally:
            big_c.adaptive_max_pool1d = real_pool
        return ({k: v.item() for k, v in dict(terms, total=total).items()},
                {k: p.grad.detach().cpu() for k, p in m.named_parameters()},
                q4g.cpu(), cost.cpu())

    def seen_pool(x, out_len, axis=-2):
        pooled.append(x.detach())
        return real_pool(x, out_len, axis)
    t0 = time.perf_counter()
    cpu_terms, cpu_grads, cpu_q, cpu_cost = run(model, *batch, seen_pool)
    seconds = time.perf_counter() - t0
    routing = amax_routing(pooled[0], cfg.enco_pool_len)
    reset_counts()
    dev = [type(x)(**{k: v.cuda() for k, v in vars(x).items()})
           for x in batch]
    gpu_terms, gpu_grads, gpu_q, gpu_cost = run(
        copy.deepcopy(model).cuda(), *dev,
        routed_max_pool(routing.cuda(), pooled))
    counts = read_counts()
    own = amax_routing(pooled[1].cpu(), cfg.enco_pool_len)
    flipped = (own != routing).any(2)
    flips, bins = int(flipped.sum()), flipped.numel()
    # the CPU's max of each bin less its least value among the card's picks
    x = pooled[0].reshape(routing.shape)
    gap = (x.amax(2) - torch.where(own > 0, x, math.inf).amin(2)).max()
    scale = pooled[0].abs().max().item()
    log(f"BIG-C encoder max-pool: {flips} of {bins} bins route their "
        "gradient differently on the card than on the CPU (the card's "
        "backward takes the CPU's routing); the widest gap between the "
        f"CPU's values at the two picks {gap.item()}, max |pool input| "
        f"{scale}, max |pool input card - CPU| "
        f"{(pooled[1].cpu() - pooled[0]).abs().max().item()}")
    if flips > MAXPOOL_FLIP_SHARE * bins or \
            gap.item() > MAXPOOL_TIE_RTOL * scale:
        raise AssertionError(
            f"the card's max-pool picks another frame in {flips} of {bins} "
            f"bins (at most {MAXPOOL_FLIP_SHARE * bins:.0f}), with a gap up "
            f"to {gap.item()} (at most {MAXPOOL_TIE_RTOL * scale}) on the "
            "CPU's values")
    if any(counts.values()):
        raise AssertionError(f"BIG-C train step launches {counts}")
    log(f"BIG-C train step on the CPU ({seconds:.1f} s) and the card: loss "
        f"terms {cpu_terms} / {gpu_terms}; max |cost| diff "
        f"{(cpu_cost - gpu_cost).abs().max().item()}")
    if not torch.equal(cpu_q, gpu_q):
        for name, q in (("CPU", cpu_q), ("card", gpu_q)):
            total = sum(cpu_cost[b, qq, p].item()
                        for b in range(q.shape[0])
                        for p, qq in enumerate(q[b].tolist()) if qq >= 0)
            log(f"the {name}'s assignment {q.tolist()} costs {total} under "
                "the CPU's cost")
        raise AssertionError("the card's assignment differs from the CPU's")
    worst = (0.0, None)
    for k, g in cpu_grads.items():
        if not (torch.isfinite(g).all() and torch.isfinite(
                gpu_grads[k]).all()):
            raise AssertionError(f"non-finite gradient {k}")
        scale = g.abs().max().item()
        err = (gpu_grads[k] - g).abs().max().item()
        worst = max(worst, (err / max(scale, 1e-12), k))
        if err > TRAIN_GRAD_TOL * scale + 1e-6:
            raise AssertionError(f"gradient {k}: max |card - CPU| {err}, "
                                 f"max |CPU| {scale}")
    for name, v in cpu_terms.items():
        if abs(gpu_terms[name] - v) > TRAIN_LOSS_RTOL * abs(v):
            raise AssertionError(f"loss {name}: card {gpu_terms[name]}, "
                                 f"CPU {v}")
    log(f"BIG-C train step card vs CPU: equal assignments "
        f"({int((cpu_q >= 0).sum())} pairs), worst gradient leaf max |diff| "
        f"/ max |g| = {worst[0]} ({worst[1]})")
    return worst[0]


def check_train_parity():
    """Phase 4 (training): one train step (R = 2 videos x 2 x 16 slots =
    64 rows, T=512, dropout 0, the same Gumbel draw) on the card against
    the port's CPU run on the same weights, float32.  A 256 MiB attention
    budget sends the combined encoder down the composed path at this row
    count, so the card runs the train forward and backward kernels."""
    from vidsgg_big_tpu_torch.tools.train_vidor import _to_device
    from vidsgg_big_tpu_torch.train.grounding_data import gumbel_noise
    from vidsgg_big_tpu_torch.train.grounding_steps import (
        grounding_train_loss)
    model, _ = grounding_train_parts("float32", dropout=0.0,
                                     attn_dropout=0.0,
                                     attn_bytes_budget=1 << 28)
    batch = train_batch(2, 16, torch.float32, seed0=20)
    noise = gumbel_noise((2, 16, 51), torch.Generator().manual_seed(3))

    def run(m, b):
        m.train()
        m.zero_grad()
        total, terms = grounding_train_loss(m, *b, noise=noise.to(
            b[0].device))
        total.backward()
        return ({k: v.item() for k, v in dict(terms, total=total).items()},
                {k: p.grad.detach().cpu() for k, p in m.named_parameters()})
    t0 = time.perf_counter()
    cpu_terms, cpu_grads = run(model, batch)
    seconds = time.perf_counter() - t0
    reset_counts()
    gpu_terms, gpu_grads = run(copy.deepcopy(model).cuda(),
                               _to_device(batch, torch.device("cuda")))
    counts = read_counts()
    if counts["composed_attention_train"] != 1 or \
            counts["composed_attention_backward"] != 1:
        raise AssertionError(f"card train step launches {counts}")
    log(f"train step on the CPU ({seconds:.1f} s) and the card: loss terms "
        f"{cpu_terms} / {gpu_terms}")
    worst = 0.0
    for k, g in cpu_grads.items():
        if not (torch.isfinite(g).all() and torch.isfinite(
                gpu_grads[k]).all()):
            raise AssertionError(f"non-finite gradient {k}")
        scale = g.abs().max().item()
        err = (gpu_grads[k] - g).abs().max().item()
        worst = max(worst, err / max(scale, 1e-12))
        if err > TRAIN_GRAD_TOL * scale + 1e-6:
            raise AssertionError(f"gradient {k}: max |card - CPU| {err}, "
                                 f"max |CPU| {scale}")
    for name, v in cpu_terms.items():
        if abs(gpu_terms[name] - v) > TRAIN_LOSS_RTOL * abs(v):
            raise AssertionError(f"loss {name}: card {gpu_terms[name]}, "
                                 f"CPU {v}")
    log(f"train step card vs CPU: worst gradient leaf max |diff| / max |g| "
        f"= {worst}")
    return worst


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


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", default=None,
                        help="root of another checkout whose role-attention "
                             "kernel phase 2 times in turns with this one")
    args = parser.parse_args(argv)
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
    for name in build.KERNELS:   # a clean build, so that every log prints
        build.library_path(name).unlink(missing_ok=True)
    logs = build.build(verbose=True)
    log(f"built {sorted(build.KERNELS)} in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"{name}: {line.strip()}")
    fwd_code = forward_code(logs["composed_attn"])
    bwd_code = backward_code(logs["composed_attn_bwd"])
    role = check_role_attention(args.parent)
    role["code"] = role_code(logs["role_attn"])

    kernels = [role] + check_composed_attention()
    for k in kernels:
        tag = k["name"].rsplit("_", 1)[1]
        if k["name"] == "role_attention":
            continue
        if k["name"].startswith("composed_attention_backward_"):
            k["code"] = {p: bwd_code[f"{p}_{tag}"] for p in ("dq", "dkv")}
        elif k["name"].startswith("composed_attention_dropout_"):
            k["code"] = fwd_code[f"{tag}_train"]
        elif k["name"].startswith("composed_attention_"):
            k["code"] = fwd_code[f"{tag}_inference"]
    by_path = {"exp2_vidvrd": drive_exp2()}
    by_path["vidor_two_stage"], vidor = drive_vidor()
    by_path["grounding_train_step"], train = drive_train_step(card)
    by_path["train_vidor"], _ = drive_train_entry(card)
    by_path["bigc_train_step"], bigc_train = drive_bigc_train_step(card)
    by_path["train_vidvrd"], ckpts = drive_train_vidvrd(card)
    by_path["eval_trained_checkpoint"] = serve_trained(card, ckpts)
    # role attention runs in float32 under both compute dtypes; each
    # composed row counts the launches of its dtype's runs
    rows_of = {"role_attention": ("role_attention", ("float32", "bfloat16"))}
    for wrapper, row in (("composed_attention", "composed_attention"),
                         ("composed_attention_train",
                          "composed_attention_dropout"),
                         ("composed_attention_backward",
                          "composed_attention_backward")):
        rows_of[row + "_f32"] = (wrapper, ("float32",))
        rows_of[row + "_bf16"] = (wrapper, ("bfloat16",))
    for k in kernels:
        wrapper, dtypes = rows_of[k["name"]]
        k["launches_by_path"] = {
            p: sum(c[d][wrapper] for d in dtypes)
            for p, c in by_path.items()}
        k["launches"] = sum(k["launches_by_path"].values())
        if k["launches"] == 0:
            raise AssertionError(f"{k['name']}: no launch on any path")
    check_outputs(card)
    check_train_parity()
    check_bigc_train_parity()
    ms_per_video = check_grounding(card)
    for dtype, res in vidor.items():
        seconds = res["stage_a_seconds"] + res["stage_b_seconds"]
        log(f"two-stage VidOR {dtype}: {res['n_videos']} videos in "
            f"{seconds} s of forward + decode = {res['n_videos'] / seconds} "
            f"videos/s (stage A {res['stage_a_seconds']} s, stage B "
            f"{res['stage_b_seconds']} s); grounding at B={G_B} Q={G_Q} "
            f"T={G_T}: {ms_per_video[dtype]} ms/video; {card}")
    for dtype, res in train.items():
        log(f"grounding training {dtype}: {res['ms_per_step']} ms/step, "
            f"{res['videos_per_s']} videos/s at B={TR_B} P={TR_P} T={G_T}, "
            f"peak {res['peak_bytes'] / 2 ** 30:.2f} GiB; {card}")
    for dtype, res in bigc_train.items():
        log(f"BIG-C training {dtype}: {res['ms_per_step']} ms/step, "
            f"{res['videos_per_s']} videos/s at exp2 B={BATCH} N=50 T=256, "
            f"peak {res['peak_bytes'] / 2 ** 30:.2f} GiB, matching on the "
            f"host {res['matching_host_ms']} ms a step; {card}")

    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
