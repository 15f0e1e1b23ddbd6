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
     and with ``--parent CHECKOUT`` against that checkout's kernel (and
     its wrapper's host ms a call) in turns; its three instances'
     registers, spills and TF32 HMMA; composed attention: the inference
     forward at T in {128, 512} x R in {4, 64, 1024} and (R in {4, 64},
     T=1024), the train forward (dropout 0 and 0.1) and the backward at T
     in {128, 512} x R in {4, 64, 1024} and (R=64, T=1024), float32 and
     bfloat16, masked keys and a fully masked
     row; the dropout keep-mask read out of the kernel exactly and its
     realized rate; the backward called twice on the same inputs gives the
     same bits; timed at R=1024, T=512 beside PyTorch's SDPA (forward;
     forward + backward minus forward, at dropout 0 and 0.1); the
     forward's four instances' and the backward kernels' registers and
     spills (ptxas) and their tensor-core instructions (cuobjdump: wgmma in
     bf16, TF32 mma in f32); the grounding conv kernel (dwsep_conv, the
     depthwise-separable conv with its ReLU, residual and mask) at the
     serving cell's shapes, timed beside its bound and the parent's ATen
     route, its twelve instances' registers and TF32 mma;
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
        at (Q, T=512) with Q reaching 256 or more (27 conv-kernel launches
        a float32 stage-B forward, none in bfloat16);
     c. the grounding train step (build_grounding_train_step) at bench.py's
        train geometry, B=8 videos x P=64 predicate slots x T=512 clips
        (R = B x 2P = 1024 rows in the combined encoder), dropout 0.1:
        ms/step, videos/s and peak memory, one composed forward and one
        backward launch per step, no conv-kernel launch (a gradient is
        recorded: the convs keep ATen's route);
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
     g. the bfloat16 checkpoint of f served through eval_vidvrd --ckpt_path
        (8 videos, one batch: six role-attention launches; phase 3s serves
        the float32 one);
     c-f each in float32 and in bfloat16;
     h. exp2's int8 serving path through eval_vidvrd --feat_dtype int8
        (16 videos at batch 8, float32 compute: six role-attention
        launches a forward);
     i. VidOR classification training, BIG-C v7 on exp4: the train step
        (build_train_step at t_abs=4096, dropout 0.1) on 4 full-size videos
        at (N=64, T=4096) (ms/step, videos/s, peak memory), then the
        train_vidor entry point on 4 full-size videos at batch 4,
        uninterrupted and stopped after a step then resumed, whose losses
        must be bit-equal;
     j. the checkpoints of i through eval_vidor --ckpt_path, stage A (four
        role-attention launches a forward) then grounding (composed
        forward launches);
     k. Base-C training on exp6, as i (build_basec_train_step);
     l. the checkpoints of k through eval_vidor --use_baseline on exp6
        rt200 then grounding (composed forward launches, the Q buckets
        reached), and the float32 one on exp6's config_.py (every triplet)
        through stage A alone: unique triplets per video and the Q bucket
        stage B would need;
     i-l each in float32 and in bfloat16;
     m. the on-disk route: splits written in the reference layout under
        build/chip_smoke/disk with the port's synthetic_raw (exp2 pku_i3d:
        8 train + 4 test videos at bench.py's full-size recipe; VidOR: 4
        train videos with their clip features + 4 val videos at the
        full-size recipe) and copies of the configs pointing at them, read
        by the entry points without --synthetic; train_vidvrd on exp2's
        train split, float32, batch 8, 2 epochs, with an 8 GB device cache
        (epoch 1 from it) and without, the losses bit-equal; the parse,
        .npz write and .npz load seconds a video, pack seconds and H2D ms,
        GB and GB/s a batch, step ms, videos/s per epoch, peak memory;
     n. eval_vidvrd on exp2's test split, cold (parse) then warm (.npz
        cache): six role-attention launches a forward, videos/s beside
        3a's in-memory rate; the first batch staged and shipped to the
        card equal to the CPU's numpy packing of the same files; the warm
        run also scores the zero-shot setting against the train split and
        saves its predictions and triplets (--zeroshot --save_json_results
        --save_infer_result --save_tag smoke);
     o. train_vidor's cls mode (exp4) on the VidOR train split, batch 4:
        bfloat16 over 2 epochs, the default 4 GB device cache completes and
        the losses are bit-equal with and without it; float32 over 1 epoch,
        a 1 GB cache goes over its budget and frees its records (memory
        allocated at the end within 128 MiB of the run without it);
     p. eval_vidor on the VidOR val split: stage A's role attention, stage
        B's composed forward on the clip features read from disk, with the
        zero-shot setting, its hit infos and predictions saved
        (--save_hit_infos --zeroshot --save_json_results --save_tag
        smoke);
     q. train_vidor --train_grounding on the train split's clip features,
        bfloat16, one epoch: the composed train forward and backward;
     r. multi-GPU (run before m): at world size 1 (NCCL) train_vidvrd
        --mesh 1,1 (exp2 f32, 16 videos at batch 8),
        train_vidor --train_grounding --data_parallel (bf16, batch 8),
        eval_vidvrd --mesh 1 and eval_vidor --data_parallel, each bit-equal
        to the same run without the flag (f, d, a, b), with the gradient
        bytes reduced (none with one data rank); e's step with a 1 x 1
        mesh and without, in turns, and the coalesced all-reduce that more
        data ranks take alone; then tools/dryrun_multichip's four
        phases (BIG-C train step and inference, grounding train step and
        inference) at full widths on 2 and 4 gloo ranks sharing this card
        (1-D and 2 x 2 data x model), each held against one process on the
        card at the CPU tests' tolerances (the train steps' gradients too,
        their max-pool picks and ReLU signs routed as the one process's
        and their own held to be ties), their launches counted;
     s. the evaluation and data tools on n's and p's files, before the
        splits are removed: eval_vidvrd --json_results_path re-scores n's
        saved predictions to n's metrics with no kernel launch;
        eval_fraction_recall on p's hit infos, eval_traj_mAP,
        prepare_gts_for_eval, cvt_results on p's predictions and
        dataloader_demo --device cuda on the VidOR val split, their counts
        held and their values finite in [0, 1]; convert_checkpoint of f's
        float32 checkpoint saved as a reference-named .pth (DataParallel
        prefixes), then eval_vidvrd on the converted directory: the
        predictions of serving the .pth, six role-attention launches a
        forward; p's grounding weights as a .pth, converted and served by
        eval_vidor from the directory: p's predictions, stage A's role
        attention and stage B's composed forward; each tool's host
        seconds;
     t. the segment baseline at the reference's widths (11,070 features,
        35 / 132 classes, k 20 / 200): the synthetic store written under
        build/chip_smoke/segments, tools/segment_baseline --train --detect
        on the card (SEG_MAX_ITER iterations), its detect on the CPU from
        the same weights file (equal relations, scores within 1e-5, equal
        metrics); the store's GB and write seconds, ms a train iteration,
        predict_segment_pairs' device ms at the largest pair bucket, the
        association's host seconds and the metrics; no kernel launch;
     u. export and serving: tools/export_model --device cuda of exp2
        (bigc_vidvrd, B=8, N=50, T=256) in float32 and bfloat16 and of
        grounding_weights (float32) at stage B's geometry (B=4, Q=256,
        T=512); each artifact reloaded through utils/serving.load_exported
        and run on a's batch and phase 4's stage-B batch: equal to the
        live infer step (integer leaves exactly, floats within 1e-6), the
        role-attention (6), composed-forward and conv-kernel (27 in the
        grounding artifact) launches counted while it runs; export
        seconds, artifact MB, videos/s of the artifact beside the live
        step's; visualisation has no device path and is not run;
  4. checks of the output: one exp2 batch's pred_logits/att and one
     stage-B batch's regrs/conf/cls (B=4, Q=256, T=512) on the card
     against the port's CPU run on the same weights (float32); one exp2
     batch packed int8: the first layer's int32 accumulator exactly equal
     to the CPU's, the outputs against the CPU's and the card's int8
     logits against its float32 ones, and two faults (TF32, a wrong
     scale) that these limits must see; one train step's loss and gradients
     (R=64, T=512, dropout 0) on the card against the CPU; one BIG-C train
     step (2 full-size videos, dropout 0) and one Base-C train step (2
     full-size videos) on the card against the CPU: equal assignments or
     label maps, the loss terms and the gradients (Base-C's with the
     card's ReLU signs held to the CPU's); the steady-state exp2
     videos/s (float32, bfloat16, int8 features), the grounding inference
     ms/video at that geometry and the two-stage videos/s;
  5. a {"kernels": [...]} line, then the {"ok": true, ...} line.
"""
import argparse
import copy
import dataclasses
import json
import math
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

EXP2_CFG = "experiments/exp2/config_.py"
EXP4_CFG = "experiments/exp4/config_.py"
GRD_CFG = "experiments/grounding_weights/config_.py"
EXP6_CFG = "experiments/exp6/config_.py"
EXP6_RT200_CFG = "experiments/exp6/config_rt200.py"
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
# the VidOR classification entry points (exp4 BIG-C v7, exp6 Base-C): 4
# full-size synthetic videos at the configs' batch 4, one epoch (two
# batches: three videos fall in the T=4096 bucket, one in T=2048); the
# train step timed over CLS_STEPS steps after TRAIN_WARMUP
CLS_VIDEOS, CLS_BATCH, CLS_STEPS = 4, 4, 5
# Base-C card vs CPU: 2 full-size videos in one (N=64, T=2048) batch
BASEC_PARITY_SEEDS = (3, 4)
# ... and its encoder time max-pool: at most this share of the pool's bins
# may pick another frame on the card than on the CPU, each only where the
# CPU's values at the two picks lie within this much of the pool input's
# largest magnitude (a tie within the devices' rounding)
MAXPOOL_FLIP_SHARE = 1e-4
MAXPOOL_TIE_RTOL = 1e-5
# ... and its ReLUs: at most this share of a ReLU's inputs may change sign
# between the CPU and the card, each within this much of the input's
# largest magnitude
RELU_FLIP_SHARE = 1e-4
RELU_TIE_RTOL = 1e-5
# int8 exp2 serving: the share of queries whose subject and object agree
# between the card's int8 and float32 runs, below which the JAX test's
# criterion on them does not count
INT8_AGREE_FLOOR = 0.9


T_START = time.perf_counter()


def log(msg):
    """A line of the run's log, with the seconds since the script started
    (where each phase's time goes)."""
    print(f"[chip_smoke {time.perf_counter() - T_START:7.1f} s] {msg}",
          flush=True)


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
    from vidsgg_big_tpu_torch.ops.dwsep_conv import dwsep_conv
    from vidsgg_big_tpu_torch.ops.role_attn import role_attention
    return {"role_attention": role_attention,
            "composed_attention": composed_attention,
            "composed_attention_train": composed_attention_train,
            "composed_attention_backward": composed_attention_backward,
            "dwsep_conv": dwsep_conv}


def reset_counts():
    for fn in kernel_counters().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in kernel_counters().items()}


def in_turns(fns, iters=None):
    """{name: min ms} of each function, timed plain / kernel / kernel /
    plain style: every name twice, in the order given and then reversed;
    ``iters`` maps a name to its calls a turn (5 where unnamed: the plain
    versions of a second a call take 1)."""
    iters = iters or {}
    times = {name: [] for name in fns}
    for name in list(fns) + list(fns)[::-1]:
        times[name].append(cuda_ms(fns[name], iters=iters.get(name, 5),
                                   warmup=1))
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
            "call_ms_turns": [
                turns.wall_ms(lambda: role_attention(*args, DIM_ENTI))
                for _ in range(3)],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "parent_device_ms": None}
        shapes[name]["call_ms"] = min(shapes[name]["call_ms_turns"])
        log(f"role_attention {name} (B={b}, N={n}) on the device alone "
            f"(CUDA graph of {turns.CALLS} calls, ms a call, both turns): "
            f"kernel {times['kernel']}, plain {times['plain']}; wrapper "
            f"wall {shapes[name]['call_ms_turns']} ms a call (three "
            f"readings of 100 calls); bound {bound_ms} "
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
        # the wrappers' host ms a call, each checkout's in fresh processes
        wrapper = turns.wrapper_turns([parent])
        for name in shapes:
            shapes[name]["parent_call_ms"] = min(wrapper[parent][name])
            shapes[name]["call_ms_beside_parent"] = min(
                wrapper["this"][name])
            log(f"role_attention wrapper {name}, host ms a call in turns A "
                f"B B A with {parent}: parent {wrapper[parent][name]}, this "
                f"{wrapper['this'][name]}")
    exp2 = shapes[turns.SHAPES[0][0]]
    return {"name": "role_attention", "route": "cuda",
            "source": "vidsgg_big_tpu_torch/csrc/role_attn.cu",
            "replaces": "vidsgg_big_tpu/ops/pallas_role_attn.py:27",
            "max_abs_err": max_err, "ms": exp2["device_ms"],
            "plain_ms": exp2["plain_device_ms"],
            "bound_ms": exp2["bound_ms"], "bound_by": exp2["bound_by"],
            "library_ms": None, "device_ms": exp2["device_ms"],
            "call_ms": exp2["call_ms"],
            "parent_call_ms": exp2.get("parent_call_ms"),
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
    # the forward's shapes are the backward's: R=1024 up to T=512 (stage B's
    # combined encoder), T=1024 at R up to 64 (R=1024 at T=1024, which no
    # main path reaches, took 20 s a dtype in the plain version)
    shapes = ((4, 128), (64, 128), (1024, 128), (4, 512), (64, 512),
              (1024, 512), (4, 1024), (64, 1024))
    for dtype in (torch.float32, torch.bfloat16):
        for r, t in shapes:
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
                dropout_p=DROPOUT).sum(1)}, iters={"plain": 1})
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
            "library_fwd_drop": lambda: sdpa_fwd(DROPOUT)},
            iters={"plain": 1})
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


# the grounding convs at the serving cell's shapes (B=4 x Q=256 rows of T=512
# clips, 128 channels): (label, Co, k, ReLU, residual, mask) of the QANet
# convs, the head blocks and the heads' final convs
DWSEP_CELL = (("qanet_k7", 128, 7, True, True, True),
              ("head_k3", 128, 3, True, False, True),
              ("head_out_20", 20, 3, False, False, False),
              ("head_out_10", 10, 3, False, False, False))
DWSEP_TOL = dict(rtol=1e-4, atol=1e-4)
# the conv kernel's launches in a float32 grounding forward at C=128: the
# video, query and combined encoders' 4 each, the three heads' 5 each
GROUNDING_CONVS = 27


def dwsep_inputs(r, t, co, k, residual, masked, seed):
    """x (r, t, 128), the conv's weights, a residual (r, t, co) or None and
    a mask with a fully masked last row or None, on the card."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(r, t, 128, generator=g)
    weights = [torch.randn(shape, generator=g) * 0.3 for shape in (
        (128, 1, k), (128,), (co, 128, 1), (co,))]
    res = torch.randn(r, t, co, generator=g) if residual else None
    mask = None
    if masked:
        mask = torch.rand(r, t, generator=g) < 0.7
        mask[-1] = False
    return [None if a is None else a.cuda() for a in [x, *weights, res,
                                                      mask]]


def dwsep_bound(x, dw, db, pw, pb, res, mask):
    """(bound ms, what bounds it) of one call: x, the weights, the residual
    and the mask read once, y written once; the depthwise taps and the
    pointwise product at the float32 peak (f32_ops_seconds)."""
    r, t, c = x.shape
    co, k = pw.shape[0], dw.shape[-1]
    nbytes = 4 * (x.numel() + r * t * co + sum(a.numel() for a in (
        dw, db, pw, pb))) + (0 if res is None else 4 * res.numel()) + (
        0 if mask is None else mask.numel())
    t_ops = f32_ops_seconds(2.0 * r * t * c * (k + co))
    t_bytes = nbytes / PEAK_BYTES_S
    return 1e3 * max(t_bytes, t_ops), (
        "bytes" if t_bytes >= t_ops else "operations")


def check_dwsep_conv():
    """Phase 2: the grounding conv kernel (csrc/dwsep_conv.cu) vs its plain
    version at the serving cell's shapes (DWSEP_CELL), timed there beside
    its bound and the parent's ATen route (transposes, two convs, the
    epilogue's passes; the plain version is its values made contiguous, so
    it is timed once and reported as plain_ms and library_ms), the better
    of two turns.  The edge shapes, float64 exactness, masked rows and
    repeated launches are the card tests' (``pytest --noconftest -m gpu
    tests/test_torch_dwsep_conv.py``)."""
    from vidsgg_big_tpu_torch.ops.dwsep_conv import (
        dwsep_conv, dwsep_conv_aten, dwsep_conv_plain)
    max_err = 0.0
    shapes = {}
    for i, (label, co, k, relu, res, masked) in enumerate(DWSEP_CELL):
        args = dwsep_inputs(G_B * G_Q, G_T, co, k, res, masked, seed=i)
        x, dw, db, pw, pb, rt, mask = args
        out = dwsep_conv(x, dw, db, pw, pb, relu, rt, mask)
        want = dwsep_conv_plain(x, dw, db, pw, pb, relu, rt, mask)
        torch.testing.assert_close(out, want, **DWSEP_TOL)
        err = (out - want).abs().max().item()
        max_err = max(max_err, err)
        del out, want
        best = in_turns({
            "kernel": lambda: dwsep_conv(x, dw, db, pw, pb, relu, rt, mask),
            "library": lambda: dwsep_conv_aten(x, dw, db, pw, pb, relu, rt,
                                               mask)},
            iters={"kernel": 20, "library": 5})
        bound_ms, bound_by = dwsep_bound(*args)
        shapes[label] = {"ms": best["kernel"], "plain_ms": best["library"],
                         "library_ms": best["library"], "bound_ms": bound_ms,
                         "bound_by": bound_by}
        log(f"dwsep_conv {label} R={G_B * G_Q} T={G_T} Co={co} k={k}: "
            f"max |kernel - plain| = {err}; kernel {best['kernel']} ms, "
            f"ATen route {best['library']} ms, bound {bound_ms} ms "
            f"({bound_by})")
        del args, x, rt, mask
        torch.cuda.empty_cache()
    first = shapes[DWSEP_CELL[0][0]]
    return {"name": "dwsep_conv_f32", "route": "cuda",
            "source": "vidsgg_big_tpu_torch/csrc/dwsep_conv.cu",
            "replaces": "none (XLA's convs in the JAX package)",
            "max_abs_err": max_err, "ms": first["ms"],
            "plain_ms": first["plain_ms"],
            "library_ms": first["library_ms"],
            "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
            "shapes": shapes}


def dwsep_code(ptxas_log):
    """kernel_code of the conv kernel's twelve instances, by the n8 tiles
    of a warp (1, 2, 4) and the depthwise halo (0-3)."""
    return kernel_code(ptxas_log, "dwsep_conv",
                       {f"f32_nj{nj}_halo{h}":
                        f"dwsep_conv_kernelILi{nj}ELi{h}E"
                        for nj in (1, 2, 4) for h in range(4)},
                       "dwsep conv")


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
    the launch counts of each run, {dtype: {kernel: launches}}, and each
    run's result."""
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
    return per_run, results


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
        convs = GROUNDING_CONVS * len(res["stage_b_batches"]) \
            if name == "float32" else 0
        if got["dwsep_conv"] != convs:
            raise AssertionError(
                f"{name}: {got['dwsep_conv']} dwsep_conv launches over "
                f"{len(res['stage_b_batches'])} stage-B batches, expected "
                f"{convs}")
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
                counts["composed_attention"] != 0 or \
                counts["dwsep_conv"] != 0:
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


def stop_and_resume(what, main, base, out, card, steps=None):
    """A trainer entry point ``main`` on the arguments ``base`` three times
    under ``out``: uninterrupted (``out/full``), and stopped after one step
    as on SIGTERM then resumed from its checkpoint (``out/resumed``).
    Fails unless the uninterrupted run takes ``steps`` steps (at least 2
    where None) with a finite journal, the resumed run's journal equals it
    bit for bit, and training launched no kernel.  Returns (kernel
    launches, the uninterrupted run's summary)."""
    shutil.rmtree(out, ignore_errors=True)
    reset_counts()
    t0 = time.perf_counter()
    full = main(base + ["--output_dir", out + "/full"])
    first = main(base + ["--output_dir", out + "/resumed",
                         "--stop_after_batches", "1"])
    second = main(base + ["--output_dir", out + "/resumed",
                          "--from_checkpoint"])
    seconds = time.perf_counter() - t0
    counts = read_counts()
    journals = {}
    for run in ("full", "resumed"):
        with open(os.path.join(out, run, "logfile", "metrics.jsonl")) as f:
            journals[run] = {r["step"]: r["value"]
                             for r in map(json.loads, f)
                             if r["tag"] == "loss/total"}
    log(f"{what}: uninterrupted losses {journals['full']}; stopped at step "
        f"{first['step']}, resumed to {second['step']}: losses "
        f"{journals['resumed']}; peak memory "
        f"{full['max_memory_allocated'] / 2 ** 30:.2f} / "
        f"{first['max_memory_allocated'] / 2 ** 30:.2f} / "
        f"{second['max_memory_allocated'] / 2 ** 30:.2f} GiB; "
        f"{seconds:.1f} s for the three runs; launches {counts} on {card}")
    n = full["step"]
    if (steps is not None and n != steps) or n < 2 or (
            first["step"], second["step"]) != (1, n):
        raise AssertionError(f"{what}: steps {n}, {first['step']}, "
                             f"{second['step']}")
    if sorted(journals["full"]) != list(range(1, n + 1)) or not all(
            math.isfinite(v) for v in journals["full"].values()):
        raise AssertionError(f"{what}: journal {journals['full']}")
    if journals["resumed"] != journals["full"]:
        raise AssertionError(f"{what}: the resumed run's losses "
                             f"{journals['resumed']} differ from the "
                             f"uninterrupted run's {journals['full']}")
    if any(counts.values()):
        raise AssertionError(f"{what}: kernel launches {counts} in training")
    return counts, full


def drive_train_vidvrd(card):
    """Phase 3f: the train_vidvrd entry point on exp2, 16 full-size videos
    at batch 8 (two steps), float32 then bfloat16: one uninterrupted run,
    and one stopped after a step as on SIGTERM and resumed from its
    checkpoint; the resumed run's journal must equal the uninterrupted
    one's bit for bit.  Returns ({dtype: {kernel: launches}}, {dtype:
    checkpoint directory})."""
    from vidsgg_big_tpu_torch.tools import train_vidvrd
    per_run, ckpts = {}, {}
    for dtype in ("float32", "bfloat16"):
        base = ["--cfg_path", EXP2_CFG, "--synthetic",
                str(BIGC_ENTRY_VIDEOS), "--synthetic_model_dims",
                "--batch_size", str(BATCH), "--epochs", "1",
                "--compute_dtype", dtype, "--device", "cuda"]
        per_run[dtype], full = stop_and_resume(
            f"train_vidvrd {dtype} batch {BATCH}", train_vidvrd.main, base,
            os.path.join(OUT_DIR, f"train_vidvrd_{dtype}"), card,
            steps=BIGC_ENTRY_VIDEOS // BATCH)
        ckpts[dtype] = full["ckpt_dir"]
    return per_run, ckpts


def serve_trained(card, ckpts):
    """Phase 3g: the bfloat16-trained checkpoint served through
    eval_vidvrd --ckpt_path in bfloat16, 8 full-size videos in one batch
    (phase 3s serves the float32 one, as a reference .pth and converted).
    Returns {dtype: {kernel: launches}}."""
    from vidsgg_big_tpu_torch.tools import eval_vidvrd
    from vidsgg_big_tpu_torch.utils.config import parse_config_py
    n_deco = parse_config_py(EXP2_CFG)["model_config"]["n_deco_layers"]
    per_run = {}
    for dtype, ckpt in ckpts.items():
        if dtype == "float32":
            continue
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


def drive_exp2_int8():
    """Phase 3h: exp2's int8 serving path, eval_vidvrd --feat_dtype int8
    (features packed int8 with a scale per video, the first visual layer an
    int8 product; float32 compute): 16 full-size videos at batch 8.
    Returns {"int8": {kernel: launches}}."""
    from vidsgg_big_tpu_torch.tools import eval_vidvrd
    from vidsgg_big_tpu_torch.utils.config import parse_config_py
    n_deco = parse_config_py(EXP2_CFG)["model_config"]["n_deco_layers"]
    reset_counts()
    res = eval_vidvrd.main([
        "--cfg_path", EXP2_CFG, "--synthetic", str(N_VIDEOS),
        "--synthetic_model_dims", "--batch_size", str(BATCH),
        "--feat_dtype", "int8", "--device", "cuda", "--output_dir", OUT_DIR,
        "--metrics_json", os.path.join(OUT_DIR, "metrics_int8.json")])
    counts = read_counts()
    log(f"eval_vidvrd int8: {json.dumps(res)}; launches {counts}")
    if res["n_videos"] != N_VIDEOS or res["n_relations"] == 0 or \
            not math.isfinite(res["mAP"]):
        raise AssertionError(f"int8: {res['n_videos']} videos, "
                             f"{res['n_relations']} relations, mAP "
                             f"{res['mAP']}")
    if counts["role_attention"] != n_deco * res["n_batches"]:
        raise AssertionError(
            f"int8: {counts['role_attention']} role-attention launches for "
            f"{res['n_batches']} forwards, expected {n_deco} each")
    return {"int8": counts}


def vidor_train_parts(baseline, dtype, **overrides):
    """The exp4 BIG-C v7 (or exp6 Base-C) model, random weights from the
    entry points' seed, its config and train config, on the CPU."""
    from vidsgg_big_tpu_torch.models.base_c import BaseCConfig
    from vidsgg_big_tpu_torch.models.big_c import BigCConfig
    from vidsgg_big_tpu_torch.tools import eval_vidor, eval_vidvrd
    from vidsgg_big_tpu_torch.utils.config import parse_config_py
    cfgs = parse_config_py(EXP6_CFG if baseline else EXP4_CFG)
    mc = dict(cfgs["model_config"], compute_dtype=dtype)
    if baseline:
        cfg = dataclasses.replace(BaseCConfig.from_dict(mc), **overrides)
        return eval_vidor.build_basec_model(cfg, mc), cfg, cfgs[
            "train_config"]
    cfg = dataclasses.replace(BigCConfig.from_dict(mc, variant="v7"),
                              **overrides)
    return eval_vidvrd.build_model(cfg, mc), cfg, cfgs["train_config"]


def time_vidor_step(baseline, dtype):
    """The train step of the VidOR classification trainer (build_train_step
    of BIG-C v7 at t_abs=4096, dropout 0.1, or build_basec_train_step) on
    one batch of 4 full-size videos at (N=64, T=4096) with their GT, in the
    wire dtype of the entry point: (ms/step, peak bytes, loss)."""
    from vidsgg_big_tpu_torch.data.transfer import wire_dtype
    from vidsgg_big_tpu_torch.tools.profile_infer import stage_a_batch
    from vidsgg_big_tpu_torch.tools.train_vidor import T_ABS
    from vidsgg_big_tpu_torch.train.loop import step_generator
    from vidsgg_big_tpu_torch.train.steps import (build_basec_train_step,
                                                  build_train_step)
    from vidsgg_big_tpu_torch.train.train_state import TrainState
    model, cfg, tc = vidor_train_parts(baseline, dtype)
    model = model.cuda()
    state = TrainState(model, tc["initial_lr"], tc["lr_decay"], [10_000])
    build = build_basec_train_step if baseline else build_train_step
    step = build(model, state, t_abs=T_ABS)
    batch = stage_a_batch(cfg, "cuda", wire_dtype(None, dtype))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(TRAIN_WARMUP):
        step(*batch, generator=step_generator(1, i))["total"].item()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(CLS_STEPS):
        metrics = step(*batch, generator=step_generator(1, TRAIN_WARMUP + i))
    loss = metrics["total"].item()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / CLS_STEPS
    peak = torch.cuda.max_memory_allocated()
    del model, state, step, batch
    torch.cuda.empty_cache()
    return ms, peak, loss


def drive_vidor_training(card, baseline):
    """Phases 3i (BIG-C v7 on exp4) and 3k (Base-C on exp6, with
    ``baseline``): the train step timed on one full-size batch, then the
    train_vidor entry point on CLS_VIDEOS full-size videos at batch
    CLS_BATCH, one epoch, uninterrupted and stopped after a step then
    resumed, whose losses must equal the uninterrupted run's bit for bit;
    float32 then bfloat16.  Returns ({dtype: {kernel: launches}}, {dtype:
    checkpoint directory}, {dtype: result})."""
    from vidsgg_big_tpu_torch.tools import train_vidor
    tag = "base" if baseline else "cls"
    per_run, ckpts, results = {}, {}, {}
    for dtype in ("float32", "bfloat16"):
        ms, peak, loss = time_vidor_step(baseline, dtype)
        log(f"VidOR {tag} train step {dtype} B={CLS_BATCH} N=64 T=4096: "
            f"{ms} ms/step = {CLS_BATCH * 1e3 / ms} videos/s, peak memory "
            f"{peak / 2 ** 30:.2f} GiB, loss {loss} on {card}")
        if not math.isfinite(loss):
            raise AssertionError(f"{tag} {dtype}: train loss {loss}")
        base = (["--train_baseline"] if baseline else []) + [
            "--cfg_path", EXP6_CFG if baseline else EXP4_CFG,
            "--synthetic", str(CLS_VIDEOS), "--synthetic_model_dims",
            "--batch_size", str(CLS_BATCH), "--epochs", "1",
            "--compute_dtype", dtype, "--device", "cuda"]
        counts, full = stop_and_resume(
            f"train_vidor {tag} {dtype} batch {CLS_BATCH}", train_vidor.main,
            base, os.path.join(OUT_DIR, f"train_vidor_{tag}_{dtype}"), card)
        per_run[dtype], ckpts[dtype] = counts, full["ckpt_dir"]
        results[dtype] = dict(ms_per_step=ms,
                              videos_per_s=CLS_BATCH * 1e3 / ms,
                              peak_bytes=peak,
                              entry_peak_bytes=full["max_memory_allocated"])
    return per_run, ckpts, results


def serve_vidor_checkpoints(card, ckpts, baseline):
    """Phases 3j and 3l: each dtype's trained checkpoint through eval_vidor
    --ckpt_path at that dtype, stage A then grounding (grounding_weights,
    random weights) on CLS_VIDEOS full-size videos at batch CLS_BATCH: the
    BIG-C v7 checkpoint on exp4 (n_deco_layers role-attention launches a
    stage-A forward), the Base-C one with --use_baseline on exp6 rt200 (no
    role attention); one composed-forward launch per engaged stage-B
    encoder either way.  Base-C's float32 checkpoint also runs exp6's
    config_.py (all triplets) through stage A alone.  Returns {dtype:
    {kernel: launches}}."""
    from vidsgg_big_tpu_torch.data.bucketing import pick_unbounded
    from vidsgg_big_tpu_torch.models.grounding import (GroundingConfig,
                                                       composed_encoders)
    from vidsgg_big_tpu_torch.tools import eval_vidor
    from vidsgg_big_tpu_torch.utils.config import parse_config_py
    gcfg = GroundingConfig.from_dict(parse_config_py(GRD_CFG)[
        "model_config"])
    n_deco = 0 if baseline else parse_config_py(EXP4_CFG)["model_config"][
        "n_deco_layers"]
    tag = "base" if baseline else "cls"
    stage_a = (["--use_baseline", "--cfg_path", EXP6_RT200_CFG]
               if baseline else ["--cfg_path", EXP4_CFG])
    per_run = {}
    for dtype, ckpt in ckpts.items():
        reset_counts()
        t0 = time.perf_counter()
        res = eval_vidor.main(stage_a + [
            "--grounding_cfg_path", GRD_CFG, "--ckpt_path", ckpt,
            "--synthetic", str(CLS_VIDEOS), "--synthetic_model_dims",
            "--batch_size", str(CLS_BATCH), "--compute_dtype", dtype,
            "--feat_dtype", dtype, "--device", "cuda", "--output_dir",
            OUT_DIR, "--metrics_json",
            os.path.join(OUT_DIR, f"metrics_{tag}_trained_{dtype}.json")])
        seconds = time.perf_counter() - t0
        counts = read_counts()
        buckets = sorted({(q, t) for q, t, _ in res["stage_b_batches"]})
        engaged = sum(len(composed_encoders(gcfg, b, q, t))
                      for q, t, b in res["stage_b_batches"])
        log(f"eval_vidor of the {dtype}-trained {tag} checkpoint {ckpt}: "
            f"{json.dumps(res)}; stage-B (Q, T) buckets reached {buckets}; "
            f"{seconds:.1f} s; launches {counts} on {card}")
        device_s = res["stage_a_seconds"] + res["stage_b_seconds"]
        log(f"two-stage VidOR with the trained {tag} checkpoint {dtype}: "
            f"stage A {1e3 * res['stage_a_seconds'] / res['n_videos']} "
            f"ms/video, {res['n_videos'] / device_s} videos/s through both "
            "stages (first calls of the process, forward + decode); "
            f"{card}")
        if counts["role_attention"] != n_deco * res["stage_a_batches"]:
            raise AssertionError(
                f"{tag} {dtype}: {counts['role_attention']} role-attention "
                f"launches for {res['stage_a_batches']} stage-A forwards, "
                f"expected {n_deco} each")
        if engaged == 0 or counts["composed_attention"] != engaged:
            raise AssertionError(
                f"{tag} {dtype}: {counts['composed_attention']} "
                f"composed-attention launches in stage B, where the gate "
                f"engages {engaged} encoders; expected one each, and at "
                "least one")
        if not math.isfinite(res["mAP"]) or res["n_relations"] == 0:
            raise AssertionError(f"{tag} {dtype}: mAP {res['mAP']}, "
                                 f"{res['n_relations']} relations")
        per_run[dtype] = counts
    if baseline:
        reset_counts()
        res = eval_vidor.main([
            "--use_baseline", "--cfg_path", EXP6_CFG, "--ckpt_path",
            ckpts["float32"], "--synthetic", str(CLS_VIDEOS),
            "--synthetic_model_dims", "--batch_size", str(CLS_BATCH),
            "--device", "cuda", "--output_dir", OUT_DIR])
        counts = read_counts()
        trip = res["stage_a_triplets"]
        log(f"eval_vidor Base-C exp6 config_.py (rt_triplets_topk -1), "
            f"stage A alone: unique triplets per video {trip}; stage B "
            f"would need the Q={pick_unbounded(max(trip))} bucket; "
            f"{json.dumps(res)}; launches {counts}")
        if min(trip) == 0 or any(counts.values()):
            raise AssertionError(f"Base-C stage A: triplets {trip}, "
                                 f"launches {counts}")
        per_run["all_triplets_float32"] = counts
    return per_run


# ---- multi-GPU (phase 3r) -------------------------------------------------

# the dry run's gloo ranks sharing the card: a 1-D (2 data) and a 2 x 2
# (data x model) layout
DRYRUN_RANKS = (2, 4)


def add_counts(total, counts):
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def same_journal(what, out, ref):
    """Fail unless the loss journal at ``out`` equals ``ref``'s bit for
    bit."""
    got, want = journal(out, "loss/total"), journal(ref, "loss/total")
    if got != want or len(want) < 2:
        raise AssertionError(f"{what}: losses {got}, without the flag "
                             f"{want}")


def time_sync_path(card):
    """The sync path's cost at world size 1 (NCCL): build_train_step at
    3e's geometry (exp2 f32, B=8, dropout 0.1) with a 1 x 1 mesh and
    without, in turns (plain, mesh, mesh, plain; TRAIN_STEPS after
    TRAIN_WARMUP each; with one data rank the step reduces no gradient,
    ``step_sync_bytes``), and the coalesced gradient all-reduce that D > 1
    data ranks take a step, alone on the whole model's gradients (CUDA
    events).  Returns the readings."""
    from vidsgg_big_tpu_torch.data.synthetic_vidvrd import bench_train_batch
    from vidsgg_big_tpu_torch.parallel.mesh import destroy_mesh, init_mesh
    from vidsgg_big_tpu_torch.train.loop import step_generator
    from vidsgg_big_tpu_torch.train.steps import build_train_step
    from vidsgg_big_tpu_torch.train.train_state import (TrainState,
                                                        all_reduce_coalesced)
    with tempfile.TemporaryDirectory() as tmp:
        mesh = init_mesh(1, 1, "cuda", init_method=f"file://{tmp}/init",
                         rank=0, world_size=1)
        try:
            steps, states = {}, {}
            for name, m in (("plain", None), ("mesh", mesh)):
                model, cfg = bigc_train_parts("float32")
                states[name] = TrainState(model.cuda(), 1e-4, 0.2, [10_000],
                                          mesh=m)
                steps[name] = build_train_step(model, states[name])
            batch = bench_train_batch(cfg, BATCH, "cuda", torch.float32)

            def ms_per_step(step):
                for i in range(TRAIN_WARMUP):
                    step(*batch, generator=step_generator(1, i))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for i in range(TRAIN_STEPS):
                    m = step(*batch, generator=step_generator(1, i))
                m["total"].item()
                return (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS

            times = {"plain": [], "mesh": []}
            for name in ("plain", "mesh", "mesh", "plain"):
                times[name].append(ms_per_step(steps[name]))
            grads = [torch.zeros_like(p) for p in states["mesh"].params]
            sync_bytes = all_reduce_coalesced(grads, mesh.data_group)
            sync_ms = cuda_ms(lambda: all_reduce_coalesced(
                grads, mesh.data_group), iters=20, warmup=3)
        finally:
            destroy_mesh()
    r = dict(ms_per_step=times, sync_ms=sync_ms, grad_sync_bytes=sync_bytes,
             step_sync_bytes=states["mesh"].sync_bytes)
    log(f"exp2 BIG-C train step f32 B={BATCH}, without and with a 1 x 1 "
        f"mesh (NCCL), in turns: {json.dumps(r)}; {card}")
    return r


def same_metrics(what, got, want):
    for key in ("mAP", "recall", "precision", "n_videos", "n_relations"):
        if got[key] != want[key]:
            raise AssertionError(f"{what}: {key} {got[key]}, without the "
                                 f"flag {want[key]}")


def drive_multi_gpu(card, exp2, vidor):
    """Phase 3r: the multi-GPU path.  At world size 1 (NCCL, this card)
    through the four entry points, each against the same run without the
    flag earlier in this script, bit for bit: train_vidvrd --mesh 1,1
    (exp2 f32, 16 videos at batch 8, against 3f; --data_parallel takes
    the same one-rank path there and is run by the next two),
    train_vidor --train_grounding --data_parallel (bf16, 16 videos at batch
    8, against 3d), eval_vidvrd --mesh 1 (against 3a f32) and eval_vidor
    --data_parallel (against 3b f32), the gradient bytes each step reduces;
    the sync path's cost (``time_sync_path``).  Then
    tools/dryrun_multichip at 2 and 4 gloo ranks on this card at full
    widths (exp2 BIG-C, grounding_weights), each phase against one process
    on the card.  Returns ({dtype: {kernel: launches}}, readings)."""
    from vidsgg_big_tpu_torch.tools import (dryrun_multichip, eval_vidor,
                                            eval_vidvrd, train_vidor,
                                            train_vidvrd)
    per_run = {"float32": {}, "bfloat16": {}}
    readings = {}
    root = os.path.join(OUT_DIR, "multi_gpu")
    shutil.rmtree(root, ignore_errors=True)

    def counted(dtype, fn):
        reset_counts()
        out = fn()
        add_counts(per_run[dtype], read_counts())
        return out

    base = ["--cfg_path", EXP2_CFG, "--synthetic", str(BIGC_ENTRY_VIDEOS),
            "--synthetic_model_dims", "--batch_size", str(BATCH),
            "--epochs", "1", "--compute_dtype", "float32", "--device",
            "cuda"]
    ref = os.path.join(OUT_DIR, "train_vidvrd_float32", "full")
    out = os.path.join(root, "train_vidvrd_1,1")
    summary = counted("float32", lambda: train_vidvrd.main(
        base + ["--mesh", "1,1", "--output_dir", out]))
    same_journal("train_vidvrd --mesh 1,1", out, ref)
    log(f"train_vidvrd f32 --mesh 1,1 (world size 1, NCCL): losses "
        f"bit-equal to the run without it; mesh {summary['mesh']}, "
        f"{summary['grad_sync_bytes']} gradient bytes reduced a step")
    run = ENTRY_RUNS["bfloat16"]
    out = os.path.join(root, "train_grounding_data_parallel")
    summary = counted("bfloat16", lambda: train_vidor.main([
        "--train_grounding", "--cfg_path", GRD_CFG, "--synthetic",
        str(run["videos"]), "--synthetic_model_dims", "--batch_size",
        str(run["batch"]), "--epochs", "1", "--compute_dtype", "bfloat16",
        "--device", "cuda", "--data_parallel", "--output_dir", out]))
    same_journal("train_vidor --train_grounding --data_parallel", out,
                 os.path.join(OUT_DIR, "train_vidor_bfloat16"))
    log(f"train_vidor --train_grounding bf16 batch {run['batch']} "
        f"--data_parallel: losses bit-equal to 3d's; mesh {summary['mesh']},"
        f" {summary['grad_sync_bytes']} gradient bytes reduced a step")
    if summary["mesh"] != [1, 1]:
        raise AssertionError(f"--data_parallel on one card: mesh "
                             f"{summary['mesh']}")
    readings["sync_path"] = time_sync_path(card)
    res = counted("float32", lambda: eval_vidvrd.main([
        "--cfg_path", EXP2_CFG, "--synthetic", str(N_VIDEOS),
        "--synthetic_model_dims", "--batch_size", str(BATCH), "--device",
        "cuda", "--output_dir", root, "--mesh", "1"]))
    same_metrics("eval_vidvrd --mesh 1", res, exp2["float32"])
    log(f"eval_vidvrd f32 --mesh 1: metrics equal to 3a's: {json.dumps(res)}")
    res = counted("float32", lambda: eval_vidor.main([
        "--cfg_path", EXP4_CFG, "--grounding_cfg_path", GRD_CFG,
        "--synthetic", str(VIDOR_VIDEOS), "--synthetic_model_dims",
        "--batch_size", str(VIDOR_BATCH), "--topk", str(VIDOR_TOPK),
        "--device", "cuda", "--output_dir", root, "--data_parallel"]))
    same_metrics("eval_vidor --data_parallel", res, vidor["float32"])
    log(f"eval_vidor f32 --data_parallel: metrics equal to 3b's: "
        f"{json.dumps(res)}")
    # the ranks share this card: hand its cached blocks back first
    torch.cuda.empty_cache()
    reference = {}          # both layouts hold the same batch of 2 videos
    for n in DRYRUN_RANKS:
        t0 = time.perf_counter()
        out = dryrun_multichip.dryrun(n, "cuda", "gloo", "full", log=log,
                                      reference=reference)
        seconds = time.perf_counter() - t0
        add_counts(per_run["float32"], out["launches"])
        readings[f"dryrun_multichip {n}"] = r = dict(
            layout=out["layout"], batch=out["batch"], errors=out["errors"],
            launches=out["launches"], seconds=seconds)
        log(f"dryrun_multichip({n}) on one card (gloo): {json.dumps(r)}; "
            f"{card}")
        if not all(out["launches"].values()):
            raise AssertionError(f"dryrun_multichip({n}): a kernel was not "
                                 f"launched: {out['launches']}")
    return per_run, readings


# ---- the on-disk route (phases 3m-3q) -------------------------------------

DISK_DIR = os.path.join(OUT_DIR, "disk")
# the splits written in the reference layout: exp2 (pku_i3d) at bench.py's
# full-size record recipe (46 tracklets of 480-frame videos), VidOR at the
# in-memory phases' full-size recipe (2,400 frames, 46 tracklets, 299
# clips).  VidOR's score_th 0.4 keeps the 12 GT tracklets and about 40% of
# the distractors (N=32 rung), so its float32 records are 0.35-0.69 GB;
# the 4 train videos (8 until phases 3t-3u needed the time) fit the default
# 4 GB device cache in bfloat16 and go past VIDOR_F32_CACHE_GB in float32.
# exp2's 8 train videos make one batch an epoch (16 did until the
# multi-GPU phase needed the time); its 4 test videos (8 until phase 3s
# needed the time) one padded batch
EXP2_DISK_TRAIN, EXP2_DISK_TEST = 8, 4
VIDOR_DISK_TRAIN, VIDOR_DISK_VAL = 4, 4
VIDOR_F32_CACHE_GB = 1.0
# exp2 records on the JAX CLI's default ladder (N=64, T=512) hold 377 MB
# each in float32; phase 3m gives the cache 8 GB
EXP2_DISK_CACHE_GB = 8.0
# the float32 VidOR run whose cache goes over its budget ends with at most
# this much more memory allocated than the run without a cache (a captured
# record is 0.35-0.69 GB)
FREED_SLACK = 128 << 20
# the dataset-config keys that point a config at a written split
SPLIT_KEYS = ("ann_dir", "proposal_dir", "i3d_dir", "classeme_dir",
              "video_feature_dir", "video_dir", "cache_dir", "cache_tag",
              "dim_boxfeature", "dim_i3d", "fmt")


def disk_config(src, name, **splits):
    """A copy of the config ``src`` whose dataset configs (``splits``:
    {"train_dataset_config": synthetic_raw's config, ...}) point at the
    written splits; its thresholds stay the experiment's."""
    with open(src) as f:
        text = f.read()
    text += "\n# the splits chip_smoke.py writes in the reference layout\n"
    for key, cfg in splits.items():
        over = {k: cfg[k] for k in SPLIT_KEYS if k in cfg}
        text += f"{key} = dict({key}, **{over!r})\n"
    path = os.path.join(DISK_DIR, f"config_{name}_.py")
    with open(path, "w") as f:
        f.write(text)
    return path


def write_disk_splits():
    """Phase 3m's first step: the exp2 train and test splits and the VidOR
    train (with clip features) and val splits, written with the port's
    synthetic_raw; returns {name: config path}."""
    from vidsgg_big_tpu_torch.data import synthetic_raw
    from vidsgg_big_tpu_torch.data import synthetic_vidor, synthetic_vidvrd
    from vidsgg_big_tpu_torch.utils.config import parse_config_py
    shutil.rmtree(DISK_DIR, ignore_errors=True)
    os.makedirs(DISK_DIR)
    t0 = time.perf_counter()
    mc = parse_config_py(EXP2_CFG)["model_config"]
    vrd = dict(fmt="pku_i3d", dim_feat=mc["dim_feat"], dim_i3d=mc["dim_i3d"],
               **synthetic_vidvrd.FULL_SIZE_RECIPE)
    root = os.path.join(DISK_DIR, "vidvrd")
    train = synthetic_raw.write_synthetic_vidvrd(root, EXP2_DISK_TRAIN,
                                                 "train", **vrd)
    # another seed than the train split's, so that the test split holds
    # triplets the train split never saw (phase 3s's zero-shot setting)
    test = synthetic_raw.write_synthetic_vidvrd(root, EXP2_DISK_TEST, "test",
                                                seed=1, **vrd)
    t1 = time.perf_counter()
    vor = dict(dim_feat=parse_config_py(EXP4_CFG)["model_config"][
        "dim_feat"], wh=(640, 360), **synthetic_vidor.FULL_SIZE_RECIPE)
    root = os.path.join(DISK_DIR, "vidor")
    vtrain = synthetic_raw.write_synthetic_vidor(root, VIDOR_DISK_TRAIN,
                                                 "train", seed=0, **vor)
    vval = synthetic_raw.write_synthetic_vidor(root, VIDOR_DISK_VAL, "val",
                                               seed=1, **vor)
    t2 = time.perf_counter()
    log(f"wrote the on-disk splits: exp2 {EXP2_DISK_TRAIN} train + "
        f"{EXP2_DISK_TEST} test videos in {t1 - t0:.1f} s, VidOR "
        f"{VIDOR_DISK_TRAIN} train + {VIDOR_DISK_VAL} val videos in "
        f"{t2 - t1:.1f} s; {dir_gb(DISK_DIR):.2f} GB")
    return {"exp2": disk_config(EXP2_CFG, "exp2",
                                train_dataset_config=train,
                                test_dataset_config=test),
            "exp4": disk_config(EXP4_CFG, "exp4",
                                train_dataset_config=vtrain,
                                test_dataset_config=vval),
            "grounding": disk_config(GRD_CFG, "grounding",
                                     train_dataset_config=vtrain,
                                     test_dataset_config=vval)}


def dir_gb(path):
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in
               os.walk(path) for f in fs) / 1e9


def spread(xs):
    """{n, median, min, max} of a list of readings (None if empty)."""
    if not xs:
        return None
    return dict(n=len(xs), median=float(np.median(xs)), min=float(min(xs)),
                max=float(max(xs)))


def journal(out, tag):
    """{step: value} of one tag of a run's metrics journal."""
    with open(os.path.join(out, "logfile", "metrics.jsonl")) as f:
        return {r["step"]: r["value"] for r in map(json.loads, f)
                if r["tag"] == tag}


def pipeline_readings(what, summary, out, card):
    """Log and return a training run's input pipeline readings: parse,
    .npz write and .npz load seconds a video, pack seconds and H2D ms, GB
    and GB/s a batch, the loop's ms a step (the lagged read's clock), each
    epoch's seconds, steps, ms a step and videos/s (a cached epoch's ms a
    step is the step's own time), peak memory."""
    pipe = summary["pipeline"]
    steps = journal(out, "time/epoch_steps")
    per_video = {k: v[0] / v[1] for k, v in pipe.get(
        "dataset_seconds", {}).items() if v[1]}
    h2d = pipe["h2d_ms"]
    gb = [b / 1e9 for b in pipe["h2d_bytes"]]
    r = dict(
        parse_s_per_video=per_video.get("parse"),
        npz_save_s_per_video=per_video.get("save"),
        npz_load_s_per_video=per_video.get("load"),
        pack_s_per_batch=spread(pipe["pack_s"]),
        h2d_ms_per_batch=spread(h2d), h2d_gb_per_batch=spread(gb),
        h2d_gb_s=spread([g * 1e3 / ms for g, ms in zip(gb, h2d) if ms]),
        loop_ms_per_step=spread(list(journal(out,
                                             "time/step_ms").values())),
        epochs=[dict(seconds=sec, steps=int(steps[e]),
                     ms_per_step=sec * 1e3 / steps[e],
                     videos_per_s=summary["n_videos"] / sec)
                for e, sec in sorted(journal(out, "time/epoch_s").items())],
        staging_gib=pipe["staging_bytes"] / 2 ** 30,
        peak_gib=summary["max_memory_allocated"] / 2 ** 30,
        end_allocated_gib=summary["memory_allocated"] / 2 ** 30,
        device_cache=pipe.get("device_cache"))
    log(f"{what}: {json.dumps(r)}; {card}")
    return r


def drive_disk_train_vidvrd(card, cfg):
    """Phase 3m: train_vidvrd on the exp2 train split from disk, float32,
    batch 8, 2 epochs: with the device cache (epoch 0 parses the split,
    writes the .npz cache and fills the device cache; epoch 1 runs from the
    device cache) and without it (both epochs read the .npz cache); the
    per-step losses bit-equal, no kernel launched.  Returns ({"float32":
    launches}, readings)."""
    from vidsgg_big_tpu_torch.tools import train_vidvrd
    base = ["--cfg_path", cfg, "--batch_size", str(BATCH), "--epochs", "2",
            "--compute_dtype", "float32", "--device", "cuda"]
    runs = {"cache_on": ["--device_cache_gb", str(EXP2_DISK_CACHE_GB)],
            "cache_off": ["--device_cache_gb", "0"]}
    reset_counts()
    losses, readings = {}, {}
    for name, extra in runs.items():
        out = os.path.join(DISK_DIR, f"train_vidvrd_{name}")
        t0 = time.perf_counter()
        res = train_vidvrd.main(base + extra + ["--output_dir", out])
        log(f"train_vidvrd exp2 from disk, {name}: {res['step']} steps in "
            f"{time.perf_counter() - t0:.1f} s")
        losses[name] = journal(out, "loss/total")
        readings[name] = pipeline_readings(
            f"train_vidvrd exp2 from disk f32 batch {BATCH}, {name}", res,
            out, card)
    counts = read_counts()
    n = len(losses["cache_on"])
    if sorted(losses["cache_on"]) != list(range(1, n + 1)) or \
            n != 2 * -(-EXP2_DISK_TRAIN // BATCH) or \
            not all(math.isfinite(v) for v in losses["cache_on"].values()):
        raise AssertionError(f"train_vidvrd from disk: {losses}")
    if losses["cache_on"] != losses["cache_off"]:
        raise AssertionError(f"train_vidvrd from disk: losses with the "
                             f"device cache {losses['cache_on']} differ from "
                             f"those without {losses['cache_off']}")
    cache = readings["cache_on"]["device_cache"]
    if not cache["complete"] or cache["first_cached_epoch"] != 1 or \
            cache["videos"] != EXP2_DISK_TRAIN:
        raise AssertionError(f"train_vidvrd from disk: device cache {cache}")
    if any(counts.values()):
        raise AssertionError(f"train_vidvrd from disk: launches {counts}")
    return {"float32": counts}, readings


def check_disk_batch(cfg):
    """Phase 3n's check: the first exp2 test batch packed into a staging
    slot and shipped to the card equals, byte for byte, the batch the CPU
    packs with numpy from the same files, in float32 and bfloat16."""
    from vidsgg_big_tpu_torch.data.bucketing import (BucketSpec,
                                                     bucketed_batches)
    from vidsgg_big_tpu_torch.data.transfer import StagingRing, wire_feats
    from vidsgg_big_tpu_torch.tools.common import (first_feat_dim,
                                                   make_dataset)
    from vidsgg_big_tpu_torch.utils.config import parse_config_py
    ds, _ = make_dataset(parse_config_py(cfg)["test_dataset_config"],
                         "vidvrd")
    records = list(ds)
    feat = first_feat_dim(p for p, _ in records)
    for dtype in ("float32", "bfloat16"):
        spec = BucketSpec(feat_dim=feat, feat_dtype=dtype)
        ring = StagingRing("cuda")
        _, rows, staged, _ = next(iter(bucketed_batches(
            records, spec, BATCH, with_gt=False, staging=ring)))
        on_card = ring.ship(staged)
        _, host_rows, host, _ = next(iter(bucketed_batches(
            records, spec, BATCH, with_gt=False)))
        torch.cuda.synchronize()
        ring.close()
        if [r[0].video_name for r in rows] != \
                [r[0].video_name for r in host_rows]:
            raise AssertionError("the staged and numpy batches hold other "
                                 "videos")
        for f in dataclasses.fields(host):
            want = torch.as_tensor(getattr(host, f.name))
            if f.name == "feats":
                want = wire_feats(want, getattr(torch, dtype))
            got = getattr(on_card, f.name).cpu()
            if got.dtype != want.dtype or not torch.equal(got, want):
                raise AssertionError(f"{dtype} {f.name}: the batch on the "
                                     "card differs from the CPU's packing")
        log(f"exp2 test batch from disk, {dtype}: shipped through the "
            f"staging ring, equal to the CPU's numpy packing in all "
            f"{len(dataclasses.fields(host))} fields "
            f"({tuple(host.feats.shape)} features)")


def drive_disk_eval_vidvrd(card, cfg, in_memory_rate):
    """Phase 3n: eval_vidvrd on the exp2 test split from disk, batch 8,
    float32: cold (parse + .npz write) then warm (.npz cache); six
    role-attention launches a forward; videos/s beside the in-memory
    rate of phase 3a; then check_disk_batch.  Returns {"float32":
    launches}."""
    from vidsgg_big_tpu_torch.tools import eval_vidvrd
    from vidsgg_big_tpu_torch.utils.config import parse_config_py
    n_deco = parse_config_py(EXP2_CFG)["model_config"]["n_deco_layers"]
    total = dict.fromkeys(read_counts(), 0)
    rates = {}
    for run in ("cold", "warm"):
        # phase 3s: the warm run scores the zero-shot setting too and
        # saves what the tools read
        tools = (["--zeroshot", "--save_json_results", "--save_infer_result",
                  "--save_tag", "smoke"] if run == "warm" else [])
        reset_counts()
        t0 = time.perf_counter()
        res = eval_vidvrd.main([
            "--cfg_path", cfg, "--batch_size", str(BATCH), "--device",
            "cuda", "--output_dir", OUT_DIR, "--metrics_json",
            os.path.join(OUT_DIR, f"metrics_disk_{run}.json")] + tools)
        wall = time.perf_counter() - t0
        counts = read_counts()
        rates[run] = res["n_videos"] / wall
        seconds = res["pipeline"]["dataset_seconds"]
        log(f"eval_vidvrd exp2 test split from disk, {run}: "
            f"{json.dumps({k: v for k, v in res.items() if k != 'pipeline'})}"
            f"; {wall:.2f} s = {rates[run]} videos/s; dataset seconds "
            f"{seconds}; pack s a batch {res['pipeline']['pack_s']}, H2D ms "
            f"{res['pipeline']['h2d_ms']}; launches {counts} on {card}")
        if res["n_videos"] != EXP2_DISK_TEST or res["n_relations"] == 0 or \
                not math.isfinite(res["mAP"]):
            raise AssertionError(f"eval from disk {run}: {res}")
        if counts["role_attention"] != n_deco * res["n_batches"]:
            raise AssertionError(
                f"eval from disk {run}: {counts['role_attention']} "
                f"role-attention launches for {res['n_batches']} forwards")
        if (run == "cold") != ("parse" in seconds):
            raise AssertionError(f"eval from disk {run}: read {seconds}")
        total = {k: total[k] + counts[k] for k in total}
    log(f"exp2 eval_vidvrd videos/s, wall time of the entry point: from "
        f"disk cold {rates['cold']}, warm {rates['warm']}; in memory "
        f"(phase 3a, float32) {in_memory_rate}; {card}")
    check_zero_shot_block("eval_vidvrd warm", res, "vidvrd", cfg)
    check_disk_batch(cfg)
    return {"float32": total}, res


def drive_disk_train_vidor(card, cfg):
    """Phase 3o: train_vidor's cls mode (exp4) on the VidOR train split
    from disk, batch 4: bfloat16 over 2 epochs with the default 4 GB device
    cache (which completes: epoch 1 runs from it) and without, the losses
    bit-equal; float32 over 1 epoch with a VIDOR_F32_CACHE_GB cache, which
    goes over its budget and frees what it captured (the memory allocated
    at the end within FREED_SLACK of the run without a cache) and without.
    Returns
    ({dtype: launches}, readings)."""
    from vidsgg_big_tpu_torch.tools import train_vidor
    base = ["--cfg_path", cfg, "--batch_size", str(CLS_BATCH), "--device",
            "cuda"]
    runs = [("bfloat16", "cache_on", 2, []),
            ("bfloat16", "cache_off", 2, ["--device_cache_gb", "0"]),
            ("float32", "cache_on", 1,
             ["--device_cache_gb", str(VIDOR_F32_CACHE_GB)]),
            ("float32", "cache_off", 1, ["--device_cache_gb", "0"])]
    reset_counts()
    losses, readings = {}, {}
    for dtype, name, epochs, extra in runs:
        out = os.path.join(DISK_DIR, f"train_vidor_{dtype}_{name}")
        t0 = time.perf_counter()
        res = train_vidor.main(base + extra + [
            "--compute_dtype", dtype, "--epochs", str(epochs),
            "--output_dir", out])
        log(f"train_vidor cls from disk, {dtype} {name}: {res['step']} "
            f"steps in {time.perf_counter() - t0:.1f} s")
        losses[dtype, name] = journal(out, "loss/total")
        readings[f"{dtype}_{name}"] = pipeline_readings(
            f"train_vidor cls exp4 from disk {dtype} batch {CLS_BATCH}, "
            f"{name}", res, out, card)
    counts = read_counts()
    for dtype in ("bfloat16", "float32"):
        on, off = losses[dtype, "cache_on"], losses[dtype, "cache_off"]
        if not on or on != off or not all(math.isfinite(v)
                                           for v in on.values()):
            raise AssertionError(f"train_vidor from disk {dtype}: losses "
                                 f"{on} with the cache, {off} without")
    cache = readings["bfloat16_cache_on"]["device_cache"]
    if not cache["complete"] or cache["first_cached_epoch"] != 1:
        raise AssertionError(f"train_vidor from disk bf16: cache {cache}")
    cache = readings["float32_cache_on"]["device_cache"]
    end = {k: readings[f"float32_{k}"]["end_allocated_gib"] * 2 ** 30
           for k in ("cache_on", "cache_off")}
    log(f"train_vidor from disk f32 at {VIDOR_F32_CACHE_GB} GB: cache "
        f"{cache}; "
        f"memory allocated at the end {end['cache_on'] / 2 ** 30:.3f} GiB "
        f"with the cache, {end['cache_off'] / 2 ** 30:.3f} GiB without")
    if not cache["over_budget"] or cache["videos"] or cache["bytes"] or \
            end["cache_on"] > end["cache_off"] + FREED_SLACK:
        raise AssertionError(f"train_vidor from disk f32: the cache over "
                             f"its budget kept memory: {cache}, {end}")
    if any(counts.values()):
        raise AssertionError(f"train_vidor from disk: launches {counts}")
    return {"bfloat16": counts}, readings


def drive_disk_eval_vidor(card, cfg):
    """Phase 3p: eval_vidor on the VidOR val split from disk, float32:
    stage A (n_deco_layers role-attention launches a forward), then the
    grounding stage on the clip features read from video_feature_dir (one
    composed-forward launch per engaged encoder).  Returns {"float32":
    launches}."""
    from vidsgg_big_tpu_torch.models.grounding import (GroundingConfig,
                                                       composed_encoders)
    from vidsgg_big_tpu_torch.tools import eval_vidor
    from vidsgg_big_tpu_torch.utils.config import parse_config_py
    n_deco = parse_config_py(EXP4_CFG)["model_config"]["n_deco_layers"]
    gcfg = GroundingConfig.from_dict(parse_config_py(GRD_CFG)[
        "model_config"])
    reset_counts()
    t0 = time.perf_counter()
    res = eval_vidor.main([
        "--cfg_path", cfg, "--grounding_cfg_path", GRD_CFG, "--batch_size",
        str(VIDOR_BATCH), "--topk", str(VIDOR_TOPK), "--device", "cuda",
        "--output_dir", OUT_DIR, "--metrics_json",
        os.path.join(OUT_DIR, "metrics_vidor_disk.json"),
        # phase 3s's files
        "--save_hit_infos", "--zeroshot", "--save_json_results",
        "--save_tag", "smoke"])
    wall = time.perf_counter() - t0
    counts = read_counts()
    engaged = sum(len(composed_encoders(gcfg, b, q, t))
                  for q, t, b in res["stage_b_batches"])
    log(f"eval_vidor two-stage on the VidOR val split from disk: "
        f"{json.dumps(res)}; {wall:.1f} s = {res['n_videos'] / wall} "
        f"videos/s; launches {counts} on {card}")
    if res["n_videos"] != VIDOR_DISK_VAL or res["n_relations"] == 0 or \
            not math.isfinite(res["mAP"]):
        raise AssertionError(f"eval_vidor from disk: {res}")
    if counts["role_attention"] != n_deco * res["stage_a_batches"]:
        raise AssertionError(f"eval_vidor from disk: {counts} for "
                             f"{res['stage_a_batches']} stage-A forwards")
    if engaged == 0 or counts["composed_attention"] != engaged:
        raise AssertionError(f"eval_vidor from disk: {counts} where the "
                             f"gate engages {engaged} encoders")
    check_zero_shot_block("eval_vidor", res, "vidor", cfg)
    return {"float32": counts}


def drive_disk_train_grounding(card, cfg):
    """Phase 3q: train_vidor --train_grounding on the VidOR train split's
    clip features from disk, bfloat16, batch 4, one epoch: one composed
    train forward and one backward launch per step.  Returns {"bfloat16":
    launches}."""
    from vidsgg_big_tpu_torch.tools import train_vidor
    reset_counts()
    out = os.path.join(DISK_DIR, "train_grounding")
    res = train_vidor.main([
        "--train_grounding", "--cfg_path", cfg, "--batch_size",
        str(CLS_BATCH), "--epochs", "1", "--compute_dtype", "bfloat16",
        "--device", "cuda", "--output_dir", out])
    counts = read_counts()
    losses = journal(out, "loss/total")
    pipeline_readings(f"train_vidor --train_grounding from disk bf16 batch "
                      f"{CLS_BATCH}", res, out, card)
    steps = res["step"]
    if steps < 1 or sorted(losses) != list(range(1, steps + 1)) or \
            not all(math.isfinite(v) for v in losses.values()):
        raise AssertionError(f"grounding from disk: {losses}")
    if counts["composed_attention_train"] != steps or \
            counts["composed_attention_backward"] != steps:
        raise AssertionError(f"grounding from disk: launches {counts} over "
                             f"{steps} steps")
    return {"bfloat16": counts}


# ---- the evaluation and data tools (phase 3s) ------------------------------

def unit_values(what, tree):
    """Every number of a metrics tree (dicts and lists) is finite and in
    [0, 1]; VOC-07 AP sums eleven elevenths, which may round 2e-16 above
    1."""
    values = tree.values() if isinstance(tree, dict) else tree
    for v in values:
        if isinstance(v, (dict, list)):
            unit_values(what, v)
        elif not (math.isfinite(v) and 0.0 <= v <= 1.0 + 1e-12):
            raise AssertionError(f"{what}: {v} out of [0, 1] in {tree}")


def check_zero_shot_block(what, res, kind, cfg):
    """A run's zero-shot block is there, in [0, 1], over a non-empty set of
    unseen triplets (the split's GT triplets less the train split's)."""
    from vidsgg_big_tpu_torch.data.annotations import VidOR, VidVRD
    from vidsgg_big_tpu_torch.evaluation.zero_shot import (
        collect_train_triplets)
    from vidsgg_big_tpu_torch.utils.config import parse_config_py
    ann = parse_config_py(cfg)["test_dataset_config"]["ann_dir"]
    split = "test" if kind == "vidvrd" else "validation"
    test = (VidVRD if kind == "vidvrd" else VidOR)(ann, [split]).get_triplets(
        split)
    unseen = set(map(tuple, test)) - collect_train_triplets(kind, ann)
    if "zero_shot" not in res or not unseen:
        raise AssertionError(f"{what}: zero-shot block "
                             f"{res.get('zero_shot')} over {len(unseen)} "
                             "unseen triplets")
    unit_values(f"{what} zero-shot", res["zero_shot"])
    log(f"{what}: zero-shot over {len(unseen)} unseen triplets: "
        f"{json.dumps(res['zero_shot'])} in {res['zero_shot_seconds']} s "
        "on the host")


def timed_tool(seconds, name, fn, serves=False):
    """``fn()`` with its host seconds kept under ``name`` and its launches;
    a tool that ``serves`` no model launches no kernel."""
    reset_counts()
    t0 = time.perf_counter()
    out = fn()
    seconds[name] = time.perf_counter() - t0
    counts = read_counts()
    if not serves and any(counts.values()):
        raise AssertionError(f"{name} launched kernels: {counts}")
    return out, counts


def drive_eval_tools(card, cfgs, vrd_warm, ckpt):
    """Phase 3s: the evaluation and data tools on the files of 3n's warm
    eval_vidvrd and 3p's eval_vidor, with the splits still on disk; 3f's
    float32 checkpoint converted and served through eval_vidvrd, and 3p's
    grounding weights converted and served through eval_vidor.  Returns
    {path: {"float32": launches}} of the two converted checkpoints'
    runs."""
    import lzma
    import zipfile
    from vidsgg_big_tpu_torch.models.grounding import (GroundingConfig,
                                                       composed_encoders)
    from vidsgg_big_tpu_torch.tools import (
        convert_checkpoint, cvt_results, dataloader_demo,
        eval_fraction_recall, eval_traj_mAP, eval_vidor, eval_vidvrd,
        prepare_gts_for_eval)
    from vidsgg_big_tpu_torch.utils.config import parse_config_py
    t_phase = time.perf_counter()
    seconds = {}
    # the saved predictions re-scored: the warm run's metrics, no kernel
    res, _ = timed_tool(seconds, "eval_vidvrd --json_results_path",
                        lambda: eval_vidvrd.main([
                            "--cfg_path", cfgs["exp2"], "--json_results_path",
                            os.path.join(OUT_DIR, "VidVRDtest_predict_"
                                                  "relations_smoke.json"),
                            "--zeroshot", "--output_dir", OUT_DIR,
                            "--save_tag", "smoke_rescored"]))
    keys = ("mAP", "recall", "precision", "zero_shot")
    if {k: res[k] for k in keys} != {k: vrd_warm[k] for k in keys}:
        raise AssertionError(f"re-scored {res} against the warm run's "
                             f"{vrd_warm}")
    log(f"eval_vidvrd --json_results_path: the warm run's metrics "
        f"{json.dumps({k: res[k] for k in keys})}")
    vidor_cfg = parse_config_py(cfgs["exp4"])["test_dataset_config"]
    fr, _ = timed_tool(seconds, "eval_fraction_recall",
                       lambda: eval_fraction_recall.main([
                           "--cfg_path", cfgs["exp4"], "--hit_info_path",
                           os.path.join(OUT_DIR, "hit_infos_smoke.pkl"),
                           "--experiment_dir", OUT_DIR]))
    if fr["n_videos"] != VIDOR_DISK_VAL:
        raise AssertionError(f"fraction recall over {fr}")
    unit_values("fraction recall", {k: fr[k] for k in ("video_level",
                                                        "dataset_level")})
    tm, _ = timed_tool(seconds, "eval_traj_mAP",
                       lambda: eval_traj_mAP.main([
                           "--cfg_path", cfgs["exp4"], "--dataset_type",
                           "vidor", "--split", "test"]))
    if tm["n_videos"] != VIDOR_DISK_VAL or not tm["ap_class"]:
        raise AssertionError(f"trajectory mAP {tm}")
    unit_values("trajectory mAP", [tm["mean_ap"]] + [
        ap for _, ap in tm["ap_class"]])
    gt_path = os.path.join(OUT_DIR, "VidORval_gts_smoke.json")
    gts, _ = timed_tool(seconds, "prepare_gts_for_eval",
                        lambda: prepare_gts_for_eval.main([
                            "--dataset_type", "vidor", "--anno_rpath",
                            vidor_cfg["ann_dir"], "--split", "validation",
                            "--save_path", gt_path]))
    if len(gts) != VIDOR_DISK_VAL or not all(gts.values()):
        raise AssertionError(f"prepare_gts_for_eval: {len(gts)} videos")
    pred_path = os.path.join(OUT_DIR, "VidORval_predict_relations_smoke.json")
    sub = os.path.join(OUT_DIR, "submission")
    cv, _ = timed_tool(seconds, "cvt_results", lambda: cvt_results.main([
        "--results_json", pred_path, "--output_dir", sub]))
    with open(pred_path) as f:
        pred = json.load(f)
    with zipfile.ZipFile(cv["zip_path"]) as z:
        members = z.namelist()
        first = json.loads(lzma.decompress(z.read(members[0])))
    if cv["n_videos"] != VIDOR_DISK_VAL or len(members) != len(pred) or \
            list(first["results"].values())[0] != pred[members[0][:-8]]:
        raise AssertionError(f"cvt_results: {cv}, {members}")
    dd, _ = timed_tool(seconds, "dataloader_demo",
                       lambda: dataloader_demo.main([
                           "--cfg_path", cfgs["exp4"], "--dataset_type",
                           "vidor", "--split", "test", "--device",
                           "cuda"]))
    if dd["n_videos"] != VIDOR_DISK_VAL or dd["n_batches"] < 1 or \
            len(dd["pipeline"]["h2d_ms"]) != dd["n_batches"]:
        raise AssertionError(f"dataloader_demo: {dd}")
    log(f"dataloader_demo --device cuda on the VidOR val split: "
        f"{json.dumps(dd)}")
    log(f"phase 3s tools: fraction recall {json.dumps(fr)}; trajectory mAP "
        f"{tm['mean_ap']} over {len(tm['ap_class'])} classes (read "
        f"{tm['read_seconds']} s, scored {tm['eval_seconds']} s); GT JSON of "
        f"{len(gts)} videos; submission of {cv['n_videos']} videos from a "
        f"{os.path.getsize(pred_path) / 1e6:.1f} MB prediction JSON")

    # 3f's float32 checkpoint as a reference .pth, converted and served
    n_deco = parse_config_py(EXP2_CFG)["model_config"]["n_deco_layers"]
    pth = os.path.join(OUT_DIR, "bigc_reference.pth")
    torch.save({f"module.{k}": v for k, v in
                eval_vidvrd.load_state(ckpt).items()}, pth)
    conv = os.path.join(OUT_DIR, "converted_bigc")
    timed_tool(seconds, "convert_checkpoint", lambda: convert_checkpoint.main(
        ["--torch_ckpt", pth, "--cfg_path", EXP2_CFG, "--model",
         "bigc_vidvrd", "--out", conv]))
    served = {}
    for name, path in (("reference_pth", pth),
                       ("eval_converted_checkpoint", conv)):
        res, counts = timed_tool(seconds, name, lambda: eval_vidvrd.main([
            "--cfg_path", EXP2_CFG, "--ckpt_path", path, "--synthetic",
            str(BATCH), "--synthetic_model_dims", "--batch_size", str(BATCH),
            "--device", "cuda", "--output_dir", OUT_DIR,
            "--save_json_results", "--save_tag", name]), serves=True)
        if counts["role_attention"] != n_deco * res["n_batches"]:
            raise AssertionError(f"{name}: launches {counts} for "
                                 f"{res['n_batches']} forwards")
        with open(os.path.join(OUT_DIR, "VidVRDtest_predict_relations_"
                                        f"{name}.json")) as f:
            served[name] = json.load(f)
    if served["reference_pth"] != served["eval_converted_checkpoint"] or \
            not any(served["reference_pth"].values()):
        raise AssertionError("the converted checkpoint's predictions differ "
                             "from the .pth's")
    log(f"convert_checkpoint: the converted directory serves the .pth's "
        f"{sum(map(len, served['reference_pth'].values()))} relations; "
        f"launches {counts}")
    launches = {"eval_converted_checkpoint": {"float32": counts}}

    # 3p's grounding weights as a reference .pth, converted, then 3p's
    # run again with them from the converted directory: 3p's predictions
    gcfg = GroundingConfig.from_dict(parse_config_py(GRD_CFG)["model_config"])
    gpth = os.path.join(OUT_DIR, "grounding_reference.pth")
    torch.save({f"module.{k}": v for k, v in
                eval_vidor.build_grounding_model(gcfg).state_dict().items()},
               gpth)
    gconv = os.path.join(OUT_DIR, "converted_grounding")
    timed_tool(seconds, "convert_checkpoint grounding",
               lambda: convert_checkpoint.main([
                   "--torch_ckpt", gpth, "--cfg_path", GRD_CFG, "--model",
                   "grounding", "--out", gconv]))
    res, counts = timed_tool(
        seconds, "eval_converted_grounding_checkpoint",
        lambda: eval_vidor.main([
            "--cfg_path", cfgs["exp4"], "--grounding_cfg_path", GRD_CFG,
            "--grounding_ckpt_path", gconv, "--batch_size", str(VIDOR_BATCH),
            "--topk", str(VIDOR_TOPK), "--device", "cuda", "--output_dir",
            OUT_DIR, "--save_json_results", "--save_tag",
            "converted_grounding"]), serves=True)
    engaged = sum(len(composed_encoders(gcfg, b, q, t))
                  for q, t, b in res["stage_b_batches"])
    with open(os.path.join(OUT_DIR, "VidORval_predict_relations_"
                                    "converted_grounding.json")) as f:
        if json.load(f) != pred:
            raise AssertionError("the converted grounding checkpoint's "
                                 "predictions differ from 3p's")
    if engaged == 0 or counts["composed_attention"] != engaged or \
            counts["role_attention"] == 0:
        raise AssertionError(f"converted grounding: launches {counts}, the "
                             f"gate engages {engaged} encoders")
    log(f"convert_checkpoint grounding: eval_vidor from the converted "
        f"directory gives 3p's {res['n_relations']} relations; launches "
        f"{counts}")
    launches["eval_converted_grounding_checkpoint"] = {"float32": counts}
    seconds["phase"] = time.perf_counter() - t_phase
    log(f"phase 3s host seconds: {json.dumps(seconds)}; {card}")
    return launches


def check_int8(card):
    """Phase 4 (int8 serving, exp2): one batch of 8 full-size videos packed
    int8, float32 compute.  The first visual layer's quantized weight, its
    scale and its int32 accumulator on the card exactly equal to the
    CPU's; the card's att and pred_logits against the port's CPU run at
    the float32 check's limits (cpu_gpu_readings); the card's int8 logits
    against its float32 logits on the same records by int8_f32_readings.
    Two faults the limits must see, each run once on the card: TF32 in the
    float32 tail, and each video dequantized at its neighbour's scale.
    Returns the int8 forward + triplets videos/s."""
    from vidsgg_big_tpu_torch.data.bucketing import (BucketSpec,
                                                     bucketed_batches)
    from vidsgg_big_tpu_torch.models import layers
    from vidsgg_big_tpu_torch.models.big_c import BigCConfig
    from vidsgg_big_tpu_torch.tools import eval_vidvrd
    from vidsgg_big_tpu_torch.train.steps import build_infer_step
    from vidsgg_big_tpu_torch.utils.config import parse_config_py
    from vidsgg_big_tpu_torch.utils.device import strict_float32
    mc = parse_config_py(EXP2_CFG)["model_config"]
    cfg = BigCConfig.from_dict(mc)
    recs, feat = eval_vidvrd.synthetic_records(BATCH, cfg, True)
    recs = list(recs)
    props = {}
    for dtype in ("int8", "float32"):
        _, _, props[dtype], _ = next(iter(bucketed_batches(
            recs, BucketSpec(feat_dim=feat, feat_dtype=dtype,
                             **eval_vidvrd.FULL_SIZE_BUCKETS),
            BATCH, with_gt=False)))
    model = eval_vidvrd.build_model(cfg, mc).eval()
    visual = torch.from_numpy(props["int8"].feats[..., :cfg.dim_feat])
    wrong_scale = dataclasses.replace(props["int8"], feat_scale=np.roll(
        props["int8"].feat_scale, 1))
    with torch.inference_mode():
        sw, kq = layers.quantize_weight(model.fc_feat2enti[0].weight)
        acc_cpu = layers.int8_accumulate(visual, kq)
        cpu = model(props["int8"].to("cpu"))
        model = model.cuda()
        sw_g, kq_g = layers.quantize_weight(model.fc_feat2enti[0].weight)
        acc_gpu = layers.int8_accumulate(visual.cuda(), kq_g)
        gpu = model(props["int8"].to("cuda"))
        f32 = model(props["float32"].to("cuda"))
        faults = {"each video at its neighbour's scale":
                  model(wrong_scale.to("cuda"))}
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            faults["TF32 in the float32 tail"] = model(
                props["int8"].to("cuda"))
        finally:
            strict_float32()
    log(f"int8 first layer: quantized weight equal on the card "
        f"{torch.equal(kq, kq_g.cpu())}, scale equal "
        f"{torch.equal(sw, sw_g.cpu())}; int32 accumulator "
        f"{tuple(acc_cpu.shape)} equal {torch.equal(acc_cpu, acc_gpu.cpu())}"
        f", max |acc| {acc_cpu.abs().max().item()}")
    if not (torch.equal(kq, kq_g.cpu()) and torch.equal(sw, sw_g.cpu())
            and torch.equal(acc_cpu, acc_gpu.cpu())):
        raise AssertionError("the card's int8 first layer (weight, scale "
                             "or accumulator) differs from the CPU's")
    compare_cpu_gpu(cpu, gpu, "int8 card vs CPU")
    r, broken = int8_f32_readings(f32, gpu)
    log(f"int8 vs float32 logits on the card: {r}")
    if broken:
        raise AssertionError(f"int8 logits vs float32: {broken} past their "
                             f"limits ({r})")
    for name, out in faults.items():
        r, broken = cpu_gpu_readings(cpu, out)
        r_f32, broken_f32 = int8_f32_readings(f32, out)
        log(f"int8 check's control, {name}: vs CPU {r}; vs float32 {r_f32};"
            f" breaks {broken + broken_f32}")
        if not broken + broken_f32:
            raise AssertionError(f"the int8 check does not see {name}")
    infer = build_infer_step(model, topk=10)
    dev = props["int8"].to("cuda")
    ms = cuda_ms(lambda: infer(dev), iters=20, warmup=3)
    log(f"BIG-C v10 exp2 int8 features (float32 compute) B={BATCH}: "
        f"forward + triplets {ms} ms/batch = {BATCH * 1e3 / ms} videos/s "
        f"on {card}")
    return BATCH * 1e3 / ms


def int8_f32_readings(f32, int8):
    """The card's int8 logits against its float32 logits on the same
    records: (readings, the limits they break).  The JAX test's criterion
    (tests/test_model_bigc.py:194-221: cosine > 0.999, atol 0.15 x max)
    on the queries whose subject and object (argmax over att) both runs
    pick alike, which must be at least INT8_AGREE_FLOOR of them.  At
    random weights the quantization moves some att argmaxes (near-uniform
    over 50 tracklets), and a moved argmax gathers another tracklet's
    features into the head: over all queries the criterion fails in JAX as
    in the port (cosine 0.99 in both at the demo widths,
    tests/test_torch_int8.py), so the cosine over all queries is read, not
    held."""
    a = f32["pred_logits"].double().cpu()
    b = int8["pred_logits"].double().cpu()
    alike = (f32["att"].argmax(-1) == int8["att"].argmax(-1)).all(
        dim=1).cpu()

    def cosine(x, y):
        return ((x * y).sum() / (x.norm() * y.norm())).item()
    x, y = (a[alike], b[alike]) if alike.any() else (a, b)
    r = {"cosine over all": cosine(a, b),
         "subject and object agree": alike.float().mean().item(),
         "cosine there": cosine(x, y),
         "max |diff| there": (x - y).abs().max().item(),
         "0.15 x max |f32| there": 0.15 * x.abs().max().item()}
    broken = [k for k, bad in (
        ("agreement", r["subject and object agree"] < INT8_AGREE_FLOOR),
        ("cosine", not r["cosine there"] > 0.999),
        ("atol", r["max |diff| there"] > r["0.15 x max |f32| there"]))
        if bad]
    return r, broken


def check_basec_parity():
    """Phase 4 (Base-C): one train step of exp6's Base-C (no dropout) on
    one full-size batch (2 videos in the (N=64, T=2048) bucket, 4,032
    ordered pairs each, with their GT) on the card against the port's CPU
    run on the same weights, float32: equal label maps, pred_logits within
    1e-3 (rtol and atol), the loss within TRAIN_LOSS_RTOL, every gradient
    within TRAIN_GRAD_TOL of its leaf.  The card's backward takes the
    CPU's routing at each kink: the encoder max-pool's picks
    (check_bigc_train_parity says why) and each ReLU's input signs, an
    input within rounding of 0 sending its whole gradient one way or not
    at all; the card's own picks and signs are held apart
    (check_pool_picks, check_relu_flips), and the card's step on its own
    ReLU signs is read beside it.  Returns the worst gradient leaf's max
    |diff| / max |g|."""
    from vidsgg_big_tpu_torch.data.bucketing import (BucketSpec,
                                                     bucketed_batches)
    from vidsgg_big_tpu_torch.data.synthetic_vidor import vidor_record
    from vidsgg_big_tpu_torch.models import big_c
    from vidsgg_big_tpu_torch.models.base_c import (basec_multihot,
                                                    basec_train_loss)
    from vidsgg_big_tpu_torch.tools.train_vidor import T_ABS
    model, cfg, _ = vidor_train_parts(True, "float32")
    feat = cfg.dim_feat + cfg.dim_clsme
    rows = [vidor_record(i, feat, True) for i in BASEC_PARITY_SEEDS]
    _, _, props, gts = next(iter(bucketed_batches(rows, BucketSpec(
        feat_dim=feat, n_ladder=(64,), t_ladder=(2048,)), len(rows))))
    batch = (props.to("cpu"), gts.to("cpu"))
    pooled, real_pool = [], big_c.adaptive_max_pool1d

    def run(m, props, gts, pool):
        big_c.adaptive_max_pool1d = pool
        try:
            m.train()
            m.zero_grad()
            out = m(props)
            total, _ = basec_train_loss(out, props, gts, cfg, t_abs=T_ABS)
            total.backward()
            labels = basec_multihot(props, gts, cfg.num_pred_cats,
                                    cfg.positive_viou_th, t_abs=T_ABS)
        finally:
            big_c.adaptive_max_pool1d = real_pool
        return ({"cls": total.item()},
                {k: p.grad.detach().cpu() for k, p in m.named_parameters()},
                out["pred_logits"].detach().cpu(),
                [x.cpu() for x in labels])

    def seen_pool(x, out_len, axis=-2):
        pooled.append(x.detach())
        return real_pool(x, out_len, axis)
    relu_cpu, relu_gpu = {}, {}
    hooks = relu_hooks(model, relu_cpu)
    t0 = time.perf_counter()
    cpu_terms, cpu_grads, cpu_logits, cpu_labels = run(model, *batch,
                                                       seen_pool)
    seconds = time.perf_counter() - t0
    for h in hooks:
        h.remove()
    routing = amax_routing(pooled[0], cfg.enco_pool_len)
    signs = {k: (x > 0).cuda() for k, x in relu_cpu.items()}
    dev = [type(x)(**{k: v.cuda() for k, v in vars(x).items()})
           for x in batch]
    card = copy.deepcopy(model).cuda()
    reset_counts()
    _, own_grads, _, _ = run(card, *dev, routed_max_pool(routing.cuda(),
                                                         pooled))
    hooks = relu_hooks(card, relu_gpu, signs)
    gpu_terms, gpu_grads, gpu_logits, gpu_labels = run(
        card, *dev, routed_max_pool(routing.cuda(), pooled))
    counts = read_counts()
    check_pool_picks("Base-C", pooled, routing, cfg.enco_pool_len)
    check_relu_flips("Base-C", relu_cpu, relu_gpu)
    log(f"Base-C train step on the CPU ({seconds:.1f} s) and the card: "
        f"loss {cpu_terms} / {gpu_terms}; positive pairs "
        f"{int(cpu_labels[1].sum())}; max |pred_logits| diff "
        f"{(cpu_logits - gpu_logits).abs().max().item()} of max "
        f"{cpu_logits.abs().max().item()}")
    if any(counts.values()):
        raise AssertionError(f"Base-C train step launches {counts}")
    if not all(torch.equal(a, b) for a, b in zip(cpu_labels, gpu_labels)):
        raise AssertionError("the card's Base-C label maps differ from the "
                             "CPU's")
    torch.testing.assert_close(gpu_logits, cpu_logits, rtol=1e-3, atol=1e-3)
    own = max(((own_grads[k] - g).abs().max().item()
               / max(g.abs().max().item(), 1e-12), k)
              for k, g in cpu_grads.items())
    worst = check_terms_and_grads(cpu_terms, gpu_terms, cpu_grads, gpu_grads)
    log(f"Base-C train step card vs CPU: equal label maps, worst gradient "
        f"leaf max |diff| / max |g| = {worst[0]} ({worst[1]}) on the CPU's "
        f"ReLU signs, {own[0]} ({own[1]}) on the card's own")
    return worst[0]


def relu_hooks(model, seen, signs=None):
    """Forward hooks on every nn.ReLU of ``model``, by module name: each
    stores its input (detached) in ``seen``; with ``signs`` (another run's
    inputs > 0) each keeps its forward and routes its backward by them.
    Returns the hook handles."""
    def hook(name):
        def fn(module, inputs, out):
            x = inputs[0]
            seen[name] = x.detach()
            if signs is not None:
                return out.detach() + (x - x.detach()) * signs[name]
        return fn
    return [m.register_forward_hook(hook(name))
            for name, m in model.named_modules()
            if isinstance(m, torch.nn.ReLU)]


def check_relu_flips(what, cpu, gpu):
    """The card's ReLU inputs (``gpu``, by module name) against the CPU's:
    at most RELU_FLIP_SHARE of each ReLU's inputs may change sign, each
    within RELU_TIE_RTOL of the input's largest magnitude on the CPU."""
    for name, x in cpu.items():
        y = gpu[name].cpu()
        flipped = (x > 0) != (y > 0)
        flips, scale = int(flipped.sum()), x.abs().max().item()
        gap = x[flipped].abs().max().item() if flips else 0.0
        log(f"{what} ReLU {name}: {flips} of {x.numel()} inputs change sign "
            f"on the card (its backward takes the CPU's signs); the largest "
            f"|CPU input| among them {gap}, max |input| {scale}, max |input "
            f"card - CPU| {(y - x).abs().max().item()}")
        if flips > RELU_FLIP_SHARE * x.numel() or gap > RELU_TIE_RTOL * scale:
            raise AssertionError(
                f"{what} ReLU {name}: {flips} of {x.numel()} inputs change "
                f"sign on the card (at most "
                f"{RELU_FLIP_SHARE * x.numel():.0f}), up to {gap} from 0 (at "
                f"most {RELU_TIE_RTOL * scale})")


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


def check_pool_picks(what, pooled, routing, pool_len):
    """The card's own picks of the encoder's time max-pool against the
    CPU's (``pooled``: the pool inputs of the CPU run, then the card's;
    ``routing``: the CPU's amax_routing): at most MAXPOOL_FLIP_SHARE of the
    bins may pick another frame, each a tie within MAXPOOL_TIE_RTOL of the
    pool input's largest magnitude on the CPU's values."""
    own = amax_routing(pooled[1].cpu(), pool_len)
    flipped = (own != routing).any(2)
    flips, bins = int(flipped.sum()), flipped.numel()
    # the CPU's max of each bin less its least value among the card's picks
    x = pooled[0].reshape(routing.shape)
    gap = (x.amax(2) - torch.where(own > 0, x, math.inf).amin(2)).max()
    scale = pooled[0].abs().max().item()
    log(f"{what} encoder max-pool: {flips} of {bins} bins route their "
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
    check_pool_picks("BIG-C", pooled, routing, cfg.enco_pool_len)
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
    worst = check_terms_and_grads(cpu_terms, gpu_terms, cpu_grads, gpu_grads)
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
    worst, _ = check_terms_and_grads(cpu_terms, gpu_terms, cpu_grads,
                                     gpu_grads)
    log(f"train step card vs CPU: worst gradient leaf max |diff| / max |g| "
        f"= {worst}")
    return worst


def check_terms_and_grads(cpu_terms, gpu_terms, cpu_grads, gpu_grads):
    """Every loss term within TRAIN_LOSS_RTOL of the CPU's, every gradient
    finite and within TRAIN_GRAD_TOL of its leaf's scale on the CPU.
    Returns (worst max |diff| / max |g|, its leaf)."""
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
    return worst


# ---- the segment baseline, export and serving (phases 3t, 3u) -------------

# phase 3t: the segment baseline at the reference's widths (the defaults of
# SegmentBaselineConfig: 11,070 features, 35 object and 132 predicate
# classes, pair top-k 20, segment top-k 200) on the synthetic writer's
# default 6 train + 3 test videos (about 60 segments of 4-7 proposals,
# 0.17 GB): the CLI end to end and the card against the CPU, a smoke run
# at toy scale.  SEG_MAX_ITER train iterations: the reference's 200 a
# quarter
SEG_MAX_ITER = 50
# ...then the detect path at a reference segment's scale: up to
# max_traj_num_in_clip = 100 trajectory proposals, so 100 x 99 ordered
# pairs, padded to the CLI's 16,384-pair bucket, on seeded random features;
# SEG_REF_VIDEOS videos of SEG_REF_FRAMES frames (30 segments each) for the
# association
SEG_REF_TRAJS = 100
SEG_REF_VIDEOS, SEG_REF_FRAMES = 4, 465
SEG_DIR = os.path.join(OUT_DIR, "segments")
# card vs CPU detect on one weights file: the linear layer's float32 sums
# run in another order
SEG_SCORE_TOL = 1e-5


def relation_key(r):
    return json.dumps([r["triplet"], r["duration"], r["sub_traj"],
                       r["obj_traj"]])


def same_relations(got, want, tol):
    """Equal videos, each with the same relations (triplets, durations and
    trajectories equal; scores within ``tol``), compared in the order of
    :func:`relation_key`: predictions whose scores lie within one float32
    rounding of each other may take the association's score sort in either
    order on two devices.  Returns the largest score difference."""
    if got.keys() != want.keys():
        raise AssertionError(f"videos {sorted(got)} != {sorted(want)}")
    worst = 0.0
    for vid in want:
        g = sorted(got[vid], key=relation_key)
        w = sorted(want[vid], key=relation_key)
        if [relation_key(r) for r in g] != [relation_key(r) for r in w]:
            raise AssertionError(f"{vid}: the relations differ")
        for a, b in zip(g, w):
            worst = max(worst, abs(a["score"] - b["score"]))
    if worst > tol:
        raise AssertionError(f"relation scores differ by {worst} > {tol}")
    return worst


def drive_segment_baseline(card):
    """Phase 3t: the store written at the reference's widths, the CLI's
    --train --detect on the card, its detect on the CPU from the same
    weights file (equal relations and metrics), predict_segment_pairs
    timed at the store's largest pair bucket (smoke readings at 4-7
    proposals a segment); the train step alone; the detect path at a
    reference segment's scale (:func:`segment_reference_scale`).  Returns
    ({"float32": launches}, the readings)."""
    from vidsgg_big_tpu_torch.data.segment_store import (
        SegmentStore, write_synthetic_segments)
    from vidsgg_big_tpu_torch.models.segment_baseline import (
        WEIGHTS_FILE, SegmentBaseline, SegmentBaselineConfig,
        feature_preprocess, load_weights, predict_segment_pairs)
    from vidsgg_big_tpu_torch.tools import segment_baseline
    t_phase = time.perf_counter()
    shutil.rmtree(SEG_DIR, ignore_errors=True)
    root = os.path.join(SEG_DIR, "store")
    t0 = time.perf_counter()
    write_synthetic_segments(root, cfg=SegmentBaselineConfig())
    write_s = time.perf_counter() - t0
    store = SegmentStore(root)
    cfg = store.cfg
    n_segs = {s: len(store.segments(s)) for s in store.splits()}
    log(f"segment store at the reference's widths ({cfg}): {n_segs} "
        f"segments, {dir_gb(root)} GB written in {write_s:.2f} s")
    out_dir = {d: os.path.join(SEG_DIR, d) for d in ("cuda", "cpu")}
    reset_counts()
    gpu = segment_baseline.main([
        "--data_root", root, "--train", "--detect", "--device", "cuda",
        "--max_iter", str(SEG_MAX_ITER), "--output_dir", out_dir["cuda"]])
    counts = read_counts()
    if any(counts.values()):
        raise AssertionError(f"the segment baseline launched {counts}")
    losses = gpu["train"]["losses"]
    if len(losses) != SEG_MAX_ITER or not all(map(math.isfinite, losses)) \
            or not losses[-1] < losses[0]:
        raise AssertionError(f"segment baseline losses {losses}")
    os.makedirs(out_dir["cpu"], exist_ok=True)
    shutil.copy(os.path.join(out_dir["cuda"], WEIGHTS_FILE), out_dir["cpu"])
    t0 = time.perf_counter()
    cpu = segment_baseline.main(["--data_root", root, "--detect", "--device",
                                 "cpu", "--output_dir", out_dir["cpu"]])
    cpu_detect_s = time.perf_counter() - t0
    rels = {}
    for d in out_dir:
        with open(os.path.join(out_dir[d],
                               "baseline_relation_prediction.json")) as f:
            rels[d] = json.load(f)["results"]
    worst = same_relations(rels["cuda"], rels["cpu"], SEG_SCORE_TOL)
    if gpu["detect"]["metrics"] != cpu["detect"]["metrics"]:
        raise AssertionError(f"detect metrics: card {gpu['detect']} CPU "
                             f"{cpu['detect']}")
    if gpu["detect"]["n_relations"] == 0:
        raise AssertionError("the segment baseline detected no relation")
    # predict_segment_pairs alone at the store's largest pair bucket, on
    # the test segment with the most proposal pairs
    model = SegmentBaseline(cfg).cuda()
    load_weights(os.path.join(out_dir["cuda"], WEIGHTS_FILE), model)
    bucket = gpu["detect"]["max_pair_bucket"]
    best = None
    for key in store.segments("test"):
        seg = store.load(*key)
        tid, pairs = seg["trackid"], seg["pairs"]
        test = (tid[pairs[:, 0]] < 0) & (tid[pairs[:, 1]] < 0)
        if best is None or test.sum() > best[1].sum():
            best = (seg["feats"], test)
    feats = np.zeros((bucket, cfg.feature_dim), np.float32)
    feats[:best[1].sum()] = feature_preprocess(best[0][best[1]], cfg)
    valid = torch.arange(bucket, device="cuda") < int(best[1].sum())
    f = torch.from_numpy(feats).cuda()
    predict_ms = cuda_ms(lambda: predict_segment_pairs(model, f, valid),
                         iters=50, warmup=5)
    triplet_ids = store.observed_train_triplets()
    res = {"store_gb": dir_gb(root), "write_seconds": write_s,
           "smoke_train_ms_per_iter": gpu["train"]["ms_per_iter"],
           "losses": [losses[0], losses[-1]],
           "smoke_predict_ms": predict_ms, "smoke_pair_bucket": bucket,
           "smoke_association_seconds":
               gpu["detect"]["association_seconds"],
           "cpu_detect_seconds": cpu_detect_s,
           "metrics": gpu["detect"]["metrics"],
           "n_relations": gpu["detect"]["n_relations"],
           "max_score_diff": worst,
           "train_step_ms": segment_train_step_ms(cfg, triplet_ids),
           "observed_triplets": len(triplet_ids)}
    shutil.rmtree(root)                  # 0.17 GB; the outputs stay
    res.update(segment_reference_scale(model, cfg))
    log(f"segment baseline (3t): {json.dumps(res)}; phase "
        f"{time.perf_counter() - t_phase:.1f} s; {card}")
    return {"float32": counts}, res


def segment_train_step_ms(cfg, triplet_ids):
    """Device ms of one train step alone (loss, gradient, Adam) on a
    batch of the CLI's 64 rows of seeded random features, over the store's
    observed triplets, on a model of its own (CUDA events)."""
    from vidsgg_big_tpu_torch.models.segment_baseline import (
        SegmentBaseline, build_baseline_train_step)
    gen = torch.Generator(device="cuda").manual_seed(5)
    model = SegmentBaseline(cfg).cuda()
    step = build_baseline_train_step(model, torch.optim.Adam(
        model.parameters(), lr=cfg.learning_rate))
    feats = torch.rand((64, cfg.feature_dim), generator=gen, device="cuda")
    labels = torch.randint(len(triplet_ids), (64,), generator=gen,
                           device="cuda")
    valid = torch.ones((64,), dtype=torch.bool, device="cuda")
    tids = torch.as_tensor(triplet_ids, device="cuda")
    return cuda_ms(lambda: step(feats, labels, valid, tids), iters=50,
                   warmup=5)


def segment_reference_features(cfg, n, bucket, gen):
    """(bucket, D) seeded uniform features of ``n`` valid pairs, made as
    ``feature_preprocess`` leaves them: each object's classeme and each
    motion block sum to 1, the relative-position channels pass through;
    zero padding."""
    f = torch.zeros((bucket, cfg.feature_dim), device="cuda")
    f[:n] = torch.rand((n, cfg.feature_dim), generator=gen, device="cuda")
    nc, blk = cfg.num_obj_cats, cfg.block_size
    edges = [0, nc, 2 * nc] + [2 * nc + (i + 1) * blk
                               for i in range(cfg.num_motion_blocks)]
    for lo, hi in zip(edges[:-1], edges[1:]):
        f[:n, lo:hi] /= f[:n, lo:hi].sum(-1, keepdim=True)
    return f


def segment_reference_scale(model, cfg):
    """The detect path at a reference segment's scale, on the card with
    the trained weights: SEG_REF_TRAJS trajectory proposals a segment
    (random walks that go on across the segments, so that relations
    merge), every ordered pair (9,900) on seeded random features padded to
    the CLI's pair bucket (16,384).  predict_segment_pairs alone (device
    ms, CUDA events); then each segment of SEG_REF_VIDEOS videos of
    SEG_REF_FRAMES frames predicted (host ms a segment: features made,
    predict, predictions to the host) and the greedy association on the
    host (s, with its counts).  Returns the readings."""
    from vidsgg_big_tpu_torch.data.segment_store import _random_walk_boxes
    from vidsgg_big_tpu_torch.evaluation.association import (
        Trajectory, greedy_relational_association, segment_video)
    from vidsgg_big_tpu_torch.models.segment_baseline import (
        predict_segment_pairs, predictions_to_host)
    from vidsgg_big_tpu_torch.tools.segment_baseline import (_names,
                                                             pair_bucket)
    n_traj = SEG_REF_TRAJS
    pairs = np.asarray([(i, j) for i in range(n_traj) for j in range(n_traj)
                        if i != j], np.int64)
    n, bucket = len(pairs), pair_bucket(len(pairs))
    gen = torch.Generator(device="cuda").manual_seed(7)
    valid = torch.arange(bucket, device="cuda") < n
    f = segment_reference_features(cfg, n, bucket, gen)
    predict_ms = cuda_ms(lambda: predict_segment_pairs(model, f, valid),
                         iters=20, warmup=3)
    rng = np.random.default_rng(7)
    video_st, trajs_lookup = {}, {}
    t0 = time.perf_counter()
    for v in range(SEG_REF_VIDEOS):
        vid = f"reference_scale_{v}"
        tracks = [_random_walk_boxes(rng, SEG_REF_FRAMES)
                  for _ in range(n_traj)]
        video_st[vid] = []
        for fs, fe in segment_video(0, SEG_REF_FRAMES):
            f = segment_reference_features(cfg, n, bucket, gen)
            preds = predictions_to_host(
                *predict_segment_pairs(model, f, valid), pairs)
            key = (vid, fs, fe)
            video_st[vid].append((key, preds))
            trajs_lookup[key] = [Trajectory(fs, fe, t[fs:fe])
                                 for t in tracks]
    n_segs = sum(map(len, video_st.values()))
    detect_ms = 1e3 * (time.perf_counter() - t0) / n_segs
    obj_names, pred_names = _names(cfg)
    t0 = time.perf_counter()
    rels = {vid: greedy_relational_association(st, trajs_lookup, obj_names,
                                               pred_names)
            for vid, st in video_st.items()}
    association_s = time.perf_counter() - t0
    n_rel = sum(map(len, rels.values()))
    merged = sum(r["duration"][1] - r["duration"][0] > 30
                 for rs in rels.values() for r in rs)
    if not n_rel or not all(math.isfinite(r["score"])
                            for rs in rels.values() for r in rs):
        raise AssertionError(f"reference-scale association: {n_rel} "
                             "relations")
    return {"reference_scale": {
        "trajectories_a_segment": n_traj, "pairs_a_segment": n,
        "pair_bucket": bucket, "videos": SEG_REF_VIDEOS,
        "frames_a_video": SEG_REF_FRAMES, "segments": n_segs,
        "predictions_a_segment": cfg.seg_topk,
        "associated_a_segment": 100,    # max_traj_num_in_clip's cap
        "predict_ms": predict_ms, "detect_host_ms_a_segment": detect_ms,
        "association_seconds": association_s,
        "relations": n_rel, "relations_longer_than_a_segment": merged}}


def same_leaves(served, live, what):
    """Integer and bool leaves exactly, float leaves within 1e-6."""
    from vidsgg_big_tpu_torch.utils.serving import flat_leaves
    a, b = flat_leaves(served), flat_leaves(live)
    if len(a) != len(b):
        raise AssertionError(f"{what}: {len(a)} leaves, live {len(b)}")
    worst = 0.0
    for x, y in zip(a, b):
        if x.dtype != y.dtype or x.shape != y.shape:
            raise AssertionError(f"{what}: {x.dtype} {tuple(x.shape)} "
                                 f"against live {y.dtype} {tuple(y.shape)}")
        if x.is_floating_point():
            torch.testing.assert_close(x, y, rtol=0, atol=1e-6)
            worst = max(worst, (x - y).abs().max().item() if x.numel()
                        else 0.0)
        elif not torch.equal(x, y):
            raise AssertionError(f"{what}: an integer leaf differs")
    return worst


def drive_export_serving(card):
    """Phase 3u: tools/export_model --device cuda of exp2 (bigc_vidvrd,
    B=8, N=50, T=256) in float32 and bfloat16 and of grounding_weights
    (float32) at stage B's geometry (B=4, Q=256, T=512); each artifact
    reloaded through load_exported and run on the live phases' batches
    (3a's exp2 batch, phase 4's stage-B batch), held equal to the live
    infer step, its kernel launches counted while it runs, and timed
    beside the live step.  Returns ({dtype: launches}, readings)."""
    from vidsgg_big_tpu_torch.data.bucketing import (BucketSpec,
                                                     bucketed_batches)
    from vidsgg_big_tpu_torch.models.big_c import BigCConfig
    from vidsgg_big_tpu_torch.models.grounding import (GroundingConfig,
                                                       composed_encoders)
    from vidsgg_big_tpu_torch.tools import eval_vidvrd, export_model
    from vidsgg_big_tpu_torch.tools.eval_vidor import build_grounding_model
    from vidsgg_big_tpu_torch.train.grounding_steps import (
        build_grounding_infer_step)
    from vidsgg_big_tpu_torch.train.steps import build_infer_step
    from vidsgg_big_tpu_torch.utils.config import parse_config_py
    from vidsgg_big_tpu_torch.utils.serving import load_exported
    t_phase = time.perf_counter()
    runs = {"exp2_float32": ("float32", ["--cfg_path", EXP2_CFG,
                                         "--feat_dtype", "float32"]),
            "exp2_bfloat16": ("bfloat16", ["--cfg_path", EXP2_CFG,
                                           "--feat_dtype", "bfloat16",
                                           "--compute_dtype", "bfloat16"]),
            "grounding_float32": ("float32", [
                "--cfg_path", GRD_CFG, "--model", "grounding",
                "--batch_size", str(G_B), "--q_bucket", str(G_Q),
                "--t_bucket", str(G_T)])}
    by_dtype = {"float32": {}, "bfloat16": {}}
    readings = {}
    for name, (dtype, flags) in runs.items():
        out = os.path.join(OUT_DIR, "export", name)
        man = export_model.main(flags + ["--out", out, "--device", "cuda"])
        serve, _ = load_exported(out)
        if man["model"] == "grounding":
            gmc = parse_config_py(GRD_CFG)["model_config"]
            icfg = parse_config_py(GRD_CFG)["inference_config"]
            gcfg = GroundingConfig.from_dict(gmc)
            infer = build_grounding_infer_step(
                build_grounding_model(gcfg).cuda(),
                score_th=icfg["score_th"], tiou_th=icfg["tiou_th"],
                bins_th=icfg["bins_th"], nms_th=icfg["nms_th"])
            # the manifest's dtypes: what a server feeds the artifact
            dev = [torch.from_numpy(a).to(getattr(torch, man["inputs"][n][1]))
                   .cuda() for n, a in zip(export_model.GROUNDING_INPUTS,
                                           grounding_batch())]
            run_live = lambda: infer(*dev)
            want = {"composed_attention":
                    len(composed_encoders(gcfg, G_B, G_Q, G_T)),
                    "dwsep_conv": GROUNDING_CONVS}
            videos = G_B
        else:
            mc = dict(parse_config_py(EXP2_CFG)["model_config"],
                      compute_dtype=dtype)
            cfg = BigCConfig.from_dict(mc)
            recs, feat = eval_vidvrd.synthetic_records(BATCH, cfg, True)
            _, _, props, _ = next(iter(bucketed_batches(
                recs, BucketSpec(feat_dim=feat,
                                 **eval_vidvrd.FULL_SIZE_BUCKETS),
                BATCH, with_gt=False)))
            infer = build_infer_step(eval_vidvrd.build_model(cfg, mc).cuda(),
                                     topk=man["topk"])
            dev = props.to("cuda", feats=getattr(torch, dtype))
            run_live = lambda: infer(dev)
            want = {"role_attention": cfg.n_deco_layers, "dwsep_conv": 0}
            videos = BATCH
        reset_counts()
        served = serve(dev)
        torch.cuda.synchronize()
        counts = read_counts()
        for k, n in want.items():
            if counts[k] != n:
                raise AssertionError(f"{name}: {counts[k]} {k} launches "
                                     f"while the artifact ran, expected {n}")
        by_dtype[dtype] = {k: by_dtype[dtype].get(k, 0) + v
                           for k, v in counts.items()}
        worst = same_leaves(served, run_live(), name)
        serve_ms = cuda_ms(lambda: serve(dev), iters=10, warmup=2)
        live_ms = cuda_ms(run_live, iters=10, warmup=2)
        readings[name] = {
            "export_seconds": man["export_seconds"],
            "artifact_mb": man["artifact_bytes"] / 1e6,
            "artifact_videos_per_s": videos * 1e3 / serve_ms,
            "live_videos_per_s": videos * 1e3 / live_ms,
            "launches": counts, "max_float_diff": worst}
        log(f"export and serving {name}: {json.dumps(readings[name])}")
        del serve, infer, dev, served
        torch.cuda.empty_cache()
    log(f"export and serving (3u) took {time.perf_counter() - t_phase:.1f} "
        f"s; {card}")
    return by_dtype, readings


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


def cpu_gpu_readings(cpu, gpu):
    """The card's BIG-C output against the CPU's, float32 with no TF32 on
    either side: (readings, the limits they break).  att within 1e-4
    absolute and pred_logits within 1e-3 (rtol and atol) where both sides
    pick the same subject and object (argmax over att); a near tie may flip
    an argmax between two summation orders, so at most 1% of queries may
    differ; every output finite."""
    att_c, att_g = cpu["att"], gpu["att"].cpu()
    lc, lg = cpu["pred_logits"], gpu["pred_logits"].cpu()
    same = (att_c.argmax(-1) == att_g.argmax(-1)).all(dim=1)    # (B, Q)
    r = {"max |att| diff": (att_g - att_c).abs().max().item(),
         "argmax agrees": same.float().mean().item(),
         "max |pred_logits| diff": (lg - lc).abs().max().item(),
         "there": ((lg - lc)[same].abs().max().item() if same.any()
                   else math.nan)}
    broken = [k for k, bad in (
        ("att", r["max |att| diff"] > 1e-4),
        ("argmax", r["argmax agrees"] < 0.99),
        ("pred_logits", not torch.allclose(lg[same], lc[same], rtol=1e-3,
                                           atol=1e-3)),
        ("finite", not all(torch.isfinite(v).all() for out in (cpu, gpu)
                           for v in out.values()))) if bad]
    return r, broken


def compare_cpu_gpu(cpu, gpu, what="card vs CPU"):
    """Raise unless the card's output meets cpu_gpu_readings' limits."""
    r, broken = cpu_gpu_readings(cpu, gpu)
    log(f"{what}: {r}")
    if broken:
        raise AssertionError(f"{what}: {broken} past their limits ({r})")


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
    t_script = time.perf_counter()
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

    dwsep = check_dwsep_conv()
    dwsep["code"] = dwsep_code(logs["dwsep_conv"])
    kernels = [role] + check_composed_attention() + [dwsep]
    for k in kernels:
        tag = k["name"].rsplit("_", 1)[1]
        if k["name"] in ("role_attention", "dwsep_conv_f32"):
            continue
        if k["name"].startswith("composed_attention_backward_"):
            k["code"] = {p: bwd_code[f"{p}_{tag}"] for p in ("dq", "dkv")}
        elif k["name"].startswith("composed_attention_dropout_"):
            k["code"] = fwd_code[f"{tag}_train"]
        elif k["name"].startswith("composed_attention_"):
            k["code"] = fwd_code[f"{tag}_inference"]
    by_path = {}
    by_path["exp2_vidvrd"], exp2 = drive_exp2()
    by_path["vidor_two_stage"], vidor = drive_vidor()
    by_path["grounding_train_step"], train = drive_train_step(card)
    by_path["train_vidor"], _ = drive_train_entry(card)
    by_path["bigc_train_step"], bigc_train = drive_bigc_train_step(card)
    by_path["train_vidvrd"], ckpts = drive_train_vidvrd(card)
    by_path["eval_trained_checkpoint"] = serve_trained(card, ckpts)
    by_path["exp2_int8_serving"] = drive_exp2_int8()
    vidor_train = {}
    for baseline in (False, True):
        tag = "base" if baseline else "cls"
        by_path[f"train_vidor_{tag}"], cls_ckpts, vidor_train[tag] = \
            drive_vidor_training(card, baseline)
        by_path[f"eval_vidor_{tag}_checkpoint"] = serve_vidor_checkpoints(
            card, cls_ckpts, baseline)
    t0 = time.perf_counter()
    by_path["multi_gpu"], multi_gpu = drive_multi_gpu(card, exp2, vidor)
    log(f"the multi-GPU phase took {time.perf_counter() - t0:.1f} s")
    # the on-disk route: splits in the reference layout, read by the entry
    # points without --synthetic
    t0 = time.perf_counter()
    disk_cfgs = write_disk_splits()
    by_path["disk_train_vidvrd"], _ = drive_disk_train_vidvrd(
        card, disk_cfgs["exp2"])
    by_path["disk_eval_vidvrd"], vrd_warm = drive_disk_eval_vidvrd(
        card, disk_cfgs["exp2"],
        N_VIDEOS / exp2["float32"]["wall_seconds"])
    by_path["disk_train_vidor_cls"], _ = drive_disk_train_vidor(
        card, disk_cfgs["exp4"])
    by_path["disk_eval_vidor"] = drive_disk_eval_vidor(card,
                                                       disk_cfgs["exp4"])
    by_path["disk_train_grounding"] = drive_disk_train_grounding(
        card, disk_cfgs["grounding"])
    by_path.update(drive_eval_tools(card, disk_cfgs, vrd_warm,
                                    ckpts["float32"]))
    for split in ("vidvrd", "vidor"):     # the written data; logs stay
        shutil.rmtree(os.path.join(DISK_DIR, split))
    log(f"the on-disk phases took {time.perf_counter() - t0:.1f} s")
    by_path["segment_baseline"], segments = drive_segment_baseline(card)
    by_path["export_serving"], served = drive_export_serving(card)
    log("visualisation (tools/visualize.py) is not driven here: it has no "
        "device path, and this host has no OpenCV; the CPU tests hold it "
        "against the JAX package's")
    # role attention runs in float32 under every compute and feature dtype;
    # each composed row counts the launches of its dtype's runs
    rows_of = {"role_attention": ("role_attention", (
        "float32", "bfloat16", "int8", "all_triplets_float32"))}
    for wrapper, row in (("composed_attention", "composed_attention"),
                         ("composed_attention_train",
                          "composed_attention_dropout"),
                         ("composed_attention_backward",
                          "composed_attention_backward")):
        rows_of[row + "_f32"] = (wrapper, ("float32",))
        rows_of[row + "_bf16"] = (wrapper, ("bfloat16",))
    rows_of["dwsep_conv_f32"] = ("dwsep_conv", ("float32",))
    for k in kernels:
        wrapper, dtypes = rows_of[k["name"]]
        k["launches_by_path"] = {
            p: sum(c[d][wrapper] for d in dtypes if d in c)
            for p, c in by_path.items()}
        k["launches"] = sum(k["launches_by_path"].values())
        if k["launches"] == 0:
            raise AssertionError(f"{k['name']}: no launch on any path")
    rates = check_outputs(card)
    rates["int8"] = check_int8(card)
    check_train_parity()
    check_bigc_train_parity()
    check_basec_parity()
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
    log(f"BIG-C v10 exp2 B={BATCH} forward + triplets videos/s: float32 "
        f"{rates['float32']}, bfloat16 {rates['bfloat16']}, int8 features "
        f"(float32 compute) {rates['int8']}; {card}")
    for tag, by_dtype in vidor_train.items():
        for dtype, res in by_dtype.items():
            log(f"VidOR {tag} training {dtype}: {res['ms_per_step']} "
                f"ms/step, {res['videos_per_s']} videos/s at B={CLS_BATCH} "
                f"N=64 T=4096, peak {res['peak_bytes'] / 2 ** 30:.2f} GiB "
                f"(entry point {res['entry_peak_bytes'] / 2 ** 30:.2f} GiB);"
                f" {card}")
    for dtype, res in bigc_train.items():
        log(f"BIG-C training {dtype}: {res['ms_per_step']} ms/step, "
            f"{res['videos_per_s']} videos/s at exp2 B={BATCH} N=50 T=256, "
            f"peak {res['peak_bytes'] / 2 ** 30:.2f} GiB, matching on the "
            f"host {res['matching_host_ms']} ms a step; {card}")

    log(f"segment baseline at the reference's widths: "
        f"{json.dumps(segments)}; {card}")
    for name, res in served.items():
        log(f"exported {name}: {res['artifact_videos_per_s']} videos/s "
            f"through the artifact, {res['live_videos_per_s']} live, "
            f"export {res['export_seconds']:.1f} s, {res['artifact_mb']:.1f} "
            f"MB; {card}")
    log(f"role_attention wrapper wall time (through the registered op, exp2 "
        f"B=8 N=50): {role['call_ms']} ms a call; the parent's in turns "
        f"(--parent): {role['parent_call_ms']}; {card}")
    log(f"chip_smoke.py took {time.perf_counter() - t_script:.1f} s; "
        f"{card}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
