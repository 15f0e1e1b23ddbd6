"""Time the composed-attention forward's four instances against other
checkouts', in turns, on one card.

    python -m vidsgg_big_tpu_torch.tools.forward_turns OTHER_CHECKOUT \\
        [OTHER_CHECKOUT ...]

Builds ``vidsgg_big_tpu_torch/csrc/composed_attn.cu`` of each OTHER_CHECKOUT
(with its own ``composed_attn_common.cuh``) with the port's nvcc flags into
a scratch library (this checkout's comes from ``ops/build``).  At the bench
geometry's combined encoder, R = 4 x 256 = 1,024 rows x T = 512 keys x 8
heads x d = 128 (masked keys and one fully masked row), for float32 and
bfloat16, the inference instance and the train instance at dropout 0.1,
for each other checkout in the order given: checks this checkout's output
against the other's at the forward's card tolerances (and prints the
largest difference of the train statistics), then times the other
checkout's kernel (A), this one's (B) and PyTorch's SDPA on the same
operands in turns A, B, SDPA, SDPA, B, A (CUDA events, 10 calls a turn
after one).  Prints one line per instance and other checkout and, last, a
JSON line with both turns of each.  Needs a CUDA card and the CUDA
toolkit.
"""
from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import sys
import tempfile
from pathlib import Path

import torch
import torch.nn.functional as F

from ..ops import build
from ..ops import composed_attn as ca
from ..utils.device import card_name_and_power, strict_float32

SOURCE = Path("vidsgg_big_tpu_torch", "csrc", "composed_attn.cu")
ROWS, T = 1024, 512          # the bench geometry's combined encoder
HEADS, WIDTH, SCALE, DROPOUT = 8, 128, 0.25, 0.1
ITERS = 10                   # calls a turn
# the card tolerances of the forward against its plain version
TOL = {torch.float32: dict(rtol=1e-4, atol=1e-5),
       torch.bfloat16: dict(rtol=1e-2, atol=1e-2)}


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Time the composed forward against another checkout's.")
    parser.add_argument("other", nargs="+", help="roots of other checkouts")
    return parser.parse_args(argv)


def operands(r, t, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    qh = torch.randn(r, HEADS, t, WIDTH, generator=g) * 0.1
    x = torch.randn(r, t, WIDTH, generator=g)
    vt = torch.randn(r, HEADS, t, WIDTH, generator=g) * 0.2
    valid = torch.rand(r, t, generator=g) < 0.8
    valid[:, 0] = True
    valid[-1] = False
    bias = torch.where(valid, 0.0, -1e30).to(torch.float32)
    seeds = torch.randint(-2 ** 31, 2 ** 31, (r,), dtype=torch.int32,
                          generator=g)
    return ([a.to("cuda", dtype) for a in (qh, x, vt)] + [bias.cuda()],
            seeds.cuda())


def cuda_ms(fn, iters):
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> int:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        print("forward_turns: needs a CUDA card", file=sys.stderr)
        return 2
    strict_float32()
    card = card_name_and_power()
    others = {}
    with tempfile.TemporaryDirectory() as tmp:
        for i, root in enumerate(args.other):
            path = Path(tmp, f"other{i}.so")
            build.compile_library(Path(root).resolve() / SOURCE, path)
            others[root] = ca.bind_library(ctypes.CDLL(str(path)),
                                           "composed_attn")
    results = {root: {} for root in others}
    for dtype in (torch.float32, torch.bfloat16):
        (qh, x, vt, bias), seeds = operands(ROWS, T, dtype)
        kv = x[:, None].expand(-1, HEADS, -1, -1)
        mask = bias[:, None, None, :].to(dtype)
        for (root, other), train in itertools.product(others.items(),
                                                      (False, True)):
            p = DROPOUT if train else 0.0

            def run(lib=None):
                return ca._launch_forward(train, qh, x, vt, bias, SCALE, p,
                                          seeds, lib)
            (a, sa), (b, sb) = run(other), run()
            torch.cuda.synchronize()
            torch.testing.assert_close(b, a, **TOL[dtype])
            diff = {"out": (b.float() - a.float()).abs().max().item()}
            if train:
                diff["stats"] = (sb - sa).abs().max().item()
            fns = {"other": lambda: run(other), "this": run,
                   "sdpa": lambda: F.scaled_dot_product_attention(
                       qh, kv, vt, attn_mask=mask, scale=SCALE,
                       dropout_p=p).sum(1)}
            times = {name: [] for name in fns}
            for name in ["other", "this", "sdpa", "sdpa", "this", "other"]:
                times[name].append(cuda_ms(fns[name], ITERS))
            key = (f"{'f32' if dtype == torch.float32 else 'bf16'}_"
                   f"{'train' if train else 'inference'}")
            results[root][key] = dict(times, max_abs_diff=diff)
            best = {k: min(v) for k, v in times.items()}
            print(f"forward_turns {key} R={ROWS} T={T} vs {root}: "
                  f"other {times['other']} ms, this {times['this']} ms, "
                  f"SDPA {times['sdpa']} ms; this / other "
                  f"{best['this'] / best['other']}, this / SDPA "
                  f"{best['this'] / best['sdpa']}; max |this - other| "
                  f"{diff}; {card}", flush=True)
            del a, b, sa, sb
        del qh, x, vt, bias, seeds, kv, mask
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "rows": ROWS, "t": T,
                      "others": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
