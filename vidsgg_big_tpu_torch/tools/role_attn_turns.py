"""Time the role-attention kernel on the device alone, against other
checkouts' kernels and its own split choices, in turns, on one card.

    python -m vidsgg_big_tpu_torch.tools.role_attn_turns \\
        [OTHER_CHECKOUT ...] [--splits S [S ...]] [--wrapper]

Builds ``vidsgg_big_tpu_torch/csrc/role_attn.cu`` of each OTHER_CHECKOUT
(with its own headers) with the port's nvcc flags into a scratch library
and calls it through its own C signature: ``role_attn_launch`` (strided
operands, a byte mask) where the library has it, else the first port's
``role_attn_forward`` (contiguous operands, an int32 mask, both made before
the timing).  At the decoder's widths (Q=192, Dh=256, De=512, dim_enti 512)
and three shapes, exp2 B=8 N=50, VidOR stage A B=4 N=64 and B=4 N=192, with
this checkout's kernel fed the layer's views of its projections: checks each
other kernel against this one (role attention's card tolerances), then times
the other checkout's kernel (A) and this one's (B) in turns A, B, B, A, and
this one at each forced split S of ``--splits`` after them.  A time is one
replay of a CUDA graph of 20 calls over 20 (CUDA events; each graph replayed
once before), so it holds the kernels and the gaps between them and no host
work.  Prints one line per shape and, last, a JSON line.  Needs a CUDA card
and the CUDA toolkit.

:func:`wrapper_turns` (``--wrapper``, and ``chip_smoke.py --parent``)
times the Python wrapper instead (``ops.role_attn.role_attention``, host milliseconds a
call, the least of five readings of 1,000 calls each ending in a
synchronize, at the three shapes, on the layer's views): each checkout's
in a fresh process of its own, in turns A B B A, so that two versions of
the wrapper (e.g. a direct ``ctypes`` call and a registered op) are
compared on one card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from ..ops import build
from ..ops import role_attn as ra
from ..utils.device import card_name_and_power, strict_float32

SOURCE = Path("vidsgg_big_tpu_torch", "csrc", "role_attn.cu")
Q, DH, DE, DIM_ENTI = 192, 256, 512, 512      # the decoder's widths
# (name, B, N): exp2's batch, VidOR stage A's batch at its N=64 rung (46
# tracklets), and the top rung of the stage-A ladder
SHAPES = (("exp2_b8_n50", 8, 50), ("stage_a_b4_n64", 4, 64),
          ("b4_n192", 4, 192))
CALLS = 20                  # calls in one graph
ATT_TOL = dict(rtol=1e-5, atol=1e-6)
VAL_TOL = dict(rtol=1e-4, atol=1e-5)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Time role attention against other checkouts' kernels.")
    parser.add_argument("other", nargs="*", help="roots of other checkouts")
    parser.add_argument("--splits", type=int, nargs="*", default=[],
                        help="also time this kernel at these forced splits")
    parser.add_argument("--wrapper", action="store_true",
                        help="time each checkout's Python wrapper (host ms "
                             "a call) instead of the kernels")
    return parser.parse_args(argv)


# run in a fresh process from a checkout's root: that checkout's wrapper,
# through names (SHAPES, layer_inputs, wall_ms, DIM_ENTI) that older
# copies of this module have too
WRAPPER_SNIPPET = """
import json
from vidsgg_big_tpu_torch.ops.role_attn import role_attention
from vidsgg_big_tpu_torch.tools import role_attn_turns as t
out = {}
for name, b, n in t.SHAPES:
    args = t.layer_inputs(b, n, seed=b * 1000 + n)
    out[name] = min(t.wall_ms(lambda: role_attention(*args, t.DIM_ENTI),
                              calls=1000) for _ in range(5))
print(json.dumps(out))
"""


def wrapper_turns(others) -> dict:
    """{checkout: {shape: [ms a call, one a turn]}}: this checkout's
    wrapper ("this") and each other's, each in a fresh process started
    from its root, in turns A B B A."""
    roots = {"this": str(Path(__file__).resolve().parents[2])}
    roots.update({o: str(Path(o).resolve()) for o in others})
    times = {k: {name: [] for name, _, _ in SHAPES} for k in roots}
    for other in others:
        for key in (other, "this", "this", other):
            proc = subprocess.run(
                [sys.executable, "-c", WRAPPER_SNIPPET], cwd=roots[key],
                env=dict(os.environ, PYTHONPATH=roots[key]),
                capture_output=True, text=True, timeout=900)
            if proc.returncode != 0:
                raise RuntimeError(f"wrapper timing in {roots[key]} "
                                   f"failed:\n{proc.stderr[-4000:]}")
            for name, ms in json.loads(
                    proc.stdout.strip().splitlines()[-1]).items():
                times[key][name].append(ms)
    return times


def layer_inputs(b, n, seed=0, device="cuda"):
    """(p, e, enco, mask) as the decoder layer passes them: p and e the
    role halves of (B, Q, 2 Dh) and (B, N, 2 Dh) projections as views;
    a bool mask with masked tracklets and, for b > 1, a padded last
    video."""
    rng = np.random.default_rng(seed)
    mask = rng.uniform(size=(b, n)) > 0.2
    mask[:, 0] = True
    if b > 1:
        mask[-1] = False
    pred2att = rng.normal(0, 0.3, (b, Q, 2 * DH)).astype(np.float32)
    enti2att = rng.normal(0, 0.3, (b, n, 2 * DH)).astype(np.float32)
    enco = rng.normal(0, 0.5, (b, n, DE)).astype(np.float32)
    p, e, c, m = (torch.from_numpy(x).to(device) for x in (
        pred2att, enti2att, enco, mask))
    return (p.unflatten(-1, (2, DH)).transpose(1, 2),
            e.unflatten(-1, (2, DH)).transpose(1, 2), c, m)


def graph_turns(fns, order):
    """{name: [ms per call, one per turn]}: each function captured in a
    CUDA graph of CALLS calls, replayed once, then timed by one replay (CUDA
    events) each time its name comes in ``order``."""
    graphs = {}
    for name, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        graphs[name] = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graphs[name]):
            for _ in range(CALLS):
                fn()
        graphs[name].replay()
    torch.cuda.synchronize()
    times = {name: [] for name in order}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for name in order:
        start.record()
        graphs[name].replay()
        end.record()
        end.synchronize()
        times[name].append(start.elapsed_time(end) / CALLS)
    del graphs
    # cuBLAS keeps a workspace for every stream it ran on (here the capture
    # stream, for the plain version's products), allocated from the graph's
    # pool; free it, or it stays allocated and lifts every later peak
    torch._C._cuda_clearCublasWorkspaces()
    return times


def wall_ms(fn, calls=100):
    """Host milliseconds per call of ``fn`` over ``calls`` calls, ending
    in a synchronize (what a caller waits when the card keeps up)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / calls


def other_call(lib, p, e, c, mask):
    """A function that runs ``lib``'s kernel on these operands through its
    own C signature and returns (att, values)."""
    if hasattr(lib, "role_attn_launch"):
        lib = ra.bind_library(lib)
        return lambda: ra._launch(p, e, c, mask, DIM_ENTI, lib=lib)
    f = lib.role_attn_forward
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    f.argtypes = [ptr] * 6 + [i32] * 5 + [ctypes.c_float, ptr]
    f.restype = i32
    p, e, c = p.contiguous(), e.contiguous(), c.contiguous()
    mask = mask.to(torch.int32)
    b, _, q, dh = p.shape
    n, de = e.shape[2], c.shape[2]

    def run():
        att = torch.empty((b, 2, q, n), dtype=torch.float32, device=p.device)
        val = torch.empty((b, 2, q, de), dtype=torch.float32,
                          device=p.device)
        err = f(p.data_ptr(), e.data_ptr(), c.data_ptr(), mask.data_ptr(),
                att.data_ptr(), val.data_ptr(), b, q, n, dh, de,
                1.0 / math.sqrt(DIM_ENTI),
                torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"role_attn_forward failed: error {err}")
        return att, val
    return run


def other_libraries(roots, tmp):
    libs = {}
    for i, root in enumerate(roots):
        path = Path(tmp, f"other{i}.so")
        build.compile_library(Path(root).resolve() / SOURCE, path)
        libs[root] = ctypes.CDLL(str(path))
    return libs


def run_turns(libs, splits=()):
    """{shape: {"this": [ms, ms], root: [ms, ms], "split_S": [ms],
    "max_abs_diff": {root: x}}} for every shape of SHAPES."""
    results = {}
    for name, b, n in SHAPES:
        p, e, c, mask = layer_inputs(b, n, seed=b * 1000 + n)

        def this():
            return ra._launch(p, e, c, mask, DIM_ENTI)
        att, val = this()
        fns, diffs = {}, {}
        for root, lib in libs.items():
            fns[root] = other_call(lib, p, e, c, mask)
            att_o, val_o = fns[root]()
            torch.cuda.synchronize()
            torch.testing.assert_close(att, att_o, **ATT_TOL)
            torch.testing.assert_close(val, val_o, **VAL_TOL)
            diffs[root] = max((att - att_o).abs().max().item(),
                              (val - val_o).abs().max().item())
        fns["this"] = this
        for s in splits:
            fns[f"split_{s}"] = (lambda s=s: ra._launch(
                p, e, c, mask, DIM_ENTI, splits=s))
        order = []
        for root in libs:
            order += [root, "this", "this", root]
        if not libs:
            order += ["this", "this"]
        order += [f"split_{s}" for s in splits]
        results[name] = dict(graph_turns(fns, order), max_abs_diff=diffs)
    return results


def main(argv=None) -> int:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        print("role_attn_turns: needs a CUDA card", file=sys.stderr)
        return 2
    strict_float32()
    card = card_name_and_power()
    if args.wrapper:
        times = wrapper_turns(args.other)
        for name, b, n in SHAPES:
            print(f"role_attn_turns wrapper {name} (B={b}, N={n}), host ms "
                  "a call in turns A B B A: " + ", ".join(
                      f"{k} {v[name]}" for k, v in times.items())
                  + f"; {card}", flush=True)
        print(json.dumps({"card": card, "wrapper_ms": times}), flush=True)
        return 0
    with tempfile.TemporaryDirectory() as tmp:
        libs = other_libraries(args.other, tmp)
        results = run_turns(libs, args.splits)
    for name, b, n in SHAPES:
        res = results[name]
        default = ra.de_splits(b, Q, DE, ra._sms(torch.device("cuda")))
        print(f"role_attn_turns {name} (B={b}, N={n}, default split "
              f"{default}): " + ", ".join(
                  f"{k} {v} ms" for k, v in res.items()
                  if k != "max_abs_diff")
              + f"; max |this - other| {res['max_abs_diff']}; {card}",
              flush=True)
    print(json.dumps({"card": card, "q": Q, "dh": DH, "de": DE,
                      "calls_a_graph": CALLS, "shapes": results}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
