"""The host-bound serving readings of ``chip_smoke.py``'s phase 4 for
several checkouts, each in a fresh process, in turns A B B A: exp2 BIG-C
v10 videos/s at batch 8 in float32 and bfloat16 (``check_outputs``) and
grounding inference ms/video (``check_grounding``), each checkout running
its own ``chip_smoke.py`` and kernels.  With ``--after_eval`` each process
first runs the in-memory ``eval_vidvrd`` path (exp2, 16 full-size videos,
float32 then bfloat16), as ``chip_smoke.py``'s phase 3a does before
phase 4.  On a host with the card:

    python -m vidsgg_big_tpu_torch.tools.serving_turns CHECKOUT_A \\
        CHECKOUT_B [--after_eval]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

# run in each checkout's root, on its own chip_smoke.py and package
_CHILD = r'''
import json, os, sys
sys.path.insert(0, os.getcwd())
import chip_smoke as cs
from vidsgg_big_tpu_torch.ops import build
from vidsgg_big_tpu_torch.utils.device import (card_name_and_power,
                                               strict_float32)
strict_float32()
build.build()
card = card_name_and_power()
if os.environ.get("SERVING_TURNS_AFTER_EVAL"):
    from vidsgg_big_tpu_torch.tools import eval_vidvrd
    for extra in ([], ["--compute_dtype", "bfloat16", "--feat_dtype",
                       "bfloat16"]):
        eval_vidvrd.main(["--cfg_path", cs.EXP2_CFG, "--synthetic", "16",
                          "--synthetic_model_dims", "--batch_size", "8",
                          "--device", "cuda", "--output_dir", cs.OUT_DIR]
                         + extra)
print("RESULT " + json.dumps(dict(
    exp2_videos_per_s=cs.check_outputs(card),
    grounding_ms_per_video=cs.check_grounding(card), card=card)),
    flush=True)
'''


def run(checkout: str, after_eval: bool) -> dict:
    """One fresh process in ``checkout``: its readings (raises with the
    process's error output if it fails)."""
    env = dict(os.environ, SERVING_TURNS_AFTER_EVAL="1" if after_eval
               else "")
    proc = subprocess.run([sys.executable, "-c", _CHILD], cwd=checkout,
                          capture_output=True, text=True, env=env)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("RESULT ")]
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f"{checkout}: exit {proc.returncode}\n"
                           f"{proc.stderr[-4000:]}")
    return json.loads(lines[-1][len("RESULT "):])


def main(argv=None) -> list:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("checkouts", nargs="+",
                        help="roots of the checkouts, each with its "
                             "chip_smoke.py")
    parser.add_argument("--after_eval", action="store_true",
                        help="run the in-memory eval_vidvrd path first in "
                             "each process")
    args = parser.parse_args(argv)
    order = args.checkouts + args.checkouts[::-1]
    out = []
    for checkout in order:
        r = dict(run(checkout, args.after_eval), checkout=checkout,
                 after_eval=args.after_eval)
        print(json.dumps(r), flush=True)
        out.append(r)
    return out


if __name__ == "__main__":
    main()
