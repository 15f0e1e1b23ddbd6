"""Compare a composed-attention kernel source's machine code (SASS) in two
checkouts.

    python -m vidsgg_big_tpu_torch.tools.sass_compare \\
        [--source forward|backward] OTHER_CHECKOUT

Builds ``vidsgg_big_tpu_torch/csrc/composed_attn.cu`` (``--source forward``,
the default) or ``composed_attn_bwd.cu`` (``--source backward``) of this
checkout and of OTHER_CHECKOUT with the port's nvcc flags
(``ops/build.NVCC_FLAGS``) into scratch libraries, which include each
checkout's own ``composed_attn_common.cuh``, disassembles both with
``cuobjdump -sass`` and prints, for each of the source's four kernels (the
forward's inference and train instances in bf16 and f32; the backward's dq
and dk/dv kernels in bf16 and f32), its instruction count in each and
whether the two instruction sequences are identical.  Exits 1 if any
differs or is missing.  Needs the CUDA toolkit (the host with the card).
"""
from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

from ..ops import build

CSRC = Path("vidsgg_big_tpu_torch", "csrc")
# each source and the names of its four kernels, as parts of their mangled
# names
SOURCES = {
    "forward": (CSRC / "composed_attn.cu",
                ("composed_attn_bf16_kernelILb0E",
                 "composed_attn_bf16_kernelILb1E",
                 "composed_attn_f32_kernelILb0E",
                 "composed_attn_f32_kernelILb1E")),
    "backward": (CSRC / "composed_attn_bwd.cu",
                 ("composed_attn_bwd_dq_bf16_kernel",
                  "composed_attn_bwd_dkv_bf16_kernel",
                  "composed_attn_bwd_dq_f32_kernel",
                  "composed_attn_bwd_dkv_f32_kernel")),
}


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Compare a composed-attention kernel source's SASS in "
                    "two checkouts.")
    parser.add_argument("--source", choices=sorted(SOURCES),
                        default="forward")
    parser.add_argument("other", help="root of the other checkout")
    return parser.parse_args(argv)


def compiled_sass(root: Path, source: Path, out: Path) -> dict:
    build.compile_library(root / source, out)
    return build.sass(out)


def main(argv=None) -> int:
    args = parse_args(argv)
    source, kernels = SOURCES[args.source]
    with tempfile.TemporaryDirectory() as tmp:
        here = compiled_sass(build.PACKAGE_DIR.parent, source,
                             Path(tmp, "here.so"))
        other = compiled_sass(Path(args.other).resolve(), source,
                              Path(tmp, "other.so"))
    same_all = True
    for key in kernels:
        a = [v for k, v in other.items() if key in k]
        b = [v for k, v in here.items() if key in k]
        same = len(a) == len(b) == 1 and a[0] == b[0]
        same_all &= same
        print(f"sass_compare {key}: other checkout "
              f"{len(a[0]) if len(a) == 1 else None} instructions, this "
              f"checkout {len(b[0]) if len(b) == 1 else None}, identical: "
              f"{same}", flush=True)
    print(f"sass_compare {source}: {args.source} kernels "
          f"{'IDENTICAL' if same_all else 'DIFFERENT'}", flush=True)
    return 0 if same_all else 1


if __name__ == "__main__":
    sys.exit(main())
