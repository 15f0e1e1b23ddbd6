"""Compare the forward kernel's machine code (SASS) in two checkouts.

    python -m vidsgg_big_tpu_torch.tools.sass_compare OTHER_CHECKOUT

Builds ``vidsgg_big_tpu_torch/csrc/composed_attn.cu`` of this checkout and
of OTHER_CHECKOUT with the port's nvcc flags (``ops/build.NVCC_FLAGS``)
into scratch libraries, which include each checkout's own
``composed_attn_common.cuh``, disassembles both with ``cuobjdump -sass``
and prints, for each of the forward's four instances (inference and train,
bf16 and f32), its instruction count in each and whether the two
instruction sequences are identical.  Exits 1 if any differs or is
missing.  Needs the CUDA toolkit (the host with the card).
"""
from __future__ import annotations

import subprocess
import sys
import tempfile
from pathlib import Path

from ..ops import build

SOURCE = Path("vidsgg_big_tpu_torch", "csrc", "composed_attn.cu")
INSTANCES = ("composed_attn_bf16_kernelILb0E", "composed_attn_bf16_kernelILb1E",
             "composed_attn_f32_kernelILb0E", "composed_attn_f32_kernelILb1E")


def compiled_sass(root: Path, out: Path) -> dict:
    subprocess.run([build.cuda_tool(), *build.NVCC_FLAGS, "-o", str(out),
                    str(root / SOURCE)], check=True)
    return build.sass(out)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory() as tmp:
        here = compiled_sass(build.PACKAGE_DIR.parent, Path(tmp, "here.so"))
        other = compiled_sass(Path(argv[0]).resolve(), Path(tmp, "other.so"))
    same_all = True
    for key in INSTANCES:
        a = [v for k, v in other.items() if key in k]
        b = [v for k, v in here.items() if key in k]
        same = len(a) == len(b) == 1 and a[0] == b[0]
        same_all &= same
        print(f"sass_compare {key}: other checkout "
              f"{len(a[0]) if len(a) == 1 else None} instructions, this "
              f"checkout {len(b[0]) if len(b) == 1 else None}, identical: "
              f"{same}", flush=True)
    print(f"sass_compare {SOURCE}: forward instances "
          f"{'IDENTICAL' if same_all else 'DIFFERENT'}", flush=True)
    return 0 if same_all else 1


if __name__ == "__main__":
    sys.exit(main())
