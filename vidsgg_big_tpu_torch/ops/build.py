"""Build the port's CUDA kernels with ``nvcc`` at first use and load them.

Each ``csrc/*.cu`` file has a plain C interface and is compiled on its own
into a shared library loaded with ``ctypes`` (no PyTorch headers, so a build
takes seconds).  Libraries go to ``build/vidsgg_big_tpu_torch/`` at the root
of the checkout, named by a hash of the source and the flags, so an edited
source is rebuilt and an unchanged one is reused.  Nothing here runs at
import time: the CPU-only test host has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "vidsgg_big_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
# every kernel source of the port, by library name
KERNELS = {"role_attn": CSRC_DIR / "role_attn.cu",
           "composed_attn": CSRC_DIR / "composed_attn.cu"}

_loaded: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "host with the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    src = KERNELS[name]
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}_{digest.hexdigest()[:16]}.so"


def build(names=None, verbose: bool = False) -> dict:
    """Compile the named kernels (default: all) that are not built yet.

    One ``nvcc`` per source, all started together.  Returns ``{name:
    compiler output}`` for the sources compiled now; ``verbose`` adds
    ``-Xptxas -v`` (registers, shared memory and spills per kernel).
    """
    names = list(KERNELS) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", tmp, str(KERNELS[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, out)     # atomic: concurrent builds agree
        else:
            os.unlink(tmp)
            failed.append(f"{name}:\n{logs[name]}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return lib
