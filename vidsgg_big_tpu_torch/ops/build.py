"""Build the port's CUDA kernels with ``nvcc``, and its host library with
``g++``, at first use and load them.

Each ``csrc/*.cu`` file has a plain C interface and is compiled on its own
into a shared library loaded with ``ctypes`` (no PyTorch headers, so a build
takes seconds).  Libraries go to ``build/vidsgg_big_tpu_torch/`` at the root
of the checkout, named by a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source is rebuilt and an
unchanged one is reused.  Nothing here runs at
import time: the CPU-only test host has no ``nvcc``.  The host packer
(``csrc/packer.cpp``, :data:`HOST_LIBRARIES`) is plain C++ built with
``g++`` the same way, on any host; a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
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
           "composed_attn": CSRC_DIR / "composed_attn.cu",
           "composed_attn_bwd": CSRC_DIR / "composed_attn_bwd.cu"}

# host libraries (plain C++, no CUDA), by library name
HOST_LIBRARIES = {"packer": CSRC_DIR / "packer.cpp"}
GXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

_loaded: dict = {}


def cuda_tool(name: str = "nvcc") -> str:
    """Path of a CUDA toolkit program (nvcc, cuobjdump)."""
    path = shutil.which(name)
    if path is None and os.path.exists(f"/usr/local/cuda/bin/{name}"):
        path = f"/usr/local/cuda/bin/{name}"
    if path is None:
        raise RuntimeError(f"{name} not found: the CUDA kernels are built on "
                           "a host with the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    if name in HOST_LIBRARIES:
        digest = hashlib.sha256(HOST_LIBRARIES[name].read_bytes() +
                                " ".join(GXX_FLAGS).encode())
        return BUILD_DIR / f"{name}_{digest.hexdigest()[:16]}.so"
    src = KERNELS[name]
    headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers +
                            " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}_{digest.hexdigest()[:16]}.so"


def nvcc_command(src, out, verbose: bool = False) -> list:
    """The nvcc call that compiles ``src`` into the shared library ``out``
    with the port's flags; ``verbose`` adds ``-Xptxas -v``."""
    return [cuda_tool(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
            "-o", str(out), str(src)]


def compile_library(src, out, verbose: bool = False) -> str:
    """Compile one source (of this checkout or another) into ``out``;
    returns the compiler's output, raises with it on failure."""
    proc = subprocess.run(nvcc_command(src, out, verbose),
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}")
    return proc.stdout


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
        cmd = nvcc_command(KERNELS[name], tmp, verbose)
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


def build_host(name: str, compiler: str = "g++") -> Path:
    """Compile the host library ``name`` (:data:`HOST_LIBRARIES`) with
    ``compiler`` and :data:`GXX_FLAGS` unless it is built; returns its
    path.  A failed build raises with the compiler's output."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [compiler, *GXX_FLAGS, "-o", tmp, str(HOST_LIBRARIES[name])]
    try:
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
    except OSError as e:
        os.unlink(tmp)
        raise RuntimeError(f"cannot run {compiler} to build {name}: {e}")
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{compiler} failed for "
                           f"{HOST_LIBRARIES[name]}:\n{proc.stdout}")
    os.replace(tmp, out)     # atomic: concurrent builds agree
    return out


def load_host(name: str) -> ctypes.CDLL:
    """The host library ``name``, built with g++ first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        lib = _loaded[name] = ctypes.CDLL(str(build_host(name)))
    return lib


def sass(path) -> dict:
    """{kernel: [SASS instructions]} of a built library or cubin
    (``cuobjdump -sass``)."""
    return parse_sass(subprocess.run(
        [cuda_tool("cuobjdump"), "-sass", str(path)], capture_output=True,
        text=True, check=True).stdout)


def parse_sass(text: str) -> dict:
    """{kernel: [instructions]} of ``cuobjdump -sass`` output, kernel names
    as the compiler mangled them, instructions without their offsets and
    encodings."""
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s*(.*?)\s*;", line)
        if name is not None and m:
            out[name].append(m.group(1))
    return out


def ptxas_usage(log: str) -> dict:
    """{kernel: {"registers": n, "spill_stores": bytes, "spill_loads":
    bytes}} from the ``-Xptxas -v`` output of a build."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([^' ]+)'?", line)
        if m:
            name = m.group(1)
            out.setdefault(name, {})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if name is not None and m:
            out[name]["spill_stores"] = int(m.group(1))
            out[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if name is not None and m:
            out[name]["registers"] = int(m.group(1))
    return out
