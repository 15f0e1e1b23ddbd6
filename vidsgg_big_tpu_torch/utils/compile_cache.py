"""Where the built kernel libraries are kept.

The JAX package's ``utils/compile_cache.py`` points JAX's persistent
compilation cache at a directory.  The port compiles no program at run
time but its kernels: each ``csrc/*.cu`` is built once with ``nvcc`` into a
library named by a hash of its source and flags (``ops/build.py``), so a
kept directory is what lets a later process start without building.  This
is the knob for that directory.
"""
from __future__ import annotations

import os
from pathlib import Path

# the counterpart of JAX_COMPILATION_CACHE_DIR
ENV_VAR = "VIDSGG_TORCH_KERNEL_CACHE_DIR"


def enable_compilation_cache(cache_dir: str | None = None) -> bool:
    """Point ``ops/build``'s kernel directory at ``cache_dir``, or else at
    ``$VIDSGG_TORCH_KERNEL_CACHE_DIR``; with neither the default
    (``build/vidsgg_big_tpu_torch`` at the root of the checkout) stays.
    Returns whether the directory was moved.  A library already loaded in
    this process stays loaded; later builds and loads use the new
    directory, where the hash in each name keeps stale builds apart."""
    from ..ops import build

    path = cache_dir or os.environ.get(ENV_VAR)
    if not path:
        return False
    os.makedirs(path, exist_ok=True)
    build.BUILD_DIR = Path(path).resolve()
    return True
