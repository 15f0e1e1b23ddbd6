"""ctypes bindings of the port's host packer (``csrc/packer.cpp``).

Counterpart of the JAX package's ``data/native.py``, with one difference:
the library is built with ``g++`` at first use (``ops/build.build_host``,
into ``build/vidsgg_big_tpu_torch/``), and a failed build raises instead of
falling back to numpy.  The numpy versions stay as the plain versions the
tests compare with (``ops/segments.stretch_index_np``,
:func:`group_tracklet_rows_np`).  Batches are packed with numpy
(``data/types.pad_pack``), as the JAX package packs them: slice assignment
is already copy-bound, and the library's ``pad_pack`` / ``stretch_pack``
(bound here, held against numpy by the tests) need one contiguous source
buffer.
"""
from __future__ import annotations

import ctypes

import numpy as np

from ..ops import build

_LIB = None
_I32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_I64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_F32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")


def load() -> ctypes.CDLL:
    """The packer library with its signatures declared; built first if
    needed.  Raises where it cannot be built or loaded."""
    global _LIB
    if _LIB is None:
        lib = build.load_host("packer")
        lib.stretch_index.argtypes = [_I32, ctypes.c_int64, ctypes.c_int64,
                                      _I32]
        lib.stretch_index.restype = None
        for fn in (lib.pad_pack, lib.stretch_pack):
            fn.argtypes = [_F32, _I64, _I32, ctypes.c_int64, ctypes.c_int64,
                           ctypes.c_int64, _F32]
            fn.restype = None
        lib.group_tracklet_rows.argtypes = [
            _F32, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, _I32, _I64,
            _I32]
        lib.group_tracklet_rows.restype = ctypes.c_int64
        _LIB = lib
    return _LIB


def stretch_index(lengths, t: int) -> np.ndarray:
    """(n, t) int32 repeat-padding gather index (the library's; plain
    version ``ops/segments.stretch_index_np``)."""
    lengths = np.ascontiguousarray(lengths, np.int32)
    out = np.empty((lengths.shape[0], t), np.int32)
    load().stretch_index(lengths, lengths.shape[0], t, out)
    return out


def group_tracklet_rows(rows: np.ndarray, max_trajs: int = 4096):
    """rows: (R, C) numeric array with columns [fid, tid, ...].

    Returns (order (R,) int32, traj_offsets (n+1,) int64, traj_tids (n,)
    int32): row indices sorted by (tid, fid) and per-trajectory segments.
    The ids are read as float32, as the JAX package's library reads them.
    """
    rows32 = np.ascontiguousarray(rows, np.float32)
    order = np.empty(rows.shape[0], np.int32)
    off = np.empty(max_trajs + 1, np.int64)
    tids = np.empty(max_trajs, np.int32)
    n = load().group_tracklet_rows(rows32, rows.shape[0], rows.shape[1],
                                   max_trajs, order, off, tids)
    if n < 0:
        raise ValueError(f"more than max_trajs={max_trajs} tracklets")
    return order, off[:n + 1], tids[:n]


def group_tracklet_rows_np(rows: np.ndarray):
    """The numpy plain version of :func:`group_tracklet_rows`."""
    rows32 = np.asarray(rows, np.float32)
    if rows32.shape[0] == 0:
        return (np.zeros(0, np.int32), np.zeros(1, np.int64),
                np.zeros(0, np.int32))
    tid = rows32[:, 1].astype(np.int64)
    fid = rows32[:, 0].astype(np.int64)
    order = np.lexsort((fid, tid)).astype(np.int32)
    st = tid[order]
    starts = np.flatnonzero(np.concatenate([[True], st[1:] != st[:-1]]))
    off = np.concatenate([starts, [rows.shape[0]]]).astype(np.int64)
    return order, off, st[starts].astype(np.int32)

