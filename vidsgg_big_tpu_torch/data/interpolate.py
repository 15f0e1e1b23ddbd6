"""Gap-filling linear interpolation for fragmented tracklets.

A copy of the JAX package's ``data/interpolate.py`` (reference
utils/utils_func.py:274-317): tracklets may miss frames; gaps are filled by
linear interpolation between the bracketing frames.
"""
from __future__ import annotations

import numpy as np


def fill_zeropadding(vectors: np.ndarray) -> None:
    """Replace all-zero rows by a neighboring row, in place."""
    mask0 = vectors == 0
    index0 = np.where(np.all(mask0, axis=-1))[0]
    if index0.size == 0:
        return
    if not np.all(np.diff(index0) > 1):
        raise ValueError(f"adjacent all-zero rows: index0={index0}")
    index_neighbor = index0 - 1
    index_neighbor[index_neighbor == -1] = 1
    vectors[index0] = vectors[index_neighbor]


def linear_interpolation(vectors: np.ndarray, frame_ids) -> np.ndarray:
    """Fill frame gaps: rows at frame_ids -> contiguous rows over
    [min(frame_ids), max(frame_ids)]."""
    if vectors.ndim != 2:
        raise ValueError(f"vectors must be 2-D, not {vectors.shape}")
    frame_ids = np.asarray(frame_ids)
    cut_point = np.where(np.diff(frame_ids) > 1)[0] + 1
    consec_frames = np.split(frame_ids, cut_point)
    consec_vectors = np.split(vectors, cut_point, axis=0)

    result = []
    for i in range(1, len(consec_frames)):
        left_vector = consec_vectors[i - 1][-1]
        right_vector = consec_vectors[i][0]
        left = consec_frames[i - 1][-1]
        right = consec_frames[i][0]
        # int(): mega/vidor rows carry float frame ids
        inter_len = int(right - left - 1)
        inter = np.linspace(left_vector, right_vector, num=inter_len + 2,
                            axis=0)[1:-1]
        result.append(consec_vectors[i - 1])
        result.append(inter)
    result.append(consec_vectors[-1])
    return np.concatenate(result, axis=0)
