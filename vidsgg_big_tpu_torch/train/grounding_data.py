"""Grounding-stage query construction at test time.

A copy of ``prepare_grounding_queries`` in the JAX package's
``train/grounding_data.py``; the training-side ground-truth preparation
comes with grounding training.
"""
from __future__ import annotations

import numpy as np


def prepare_grounding_queries(quintuples, dura_inters, valid, video_len):
    """Test-time query construction from stage-1 triplets (already unique).

    quintuples: (M, 5) [pred, s_cat, o_cat, s_tid, o_tid]; dura_inters:
    (M, 2) closed; returns (query_cats (M, 3) [s_cat, pred, o_cat],
    temporal (M, 2) normalised by ``video_len``, query_mask = ``valid``).
    Numpy, on the host: the stage-B eval loop calls it per video.
    """
    q = np.asarray(quintuples)
    query_cats = np.stack([q[:, 1], q[:, 0], q[:, 2]], axis=-1)
    temporal = np.asarray(dura_inters, np.float32) / np.float32(video_len)
    return query_cats, temporal, valid
