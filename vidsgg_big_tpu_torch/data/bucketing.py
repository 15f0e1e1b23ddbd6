"""Shape bucketing: group videos into a small set of padded shapes.

Port of the JAX package's ``data/bucketing.py``.  Each (N_traj, T_frames)
bucket is one padded batch shape; videos are padded up to their bucket.
Packing is float32 numpy; the feature dtype is applied after the copy to
the device (``TrackletBatch.to``).
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence, Tuple

import numpy as np

from .types import VideoProposalRecord, pack_proposal, pack_gt, stack_batches

DEFAULT_N_LADDER = (8, 16, 32, 64, 128, 192)
DEFAULT_T_LADDER = (32, 64, 128, 256, 512, 1024, 2048, 4096)


def pick(value: int, ladder: Sequence[int]) -> int:
    for x in ladder:
        if value <= x:
            return x
    return ladder[-1]


# the grounding stage's shape ladder (clip counts and unique-triplet counts)
GROUNDING_LADDER = (32, 64, 128, 256, 512, 1024)


def pick_unbounded(value: int,
                   ladder: Sequence[int] = GROUNDING_LADDER) -> int:
    """Smallest ladder bucket holding ``value``; doubles past the top so no
    video is ever truncated."""
    for x in ladder:
        if value <= x:
            return x
    x = ladder[-1]
    while x < value:
        x *= 2
    return x


@dataclasses.dataclass
class BucketSpec:
    n_ladder: Sequence[int] = DEFAULT_N_LADDER
    t_ladder: Sequence[int] = DEFAULT_T_LADDER
    g_bucket: int = 32            # GT trajectories
    tg_bucket: int = 4096         # GT per-frame box storage
    p_bucket: int = 128           # GT predicates
    feat_dim: int = 0

    def bucket_of(self, prop: VideoProposalRecord) -> Tuple[int, int]:
        n = pick(max(prop.num_proposals, 1), self.n_ladder)
        t = pick(max(prop.max_frames, 1), self.t_ladder)
        return n, t


def iter_shuffled(dataset, seed: int = 0):
    """Yield ``dataset[i]`` over ``np.random.default_rng(seed)``'s
    permutation (the JAX package's order for the same seed), loading each
    record at yield time."""
    for i in np.random.default_rng(seed).permutation(len(dataset)):
        yield dataset[int(i)]


def stream_buckets(items: Iterable, key_of, batch_size: int):
    """The streaming bucket grouper: yield ``(key, rows, n_real)``.

    ``rows`` holds ``n_real`` real records followed by repeats of the last
    record padding to a ``batch_size`` multiple (callers mask the repeats).
    Full buckets flush as soon as they fill; at most ``max(8 * batch_size,
    64)`` records wait in partial buckets: when the cap is hit the fullest
    bucket flushes early, padded.  The remainders flush at the end.
    """
    max_pending = max(8 * batch_size, 64)

    def padded(rows):
        n_real = len(rows)
        rows = list(rows)
        while len(rows) % batch_size != 0:
            rows.append(rows[-1])
        return rows, n_real

    groups, pending = {}, 0
    for rec in items:
        key = key_of(rec)
        groups.setdefault(key, []).append(rec)
        pending += 1
        if len(groups[key]) == batch_size:
            yield key, groups.pop(key), batch_size
            pending -= batch_size
        elif pending >= max_pending:
            k2 = max(groups, key=lambda k: len(groups[k]))
            rows, n_real = padded(groups.pop(k2))
            pending -= n_real
            yield k2, rows, n_real
    for key, rows in groups.items():
        rows, n_real = padded(rows)
        for i in range(0, len(rows), batch_size):
            yield key, rows[i:i + batch_size], min(batch_size, n_real - i)


def bucketed_batches(items: Iterable, spec: BucketSpec, batch_size: int,
                     with_gt: bool = True):
    """Yield (bucket_key, [records], TrackletBatch, GraphBatch | None).

    items: iterable of (VideoProposalRecord, VideoGTRecord | None).  Videos
    are grouped per bucket by :func:`stream_buckets`; the repeats that pad a
    batch are fully masked out, so they add nothing to metrics.  Leaves are
    numpy.
    """
    def emit(key, rows, n_real):
        n, t = key[0], key[1]
        props = stack_batches([pack_proposal(r[0], n, t, spec.feat_dim)
                               for r in rows])
        real = np.arange(len(rows)) < n_real
        if n_real < len(rows):
            props = props.replace(traj_mask=props.traj_mask & real[:, None])
        gts = None
        if with_gt and rows[0][1] is not None:
            tg, gb = key[2], key[3]
            gts = stack_batches([pack_gt(r[1], gb, tg, spec.p_bucket)
                                 for r in rows])
            if n_real < len(rows):
                gts = gts.replace(traj_mask=gts.traj_mask & real[:, None],
                                  pred_mask=gts.pred_mask & real[:, None])
        return key, rows[:n_real], props, gts

    def key_of(rec):
        k = spec.bucket_of(rec[0])
        if not with_gt:
            return k
        gt = rec[1]
        # GT buckets ride the key so every batch of a key has one shape:
        # tg covers every GT trajectory, gb grows on crowded videos
        tg = pick_unbounded(max(
            (b.shape[0] for b in gt.traj_boxes), default=1)
            if gt is not None else 1, (spec.tg_bucket,))
        gb = pick_unbounded(
            gt.num_trajs if gt is not None else 1,
            (spec.g_bucket, 2 * spec.g_bucket, 4 * spec.g_bucket))
        return (*k, tg, gb)

    for key, rows, n_real in stream_buckets(items, key_of, batch_size):
        yield emit(key, rows, n_real)
