"""Data contracts: host-side per-video records and fixed-shape batches.

Port of the JAX package's ``data/types.py``:

  * :class:`VideoProposalRecord` / :class:`VideoGTRecord`: plain numpy,
    variable shape, used on the host for data prep and eval conversion.
  * :class:`TrackletBatch` / :class:`GraphBatch`: padded, masked batches of
    one ``(N_bucket, T_bucket)`` shape.  Packing is numpy on the host
    (float32 features, or int8 with a per-video scale); ``.to(device)``
    makes every leaf a tensor on the device, and a low-precision float
    feature dtype is applied there, after the copy.

Boxes are stored relative to each trajectory (frame 0 = trajectory start) and
un-stretched; ``stretch_idx`` carries the reference's repeat-padding gather.
Durations are closed intervals [start, end] of absolute frame ids.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from ..ops.segments import stretch_index_np


# ---------------------------------------------------------------------------
# host-side records (numpy, variable shape)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class VideoProposalRecord:
    """Tracklet proposals of one video (after score clipping to MAX_PROPOSAL)."""
    video_name: str
    video_len: int
    video_wh: Tuple[int, int]
    cat_ids: np.ndarray            # (n,) int32
    scores: np.ndarray             # (n,) float32 (mean per-frame conf)
    durations: np.ndarray          # (n, 2) int32, closed [start, end]
    boxes: List[np.ndarray]        # n arrays, (len_i, 4) float32 xyxy
    features: List[np.ndarray]     # n arrays, (len_i, D) float32

    @property
    def num_proposals(self) -> int:
        return len(self.boxes)

    @property
    def max_frames(self) -> int:
        return max((b.shape[0] for b in self.boxes), default=0)


@dataclasses.dataclass
class VideoGTRecord:
    """Ground-truth scene graph of one video."""
    video_name: str
    video_len: int
    video_wh: Tuple[int, int]
    traj_cat_ids: np.ndarray       # (g,) int32
    traj_durations: np.ndarray     # (g, 2) int32 closed
    traj_boxes: List[np.ndarray]   # g arrays, (len_i, 4) float32
    pred_cat_ids: np.ndarray       # (p,) int32
    pred_durations: np.ndarray     # (p, 2) float32 closed
    adj: np.ndarray                # (2, p, g) float32 one-hot (subj, obj)

    @property
    def num_trajs(self) -> int:
        return len(self.traj_boxes)

    @property
    def num_preds(self) -> int:
        return int(self.pred_cat_ids.shape[0])


# ---------------------------------------------------------------------------
# batches (fixed shape, masked)
# ---------------------------------------------------------------------------

class _Batch:
    """Dataclass batch whose leaves are numpy arrays or tensors."""

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)

    def to(self, device, **dtypes):
        """Every leaf as a tensor on ``device``; ``dtypes`` maps a field
        name to the dtype it takes after the copy (e.g. ``feats=
        torch.bfloat16``).  int8 features keep their dtype: their scale is
        per video, so no cast after the copy can make them."""
        out = {}
        for f in dataclasses.fields(self):
            x = torch.as_tensor(getattr(self, f.name)).to(device)
            if f.name in dtypes and x.dtype != torch.int8:
                x = x.to(dtypes[f.name])
            out[f.name] = x
        return type(self)(**out)


@dataclasses.dataclass
class TrackletBatch(_Batch):
    """Padded tracklet proposals.  Leading batch axis optional (stack to add)."""
    feats: np.ndarray        # (N, T, D) raw (un-stretched), 0-padded;
    #                          float32, or int8 x feat_scale
    boxes: np.ndarray        # (N, T, 4) float32, relative frames, 0-padded
    stretch_idx: np.ndarray  # (N, T) int32 repeat-padding gather index
    durations: np.ndarray    # (N, 2) int32 closed absolute
    cat_ids: np.ndarray      # (N,) int32
    scores: np.ndarray       # (N,) float32
    traj_mask: np.ndarray    # (N,) bool
    video_len: np.ndarray    # () int32
    video_wh: np.ndarray     # (2,) float32 (w, h)
    feat_scale: np.ndarray = np.float32(1.0)   # () float32 dequant scale
    #                                            of int8 features


@dataclasses.dataclass
class GraphBatch(_Batch):
    """Padded ground-truth scene graph."""
    traj_cats: np.ndarray       # (G,) int32
    traj_durations: np.ndarray  # (G, 2) int32 closed
    traj_boxes: np.ndarray      # (G, Tg, 4) float32 relative
    traj_mask: np.ndarray       # (G,) bool
    pred_cats: np.ndarray       # (P,) int32
    pred_durations: np.ndarray  # (P, 2) float32 closed
    pred_mask: np.ndarray       # (P,) bool
    adj: np.ndarray             # (2, P, G) float32


def pad_pack(trajs, n_bucket: int, t_bucket: int,
             dtype=np.float32) -> np.ndarray:
    """trajs: list of (L_i, D) arrays -> (n_bucket, t_bucket, D) of
    ``dtype``, zero-padded and truncated to ``t_bucket`` rows."""
    d = trajs[0].shape[1] if trajs else 0
    dst = np.zeros((n_bucket, t_bucket, d), dtype)
    for i, x in enumerate(trajs):
        L = min(x.shape[0], t_bucket)
        dst[i, :L] = x[:L]
    return dst


def quantize_feats(trajs):
    """int8 feature storage (JAX ``data/types.py:162-168``): a per-video
    symmetric absmax scale, round to nearest even, clipped to +-127.
    ``trajs`` are the video's float32 (L_i, D) tracklet features as they
    are packed; the zero padding quantizes to 0 and does not move the
    absmax, so JAX's pass over the padded tensor gives the same bytes.
    Returns ([int8 (L_i, D)], float32 scale)."""
    absmax = max((np.abs(x).max() for x in trajs if x.size),
                 default=np.float32(0.0))
    scale = np.float32(max(absmax / 127.0, 1e-12))
    return [np.clip(np.rint(x / scale), -127, 127).astype(np.int8)
            for x in trajs], scale


def pack_proposal(rec: VideoProposalRecord, n_bucket: int, t_bucket: int,
                  feat_dim: int, dtype=np.float32,
                  feats_out: torch.Tensor | None = None) -> TrackletBatch:
    """Pad one video's proposals into a fixed (N, T) bucket (numpy leaves).

    ``dtype`` float32 or int8 (:func:`quantize_feats`, on the host, since
    the scale is per video); low-precision float storage is a cast after
    the copy (``TrackletBatch.to``), or, with ``feats_out``, the cast into
    it.  ``feats_out`` ((N, T, D) tensor, e.g. a row of a staging slot):
    the features are packed straight into it (cast to its dtype, padding
    zeroed) and it is the batch's ``feats``."""
    n = rec.num_proposals
    if n > n_bucket:
        raise ValueError(f"{rec.video_name}: {n} proposals > bucket "
                         f"{n_bucket}")
    durations = np.zeros((n_bucket, 2), dtype=np.int32)
    cat_ids = np.zeros((n_bucket,), dtype=np.int32)
    scores = np.zeros((n_bucket,), dtype=np.float32)
    mask = np.zeros((n_bucket,), dtype=bool)
    lengths = np.zeros((n_bucket,), dtype=np.int32)
    for i in range(n):
        L = min(rec.boxes[i].shape[0], t_bucket)
        lengths[i] = L
        durations[i] = rec.durations[i]
        # clamp duration if the trajectory was truncated by the bucket
        durations[i, 1] = durations[i, 0] + L - 1
    if np.dtype(dtype) not in (np.float32, np.int8):
        raise ValueError(f"pack_proposal stores float32 or int8 features, "
                         f"not {np.dtype(dtype)}")
    trajs = [np.asarray(f[:t_bucket], np.float32) for f in rec.features]
    feat_scale = np.float32(1.0)
    if np.dtype(dtype) == np.int8:
        trajs, feat_scale = quantize_feats(trajs)
    if n and trajs[0].shape[-1] != feat_dim:
        raise ValueError(f"{rec.video_name}: feature width "
                         f"{trajs[0].shape[-1]} != {feat_dim}")
    if feats_out is not None:
        if tuple(feats_out.shape) != (n_bucket, t_bucket, feat_dim):
            raise ValueError(f"feats_out {tuple(feats_out.shape)} is not "
                             f"{(n_bucket, t_bucket, feat_dim)}")
        for i, x in enumerate(trajs):
            feats_out[i, :x.shape[0]].copy_(torch.from_numpy(x))
            feats_out[i, x.shape[0]:].zero_()
        feats_out[n:].zero_()
        feats = feats_out
    elif n == 0:
        # zero-proposal videos occur in real splits: size the empty arrays
        # from feat_dim, not from the (empty) record
        feats = np.zeros((n_bucket, t_bucket, feat_dim), dtype)
    else:
        feats = pad_pack(trajs, n_bucket, t_bucket, dtype)
    if n == 0:
        boxes = np.zeros((n_bucket, t_bucket, 4), np.float32)
    else:
        boxes = pad_pack([np.asarray(b[:t_bucket, :4], np.float32)
                          for b in rec.boxes], n_bucket, t_bucket)
    cat_ids[:n] = rec.cat_ids
    scores[:n] = rec.scores
    mask[:n] = True
    return TrackletBatch(
        feats=feats, boxes=boxes,
        stretch_idx=stretch_index_np(lengths, t_bucket), durations=durations,
        cat_ids=cat_ids, scores=scores, traj_mask=mask,
        video_len=np.asarray(rec.video_len, np.int32),
        video_wh=np.asarray(rec.video_wh, np.float32),
        feat_scale=np.asarray(feat_scale, np.float32))


def tracklet_leaves(b: int, n: int, t: int, feat_dim: int,
                    feat_dtype: torch.dtype) -> dict:
    """{field: (shape, torch dtype)} of a stacked TrackletBatch of ``b``
    videos at (n, t) with ``feat_dtype`` features."""
    return {"feats": ((b, n, t, feat_dim), feat_dtype),
            "boxes": ((b, n, t, 4), torch.float32),
            "stretch_idx": ((b, n, t), torch.int32),
            "durations": ((b, n, 2), torch.int32),
            "cat_ids": ((b, n), torch.int32),
            "scores": ((b, n), torch.float32),
            "traj_mask": ((b, n), torch.bool),
            "video_len": ((b,), torch.int32),
            "video_wh": ((b, 2), torch.float32),
            "feat_scale": ((b,), torch.float32)}


def graph_leaves(b: int, g: int, tg: int, p: int) -> dict:
    """{field: (shape, torch dtype)} of a stacked GraphBatch of ``b``
    videos at (G=g, Tg=tg, P=p)."""
    return {"traj_cats": ((b, g), torch.int32),
            "traj_durations": ((b, g, 2), torch.int32),
            "traj_boxes": ((b, g, tg, 4), torch.float32),
            "traj_mask": ((b, g), torch.bool),
            "pred_cats": ((b, p), torch.int32),
            "pred_durations": ((b, p, 2), torch.float32),
            "pred_mask": ((b, p), torch.bool),
            "adj": ((b, 2, p, g), torch.float32)}


def pack_gt(rec: VideoGTRecord, g_bucket: int, tg_bucket: int,
            p_bucket: int) -> GraphBatch:
    """Pad one video's GT graph into a fixed (G, Tg, P) bucket.

    ``traj_durations`` keep the TRUE closed GT extents; only the stored
    per-frame boxes are capped at ``tg_bucket``.
    """
    g, p = rec.num_trajs, rec.num_preds
    if g > g_bucket or p > p_bucket:
        raise ValueError(f"{rec.video_name}: GT ({g}, {p}) > bucket "
                         f"({g_bucket}, {p_bucket})")
    traj_boxes = np.zeros((g_bucket, tg_bucket, 4), dtype=np.float32)
    traj_durations = np.zeros((g_bucket, 2), dtype=np.int32)
    traj_cats = np.zeros((g_bucket,), dtype=np.int32)
    traj_mask = np.zeros((g_bucket,), dtype=bool)
    for i in range(g):
        L = min(rec.traj_boxes[i].shape[0], tg_bucket)
        traj_boxes[i, :L] = rec.traj_boxes[i][:L]
        traj_durations[i] = rec.traj_durations[i]
    traj_cats[:g] = rec.traj_cat_ids
    traj_mask[:g] = True

    pred_cats = np.zeros((p_bucket,), dtype=np.int32)
    pred_durations = np.zeros((p_bucket, 2), dtype=np.float32)
    pred_mask = np.zeros((p_bucket,), dtype=bool)
    adj = np.zeros((2, p_bucket, g_bucket), dtype=np.float32)
    pred_cats[:p] = rec.pred_cat_ids
    pred_durations[:p] = rec.pred_durations
    pred_mask[:p] = True
    adj[:, :p, :g] = rec.adj
    return GraphBatch(
        traj_cats=traj_cats, traj_durations=traj_durations,
        traj_boxes=traj_boxes, traj_mask=traj_mask, pred_cats=pred_cats,
        pred_durations=pred_durations, pred_mask=pred_mask, adj=adj)


def stack_batches(items):
    """Stack same-shaped host batches along a new leading batch axis."""
    return type(items[0])(**{
        f.name: np.stack([getattr(x, f.name) for x in items], axis=0)
        for f in dataclasses.fields(items[0])})
