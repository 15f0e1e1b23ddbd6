"""Volumetric (per-frame) trajectory IoU, batched over videos.

Port of the JAX package's ``ops/boxes.py`` (``box_areas_xyxy`` :22,
``_pairwise_frame_inter`` :27, ``viou_matrix`` :51, ``viou_matrix_grid``
:108; reference utils/utils_func.py:437-490).  Every function takes any
leading batch dimensions (the JAX package ``vmap``s over videos) and
computes in float32 whatever the input dtype.

Conventions:
  * boxes are stored *relative* to their trajectory: ``boxes[i, k]`` is the
    xyxy box of trajectory i at absolute frame ``dura[i, 0] + k``; frames past
    the trajectory length are zero padding.
  * durations are closed intervals [start, end] of absolute frame ids.
  * box area uses the detection convention ``(x2 - x1 + 1) * (y2 - y1 + 1)``.

``viou_matrix_grid`` keeps the grid semantics of the JAX version exactly
(both sets placed on one absolute frame grid of ``t_abs`` frames that starts
at the earliest valid start) without building the grid: each pair's
intersection runs over a window of at most ``min(T1, T2)`` frames, so the
largest intermediate is (..., N, M, min(T1, T2)) instead of (..., N, M,
t_abs, 4).
"""
from __future__ import annotations

import torch


def box_areas_xyxy(boxes):
    """Area of xyxy boxes with the +1 convention.  boxes: (..., 4)."""
    return (boxes[..., 2] - boxes[..., 0] + 1.0) * \
        (boxes[..., 3] - boxes[..., 1] + 1.0)


def _pairwise_frame_inter(b1, b2):
    """Intersection area of aligned per-frame boxes.  b1, b2: (..., 4)."""
    lt = torch.maximum(b1[..., :2], b2[..., :2])
    rb = torch.minimum(b1[..., 2:], b2[..., 2:])
    wh = torch.clamp(rb - lt + 1.0, min=0.0)
    return wh[..., 0] * wh[..., 1]


def _frame_areas(boxes, dura):
    """(..., N) total box area over each trajectory's own frames (its
    duration, capped at the stored frames)."""
    t = boxes.shape[-2]
    length = dura[..., 1] - dura[..., 0] + 1
    fmask = torch.arange(t, device=boxes.device) < length[..., None]
    return (box_areas_xyxy(boxes) * fmask).sum(-1)


def _window_inter(boxes1, boxes2, w1, w2, width):
    """sum_k inter(boxes1[i, w1[i, j] + k], boxes2[j, w2[i, j] + k]) over
    k < width[i, j]: (..., N, M).  boxes (..., N|M, T, 4); w1, w2, width
    (..., N, M) integer; indices past the stored frames are masked."""
    t1, t2 = boxes1.shape[-2], boxes2.shape[-2]
    tw = min(t1, t2)
    k = torch.arange(tw, device=boxes1.device)
    kmask = k < width[..., None]                              # (.., N, M, Tw)
    i1 = (w1[..., None] + k).clamp(0, t1 - 1)
    i2 = (w2[..., None] + k).clamp(0, t2 - 1)
    lead = boxes1.shape[:-3]
    n, m = boxes1.shape[-3], boxes2.shape[-3]

    def take(boxes, idx, axis):
        # boxes (..., K, T, 4) -> (..., N, M, Tw, 4) at idx along T
        b = boxes.unsqueeze(axis).expand(*lead, n, m, *boxes.shape[-2:])
        return torch.gather(b, -2, idx[..., None].expand(*idx.shape, 4))

    g1 = take(boxes1, i1, -3)
    g2 = take(boxes2, i2, -4)
    return (_pairwise_frame_inter(g1, g2) * kmask).sum(-1)


def _finish(inter, area1, area2, dura1, dura2, valid1, valid2):
    denom = area1[..., :, None] + area2[..., None, :] - inter
    v = torch.where(denom > 0, inter / denom, torch.zeros_like(inter))
    overlap = (torch.minimum(dura1[..., :, None, 1], dura2[..., None, :, 1])
               >= torch.maximum(dura1[..., :, None, 0],
                                dura2[..., None, :, 0]))
    v = torch.where(overlap, v, torch.zeros_like(v))
    if valid1 is not None:
        v = torch.where(valid1[..., :, None], v, torch.zeros_like(v))
    if valid2 is not None:
        v = torch.where(valid2[..., None, :], v, torch.zeros_like(v))
    return v


@torch.no_grad()
def viou_matrix(boxes1, dura1, boxes2, dura2, valid1=None, valid2=None):
    """All-pairs volumetric IoU between two sets of trajectories.

    Args:
      boxes1: (..., N, T1, 4) relative per-frame boxes (zero padded).
      dura1:  (..., N, 2) closed absolute [start, end].
      boxes2: (..., M, T2, 4).
      dura2:  (..., M, 2).
      valid1/valid2: optional (..., N)/(..., M) bool validity masks.

    Returns:
      (..., N, M) float32 vIoU, 0 where durations don't overlap or either
      trajectory is padding.  The intersection window of a pair is the
      overlap of their durations, read at frame indices clamped to the
      stored frames (the JAX version's gathers); the denominator covers each
      trajectory's full duration.
    """
    boxes1, boxes2 = boxes1.float(), boxes2.float()
    dura1, dura2 = dura1.long(), dura2.long()
    area1, area2 = _frame_areas(boxes1, dura1), _frame_areas(boxes2, dura2)
    s1, s2 = dura1[..., :, None, 0], dura2[..., None, :, 0]
    inter_s = torch.maximum(s1, s2)
    inter_len = torch.minimum(dura1[..., :, None, 1],
                              dura2[..., None, :, 1]) - inter_s + 1
    inter = _window_inter(boxes1, boxes2, (inter_s - s1).clamp(min=0),
                          (inter_s - s2).clamp(min=0), inter_len)
    return _finish(inter, area1, area2, dura1, dura2, valid1, valid2)


@torch.no_grad()
def viou_matrix_grid(boxes1, dura1, boxes2, dura2, valid1=None, valid2=None,
                     t_abs: int = 1024):
    """All-pairs vIoU with the JAX ``viou_matrix_grid``'s semantics.

    That version places every trajectory on a shared absolute grid of
    ``t_abs`` frames starting at ``shift``, the earliest start among the
    valid trajectories of both sets (padding starts are excluded), at offset
    ``clip(start - shift, 0, t_abs)``, with its stored frames masked to its
    duration; frames at grid positions >= ``t_abs`` drop out of the
    intersection.  Here each pair's grid overlap is computed directly: its
    window starts at the later offset and ends at the earliest of the two
    masked ends and ``t_abs``.  Areas, the duration-overlap test and the
    validity masks are as in :func:`viou_matrix`.

    Args: as :func:`viou_matrix`, plus ``t_abs``, the grid length (pick it
    >= the video-length bound of the data).
    Returns: (..., N, M) float32.
    """
    boxes1, boxes2 = boxes1.float(), boxes2.float()
    dura1, dura2 = dura1.long(), dura2.long()
    t1, t2 = boxes1.shape[-2], boxes2.shape[-2]
    area1, area2 = _frame_areas(boxes1, dura1), _frame_areas(boxes2, dura2)

    starts = torch.cat([dura1[..., 0], dura2[..., 0]], dim=-1)
    if valid1 is not None or valid2 is not None:
        v = torch.cat([
            valid1 if valid1 is not None else
            torch.ones_like(dura1[..., 0], dtype=torch.bool),
            valid2 if valid2 is not None else
            torch.ones_like(dura2[..., 0], dtype=torch.bool)], dim=-1)
        starts = torch.where(v, starts, torch.full_like(
            starts, torch.iinfo(torch.int32).max))
    shift = starts.amin(-1, keepdim=True)

    def placed(dura, t):
        """Grid offset and end (exclusive) of each trajectory's masked
        frames: [off, off + min(len, t))."""
        off = (dura[..., 0] - shift).clamp(0, t_abs)
        length = (dura[..., 1] - dura[..., 0] + 1).clamp(0, t)
        return off, off + length

    off1, end1 = placed(dura1, t1)
    off2, end2 = placed(dura2, t2)
    lo = torch.maximum(off1[..., :, None], off2[..., None, :])
    hi = torch.minimum(torch.minimum(end1[..., :, None], end2[..., None, :]),
                       torch.full_like(lo, t_abs))
    inter = _window_inter(boxes1, boxes2, lo - off1[..., :, None],
                          lo - off2[..., None, :], hi - lo)
    return _finish(inter, area1, area2, dura1, dura2, valid1, valid2)
