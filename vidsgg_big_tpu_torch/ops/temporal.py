"""Temporal-interval (duration) algebra on tensors.

Durations are **closed intervals** ``[start, end]`` of frame ids, as in the
JAX package's ``ops/temporal.py``.  Every function takes a leading batch of
any rank before the interval axis.
"""
from __future__ import annotations

import torch


def dura_intersection(dura1, dura2, broadcast: bool = True):
    """Pairwise intersection of closed intervals.

    Args:
      dura1: (..., n1, 2) int/float tensor of [start, end] (closed).
      dura2: (..., n2, 2).
      broadcast: if True return all pairs, else elementwise (n1 == n2).

    Returns:
      (intersection, mask): intersection (..., n1, n2, 2) (or (..., n1, 2)),
      and a bool mask marking pairs that overlap (start <= end).
      Non-overlapping entries hold an inverted interval; callers apply the
      mask.  Mirrors reference utils/utils_func.py:347-373.
    """
    if broadcast:
        inter_s = torch.maximum(dura1[..., :, None, 0], dura2[..., None, :, 0])
        inter_e = torch.minimum(dura1[..., :, None, 1], dura2[..., None, :, 1])
    else:
        inter_s = torch.maximum(dura1[..., 0], dura2[..., 0])
        inter_e = torch.minimum(dura1[..., 1], dura2[..., 1])
    return torch.stack([inter_s, inter_e], dim=-1), inter_s <= inter_e


def tiou(duras1, duras2, broadcast: bool = True):
    """Temporal IoU of closed/real intervals; 0 where disjoint.

    Mirrors reference utils/utils_func.py:375-390 (including the division by
    the union span without +1 correction).
    """
    if broadcast:
        a0, a1 = duras1[..., :, None, 0], duras1[..., :, None, 1]
        b0, b1 = duras2[..., None, :, 0], duras2[..., None, :, 1]
    else:
        a0, a1 = duras1[..., 0], duras1[..., 1]
        b0, b1 = duras2[..., 0], duras2[..., 1]
    mask = (a1 >= b0) & (b1 >= a0)
    t = (torch.minimum(a1, b1) - torch.maximum(a0, b0)) / (
        torch.maximum(a1, b1) - torch.minimum(a0, b0))
    return torch.where(mask, t, torch.zeros_like(t))


def tiou_left_right(lr1, lr2):
    """IoU of (left, right) FCOS-style offsets around a shared anchor point
    (..., 2) (reference models/grd_model_v5.py:10-14)."""
    return (torch.minimum(lr1[..., 1], lr2[..., 1])
            + torch.minimum(lr1[..., 0], lr2[..., 0])) / (
        torch.maximum(lr1[..., 1], lr2[..., 1])
        + torch.maximum(lr1[..., 0], lr2[..., 0]))
