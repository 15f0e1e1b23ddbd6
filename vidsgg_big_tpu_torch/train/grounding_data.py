"""Grounding-stage query construction.

Train path (from GT graphs; reference grd_model_v5.py:253-306): one query
slot per (padded) GT predicate, duplicate-query groups identified by the
(pred, sub_cat, obj_cat, s∩o-duration) tag, and one negative predicate per
unique query, sampled without replacement within each (sub, obj, duration)
group.  Port of ``prepare_grounding_gt`` of the JAX package's
``train/grounding_data.py``, batched over videos instead of ``vmap``.

Test path (from stage-1 triplets; reference grd_model_v5.py:310-328): a copy
of ``prepare_grounding_queries``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.attention import draw_share
from ..ops.segments import pack_rows, unique_max


def _group_structure(keys, valid):
    """keys: (B, P, W) int32.  Returns (is_rep, group_rep) where
    group_rep[b, p] is the index of p's group representative (its first
    valid occurrence)."""
    is_rep = unique_max(keys, torch.zeros(valid.shape, device=keys.device),
                        valid)
    eq = torch.all(keys[:, :, None, :] == keys[:, None, :, :], dim=-1)
    eq = eq & valid[:, :, None] & valid[:, None, :]
    rep_mat = eq & is_rep[:, None, :]
    group_rep = torch.argmax(rep_mat.to(torch.int8), dim=-1)
    group_rep = torch.where(valid, group_rep, 0)
    return is_rep & valid, group_rep


def gumbel_noise(shape, generator=None, device=None):
    """Standard Gumbel noise -log(-log U), U uniform on (0, 1); a
    :class:`~..ops.attention.ShardedDraws` gives this rank's rows of the
    global batch's draw."""
    u = draw_share(generator, shape, lambda s, g: torch.rand(
        s, generator=g, device=device))
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(torch.clamp(u, min=tiny)))


def prepare_grounding_gt(gts, video_len, num_pred_cats: int, noise=None,
                         generator=None):
    """Train-time query construction for a batch of videos.

    Args:
      gts: a batched ``GraphBatch`` of tensors (B, ...).
      video_len: (B,) frame counts.
      noise: (B, P, num_pred_cats) Gumbel noise for the negative sampling
        (the JAX package draws ``jax.random.gumbel(rng, (P, C))`` per
        video); drawn from ``generator`` when None.

    Returns a dict of (B, P, ...) tensors: query_cats (P, 3), neg_query_cats
    (P, 3), temporal (P, 2) and target (P, 2) normalized by the video
    length, is_rep, group_rep, query_mask.
    """
    adj = gts.adj                                               # (B, 2, P, G)
    b, _, p, _ = adj.shape
    dev = adj.device
    pred2so = torch.argmax(adj, dim=-1).transpose(1, 2)          # (B, P, 2)
    take = lambda table: torch.gather(
        table, 1, pred2so.reshape(b, -1, *([1] * (table.dim() - 2))).expand(
            b, 2 * p, *table.shape[2:])).reshape(b, p, 2, *table.shape[2:])
    duras = take(gts.traj_durations)                            # (B,P,2,2)
    inter = torch.stack([torch.maximum(duras[:, :, 0, 0], duras[:, :, 1, 0]),
                         torch.minimum(duras[:, :, 0, 1], duras[:, :, 1, 1])],
                        dim=-1)                                 # (B, P, 2)
    so_cats = take(gts.traj_cats)                               # (B, P, 2)
    pred_cats = gts.pred_cats
    tags = torch.cat([pred_cats[..., None].to(inter.dtype),
                      so_cats.to(inter.dtype), inter], dim=-1)  # (B, P, 5)
    keys = pack_rows(tags, [num_pred_cats, 256, 256, 1 << 15, 1 << 15])
    valid = gts.pred_mask
    is_rep, group_rep = _group_structure(keys, valid)

    query_cats = torch.stack([so_cats[..., 0], pred_cats, so_cats[..., 1]],
                             dim=-1)                            # (B, P, 3)
    vl = video_len.to(torch.float32)[:, None, None]
    temporal = inter.to(torch.float32) / vl
    target = gts.pred_durations.to(torch.float32) / vl

    # negative predicate sampling (reference :285-299)
    so_keys = pack_rows(tags[..., 1:], [256, 256, 1 << 15, 1 << 15])
    _, so_rep = _group_structure(so_keys, valid)
    same_so = torch.all(so_keys[:, :, None, :] == so_keys[:, None, :, :],
                        dim=-1)
    same_so = same_so & valid[:, :, None] & valid[:, None, :]
    # positive predicates of each slot's SO-group
    pred_onehot = F.one_hot(pred_cats.long(), num_pred_cats).bool() & \
        valid[..., None]
    group_pos = torch.einsum("bpq,bqc->bpc", same_so.to(torch.float32),
                             pred_onehot.to(torch.float32)) > 0  # (B, P, C)
    # rank of each representative within its SO-group (unique tags only)
    idx = torch.arange(p, device=dev)
    earlier = same_so & is_rep[:, None, :] & (idx[None, :] < idx[:, None])
    rank = earlier.sum(-1)                                       # (B, P)
    # shared per-SO-group randomness: the SO representative's noise row
    if noise is None:
        noise = gumbel_noise((b, p, num_pred_cats), generator).to(dev)
    noise = torch.gather(noise.to(torch.float32), 1,
                         so_rep[..., None].expand(b, p, num_pred_cats))
    noise = noise.masked_fill(group_pos, -torch.inf)
    order = torch.argsort(-noise, dim=-1, stable=True)           # (B, P, C)
    neg_pred = torch.gather(order, -1, torch.clamp(
        rank, 0, num_pred_cats - 1)[..., None])[..., 0]
    neg_query_cats = query_cats.clone()
    neg_query_cats[..., 1] = neg_pred.to(query_cats.dtype)

    return {
        "query_cats": query_cats,
        "neg_query_cats": neg_query_cats,
        "temporal": temporal,
        "target": target,
        "is_rep": is_rep,
        "group_rep": group_rep,
        "query_mask": valid,
    }


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
