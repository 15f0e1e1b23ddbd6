"""Fixed-shape triplet construction (inference post-processing), batched.

Port of the JAX package's ``models/triplets.py`` (reference
models/model_0v10.py:707-785): top-k predicate scores per query,
subject/object selection by adjacency argmax, overlap filtering, exact
dedup of (pred_cat, subj_cat, obj_cat, subj_tid, obj_tid) quintuples keeping
the max-score copy, and background removal, as masked tensor ops with a
static output of ``num_querys * topk`` candidates per video.  The JAX
version runs on one video under ``vmap``; this one takes the batch axis.
"""
from __future__ import annotations

import dataclasses

import torch

from ..ops.temporal import dura_intersection
from ..ops.segments import pack_rows, unique_max


@dataclasses.dataclass
class Triplets:
    """Padded candidate triplets (M = Q * topk slots per video)."""
    quintuples: torch.Tensor   # (B, M, 5) [pred_cat, s_cat, o_cat, s_tid, o_tid]
    scores: torch.Tensor       # (B, M, 3) [pred_score, s_score, o_score]
    dura_inters: torch.Tensor  # (B, M, 2) closed subject∩object duration
    query_ids: torch.Tensor    # (B, M) originating query
    valid: torch.Tensor        # (B, M) bool

    def numpy(self) -> "Triplets":
        """The same triplets as host numpy arrays."""
        return Triplets(**{f.name: getattr(self, f.name).cpu().numpy()
                           for f in dataclasses.fields(self)})

    def video(self, i: int) -> "Triplets":
        """Video ``i`` of the batch (leaves lose the batch axis)."""
        return Triplets(**{f.name: getattr(self, f.name)[i]
                           for f in dataclasses.fields(self)})


def construct_triplets(pred_logits, att, durations, scores, cat_ids,
                       traj_mask, topk: int, num_enti_cats: int,
                       num_pred_cats: int) -> Triplets:
    """Batched triplet construction.

    Args:
      pred_logits: (B, Q, C) predicate logits.
      att: (B, 2, Q, N) soft adjacency (entity softmax already masked).
      durations: (B, N, 2) closed per-tracklet durations.
      scores: (B, N) tracklet confidence.
      cat_ids: (B, N) tracklet categories.
      traj_mask: (B, N) validity.
      topk: predicates kept per query.
    """
    bsz, q, _ = pred_logits.shape
    n = durations.shape[1]
    m = q * topk
    dev = pred_logits.device

    probs = torch.exp(pred_logits - pred_logits.amax(-1, keepdim=True))
    probs = probs / probs.sum(-1, keepdim=True)
    # a stable descending sort gives jax.lax.top_k's tie order (lowest
    # index first); torch.topk promises no order among ties
    top_scores, top_cats = torch.sort(probs, dim=-1, descending=True,
                                      stable=True)
    pred_scores = top_scores[..., :topk].reshape(bsz, m)
    pred_catids = top_cats[..., :topk].reshape(bsz, m).to(torch.int32)
    query_ids = torch.arange(q, dtype=torch.int32, device=dev).repeat_interleave(
        topk)[None].expand(bsz, m)

    pred2so = torch.argmax(att, dim=-1).transpose(1, 2)       # (B, Q, 2)
    pred2so = pred2so.repeat_interleave(topk, dim=1)          # (B, M, 2)

    inters, overlap = dura_intersection(durations, durations)  # (B, N, N, .)
    eye = torch.eye(n, dtype=torch.bool, device=dev)
    pair_ok = overlap & ~eye & traj_mask[:, :, None] & traj_mask[:, None, :]
    rows = torch.arange(bsz, device=dev)[:, None]
    s_id, o_id = pred2so[..., 0], pred2so[..., 1]
    cand_ok = pair_ok[rows, s_id, o_id]                       # (B, M)

    so_cats = torch.gather(cat_ids.long(), 1, pred2so.reshape(bsz, -1)
                           ).reshape(bsz, m, 2)
    quint = torch.cat([pred_catids[..., None].long(), so_cats, pred2so],
                      dim=-1).to(torch.int32)                 # (B, M, 5)
    so_scores = torch.gather(scores, 1, pred2so.reshape(bsz, -1)
                             ).reshape(bsz, m, 2)
    trip_scores = torch.cat([pred_scores[..., None], so_scores], dim=-1)

    keys = pack_rows(quint, [num_pred_cats, num_enti_cats, num_enti_cats,
                             n, n])
    # dedup by max *predicate* score per quintuple (reference
    # model_0v10.py:761)
    keep = unique_max(keys, pred_scores, cand_ok)
    valid = keep & (quint[..., 0] != 0)

    dura_inters = inters[rows, s_id, o_id]                    # (B, M, 2)
    return Triplets(quintuples=quint, scores=trip_scores,
                    dura_inters=dura_inters, query_ids=query_ids,
                    valid=valid)

