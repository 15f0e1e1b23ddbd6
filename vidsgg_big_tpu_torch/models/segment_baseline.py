"""Segment-proposal relation baseline (the MM'17 "VidVRD" baseline).

Port of the JAX package's ``models/segment_baseline.py`` (reference
VidVRD-helper/baseline/model.py:25-286): per 30-frame segment, each ordered
pair of object-trajectory proposals carries a handcrafted relation feature
[sub classeme | obj classeme | 8 x BoW motion blocks | 3 x relative-position
blocks]; a single linear layer predicts predicate scores; the triplet
posterior is a softmax over the *observed training triplets* of
``s_prob * p_score * o_prob``; at test time the top-k (sub, pred, obj)
products of each pair and the top ``seg_topk`` predictions of a segment
survive, which the greedy association (``evaluation/association.py``) links
into video-level relations.

The linear layer is ``torch.nn.functional.linear`` and the top-k cube is
four stable descending sorts, each cut to k: ``jax.lax.top_k`` puts the
lower index first among equal values, and ``torch.topk`` promises no order
among ties, which the association's score sort would then follow.

Weights cross between the packages through ``segment_baseline_weights.npz``
(``kernel`` in flax's (in, out) layout, ``bias``, ``triplet_ids``):
:func:`save_weights` and :func:`load_weights` read and write exactly that
file.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
from torch import nn

WEIGHTS_FILE = "segment_baseline_weights.npz"


@dataclasses.dataclass(frozen=True)
class SegmentBaselineConfig:
    feature_dim: int = 11070      # 70 classeme + 8x1000 BoW + 3x1000 relpos
    num_obj_cats: int = 35        # no-background id space (helper dataset)
    num_pred_cats: int = 132
    block_size: int = 1000        # BoW block width (paper feature: 1000)
    num_motion_blocks: int = 8    # l1-normalized blocks after the classemes
    pair_topk: int = 20
    seg_topk: int = 200
    learning_rate: float = 0.001

    @property
    def classeme_dim(self) -> int:
        return 2 * self.num_obj_cats

    @classmethod
    def from_dict(cls, d: dict):
        return cls(**{k: d[k] for k in (
            "feature_dim", "num_obj_cats", "num_pred_cats", "block_size",
            "num_motion_blocks", "pair_topk", "seg_topk", "learning_rate")
            if k in d})


def feature_preprocess(feats: np.ndarray, cfg: SegmentBaselineConfig):
    """L1-normalize the Bag-of-Words motion blocks (reference model.py:25-49).

    Blocks of width ``block_size`` starting after the two classemes are
    normalized to fractions; classeme and relative-position channels pass
    through.  Zero-sum blocks divide by 1 (keras np_utils.normalize
    convention).
    """
    feats = np.array(feats, np.float32, copy=True)
    start = cfg.classeme_dim
    for i in range(cfg.num_motion_blocks):
        lo = start + i * cfg.block_size
        block = feats[:, lo: lo + cfg.block_size]
        norm = np.abs(block).sum(-1, keepdims=True)
        norm[norm == 0] = 1.0
        feats[:, lo: lo + cfg.block_size] = block / norm
    return feats


class SegmentBaseline(nn.Module):
    """Linear predicate head (reference model.py:186-201 ``build_model``):
    keras' Dense defaults, a Glorot-uniform weight and a zero bias, drawn
    from ``generator``."""

    def __init__(self, cfg: SegmentBaselineConfig, generator=None):
        super().__init__()
        self.cfg = cfg
        self.pred_fc = nn.Linear(cfg.feature_dim, cfg.num_pred_cats)
        with torch.no_grad():
            nn.init.xavier_uniform_(self.pred_fc.weight, generator=generator)
            self.pred_fc.bias.zero_()

    def forward(self, feats):
        return self.pred_fc(feats)


def save_weights(path: str, model: SegmentBaseline,
                 triplet_ids: np.ndarray) -> None:
    """Write ``segment_baseline_weights.npz`` as the JAX package does:
    ``kernel`` (in, out), ``bias``, ``triplet_ids``."""
    np.savez(path, kernel=model.pred_fc.weight.detach().cpu().numpy().T,
             bias=model.pred_fc.bias.detach().cpu().numpy(),
             triplet_ids=np.asarray(triplet_ids))


def load_weights(path: str, model: SegmentBaseline) -> np.ndarray:
    """Load a weights file of either package into ``model``; returns its
    ``triplet_ids``."""
    from .transplant import segment_baseline_state_dict_from_jax

    with np.load(path) as w:
        params = {"params": {"pred_fc": {"kernel": w["kernel"],
                                         "bias": w["bias"]}}}
        triplet_ids = w["triplet_ids"]
    sd = segment_baseline_state_dict_from_jax(params)
    model.load_state_dict({k: v.to(model.pred_fc.weight.device)
                           for k, v in sd.items()}, strict=True)
    return triplet_ids


def triplet_log_softmax(p_scores, prob_s, prob_o, triplet_ids):
    """Log-softmax over observed training triplets of s*p*o.

    Reference model.py:168-196: ``SelectionLayer`` gathers the subject prob,
    predicate score, and object prob of every observed triplet and multiplies
    them; training softmaxes over that R-way product.

    Args:
      p_scores: (B, num_pred_cats) raw predicate scores.
      prob_s/prob_o: (B, num_obj_cats) classeme probabilities.
      triplet_ids: (R, 3) int (s_cid, pid, o_cid) of observed triplets.
    Returns (B, R) log-probabilities.
    """
    r = (prob_s[:, triplet_ids[:, 0]] * p_scores[:, triplet_ids[:, 1]] *
         prob_o[:, triplet_ids[:, 2]])
    return torch.log_softmax(r, dim=-1)


def baseline_loss(model: SegmentBaseline, feats, labels, valid, triplet_ids):
    """Categorical cross-entropy over observed triplets (reference
    model.py:218-226), masked for padded rows."""
    cfg = model.cfg
    p = model(feats)
    prob_s = feats[:, :cfg.num_obj_cats]
    prob_o = feats[:, cfg.num_obj_cats: 2 * cfg.num_obj_cats]
    logp = triplet_log_softmax(p, prob_s, prob_o, triplet_ids)
    nll = -torch.take_along_dim(logp, labels[:, None], dim=-1)[:, 0]
    w = valid.to(torch.float32)
    return (nll * w).sum() / torch.clamp(w.sum(), min=1.0)


def build_baseline_train_step(model: SegmentBaseline, optimizer):
    """Returns ``step(feats, labels, valid, triplet_ids) -> loss``: the loss,
    its gradient and one optimizer update.

    The trainer passes ``torch.optim.Adam(model.parameters(),
    lr=cfg.learning_rate)``: at its defaults (betas 0.9 / 0.999, eps 1e-8,
    no weight decay, no clip) it computes ``optax.adam``'s update, the JAX
    trainer's optimizer, up to rounding.
    """

    def step(feats, labels, valid, triplet_ids):
        optimizer.zero_grad(set_to_none=True)
        loss = baseline_loss(model, feats, labels, valid, triplet_ids)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def _top_k(x, k: int):
    """``jax.lax.top_k`` over the last axis: values and indices of the k
    largest, the lower index first among equal values."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


@torch.no_grad()
def predict_segment_pairs(model: SegmentBaseline, feats,
                          valid) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top ``seg_topk`` short-term relation predictions for one segment.

    Vectorized form of reference model.py:259-280: for each pair, the top
    ``pair_topk`` subject/predicate/object scores form a k^3 product cube
    whose top ``pair_topk`` entries survive; all pairs' candidates are then
    globally cut to ``seg_topk`` by score.

    Args:
      feats: (P, D) preprocessed pair features (padded rows allowed), on
        the model's device.
      valid: (P,) bool row validity.
    Returns:
      scores: (n_out,) float; -inf on padding; n_out = min(seg_topk, P k).
      sto: (n_out, 4) int64 columns (s_cid, pid, o_cid, pair_row).
    """
    cfg = model.cfg
    k = min(cfg.pair_topk, cfg.num_obj_cats, cfg.num_pred_cats)
    p = model(feats)                                     # (P, R_pred)
    s = feats[:, :cfg.num_obj_cats]
    o = feats[:, cfg.num_obj_cats: 2 * cfg.num_obj_cats]
    ts, is_ = _top_k(s, k)                               # (P, k)
    tp, ip = _top_k(p, k)
    to, io = _top_k(o, k)
    cube = (ts[:, :, None, None] * tp[:, None, :, None] *
            to[:, None, None, :]).reshape(-1, k * k * k)  # (P, k^3)
    top_sc, flat = _top_k(cube, k)                       # (P, k)
    si, rem = flat // (k * k), flat % (k * k)
    pi, oi = rem // k, rem % k
    s_cid = torch.take_along_dim(is_, si, dim=-1)        # (P, k)
    p_cid = torch.take_along_dim(ip, pi, dim=-1)
    o_cid = torch.take_along_dim(io, oi, dim=-1)
    pair_row = torch.arange(feats.shape[0], device=feats.device)[
        :, None].expand(top_sc.shape)

    top_sc = torch.where(valid[:, None], top_sc, -torch.inf)
    n_out = min(cfg.seg_topk, top_sc.numel())
    flat_sc, order = _top_k(top_sc.reshape(-1), n_out)
    sto = torch.stack([x.reshape(-1)[order]
                       for x in (s_cid, p_cid, o_cid, pair_row)], dim=-1)
    return flat_sc, sto


def predictions_to_host(scores, sto, pairs) -> list:
    """Convert one segment's device predictions into association-stage tuples
    ``(score, (s_cid, pid, o_cid), (s_traj_idx, o_traj_idx))``."""
    scores, sto = scores.cpu().numpy(), sto.cpu().numpy()
    out = []
    for sc, (s_cid, pid, o_cid, row) in zip(scores, sto):
        if not np.isfinite(sc):
            continue
        t1, t2 = pairs[int(row)]
        out.append((float(sc), (int(s_cid), int(pid), int(o_cid)),
                    (int(t1), int(t2))))
    return out


def sample_positive_pairs(pairs: np.ndarray, iou: np.ndarray,
                          trackid: np.ndarray, gt_insts: list,
                          rng: np.random.Generator, sample_num: int,
                          triplet_index: dict, iou_thres: float = 0.5
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Sample positive (pair_row, triplet_label) training examples.

    Reference model.py:142-165 (``_data_sampling``): a proposal pair is a
    positive for GT relation (tid1, tid2, s, p, o) when both proposals have
    IoU >= ``iou_thres`` with the respective GT trajectories.  ``rng`` is
    drawn from as the JAX package draws (one ``choice``), so one seed gives
    both packages the same samples.

    Args:
      pairs: (P, 2) proposal-index pairs.
      iou: (n_traj, n_traj) segment trajectory IoU (proposals + GT columns).
      trackid: (n_traj,) GT track ids (-1 = proposal).
      gt_insts: list of (tid1, tid2, s_cid, pid, o_cid) for this segment.
      triplet_index: (s, p, o) -> observed-triplet label id.
    """
    pair_to_row = {(int(a), int(b)): i for i, (a, b) in enumerate(pairs)}
    tid_to_ind = {int(t): i for i, t in enumerate(trackid) if t >= 0}
    pos = []
    for tid1, tid2, s, p, o in gt_insts:
        if tid1 not in tid_to_ind or tid2 not in tid_to_ind:
            continue
        key = (s, p, o)
        if key not in triplet_index:
            continue
        inds1 = np.where(iou[:, tid_to_ind[tid1]] >= iou_thres)[0]
        inds2 = np.where(iou[:, tid_to_ind[tid2]] >= iou_thres)[0]
        for t1 in inds1:
            for t2 in inds2:
                if t1 != t2 and (int(t1), int(t2)) in pair_to_row:
                    pos.append((pair_to_row[(int(t1), int(t2))],
                                triplet_index[key]))
    if not pos:
        return (np.zeros((0,), np.int64), np.zeros((0,), np.int64))
    pos = np.asarray(pos, np.int64)
    take = min(len(pos), sample_num)
    sel = rng.choice(len(pos), take, replace=False)
    return pos[sel, 0], pos[sel, 1]
