"""Grounding-stage train and inference steps.

Port of the JAX package's ``train/grounding_steps.py``: the training loss
(positive and negative query slots through one forward), the train step
(loss, backward, clip, Adam) and the inference step (forward in eval mode,
then the test-time decode over the batch axis).
"""
from __future__ import annotations

import torch

from ..models.grounding import (GroundingModel, grounding_decode,
                                grounding_gt_labels, grounding_loss)
from .grounding_data import prepare_grounding_gt
from .train_state import TrainState


def grounding_train_loss(model: GroundingModel, video_feats, clip_mask,
                         n_clips, gts, video_len, generator=None, noise=None):
    """Full grounding loss of a batch: (total, {term: value}).

    video_feats (B, T, D); gts a batched ``GraphBatch`` of tensors;
    ``generator`` feeds the negative sampling (unless ``noise``, the (B, P,
    C) Gumbel draw, is given) and the model's train-mode dropouts.  One
    forward runs the [positive ++ negative] query slots, as the reference's
    ``torch.cat`` (reference grd_model_v5.py:302) and the JAX package
    (grounding_steps.py:34-43); queries are row-independent, so the split
    outputs equal two separate forwards.
    """
    cfg = model.cfg
    prep = prepare_grounding_gt(gts, video_len, cfg.num_pred_cats,
                                noise=noise, generator=generator)
    t = video_feats.shape[1]
    p = prep["query_cats"].shape[1]
    cats2 = torch.cat([prep["query_cats"], prep["neg_query_cats"]], dim=1)
    temp2 = torch.cat([prep["temporal"]] * 2, dim=1)
    qm2 = torch.cat([prep["query_mask"]] * 2, dim=1)
    regrs, conf, cls = model(video_feats, clip_mask, cats2, temp2, qm2,
                             generator=generator)
    out = (regrs[:, :p], conf[:, :p], cls[:, :p])
    neg_out = (regrs[:, p:], conf[:, p:], cls[:, p:])
    labels = grounding_gt_labels(prep["target"], n_clips, t, cfg.num_bins)
    return grounding_loss(out, neg_out, labels, prep["group_rep"],
                          prep["is_rep"], prep["query_mask"], clip_mask, cfg)


def build_grounding_train_step(model: GroundingModel, state: TrainState):
    """Returns ``step(video_feats, clip_mask, n_clips, gts, video_len,
    generator, noise=None) -> {term: detached tensor, "total": ...}``: loss,
    backward, global-norm clip and one Adam update of ``state`` (which owns
    ``model``).  The model is put in train mode; on the card the combined
    encoder's attention launches the composed forward and backward kernels
    once each per step wherever its gate engages."""
    model.train()

    def step(video_feats, clip_mask, n_clips, gts, video_len, generator=None,
             noise=None):
        total, terms = grounding_train_loss(
            model, video_feats, clip_mask, n_clips, gts, video_len,
            generator=generator, noise=noise)
        total.backward()
        state.apply_gradients()
        return {k: v.detach() for k, v in dict(terms, total=total).items()}

    return step


def build_grounding_infer_step(model: GroundingModel, *, score_th, tiou_th,
                               bins_th, nms_th):
    """Returns infer(video_feats (B,T,D), clip_mask, n_clips (B,),
    query_cats (B,Q,3), temporal (B,Q,2), query_mask) -> (pooled (B,Q,K+1,2),
    bins_probs (B,Q,K+1), bins_mask (B,Q,K+1)), tensors on the model's
    device.  The model is put in eval mode, so the combined encoder's
    attention runs the CUDA kernel on the card wherever its gate engages.
    """
    model.eval()

    @torch.inference_mode()
    def infer(video_feats, clip_mask, n_clips, query_cats, temporal,
              query_mask):
        regrs, conf, cls = model(video_feats, clip_mask, query_cats,
                                 temporal, query_mask)
        return grounding_decode(regrs, conf, cls, temporal, n_clips,
                                clip_mask, query_mask, score_th=score_th,
                                tiou_th=tiou_th, bins_th=bins_th,
                                nms_th=nms_th)

    return infer
