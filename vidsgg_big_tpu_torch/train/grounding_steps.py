"""Grounding-stage train and inference steps.

Port of the JAX package's ``train/grounding_steps.py``: the training loss
(positive and negative query slots through one forward), the train step
(loss, backward, clip, Adam) and the inference step (forward in eval mode,
then the test-time decode over the batch axis).  Sharded over a mesh's data
ranks (``parallel/``; the grounding model is never split over a model
axis, as in the JAX CLI), a rank runs its rows with the single process's
draws cut to them, and the loss divides by global counts.
"""
from __future__ import annotations

import torch

from ..models.grounding import (GroundingModel, grounding_decode,
                                grounding_gt_labels, grounding_loss)
from ..parallel.mesh import gather_rows
from ..utils.spans import span
from .grounding_data import prepare_grounding_gt
from .steps import step_metrics
from .train_state import TrainState


def grounding_train_loss(model: GroundingModel, video_feats, clip_mask,
                         n_clips, gts, video_len, generator=None, noise=None,
                         mesh=None):
    """Full grounding loss of a batch: (total, {term: value}).

    video_feats (B, T, D); gts a batched ``GraphBatch`` of tensors;
    ``generator`` feeds the negative sampling (unless ``noise``, the (B, P,
    C) Gumbel draw, is given) and the model's train-mode dropouts.  One
    forward runs the [positive ++ negative] query slots, as the reference's
    ``torch.cat`` (reference grd_model_v5.py:302) and the JAX package
    (grounding_steps.py:34-43); queries are row-independent, so the split
    outputs equal two separate forwards.  ``mesh``: the loss's counts are
    summed over its data ranks.
    """
    cfg = model.cfg
    with span("targets"):
        prep = prepare_grounding_gt(gts, video_len, cfg.num_pred_cats,
                                    noise=noise, generator=generator)
    t = video_feats.shape[1]
    p = prep["query_cats"].shape[1]
    cats2 = torch.cat([prep["query_cats"], prep["neg_query_cats"]], dim=1)
    temp2 = torch.cat([prep["temporal"]] * 2, dim=1)
    qm2 = torch.cat([prep["query_mask"]] * 2, dim=1)
    with span("forward"):
        regrs, conf, cls = model(video_feats, clip_mask, cats2, temp2, qm2,
                                 generator=generator)
    out = (regrs[:, :p], conf[:, :p], cls[:, :p])
    neg_out = (regrs[:, p:], conf[:, p:], cls[:, p:])
    with span("loss"):
        labels = grounding_gt_labels(prep["target"], n_clips, t,
                                     cfg.num_bins)
        return grounding_loss(out, neg_out, labels, prep["group_rep"],
                              prep["is_rep"], prep["query_mask"], clip_mask,
                              cfg, mesh=mesh)


def build_grounding_train_step(model: GroundingModel, state: TrainState):
    """Returns ``step(video_feats, clip_mask, n_clips, gts, video_len,
    generator, noise=None) -> {term: detached tensor, "total": ...}``: loss,
    backward, global-norm clip and one Adam update of ``state`` (which owns
    ``model``).  The model is put in train mode; on the card the combined
    encoder's attention launches the composed forward and backward kernels
    once each per step wherever its gate engages.  Under ``state.mesh``
    the batch is this rank's rows (``noise``, where given, too) and the
    terms come back summed over the data ranks."""
    mesh = state.mesh
    model.train()

    def step(video_feats, clip_mask, n_clips, gts, video_len, generator=None,
             noise=None):
        with span("grounding.train"):
            draws = generator if mesh is None else mesh.draws(generator)
            total, terms = grounding_train_loss(
                model, video_feats, clip_mask, n_clips, gts, video_len,
                generator=draws, noise=noise, mesh=mesh)
            with span("backward"):
                total.backward()
            state.apply_gradients()
            return step_metrics(dict(terms, total=total), None, mesh)

    return step


def build_grounding_infer_step(model: GroundingModel, *, score_th, tiou_th,
                               bins_th, nms_th, mesh=None):
    """Returns infer(video_feats (B,T,D), clip_mask, n_clips (B,),
    query_cats (B,Q,3), temporal (B,Q,2), query_mask) -> (pooled (B,Q,K+1,2),
    bins_probs (B,Q,K+1), bins_mask (B,Q,K+1)), tensors on the model's
    device.  The model is put in eval mode, so the combined encoder's
    attention runs the CUDA kernel on the card wherever its gate engages.
    With ``mesh`` the operands are this rank's rows and the outputs of
    every data rank's rows come back in order (the stage-B eval's data
    axis).
    """
    model.eval()

    # under a mesh the attention picks its lowering by the whole batch's
    # rows, as the single process does (no draw in eval mode)
    rows = None if mesh is None else mesh.draws(None)

    @torch.inference_mode()
    def decode(video_feats, clip_mask, n_clips, query_cats, temporal,
               query_mask):
        with span("grounding.infer"):
            with span("forward"):
                regrs, conf, cls = model(video_feats, clip_mask, query_cats,
                                         temporal, query_mask, generator=rows)
            with span("postprocess"):
                return grounding_decode(regrs, conf, cls, temporal, n_clips,
                                        clip_mask, query_mask,
                                        score_th=score_th, tiou_th=tiou_th,
                                        bins_th=bins_th, nms_th=nms_th)

    if mesh is None:
        return decode
    return lambda *operands: gather_rows(decode(*operands), mesh)
