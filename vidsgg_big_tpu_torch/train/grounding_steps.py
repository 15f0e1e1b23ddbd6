"""Grounding-stage inference step (the training step is a later slice).

Port of ``build_grounding_infer_step`` in the JAX package's
``train/grounding_steps.py``: forward in eval mode, then the test-time
decode over the batch axis.
"""
from __future__ import annotations

import torch

from ..models.grounding import GroundingModel, grounding_decode


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
