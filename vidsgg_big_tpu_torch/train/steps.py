"""Inference step (the training step is a later slice of the port).

Port of ``build_infer_step`` in the JAX package's ``train/steps.py``:
forward in eval mode, then batched triplet construction.
"""
from __future__ import annotations

import torch

from ..models.big_c import BigC
from ..models.triplets import Triplets, construct_triplets


def build_infer_step(model: BigC, topk: int):
    """Returns infer(props) -> Triplets (batched, on the model's device).

    ``props`` is a :class:`TrackletBatch` of tensors on that device.  The
    model is put in eval mode, so the decoder's role attention runs the
    CUDA kernel on the card.
    """
    cfg = model.cfg
    model.eval()

    @torch.inference_mode()
    def infer(props) -> Triplets:
        out = model(props)
        return construct_triplets(
            out["pred_logits"], out["att"], props.durations, props.scores,
            props.cat_ids, props.traj_mask, topk=topk,
            num_enti_cats=cfg.num_enti_cats,
            num_pred_cats=cfg.num_pred_cats)

    return infer
