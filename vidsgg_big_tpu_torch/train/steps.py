"""BIG-C and Base-C train and inference steps.

Port of ``build_train_step``, ``build_infer_step`` and
``build_basec_infer_step`` in the JAX package's ``train/steps.py`` (:22-59,
:67-88, :97-119), and of the Base-C step of its ``tools/train_vidor.py``
(:132-140): a train step is forward in train mode, loss, backward,
global-norm clip and one Adam update; an inference step is forward in eval
mode, then batched triplet construction.
"""
from __future__ import annotations

import torch

from ..models.base_c import BaseC, basec_train_loss
from ..models.big_c import BigC
from ..models.triplets import (Triplets, construct_triplets,
                               pairwise_construct_triplets)
from .losses import bigc_train_loss
from .train_state import TrainState


def build_train_step(model: BigC, state: TrainState, t_abs: int = 1024):
    """Returns ``step(props, gts, generator=None) -> metrics``: one update
    of ``state`` (which owns ``model``) on a batch of tensors on the
    model's device.  ``metrics`` holds the detached loss terms (``cls_pos``,
    ``cls_neg``, ``adj``), their sum ``total`` and ``grad_norm``, the global
    norm of the gradients before the clip (``optax_global_norm``).

    The model is put in train mode: its dropouts draw from ``generator``
    and the decoder's role attention takes its plain version (the kernel is
    forward-only, as the Pallas kernel in JAX).  The matching copies the
    cost to the host in the middle of the step (ops/matching.hungarian).
    ``t_abs`` is the vIoU grid length (train/losses.bigc_train_loss).
    """
    cfg = model.cfg
    model.train()

    def step(props, gts, generator=None):
        out = model(props, generator=generator)
        total, terms, _ = bigc_train_loss(out, props, gts, cfg,
                                          t_abs=t_abs)
        total.backward()
        norm = state.apply_gradients()
        return {k: v.detach() for k, v in dict(
            terms, total=total, grad_norm=norm).items()}

    return step


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


def build_basec_train_step(model: BaseC, state: TrainState,
                           t_abs: int = 1024):
    """Returns ``step(props, gts, generator=None) -> metrics`` for Base-C
    (JAX ``tools/train_vidor.py:132-140``): the multi-label BCE over the
    positive pairs, backward, clip and Adam.  ``metrics`` holds ``cls``,
    ``total`` (the same value) and ``grad_norm`` before the clip.  Base-C
    has no dropout, so ``generator`` is not read; ``t_abs`` is the label
    assignment's vIoU grid (4096 in the VidOR trainer)."""
    cfg = model.cfg
    model.train()

    def step(props, gts, generator=None):
        out = model(props)
        total, terms = basec_train_loss(out, props, gts, cfg, t_abs=t_abs)
        total.backward()
        norm = state.apply_gradients()
        return {k: v.detach() for k, v in dict(
            terms, total=total, grad_norm=norm).items()}

    return step


def build_basec_infer_step(model: BaseC, topk: int):
    """Returns infer(props) -> Triplets for Base-C: logits over every
    ordered tracklet pair, then :func:`pairwise_construct_triplets` with the
    config's ``rt_triplets_topk`` truncation."""
    cfg = model.cfg
    model.eval()

    @torch.inference_mode()
    def infer(props) -> Triplets:
        out = model(props)
        return pairwise_construct_triplets(
            out["pred_logits"], out["pair_ids"], props.durations,
            props.scores, props.cat_ids, props.traj_mask, topk=topk,
            num_enti_cats=cfg.num_enti_cats,
            num_pred_cats=cfg.num_pred_cats, rt_topk=cfg.rt_triplets_topk)

    return infer
