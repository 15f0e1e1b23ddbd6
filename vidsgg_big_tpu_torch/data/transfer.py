"""Host-to-device copies of packed batches.

The trainers pack a batch on the host and copy it to the card one batch
ahead of its step (``train/loop.run_epochs``' ``preput``): pinned and
non-blocking there, so the copy overlaps the step in flight.  Features
travel in the wire dtype: float ones cast on the host, int8 ones as packed
(``BucketSpec(feat_dtype="int8")``, one scale per video).
"""
from __future__ import annotations

from typing import Optional

import torch


def wire_dtype(feat_dtype: Optional[str], compute_dtype: str) -> torch.dtype:
    """Feature dtype of a train batch: ``feat_dtype`` where given
    (float32, bfloat16 or int8), else bf16 under bf16 compute (whose cast
    rounds as the model's own) and float32 otherwise."""
    if feat_dtype:
        return getattr(torch, feat_dtype)
    return torch.bfloat16 if compute_dtype == "bfloat16" else torch.float32


def to_device(x, device: torch.device) -> torch.Tensor:
    """One leaf on ``device``: pinned and non-blocking on the card."""
    x = torch.as_tensor(x)
    if device.type == "cuda":
        return x.pin_memory().to(device, non_blocking=True)
    return x.to(device)


def wire_feats(feats, wire: torch.dtype) -> torch.Tensor:
    """Packed features in the wire dtype: a float cast on the host, or
    int8 features as they were packed (their scale rides in the batch)."""
    x = torch.as_tensor(feats)
    if (x.dtype == torch.int8) != (wire == torch.int8):
        raise ValueError(f"features packed as {x.dtype} cannot travel as "
                         f"{wire}: int8 is made at pack time "
                         "(BucketSpec.feat_dtype)")
    return x.to(wire)


def batch_to_device(props, gts, device: torch.device, wire: torch.dtype):
    """One numpy (TrackletBatch, GraphBatch) on ``device``, the features
    in ``wire`` (:func:`wire_feats`)."""
    p = {k: to_device(wire_feats(v, wire) if k == "feats" else v, device)
         for k, v in vars(props).items()}
    g = {k: to_device(v, device) for k, v in vars(gts).items()}
    return type(props)(**p), type(gts)(**g)
