"""Matmul and convolution FLOPs of one grounding-model step, from the layer
equations at a batch's bucket shapes (padding counts), frozen with the
benchmark.

Only products are counted (2 m k n each; a depthwise convolution as 2 C k
per output step), as ``torch.utils.flop_counter.FlopCounterMode`` counts
them.  The QANet attention counts its equations (8 heads of d / 8, the
logits and the weighted sum at width d over all heads), not the wider
composed products the port's kernel computes in their place.  A train
step counts the forward three times: the backward does twice the forward's
products.
"""
from __future__ import annotations

HEADS = 8


def _qanet(rows: int, length: int, h: int, kernel: int) -> float:
    convs = 4 * 2.0 * rows * length * (h * kernel + h * h)
    attention = 2.0 * rows * (4 * length * h * h + 2 * length * length * h)
    return convs + attention + 2.0 * rows * length * h * h


def _head(rows: int, length: int, h: int, out: int) -> float:
    blocks = 4 * 2.0 * rows * length * (3 * h + h * h)
    return blocks + 2.0 * rows * length * (3 * h + h * out)


def forward_flops(m: dict, b: int, q: int, t: int) -> float:
    """One forward of ``b`` videos x ``q`` query slots x ``t`` clips; ``m``
    is the configuration's ``model_config``."""
    h, k = m["dim_hidden"], m["num_bins"]
    rows = b * q
    total = 2.0 * b * t * m["dim_feat"] * h
    total += 2.0 * rows * 3 * m["dim_clsme"] * h + 2.0 * rows * 2 * h
    total += _qanet(b, t, h, 7) + _qanet(rows, 3, h, 3)
    total += 2.0 * b * t * h * h                       # proj2sim
    total += 4 * 2.0 * rows * t * 3 * h                # sim, mat_a, cv, mat_b
    total += 2.0 * rows * t * 4 * h * h                # vq_fc
    total += _qanet(rows, t, h, 7)
    total += _head(rows, t, h, 2 * k) + 2 * _head(rows, t, h, k)
    return total


def train_step_flops(m: dict, b: int, q: int, t: int) -> float:
    """One train step over ``q`` query slots a video (positive and negative
    slots together): the forward, and the backward at twice its products."""
    return 3.0 * forward_flops(m, b, q, t)
