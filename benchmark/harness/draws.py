"""Random weights and inputs made on the device from a run's ``--seed``.

Every stream of a run is seeded by a hash of (seed, stream), so the same
seed gives the same weights, inputs and dropout draws, and any whole number
up to 2**64 is a valid seed.  Weights are drawn in one call over all leaves
and cut into them.
"""
from __future__ import annotations

import math

import numpy as np
import torch

WEIGHTS, INPUTS, STEPS, SAMPLE = range(4)


def sub_seed(seed: int, stream: int, index: int = 0) -> int:
    """A 63-bit seed for ``stream`` (and ``index`` within it) of ``seed``."""
    return int(np.random.SeedSequence([int(seed) % (1 << 64), stream, index])
               .generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, stream: int, device, index: int = 0):
    return torch.Generator(device=device).manual_seed(
        sub_seed(seed, stream, index))


def _scale(name: str, shape) -> tuple:
    """(std, offset) of a leaf: LayerNorm gains 1 + N(0, 0.02^2), other
    vectors N(0, 0.02^2), matrices and kernels N(0, 1 / fan_in)."""
    if len(shape) == 1:
        if "norm" in name and name.endswith("weight"):
            return 0.02, 1.0
        return 0.02, 0.0
    fan_in = math.prod(shape[1:])
    return 1.0 / math.sqrt(fan_in), 0.0


def draw_state(template: dict, seed: int, device) -> dict:
    """A state dict with the names and shapes of ``template`` (a model's
    ``state_dict``), every floating leaf drawn from ``seed``."""
    leaves = {k: v for k, v in template.items() if v.is_floating_point()}
    total = sum(v.numel() for v in leaves.values())
    flat = torch.randn(total, generator=generator(seed, WEIGHTS, device),
                       device=device)
    out, off = {}, 0
    for name, v in leaves.items():
        n = v.numel()
        std, offset = _scale(name, tuple(v.shape))
        out[name] = flat[off:off + n].view(v.shape) * std + offset
        off += n
    return out
