"""The reference training recipe's update, written out: a global-norm clip at
5.0 (``optax.clip_by_global_norm``: every gradient times max_norm / norm
where the norm reaches max_norm) and Adam (beta 0.9 / 0.999, eps 1e-8
outside the square root, both moments bias-corrected)."""
from __future__ import annotations

import torch

BETAS, EPS, CLIP = (0.9, 0.999), 1e-8, 5.0


def clip(grads: dict) -> dict:
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
    if norm >= CLIP:
        return {k: g * (CLIP / norm).to(g.dtype) for k, g in grads.items()}
    return grads


class Adam:
    def __init__(self, params: dict, lr: float):
        self.params, self.lr, self.t = params, lr, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, grads: dict):
        self.t += 1
        b1, b2 = BETAS
        for k, p in self.params.items():
            g = grads[k]
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            mhat = self.m[k] / (1 - b1 ** self.t)
            vhat = self.v[k] / (1 - b2 ** self.t)
            p.sub_(self.lr * mhat / (vhat.sqrt() + EPS))
