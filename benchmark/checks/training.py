"""The check of a training cell's first steps against the plain reference.

Set-up drives the program's train step from the seed through its first
``STEPS`` steps, on batches whose rows all differ, and keeps: each step's
loss, the first gradient as the optimizer got it (Adam's first moment after
one step over 1 - beta1: the clipped gradient) and each parameter's change
after the steps.  The reference starts from the same weights and follows
the same steps with the same batches and dropout draws.

* ``loss_gap``: the largest |program - reference| / |reference| of the
  losses of the first ``loss_steps`` steps (a traffic file's key).  Where a
  loss reads discrete choices of the weights (BIG-C's subject and object
  by an argmax, the Hungarian matching), a later step's choices can flip
  on the round-off of the earlier updates, so that cell compares the
  first step's loss alone and leaves the later steps to ``update_gap``.
* ``grad_gap``: over the leaves, the largest gap between the program's
  and the reference's gradient norm, over the larger of the reference
  leaf's norm and the median leaf's.
* ``update_gap``: the same of each leaf's change after the steps, over the
  leaves whose reference gradient reaches ``GRAD_FLOOR`` of the median
  leaf's (smaller ones move by Adam's round-off alone, such as a key bias
  under the softmax).
"""
from __future__ import annotations

import torch

from benchmark.reference import optim

STEPS = 3
GRAD_FLOOR = 1e-3


def program_state(state, names: list) -> dict:
    """The program's first gradient (from Adam's state after one step;
    zero where the optimizer holds no state for a leaf)."""
    opt = state.optimizer
    return {n: opt.state[p]["exp_avg"].detach() / (1 - optim.BETAS[0])
            if "exp_avg" in opt.state.get(p, {}) else torch.zeros_like(p)
            for n, p in zip(names, state.params)}


def cast(tree, dtype):
    """Every floating tensor of a (nested) dict in ``dtype``."""
    if isinstance(tree, dict):
        return {k: cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.is_floating_point() else tree


def reference_steps(weights: dict, names: list, loss_fn, batches,
                    generators, lr: float, low=None):
    """(losses, first gradients, changes) of the reference's first steps:
    ``loss_fn(w, batch, generator)`` is the reference's loss of one step,
    ``w`` every weight with the trainable ``names`` requiring grad.
    ``low`` = (dtype, cast_batch) computes the steps in that dtype over
    float32 weights and Adam state (mixed precision), the batch's features
    cast by ``cast_batch(batch, dtype)``: the control."""
    params = {n: weights[n].detach().clone().requires_grad_(True)
              for n in names}
    w = dict(weights, **params)
    opt = optim.Adam(params, lr)
    losses, first = [], None
    for batch, gen in zip(batches, generators):
        if low is not None:
            w = cast(dict(weights, **params), low[0])
            batch = low[1](batch, low[0])
        total = loss_fn(w, batch, gen)
        grads = torch.autograd.grad(total, [params[n] for n in names],
                                    allow_unused=True)
        grads = optim.clip({n: torch.zeros_like(params[n]) if g is None
                            else g for n, g in zip(names, grads)})
        if first is None:
            first = {n: g.detach().clone() for n, g in grads.items()}
        opt.step(grads)
        losses.append(float(total.detach()))
    changes = {n: params[n].detach() - weights[n] for n in names}
    return losses, first, changes


def _leaf_gap(prog: dict, ref: dict, names) -> float:
    norms = {n: (float(prog[n].norm()), float(ref[n].norm())) for n in names}
    median = float(torch.tensor([r for _, r in norms.values()]).median())
    return max(abs(p - r) / max(r, median) for p, r in norms.values())


def compare(prog: tuple, ref: tuple, loss_steps: int = STEPS) -> dict:
    """prog and ref: (losses, first gradients, changes)."""
    pl, pg, pd = prog
    rl, rg, rd = ref
    loss_gap = max(abs(p - r) / abs(r)
                   for p, r in list(zip(pl, rl))[:loss_steps])
    names = list(rg)
    grad_gap = _leaf_gap(pg, rg, names)
    median = float(torch.tensor([float(rg[n].norm()) for n in names])
                   .median())
    moved = [n for n in names if float(rg[n].norm()) >= GRAD_FLOOR * median]
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "update_gap": _leaf_gap(pd, rd, moved)}


def half_batch(tree):
    """The first half of every tensor's rows (the batch axis) of a
    (nested) dict: a step that leaves out half of its batch."""
    if isinstance(tree, dict):
        return {k: half_batch(v) for k, v in tree.items()}
    return tree[: tree.shape[0] // 2]
