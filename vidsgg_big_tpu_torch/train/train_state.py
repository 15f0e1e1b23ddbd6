"""Optimizer, LR schedule, train state and checkpoints.

Port of the JAX package's ``train/train_state.py`` (the reference drivers'
recipe, reference tools/train_vidvrd.py:123-164): Adam with milestone LR
decay (epochs converted to iterations by the caller) after a global-norm
gradient clip at 5.0, each in optax's exact formula:

* the clip is ``optax.clip_by_global_norm``: with ``n`` the global norm of
  all gradients, every gradient becomes ``(g / n) * max_norm`` when ``n >=
  max_norm`` and stays as it is otherwise (``clip_grad_norm_`` instead
  scales by ``max_norm / (n + 1e-6)``);
* Adam is ``torch.optim.Adam`` (eps 1e-8 added outside the square root,
  both moments bias-corrected: the same update as ``optax.adam``);
* the schedule is ``optax.piecewise_constant_schedule``: update number s
  (0-based) uses ``lr * decay ** #(milestones <= s)``.

Checkpoints are ``torch.save`` files of {step, model, optimizer} with a
``meta_{step}.json`` sidecar of the position in the epoch stream, both
written atomically; the ``KEEP_CHECKPOINTS`` newest are kept.
"""
from __future__ import annotations

import bisect
import glob
import json
import os
from typing import Sequence

import torch

KEEP_CHECKPOINTS = 5


def milestone_lr(initial_lr: float, lr_decay: float,
                 milestones_iters: Sequence[int], step: int) -> float:
    """The learning rate of update number ``step`` (0-based)."""
    n = bisect.bisect_right(sorted(set(int(m) for m in milestones_iters)),
                            step)
    return initial_lr * lr_decay ** n


def clip_by_global_norm(grads, max_norm: float):
    """Clip ``grads`` (a list of tensors, in place) as
    ``optax.clip_by_global_norm``; returns the global norm, a tensor on the
    gradients' device (no host sync)."""
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g.float()) for g in grads]))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm.to(g.dtype)) * max_norm))
    return norm


class TrainState:
    """A model, its Adam optimizer and the count of updates done (the JAX
    ``TrainState``'s step).  ``apply_gradients`` clips the model's ``.grad``
    tensors, sets the update's learning rate from the milestone schedule
    and takes one Adam step."""

    def __init__(self, model: torch.nn.Module, initial_lr: float,
                 lr_decay: float, milestones_iters: Sequence[int],
                 grad_clip: float = 5.0):
        self.model = model
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.optimizer = torch.optim.Adam(self.params, lr=initial_lr,
                                          betas=(0.9, 0.999), eps=1e-8)
        self.initial_lr, self.lr_decay = initial_lr, lr_decay
        self.milestones = [int(m) for m in milestones_iters]
        self.grad_clip = grad_clip
        self.step = 0

    def lr(self, step: int | None = None) -> float:
        return milestone_lr(self.initial_lr, self.lr_decay, self.milestones,
                            self.step if step is None else step)

    def apply_gradients(self):
        """Clip, then one Adam update at this step's learning rate.  A
        parameter without a gradient (unused by the forward) counts as a zero
        gradient, as in JAX."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        norm = clip_by_global_norm([p.grad for p in self.params],
                                   self.grad_clip)
        for group in self.optimizer.param_groups:
            group["lr"] = self.lr()
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1
        return norm

    def state_dict(self):
        return {"step": self.step, "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict()}

    def load_state_dict(self, sd):
        self.model.load_state_dict(sd["model"])
        self.optimizer.load_state_dict(sd["optimizer"])
        self.step = int(sd["step"])


def _ckpt_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"ckpt_{step}.pt")


def _atomic_write(path: str, write):
    tmp = path + ".tmp"
    write(tmp)
    os.replace(tmp, path)


def checkpoint_steps(ckpt_dir: str) -> list:
    steps = []
    for p in glob.glob(os.path.join(ckpt_dir, "ckpt_*.pt")):
        try:
            steps.append(int(os.path.basename(p)[5:-3]))
        except ValueError:
            continue
    return sorted(steps)


def save_checkpoint(ckpt_dir: str, state: TrainState, step: int,
                    epoch: int | None = None, batch_in_epoch: int = 0):
    """Save {step, model, optimizer} as ``ckpt_{step}.pt`` and, with
    ``epoch``, the sidecar ``meta_{step}.json`` of (epoch, batch_in_epoch):
    ``epoch`` is the next epoch to train, or with ``batch_in_epoch`` > 0 the
    interrupted one, whose stream a resume fast-forwards by that many
    batches.  Keeps the ``KEEP_CHECKPOINTS`` newest and their sidecars."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    os.makedirs(ckpt_dir, exist_ok=True)
    _atomic_write(_ckpt_path(ckpt_dir, step),
                  lambda p: torch.save(state.state_dict(), p))
    if epoch is not None:
        def dump(p):
            with open(p, "w") as f:
                json.dump({"step": step, "epoch": epoch,
                           "batch_in_epoch": int(batch_in_epoch)}, f)
        _atomic_write(os.path.join(ckpt_dir, f"meta_{step}.json"), dump)
    kept = set(checkpoint_steps(ckpt_dir)[-KEEP_CHECKPOINTS:])
    for s in checkpoint_steps(ckpt_dir):
        if s not in kept:
            os.remove(_ckpt_path(ckpt_dir, s))
    for p in glob.glob(os.path.join(ckpt_dir, "meta_*.json")):
        try:
            s = int(os.path.basename(p)[5:-5])
        except ValueError:
            continue
        if s not in kept:
            os.remove(p)


def load_checkpoint(ckpt_dir: str, state: TrainState) -> int:
    """Load the newest checkpoint into ``state``; returns its step."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    steps = checkpoint_steps(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    step = steps[-1]
    device = next(state.model.parameters()).device
    sd = torch.load(_ckpt_path(ckpt_dir, step), map_location=device,
                    weights_only=True)
    state.load_state_dict(sd)
    return step


def load_checkpoint_position(ckpt_dir: str, step: int) \
        -> tuple[int | None, int]:
    """``(epoch, batch_in_epoch)`` from the sidecar; ``(None, 0)`` when it
    is missing or corrupt."""
    path = os.path.join(os.path.abspath(ckpt_dir), f"meta_{step}.json")
    if not os.path.exists(path):
        return None, 0
    try:
        with open(path) as f:
            d = json.load(f)
        return d["epoch"], int(d.get("batch_in_epoch", 0))
    except (json.JSONDecodeError, KeyError, ValueError, OSError):
        return None, 0
