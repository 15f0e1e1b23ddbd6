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

Under a mesh (``parallel/``) a state holds this rank's part of the
parameters and of their Adam moments (``parallel/sharding.py``'s plan):
after backward the gradients are summed over the data ranks in one
coalesced all-reduce (the losses divide by global counts, so the sum is the
global gradient), the clip's norm sums the split gradients' squares over
the model ranks and counts the replicated ones once, and a checkpoint
gathers the whole reference-named state, which rank 0 writes: the same
file under any mesh, loaded under any other by cutting it.
"""
from __future__ import annotations

import bisect
import glob
import json
import os
import sys
from typing import Sequence

import torch
import torch.distributed as dist

from ..parallel.sharding import (full_state_dict, gather_tensor, model_plan,
                                 shard_state_dict, shard_tensor)
from ..utils.spans import span

KEEP_CHECKPOINTS = 5


def milestone_lr(initial_lr: float, lr_decay: float,
                 milestones_iters: Sequence[int], step: int) -> float:
    """The learning rate of update number ``step`` (0-based)."""
    n = bisect.bisect_right(sorted(set(int(m) for m in milestones_iters)),
                            step)
    return initial_lr * lr_decay ** n


def global_norm(grads, split=None, axis=None):
    """The global norm of ``grads``.  Where ``split`` flags the gradients
    cut over ``axis`` (a ``parallel.mesh.ModelAxis``), their squares are
    summed over its ranks and the others' counted once."""
    if not split or not any(split):
        return torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g.float()) for g in grads]))
    sq = [torch.linalg.vector_norm(g.float()) ** 2 for g in grads]
    zero = torch.zeros((), device=grads[0].device)
    sharded = sum((q for q, s in zip(sq, split) if s), zero).reshape(1)
    dist.all_reduce(sharded, group=axis.group)
    return torch.sqrt(sharded[0] + sum((q for q, s in zip(sq, split)
                                        if not s), zero))


def clip_by_global_norm(grads, max_norm: float, split=None, axis=None):
    """Clip ``grads`` (a list of tensors, in place) as
    ``optax.clip_by_global_norm``; returns the global norm
    (:func:`global_norm`), a tensor on the gradients' device (no host
    sync)."""
    norm = global_norm(grads, split, axis)
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm.to(g.dtype)) * max_norm))
    return norm


def all_reduce_coalesced(tensors, group) -> int:
    """SUM-all-reduce ``tensors`` over ``group`` in place: one all-reduce of
    their concatenation, copied back with one foreach copy.  Returns the
    bytes reduced."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    parts = flat.split([t.numel() for t in tensors])
    torch._foreach_copy_(tensors, [p.view_as(t)
                                   for p, t in zip(parts, tensors)])
    return flat.numel() * flat.element_size()


class TrainState:
    """A model, its Adam optimizer and the count of updates done (the JAX
    ``TrainState``'s step).  ``apply_gradients`` clips the model's ``.grad``
    tensors, sets the update's learning rate from the milestone schedule
    and takes one Adam step.  ``mesh`` (a ``parallel.mesh.Mesh``) makes it
    one rank's part of a sharded state; shard the model
    (``parallel.sharding.shard_params``) before building it."""

    def __init__(self, model: torch.nn.Module, initial_lr: float,
                 lr_decay: float, milestones_iters: Sequence[int],
                 grad_clip: float = 5.0, mesh=None):
        self.model, self.mesh = model, mesh
        names = {id(p): n for n, p in model.named_parameters()}
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.names = [names[id(p)] for p in self.params]
        self.plan = model_plan(model)
        self.sync_bytes = 0      # the gradient bytes of each data all-reduce
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
        with span("optim"):
            for p in self.params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            grads = [p.grad for p in self.params]
            if self.mesh is not None:
                self.sync_gradients(grads)
            with span("clip"):
                split = [n in self.plan for n in self.names]
                norm = clip_by_global_norm(grads, self.grad_clip, split,
                                           self.mesh and self.mesh.model_axis)
            with span("adam"):
                for group in self.optimizer.param_groups:
                    group["lr"] = self.lr()
                self.optimizer.step()
                self.optimizer.zero_grad(set_to_none=True)
            self.step += 1
            return norm

    def sync_gradients(self, grads):
        """Sum ``grads`` over the data ranks in place (nothing to do with
        one data rank)."""
        if self.mesh.n_data > 1:
            self.sync_bytes = all_reduce_coalesced(grads,
                                                   self.mesh.data_group)

    @property
    def is_writer(self) -> bool:
        """Whether this rank writes (rank 0, or the only process)."""
        return self.mesh is None or self.mesh.is_writer

    def _moments(self, opt, cut):
        """``opt`` (an optimizer state_dict) with ``cut(tensor, spec)``
        applied to the Adam moments of the split parameters."""
        if not self.plan:
            return opt
        state = dict(opt["state"])
        for i, name in enumerate(self.names):
            spec = self.plan.get(name)
            if spec is not None and i in state:
                state[i] = {k: (cut(v, spec) if k in ("exp_avg", "exp_avg_sq")
                                else v) for k, v in state[i].items()}
        return dict(opt, state=state)

    def state_dict(self):
        """The whole reference-named state, alike under any mesh (every rank
        calls it: the split parameters are gathered).  Its string keys are
        interned, so a state restored from a file pickles as one trained
        here: a checkpoint's bytes do not depend on its history."""
        axis = self.mesh and self.mesh.model_axis
        return _interned({"step": self.step,
                          "model": full_state_dict(self.model, self.mesh),
                          "optimizer": self._moments(
                              self.optimizer.state_dict(),
                              lambda v, spec: gather_tensor(v, spec, axis))})

    def load_state_dict(self, sd):
        """Load a whole state (of any mesh), cut to this rank's parts."""
        mesh = self.mesh
        self.model.load_state_dict(shard_state_dict(sd["model"], self.model,
                                                    mesh))
        self.optimizer.load_state_dict(self._moments(
            sd["optimizer"], lambda v, spec: shard_tensor(
                v, spec, mesh.n_model, mesh.model_index)))
        self.step = int(sd["step"])


def _interned(tree):
    """``tree`` (dicts and lists) rebuilt with interned string keys: pickle
    shares a string by identity, and keys read from a file are new
    objects.  A ``state_dict``'s type and ``_metadata`` stay."""
    if isinstance(tree, dict):
        out = type(tree)(
            (sys.intern(k) if isinstance(k, str) else k, _interned(v))
            for k, v in tree.items())
        if hasattr(tree, "_metadata"):
            out._metadata = tree._metadata
        return out
    if isinstance(tree, list):
        return [_interned(v) for v in tree]
    return tree


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
    batches.  Keeps the ``KEEP_CHECKPOINTS`` newest and their sidecars.
    Under a mesh every rank calls it: the state is gathered, rank 0
    writes, and the ranks wait for the write."""
    sd = state.state_dict()
    if state.is_writer:
        _write_checkpoint(os.path.abspath(ckpt_dir), sd, step, epoch,
                          batch_in_epoch)
    if state.mesh is not None:
        dist.barrier(group=state.mesh.host_group)


def _write_checkpoint(ckpt_dir, sd, step, epoch, batch_in_epoch):
    os.makedirs(ckpt_dir, exist_ok=True)
    _atomic_write(_ckpt_path(ckpt_dir, step), lambda p: torch.save(sd, p))
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
