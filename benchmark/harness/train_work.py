"""What the training drivers share: the port's model and ``TrainState``
with the benchmark's weights, the checked first steps of set-up, the
window's steps after them, and the check against the plain reference.

Each step's dropout draws come from its own CPU generator, seeded from the
run's seed and the step's number (the port's train loop also hands each
step a generator of its own); step i trains on batch i of the pool
(cycled), so the checked steps' rows all differ.
"""
from __future__ import annotations

import torch

from benchmark.checks import training
from . import draws
from .runtime import end_phase
from vidsgg_big_tpu_torch.train.train_state import TrainState

# a milestone past any run: the learning rate stays the initial one
NO_DECAY = [10 ** 9]


class TrainWork:
    kind = "train"
    dtype = "float32"

    def __init__(self, cell, seed: int, device, model):
        """``model``: the port's model, built on ``device``; subclasses
        set ``self.inputs`` (the pool) and define ``dispatch`` and
        ``reference_loss`` before calling this."""
        tc = cell.config["train_config"]
        self.m, self.traffic, self.seed = cell.config["model_config"], \
            cell.traffic, seed
        self.lr = tc["initial_lr"]
        self.weights = draws.draw_state(model.state_dict(), seed, device)
        model.load_state_dict(self.weights, strict=True)
        end_phase("weights")
        self.state = TrainState(model, self.lr, tc["lr_decay"], NO_DECAY)
        self.names = list(self.state.names)
        self.train = self.build_step(model, self.state)
        end_phase("optimizer")
        # the checked steps; they warm up every shape of the window too
        losses = []
        for i in range(training.STEPS):
            losses.append(float(self.dispatch(i)))
            if i == 0:
                first = training.program_state(self.state, self.names)
                end_phase("first_step")
        params = dict(zip(self.names, self.state.params))
        self.program = (losses, first, {
            n: params[n].detach() - self.weights[n] for n in self.names})
        self.done = training.STEPS
        end_phase("checked_steps")

    def generator(self, i: int) -> torch.Generator:
        return torch.Generator().manual_seed(
            draws.sub_seed(self.seed, draws.STEPS, i))

    def batch(self, i: int):
        return self.inputs[i % len(self.inputs)]

    def step(self, n: int):
        """Dispatch the window's step ``n`` (the run's steps go on after
        set-up's); returns its loss, not yet read."""
        self.done += 1
        return self.dispatch(self.done - 1)

    def release(self):
        self.train = self.state = None

    def reference(self, dtype=None, cut=None):
        """The reference's first steps (computed in ``dtype`` where given;
        on the batches as ``cut`` leaves them)."""
        steps = range(training.STEPS)
        batches = [self.batch(i) for i in steps]
        return training.reference_steps(
            self.weights, self.names, self.reference_loss,
            [cut(b) for b in batches] if cut else batches,
            [self.generator(i) for i in steps], self.lr,
            None if dtype is None else (dtype, self.low_precision))

    def compare(self, prog, ref) -> dict:
        return training.compare(prog, ref, self.traffic["loss_steps"])

    def check(self, sample) -> list:
        got = self.compare(self.program, self.reference())
        limits = self.traffic["limits"]
        return [(n, got[n], limits[n]) for n in limits]

    def controls(self, sample, dtype) -> dict:
        """The readings of the reference put in the program's place: in
        ``dtype``, and on half of each batch (a step that leaves half of
        its batch out)."""
        expected = self.reference()
        return {"control": self.compare(self.reference(dtype), expected),
                "half_batch": self.compare(
                    self.reference(cut=training.half_batch), expected),
                "step_loss_gaps": [abs(p - r) / abs(r) for p, r in zip(
                    self.program[0], expected[0])]}
