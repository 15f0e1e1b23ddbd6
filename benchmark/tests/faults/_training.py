"""The faults of a training step, shared by the training drivers."""
from __future__ import annotations

import dataclasses

import torch


def unchanged_state(monkeypatch, cell):
    """A step that returns its state unchanged."""
    from vidsgg_big_tpu_torch.train.train_state import TrainState

    def no_update(self):
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1
        return None
    monkeypatch.setattr(TrainState, "apply_gradients", no_update)


def half_batch(monkeypatch, cell):
    """Half of the batch left out, the mean taken over the rest."""
    def half(x):
        if dataclasses.is_dataclass(x):
            return type(x)(**{f.name: half(getattr(x, f.name))
                              for f in dataclasses.fields(x)})
        return x[: x.shape[0] // 2] if torch.is_tensor(x) and x.dim() else x

    real = cell.driver.Work.dispatch

    def dispatch(self, i):
        build = self.train

        def halved(*a, **kw):
            return build(*(half(x) for x in a),
                         **{k: half(v) for k, v in kw.items()})
        self.train = halved
        try:
            return real(self, i)
        finally:
            self.train = build
    monkeypatch.setattr(cell.driver.Work, "dispatch", dispatch)


FAULTS = [unchanged_state, half_batch]
