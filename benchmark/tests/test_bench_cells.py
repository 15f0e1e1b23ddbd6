"""Every cell driven on the CPU at small widths: a sound run is correct with
the committed limits; a run with the timed path broken underneath is not;
the control (the reference in bfloat16 in the program's place) reads over
at least one limit."""
import time

import pytest
import torch

from benchmark.harness.session import run_cell, serve_window
from benchmark.tests.small import small_cell

CELLS = ["exp2_serve_f32", "grounding_train_f32", "exp2_train_f32",
         "grounding_serve_f32"]
SEED = 2 ** 31 + 12345


def _run(name, cell=None, seed=SEED):
    cell = cell or small_cell(name)
    result, checked = run_cell(name, seed, 0.3, False, time.perf_counter(),
                               device="cpu", cell=cell)
    return result, checked


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    result, checked = _run(name)
    assert result["correct"], checked
    assert result["attempted"] > 0
    assert list(result)[-1] == "checked"
    assert set(result["metrics"]) <= {"videos_per_s", "batch_ms_p95",
                                      "train_videos_per_s", "setup_s",
                                      "bigc_train_videos_per_s",
                                      "peak_gib"}


def _alter_token(monkeypatch, name):
    """A served answer altered where it is produced."""
    if name == "exp2_serve_f32":
        import vidsgg_big_tpu_torch.train.steps as steps
        real = steps.construct_triplets

        def altered(*a, **kw):
            trip = real(*a, **kw)
            trip.quintuples[:, :, 0] = (trip.quintuples[:, :, 0] + 1) % 7
            return trip
        monkeypatch.setattr(steps, "construct_triplets", altered)
    else:
        import vidsgg_big_tpu_torch.train.grounding_steps as steps
        real = steps.grounding_decode

        def altered(*a, **kw):
            spans, probs, kept = real(*a, **kw)
            return spans, probs * 0.99, kept
        monkeypatch.setattr(steps, "grounding_decode", altered)


def _unchanged_state(monkeypatch, name):
    """A step that returns its state unchanged."""
    from vidsgg_big_tpu_torch.train.train_state import TrainState

    def no_update(self):
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1
        return None
    monkeypatch.setattr(TrainState, "apply_gradients", no_update)


def _half_batch(monkeypatch, name):
    """Half of the batch left out, the mean taken over the rest."""
    import dataclasses

    def half(x):
        if dataclasses.is_dataclass(x):
            return type(x)(**{f.name: half(getattr(x, f.name))
                              for f in dataclasses.fields(x)})
        return x[: x.shape[0] // 2] if torch.is_tensor(x) and x.dim() else x

    cell = small_cell(name)
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
    return cell


FAULTS = [(c, _alter_token) for c in CELLS if "serve" in c] + \
    [(c, f) for c in CELLS if "train" in c
     for f in (_unchanged_state, _half_batch)]


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_fault_is_not_correct(monkeypatch, name, fault):
    cell = fault(monkeypatch, name) or small_cell(name)
    result, checked = _run(name, cell)
    assert not result["correct"], checked


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    cell = small_cell(name)
    work = cell.driver.build(cell, SEED, "cpu")
    sample = []
    if work.kind == "serve":
        _, _, _, sample = serve_window(work, 0.2, 3, SEED, "cpu")
    work.release()
    limits = cell.traffic["limits"]
    readings = work.controls(sample, torch.bfloat16)["control"]
    assert any(readings[n] > limits[n] for n in readings), readings
