"""Every cell of ``BENCHMARK.json`` driven on the CPU at small widths: a
sound run is correct with the committed limits; a run with the timed path
broken underneath by each of its driver's faults (``tests/faults/``) is
not; the control (the reference in the program's place, one precision below
the cell's: bfloat16 for a float32 cell, or the driver's ``control_dtype``)
reads over at least one limit."""
import time

import pytest
import torch

from benchmark.harness.runtime import BENCH_DIR, ROOT, load_json
from benchmark.harness.session import run_cell, serve_window
from benchmark.tests import faults
from benchmark.tests.small import small_cell

SPEC = load_json(ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in SPEC["workloads"]]
SEED = 2 ** 31 + 12345


def driver(name: str) -> str:
    """The driver of the cell ``name``, read from its traffic file."""
    entry = next(w for w in SPEC["workloads"] if w["name"] == name)
    return load_json(BENCH_DIR / "workloads" /
                     f"{entry['traffic']}.json")["driver"]


def control_dtype(work):
    return getattr(work, "control_dtype", torch.bfloat16)


def _run(name, cell=None, seed=SEED):
    cell = cell or small_cell(name)
    result, checked = run_cell(name, seed, 0.3, False, time.perf_counter(),
                               device="cpu", cell=cell)
    return result, checked


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    cell = small_cell(name)
    result, checked = _run(name, cell)
    assert result["correct"], checked
    assert result["attempted"] > 0
    assert list(result)[-1] == "checked"
    assert set(result["metrics"]) <= {m["name"] for m in cell.end_to_end}


FAULTS = [(c, f) for c in CELLS for f in faults.load(driver(c))]


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_fault_is_not_correct(monkeypatch, name, fault):
    cell = small_cell(name)
    fault(monkeypatch, cell)
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
    readings = work.controls(sample, control_dtype(work))["control"]
    assert any(readings[n] > limits[n] for n in readings), readings
