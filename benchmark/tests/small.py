"""The cells at small widths and shapes, for CPU tests: every key the
benchmark reads, shrunk, the rest (limits, thresholds) as committed.

A cell's small sizes are files found by name, as a run finds the cell's
pieces: ``tests/small/configs/<config>.json`` shrinks the configuration's
``model_config`` and ``tests/small/drivers/<driver>.json`` the keys of every
traffic mix that the driver reads, under the benchmark directory the cell
is loaded from.  A new configuration or driver brings its file; no file
here changes for it.
"""
from __future__ import annotations

from pathlib import Path

from benchmark.harness.runtime import Cell, load_json

SMALL = Path("tests") / "small"


def small_sizes(root: Path, kind: str, name: str) -> dict:
    """The small sizes of the configuration (``kind`` "configs") or driver
    (``kind`` "drivers") ``name``."""
    path = Path(root) / SMALL / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(
            f"no small sizes for the {kind[:-1]} {name!r}: add {path}")
    return load_json(path)


def small_cell(name: str, **kw) -> Cell:
    cell = Cell(name, **kw)
    cell.config["model_config"].update(
        small_sizes(cell.root, "configs", cell.entry["config"]))
    cell.traffic.update(
        small_sizes(cell.root, "drivers", cell.traffic["driver"]),
        trace_steps=2)
    if "sample_batches" in cell.traffic:
        cell.traffic["sample_batches"] = 3
    return cell
