"""The faults that the CPU tests plant under a cell's timed path, one file a
driver, found by the driver's name: ``tests/faults/<driver>.py`` holds
``FAULTS``, functions ``fault(monkeypatch, cell)`` that each break the path
underneath a run of ``cell`` (a small cell of that driver), so that the run
must read ``correct`` false.  A new driver brings its file."""
from __future__ import annotations

from pathlib import Path

from benchmark.harness.runtime import BENCH_DIR, load_module


def load(driver: str, root: Path = BENCH_DIR) -> list:
    """The ``FAULTS`` of ``driver``."""
    path = Path(root) / "tests" / "faults" / f"{driver}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no faults for the driver {driver!r}: "
                                f"add {path}")
    return load_module(path, f"bench_faults_{driver}").FAULTS
