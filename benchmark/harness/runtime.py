"""What every run does around its driver: where the benchmark's files and
the program's caches are, the look for the cards, the look for JAX, and the
loading of the pieces a cell names.

Every piece a cell uses is found by name: the cell in ``BENCHMARK.json``,
its traffic mix in ``benchmark/workloads/<traffic>.json`` (which names the
driver), its configuration in ``benchmark/configs/<config>.json``, the
driver in ``benchmark/drivers/<driver>.py`` and each per-layer metric's
reader in ``benchmark/metrics/<metric>.py``.  A new cell, configuration or
metric is new files and entries; no file here changes for it.
"""
from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
# top-level module names the benchmark's process may never hold: the JAX
# package is the port's reference, not the system under test
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "vidsgg_big_tpu")
# the program's build and kernel caches, at fixed paths inside the checkout
CACHE_DIR = ROOT / "build" / "benchmark_cache"


def set_cache_env() -> None:
    """Point every compiler cache that torch or triton might use into the
    checkout, so that only a cell's first run in a checkout builds.  The
    port's own kernels build into ``build/vidsgg_big_tpu_torch/`` of the
    checkout (its ``ops/build.py``)."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE_DIR / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE_DIR / "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(CACHE_DIR / "inductor")


# set-up's phases as they end: (name, the host clock's reading)
PHASES: list = []


def end_phase(name: str) -> None:
    """Mark the end of the set-up phase ``name``, once the device's queue
    has drained, so that a run can log where its set-up time went."""
    import torch
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    PHASES.append((name, time.perf_counter()))


def phase_seconds(t_start: float, t_end: float) -> dict:
    """Seconds of each phase marked since ``t_start``, and of what follows
    the last mark until ``t_end`` (``rest``)."""
    out, last = {}, t_start
    for name, t in PHASES:
        out[name] = out.get(name, 0.0) + (t - last)
        last = t
    out["rest"] = t_end - last
    return out


def forbidden_loaded() -> list:
    """The forbidden top-level names that ``sys.modules`` holds, compared
    whole (``vidsgg_big_tpu_torch`` is not ``vidsgg_big_tpu``)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark_spec() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def load_module(path: Path, name: str):
    """Import the file ``path`` as a module named ``name``."""
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Cell:
    """One workload of ``BENCHMARK.json`` with its pieces: ``entry`` (the
    workload's entry), ``config`` and ``traffic`` (their files' contents),
    the driver module and the cell's metrics of both kinds."""

    def __init__(self, name: str, spec: dict | None = None,
                 root: Path = BENCH_DIR):
        spec = spec if spec is not None else benchmark_spec()
        self.root = root
        entries = {w["name"]: w for w in spec["workloads"]}
        if name not in entries:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                           f"{sorted(entries)}")
        self.name = name
        self.entry = entries[name]
        self.config = load_json(root / "configs" /
                                f"{self.entry['config']}.json")
        self.traffic = load_json(root / "workloads" /
                                 f"{self.entry['traffic']}.json")
        self.driver = load_module(
            root / "drivers" / f"{self.traffic['driver']}.py",
            f"bench_driver_{self.traffic['driver']}")
        self.end_to_end = [m for m in spec["end_to_end"] if self._has(m)]
        self.per_layer = [m for m in spec["per_layer"] if self._has(m)]

    def _has(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])

    def reader(self, metric: str):
        """The ``read`` function of ``benchmark/metrics/<metric>.py``."""
        return load_module(self.root / "metrics" / f"{metric}.py",
                           "bench_metric_" + metric.replace(".", "_")).read
