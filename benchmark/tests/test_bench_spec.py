"""``BENCHMARK.json`` against the benchmark's contract, a cell and a metric
added as files and entries alone, the run without a card, and the imports:
no JAX and no JAX package anywhere, nothing of the port in the reference."""
import ast
import json
import re
import shutil
import subprocess
import sys
import time

import pytest

from benchmark.harness.runtime import BENCH_DIR, ROOT, Cell, load_json
from benchmark.harness.session import run_cell
from benchmark.tests import faults
from benchmark.tests.small import small_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = load_json(ROOT / "BENCHMARK.json")


def _line(text, limit=200):
    return 1 <= len(text) <= limit and "\n" not in text and "\t" not in text


def test_spec_keys_and_names():
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert all(_line(w) for w in SPEC["command"])
    names = [c["name"] for c in SPEC["configs"]] + \
        [w["name"] for w in SPEC["workloads"]] + \
        [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert all(NAME.match(n) for n in names), names
    assert len({c["name"] for c in SPEC["configs"]}) == len(SPEC["configs"])
    assert len({w["name"] for w in SPEC["workloads"]}) == \
        len(SPEC["workloads"])
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)


def test_configs_and_workloads():
    used = {w["config"] for w in SPEC["workloads"]}
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and _line(c["source"]) and _line(c["why"])
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert load_json(ROOT / c["file"])["reduced"] == c["reduced"]
    pairs = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and _line(w["why"])
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        traffic = load_json(BENCH_DIR / "workloads" / f"{w['traffic']}.json")
        assert (BENCH_DIR / "drivers" / f"{traffic['driver']}.py").is_file()


def test_metrics():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (BENCH_DIR / "metrics" / f"{m['name']}.py").is_file()
    for w in SPEC["workloads"]:
        cell = Cell(w["name"])
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in reported, (w["name"], m["name"])


def _copy_bench(tmp_path):
    """The benchmark's files that a cell is found by, and the CPU suite's
    small sizes and faults, copied under ``tmp_path``."""
    for d in ("configs", "workloads", "drivers", "metrics", "tests/small",
              "tests/faults"):
        shutil.copytree(BENCH_DIR / d, tmp_path / d)


def _write_json(path, obj):
    path.write_text(json.dumps(obj))


def test_new_cell_and_metric_are_files_and_entries(monkeypatch, tmp_path):
    _copy_bench(tmp_path)
    traffic = load_json(BENCH_DIR / "workloads" / "vidvrd_serve_b8.json")
    _write_json(tmp_path / "workloads" / "vidvrd_serve_b4.json",
                dict(traffic, batch=4))
    (tmp_path / "metrics" / "requests_done.py").write_text(
        "def read(run):\n    return float(run.steps)\n")
    # a new configuration and a new driver, each with its small sizes and
    # the driver with its faults: new files, and entries in the spec
    config = load_json(BENCH_DIR / "configs" / "bigc_v10_exp2.json")
    _write_json(tmp_path / "configs" / "newcfg.json",
                dict(config, name="newcfg"))
    (tmp_path / "drivers" / "serve_newdrv.py").write_text(
        "from benchmark.drivers.serve_bigc import Work, build  # noqa\n")
    _write_json(tmp_path / "workloads" / "vidvrd_serve_new.json",
                dict(traffic, driver="serve_newdrv"))
    small = load_json(BENCH_DIR / "tests" / "small" / "configs" /
                      "bigc_v10_exp2.json")
    _write_json(tmp_path / "tests" / "small" / "configs" / "newcfg.json",
                small)
    small = load_json(BENCH_DIR / "tests" / "small" / "drivers" /
                      "serve_bigc.json")
    _write_json(tmp_path / "tests" / "small" / "drivers" /
                "serve_newdrv.json", dict(small, batch=3))
    (tmp_path / "tests" / "faults" / "serve_newdrv.py").write_text(
        "from benchmark.tests.faults.serve_bigc import FAULTS  # noqa\n")
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"] += [
        {"name": "exp2_serve_b4", "config": "bigc_v10_exp2",
         "traffic": "vidvrd_serve_b4", "chips": 1, "why": "a test"},
        {"name": "new_serve", "config": "newcfg",
         "traffic": "vidvrd_serve_new", "chips": 1, "why": "a test"}]
    spec["end_to_end"].append({"name": "requests_done", "unit": "requests",
                               "better": "higher", "bound": 0.05,
                               "source": "host_clock",
                               "workloads": ["exp2_serve_b4", "new_serve"]})
    cell = small_cell("exp2_serve_b4", spec=spec, root=tmp_path)
    result, _ = run_cell("exp2_serve_b4", 3, 0.2, False, time.perf_counter(),
                         device="cpu", cell=cell)
    assert result["metrics"]["requests_done"]["value"] == result["attempted"]
    assert result["correct"]

    cell = small_cell("new_serve", spec=spec, root=tmp_path)
    assert cell.traffic["batch"] == 3
    assert cell.config["name"] == "newcfg"
    result, _ = run_cell("new_serve", 3, 0.2, False, time.perf_counter(),
                         device="cpu", cell=cell)
    assert result["metrics"]["requests_done"]["value"] == result["attempted"]
    assert result["correct"]
    for fault in faults.load("serve_newdrv", root=tmp_path):
        with monkeypatch.context() as patch:
            broken = small_cell("new_serve", spec=spec, root=tmp_path)
            fault(patch, broken)
            result, _ = run_cell("new_serve", 3, 0.2, False,
                                 time.perf_counter(), device="cpu",
                                 cell=broken)
        assert not result["correct"]


@pytest.mark.parametrize("kind,missing", [
    ("configs", "newcfg"), ("drivers", "serve_newdrv"), ("faults", None)])
def test_missing_small_file_names_it(tmp_path, kind, missing):
    _copy_bench(tmp_path)
    config = load_json(BENCH_DIR / "configs" / "bigc_v10_exp2.json")
    _write_json(tmp_path / "configs" / "newcfg.json",
                dict(config, name="newcfg"))
    (tmp_path / "drivers" / "serve_newdrv.py").write_text(
        "from benchmark.drivers.serve_bigc import Work, build  # noqa\n")
    traffic = load_json(BENCH_DIR / "workloads" / "vidvrd_serve_b8.json")
    _write_json(tmp_path / "workloads" / "vidvrd_serve_new.json",
                dict(traffic, driver="serve_newdrv"))
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": "new_serve", "config": "newcfg",
                              "traffic": "vidvrd_serve_new", "chips": 1,
                              "why": "a test"})
    if kind == "faults":
        with pytest.raises(FileNotFoundError, match="serve_newdrv.py"):
            faults.load("serve_newdrv", root=tmp_path)
        return
    small = tmp_path / "tests" / "small"
    if kind == "drivers":
        shutil.copy(small / "configs" / "bigc_v10_exp2.json",
                    small / "configs" / "newcfg.json")
    path = small / kind / f"{missing}.json"
    with pytest.raises(FileNotFoundError, match=str(path)):
        small_cell("new_serve", spec=spec, root=tmp_path)


def test_run_without_a_card_fails():
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "exp2_serve_f32",
         "--seed", str(2 ** 33), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 2, proc.stderr
    assert proc.stdout == ""


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_sources_import_no_jax_and_reference_no_port():
    for path in BENCH_DIR.rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "vidsgg_big_tpu"}, path
    for path in (BENCH_DIR / "reference").glob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & {"vidsgg_big_tpu_torch", "benchmark"}, path


def test_rehearsal_loads_no_jax():
    script = (
        "import time, json\n"
        "from benchmark.harness.runtime import forbidden_loaded\n"
        "from benchmark.harness.session import run_cell\n"
        "from benchmark.tests.small import small_cell\n"
        "for name in %r:\n"
        "    run_cell(name, 5, 0.1, True, time.perf_counter(), device='cpu',"
        " cell=small_cell(name))\n"
        "print(json.dumps(forbidden_loaded()))\n"
        % [w["name"] for w in SPEC["workloads"]])
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
