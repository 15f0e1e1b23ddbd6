"""The program-span pass (``harness/program_pass.py``): the attribution of
idle gaps to the program's spans on synthetic intervals, the shared clock
and its refusal, the retry, the profile's reader on fake events, and a CPU
rehearsal of every cell with ``--trace 1``."""
import time
from types import SimpleNamespace

import pytest
import torch

from benchmark.harness import program_pass
from benchmark.harness.runtime import ROOT, load_json
from benchmark.harness.session import run_cell
from benchmark.harness.trace import MARKER
from benchmark.tests.small import small_cell
from vidsgg_big_tpu_torch.utils.spans import Record

SEED = 2 ** 31 + 4321
CELLS = [w["name"] for w in load_json(ROOT / "BENCHMARK.json")["workloads"]]
# the spans, on the host's clock in nanoseconds
RECORDS = [
    Record("train", None, 10_000, 90_000),          # 10-90 us
    Record("forward", 0, 20_000, 40_000),           # 20-40
    Record("optim", 0, 50_000, 80_000),             # 50-80
    Record("clip", 2, 55_000, 65_000),              # 55-65
]


# the device's busy intervals (microseconds on the profile's device clock)
# with the start of each one's launch call on the profile's host clock,
# which is the host's clock plus OFFSET: 25-30 launched at host 25, 33-40
# at 33 (38-58 inside its merged interval), 62-70 at 62, 95-98 at 95; the
# window 0-100 closes with the second marker, launched at host 100
OFFSET = 500.0
OPS = [(0, 12, None), (25, 30, 525.0), (33, 40, 533.0), (38, 58, 536.0),
       (62, 70, 562.0), (95, 98, 595.0)]


def test_idle_gaps_end_at_their_launch_calls():
    assert program_pass.idle_gaps(OPS, (0.0, 100.0), 600.0) == [
        (13, 525.0), (3, 533.0), (4, 562.0), (25, 595.0), (2.0, 600.0)]


def test_attribution_by_midpoint_with_ancestors():
    # gaps on the host's clock: 12-25 (mid 18.5: train), 30-33 (31.5:
    # forward), 58-62 (60: clip), 70-95 (82.5: train), 98-100 (99: none)
    gaps = program_pass.idle_gaps(OPS, (0.0, 100.0), 600.0)
    idle = program_pass.attribute(RECORDS, gaps, OFFSET)
    assert idle == pytest.approx({0: 38.0, 1: 3.0, 3: 4.0,
                                  "between_steps": 2.0})
    assert program_pass.attribute(RECORDS, [(5.0, None)], OFFSET) == \
        {"unanchored": 5.0}
    found = program_pass.summarize(RECORDS, 2, dict(idle, unanchored=1.0))
    assert found["roots"] == ["train"]
    assert found["idle_ms"] == pytest.approx(
        {"train": 0.0225, "forward": 0.0015, "optim": 0.002, "clip": 0.002})
    assert found["root_self_idle_ms"] == pytest.approx({"train": 0.019})
    assert found["between_steps_ms"] == pytest.approx(0.001)
    assert found["unanchored_ms"] == pytest.approx(0.0005)
    assert found["idle_total_ms"] == pytest.approx(0.024)
    assert found["host_ms"] == pytest.approx(
        {"train": 0.04, "forward": 0.01, "optim": 0.015, "clip": 0.005})
    assert program_pass.summarize(RECORDS, 2)["idle_ms"] is None


def test_launch_counts_by_innermost_span_with_ancestors():
    # launch calls on the host's clock: 25, 33, 36 (forward), 62 (clip),
    # 95 (none)
    calls = sorted({call for _, _, call in OPS if call is not None})
    launches = program_pass.count_launches(RECORDS, calls, OFFSET)
    assert launches == {1: 3, 3: 1, "between_steps": 1}
    gaps = program_pass.idle_gaps(OPS, (0.0, 100.0), 600.0)
    found = program_pass.summarize(
        RECORDS, 2, program_pass.attribute(RECORDS, gaps, OFFSET), launches)
    assert found["launches"] == pytest.approx(
        {"train": 2.0, "forward": 1.5, "optim": 0.5, "clip": 0.5})
    assert found["launches_total"] == pytest.approx(2.5)
    assert "launches" not in program_pass.summarize(
        RECORDS, 2, program_pass.attribute(RECORDS, gaps, OFFSET))


def test_clock_map_and_its_refusal():
    stamps = [5_000_000, 9_000_000]                      # host ns
    offsets = program_pass.clock_offsets(stamps, [5_012.0, 9_030.0])
    assert offsets == pytest.approx([12.0, 30.0])
    assert program_pass.clocks_agree(offsets)
    assert not program_pass.clocks_agree(
        program_pass.clock_offsets(stamps, [5_012.0, 9_070.0]))
    # the gaps land on the host's clock through the first offset alone
    gaps = program_pass.idle_gaps(OPS, (0.0, 100.0), 600.0)
    moved = [(us, call + 4_000.0) for us, call in gaps]
    assert program_pass.attribute(RECORDS, moved, OFFSET + 4_000.0) == \
        program_pass.attribute(RECORDS, gaps, OFFSET)


def _event(name, start, end, cid, cpu=False):
    device = torch.autograd.DeviceType
    return SimpleNamespace(
        name=name, id=cid, is_user_annotation=False,
        device_type=device.CPU if cpu else device.CUDA,
        time_range=SimpleNamespace(start=start, end=end))


@pytest.mark.parametrize("lost", [None, 0, 3])
def test_profile_read_pairs_operations_with_their_launch_calls(lost):
    marker = f"void at::cuda::{MARKER}(long)"
    events = [_event("cudaLaunchKernel", 100.0, 103.0, 1, cpu=True),
              _event("cudaLaunchKernel", 110.0, 112.0, 2, cpu=True),
              _event("cudaMemcpyAsync", 300.0, 302.0, 3, cpu=True),
              _event("cudaLaunchKernel", 500.0, 503.0, 4, cpu=True),
              _event(marker, 105.0, 106.0, 1), _event("gemm", 115.0, 200.0, 2),
              _event("Memcpy HtoD", 305.0, 400.0, 3),
              _event(marker, 505.0, 506.0, 4)]
    if lost is not None:
        del events[lost]
    found = program_pass._read_profile(SimpleNamespace(events=lambda: events))
    if lost is None:
        assert found == ([100.0, 500.0], [(9.0, 110.0), (105.0, 300.0),
                                          (105.0, 500.0)], [110.0, 300.0])
    else:
        assert found is None


@pytest.mark.parametrize("passes", [["agree"], ["skew", "agree"],
                                    ["lost", "skew", "agree"],
                                    ["skew", "lost", "skew"]])
def test_pass_retries_then_gives_up(monkeypatch, passes):
    seen = []
    stamps = [1_000_000, 2_000_000]

    def on_card(work, steps):
        return RECORDS, 0.5, passes[len(seen)], stamps

    def read_profile(kind):
        seen.append(kind)
        if kind == "lost":
            return None
        calls = [1_500.0, 2_500.0 + (80.0 if kind == "skew" else 0.0)]
        return calls, program_pass.idle_gaps(OPS, (0.0, 100.0), 600.0), \
            [525.0, 562.0]
    monkeypatch.setattr(program_pass, "_on_card", on_card)
    monkeypatch.setattr(program_pass, "_read_profile", read_profile)
    found = program_pass._pass(None, 2, cuda=True)
    assert seen == passes and len(passes) <= program_pass.ATTEMPTS
    assert found["seconds"] == 0.5
    assert (found["idle_ms"] is None) == (passes[-1] != "agree")
    if passes[-1] == "agree":
        assert found["offsets_us"] == [500.0, 500.0]
        assert found["launches"]["train"] == pytest.approx(1.0)


@pytest.mark.parametrize("separate", [False, True])
def test_pass_takes_its_device_from_the_run(monkeypatch, separate):
    # on the card the run's device pass is a trace of its own; a CPU run
    # shares one, whatever the process did with CUDA before
    seen = []

    def fake_pass(work, steps, cuda):
        seen.append(cuda)
        launches = {1: 3, 3: 1, "between_steps": 1} if cuda else None
        return dict(program_pass.summarize(RECORDS, steps, {}, launches),
                    seconds=0.004)
    monkeypatch.setattr(program_pass, "_pass", fake_pass)
    shared = object()
    run = SimpleNamespace(
        work=SimpleNamespace(kind="train"),
        cell=SimpleNamespace(traffic={"trace_steps": 2}),
        spans=shared, trace=object() if separate else shared,
        window_s=0.003, steps=2)
    found = program_pass.program_spans(run)
    assert seen == [separate]
    assert found["pass_ms_per_step"] == pytest.approx(2.0)
    assert found["window_ms_per_step"] == pytest.approx(1.5)
    # (2.0 - 1.5) ms a step over 2.5 launches a step
    assert found.get("profiler_us_per_launch") == (
        pytest.approx(200.0) if separate else None)
    assert program_pass.program_spans(run) is found and len(seen) == 1


@pytest.mark.parametrize("name", CELLS)
def test_traced_rehearsal_reads_the_host_spans(name):
    cell = small_cell(name)
    result, _ = run_cell(name, SEED, 0.2, True, time.perf_counter(),
                         device="cpu", cell=cell)
    metrics = result["metrics"]
    assert result["correct"]
    assert not [m for m in metrics if m.startswith("idle_ms.")]
    host = [m["name"] for m in cell.per_layer
            if m["name"].startswith("host_ms.")]
    assert [m for m in metrics if m.startswith("host_ms.")] == host
    for m in host:
        assert metrics[m]["value"] > 0 and metrics[m]["unit"] == "ms"
