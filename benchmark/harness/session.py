"""One run of one cell: set-up, the measured window, the traced window, the
check of the outputs, and the result line.

A driver (``benchmark/drivers/<name>.py``) has ``build(cell, seed, device)``
returning a workload object with:

* ``kind``: ``"serve"`` or ``"train"``; ``videos_per_step``;
* ``step(i)``: serving: request ``i`` from the step call until its outputs
  are on the host, returned; training: dispatch step ``i`` and return its
  loss tensor, not yet read;
* ``flops_per_step`` and ``dtype`` (for ``mfu``); ``kernel_bounds``: the
  frozen bound, in seconds, of one call of each hand-written kernel the
  window drives, by kernel role;
* ``counters()``: the program's own counters, printed on an earlier line;
* ``mark`` (serving): :func:`~.trace.no_span`, set to :func:`~.trace.span`
  for the traced pass with host spans; the driver marks the copy of a
  request's outputs to the host with ``self.mark("d2h")``;
* ``release()``: drop the program's state, after the window;
* ``check(samples)``: the comparison with the plain reference, given the
  sampled requests ``[(i, outputs)]`` (serving) or nothing new (training):
  a list of ``(name, value, limit)``; a run is correct where every value is
  at most its limit.

``build`` does all set-up: the weights and inputs drawn on the device, the
kernels built or loaded, every shape of the cell warmed up, and for
training the first steps whose results the check compares.  It marks the
end of each of its phases with :func:`~.runtime.end_phase`; a run logs the
seconds of each phase of its set-up on standard error.
"""
from __future__ import annotations

import json
import random
import sys
import time

import torch

from . import draws
from .runtime import PHASES, Cell, end_phase, phase_seconds
from .trace import Trace, WINDOW_SPAN, marker, span


class NoCard(RuntimeError):
    """The cards the cell asks for are not there."""


class Run:
    """What the metric readers read (``benchmark/metrics/*.py``)."""

    def __init__(self, cell, work, setup_s):
        self.cell, self.work, self.setup_s = cell, work, setup_s
        self.kind = work.kind
        self.steps, self.window_s, self.latencies = 0, 0.0, []
        self.window_peak_bytes = 0
        # the traced windows: the device's pass (``trace``) and the pass
        # with the host spans (``spans``)
        self.trace, self.spans, self.traced_steps = None, None, 0

    @property
    def videos(self) -> int:
        return self.steps * self.work.videos_per_step


def require_cards(count: int) -> None:
    if not torch.cuda.is_available():
        raise NoCard("CUDA is not available: the benchmark measures the "
                     "port on the card and never falls back to the CPU")
    if torch.cuda.device_count() < count:
        raise NoCard(f"the cell asks for {count} cards, "
                     f"{torch.cuda.device_count()} visible")


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def serve_window(work, seconds, sample_size, seed, device, traced=False,
                 steps=None):
    """Closed loop with one client: request i+1 is sent when request i's
    outputs are on the host.  Returns (requests, seconds, latencies,
    reservoir sample of (i, outputs))."""
    rng = random.Random(draws.sub_seed(seed, draws.SAMPLE))
    sample, lat = [], []
    _sync(device)
    t0 = time.perf_counter()
    i = 0
    while True:
        a = time.perf_counter()
        if traced:
            with span("step"):
                out = work.step(i)
        else:
            out = work.step(i)
        b = time.perf_counter()
        lat.append(b - a)
        if len(sample) < sample_size:
            sample.append((i, out))
        else:
            j = rng.randrange(i + 1)
            if j < sample_size:
                sample[j] = (i, out)
        i += 1
        if (steps is not None and i >= steps) or \
                (steps is None and b - t0 >= seconds):
            break
    return i, b - t0, lat, sample


def train_window(work, seconds, device, traced=False, steps=None):
    """Steps dispatched back to back; step N-1's loss is read after step N
    is dispatched, and the window ends with a synchronize.  Returns
    (steps, seconds)."""
    _sync(device)
    t0 = time.perf_counter()
    prev, n = None, 0
    while True:
        if traced:
            with span("step"):
                loss = work.step(n)
            if prev is not None:
                with span("loss_fetch"):
                    float(prev)
        else:
            loss = work.step(n)
            if prev is not None:
                float(prev)
        prev, n = loss, n + 1
        if (steps is not None and n >= steps) or \
                (steps is None and time.perf_counter() - t0 >= seconds):
            break
    if traced:
        with span("sync"):
            _sync(device)
            float(prev)
    else:
        _sync(device)
        float(prev)
    return n, time.perf_counter() - t0


def _window(work, device, seed, steps, traced):
    if work.kind == "serve":
        return serve_window(work, 0, 0, seed, device, traced=traced,
                            steps=steps)[1]
    return train_window(work, 0, device, traced=traced, steps=steps)[1]


def _traced(work, run, device, seed):
    """Two traced windows of ``trace_steps`` steps.  The device's pass
    records CUDA activity alone, between two marker kernels, which costs
    the host less than CPU activity does; ``busy_s``, ``window_s`` and the
    kernels' counts and times come from it.  The second pass adds the CPU
    activity and the benchmark's host spans, which name the idle gaps of
    ``breakdown``.  On the CPU (tests) the second pass is the only one."""
    steps = int(run.cell.traffic["trace_steps"])
    profiler = torch.profiler
    cuda = torch.device(device).type == "cuda"
    if cuda:
        cuda_only = [profiler.ProfilerActivity.CUDA]
        with profiler.profile(activities=cuda_only) as prof:
            marker()
            seconds = _window(work, device, seed, steps, traced=False)
            marker()
        run.trace = Trace.from_profile(prof, marked=True)
        log(f"device pass: {steps} steps in {seconds:.4f} s on the host "
            f"clock, against {run.window_s / max(run.steps, 1):.6f} s a "
            "step untraced")
    work.mark = span
    acts = [profiler.ProfilerActivity.CPU] + \
        ([profiler.ProfilerActivity.CUDA] if cuda else [])
    with profiler.profile(activities=acts) as prof:
        with span(WINDOW_SPAN):
            _window(work, device, seed, steps, traced=True)
    run.spans = Trace.from_profile(prof)
    run.trace = run.trace or run.spans
    run.traced_steps = steps


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda", cell: Cell | None = None):
    """One run; returns (result dict, checked [(name, value, limit)])."""
    PHASES.clear()
    cell = cell or Cell(workload)
    end_phase("imports")
    cuda = torch.device(device).type == "cuda"
    if cuda:
        require_cards(cell.chips)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.zeros(1, device=device)
        end_phase("cuda_init")
    work = cell.driver.build(cell, seed, device)
    _sync(device)
    t_window = time.perf_counter()
    run = Run(cell, work, t_window - t_start)
    log("set-up phases (s): " + json.dumps(phase_seconds(t_start,
                                                           t_window)))
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    sample = []
    if work.kind == "serve":
        run.steps, run.window_s, run.latencies, sample = serve_window(
            work, seconds, int(cell.traffic["sample_batches"]), seed, device)
        log(f"{run.steps} requests in {run.window_s:.3f} s; the latency "
            f"percentiles are over all {len(run.latencies)} of them")
    else:
        run.steps, run.window_s = train_window(work, seconds, device)
        log(f"{run.steps} train steps in {run.window_s:.3f} s")
    if cuda:
        run.window_peak_bytes = torch.cuda.max_memory_allocated()
    if trace:
        _traced(work, run, device, seed)
    memory_peak = max(setup_peak, torch.cuda.max_memory_allocated()) \
        if cuda else 0
    log("program counters: " + json.dumps(work.counters()))

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cell.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": memory_peak}
    result = {"correct": None, "attempted": run.steps, "failed": 0,
              "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.top_ops(),
                               "idle_gaps": run.spans.idle_gaps()}
    work.release()
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    checked = work.check(sample)
    log(f"the check took {time.perf_counter() - t:.1f} s")
    result["correct"] = all(v <= lim for _, v, lim in checked)
    result["checked"] = {n: {"value": v, "limit": lim}
                         for n, v, lim in checked}
    return result, checked
