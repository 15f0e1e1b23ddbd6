"""The program's own spans in a traced run, and the device's idle time put
down to them.

The port marks the layers of its train and serve steps with spans
(``vidsgg_big_tpu_torch.utils.spans``), off unless recorded.  The first
reader of an ``idle_ms.*`` or ``host_ms.*`` metric in a ``--trace 1`` run
calls :func:`program_spans`, which runs one more window of the cell's
``trace_steps`` steps through :func:`~.session.serve_window` or
:func:`~.session.train_window` with the spans recorded and, on the card,
under a CUDA-only ``torch.profiler`` pass between two marker kernels, and
caches what it found on the run (``run.program_spans``).  Serving records
the copy of a request's outputs to the host (``d2h``) beside the program's
spans.

**The shared clock.**  The spans are on the host's ``perf_counter_ns``.  A
CUDA-only profile holds the device's operations and, on the host's side,
the CUDA calls that launched them, each pair under one correlation id.  On
an H100 with torch 2.11 the device's timestamps in such a profile drift
against its host-side timestamps by up to 2 ms within one pass (a kernel
can read as starting 2 ms before its launch call), so the device's clock
cannot be tied to the host's through a marker kernel's start.  The host
side of the profile can: after a synchronize, the host's clock is read just
before each marker's launch, and each marker's offset is its launch call's
start in the profile minus that reading.  The two offsets agree up to the
Python between the reading and the call; where they differ by more than
:data:`MAX_SKEW_US`, or the profile lost a marker, the pass runs again,
:data:`ATTEMPTS` times in all, and then gives up (the idle readers return
None and the log says why).

**Attribution.**  The idle gaps are those of :class:`~.trace.Trace`: the
gaps between the merged busy intervals of the device's operations between
the two markers (``Trace.from_profile(prof, marked=True)``).  A device
waits only for work not yet launched, so a gap ends when the host's launch
of the operation after it reaches the device: the gap is put on the host's
clock as its length on the device's clock, ending at that launch call
(mapped with the first offset), and goes to the innermost span around its
middle, the harness's rule.  It counts for that span and each of its
ancestors; gaps under no span are ``between_steps``.  Each launch call
between the markers is counted for the innermost span around it the same
way.

The profile slows each launch on the host, so a span's idle in this pass
is an upper reading: it holds the profiler's cost for each of the span's
launches.  The log gives each span's launches beside its idle and that
cost per launch (the pass's ms a step less the untraced window's, over
the launches a step); a gain is claimed on the end-to-end metrics, not on
``idle_ms.*``.

The pass leaves the run's window, trace, latencies and memory peaks as
they were: all of those are taken before any reader runs.  On the CPU (the
benchmark's tests) it records the spans alone: host times, no idle.
"""
from __future__ import annotations

import json
import time

import torch

from .session import log, serve_window, train_window
from .trace import MARKER, Trace, marker

try:
    from vidsgg_big_tpu_torch.utils import spans
except ImportError:          # a program without the span recorder
    spans = None

MAX_SKEW_US = 50.0
ATTEMPTS = 3
# host seconds around the markers inside the profile, so that the drift of
# the device's timestamps cannot put a marker outside the profiled span
PAD_S = 0.05
# small kernels launched at each end of the profile, outside the markers:
# once a process has run a few profiler sessions (this pass is its third),
# a CUDA-only profile on the card loses the first and last few device
# records of a session, and these take that loss in the markers' place
EDGE_KERNELS = 64


def program_spans(run):
    """The pass's summary (see :func:`summarize`), run once per run; None
    where the program has no span recorder."""
    if not hasattr(run, "program_spans"):
        run.program_spans = _measure(run)
    return run.program_spans


def idle_ms(run, name, roots):
    """Device idle ms a step under span ``name`` of a step whose root is
    one of ``roots``; None without a device trace."""
    found = program_spans(run)
    if found is None or found["idle_ms"] is None or \
            not set(roots) & set(found["roots"]):
        return None
    return found["idle_ms"].get(name)


def host_ms(run, name, roots):
    """Host ms a step inside span ``name`` of a step whose root is one of
    ``roots``."""
    found = program_spans(run)
    if found is None or not set(roots) & set(found["roots"]):
        return None
    return found["host_ms"].get(name)


def clock_offsets(stamps_ns, calls_us):
    """Each marker's launch call's start in the profile (microseconds)
    minus the host's reading just before it (``perf_counter_ns``), in
    microseconds."""
    return [c - h / 1e3 for h, c in zip(stamps_ns, calls_us)]


def clocks_agree(offsets) -> bool:
    return abs(offsets[1] - offsets[0]) <= MAX_SKEW_US


def idle_gaps(ops, window, last_call):
    """[(microseconds, launch call's start)]: the device's idle gaps inside
    ``window`` between the merged busy intervals of ``ops`` ((start, end,
    launch call's start or None) on the profile's clock), each with the
    launch call of the operation that ends it (``last_call``, the second
    marker's, for the gap that runs to the window's end)."""
    busy = []
    for s, e, call in sorted(ops, key=lambda op: op[:2]):
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], e)
        else:
            busy.append([s, e, call])
    gaps, cursor = [], window[0]
    for s, e, call in busy:
        if s > cursor:
            gaps.append((s - cursor, call))
        cursor = max(cursor, e)
    if window[1] > cursor:
        gaps.append((window[1] - cursor, last_call))
    return gaps


def _innermost(spans_us, t):
    around = [(t1 - t0, i) for t0, t1, i in spans_us if t0 <= t <= t1]
    return min(around)[1] if around else "between_steps"


def _host_spans(records):
    return [(r.t0_ns / 1e3, r.t1_ns / 1e3, i) for i, r in enumerate(records)]


def attribute(records, gaps, offset_us):
    """{record index, "between_steps" or "unanchored": idle microseconds}:
    each gap of :func:`idle_gaps` put on the host's clock (ending at its
    launch call less ``offset_us``) and given to the innermost record
    around its middle; ``unanchored`` where the profile lacks the call."""
    spans_us = _host_spans(records)
    out = {}
    for us, call in gaps:
        key = "unanchored" if call is None else \
            _innermost(spans_us, call - offset_us - us / 2)
        out[key] = out.get(key, 0.0) + us
    return out


def count_launches(records, calls, offset_us):
    """{record index or "between_steps": launch calls}: each launch call
    (its start on the profile's host clock) given to the innermost record
    around it on the host's clock."""
    spans_us = _host_spans(records)
    out = {}
    for call in calls:
        key = _innermost(spans_us, call - offset_us)
        out[key] = out.get(key, 0) + 1
    return out


def _rolled_up(records, by_index, scale):
    """{span name: sum of ``by_index``'s values over its records and their
    descendants, times ``scale``}."""
    total = {r.name: 0.0 for r in records}
    for i, value in by_index.items():
        if isinstance(i, str):
            continue
        while i is not None:
            total[records[i].name] += value * scale
            i = records[i].parent
    return total


def summarize(records, steps, idle=None, launches=None):
    """Per step: each span name's host ms (``host_ms``) and, with ``idle``
    (:func:`attribute`'s result), its idle ms counted with its
    descendants' (``idle_ms``), the idle under each root but under none of
    its children (``root_self_idle_ms``), ``between_steps_ms``,
    ``unanchored_ms`` and the whole (``idle_total_ms``); with ``launches``
    (:func:`count_launches`'s result), each span's launch calls counted
    with its descendants' (``launches``) and the whole
    (``launches_total``)."""
    out = {"steps": steps,
           "roots": sorted({r.name for r in records if r.parent is None}),
           "host_ms": {}, "idle_ms": None}
    for r in records:
        out["host_ms"][r.name] = out["host_ms"].get(r.name, 0.0) + \
            (r.t1_ns - r.t0_ns) / 1e6 / steps
    if idle is None:
        return out
    out["idle_ms"] = _rolled_up(records, idle, 1e-3 / steps)
    own = {r.name: 0.0 for r in records if r.parent is None}
    for i, us in idle.items():
        if not isinstance(i, str) and records[i].parent is None:
            own[records[i].name] += us / 1e3 / steps
    out["root_self_idle_ms"] = own
    for key in ("between_steps", "unanchored"):
        out[key + "_ms"] = idle.get(key, 0.0) / 1e3 / steps
    out["idle_total_ms"] = sum(idle.values()) / 1e3 / steps
    if launches is not None:
        out["launches"] = _rolled_up(records, launches, 1 / steps)
        out["launches_total"] = sum(launches.values()) / steps
    return out


def _window(work, steps, device):
    if work.kind == "serve":
        return serve_window(work, 0, 0, 0, device, steps=steps)[1]
    return train_window(work, 0, device, steps=steps)[1]


def _on_card(work, steps):
    """One window under the recorder and a CUDA-only profile between two
    markers: (records, seconds, profile, host readings)."""
    stamps = []
    edge = torch.zeros(1, device="cuda")

    def edge_kernels():
        for _ in range(EDGE_KERNELS):
            edge.zero_()
        torch.cuda.synchronize()
    cuda_only = [torch.profiler.ProfilerActivity.CUDA]
    with spans.recording() as records, \
            torch.profiler.profile(activities=cuda_only) as prof:
        time.sleep(PAD_S)
        # the launches also warm the host's path to the first marker's
        edge_kernels()
        stamps.append(time.perf_counter_ns())
        marker()
        seconds = _window(work, steps, "cuda")
        torch.cuda.synchronize()
        stamps.append(time.perf_counter_ns())
        marker()
        edge_kernels()
        time.sleep(PAD_S)
    return records, seconds, prof, stamps


def _read_profile(prof):
    """(the markers' launch calls' starts, the idle gaps of
    :func:`idle_gaps`, the starts of the launch calls of the device's
    operations between the markers), or None where the profile lacks a
    marker or its launch call."""
    calls, kernel_ids, markers = {}, {}, []
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CPU:
            if ev.id and ev.name.startswith("cu"):    # CUDA's API calls
                calls.setdefault(ev.id, ev.time_range.start)
        elif MARKER in ev.name:
            markers.append((ev.time_range.start, ev.id))
        else:
            kernel_ids[ev.name, ev.time_range.start, ev.time_range.end] = \
                ev.id
    marker_calls = [calls.get(i) for _, i in sorted(markers)]
    if len(marker_calls) != 2 or None in marker_calls:
        return None
    trace = Trace.from_profile(prof, marked=True)
    ops = [(s, e, calls.get(kernel_ids.get((n, s, e))))
           for n, s, e, _ in trace.ops]
    launched = sorted({call for _, _, call in ops if call is not None})
    return (marker_calls, idle_gaps(ops, trace.window, marker_calls[1]),
            launched)


def _pass(work, steps, cuda):
    """The pass's summary with its host seconds (``seconds``) and, on the
    card (``cuda``), the markers' offsets."""
    if not cuda:
        with spans.recording() as records:
            seconds = _window(work, steps, "cpu")
        return dict(summarize(records, steps), seconds=seconds)
    offsets = []
    for attempt in range(ATTEMPTS):
        records, seconds, prof, stamps = _on_card(work, steps)
        found = _read_profile(prof)
        if found is None:
            log("program spans: the profile lacks a marker kernel or its "
                f"launch call in pass {attempt + 1}")
            continue
        calls, gaps, launched = found
        offsets = clock_offsets(stamps, calls)
        if clocks_agree(offsets):
            return dict(summarize(
                records, steps, attribute(records, gaps, offsets[0]),
                count_launches(records, launched, offsets[0])),
                seconds=seconds, offsets_us=offsets)
        log(f"program spans: the markers' clock offsets differ by "
            f"{abs(offsets[1] - offsets[0]):.1f} us (limit {MAX_SKEW_US}) "
            f"in pass {attempt + 1}")
    log(f"program spans: no idle is put down to the spans: no pass of "
        f"{ATTEMPTS} gave two markers on which the clocks agree")
    return dict(summarize(records, steps), seconds=seconds,
                offsets_us=offsets)


def _measure(run):
    if spans is None:
        log("program spans: the program has no span recorder")
        return None
    work = run.work
    steps = int(run.cell.traffic["trace_steps"])
    mark = work.mark if work.kind == "serve" else None
    if mark is not None:
        work.mark = spans.span
    # the run's own passes: on the card its device's pass is a trace of
    # its own, on the CPU the annotated pass stands for it
    cuda = run.trace is not run.spans
    try:
        found = _pass(work, steps, cuda)
    finally:
        if mark is not None:
            work.mark = mark
    found["pass_ms_per_step"] = 1e3 * found.pop("seconds") / steps
    found["window_ms_per_step"] = 1e3 * run.window_s / max(run.steps, 1)
    if found.get("launches_total"):
        # the tracing's cost per launch (the profiler's, and the spans'
        # own), which each span's idle includes
        found["profiler_us_per_launch"] = 1e3 * (
            found["pass_ms_per_step"] - found["window_ms_per_step"]) / \
            found["launches_total"]
    log("program spans: " + json.dumps(found))
    return found
