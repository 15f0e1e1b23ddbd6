"""The device trace of a run's traced windows, read from ``torch.profiler``.

The device's pass records CUDA activity alone; its window runs from the end
of a first marker kernel (:func:`marker`) to the start of a second, each
launched while the device is idle.  The annotated pass adds the CPU
activity; the benchmark marks its own host spans there with
``record_function``: ``bench.window`` around the whole window and, inside
it, ``step`` (the call into the program), ``loss_fetch`` (a train step's
lagged loss read), ``d2h`` (a request's outputs to the host) and ``sync``
(the closing synchronize).  From a trace: every device operation's
interval, the spans' intervals, and from those the busy seconds, the
kernels by name, and the idle gaps named by the innermost benchmark span
around them.
"""
from __future__ import annotations

import re
from contextlib import contextmanager, nullcontext

import torch

SPANS = ("step", "loss_fetch", "d2h", "sync")
WINDOW_SPAN = "bench.window"
# the kernel of torch.cuda._sleep, which nothing else launches
MARKER = "spin_kernel"


def marker():
    """A kernel of about a microsecond that bounds the device's pass."""
    torch.cuda._sleep(1000)


@contextmanager
def span(name: str):
    with torch.profiler.record_function(name):
        yield


def no_span(name: str):
    """What a driver marks its spans with outside the traced window."""
    return nullcontext()


def _merged(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Trace:
    """Intervals in microseconds on the profiler's clock.

    ``ops``: (name, start, end, is_kernel) of every device operation inside
    the window; ``spans``: (name, start, end) of the benchmark's host spans;
    ``window``: (start, end) of ``bench.window``.
    """

    def __init__(self, ops, spans, window):
        self.ops, self.spans, self.window = ops, spans, window

    @classmethod
    def from_profile(cls, prof, marked: bool = False) -> "Trace":
        """``marked``: the window lies between the two marker kernels
        (the device's pass), else it is the ``bench.window`` span."""
        events = prof.events()
        window, spans, ops, marks = None, [], [], []
        for ev in events:
            tr = ev.time_range
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                if getattr(ev, "is_user_annotation", False):
                    continue
                name = ev.name
                if MARKER in name:
                    marks.append((tr.start, tr.end))
                    continue
                kernel = not name.startswith(("Memcpy", "Memset"))
                ops.append((name, tr.start, tr.end, kernel))
            elif ev.name == WINDOW_SPAN:
                window = (tr.start, tr.end)
            elif ev.name in SPANS:
                spans.append((ev.name, tr.start, tr.end))
        if marked:
            if len(marks) != 2:
                raise RuntimeError(f"the device's pass holds {len(marks)} "
                                   "marker kernels, not 2")
            (_, lo), (hi, _) = sorted(marks)
            window = (lo, hi)
        if window is None:
            raise RuntimeError("the trace holds no bench.window span")
        lo, hi = window
        ops = [(n, max(s, lo), min(e, hi), k) for n, s, e, k in ops
               if e > lo and s < hi]
        return cls(ops, spans, window)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    @property
    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        return sum(e - s for s, e in _merged(
            [(s, e) for _, s, e, _ in self.ops])) * 1e-6

    def kernels(self, pattern: str | None = None):
        """(name, seconds) of every kernel launch, or of those whose name
        matches the regular expression ``pattern``."""
        rx = re.compile(pattern) if pattern else None
        return [(n, (e - s) * 1e-6) for n, s, e, k in self.ops
                if k and (rx is None or rx.search(n))]

    def top_ops(self, count: int = 10):
        """[name, seconds] of the device operations that took most time."""
        total = {}
        for n, s, e, _ in self.ops:
            total[n] = total.get(n, 0.0) + (e - s) * 1e-6
        top = sorted(total.items(), key=lambda kv: -kv[1])[:count]
        return [[n[:160], sec] for n, sec in top]

    def idle_gaps(self, count: int = 10):
        """[name, seconds]: the idle time of the device inside the window,
        summed by the innermost benchmark span around each gap's middle
        (``outside`` where none is), longest first."""
        busy = _merged([(s, e) for _, s, e, _ in self.ops])
        gaps, cursor = [], self.window[0]
        for s, e in busy:
            if s > cursor:
                gaps.append((cursor, s))
            cursor = max(cursor, e)
        if self.window[1] > cursor:
            gaps.append((cursor, self.window[1]))
        total = {}
        for s, e in gaps:
            mid = 0.5 * (s + e)
            around = [(se - ss, n) for n, ss, se in self.spans
                      if ss <= mid <= se]
            name = min(around)[1] if around else "outside"
            total[name] = total.get(name, 0.0) + (e - s) * 1e-6
        return [[n, sec] for n, sec in
                sorted(total.items(), key=lambda kv: -kv[1])[:count]]
