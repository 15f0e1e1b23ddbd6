"""The port's span recorder: where in a train or serve step the host spends
its time.

The steps mark their layers with ``with span("forward"): ...``.  Spans are
off unless a caller records them::

    with recording() as records:
        step(...)
    # records: [Record(name, parent, t0_ns, t1_ns), ...]

Off, :func:`span` returns one shared no-op object: nothing is allocated,
timed or handed to the profiler, so a step does exactly what it does
without spans.  On, each span appends a :class:`Record` on
``time.perf_counter_ns()`` and opens ``torch.profiler.record_function``
under its name, so a CPU + CUDA profile shows the spans beside the kernels
on the profiler's own clock.  ``parent`` is the index of the enclosing
span's record, None for a step call's root.  Only the thread that entered
:func:`recording` records; spans are off while ``torch.export`` or
``torch.compile`` traces, so an exported program holds none.
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import NamedTuple

import torch


class Record(NamedTuple):
    name: str
    parent: int | None
    t0_ns: int
    t1_ns: int | None        # None while the span is open


class _Off:
    """What :func:`span` returns when spans are off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Recording:
    def __init__(self):
        self.records: list[Record] = []
        self.open: list[int] = []           # indices of the open spans
        self.thread = threading.get_ident()


# the recording in progress, or None: spans are off
_active: _Recording | None = None


class _Span:
    __slots__ = ("rec", "name", "index", "fn")

    def __init__(self, rec: _Recording, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        rec = self.rec
        parent = rec.open[-1] if rec.open else None
        self.index = len(rec.records)
        self.fn = torch.profiler.record_function(self.name)
        self.fn.__enter__()
        rec.records.append(Record(self.name, parent, time.perf_counter_ns(),
                                  None))
        rec.open.append(self.index)
        return self

    def __exit__(self, *exc):
        rec = self.rec
        t1 = time.perf_counter_ns()
        rec.records[self.index] = rec.records[self.index]._replace(t1_ns=t1)
        rec.open.pop()
        self.fn.__exit__(*exc)
        return False


def span(name: str):
    """A context manager that records ``name`` around its body while a
    :func:`recording` is in progress on this thread; otherwise the shared
    no-op."""
    rec = _active
    if rec is None or rec.thread != threading.get_ident() or \
            torch.compiler.is_compiling():
        return _OFF
    return _Span(rec, name)


@contextmanager
def recording():
    """Turn spans on for the calling thread; yields the list of
    :class:`Record` the spans append to, complete once the block exits."""
    global _active
    if _active is not None:
        raise RuntimeError("spans are already being recorded")
    _active = _Recording()
    try:
        yield _active.records
    finally:
        _active = None
