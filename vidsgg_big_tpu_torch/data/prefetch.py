"""Host-side batch prefetching.

Port of the JAX package's ``data/prefetch.py``: a producer thread loads,
packs and stages batches into a bounded queue while the consumer runs the
step (the counterpart of the reference's DataLoader worker processes,
reference tools/train_vidvrd.py:105-112).  The copy to the card is not made
here: the consumer ships each staged batch (``data/transfer.StagingRing``)
on a copy stream one batch ahead of its step.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

_SENTINEL = object()


def prefetch(iterable: Iterable, size: int = 2) -> Iterator:
    """Iterate ``iterable`` on a background thread, ``size`` items ahead.

    Exceptions in the producer are re-raised in the consumer.  A consumer
    that abandons the generator (an exception or a break mid-epoch)
    releases the producer, which would otherwise block on a full queue
    forever, holding packed batches and the dataset iterator.
    """
    q: queue.Queue = queue.Queue(maxsize=size)
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for item in iterable:
                if not put(("ok", item)):
                    return
        except BaseException as e:  # noqa: BLE001 — raised in the consumer
            put(("err", e))
            return
        put((_SENTINEL, None))

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            kind, item = q.get()
            if kind is _SENTINEL:
                return
            if kind == "err":
                raise item
            yield item
    finally:
        stop.set()
        while True:
            try:
                q.get_nowait()
            except queue.Empty:
                break
