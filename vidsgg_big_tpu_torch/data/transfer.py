"""Host-to-device copies of packed batches.

The entry points stage every batch through a :class:`StagingRing`: the
producer (``data/prefetch.py``'s thread) packs a batch straight into a
reused pinned slot, and ``preput`` (``train/loop.run_epochs``) copies it to
the card on a copy stream of its own, so the copy of batch N+1 overlaps
step N on the device; the compute stream waits on the copy's event, and a
slot is refilled only after that event has completed.  Features travel in
the wire dtype (:func:`wire_dtype`): float32 or bfloat16 (a torch cast on
the host, the same round-to-nearest-even as the JAX package's
``ml_dtypes``), or int8 as packed (``BucketSpec(feat_dtype="int8")``, one
scale per video).  :func:`batch_to_device` is a plain copy of one batch,
for benchmarks and profiles that put a batch once.
"""
from __future__ import annotations

import collections
import dataclasses
import queue
import threading
from typing import Optional

import torch

# the byte alignment of each leaf inside a staging slot
_ALIGN = 256


def wire_dtype(feat_dtype: Optional[str], compute_dtype: str) -> torch.dtype:
    """Feature dtype of a train batch: ``feat_dtype`` where given
    (float32, bfloat16 or int8), else bf16 under bf16 compute (whose cast
    rounds as the model's own) and float32 otherwise."""
    if feat_dtype:
        return getattr(torch, feat_dtype)
    return torch.bfloat16 if compute_dtype == "bfloat16" else torch.float32


def to_device(x, device: torch.device) -> torch.Tensor:
    """One leaf on ``device``: a plain (pageable) copy."""
    return torch.as_tensor(x).to(device)


def wire_feats(feats, wire: torch.dtype) -> torch.Tensor:
    """Packed features in the wire dtype: a float cast on the host, or
    int8 features as they were packed (their scale rides in the batch)."""
    x = torch.as_tensor(feats)
    if (x.dtype == torch.int8) != (wire == torch.int8):
        raise ValueError(f"features packed as {x.dtype} cannot travel as "
                         f"{wire}: int8 is made at pack time "
                         "(BucketSpec.feat_dtype)")
    return x.to(wire)


def batch_to_device(props, gts, device: torch.device, wire: torch.dtype):
    """One numpy (TrackletBatch, GraphBatch) on ``device``, the features
    in ``wire`` (:func:`wire_feats`): a plain copy, for a batch put once."""
    p = {k: to_device(wire_feats(v, wire) if k == "feats" else v, device)
         for k, v in vars(props).items()}
    g = {k: to_device(v, device) for k, v in vars(gts).items()}
    return type(props)(**p), type(gts)(**g)


def tree_map(fn, tree):
    """``fn`` on every tensor of a batch: a tensor, a dataclass batch, a
    tuple, list or dict of them, or None (kept)."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree):
        return type(tree)(**{f.name: tree_map(fn, getattr(tree, f.name))
                             for f in dataclasses.fields(tree)})
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    raise TypeError(f"not a batch leaf: {type(tree)}")


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


class RingClosed(RuntimeError):
    """Raised in a producer waiting on a slot of a closed ring."""


class StagingRing:
    """Reused pinned host slots for batches on their way to ``device``.

    ``acquire(leaves)`` (producer) waits for a free slot whose last copy has
    completed, grows it where the batch needs more bytes, and returns a
    view per leaf to pack into; ``ship(batch)`` (consumer) copies a batch
    of those views to the device on the ring's copy stream, makes the
    current stream wait on the copy's event and frees the slot;
    ``discard(batch)`` frees a slot whose batch is not shipped.  A pinned
    allocation that fails raises with its size.  On the CPU the slots are
    ordinary memory and ``ship`` copies them (the tests' path).

    ``pack_seconds`` holds the producer's pack time of recent batches, and
    :meth:`h2d_report` the copies' device times.
    """

    def __init__(self, device, slots: int = 2):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.copy_stream = (torch.cuda.Stream(self.device) if self.cuda
                            else None)
        self._bufs: list = [None] * slots
        self._events: list = [None] * slots
        self._free: queue.Queue = queue.Queue()
        for i in range(slots):
            self._free.put(i)
        self._closed = threading.Event()
        self.pack_seconds: collections.deque = collections.deque(maxlen=4096)
        self._copies: collections.deque = collections.deque(maxlen=4096)
        self.allocated_bytes = 0

    # ---- producer side ---------------------------------------------------

    def acquire(self, leaves: dict) -> dict:
        """``leaves``: {name: (shape, torch dtype)} -> {name: host tensor
        view in one slot}.  Blocks until a slot is free and its last copy
        has completed."""
        while True:
            try:
                i = self._free.get(timeout=0.2)
                break
            except queue.Empty:
                if self._closed.is_set():
                    raise RingClosed("the staging ring was closed")
        if self._events[i] is not None:
            self._events[i].synchronize()     # its last copy has completed
        layout, total = {}, 0
        for name, (shape, dtype) in leaves.items():
            nbytes = torch.Size(shape).numel() * dtype.itemsize
            layout[name] = (total, nbytes, shape, dtype)
            total += -(-nbytes // _ALIGN) * _ALIGN
        buf = self._bufs[i]
        if buf is None or buf.numel() < total:
            self._bufs[i] = buf = None
            try:
                buf = torch.empty(total, dtype=torch.uint8,
                                  pin_memory=self.cuda)
            except RuntimeError as e:
                raise RuntimeError(
                    f"cannot allocate a staging slot of {total} bytes "
                    f"({total / 2 ** 30:.2f} GiB) of "
                    f"{'pinned' if self.cuda else 'host'} memory") from e
            self._bufs[i] = buf
            self.allocated_bytes = sum(b.numel() for b in self._bufs
                                       if b is not None)
        return {name: buf[off:off + nb].view(dtype).view(shape)
                for name, (off, nb, shape, dtype) in layout.items()}

    # ---- consumer side ---------------------------------------------------

    def _slot_of(self, tree) -> int:
        ptr = next(x.data_ptr() for x in tree_leaves(tree) if x.numel())
        for i, buf in enumerate(self._bufs):
            if buf is not None and \
                    buf.data_ptr() <= ptr < buf.data_ptr() + buf.numel():
                return i
        raise ValueError("the batch does not lie in a slot of this ring")

    def ship(self, tree):
        """The batch ``tree`` (views of one slot) on the device; frees the
        slot once the copy is issued."""
        i = self._slot_of(tree)
        if not self.cuda:
            out = tree_map(lambda x: x.to(self.device, copy=True), tree)
            self._free.put(i)
            return out
        compute = torch.cuda.current_stream(self.device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(self.copy_stream):
            start.record()
            out = tree_map(lambda x: x.to(self.device, non_blocking=True),
                           tree)
            end.record()
        compute.wait_event(end)
        nbytes = 0
        for x in tree_leaves(out):
            # allocated on the copy stream, used and freed on the compute
            # stream
            x.record_stream(compute)
            nbytes += x.numel() * x.element_size()
        self._events[i] = end
        self._copies.append((start, end, nbytes))
        self._free.put(i)
        return out

    def discard(self, tree) -> None:
        """Free the slot of a batch that is not shipped."""
        self._free.put(self._slot_of(tree))

    def close(self) -> None:
        """Wake a producer blocked in :meth:`acquire` (it raises
        :class:`RingClosed`)."""
        self._closed.set()

    def h2d_report(self) -> dict:
        """{"bytes", "ms"} of the recent copies, each copy's device time
        (waits for them to complete); empty on the CPU."""
        copies = list(self._copies)
        for _, end, _ in copies:
            end.synchronize()
        return {"bytes": [b for _, _, b in copies],
                "ms": [s.elapsed_time(e) for s, e, _ in copies]}

