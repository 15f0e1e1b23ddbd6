"""The port's staging ring (``data/transfer.StagingRing``): reused slots,
a producer blocked on a full ring and woken by ``close``, the size of a
failed allocation named, and, on the card, no slot refilled before the
copy out of it has completed.  Imports no JAX, so the card's test runs
there: ``python -m pytest --noconftest -m gpu tests/test_torch_data_ring.py``.
"""
import threading
import time

import pytest
import torch

from vidsgg_big_tpu_torch.data.prefetch import prefetch
from vidsgg_big_tpu_torch.data.transfer import RingClosed, StagingRing

LEAVES = {"a": ((2, 3), torch.float32), "b": ((5,), torch.bool),
          "c": ((2, 2), torch.bfloat16)}


def test_ring_reuses_its_slots():
    ring = StagingRing("cpu", slots=2)
    seen = []
    for i in range(6):
        views = ring.acquire(LEAVES)
        views["a"].fill_(i)
        seen.append(views["a"].data_ptr())
        out = ring.ship(views)
        assert torch.equal(out["a"], torch.full((2, 3), float(i)))
        assert out["a"].data_ptr() != views["a"].data_ptr()
    assert len(set(seen)) == 2            # two slots, allocated once each
    small = ring.acquire({"a": ((1,), torch.float32)})
    assert small["a"].data_ptr() in seen  # a smaller batch fits a slot
    ring.discard(small)


def test_ring_blocks_on_a_full_ring_and_close_wakes_it():
    ring = StagingRing("cpu", slots=1)
    held = ring.acquire(LEAVES)
    errors = []

    def producer():
        try:
            ring.acquire(LEAVES)
        except RingClosed as e:
            errors.append(e)

    t = threading.Thread(target=producer)
    t.start()
    time.sleep(0.3)
    assert t.is_alive()                   # no free slot
    ring.close()
    t.join(5)
    assert not t.is_alive() and len(errors) == 1
    with pytest.raises(ValueError, match="not lie in a slot"):
        ring.ship({"a": torch.zeros(3)})
    ring.discard(held)


def test_ring_names_the_size_of_a_failed_allocation(monkeypatch):
    ring = StagingRing("cpu")

    def refuse(*args, **kwargs):
        raise RuntimeError("out of memory")

    monkeypatch.setattr(torch, "empty", refuse)
    with pytest.raises(RuntimeError, match=r"staging slot of 1024 bytes"):
        ring.acquire({"a": ((256,), torch.float32)})


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (pinned memory and copy streams)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_ring_never_refills_a_slot_before_its_copy_completes(
        cuda_device):
    """A slow copy (each one queued behind a 50 ms kernel on the copy
    stream) and a fast producer: every batch arrives on the card with the
    values it was packed with, though the producer refills the two slots
    as fast as it can."""
    ring = StagingRing(cuda_device, slots=2)
    n, size = 12, 16 << 20
    out = []

    def packed():
        for i in range(n):
            views = ring.acquire({"x": ((size,), torch.float32)})
            views["x"].fill_(float(i))     # refill as fast as possible
            yield views

    for views in prefetch(packed(), size=1):
        with torch.cuda.stream(ring.copy_stream):
            # hold the copy stream so that the copy is still in flight
            # when the producer wants the slot back
            torch.cuda._sleep(50_000_000)
        out.append(ring.ship(views)["x"])
    torch.cuda.synchronize()
    for i, x in enumerate(out):
        assert torch.all(x == float(i)), i
