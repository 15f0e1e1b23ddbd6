"""Device-resident per-video record cache: epochs after the first take no
host-to-device copy.

Port of the JAX package's ``data/device_cache.py`` for GPU memory:

  * **Epoch 0** runs the host pipeline (disk, pack, staged H2D copy).  As
    each shipped batch arrives, :meth:`DeviceRecordCache.offer` captures
    each new video's packed record as a copy of its row of the batch on the
    card, and remembers its bucket key.
  * **Epochs >= 1** (once every required video is cached) skip the disk,
    the packing and the copy: :meth:`epoch_descriptors` regroups the
    epoch's shuffled names with the same ``stream_buckets`` over the same
    ``default_rng(seed)`` permutation as the host path, and
    :meth:`assemble` stacks the cached records into a batch on the card.

Batches are bit-identical to the host path's: the same records, grouping
and repeat masking.  The cache is all-or-nothing: where the split does not
fit ``budget_bytes``, or a video never surfaces in a full epoch (a
redirecting video), every epoch stays on the host path.  Unlike the JAX
package's (the defect of its ``offer``, ADVICE.md), the records already
captured do not stay on the card for nothing: they are freed when the
budget is exceeded, and the cache is dropped when a full host epoch left
it incomplete.  That departs from JAX in memory only.
"""
from __future__ import annotations

import random
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .bucketing import stream_buckets
from .transfer import tree_leaves, tree_map


def _nbytes(tree, i: int) -> int:
    """Bytes of row ``i`` of every leaf of a batch."""
    return sum(x[i].numel() * x.element_size() for x in tree_leaves(tree))


def _stack(trees):
    """The leafwise stack of same-shaped records along a new batch axis."""
    first = trees[0]
    if first is None:
        return None
    return type(first)(**{name: torch.stack([getattr(t, name)
                                             for t in trees])
                          for name in vars(first)})


class DeviceRecordCache:
    """See the module docstring.

    Args:
      name_list: dataset order of video names (``dataset.video_name_list``):
        epoch shuffles permute indices of this list as
        ``bucketing.iter_shuffled`` does.
      batch_size: the batch size (grouping granularity).
      budget_bytes: device-memory budget; once exceeded the captured
        records are freed and the cache stays incomplete.
      skip_names: names ``__getitem__`` always redirects away from (the
        reference's by-name skip, reference
        dataloaders/dataloader_vidvrd.py:209-211): not required, and
        redirected identically (a fresh ``random.randint`` draw) when a
        cached epoch meets one.
    """

    def __init__(self, name_list: Sequence[str], batch_size: int,
                 budget_bytes: float, skip_names: Iterable[str] = ()):
        self.name_list = list(name_list)
        self.batch_size = batch_size
        self.budget = float(budget_bytes)
        self.skip_names = set(skip_names)
        self.required = [n for n in self.name_list
                         if n not in self.skip_names]
        self.records: Dict[str, Tuple[object, object]] = {}
        self.keys: Dict[str, tuple] = {}
        self.bytes = 0
        self.over_budget = False
        self.dropped = False
        self.first_cached_epoch: Optional[int] = None
        # a host epoch from its first batch was started (and, since the
        # trainer asks for the next epoch, finished)
        self.saw_full_host_epoch = False

    # ---- epoch-0 capture ---------------------------------------------------

    def offer(self, key, rows, props, gts) -> None:
        """Capture the uncached videos of a shipped batch.

        ``rows`` are the batch's real records (``bucketed_batches`` trims
        the repeats), so row ``i`` < len(rows) is an unmodified row of the
        batch on the card.
        """
        if self.over_budget or self.dropped:
            return
        for i, row in enumerate(rows):
            name = row[0].video_name
            if name in self.records:
                continue
            nbytes = _nbytes(props, i) + (_nbytes(gts, i)
                                          if gts is not None else 0)
            if self.bytes + nbytes > self.budget:
                self.over_budget = True
                self.free()
                return
            self.records[name] = (
                tree_map(lambda x: x[i].clone(), props),
                tree_map(lambda x: x[i].clone(), gts))
            self.keys[name] = key
            self.bytes += nbytes

    def free(self) -> None:
        """Release every captured record."""
        self.records, self.keys, self.bytes = {}, {}, 0

    def drop(self) -> None:
        """Free the records and never cache again."""
        self.dropped = True
        self.free()

    @property
    def complete(self) -> bool:
        return (not self.over_budget and not self.dropped and
                all(n in self.records for n in self.required))

    def summary(self) -> dict:
        return dict(videos=len(self.records), bytes=self.bytes,
                    complete=self.complete, over_budget=self.over_budget,
                    dropped=self.dropped,
                    first_cached_epoch=self.first_cached_epoch)

    # ---- cached epochs -----------------------------------------------------

    def _resolve(self, idx: int) -> str:
        # the dataset's by-name redirect; videos that redirect on content
        # never surface, which keeps `complete` False and the host path on
        name = self.name_list[idx]
        while name in self.skip_names:
            name = self.name_list[random.randint(0, len(self.name_list) - 1)]
        return name

    def epoch_descriptors(self, seed: int):
        """Yield ``(key, names)`` for one shuffled epoch: the batches of
        ``bucketed_batches(iter_shuffled(dataset, seed))``."""
        rng = np.random.default_rng(seed)
        names = (self._resolve(int(i))
                 for i in rng.permutation(len(self.name_list)))
        for key, rows, n_real in stream_buckets(
                names, lambda n: self.keys[n], self.batch_size):
            yield key, rows[:n_real]

    def assemble(self, key, names: List[str]):
        """Stack cached records into a batch on the card, the repeats that
        pad it masked out as ``bucketed_batches`` masks them."""
        rows = list(names)
        while len(rows) < self.batch_size:
            rows.append(rows[-1])
        props = _stack([self.records[n][0] for n in rows])
        gts = _stack([self.records[n][1] for n in rows])
        real = (torch.arange(self.batch_size) < len(names)).to(
            props.traj_mask.device)
        props = props.replace(traj_mask=props.traj_mask & real[:, None])
        if gts is not None:
            gts = gts.replace(traj_mask=gts.traj_mask & real[:, None],
                              pred_mask=gts.pred_mask & real[:, None])
        return props, gts


# ---- CLI wiring (train_vidvrd and train_vidor's classification modes) -----

def make_cache(args, dataset, batch_size, mesh=None, skip_names=()):
    """A cache where eligible: a run on one device (``mesh`` None),
    ``--device_cache_gb`` > 0 and a dataset with ``video_name_list``."""
    if mesh is not None:
        return None
    gb = getattr(args, "device_cache_gb", 4.0)
    if not gb or gb <= 0 or not hasattr(dataset, "video_name_list"):
        return None
    return DeviceRecordCache(dataset.video_name_list, batch_size, gb * 1e9,
                             skip_names=skip_names)


def cached_or_host_epoch(cache, epoch, logger, host_gen, skip: int = 0):
    """The epoch's stream: ``(key, names, None, None)`` descriptors once the
    cache is complete, else ``host_gen()`` (a thunk: the host pipeline is
    not built for cached epochs).  ``skip`` is the batches a resumed epoch
    skips; a host epoch asked for with ``skip`` 0 is a full one, and a
    cache that a full host epoch left incomplete is dropped here."""
    if cache is None:
        return host_gen()
    if cache.saw_full_host_epoch and not cache.complete and \
            not cache.dropped:
        n, nbytes = len(cache.records), cache.bytes
        cache.drop()
        if logger is not None:
            logger.info(f"device cache incomplete after a full epoch "
                        f"(over budget: {cache.over_budget}): dropped, "
                        f"{n} records ({nbytes / 1e9:.2f} GB) freed")
    if cache.complete:
        if cache.first_cached_epoch is None:
            cache.first_cached_epoch = epoch
            if logger is not None:
                logger.info(
                    f"device cache complete: {len(cache.records)} videos, "
                    f"{cache.bytes / 1e9:.2f} GB on the device; epoch "
                    f"{epoch}+ takes no host-to-device copy")
        return ((k, names, None, None)
                for k, names in cache.epoch_descriptors(epoch))
    if skip == 0:
        cache.saw_full_host_epoch = True
    return host_gen()
