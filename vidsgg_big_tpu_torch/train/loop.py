"""Training-loop runtime for the CLI drivers.

Port of the JAX package's ``train/loop.py``:

* **Graceful stop**: a SIGTERM/SIGINT latch checked at step boundaries; on
  a stop the loop checkpoints its exact position and returns.
* **Exact mid-epoch resume**: the checkpoint sidecar carries ``(epoch,
  batch_in_epoch)``; a resume fast-forwards that epoch's deterministic
  batch stream (seeded shuffle + deterministic bucketing) by
  ``batch_in_epoch`` and goes on as an uninterrupted run would.
* **Deterministic per-step randomness**: step ``it`` draws its dropout and
  negative sampling from :func:`step_generator` ``(base_seed, it)``, a
  function of the *global* step (the counterpart of ``fold_in(base, it)``),
  so a resumed run draws what an uninterrupted run would.
* **Lagged metric fetch**: step N-1's loss is read (``.item()``, which
  waits for the card) after step N is dispatched; per-step ``loss/total``
  and ``time/step_ms`` go to metrics.jsonl at full float precision, and
  every ``JOURNAL_EVERY`` steps the ``extra_metrics`` keys as
  ``loss/<key>``.
* **Overlapped H2D**: ``preput`` moves batch N+1 to the card (a staged
  copy on a copy stream, ``data/transfer.StagingRing``) after step N is
  dispatched; each epoch's seconds and steps go to the journal as
  ``time/epoch_s`` and ``time/epoch_steps``.
"""
from __future__ import annotations

import signal
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .train_state import TrainState, save_checkpoint

JOURNAL_EVERY = 10      # steps between log lines


def install_stop_handler(logger=None) -> Callable[[], bool]:
    """Latch SIGTERM/SIGINT; returns ``should_stop()``.

    The first signal requests a graceful stop (finish the in-flight step,
    checkpoint, return); a second one restores the default disposition so
    a stuck process can still be killed."""
    flag = {"stop": False}

    def handler(signum, frame):
        if flag["stop"]:
            signal.signal(signum, signal.SIG_DFL)
            raise KeyboardInterrupt
        flag["stop"] = True
        if logger is not None:
            logger.info(f"signal {signum}: stopping at the next step "
                        "boundary (checkpoint will be written)")

    for s in (signal.SIGTERM, signal.SIGINT):
        signal.signal(s, handler)
    return lambda: flag["stop"]


def step_generator(base_seed: int, it: int) -> torch.Generator:
    """The CPU generator of global step ``it``: seeded by a hash of
    (base_seed, it), so its stream depends on nothing else."""
    seed = int(np.random.SeedSequence([int(base_seed), int(it)])
               .generate_state(1, np.uint64)[0] >> np.uint64(1))
    return torch.Generator().manual_seed(seed)


def run_epochs(state: TrainState, run_step, epoch_stream, *,
               start_epoch: int, total_epoch: int, base_seed: int, writer,
               logger, ckpt_dir: str, ckpt_every: int,
               start_batch: int = 0,
               extra_metrics: Sequence[str] = (),
               should_stop: Optional[Callable[[], bool]] = None,
               preput: Optional[Callable] = None,
               stop_after_batches: int = 0) -> TrainState:
    """Drive ``run_step`` over ``epoch_stream`` with checkpoint/resume.

    Args:
      run_step: ``(batch, generator) -> metrics``, updating ``state``;
        ``metrics`` holds ``"total"`` (a device scalar is fine: it is read
        one step later).
      epoch_stream: ``(epoch, skip) -> iterable of batches``; ``skip`` > 0
        only on the first (resumed) epoch, whose deterministic stream the
        implementation fast-forwards by that many batches.
      start_batch: batches already consumed in ``start_epoch`` (sidecar).
      extra_metrics: metric keys journaled (``loss/<key>``) and logged every
        ``JOURNAL_EVERY`` steps, on the lagged read, before the step's
        learning rate.
      preput: optional ``batch -> batch`` (the H2D copy), run one batch
        ahead of its step.
      stop_after_batches: test hook: behave as if SIGTERM arrived after
        this many batches (0 = never).
    """
    should_stop = should_stop or (lambda: False)
    it = state.step
    total_batches = 0
    pending = None          # (it, metrics, epoch) awaiting its lagged read
    t_prev = [time.perf_counter()]

    def flush_pending(losses):
        nonlocal pending
        if pending is None:
            return
        p_it, m, p_epoch = pending
        pending = None
        loss = float(m["total"])            # waits for the step to finish
        now = time.perf_counter()
        losses.append(loss)
        writer.add_scalar("loss/total", loss, p_it)
        writer.add_scalar("time/step_ms", (now - t_prev[0]) * 1000.0, p_it)
        t_prev[0] = now
        if p_it % JOURNAL_EVERY == 0:
            parts = []
            for k in extra_metrics:
                v = float(m[k])
                writer.add_scalar(f"loss/{k}", v, p_it)
                parts.append(f" {k}={v:.4f}")
            logger.info(f"epoch {p_epoch} it {p_it} loss {loss:.4f}"
                        + "".join(parts) + f" lr {state.lr(p_it - 1):.3g}")

    for epoch in range(start_epoch, total_epoch):
        t0 = time.time()
        skip = start_batch if epoch == start_epoch else 0
        if skip:
            logger.info(f"resume: fast-forwarding {skip} batches of "
                        f"epoch {epoch}")
        losses: list = []
        n_done = skip
        stopped = False
        t_prev[0] = time.perf_counter()
        stream = iter(epoch_stream(epoch, skip))
        end = object()

        def pull():
            nxt = next(stream, end)
            if preput is not None and nxt is not end:
                nxt = preput(nxt)
            return nxt

        nxt = pull()
        while nxt is not end:
            batch, nxt = nxt, None
            metrics = run_step(batch, step_generator(base_seed, it))
            it += 1
            n_done += 1
            total_batches += 1
            nxt = pull()                    # pack + H2D N+1 while N runs
            flush_pending(losses)           # read step N-1 while N runs
            pending = (it, metrics, epoch)
            if should_stop() or (stop_after_batches and
                                 total_batches >= stop_after_batches):
                stopped = True
                break
        if stopped and hasattr(stream, "close"):
            stream.close()
        flush_pending(losses)
        if stopped:
            save_checkpoint(ckpt_dir, state, it, epoch=epoch,
                            batch_in_epoch=n_done)
            logger.info(f"graceful stop: checkpoint at {ckpt_dir} "
                        f"(step {it}, epoch {epoch}, batch {n_done})")
            return state
        if losses:
            writer.add_scalar("loss/epoch_mean", float(np.mean(losses)),
                              epoch)
        writer.add_scalar("time/epoch_s", time.time() - t0, epoch)
        writer.add_scalar("time/epoch_steps", n_done, epoch)
        logger.info(f"epoch {epoch} done in {time.time() - t0:.1f}s, mean "
                    f"loss {np.mean(losses) if losses else float('nan'):.4f}")
        writer.flush()
        if (epoch + 1) % ckpt_every == 0 or epoch + 1 == total_epoch:
            save_checkpoint(ckpt_dir, state, it, epoch=epoch + 1)
            logger.info(f"checkpoint saved at {ckpt_dir} (step {it})")
    return state
