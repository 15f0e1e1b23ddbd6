"""The judging of a serving run's sampled requests."""
from __future__ import annotations

import torch


def worst(sample, pool: int, expected, judge) -> dict:
    """The largest reading of each number over the sampled requests
    ``[(i, served)]``: request i served pool batch ``i % pool``, whose
    reference outputs ``expected(k)`` are worked out once, and ``judge(k,
    reference outputs, served)`` gives its numbers."""
    out, cache = {}, {}
    with torch.no_grad():
        for i, served in sample:
            k = i % pool
            if k not in cache:
                cache[k] = expected(k)
            for name, v in judge(k, cache[k], served).items():
                out[name] = max(out.get(name, 0.0), v)
    return out
