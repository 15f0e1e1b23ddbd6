"""Bipartite matching of predicate queries to ground truths.

Port of ``hungarian`` in the JAX package's ``ops/matching.py`` (:131, the
semantics of ``_assign_single`` :103-128).  The JAX package solves the
linear assignment on the device (``lap_jv``) only because its TPU runtime
had no host callbacks; the port does what the reference does (reference
models/model_0v10.py:606-639): ``scipy.optimize.linear_sum_assignment``
per video on the host.  The (B, Q, P) cost goes to the host once per
step and the assignment comes back as one tensor on the cost's device.
"""
from __future__ import annotations

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment

from ..utils.spans import span


@torch.no_grad()
def hungarian(cost, n_gt):
    """Exact minimum-cost assignment of queries to ground truths.

    Args:
      cost: (B, Q, P) cost of assigning query q to ground truth p (entries
        for p >= n_gt[b] are ignored).
      n_gt: (B,) number of valid ground truths per video (the first
        ``n_gt[b]`` of the P slots).

    Returns:
      (B, P) int64 on ``cost``'s device: the query assigned to each ground
      truth, -1 for padding and for the ground truths left unmatched when
      n_gt > Q (min(Q, n_gt) pairs, as scipy's rectangular assignment).
    """
    with span("match.fetch"):
        c = cost.detach().float().cpu().numpy()
        n = torch.as_tensor(n_gt).cpu().numpy()
    with span("match.solve"):
        out = np.full(c.shape[::2], -1, np.int64)
        for b in range(c.shape[0]):
            m = int(n[b])
            if m == 0:
                continue
            if not np.isfinite(c[b, :, :m]).all():
                raise ValueError(f"video {b}: non-finite matching cost")
            rows, cols = linear_sum_assignment(c[b, :, :m])
            out[b, cols] = rows
    with span("match.upload"):
        return torch.from_numpy(out).to(cost.device)
