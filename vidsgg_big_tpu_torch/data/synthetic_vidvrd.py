"""In-memory synthetic VidVRD data at the sizes the port's CLIs and
``chip_smoke.py`` run.

Records come from ``data/synthetic.make_video``.  With the config's
feature widths they follow bench.py's full-size record recipe (bench.py:
22-24, 79-87: 12 GT + 34 distractor tracklets per 480-frame video, packed
at N=50 tracklets x T=256 frames); otherwise they take the JAX CLIs'
small synthetic widths.  :func:`bench_train_batch` packs one train batch
at bench.py's BIG-C train geometry (bench.py:145-199).
"""
from __future__ import annotations

import torch

from .synthetic import make_video
from .transfer import batch_to_device
from .types import pack_gt, pack_proposal, stack_batches

FULL_SIZE_RECIPE = dict(video_len=480, n_gt_trajs=12, n_preds=16,
                        n_distractors=34)
FULL_SIZE_BUCKETS = dict(n_ladder=(50,), t_ladder=(256,))
# feature widths of the small records: 64 RoI + 16 I3D channels
SMALL_DIMS = (64, 16)
# the GT of bench.py's train batch: 16 trajectories x 256 frames x 32
# predicates
BENCH_GT_BUCKETS = dict(g_bucket=16, tg_bucket=256, p_bucket=32)


class SyntheticVidVRDSet:
    """N in-memory VidVRD-shaped videos: item i is the (proposal, GT)
    record pair of ``make_video(i)``, made when it is read; ``feat_dim`` is
    the config's RoI + I3D width with ``model_dims`` (bench.py's record
    recipe), else the small synthetic widths.  ``cfg`` is a BigCConfig."""

    def __init__(self, n_videos: int, cfg, model_dims: bool):
        self.n, self.cfg = n_videos, cfg
        if model_dims:
            self.feat_dim = cfg.dim_feat + (cfg.dim_i3d or 0)
            self.recipe = FULL_SIZE_RECIPE
        else:
            self.feat_dim, self.recipe = sum(SMALL_DIMS), {}

    def __len__(self):
        return self.n

    def __getitem__(self, i: int):
        return make_video(i, feat_dim=self.feat_dim,
                          num_enti_cats=self.cfg.num_enti_cats,
                          num_pred_cats=self.cfg.num_pred_cats, **self.recipe)


def bench_train_batch(cfg, b: int, device, wire: torch.dtype,
                      seed0: int = 0):
    """One train batch at bench.py's train geometry: ``b`` full-size
    synthetic videos (seeds ``seed0``...) on ``device``."""
    data = SyntheticVidVRDSet(seed0 + b, cfg, model_dims=True)
    n, t = FULL_SIZE_BUCKETS["n_ladder"][0], FULL_SIZE_BUCKETS["t_ladder"][0]
    rows = [data[i] for i in range(seed0, seed0 + b)]
    props = stack_batches([pack_proposal(p, n, t, data.feat_dim)
                           for p, _ in rows])
    gts = stack_batches([pack_gt(g, **BENCH_GT_BUCKETS) for _, g in rows])
    return batch_to_device(props, gts, torch.device(device), wire)
