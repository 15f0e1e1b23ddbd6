"""The generator of VidVRD-shaped tracklet batches, made on the device from a
traffic mix's parameters (``benchmark/workloads/*.json``) and a seed.

Every batch of a mix has the same shape and the same number of valid
tracklets; the seed draws their lengths, places, boxes, features, classes
and scores.  A trajectory of L <= T frames starts anywhere in the video;
its frames are stored un-stretched, zero past L (the port's
``TrackletBatch`` layout, with the stretch gather index beside them).
Training mixes add a GT scene graph of ``gt_trajs`` trajectories (proposal
tracklets jittered around them, the rest distractors) and ``gt_preds``
predicates between overlapping pairs.
"""
from __future__ import annotations

import torch


def stretch_gather_index(lengths, t: int):
    """(..., T) int32: stretched step k reads frame idx[k], frame j of L
    repeated ceil((T - j) / L) times."""
    L = lengths.clamp(min=1).long()[..., None]
    j = torch.arange(t, device=lengths.device)
    counts = torch.where(j < L, torch.div(t - j + L - 1, L,
                                          rounding_mode="floor"), 0)
    ends = torch.cumsum(counts, -1)
    k = j.expand(*lengths.shape, t).contiguous()
    return torch.searchsorted(ends, k, right=True).clamp(max=t - 1).to(
        torch.int32)


def _boxes(g, b, n, t, w, h, device):
    """Random-walk boxes (B, N, T, 4) in pixels."""
    def u(lo, hi):
        return lo + (hi - lo) * torch.rand(b, n, 1, generator=g,
                                           device=device)
    x0, y0 = u(0.0, 0.6 * w), u(0.0, 0.6 * h)
    bw, bh = u(0.1 * w, 0.4 * w), u(0.1 * h, 0.4 * h)
    walk = torch.cumsum(2.0 * torch.randn(b, n, t, 2, generator=g,
                                          device=device), 2)
    x1 = (x0 + walk[..., 0]).clamp(0.0, w - 2.0)
    y1 = (y0 + walk[..., 1]).clamp(0.0, h - 2.0)
    return torch.stack([x1, y1, (x1 + bw).clamp(max=w), (y1 + bh)
                        .clamp(max=h)], -1)


def tracklet_batch(p: dict, m: dict, g, device) -> dict:
    """One batch of ``p["batch"]`` videos as a dict of device tensors with
    the port's ``TrackletBatch`` fields; ``m`` is the ``model_config``."""
    b, n, t = p["batch"], p["slots"], p["frames"]
    vlen, nv = p["video_len"], p["tracklets"]
    w, h = p["video_wh"]
    d = m["dim_feat"] + (m.get("dim_i3d") or 0)
    valid = (torch.arange(n, device=device) < nv).expand(b, n)
    length = torch.randint(p["min_len"], t + 1, (b, n), generator=g,
                           device=device)
    start = (torch.rand(b, n, generator=g, device=device)
             * (vlen - length + 1)).floor().long()
    length = torch.where(valid, length, 1)
    start = torch.where(valid, start, 0)
    frames = (torch.arange(t, device=device) < length[..., None]) \
        & valid[..., None]
    feats = 2.0 * torch.rand(b, n, t, d, generator=g, device=device)
    feats *= frames[..., None]
    boxes = _boxes(g, b, n, t, w, h, device) * frames[..., None]
    cats = torch.randint(1, m["num_enti_cats"], (b, n), generator=g,
                         device=device)
    scores = 0.3 + 0.7 * torch.rand(b, n, generator=g, device=device)
    return {
        "feats": feats, "boxes": boxes,
        "stretch_idx": stretch_gather_index(length, t),
        "durations": torch.stack([start, start + length - 1], -1).to(
            torch.int32),
        "cat_ids": (cats * valid).to(torch.int32),
        "scores": scores * valid,
        "traj_mask": valid.clone(),
        "video_len": torch.full((b,), vlen, dtype=torch.int32,
                                device=device),
        "video_wh": torch.tensor([float(w), float(h)],
                                 device=device).expand(b, 2).clone(),
        "feat_scale": torch.ones(b, device=device),
    }


def train_batch(p: dict, m: dict, g, device) -> tuple:
    """(proposals, GT) of one train batch: ``gt_trajs`` GT trajectories of
    ``gt_slots``, each of ``gt_min_len`` to T frames from a start of at
    most ``gt_max_start`` (with 150 of 256 and 100 all cover frames
    100-149, so every pair overlaps), ``gt_preds`` predicates of
    ``pred_slots`` between distinct pairs; the first proposals are the GT
    trajectories with their boxes jittered by a few pixels, the rest
    distractors as in :func:`tracklet_batch`.  Both as dicts of the
    port's ``TrackletBatch`` and ``GraphBatch`` fields."""
    props = tracklet_batch(p, m, g, device)
    b, gs, ng, t = p["batch"], p["gt_slots"], p["gt_trajs"], p["frames"]
    ps, npred = p["pred_slots"], p["gt_preds"]
    w, h = p["video_wh"]
    gvalid = (torch.arange(gs, device=device) < ng).expand(b, gs)
    length = torch.randint(p["gt_min_len"], t + 1, (b, gs), generator=g,
                           device=device)
    start = torch.randint(0, p["gt_max_start"] + 1, (b, gs), generator=g,
                          device=device)
    length, start = torch.where(gvalid, length, 1), torch.where(gvalid,
                                                                start, 0)
    frames = (torch.arange(t, device=device) < length[..., None]) \
        & gvalid[..., None]
    boxes = _boxes(g, b, gs, t, w, h, device) * frames[..., None]
    dur = torch.stack([start, start + length - 1], -1).to(torch.int32)
    cats = torch.randint(1, m["num_enti_cats"], (b, gs), generator=g,
                         device=device) * gvalid
    # the first ``gt_trajs`` proposals track the GT trajectories
    jitter = 3.0 * torch.randn(b, ng, t, 4, generator=g, device=device)
    gbox = boxes[:, :ng]
    x = (gbox + jitter).clamp(min=0.0)
    x = torch.maximum(x, torch.cat([x[..., :2], x[..., :2] + 2.0], -1))
    props["boxes"][:, :ng] = x * frames[:, :ng, :, None]
    props["durations"][:, :ng] = dur[:, :ng]
    props["stretch_idx"][:, :ng] = stretch_gather_index(length[:, :ng], t)
    props["feats"][:, :ng] *= frames[:, :ng, :, None]
    props["cat_ids"][:, :ng] = cats[:, :ng].to(torch.int32)
    subj = torch.randint(0, ng, (b, ps), generator=g, device=device)
    obj = (subj + torch.randint(1, ng, (b, ps), generator=g,
                                device=device)) % ng
    pvalid = (torch.arange(ps, device=device) < npred).expand(b, ps)
    adj = torch.zeros(b, 2, ps, gs, device=device)
    adj[:, 0].scatter_(-1, subj[..., None], 1.0)
    adj[:, 1].scatter_(-1, obj[..., None], 1.0)
    adj *= pvalid[:, None, :, None]
    lo = torch.maximum(dur[..., 0].gather(1, subj), dur[..., 0].gather(1, obj))
    hi = torch.minimum(dur[..., 1].gather(1, subj), dur[..., 1].gather(1, obj))
    gts = {
        "traj_cats": cats.to(torch.int32),
        "traj_durations": dur,
        "traj_boxes": boxes,
        "traj_mask": gvalid.clone(),
        "pred_cats": (torch.randint(1, m["num_pred_cats"], (b, ps),
                                    generator=g, device=device)
                      * pvalid).to(torch.int32),
        "pred_durations": (torch.stack([lo, hi], -1).float()
                           * pvalid[..., None]),
        "pred_mask": pvalid.clone(),
        "adj": adj,
    }
    return props, gts
