"""The generator of VidOR grounding batches, made on the device from a
traffic mix's parameters (``benchmark/workloads/*.json``) and a seed.

Every video of a mix has ``video_len`` frames, so ``n_clips`` I3D clips
(16-frame clips every 8 frames) of a ``clips`` bucket; the seed draws the
clip features, the queries' classes and their subject-object time spans.
Training mixes draw a GT scene graph per video: ``gt_trajs`` trajectories
and ``gt_preds`` predicates between overlapping pairs in ``pred_slots``
slots, some of them repeated (the duplicate queries of the reference's
data), and the Gumbel noise of the negative sampling.
"""
from __future__ import annotations

import torch


def n_clips(video_len: int) -> int:
    return max(2, (video_len - 16) // 8 + 1)


def clip_batch(p: dict, m: dict, g, device):
    """(video_feats (B,T,D), clip_mask (B,T), n_clips (B,))."""
    b, t = p["batch"], p["clips"]
    n = n_clips(p["video_len"])
    counts = torch.full((b,), n, dtype=torch.int64, device=device)
    mask = torch.arange(t, device=device)[None] < counts[:, None]
    feats = 2.0 * torch.rand(b, t, m["dim_feat"], generator=g,
                             device=device) * mask[..., None]
    return feats, mask, counts


def query_batch(p: dict, m: dict, g, device) -> dict:
    """One serving batch: clips and ``queries`` queries a video."""
    b, q = p["batch"], p["queries"]
    feats, mask, counts = clip_batch(p, m, g, device)
    ent, pred = m["num_enti_cats"], m["num_pred_cats"]
    cats = torch.stack([
        torch.randint(1, ent, (b, q), generator=g, device=device),
        torch.randint(1, pred, (b, q), generator=g, device=device),
        torch.randint(1, ent, (b, q), generator=g, device=device)], -1)
    start = 0.8 * torch.rand(b, q, generator=g, device=device)
    length = 0.05 + (0.95 - start - 0.05) * torch.rand(
        b, q, generator=g, device=device)
    return {"video_feats": feats, "clip_mask": mask, "n_clips": counts,
            "query_cats": cats,
            "temporal": torch.stack([start, start + length], -1),
            "query_mask": torch.ones(b, q, dtype=torch.bool, device=device)}


def graph_batch(p: dict, m: dict, g, device) -> dict:
    """One GT scene graph a video, as the port's ``GraphBatch`` fields
    (B, ...): ``gt_trajs`` trajectories that all share the middle of the
    video, ``gt_preds`` valid predicate slots of ``pred_slots``, a share
    ``dup_share`` of them repeating an earlier slot's subject, object and
    class (the duplicate queries), each predicate's span inside its pair's
    overlap."""
    b, gn, ps, npred = p["batch"], p["gt_trajs"], p["pred_slots"], \
        p["gt_preds"]
    vlen = p["video_len"]
    ent, pcats = m["num_enti_cats"], m["num_pred_cats"]

    def u(*shape):
        return torch.rand(*shape, generator=g, device=device)

    def ints(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=g, device=device)

    start = (u(b, gn) * (vlen // 3)).floor()
    end = vlen // 2 + (u(b, gn) * (vlen - vlen // 2)).floor()
    end = end.clamp(max=vlen - 1)
    subj = ints(0, gn, b, ps)
    obj = (subj + ints(1, gn, b, ps)) % gn
    cats = ints(1, pcats, b, ps)
    src = (u(b, ps) * torch.arange(ps, device=device)).floor().long()
    dup = (u(b, ps) < p["dup_share"]) & (torch.arange(ps, device=device) > 0)
    pick = torch.where(dup, src, torch.arange(ps, device=device))
    subj, obj, cats = (x.gather(1, pick) for x in (subj, obj, cats))
    valid = torch.arange(ps, device=device)[None].expand(b, ps) < npred
    inter0 = torch.maximum(start.gather(1, subj), start.gather(1, obj))
    inter1 = torch.minimum(end.gather(1, subj), end.gather(1, obj))
    span = inter1 - inter0
    ps0 = inter0 + (0.15 * span * u(b, ps)).floor()
    ps1 = inter1 - (0.15 * span * u(b, ps)).floor()
    adj = torch.zeros(b, 2, ps, gn, device=device)
    adj[:, 0].scatter_(-1, subj[..., None], 1.0)
    adj[:, 1].scatter_(-1, obj[..., None], 1.0)
    adj *= valid[:, None, :, None]
    return {
        "traj_cats": ints(1, ent, b, gn).to(torch.int32),
        "traj_durations": torch.stack([start, end], -1).to(torch.int32),
        "traj_boxes": torch.zeros(b, gn, 1, 4, device=device),
        "traj_mask": torch.ones(b, gn, dtype=torch.bool, device=device),
        "pred_cats": (cats * valid).to(torch.int32),
        "pred_durations": torch.stack([ps0, ps1], -1) * valid[..., None],
        "pred_mask": valid.clone(),
        "adj": adj,
    }


def train_batch(p: dict, m: dict, g, device) -> dict:
    """Clips and a GT graph a video, the video lengths, and the Gumbel
    noise of one step's negative sampling."""
    feats, mask, counts = clip_batch(p, m, g, device)
    gts = graph_batch(p, m, g, device)
    u = torch.rand(p["batch"], p["pred_slots"], m["num_pred_cats"],
                   generator=g, device=device)
    tiny = torch.finfo(torch.float32).tiny
    return {"video_feats": feats, "clip_mask": mask, "n_clips": counts,
            "gts": gts,
            "video_len": torch.full((p["batch"],), p["video_len"],
                                    dtype=torch.int64, device=device),
            "noise": -torch.log(-torch.log(u.clamp(min=tiny)))}
