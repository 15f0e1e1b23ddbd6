"""Plain PyTorch reference of BIG-C v10 (Dawn-LX/VidSGG-BIG, CVPR 2022,
``models/model_0v10.py``: the VidVRD predicate-query model of the paper's
table 1), written from the model's equations over a ``state_dict`` under the
reference's parameter names.  It imports nothing of the port.

One batch of videos at a fixed (N tracklet slots, T frames) bucket:

* per frame: box geometry (normalised centre and size with their forward
  differences, 0 at a trajectory's last frame) through ``fc_bbox2enti``,
  RoI features through ``fc_feat2enti``; the frames of a trajectory of L
  frames stretched to T by repeating frame j ceil((T - j) / L) times
  (the reference's ``stack_with_repeat_2d``); a stride-2 temporal conv,
  adaptive max pooling to ``enco_pool_len``, ``fc_enti2enco``;
* a post-norm transformer encoder over the tracklets (padding masked);
* the role-factored decoder: self-attention over the queries, then each
  role's logits p_r e_r^T / sqrt(dim_enti), a softmax over the valid
  tracklets times a softmax over the two roles, the values att enco;
* the head: the subject's and object's node features, their mean I3D
  features through ``fc_i3d``, their name embeddings and the queries, a
  linear layer, plus the frequency bias of the (subject, object) classes.

Every product runs in the tensors' dtype; float32 runs with TF32 off (the
harness sets it).  ``drop`` (training) is called as ``drop(x, p)`` at each
dropout of the reference model, in its order; serving passes none.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

LN_EPS = 1e-6


def _lin(w, x, name):
    return F.linear(x, w[name + ".weight"], w.get(name + ".bias"))


def _mlp(w, x, name, layers, final_relu=True):
    for i in range(layers):
        x = _lin(w, x, f"{name}.{2 * i}")
        if i < layers - 1 or final_relu:
            x = F.relu(x)
    return x


def _norm(w, x, name):
    return F.layer_norm(x, (x.shape[-1],), w[name + ".weight"],
                        w[name + ".bias"], LN_EPS)


def _identity(x, p):
    return x


def attention(w, name, q, k, v, heads, key_mask=None, drop=_identity,
              p=0.0):
    """Multi-head attention with a packed in_proj; masked keys get no
    weight (a row with no valid key gives zeros)."""
    d = q.shape[-1]
    wi, bi = w[name + ".in_proj_weight"], w[name + ".in_proj_bias"]
    hd = d // heads

    def split(x, i):
        y = F.linear(x, wi[i * d:(i + 1) * d], bi[i * d:(i + 1) * d])
        return y.unflatten(-1, (heads, hd)).transpose(1, 2)   # (B, H, L, hd)

    qh, kh, vh = split(q, 0), split(k, 1), split(v, 2)
    logits = qh @ kh.transpose(-1, -2) / math.sqrt(hd)
    if key_mask is not None:
        valid = key_mask[:, None, None, :]
        logits = logits.masked_fill(~valid, float("-inf"))
        a = torch.nan_to_num(torch.softmax(logits, -1), nan=0.0)
    else:
        a = torch.softmax(logits, -1)
    a = drop(a, p)
    out = (a @ vh).transpose(1, 2).flatten(-2)
    return _lin(w, out, name + ".out_proj")


def stretch_index(lengths, t: int):
    """(B, N, T) long: the frame each stretched step reads; a trajectory of
    L frames repeats frame j ceil((T - j) / L) times (L >= T: frames 0..T-1
    once)."""
    rows = []
    for n in lengths.reshape(-1).tolist():
        n = max(int(n), 1)
        if n >= t:
            rows.append(torch.arange(t))
            continue
        j = torch.arange(n)
        counts = (t - j + n - 1) // n
        rows.append(torch.repeat_interleave(j, counts))
    return torch.stack(rows).reshape(*lengths.shape, t).to(lengths.device)


def _stretch(x, idx):
    return torch.gather(x, 2, idx[..., None].expand(*idx.shape, x.shape[-1]))


def geometry(boxes, wh, lengths):
    """(B, N, T, 8) per raw frame: [cx, dcx, cy, dcy, w, dw, h, dh]."""
    sx = wh[:, 0][:, None, None]
    sy = wh[:, 1][:, None, None]
    x1, y1 = boxes[..., 0] / sx, boxes[..., 1] / sy
    x2, y2 = boxes[..., 2] / sx, boxes[..., 3] / sy
    vals = torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], -1)
    t = boxes.shape[2]
    nxt = torch.cat([vals[:, :, 1:], vals[:, :, -1:]], 2)
    has_next = torch.arange(t, device=boxes.device) < (lengths[..., None] - 1)
    diffs = torch.where(has_next[..., None], nxt - vals, 0.0)
    out = torch.stack([vals, diffs], -1)                  # (B,N,T,4,2)
    return out.flatten(-2)


def forward(w, m, batch, drop=_identity):
    """Returns att (B,2,Q,N), queries (B,Q,Dp), nodes (B,N,E) (the
    tracklet embeddings before the encoder) and i3d (B,N,Di) (each
    tracklet's mean I3D features over its stretched frames)."""
    feats, mask = batch["feats"], batch["traj_mask"]
    dur = batch["durations"]
    b, n, t, _ = feats.shape
    e, heads, p = m["dim_enti"], m["n_att_head"], 0.1
    lengths = (dur[..., 1] - dur[..., 0] + 1).long()
    idx = stretch_index(lengths, t)
    geo = geometry(batch["boxes"], batch["video_wh"], lengths).to(feats.dtype)
    x = torch.cat([_mlp(w, _stretch(geo, idx), "fc_bbox2enti", 2),
                   _mlp(w, _stretch(feats[..., :m["dim_feat"]], idx),
                        "fc_feat2enti", 2)], -1)           # (B,N,T,2E)
    x = F.conv1d(x.reshape(b * n, t, 2 * e).transpose(1, 2),
                 w["conv_feat2enti.weight"], w["conv_feat2enti.bias"],
                 stride=2, padding=1)                     # (BN, E, T/2)
    x = F.adaptive_max_pool1d(x, m["enco_pool_len"])       # (BN, E, pool)
    nodes = _mlp(w, x.reshape(b, n, -1), "fc_enti2enco", 2)
    i3d = _stretch(feats[..., m["dim_feat"]:], idx).mean(2)

    out = nodes
    for i in range(m["n_enco_layers"]):
        name = f"encoder_layers.{i}"
        a = attention(w, name + ".self_attn", out, out, out, heads, mask,
                      drop, p)
        out = _norm(w, out + drop(a, p), name + ".norm1")
        ff = _lin(w, drop(F.relu(_lin(w, out, name + ".linear1")), p),
                  name + ".linear2")
        out = _norm(w, out + drop(ff, p), name + ".norm2")
    enco = out

    pos = w["pos_embedding"][None]
    query = w["pred_query_init"][None].expand(b, -1, -1)
    half = m["dim_att"] // 2
    valid = mask[:, None, None, :]
    for i in range(m["n_deco_layers"]):
        name = f"decoder_layers.{i}"
        qk = query + pos
        a = attention(w, name + ".self_attn", qk, qk, query, heads, None,
                      drop, p)
        query = _norm(w, query + a, name + ".norm1") + pos
        ea = _lin(w, enco, name + ".fc_enti2att")
        pa = _lin(w, query, name + ".fc_pred2att")
        logits = torch.stack([
            pa[..., r * half:(r + 1) * half]
            @ ea[..., r * half:(r + 1) * half].transpose(1, 2)
            for r in range(2)], 1) / math.sqrt(e)        # (B,2,Q,N)
        over_nodes = torch.softmax(logits.masked_fill(~valid, float("-inf")),
                                   -1).masked_fill(~valid, 0.0)
        att = over_nodes * torch.softmax(logits, 1)
        values = att @ enco[:, None]                       # (B,2,Q,E)
        roles = sum(_mlp(w, values[:, r], f"{name}.fc_rolewise.{r}", 2,
                         final_relu=False) for r in range(2))
        query = _norm(w, query + roles, name + ".norm2")
        ff = _lin(w, drop(F.relu(_lin(w, query, name + ".fc2.0")), p),
                  name + ".fc2.3")
        query = _norm(w, query + ff, name + ".norm3")
    return {"att": att, "queries": query, "nodes": nodes, "i3d": i3d}


def head(w, m, fwd, subj, obj, cat_ids):
    """Predicate logits (B, Q, C) of each query for the given subject and
    object tracklet ids (B, Q)."""
    rows = torch.arange(subj.shape[0], device=subj.device)[:, None]
    cs, co = cat_ids.long()[rows, subj], cat_ids.long()[rows, obj]
    emb = w["EntiNameEmb"]
    parts = [fwd["queries"],
             _mlp(w, fwd["i3d"][rows, subj], "fc_i3d", 1),
             _mlp(w, fwd["i3d"][rows, obj], "fc_i3d", 1),
             fwd["nodes"][rows, subj], fwd["nodes"][rows, obj],
             emb[cs], emb[co]]
    logits = _lin(w, torch.cat(parts, -1), "fc_pred2logits")
    return logits + w["bias_matrix"][cs, co]


def cast(w, batch, dtype):
    """The weights and the batch's float tensors in ``dtype``."""
    w = {k: v.to(dtype) for k, v in w.items()}
    batch = {k: v.to(dtype) if v.is_floating_point() else v
             for k, v in batch.items()}
    return w, batch


# ---------------------------------------------------------------------------
# training (reference model_0v10.py:559-704): proposals aligned to the GT
# trajectories by vIoU, Hungarian matching of queries to GT predicates,
# classification and adjacency losses
# ---------------------------------------------------------------------------

def _on_frames(boxes, dur, frames: int):
    """Relative per-frame boxes (..., K, T, 4) on absolute frames
    (..., K, frames, 4), and the mask of the frames each trajectory holds
    (its duration, up to its stored frames)."""
    t = boxes.shape[-2]
    k = torch.arange(frames, device=boxes.device)
    rel = k - dur[..., :1].long()                             # (..., K, F)
    length = (dur[..., 1] - dur[..., 0] + 1).long().clamp(max=t)
    held = (rel >= 0) & (rel < length[..., None])
    idx = rel.clamp(0, t - 1)
    on = torch.gather(boxes, -2, idx[..., None].expand(*idx.shape, 4))
    return on * held[..., None], held


def viou(pboxes, pdur, pvalid, gboxes, gdur, gvalid, frames: int):
    """(B, N, G) volumetric IoU: summed per-frame intersections (boxes
    with the +1 pixel convention) over summed areas of union; 0 where the
    durations do not overlap or either side is padding."""
    a, ha = _on_frames(pboxes.float(), pdur, frames)
    b, hb = _on_frames(gboxes.float(), gdur, frames)
    a, b = a[:, :, None], b[:, None]                           # (B,N,G,F,4)
    both = ha[:, :, None] & hb[:, None]
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = (rb - lt + 1.0).clamp(min=0.0)
    inter = (wh[..., 0] * wh[..., 1] * both).sum(-1)

    def area(x, held):
        return ((x[..., 2] - x[..., 0] + 1.0) * (x[..., 3] - x[..., 1] + 1.0)
                * held).sum(-1)

    union = area(a[:, :, 0], ha)[:, :, None] + area(b[:, 0], hb)[:, None] \
        - inter
    v = torch.where(union > 0, inter / union, torch.zeros_like(inter))
    overlap = torch.minimum(pdur[:, :, None, 1], gdur[:, None, :, 1]) >= \
        torch.maximum(pdur[:, :, None, 0], gdur[:, None, :, 0])
    keep = overlap & pvalid[:, :, None] & gvalid[:, None, :]
    return torch.where(keep, v, torch.zeros_like(v))


def aligned_adjacency(props, gts, threshold: float, frames: int):
    """(B, 2, P, N): each proposal takes the adjacency column of the GT
    trajectory it overlaps most, where it overlaps some GT trajectory by
    more than ``threshold`` (each GT trajectory without such a proposal
    first claims its best one)."""
    v = viou(props["boxes"], props["durations"], props["traj_mask"],
             gts["traj_boxes"], gts["traj_durations"], gts["traj_mask"],
             frames)
    pos = v > threshold
    best = v.argmax(1)                                          # (B, G)
    lonely = ~pos.any(1) & gts["traj_mask"]
    claim = F.one_hot(best, v.shape[1]).transpose(1, 2).bool() & \
        lonely[:, None, :]
    pos = pos | claim
    has = pos.any(-1) & props["traj_mask"]                      # (B, N)
    col = v.argmax(-1)                                          # (B, N)
    adj = gts["adj"].float()                                    # (B,2,P,G)
    b, _, p, _ = adj.shape
    rows = torch.arange(b, device=adj.device)[:, None, None, None]
    roles = torch.arange(2, device=adj.device)[None, :, None, None]
    preds = torch.arange(p, device=adj.device)[None, None, :, None]
    return adj[rows, roles, preds, col[:, None, None, :]] * \
        has[:, None, None, :]


def _clamped(p, eps=1e-7):
    return p.clamp(eps, 1.0 - eps)


def match(logits, att, gts, aligned, mask, m):
    """(B, P) query of each GT predicate (-1 for padding), the minimum-cost
    assignment (scipy) of the cost: 1 x the predicate's cross-entropy
    under the query + 30 x the mean BCE of the query's adjacency against
    the predicate's aligned adjacency over both roles and the valid
    tracklets."""
    from scipy.optimize import linear_sum_assignment
    cost_c = m["cost_coeff_dict"]
    with torch.no_grad():
        logp = torch.log_softmax(logits.float(), -1)          # (B,Q,C)
        cats = gts["pred_cats"].long()                        # (B,P)
        cls = -logp.gather(-1, cats[:, None, :].expand(
            -1, logp.shape[1], -1))                           # (B,Q,P)
        pr = _clamped(att.float())[:, :, :, None, :]          # (B,2,Q,1,N)
        t = aligned[:, :, None]                               # (B,2,1,P,N)
        bce = -(t * pr.log() + (1 - t) * (1 - pr).log())
        bce = (bce * mask[:, None, None, None, :]).sum((1, -1))
        n = mask.sum(-1).clamp(min=1)[:, None, None]
        cost = cost_c["classification"] * cls + \
            cost_c["adj_matrix"] * bce / (2.0 * n)
    c = cost.cpu().double().numpy()
    counts = gts["pred_mask"].sum(-1).tolist()
    out = torch.full(cats.shape, -1, dtype=torch.long)
    for v, k in enumerate(counts):
        if k:
            q, p = linear_sum_assignment(c[v, :, :k])
            out[v, torch.as_tensor(p)] = torch.as_tensor(q)
    return out.to(logits.device)


def losses(logits, att, gts, aligned, mask, assigned, m):
    """Cross-entropy of every query against its matched predicate's class
    (background where unmatched), positive and negative queries averaged
    apart; the BCE of each matched query's adjacency against its aligned
    adjacency, zero targets weighted by ``neg_weight``, over both roles
    and the valid tracklets."""
    b, q, _ = logits.shape
    lc = m["loss_coeff_dict"]
    matched = assigned >= 0
    target = torch.zeros(b, q, dtype=torch.long, device=logits.device)
    for v in range(b):
        sel = matched[v]
        target[v, assigned[v, sel]] = gts["pred_cats"][v, sel].long()
    ce = -torch.log_softmax(logits.float(), -1).gather(
        -1, target[..., None])[..., 0]
    pos = target != 0
    neg = ~pos & mask.any(-1)[:, None]
    cls_pos = (ce * pos).sum() / pos.sum().clamp(min=1)
    cls_neg = (ce * neg).sum() / neg.sum().clamp(min=1)
    rows = torch.arange(b, device=att.device)[:, None, None]
    roles = torch.arange(2, device=att.device)[None, :, None]
    att_m = att.float()[rows, roles, assigned.clamp(min=0)[:, None, :]]
    pr = _clamped(att_m)                                      # (B,2,P,N)
    bce = -(aligned * pr.log() + (1 - aligned) * (1 - pr).log())
    weight = torch.where(aligned > 0.5, 1.0, m["neg_weight"])
    sel = (matched[:, None, :, None] & mask[:, None, None, :]).float()
    sel = sel.expand_as(bce)
    adj = (bce * weight * sel).sum() / sel.sum().clamp(min=1)
    return (lc["classification"] * cls_pos + lc["classification"] * cls_neg
            + lc["adj_matrix"] * adj)


def train_loss(w, m, batch, drop, frames: int):
    """The total loss of one train step on ``batch`` (``props``, ``gts``),
    its dropouts from ``drop``; ``frames`` spans the videos' frames."""
    props, gts = batch["props"], batch["gts"]
    fwd = forward(w, m, props, drop)
    mask = props["traj_mask"]
    own = fwd["att"].argmax(-1)
    logits = head(w, m, fwd, own[:, 0], own[:, 1], props["cat_ids"])
    aligned = aligned_adjacency(props, gts, m["positive_vIoU_th"], frames)
    assigned = match(logits, fwd["att"], gts, aligned, mask, m)
    return losses(logits, fwd["att"], gts, aligned, mask, assigned, m)
