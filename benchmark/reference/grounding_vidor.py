"""Plain PyTorch reference of BIG's stage-2 grounding model (Dawn-LX/
VidSGG-BIG, ``models/grd_model_v5.py``, config
``experiments/grounding_weights/config_.py``), written from its equations
over a ``state_dict`` under the reference's parameter names.  It imports
nothing of the port.

A batch of B videos x Q queries x T clips:

* clip features through ``video_fc``; each query's three words (subject,
  predicate, object name embeddings) through ``query_fc``, plus its
  subject-object time span through ``temp_fc``;
* QANet blocks over the clips (kernel 7) and over each query's words
  (kernel 3): sine positions, four depthwise-separable convs with
  pre-norm residuals, 8-head self-attention, a linear layer; padded clips
  are zeroed after every sublayer;
* the video-query fusion: similarities, a softmax over the words and one
  over the valid clips, [v, a, a v, b v] through ``vq_fc``;
* a combined QANet block over each (query, clip) row, then three conv
  heads: per-bin regressions (sigmoid), centerness and class logits;
* the test-time decode: per bin, the clip of the best score and the clips
  scoring above ``score_th`` of it whose spans overlap its by more than
  ``tiou_th`` pooled into one span, clamped to the query's window; the
  window itself as an extra bin of probability 1; greedy NMS at
  ``nms_th``; bins above ``bins_th`` kept, at least the best one.

Training passes ``draws``, which supplies every dropout in the reference
model's order (``drop``) and the attention weights' dropout
(``attention``); serving passes none.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import philox
from .dropout import StepDropout

LN_EPS = 1e-6
HEADS = 8
# rows of the attention's (rows, heads, T, T) weights held at once
ATTENTION_BLOCK_BYTES = 1 << 28


class NoDraws:
    """Eval mode: no dropout."""

    def drop(self, x, p):
        return x

    def attention(self, a, p, name, rows):
        return a


def _lin(w, x, name):
    return F.linear(x, w[name + ".weight"], w.get(name + ".bias"))


def _norm(w, x, name):
    return F.layer_norm(x, (x.shape[-1],), w[name + ".weight"],
                        w[name + ".bias"], LN_EPS)


def sine_positions(length: int, d: int, device, dtype):
    pos = np.arange(length, dtype=np.float64)[:, None]
    rate = 10000.0 ** (-np.arange(0, d, 2, dtype=np.float64) / d)
    table = np.zeros((length, d))
    table[:, 0::2] = np.sin(pos * rate)
    table[:, 1::2] = np.cos(pos * rate)
    return torch.tensor(table, dtype=dtype, device=device)


def sep_conv(w, x, name):
    """Depthwise then pointwise conv over time, (R, T, C) -> (R, T, O)."""
    dw, pw = w[name + ".depth_wise.weight"], w[name + ".point_wise.weight"]
    y = F.conv1d(x.transpose(1, 2), dw, w[name + ".depth_wise.bias"],
                 padding=dw.shape[-1] // 2, groups=dw.shape[0])
    y = F.conv1d(y, pw, w[name + ".point_wise.bias"])
    return y.transpose(1, 2)


def attention(w, name, x, mask, draws, p):
    """8-head self-attention over (R, T, d) with a key mask (R, T); rows
    go in blocks so that the weights of a block fit."""
    r, t, d = x.shape
    hd = d // HEADS
    wi, bi = w[name + ".in_proj_weight"], w[name + ".in_proj_bias"]
    heads = [F.linear(x, wi[i * d:(i + 1) * d], bi[i * d:(i + 1) * d])
             .unflatten(-1, (HEADS, hd)).transpose(1, 2) for i in range(3)]
    block = max(1, ATTENTION_BLOCK_BYTES // (4 * HEADS * t * t))

    def rows(s, q, k, v, valid):
        logits = q @ k.transpose(-1, -2) / math.sqrt(hd)
        if valid is not None:
            logits = logits.masked_fill(~valid[:, None, None, :],
                                        float("-inf"))
        a = draws.attention(torch.softmax(logits, -1), p, name,
                            (s, s + q.shape[0], r))
        return (a @ v).transpose(1, 2).flatten(-2)

    outs = []
    for s in range(0, r, block):
        args = [s] + [h[s:s + block] for h in heads] + [
            None if mask is None else mask[s:s + block]]
        if block < r and torch.is_grad_enabled():
            # only the block's output is kept for the backward, which
            # recomputes its weights (and draws the same keep-mask)
            outs.append(checkpoint(rows, *args, use_reentrant=False))
        else:
            outs.append(rows(*args))
    return _lin(w, torch.cat(outs), name + ".out_proj")


def qanet(w, name, x, mask, draws, p=0.1, p_attn=0.1):
    """One QANet block, (R, T, d) -> (R, T, d)."""
    z = (lambda o: o.masked_fill(~mask[..., None], 0.0)) \
        if mask is not None else (lambda o: o)
    out = z(x + sine_positions(x.shape[1], x.shape[2], x.device,
                               x.dtype)[None])
    res = out
    out = z(_norm(w, out, name + ".normb"))
    for i in range(4):
        out = z(F.relu(sep_conv(w, out, f"{name}.convs.{i}")) + res)
        if i % 2 == 1:
            out = draws.drop(out, p * (i + 1) / 4)
        res = out
        out = z(_norm(w, out, f"{name}.norm_seq.{i}"))
    out = z(attention(w, name + ".mh_attn", out, mask, draws, p_attn) + res)
    out = draws.drop(out, p)
    res = out
    out = z(_norm(w, out, name + ".norme"))
    out = z(F.relu(_lin(w, out, name + ".fc")) + res)
    return draws.drop(out, p)


def conv_head(w, name, x, mask):
    for i in range(4):
        x = F.relu(sep_conv(w, x, f"{name}.{i}.0")).masked_fill(
            ~mask[..., None], 0.0)
    return sep_conv(w, x, f"{name}.4")


def forward(w, m, video, clip_mask, query_cats, temporal, draws=None):
    """(regrs (B,Q,T,2,K), conf (B,Q,T,K), cls (B,Q,T,K))."""
    draws = draws or NoDraws()
    b, t, _ = video.shape
    q = query_cats.shape[1]
    h, k = m["dim_hidden"], m["num_bins"]
    qc = query_cats.long()
    words = torch.stack([w["EntiNameEmb"][qc[..., 0]],
                         w["PredNameEmb"][qc[..., 1]],
                         w["EntiNameEmb"][qc[..., 2]]], 2)      # (B,Q,3,300)
    v = _lin(w, video, "video_fc")
    query = _lin(w, words, "query_fc") + \
        _lin(w, temporal.to(v.dtype), "temp_fc")[:, :, None]
    v = qanet(w, "video_encoder", v, clip_mask, draws)
    query = qanet(w, "query_encoder", query.reshape(b * q, 3, h), None,
                  draws).reshape(b, q, 3, h)
    sim = torch.einsum("bth,bqlh->bqtl", _lin(w, v, "proj2sim"), query)
    over_words = torch.softmax(sim, -1)
    cm = clip_mask[:, None, :, None]
    over_clips = torch.softmax(sim.masked_fill(~cm, float("-inf")), 2)
    a = torch.einsum("bqtl,bqlh->bqth", over_words, query)
    clip_ctx = torch.einsum("bqsl,bsh->bqlh", over_clips, v)
    bb = torch.einsum("bqtl,bqlh->bqth", over_words, clip_ctx)
    ve = v[:, None].expand_as(a)
    fused = _lin(w, torch.cat([ve, a, a * ve, bb * ve], -1), "vq_fc")
    rows_mask = clip_mask[:, None].expand(b, q, t).reshape(b * q, t)
    x = qanet(w, "combined_encoder", fused.reshape(b * q, t, h), rows_mask,
              draws)
    regrs = torch.sigmoid(conv_head(w, "regr_head", x, rows_mask))
    conf = conv_head(w, "conf_head", x, rows_mask)
    cls = conv_head(w, "cls_head", x, rows_mask)
    return (regrs.reshape(b, q, t, 2, k), conf.reshape(b, q, t, k),
            cls.reshape(b, q, t, k))


def _tiou(a, b):
    """IoU of spans (..., 2) against spans (..., 2), 0 where disjoint."""
    inter = torch.minimum(a[..., 1], b[..., 1]) - \
        torch.maximum(a[..., 0], b[..., 0])
    union = torch.maximum(a[..., 1], b[..., 1]) - \
        torch.minimum(a[..., 0], b[..., 0])
    return torch.where(inter >= 0, inter / union, torch.zeros_like(inter))


def decode(regrs, conf, cls, window, n_clips, clip_mask, query_mask, *,
           score_th, tiou_th, bins_th, nms_th):
    """(spans (B,Q,K+1,2), probs (B,Q,K+1), kept (B,Q,K+1))."""
    b, q, t, _, k = regrs.shape
    cm = clip_mask[:, None, :, None]
    score = (torch.sigmoid(conf) * torch.sigmoid(cls)).masked_fill(~cm, 0.0)
    probs = torch.cat([score.amax(2), torch.ones_like(score[:, :, 0, :1])],
                      -1)
    anchor = torch.arange(t, device=regrs.device)[None] / \
        (n_clips.clamp(min=2) - 1).float()[:, None]           # (B, T)
    start = anchor[:, None, :, None] - regrs[..., 0, :]       # (B,Q,T,K)
    end = anchor[:, None, :, None] + regrs[..., 1, :]
    s = score.masked_fill(~cm, float("-inf"))
    top = s.argmax(2, keepdim=True)
    best = torch.stack([start.gather(2, top), end.gather(2, top)], -1)
    spans_t = torch.stack([start, end], -1)                   # (B,Q,T,K,2)
    overlap = (torch.minimum(spans_t[..., 1], best[..., 1])
               - torch.maximum(spans_t[..., 0], best[..., 0])) / \
        (torch.maximum(spans_t[..., 1], best[..., 1])
         - torch.minimum(spans_t[..., 0], best[..., 0]))
    pool = (s > score_th * s.gather(2, top)) & (overlap > tiou_th) & cm
    lo = start.masked_fill(~pool, float("inf")).amin(2)
    hi = end.masked_fill(~pool, float("-inf")).amax(2)
    win = window[:, :, None, :]
    s0 = torch.maximum(lo, win[..., 0])
    e0 = torch.minimum(hi, win[..., 1])
    inside = s0 <= e0
    spans = torch.where(inside[..., None], torch.stack([s0, e0], -1),
                        win.expand(b, q, k, 2))
    spans = torch.cat([spans, window[:, :, None, :]], 2)       # (B,Q,K+1,2)
    inside = torch.cat([inside, torch.ones_like(inside[..., :1])], -1)
    alive = torch.ones_like(probs, dtype=torch.bool)
    nms = torch.zeros_like(alive)
    for _ in range(k + 1):
        cand = probs.masked_fill(~alive, float("-inf"))
        pick = cand.argmax(-1, keepdim=True)
        any_alive = alive.any(-1, keepdim=True)
        hit = torch.zeros_like(alive).scatter(-1, pick, True) & any_alive
        nms |= hit
        ov = _tiou(spans, spans.gather(2, pick[..., None].expand(
            b, q, 1, 2)))
        alive &= ~hit & (ov < nms_th)
    kept = (probs > bins_th) & inside & nms
    none = ~kept.any(-1, keepdim=True)
    kept |= none & torch.zeros_like(kept).scatter(
        -1, probs.argmax(-1, keepdim=True), True)
    weak = probs[..., :-1].amax(-1, keepdim=True) <= bins_th
    probs = torch.cat([probs[..., :-1], probs[..., -1:].masked_fill(weak,
                                                                    0.0)], -1)
    return spans, probs, kept & query_mask[..., None]


def cast(w, tensors: dict, dtype):
    w = {k: v.to(dtype) for k, v in w.items()}
    return w, {k: v.to(dtype) if v.is_floating_point() else v
               for k, v in tensors.items()}


# ---------------------------------------------------------------------------
# training: the step's draws, the queries, the labels, the loss, the steps
# ---------------------------------------------------------------------------

def attention_way(rows: int, t: int, d: int, budget: int = 1 << 30) -> str:
    """How the port lowers a QANet attention of (rows, t, d), which decides
    how its dropout is drawn: "direct" while the (rows, 8, t, t) float32
    logits fit ``budget`` (or cannot be halved below it), else "composed"
    (its kernels) at 128-aligned t and d.  A frozen copy of the port's
    rule (``models/grounding.attention_lowering``)."""
    chunk = rows
    while chunk * HEADS * t * t * 4 > budget and chunk % 2 == 0:
        chunk //= 2
    if chunk < rows and 4 * rows * HEADS * t * t > budget:
        if t % 128 == 0 and d % 128 == 0:
            return "composed"
        raise NotImplementedError("the port's chunked stored-softmax path")
    return "direct"


class TrainDraws:
    """A train step's dropouts, drawn as the port draws them from the
    step's CPU generator, in the reference model's order: a dropout mask
    (and a direct attention's) as :class:`~.dropout.StepDropout`; a
    composed attention's row seeds drawn from the generator once, the
    keep-mask from :mod:`philox` (rescaled by its realised rate)."""

    def __init__(self, generator: torch.Generator, d: int):
        self.g, self.d = generator, d
        self.drop = StepDropout(generator)
        self.seeds = {}

    def attention(self, a, p, name, rows):
        lo, hi, total = rows
        t = a.shape[-1]
        if attention_way(total, t, self.d) == "direct":
            if (lo, hi) != (0, total):
                raise ValueError("a direct attention draws its mask whole")
            return self.drop(a, p)
        if name not in self.seeds:
            self.seeds[name] = torch.randint(
                -2 ** 31, 2 ** 31, (total,), dtype=torch.int32,
                generator=self.g).to(a.device)
        keep = philox.attention_keep(self.seeds[name][lo:hi], HEADS, t, t, p)
        _, inv = philox.drop_threshold(p)
        return torch.where(keep, a * inv, 0.0)


def queries(gts: dict, video_len, num_pred_cats: int, noise):
    """The train queries of a batch (reference grd_model_v5.py:253-306),
    one video at a time on the host: one slot per GT predicate; slots with
    the same (predicate, subject class, object class, subject-object span)
    form a group whose first slot represents it; each representative gets a
    negative predicate: within its (subject class, object class, span)
    group, the predicates no slot of the group has, ordered by the group's
    first slot's Gumbel noise, the k-th for the group's k-th
    representative."""
    adj = gts["adj"].cpu()
    tcat = gts["traj_cats"].cpu().long()
    tdur = gts["traj_durations"].cpu().long()
    pcat = gts["pred_cats"].cpu().long()
    pmask = gts["pred_mask"].cpu()
    noise = noise.cpu().float()
    b, _, p, _ = adj.shape
    qc = torch.zeros(b, p, 3, dtype=torch.long)
    neg = torch.zeros(b, p, 3, dtype=torch.long)
    inter = torch.zeros(b, p, 2)
    is_rep = torch.zeros(b, p, dtype=torch.bool)
    group_rep = torch.zeros(b, p, dtype=torch.long)
    for v in range(b):
        tags, firsts, so_first, so_preds, so_reps = {}, {}, {}, {}, {}
        for j in range(p):
            if not pmask[v, j]:
                continue
            s, o = int(adj[v, 0, j].argmax()), int(adj[v, 1, j].argmax())
            span = (max(int(tdur[v, s, 0]), int(tdur[v, o, 0])),
                    min(int(tdur[v, s, 1]), int(tdur[v, o, 1])))
            so = (int(tcat[v, s]), int(tcat[v, o]), span)
            tag = (int(pcat[v, j]),) + so
            tags[j] = (tag, so)
            qc[v, j] = torch.tensor([so[0], int(pcat[v, j]), so[1]])
            inter[v, j] = torch.tensor(span, dtype=torch.float32)
            firsts.setdefault(tag, j)
            so_first.setdefault(so, j)
            so_preds.setdefault(so, set()).add(int(pcat[v, j]))
        for j, (tag, so) in tags.items():
            group_rep[v, j] = firsts[tag]
            if firsts[tag] != j:
                continue
            is_rep[v, j] = True
            rank = so_reps.get(so, 0)
            so_reps[so] = rank + 1
            row = noise[v, so_first[so]].clone()
            row[list(so_preds[so])] = float("-inf")
            order = torch.argsort(-row, stable=True)
            neg[v, j] = qc[v, j]
            neg[v, j, 1] = order[min(rank, num_pred_cats - 1)]
    dev = gts["adj"].device
    vl = video_len.float().cpu()[:, None, None]
    return {"query_cats": qc.to(dev), "neg_query_cats": neg.to(dev),
            "temporal": (inter / vl).to(dev),
            "target": (gts["pred_durations"].cpu().float() / vl).to(dev),
            "is_rep": is_rep.to(dev), "group_rep": group_rep.to(dev),
            "query_mask": pmask.to(dev)}


def labels(target, n_clips, t: int, k: int):
    """FCOS-style labels: per clip the (left, right) distances to the
    target span, centerness sqrt(min / max) inside it, a 0/1 score, and the
    bin of the target's centre among k equal bins of [0, 1]."""
    anchor = torch.arange(t, device=target.device)[None].float() / \
        (n_clips.clamp(min=2) - 1).float()[:, None]               # (B, T)
    valid = torch.arange(t, device=target.device)[None] < n_clips[:, None]
    left = anchor[:, None] - target[..., :1]                      # (B,Q,T)
    right = target[..., 1:] - anchor[:, None]
    inside = (left > 0) & (right > 0) & valid[:, None]
    ratio = torch.minimum(left, right) / torch.maximum(left, right).clamp(
        min=1e-12)
    ctness = torch.where(inside, ratio, 0.0).clamp(min=0).sqrt()
    edges = torch.arange(k + 1, device=target.device).float() * \
        torch.tensor(1.0 / k, device=target.device)
    edges[-1] = 1.0
    centre = target.mean(-1)
    bins = ((centre[..., None] - edges) > 0).sum(-1).sub(1).clamp(0, k - 1)
    return torch.stack([left, right], -1), ctness, inside.float(), bins


def _bce(logits, target):
    return F.binary_cross_entropy_with_logits(logits, torch.as_tensor(
        target, dtype=logits.dtype, device=logits.device).expand_as(logits),
        reduction="none")


def loss(m, pos, negq, lab, qs, clip_mask):
    """The five loss terms (reference grd_model_v5.py:375-527)."""
    regrs, conf, cls = pos
    _, n_conf, n_cls = negq
    gt_lr, gt_ct, gt_sc, bins = lab
    b, q, t, k = conf.shape
    rep, is_rep, qm = qs["group_rep"], qs["is_rep"], qs["query_mask"]
    rows = torch.arange(b, device=conf.device)[:, None]

    def at_bin(x):                       # (B,Q,T,...,K) -> rep's, at bin
        x = x[rows, rep]
        idx = bins[:, :, None].expand(b, q, t)
        if x.dim() == 5:
            return torch.stack([x[..., i, :].gather(-1, idx[..., None])[
                ..., 0] for i in range(2)], -1)
        return x.gather(-1, idx[..., None])[..., 0]

    valid = qm[:, :, None] & clip_mask[:, None, :]
    vf = valid.float()
    pos_cls = (_bce(at_bin(cls), gt_sc) * vf).sum() / vf.sum().clamp(min=1)
    ct = ((gt_ct > 0) & valid).float()
    n_ct = ct.sum().clamp(min=1)
    pos_ct = (_bce(at_bin(conf), gt_ct) * ct).sum() / n_ct
    pr, gl = at_bin(regrs), torch.where(ct[..., None] > 0, gt_lr, 1.0)
    iou = (torch.minimum(pr[..., 1], gl[..., 1]) + torch.minimum(
        pr[..., 0], gl[..., 0])) / (torch.maximum(pr[..., 1], gl[..., 1])
                                    + torch.maximum(pr[..., 0], gl[..., 0]))
    iou = torch.where(ct > 0, iou, 1.0)
    regr = (-torch.log(iou.clamp(min=0) + 1e-6) * ct).sum() / n_ct
    own = F.one_hot(bins, k).bool() & qm[..., None]
    group_bins = torch.zeros(b, q, k, dtype=torch.bool, device=conf.device)
    for j in range(q):
        group_bins[rows[:, 0], rep[:, j]] |= own[:, j]
    neg_bins = (~group_bins & is_rep[..., None] & qm[..., None]
                )[:, :, None, :] & valid[..., None]
    neg_q = (is_rep[:, :, None] & valid)[..., None].expand(b, q, t, k)
    n_neg = (neg_bins.sum() + neg_q.sum()).clamp(min=1).float()
    nb, nq = neg_bins.float(), neg_q.float()
    neg_cls = ((_bce(cls, 0.0) * nb).sum() + (_bce(n_cls, 0.0) * nq).sum()
               ) / n_neg
    neg_ct = ((_bce(conf, 0.0) * nb).sum() + (_bce(n_conf, 0.0) * nq).sum()
              ) / n_neg
    lf = m["loss_factor"]
    return {"pos_cls": lf["classification"] * pos_cls,
            "neg_cls": lf["classification"] * neg_cls,
            "pos_ct": lf["centerness"] * pos_ct,
            "neg_ct": lf["centerness"] * neg_ct,
            "regr": lf["regression"] * regr}


def train_loss(w, m, batch, generator):
    """The total loss of one train step (dropout 0.1 everywhere)."""
    qs = queries(batch["gts"], batch["video_len"], m["num_pred_cats"],
                 batch["noise"])
    p = qs["query_cats"].shape[1]
    draws = TrainDraws(generator, m["dim_hidden"])
    regrs, conf, cls = forward(
        w, m, batch["video_feats"], batch["clip_mask"],
        torch.cat([qs["query_cats"], qs["neg_query_cats"]], 1),
        torch.cat([qs["temporal"]] * 2, 1), draws)
    t = batch["video_feats"].shape[1]
    lab = labels(qs["target"], batch["n_clips"], t, m["num_bins"])
    terms = loss(m, (regrs[:, :p], conf[:, :p], cls[:, :p]),
                 (regrs[:, p:], conf[:, p:], cls[:, p:]), lab, qs,
                 batch["clip_mask"])
    return sum(terms.values())
