"""The check of served BIG-C triplets against the plain reference.

A served batch is judged as a served language model's tokens are: the
reference runs once over the same inputs and reads, at each query, the
choices the program served.

* ``att_gap``: for each query and role, the reference's largest adjacency
  weight minus its weight at the served tracklet (0 where they agree; a
  near tie gives a tiny gap, not a failure).
* ``logit_gap``: the reference's head run at the served subject and
  object; at each of a query's top-k slots, the gap between the
  reference's k-th best logit and its logit of the served class.
* ``score_gap``: the served predicate score against the reference's
  probability of the served class.
* ``bad_triplets``: exact rules: the served subject and object classes,
  scores, query ids and duration intersections are those of the served
  tracklets; a valid triplet has a foreground class and two distinct valid
  tracklets that overlap in time; valid quintuples are unique; a dropped
  foreground candidate on a sound pair has a valid twin whose score is at
  least its own.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import bigc_v10_exp2 as ref


def served_tokens(trip, topk: int, device):
    """(subject, object) ids (B, Q), classes (B, Q, k) and predicate
    scores (B, Q, k) of a served batch (host arrays)."""
    quint = torch.as_tensor(trip["quintuples"]).to(device).long()
    b, mk, _ = quint.shape
    q = mk // topk
    cats = quint[..., 0].reshape(b, q, topk)
    scores = torch.as_tensor(trip["scores"][..., 0]).to(device).reshape(
        b, q, topk)
    return quint[:, ::topk, 3], quint[:, ::topk, 4], cats, scores


def gaps(w, m, batch, fwd, subj, obj, cats, scores, topk):
    """(att_gap, logit_gap, score_gap) of the tokens against the float32
    reference forward ``fwd``."""
    att = fwd["att"]
    pick = torch.stack([subj, obj], 1)[..., None]            # (B,2,Q,1)
    att_gap = (att.amax(-1) - att.gather(-1, pick)[..., 0]).max()
    logits = ref.head(w, m, fwd, subj, obj, batch["cat_ids"])
    best = logits.sort(-1, descending=True).values[..., :topk]
    logit_gap = (best - logits.gather(-1, cats)).abs().max()
    probs = torch.softmax(logits, -1)
    score_gap = (scores - probs.gather(-1, cats)).abs().max()
    return float(att_gap), float(logit_gap), float(score_gap)


def bad_triplets(trip, batch, topk: int) -> int:
    """How many of the exact rules the served batch breaks (host)."""
    quint = trip["quintuples"].astype(np.int64)
    sc, dura = trip["scores"], trip["dura_inters"]
    valid, qids = trip["valid"], trip["query_ids"]
    cat = batch["cat_ids"].cpu().numpy()
    tscore = batch["scores"].cpu().numpy()
    mask = batch["traj_mask"].cpu().numpy()
    durs = batch["durations"].cpu().numpy()
    b, mk, _ = quint.shape
    rows = np.arange(b)[:, None]
    s, o, pc = quint[..., 3], quint[..., 4], quint[..., 0]
    bad = 0
    bad += int((s.reshape(b, -1, topk) != s[:, ::topk, None]).sum())
    bad += int((o.reshape(b, -1, topk) != o[:, ::topk, None]).sum())
    bad += int((quint[..., 1] != cat[rows, s]).sum())
    bad += int((quint[..., 2] != cat[rows, o]).sum())
    bad += int((sc[..., 1] != tscore[rows, s]).sum())
    bad += int((sc[..., 2] != tscore[rows, o]).sum())
    bad += int((qids != np.arange(mk)[None] // topk).sum())
    inter = np.stack([np.maximum(durs[rows, s, 0], durs[rows, o, 0]),
                      np.minimum(durs[rows, s, 1], durs[rows, o, 1])], -1)
    bad += int((dura != inter).sum())
    pair_ok = (s != o) & mask[rows, s] & mask[rows, o] & \
        (inter[..., 0] <= inter[..., 1])
    cand = pair_ok & (pc != 0)
    bad += int((valid & ~cand).sum())
    for v in range(b):
        best = {}
        for j in np.nonzero(valid[v])[0]:
            key = tuple(quint[v, j])
            if key in best:
                bad += 1
            best[key] = max(best.get(key, -np.inf), sc[v, j, 0])
        for j in np.nonzero(cand[v] & ~valid[v])[0]:
            key = tuple(quint[v, j])
            if key not in best or best[key] < sc[v, j, 0]:
                bad += 1
    return bad


def judge(w, m, batch, fwd, trip, topk: int) -> dict:
    """The compared numbers of one served batch."""
    subj, obj, cats, scores = served_tokens(trip, topk, fwd["att"].device)
    att_gap, logit_gap, score_gap = gaps(w, m, batch, fwd, subj, obj, cats,
                                         scores, topk)
    return {"att_gap": att_gap, "logit_gap": logit_gap,
            "score_gap": score_gap,
            "bad_triplets": float(bad_triplets(trip, batch, topk))}


def control(w, m, batch, fwd, trip, topk: int, dtype) -> dict:
    """The reference in ``dtype`` in the program's place: at each query its
    own subject and object (the largest of its adjacency weights), and at
    the served subject and object its own top-k classes and scores, judged
    by the float32 reference ``fwd``."""
    wl, bl = ref.cast(w, batch, dtype)
    low = ref.forward(wl, m, bl)
    subj, obj, _, _ = served_tokens(trip, topk, fwd["att"].device)
    own = low["att"].argmax(-1)                               # (B,2,Q)
    logits = ref.head(wl, m, low, subj, obj, bl["cat_ids"]).float()
    probs, cats = torch.softmax(logits, -1).sort(-1, descending=True)
    att_gap, _, _ = gaps(w, m, batch, fwd, own[:, 0], own[:, 1],
                         cats[..., :topk], probs[..., :topk], topk)
    _, logit_gap, score_gap = gaps(w, m, batch, fwd, subj, obj,
                                   cats[..., :topk], probs[..., :topk], topk)
    return {"att_gap": att_gap, "logit_gap": logit_gap,
            "score_gap": score_gap}
