"""Offline data-preparation: GloVe name embeddings, frequency-bias matrix,
soft classeme, triplet statistics.

A copy of the JAX package's ``data/prepare.py`` (numpy only).

Capability-parity with the reference's one-time scripts (reference
tools_draft/construct_CatName2vec.py:23-152, construct_BiasMatrix.py:42-66,
extract_classeme.py:11-42, stat_triplet_bias.py).
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, List

import numpy as np


def load_glove(path: str, dim: int = 300) -> Dict[str, np.ndarray]:
    """Parse a GloVe text file ('word v1 ... vd' per line)."""
    table = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip().split(" ")
            if len(parts) != dim + 1:
                continue
            table[parts[0]] = np.asarray(parts[1:], np.float32)
    return table


def name_embedding(name: str, glove: Dict[str, np.ndarray],
                   dim: int = 300) -> np.ndarray:
    """Multi-word names average their word vectors; '/'-alternatives average
    their sub-names; background is zeros.  '(...)' qualifiers are stripped
    (e.g. 'play(instrument)' -> 'play')."""
    if name == "__background__":
        return np.zeros((dim,), np.float32)

    def word_vec(word: str) -> np.ndarray:
        words = word.split("_")
        if not 1 <= len(words) <= 3:
            raise ValueError(f"{word!r}: names have 1 to 3 words")
        return np.mean([glove[w] for w in words], axis=0)

    name = name.split("(")[0]
    alts = name.split("/")
    return np.mean([word_vec(a) for a in alts], axis=0).astype(np.float32)


def build_name_embeddings(names: List[str], glove: Dict[str, np.ndarray],
                          dim: int = 300) -> np.ndarray:
    return np.stack([name_embedding(n, glove, dim) for n in names])


def collect_triplet_names(gt_records, enti_id2name, pred_id2name):
    """Per-video (sub_name, pred_name, obj_name) triplets (train split)."""
    out = []
    for gt in gt_records:
        pred2so = gt.adj.argmax(-1)                     # (2, P)
        trips = []
        for p in range(gt.num_preds):
            s = enti_id2name[int(gt.traj_cat_ids[pred2so[0, p]])]
            o = enti_id2name[int(gt.traj_cat_ids[pred2so[1, p]])]
            trips.append((s, pred_id2name[int(gt.pred_cat_ids[p])], o))
        out.append(trips)
    return out


def build_bias_matrix(triplets_per_video, enti_name2id, pred_name2id
                      ) -> np.ndarray:
    """(sub, obj) -> predicate log-prior (reference construct_BiasMatrix.py:
    42-66): counts, +1 background smoothing, row-normalize, log(p + 1e-3)."""
    n_enti = len(enti_name2id)
    n_pred = len(pred_name2id)
    counts = Counter()
    for trips in triplets_per_video:
        for s, p, o in trips:
            counts[(enti_name2id[s], enti_name2id[o], pred_name2id[p])] += 1
    bias = np.zeros((n_enti, n_enti, n_pred))
    for (si, oi, pi), c in counts.items():
        bias[si, oi, pi] = c
    bias[:, :, 0] += 1
    bias = bias / bias.sum(-1, keepdims=True)
    return np.log(bias + 1e-3).astype(np.float32)


def extract_classeme(logits: np.ndarray, word_emb: np.ndarray) -> np.ndarray:
    """Per-box 'soft classeme': softmax over foreground detector logits
    projected onto name embeddings (reference extract_classeme.py:11-42).

    logits: (N, 1 + n_fg); word_emb: (n_fg, dim) — background excluded.
    """
    x = logits[:, 1:].astype(np.float64)
    x = x - x.max(-1, keepdims=True)
    p = np.exp(x)
    p /= p.sum(-1, keepdims=True)
    return (p @ word_emb.astype(np.float64)).astype(np.float32)


def extract_logits(roi_features: np.ndarray, fc_weight: np.ndarray,
                   fc_bias: np.ndarray) -> np.ndarray:
    """Re-apply a detector's final classification layer to stored RoI
    features (reference tools_draft/extract_logits.py:7-80: the MEGA
    checkpoint's cls_score FC lifted onto per-box features)."""
    return (roi_features @ fc_weight.T + fc_bias).astype(np.float32)
