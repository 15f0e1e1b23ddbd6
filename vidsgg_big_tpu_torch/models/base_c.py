"""Base-C: the non-query pairwise relation baseline (the paper's table 2).

Port of the JAX package's ``models/base_c.py`` (:25-200; reference
models/model_pairwise_baseline.py:8-396): the shared tracklet encoder (no
transformer), then for every ordered tracklet pair a classeme + feature
concat MLP plus the frequency-bias matrix.  Fixed shape: all N*(N-1)
ordered pairs of the bucket are computed with a pair-validity mask.  The
reference's top-level parameter names hold (``fc_bbox2enti``,
``fc_feat2enti``, ``conv_feat2enti``, ``fc_enti2enco``, ``bias_matrix``,
``fc_pred2logits``), so a reference ``state_dict`` loads ``strict=True``.

Every gather with repeated indices (the pair gathers, the bias table) is
advanced indexing, never ``torch.gather``: on the card its backward sorts
the indices and sums each run in order, so a train step is bit-reproducible.
Base-C has no up-front dequantization in train mode (JAX :86-89, unlike
BigC): int8 features train through the int8 first layer, whose weight then
gets gradient only through its scale's max, as in JAX.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..data.types import GraphBatch, TrackletBatch
from ..ops.boxes import viou_matrix_grid
from ..ops.segments import stretch_weighted_mean
from ..parallel.mesh import data_sum
from .big_c import TrackletEncoder, dequantize_extra
from .layers import MLP


@dataclasses.dataclass(frozen=True)
class BaseCConfig:
    num_pred_cats: int
    num_enti_cats: int
    dim_feat: int
    dim_clsme: int = 300
    dim_enti: int = 512
    dim_ffn: int = 512
    enco_pool_len: int = 4
    use_clsme: bool = True
    use_name_emb: bool = False     # True -> EntiNameEmb lookup
    rt_triplets_topk: int = 0
    positive_viou_th: float = 0.5
    compute_dtype: str = "float32"   # lowers the tracklet-encoder matmuls

    @classmethod
    def from_dict(cls, d: dict):
        """From a reference-style ``model_config`` dict (JAX :41-53)."""
        return cls(
            num_pred_cats=d["num_pred_cats"],
            num_enti_cats=d["num_enti_cats"], dim_feat=d["dim_feat"],
            dim_clsme=d.get("dim_clsme", 300), dim_enti=d["dim_enti"],
            dim_ffn=d["dim_ffn"], enco_pool_len=d["enco_pool_len"],
            use_clsme=d.get("use_clsme", True),
            use_name_emb=d.get("EntiNameEmb_path") is not None,
            rt_triplets_topk=d.get("rt_triplets_topk", 0),
            positive_viou_th=d.get("positive_vIoU_th", 0.5),
            compute_dtype=d.get("compute_dtype", "float32"))


def ordered_pair_ids(n: int) -> np.ndarray:
    """All ordered (i, j), i != j, row-major (reference
    pairwise_baseline.py:104-111): (n * (n - 1), 2) int32."""
    i, j = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    keep = i != j
    return np.stack([i[keep], j[keep]], axis=-1).astype(np.int32)


class BaseC(TrackletEncoder):
    """Batched Base-C forward.  ``enti_name_emb`` fills the frozen
    ``EntiNameEmb`` buffer of a name-embedding head; ``generator`` seeds
    the initial weights (xavier-normal, zero biases and bias matrix)."""

    def __init__(self, cfg: BaseCConfig, enti_name_emb=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(cfg.dim_enti, cfg.dim_feat, cfg.enco_pool_len,
                         cfg.compute_dtype)
        self.cfg = cfg
        self.bias_matrix = nn.Parameter(torch.zeros(
            cfg.num_enti_cats, cfg.num_enti_cats, cfg.num_pred_cats))
        head_in = 2 * cfg.dim_enti + (2 * cfg.dim_clsme if cfg.use_clsme
                                      else 0)
        self.fc_pred2logits = MLP(head_in, (cfg.dim_ffn, cfg.num_pred_cats),
                                  final_relu=False)
        if cfg.use_clsme and cfg.use_name_emb:
            emb = (torch.zeros(cfg.num_enti_cats, cfg.dim_clsme)
                   if enti_name_emb is None else
                   torch.as_tensor(np.asarray(enti_name_emb, np.float32)))
            self.register_buffer("EntiNameEmb", emb)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        for name, p in self.named_parameters():
            if name == "bias_matrix" or p.ndim == 1:
                p.zero_()
            else:
                nn.init.xavier_normal_(p, generator=generator)

    def forward(self, batch: TrackletBatch):
        """Returns dict with pred_logits (B, NP, C) float32, pair_ids
        (NP, 2) long, pair_mask (B, NP) bool, enti_feat (B, N, E)."""
        cfg = self.cfg
        width = batch.feats.shape[-1]
        # the width contract of JAX :75-85: exact when the classeme tail is
        # read, tolerant of unread tail channels otherwise
        if cfg.use_clsme and not cfg.use_name_emb:
            if width != cfg.dim_feat + cfg.dim_clsme:
                raise ValueError(f"feature dim {width} != dim_feat "
                                 f"{cfg.dim_feat} + dim_clsme "
                                 f"{cfg.dim_clsme}")
        elif width < cfg.dim_feat:
            raise ValueError(f"feature dim {width} < dim_feat "
                             f"{cfg.dim_feat}")
        enti2enco = self.encode(batch)                        # (B, N, E)
        n = enti2enco.shape[1]
        pair_ids = torch.as_tensor(ordered_pair_ids(n),
                                   device=enti2enco.device).long()
        s_id, o_id = pair_ids[:, 0], pair_ids[:, 1]
        mask = batch.traj_mask
        pair_mask = mask[:, s_id] & mask[:, o_id]              # (B, NP)
        cat = batch.cat_ids.long()
        s_cat, o_cat = cat[:, s_id], cat[:, o_id]               # (B, NP)
        pred_bias = self.bias_matrix[s_cat, o_cat]              # (B, NP, C)

        parts = []
        if cfg.use_clsme:
            if cfg.use_name_emb:
                sub_clsme = self.EntiNameEmb[s_cat]
                obj_clsme = self.EntiNameEmb[o_cat]
            else:
                lengths = batch.durations[..., 1] - batch.durations[..., 0] \
                    + 1
                # int8 storage: dequantized before the mean, whose weights
                # stay float32 (JAX :110-115)
                extra = dequantize_extra(batch.feats[..., cfg.dim_feat:],
                                         batch.feat_scale)
                clsme_avg = stretch_weighted_mean(extra, lengths)
                sub_clsme, obj_clsme = clsme_avg[:, s_id], clsme_avg[:, o_id]
            # JAX's concat promotes a bf16 classeme mean to float32, the
            # dtype of the node embeddings
            parts += [sub_clsme.float(), obj_clsme.float()]
        parts += [enti2enco[:, s_id], enti2enco[:, o_id]]
        logits = self.fc_pred2logits(torch.cat(parts, dim=-1))
        return {"pred_logits": logits + pred_bias, "pair_ids": pair_ids,
                "pair_mask": pair_mask, "enti_feat": enti2enco}


def basec_label_assignment(props: TrackletBatch, gts: GraphBatch,
                           positive_viou_th: float, t_abs: int = 1024):
    """Vectorized label pre-assignment (JAX :138-162; reference
    tools/train_vidor.py:80-170): a proposal hits a GT trajectory at vIoU
    above the threshold.  Returns (hits (B, N, G), hit_s (B, N, P), hit_o
    (B, N, P)): whether proposal i hits predicate p's subject / object."""
    viou = viou_matrix_grid(props.boxes, props.durations, gts.traj_boxes,
                            gts.traj_durations, props.traj_mask,
                            gts.traj_mask, t_abs=t_abs)        # (B, N, G)
    hits = viou > positive_viou_th
    n = hits.shape[1]
    pred2so = gts.adj.argmax(-1)                               # (B, 2, P)

    def gather(r):                                             # (B, N, P)
        return torch.gather(hits, -1, pred2so[:, r, None, :].expand(
            -1, n, -1)) & gts.pred_mask[:, None, :]
    return hits, gather(0), gather(1)


def basec_multihot(props: TrackletBatch, gts: GraphBatch,
                   num_pred_cats: int, positive_viou_th: float,
                   t_abs: int = 1024):
    """(multihot (B, N, N, C) float32 with the diagonal zeroed, pair_pos
    (B, N, N) bool: valid pairs with at least one label), JAX :165-181."""
    _, hit_s, hit_o = basec_label_assignment(props, gts, positive_viou_th,
                                             t_abs=t_abs)
    onehot = F.one_hot(gts.pred_cats.long(), num_pred_cats).float()
    onehot = onehot * gts.pred_mask[..., None]                 # (B, P, C)
    multihot = torch.einsum("bip,bjp,bpc->bijc", hit_s.float(),
                            hit_o.float(), onehot)
    multihot = (multihot > 0).float()
    n = multihot.shape[1]
    eye = torch.eye(n, dtype=torch.bool, device=multihot.device)
    multihot = multihot.masked_fill(eye[None, :, :, None], 0.0)
    mask = props.traj_mask
    pair_pos = multihot.any(-1) & mask[:, :, None] & mask[:, None, :]
    return multihot, pair_pos


def basec_train_loss(outputs, props: TrackletBatch, gts: GraphBatch,
                     cfg: BaseCConfig, t_abs: int = 1024, mesh=None):
    """Multi-label BCE over the positive pairs only (JAX :184-200;
    reference pairwise_baseline.py:276-310).  ``t_abs`` must cover the
    video-length bound (VidOR: 4096); under a ``mesh`` the denominator is
    summed over the data ranks.  Returns (cls, {"cls": cls})."""
    with torch.no_grad():
        multihot, pair_pos = basec_multihot(
            props, gts, cfg.num_pred_cats, cfg.positive_viou_th,
            t_abs=t_abs)
    logits = outputs["pred_logits"]                            # (B, NP, C)
    s_id, o_id = outputs["pair_ids"][:, 0], outputs["pair_ids"][:, 1]
    labels = multihot[:, s_id, o_id]                           # (B, NP, C)
    pos = pair_pos[:, s_id, o_id]                              # (B, NP)
    bce = torch.maximum(logits, torch.zeros_like(logits)) \
        - logits * labels + torch.log1p(torch.exp(-logits.abs()))
    w = pos[..., None].float()
    denom = torch.clamp(data_sum(w.sum(), mesh) * logits.shape[-1],
                        min=1.0)
    cls = (bce * w).sum() / denom
    return cls, {"cls": cls}
