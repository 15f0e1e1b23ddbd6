"""BIG-C: the predicate-query classification model, for the card.

Port of the JAX package's ``models/big_c.py``: the v10 variant (reference
models/model_0v10.py:239-786, exported as ``BIG_C_vidvrd``) and the v7
variant (models/model_0v7.py, ``BIG_C_vidor``: a frozen query pos-table,
an MLP head and the classeme switch), with the reference parameter names so
a reference ``state_dict`` loads with ``strict=True``.  One call processes
a whole bucket of B videos:

  tracklet geometry+RoI features (B, N, T, .)
    -> per-frame MLPs -> stride-2 temporal conv -> adaptive-max-pool to
       ``enco_pool_len`` -> per-tracklet node embedding (B, N, E)
    -> transformer encoder over the N tracklet tokens (masked)
    -> role-factored query decoder producing soft adjacency (B, 2, Q, N)
    -> prediction head (I3D / classeme gathers + frequency-bias logits)

int8 feature storage (``pack_proposal(dtype=np.int8)``, a scale per video
in ``feat_scale``) runs the encoder's first visual layer as an int8 product
at inference, and is dequantized once up front in train mode (JAX
``big_c.py:106-116, 198-207, 270-278, 321-324``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..data.types import TrackletBatch
from ..ops.segments import (stretch_conv_patches, adaptive_max_pool1d,
                            stretch_weighted_mean)
from ..utils.spans import span
from .layers import (MLP, TransformerEncoderLayer, RoleAttnDecoderLayer,
                     sine_pos_embedding)


@dataclasses.dataclass(frozen=True)
class BigCConfig:
    num_pred_cats: int
    num_enti_cats: int
    dim_feat: int                 # RoI feature dim (2048 vidvrd / 1024 vidor)
    dim_clsme: int = 300
    dim_enti: int = 512
    dim_pred: int = 512
    dim_att: int = 512
    dim_ffn: int = 512
    dim_i3d: Optional[int] = None     # v10: extra I3D channels after dim_feat
    enco_pool_len: int = 4
    n_enco_layers: int = 2
    n_deco_layers: int = 6
    n_att_head: int = 8
    num_querys: int = 192
    dropout: float = 0.1
    variant: str = "v10"          # "v10" (learned pos-emb, linear head)
    #                               "v7" (frozen pos-table, MLP head)
    use_clsme: bool = True        # v7 only: include classeme in the head
    use_name_emb: bool = True     # v7: True -> EntiNameEmb lookup,
    #                               False -> per-frame classeme channels
    # training (train/losses.py)
    neg_weight: float = 0.1
    positive_viou_th: float = 0.5
    cost_coeff_cls: float = 1.0
    cost_coeff_adj: float = 30.0
    loss_coeff_cls: float = 1.0
    loss_coeff_adj: float = 30.0
    # dtype of the per-frame encoder matmuls (params stay float32)
    compute_dtype: str = "float32"

    @property
    def clsme_in_feats(self) -> bool:
        """Whether per-frame classeme channels ride after dim_feat in feats."""
        return self.variant == "v7" and self.use_clsme and not self.use_name_emb

    @property
    def name_emb_in_head(self) -> bool:
        """Whether the head reads the frozen ``EntiNameEmb`` table."""
        return self.variant == "v10" or (self.use_clsme and self.use_name_emb)

    @classmethod
    def from_dict(cls, d: dict, variant: str = "v10"):
        """Build from a reference-style ``model_config`` dict (same keys,
        the loss weights included).  v7 reads the name embeddings only when
        the config names their file."""
        cost = d.get("cost_coeff_dict", {})
        loss = d.get("loss_coeff_dict", {})
        return cls(
            num_pred_cats=d["num_pred_cats"],
            num_enti_cats=d["num_enti_cats"],
            dim_feat=d["dim_feat"], dim_clsme=d.get("dim_clsme", 300),
            dim_enti=d["dim_enti"], dim_pred=d["dim_pred"],
            dim_att=d["dim_att"], dim_ffn=d["dim_ffn"],
            dim_i3d=d.get("dim_i3d"),
            enco_pool_len=d["enco_pool_len"],
            n_enco_layers=d["n_enco_layers"],
            n_deco_layers=d["n_deco_layers"],
            n_att_head=d["n_att_head"], num_querys=d["num_querys"],
            variant=variant,
            use_clsme=d.get("use_clsme", True),
            use_name_emb=(d.get("EntiNameEmb_path") is not None
                          if variant == "v7" else True),
            neg_weight=d.get("neg_weight", 0.1),
            positive_viou_th=d.get("positive_vIoU_th", 0.5),
            cost_coeff_cls=cost.get("classification", 1.0),
            cost_coeff_adj=cost.get("adj_matrix", 30.0),
            loss_coeff_cls=loss.get("classification", 1.0),
            loss_coeff_adj=loss.get("adj_matrix", 30.0),
            compute_dtype=d.get("compute_dtype", "float32"),
        )


def scale_like(feat_scale, ndim: int):
    """The per-video ``feat_scale`` (B,) reshaped to broadcast against a
    tensor of ``ndim`` dimensions led by the batch axis."""
    return feat_scale.reshape(feat_scale.shape
                              + (1,) * (ndim - feat_scale.dim()))


def dequantize_extra(extra, feat_scale):
    """int8-stored aux channels times their per-video scale, float32 (JAX
    ``big_c.py:106-116``); float inputs pass unchanged.  Shared by BigC and
    BaseC."""
    if extra.dtype != torch.int8:
        return extra
    return extra.to(torch.float32) * scale_like(feat_scale, extra.dim())


def geometry_features(batch: TrackletBatch):
    """Per-frame 8-dim box geometry, stretched to the bucket length.

    Matches reference model_0v10.py:391-430: normalized center/size plus
    *forward* frame differences zero-padded at the trajectory's last frame.
    """
    w = batch.video_wh[..., 0][..., None, None]
    h = batch.video_wh[..., 1][..., None, None]
    b = batch.boxes                                   # (..., N, T, 4)
    x1, y1, x2, y2 = b[..., 0] / w, b[..., 1] / h, b[..., 2] / w, b[..., 3] / h
    vals = torch.stack([(x2 + x1) / 2, (y2 + y1) / 2, x2 - x1, y2 - y1],
                       dim=-1)                        # (..., N, T, 4)
    diffs = torch.cat([vals[..., 1:, :] - vals[..., :-1, :],
                       torch.zeros_like(vals[..., :1, :])], dim=-2)
    lengths = batch.durations[..., 1] - batch.durations[..., 0] + 1
    t = b.shape[-2]
    diff_ok = torch.arange(t, device=b.device) < (lengths[..., None] - 1)
    diffs = diffs * diff_ok[..., None]
    return torch.stack(
        [vals[..., 0], diffs[..., 0], vals[..., 1], diffs[..., 1],
         vals[..., 2], diffs[..., 2], vals[..., 3], diffs[..., 3]], dim=-1)


class TrackletEncoder(nn.Module):
    """Per-tracklet node embedding (reference model_0v10.py:289-309,
    446-458): geometry + RoI MLPs -> stride-2 temporal conv -> adaptive max
    pool -> channel-major flatten -> MLP.

    The reference keeps these layers at the top of the model's state_dict,
    so the models that use the encoder subclass it.  ``compute_dtype`` runs
    the per-frame matmuls in bfloat16; the conv output returns to float32.
    """

    def __init__(self, dim_enti: int, dim_feat: int, enco_pool_len: int,
                 compute_dtype: str = "float32"):
        super().__init__()
        e = dim_enti
        self.dim_feat, self.enco_pool_len = dim_feat, enco_pool_len
        self.compute_dtype = getattr(torch, compute_dtype)
        self.fc_bbox2enti = MLP(8, (e, e))
        self.fc_feat2enti = MLP(dim_feat, (e, e))
        self.conv_feat2enti = nn.Conv1d(2 * e, e, kernel_size=3, stride=2,
                                        padding=1)
        self.fc_enti2enco = MLP(e * enco_pool_len, (e, e))

    def encode(self, batch: TrackletBatch):
        """(B, N, T, D) features -> (B, N, E) float32 node embeddings."""
        cdt = self.compute_dtype
        # the stretch gather commutes with the per-frame MLPs (both are
        # rowwise), so the wide matmuls run on the raw frames
        geo = geometry_features(batch)                        # (B, N, T, 8)
        x_geo = self.fc_bbox2enti(geo.to(cdt))                # cdt
        visual = batch.feats[..., :self.dim_feat]
        if visual.dtype == torch.int8:
            # int8 storage (JAX :198-207): the first layer is an int8
            # product over the per-video scale and returns bfloat16, the
            # second runs in bfloat16 (JAX MLP), so x_vis is bfloat16
            x_vis = self.fc_feat2enti(visual, input_scale=scale_like(
                batch.feat_scale, visual.dim()))
        else:
            x_vis = self.fc_feat2enti(visual.to(cdt))         # cdt
        # JAX's concat promotes (bf16, f32) to float32, which is cdt under
        # float32 compute; under bfloat16 compute both halves are bf16
        x = torch.cat([x_geo, x_vis.to(cdt)], dim=-1)         # (B, N, T, 2E)
        bsz, n, t, _ = x.shape
        patches = stretch_conv_patches(x.reshape(bsz * n, t, -1),
                                       batch.stretch_idx.reshape(bsz * n, t))
        conv = self.conv_feat2enti                            # (E, 2E, k)
        w = conv.weight.permute(2, 1, 0).reshape(-1, conv.out_channels)
        x = patches @ w.to(cdt) + conv.bias.to(cdt)           # (BN, To, E)
        x = adaptive_max_pool1d(x.float(), self.enco_pool_len, axis=-2)
        # channel-major flatten, as the reference: (n, E, pool) -> (n, E*pool)
        x = x.transpose(-1, -2).reshape(bsz, n, -1)
        return self.fc_enti2enco(x)                           # (B, N, E)


class BigC(TrackletEncoder):
    """Batched BIG-C forward, v10 or v7.

    ``enti_name_emb`` fills the frozen ``EntiNameEmb`` buffer
    (num_enti_cats, dim_clsme) of the heads that read it; ``generator``
    seeds the initial weights.  v7 keeps its query positions in a frozen
    ``pos_embedding`` buffer: ``pos_emb_table`` when given, else the sine
    table.  Reference quirk: model_0v7's init xavier-overwrites its sine
    table, so every trained v7 checkpoint carries a random frozen table,
    which loads with the rest of its ``state_dict``.
    """

    def __init__(self, cfg: BigCConfig, enti_name_emb=None,
                 generator: Optional[torch.Generator] = None,
                 pos_emb_table=None):
        if cfg.variant not in ("v10", "v7"):
            raise ValueError(f"BigC variant {cfg.variant!r}: v10 or v7")
        super().__init__(cfg.dim_enti, cfg.dim_feat, cfg.enco_pool_len,
                         cfg.compute_dtype)
        self.cfg = cfg
        e, dp = cfg.dim_enti, cfg.dim_pred
        self.encoder_layers = nn.ModuleList(
            TransformerEncoderLayer(e, cfg.n_att_head, cfg.dim_ffn,
                                    cfg.dropout)
            for _ in range(cfg.n_enco_layers))
        self.decoder_layers = nn.ModuleList(
            RoleAttnDecoderLayer(dp, cfg.n_att_head, e, cfg.dim_att,
                                 cfg.dim_ffn, cfg.dropout)
            for _ in range(cfg.n_deco_layers))
        self.pred_query_init = nn.Parameter(torch.empty(cfg.num_querys, dp))
        if cfg.variant == "v7":
            table = (sine_pos_embedding(cfg.num_querys, dp)
                     if pos_emb_table is None else pos_emb_table)
            self.register_buffer("pos_embedding", torch.as_tensor(
                np.asarray(table, np.float32)).reshape(cfg.num_querys, dp))
        else:
            self.pos_embedding = nn.Parameter(torch.empty(cfg.num_querys,
                                                          dp))
        self.bias_matrix = nn.Parameter(torch.zeros(
            cfg.num_enti_cats, cfg.num_enti_cats, cfg.num_pred_cats))
        head_in = dp + 2 * e
        if cfg.dim_i3d:
            self.fc_i3d = MLP(cfg.dim_i3d, (e,))
            head_in += 2 * e
        if cfg.use_clsme or cfg.variant == "v10":
            head_in += 2 * cfg.dim_clsme
        if cfg.variant == "v7":
            self.fc_pred2logits = MLP(head_in, (cfg.dim_ffn,
                                                cfg.num_pred_cats),
                                      final_relu=False)
        else:
            self.fc_pred2logits = nn.Linear(head_in, cfg.num_pred_cats)
        if cfg.name_emb_in_head:
            emb = (torch.zeros(cfg.num_enti_cats, cfg.dim_clsme)
                   if enti_name_emb is None else
                   torch.as_tensor(np.asarray(enti_name_emb, np.float32)))
            self.register_buffer("EntiNameEmb", emb)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """The JAX package's init: xavier-normal (v10) or xavier-uniform
        (v7) weights (the packed (3D, D) fan for in_proj), zero biases,
        N(0, 0.1) queries and v10 positional embedding, zero bias_matrix."""
        xavier = (nn.init.xavier_uniform_ if self.cfg.variant == "v7"
                  else nn.init.xavier_normal_)
        for name, p in self.named_parameters():
            if name in ("pred_query_init", "pos_embedding"):
                p.normal_(0.0, 0.1, generator=generator)
            elif name == "bias_matrix" or p.ndim == 1:
                p.zero_()
            elif p.ndim >= 2:
                xavier(p, generator=generator)
        for mod in self.modules():
            if isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)

    def forward(self, batch: TrackletBatch, generator=None):
        """Returns dict with pred_queries (B,Q,Dp), pred_logits (B,Q,C),
        att (B,2,Q,N) float32, enti_feat (B,N,E).  In train mode every
        dropout draws from ``generator`` (see ``ops.attention.dropout``)."""
        cfg = self.cfg
        consumed = (cfg.dim_i3d or 0) + (
            cfg.dim_clsme if cfg.clsme_in_feats else 0)
        expect = cfg.dim_feat + consumed
        width = batch.feats.shape[-1]
        # the paths that read the tail (v10 I3D, v7 classeme) take exactly
        # the on-disk width; otherwise tail channels are ignored, as the
        # reference slices [..., :dim_feat] (VidOR files always carry the
        # 300-d classeme, which the exp4 head never reads)
        if (width != expect) if consumed else (width < expect):
            raise ValueError(
                f"feature dim {width} does not fit dim_feat {cfg.dim_feat} "
                f"+ {consumed} channels the head reads; check dataset fmt "
                "vs config")
        if batch.feats.dtype == torch.int8 and self.training:
            # int8 storage is a serving path; training dequantizes the whole
            # feature tensor once, in the compute dtype (JAX :270-278)
            cdt = self.compute_dtype
            batch = batch.replace(feats=batch.feats.to(cdt) * scale_like(
                batch.feat_scale, batch.feats.dim()).to(cdt))
        mask = batch.traj_mask
        with span("encoder"):
            enti2enco = self.encode(batch)
            out = enti2enco
            for layer in self.encoder_layers:
                out = layer(out, key_mask=mask, generator=generator)
            enco_output = out                                 # (B, N, E)

        with span("decoder"):
            bsz = enti2enco.shape[0]
            pred_queries = self.pred_query_init[None].expand(bsz, -1, -1)
            att = None
            for layer in self.decoder_layers:
                pred_queries, att = layer(pred_queries, self.pos_embedding,
                                          enco_output, mask, generator)

        with span("head"):
            extra_avg = None
            if consumed:
                # the reference averages over the *stretched* axis
                # (model_0v10.py:470): a repeat-counts-weighted raw-frame
                # mean
                lengths = batch.durations[..., 1] - \
                    batch.durations[..., 0] + 1
                extra_avg = stretch_weighted_mean(dequantize_extra(
                    batch.feats[..., cfg.dim_feat:expect],
                    batch.feat_scale), lengths)
            pred_logits = self._prediction_head(
                pred_queries, att, batch.cat_ids, extra_avg, enti2enco)
        return {"pred_queries": pred_queries, "pred_logits": pred_logits,
                "att": att, "enti_feat": enti2enco}

    def _prediction_head(self, pred_queries, att, cat_ids, extra_avg,
                         enti_feat):
        """Reference model_0v10.py:478-507 / model_0v7.py:483-511,
        batched."""
        cfg = self.cfg
        pred_soid = torch.argmax(att, dim=-1)                 # (B, 2, Q)
        pred_socat = torch.gather(
            cat_ids[:, None, :].expand(-1, 2, -1), -1, pred_soid).long()
        pred_bias = self.bias_matrix[pred_socat[:, 0], pred_socat[:, 1]]

        rows = torch.arange(att.shape[0], device=att.device)[:, None]

        def gather_traj(x, ids):                      # (B, N, D) -> (B, Q, D)
            # an index, not torch.gather: on the card its backward sums the
            # duplicate rows in a fixed order (gather's scatter_add does
            # not), so a train step is bit-reproducible
            return x[rows, ids]

        sub_feat = gather_traj(enti_feat, pred_soid[:, 0])
        obj_feat = gather_traj(enti_feat, pred_soid[:, 1])
        if cfg.clsme_in_feats:
            sub_clsme = gather_traj(extra_avg, pred_soid[:, 0]).float()
            obj_clsme = gather_traj(extra_avg, pred_soid[:, 1]).float()
        elif cfg.name_emb_in_head:
            sub_clsme = self.EntiNameEmb[pred_socat[:, 0]]
            obj_clsme = self.EntiNameEmb[pred_socat[:, 1]]
        if cfg.dim_i3d:  # reference model_0v10.py:495-501
            # a bf16 i3d mean runs fc_i3d in bf16; the head is float32
            sub_i3d = self.fc_i3d(gather_traj(extra_avg, pred_soid[:, 0]))
            obj_i3d = self.fc_i3d(gather_traj(extra_avg, pred_soid[:, 1]))
            parts = [pred_queries, sub_i3d.float(), obj_i3d.float(),
                     sub_feat, obj_feat, sub_clsme, obj_clsme]
        elif cfg.variant == "v7" and not cfg.use_clsme:
            parts = [pred_queries, sub_feat, obj_feat]
        else:
            parts = [pred_queries, sub_clsme, obj_clsme, sub_feat, obj_feat]
        logits = self.fc_pred2logits(torch.cat(parts, dim=-1))
        return logits + pred_bias


def load_bias_matrix(model: BigC, bias_matrix) -> BigC:
    """Overwrite the trainable ``bias_matrix`` with a precomputed prior."""
    bias = torch.as_tensor(np.asarray(bias_matrix, np.float32))
    if bias.shape != model.bias_matrix.shape:
        raise ValueError(f"bias matrix {tuple(bias.shape)} != "
                         f"{tuple(model.bias_matrix.shape)}")
    with torch.no_grad():
        model.bias_matrix.copy_(bias)
    return model
