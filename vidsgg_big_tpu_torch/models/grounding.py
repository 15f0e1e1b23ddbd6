"""Multi-bin temporal grounding model (stage 2 of BIG), for the card.

Port of the JAX package's ``models/grounding.py`` (reference class ``DEBUG``,
models/grd_model_v5.py:140-737): QANet-style encoders over the clips and the
query words, video/query similarity fusion, a combined QANet encoder over
every (query, clip) pair, and three per-bin conv heads; then the test-time
decode, and the training side: the FCOS-style label geometry
(:func:`grounding_gt_labels`) and the loss (:func:`grounding_loss`).
Queries of one video are padded to a fixed Q and clips to a fixed T; clip
validity rides through attention, pooling, the decode and every loss
denominator.  The modules keep the reference parameter names, so a
reference ``state_dict`` loads with ``strict=True``.  In train mode every
dropout draws from the ``generator`` handed to the forward, so a step's
randomness is a function of that generator alone.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import (attn_chunked_stored, chunked_attention,
                             composed_qkvo, dropout, row_share)
from ..ops.composed_attn import fused_composed_attention
from ..ops.dwsep_conv import (conv_epilogue, dwsep_conv, dwsep_conv_aten,
                              kernel_takes)
from ..ops.temporal import tiou, tiou_left_right
from ..parallel.mesh import data_sum
from ..utils.spans import span
from .layers import LN_EPS, MultiHeadAttention, _linear, sine_pos_embedding

HEADS = 8        # QANet attention heads (reference grd_model_v5.py:103)


@dataclasses.dataclass(frozen=True)
class GroundingConfig:
    dim_feat: int = 1024          # I3D clip-feature dim
    dim_clsme: int = 300          # GloVe word-embedding dim
    dim_hidden: int = 128
    num_bins: int = 10
    num_pred_cats: int = 51
    num_enti_cats: int = 81
    dropout: float = 0.1
    loss_cls: float = 1.0
    loss_ctn: float = 1.0
    loss_reg: float = 1.0
    # compute dtype of the conv/attention stacks; params stay float32,
    # layernorms and softmaxes compute in float32
    compute_dtype: str = "float32"
    attn_dropout: float = 0.1
    attn_bytes_budget: int = 1 << 30
    fused_attention: bool = True
    # the JAX config's opt-in: the three heads' final point-wise kernels
    # start at 0.02x their default init, so head logits start O(1)
    stable_head_init: bool = False

    @classmethod
    def from_dict(cls, d: dict):
        """Build from a reference-style ``model_config`` dict.  The JAX
        package's ``fused_interpret`` (Pallas interpret mode) is accepted and
        ignored."""
        lf = d.get("loss_factor", {})
        return cls(dim_feat=d["dim_feat"], dim_clsme=d["dim_clsme"],
                   dim_hidden=d["dim_hidden"], num_bins=d["num_bins"],
                   num_pred_cats=d.get("num_pred_cats", 51),
                   num_enti_cats=d.get("num_enti_cats", 81),
                   loss_cls=lf.get("classification", 1.0),
                   loss_ctn=lf.get("centerness", 1.0),
                   loss_reg=lf.get("regression", 1.0),
                   compute_dtype=d.get("compute_dtype", "float32"),
                   attn_dropout=d.get("attn_dropout", 0.1),
                   attn_bytes_budget=d.get("attn_bytes_budget", 1 << 30),
                   fused_attention=d.get("fused_attention", True),
                   stable_head_init=d.get("stable_head_init", False))


def attention_lowering(b: int, t: int, d: int, budget: int,
                       composed: bool = True):
    """Which lowering the QANet attention takes for a (b, t, d) input, as
    ``models/grounding.py:299-331`` of the JAX package: ``("direct", b)``
    while the (b, 8, t, t) float32 logits fit ``budget``; past it the batch
    halves into chunks and, when the halving got below b, ``("composed",
    chunk)`` for 128-aligned t and d (the kernels on the card) or
    ``("chunked", chunk)``.  ``composed=False`` (the fused path switched
    off) never picks the composed path."""
    chunk = b
    while chunk * HEADS * t * t * 4 > budget and chunk % 2 == 0:
        chunk //= 2
    if chunk < b and 4 * b * HEADS * t * t > budget:
        if composed and t % 128 == 0 and d % 128 == 0:
            return "composed", chunk
        return "chunked", chunk
    return "direct", b


def composed_encoders(cfg: "GroundingConfig", b: int, q: int, t: int):
    """The QANet encoders of a (B, Q, T) eval forward whose attention takes
    the composed path (one kernel launch each on the card)."""
    shapes = {"video_encoder": (b, t), "query_encoder": (b * q, 3),
              "combined_encoder": (b * q, t)}
    return [name for name, (rows, length) in shapes.items()
            if attention_lowering(rows, length, cfg.dim_hidden,
                                  cfg.attn_bytes_budget,
                                  cfg.fused_attention)[0] == "composed"]


class DepthwiseSeparableConv(nn.Module):
    """Depthwise + pointwise 1-D conv over time (reference
    grd_model_v5.py:36-56), (B, T, C_in) -> (B, T, C_out), with the
    caller's ReLU, residual and mask (``ops/dwsep_conv.conv_epilogue``).

    A float32 call that records no gradient, at a shape the kernel takes
    (C_in = 128, C_out <= 128, odd k <= 7), goes through the registered op
    ``dwsep_conv``: one channels-last kernel on the card, the plain version
    on the CPU.  Otherwise float32 runs the two convs as ATen ops on the
    transposed input, then the epilogue, and bfloat16 composes them into
    one dense (C_out, C_in, k) conv first (W[o, c, k] = pw[o, c] dw[c, k],
    the bias folded), as the JAX package does in bf16.  Either way the
    weights are float32 and are cast to the compute dtype after composing.
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int):
        super().__init__()
        self.kernel_size = kernel_size
        self.depth_wise = nn.Conv1d(in_channels, in_channels, kernel_size,
                                    padding=kernel_size // 2,
                                    groups=in_channels)
        self.point_wise = nn.Conv1d(in_channels, out_channels, 1)

    def forward(self, x, relu: bool = False, residual=None, mask=None):
        cdt = x.dtype
        dw, pw = self.depth_wise, self.point_wise
        weights = (dw.weight, dw.bias, pw.weight, pw.bias)
        if cdt == torch.bfloat16:
            full = pw.weight * dw.weight[:, 0, :][None]      # (O, C, k)
            bias = pw.weight[:, :, 0] @ dw.bias + pw.bias
            y = F.conv1d(x.transpose(1, 2), full.to(cdt), bias.to(cdt),
                         padding=self.kernel_size // 2)
            return conv_epilogue(y.transpose(1, 2), relu, residual, mask)
        if cdt == torch.float32 and kernel_takes(
                x.shape[-1], pw.out_channels, self.kernel_size) and not (
                torch.is_grad_enabled() and any(
                    a is not None and a.requires_grad
                    for a in (x, residual) + weights)):
            return dwsep_conv(x.contiguous(), *weights, relu,
                              None if residual is None else
                              residual.contiguous(),
                              None if mask is None else mask.contiguous())
        return dwsep_conv_aten(x, *weights, relu, residual, mask)


class QANetEncoderLayer(nn.Module):
    """QANet block: pos-enc -> convs(+res) -> self-attn(+res) -> fc(+res)
    (reference grd_model_v5.py:81-137), (B, T, D) -> (B, T, D).

    Padded clips are re-zeroed after every sublayer, so valid clips see a
    fixed zero boundary and outputs do not depend on the T bucket.  The
    attention picks its lowering with :func:`attention_lowering`, as the JAX
    layer's ``use_fused`` / ``use_flash`` (models/grounding.py:299-331):
    direct at small shapes; past ``attn_bytes_budget`` of logits at
    128-aligned shapes, the composed attention (the CUDA kernels on the
    card, their plain versions on the CPU) in train and eval mode with
    ``fused_attention``, and with ``flash_attention`` (the JAX package's
    stock flash option, the same function, deterministic only) when no
    attention dropout is drawn; else the chunked stored-softmax path.
    Train-mode dropouts draw from the forward's generator.
    """

    def __init__(self, d_model: int, num_conv: int, kernel_size: int,
                 dropout: float = 0.1, attn_dropout: float = 0.1,
                 attn_bytes_budget: int = 1 << 30,
                 fused_attention: bool = True, flash_attention: bool = False,
                 compute_dtype: str = "float32"):
        super().__init__()
        self.dropout, self.attn_dropout = dropout, attn_dropout
        self.attn_bytes_budget = attn_bytes_budget
        # fused_attention takes the composed path in train and eval mode;
        # flash_attention alone only where no attention dropout is drawn
        self.composed = fused_attention or flash_attention
        self.flash_only = flash_attention and not fused_attention
        self.compute_dtype = getattr(torch, compute_dtype)
        self.convs = nn.ModuleList(
            DepthwiseSeparableConv(d_model, d_model, kernel_size)
            for _ in range(num_conv))
        self.norm_seq = nn.ModuleList(nn.LayerNorm(d_model, eps=LN_EPS)
                                      for _ in range(num_conv))
        self.normb = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norme = nn.LayerNorm(d_model, eps=LN_EPS)
        # packed in_proj + out_proj, as torch's MultiheadAttention; the
        # attention itself is computed below
        self.mh_attn = MultiHeadAttention(d_model, HEADS, attn_dropout)
        self.fc = nn.Linear(d_model, d_model)

    def forward(self, x, mask=None, generator=None):
        cdt = self.compute_dtype
        x = x.to(cdt)
        t, d = x.shape[1], x.shape[2]
        drop = lambda o, p: dropout(o, p, generator, self.training)
        ln = lambda norm, o: norm(o.float()).to(cdt)
        z = ((lambda o: o.masked_fill(~mask[..., None], 0.0))
             if mask is not None else (lambda o: o))
        pos = torch.from_numpy(sine_pos_embedding(t, d)).to(x.device, cdt)
        out = z(x + pos[None])
        res = out
        out = z(ln(self.normb, out))
        n = len(self.convs)
        for i, (conv, norm) in enumerate(zip(self.convs, self.norm_seq)):
            out = conv(out, relu=True, residual=res, mask=mask)
            if (i + 1) % 2 == 0:
                out = drop(out, self.dropout * (i + 1) / n)
            res = out
            out = z(ln(norm, out))
        out = z(self._attention(out, mask, generator) + res)
        out = drop(out, self.dropout)
        res = out
        out = z(ln(self.norme, out))
        out = z(F.relu(_linear(self.fc, out)) + res)
        return drop(out, self.dropout)

    def _head_weights(self):
        """Per-head float32 projections (wq, bq, wk, wv, wo, bv, bo) from the
        packed parameters: q/k/v kernels (d, h, hd), biases (h, hd), output
        kernel (h, hd, d)."""
        a = self.mh_attn
        d = a.dim
        hd = d // HEADS
        w, b = a.in_proj_weight, a.in_proj_bias
        kern = lambda i: w[i * d:(i + 1) * d].t().reshape(d, HEADS, hd)
        return (kern(0), b[:d].reshape(HEADS, hd), kern(1), kern(2),
                a.out_proj.weight.t().reshape(HEADS, hd, d),
                b[2 * d:].reshape(HEADS, hd), a.out_proj.bias)

    def _attention(self, x, mask, generator=None):
        b, t, d = x.shape
        cdt = x.dtype
        a = self.mh_attn
        hd = d // HEADS
        p = self.attn_dropout if self.training else 0.0
        # a sharded train step picks the single process's lowering, by the
        # global batch's rows, so that it draws the same masks
        way, chunk = attention_lowering(
            b * row_share(generator)[1], t, d, self.attn_bytes_budget,
            composed=self.composed and not (self.flash_only and p > 0.0))
        if way == "composed":
            comp = composed_qkvo(*self._head_weights())
            return fused_composed_attention(x, mask, *comp, hd=hd,
                                            dropout=p, generator=generator)
        if mask is None:
            mask = torch.ones((b, t), dtype=torch.bool, device=x.device)
        w, bias = a.in_proj_weight.to(cdt), a.in_proj_bias.to(cdt)
        q, k, v = (F.linear(x, w[i * d:(i + 1) * d], bias[i * d:(i + 1) * d]
                            ).reshape(b, t, HEADS, hd) for i in range(3))
        attend = attn_chunked_stored if way == "chunked" else \
            chunked_attention
        o = attend(q, k, v, mask, chunk=chunk, dropout=p,
                   generator=generator)
        return _linear(a.out_proj, o.reshape(b, t, d))


class ConvHead(nn.Sequential):
    """4 x (dw-sep conv + relu) + a final dw-sep conv (reference
    grd_model_v5.py:182-193; torch indices ``i.0`` and ``4``), padded clips
    re-zeroed between convs (the ReLU and the mask go into each conv's
    call); the output is float32."""

    def __init__(self, d_model: int, out_channels: int, sigmoid: bool = False):
        super().__init__(*[nn.Sequential(
            DepthwiseSeparableConv(d_model, d_model, 3)) for _ in range(4)],
            DepthwiseSeparableConv(d_model, out_channels, 3))
        self.sigmoid = sigmoid

    def forward(self, x, mask=None):
        for block in list(self)[:-1]:
            x = block[0](x, relu=True, mask=mask)
        x = self[-1](x).float()
        return torch.sigmoid(x) if self.sigmoid else x


class GroundingModel(nn.Module):
    """Batched grounding forward.

    Inputs (one video per batch row):
      video_feats: (B, T, dim_feat) I3D clip features (zero padded).
      clip_mask:   (B, T) validity.
      query_cats:  (B, Q, 3) [sub_cat, pred_cat, obj_cat] ids, embedded
                   through the trainable ``EntiNameEmb`` / ``PredNameEmb``.
      temporal:    (B, Q, 2) normalized subject∩object duration.
      query_mask:  (B, Q) validity (the forward does not read it; the
                   decode does).
    Returns regrs (B,Q,T,2,K), conf_logits (B,Q,T,K), cls_logits (B,Q,T,K),
    float32.  ``generator`` seeds the initial weights; the forward's own
    ``generator`` feeds the train-mode dropouts.
    """

    def __init__(self, cfg: GroundingConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        h = cfg.dim_hidden
        self.EntiNameEmb = nn.Parameter(torch.empty(cfg.num_enti_cats,
                                                    cfg.dim_clsme))
        self.PredNameEmb = nn.Parameter(torch.empty(cfg.num_pred_cats,
                                                    cfg.dim_clsme))
        self.video_fc = nn.Linear(cfg.dim_feat, h)
        self.query_fc = nn.Linear(cfg.dim_clsme, h)
        self.temp_fc = nn.Linear(2, h)
        kw = dict(dropout=cfg.dropout, attn_dropout=cfg.attn_dropout,
                  attn_bytes_budget=cfg.attn_bytes_budget,
                  fused_attention=cfg.fused_attention,
                  compute_dtype=cfg.compute_dtype)
        self.video_encoder = QANetEncoderLayer(h, 4, 7, **kw)
        self.query_encoder = QANetEncoderLayer(h, 4, 3, **kw)
        self.proj2sim = nn.Linear(h, h, bias=False)
        self.vq_fc = nn.Linear(4 * h, h)
        self.combined_encoder = QANetEncoderLayer(h, 4, 7, **kw)
        self.regr_head = ConvHead(h, 2 * cfg.num_bins, sigmoid=True)
        self.conf_head = ConvHead(h, cfg.num_bins)
        self.cls_head = ConvHead(h, cfg.num_bins)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """The JAX package's init in kind: linear layers U(+-1/sqrt(fan_in))
        (torch's default), attention q/k/v xavier-uniform per (d, d) block,
        convs kaiming-normal, zero biases, N(0, 0.02) name tables; with
        ``stable_head_init`` the heads' final point-wise kernels x 0.02
        (JAX's ``out_kernel_init``, models/grounding.py:479-491)."""
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                bound = 1.0 / math.sqrt(mod.in_features)
                mod.weight.uniform_(-bound, bound, generator=generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.Conv1d):
                fan_in = mod.weight.shape[1] * mod.weight.shape[2]
                mod.weight.normal_(0.0, math.sqrt(2.0 / fan_in),
                                   generator=generator)
                mod.bias.zero_()
            elif isinstance(mod, MultiHeadAttention):
                for w in mod.in_proj_weight.split(mod.dim):
                    nn.init.xavier_uniform_(w, generator=generator)
                mod.in_proj_bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        for table in (self.EntiNameEmb, self.PredNameEmb):
            table.normal_(0.0, 0.02, generator=generator)
        if self.cfg.stable_head_init:
            for head in (self.regr_head, self.conf_head, self.cls_head):
                head[-1].point_wise.weight.mul_(0.02)

    def forward(self, video_feats, clip_mask, query_cats, temporal,
                query_mask=None, generator=None):
        cfg = self.cfg
        cdt = getattr(torch, cfg.compute_dtype)
        b, t, _ = video_feats.shape
        q = query_cats.shape[1]
        hid = cfg.dim_hidden
        with span("embed"):
            qc = query_cats.long()
            words_emb = torch.stack([self.EntiNameEmb[qc[..., 0]],
                                     self.PredNameEmb[qc[..., 1]],
                                     self.EntiNameEmb[qc[..., 2]]], dim=2)
            video = _linear(self.video_fc, video_feats.to(cdt))    # (B,T,H)
            words = _linear(self.query_fc, words_emb.to(cdt))      # (B,Q,3,H)
            temp = _linear(self.temp_fc, temporal.to(cdt))         # (B,Q,H)
            query = words + temp[:, :, None, :]

        with span("encoders"):
            video = self.video_encoder(video, mask=clip_mask,
                                       generator=generator)
            query = self.query_encoder(
                query.reshape(b * q, 3, hid),
                generator=generator).reshape(b, q, 3, hid)

        # similarity fusion (reference grd_model_v5.py:331-368)
        with span("fusion"):
            vproj = _linear(self.proj2sim, video)                 # (B,T,H)
            sim = torch.einsum("bth,bqlh->bqtl", vproj, query).float()
            sim_r = torch.softmax(sim, dim=-1).to(cdt)           # over words
            cm = clip_mask[:, None, :, None]
            sim_c = torch.softmax(sim.masked_fill(
                ~cm, torch.finfo(torch.float32).min), dim=-2)    # over clips
            sim_c = sim_c.masked_fill(~cm, 0.0).to(cdt)
            mat_a = torch.einsum("bqtl,bqlh->bqth", sim_r, query)
            # sim_r (sim_c^T video) instead of (sim_r sim_c^T) video: the
            # same product through the small (Q, 3, H) contraction, no
            # (Q, T, T)
            cv = torch.einsum("bqsl,bsh->bqlh", sim_c, video)
            mat_b = torch.einsum("bqtl,bqlh->bqth", sim_r, cv)
            vexp = video[:, None]
            combined = torch.cat([vexp.expand_as(mat_a), mat_a, mat_a * vexp,
                                  mat_b * vexp], dim=-1)         # (B,Q,T,4H)
            combined = _linear(self.vq_fc, combined)
        with span("combined"):
            flat_mask = clip_mask.repeat_interleave(q, dim=0)    # (BQ, T)
            flat = self.combined_encoder(combined.reshape(b * q, t, hid),
                                         mask=flat_mask, generator=generator)
        with span("heads"):
            k = cfg.num_bins
            regrs = self.regr_head(flat, mask=flat_mask).reshape(
                b, q, t, 2, k)
            conf = self.conf_head(flat, mask=flat_mask).reshape(b, q, t, k)
            cls = self.cls_head(flat, mask=flat_mask).reshape(b, q, t, k)
        return regrs, conf, cls


# ---------------------------------------------------------------------------
# ground-truth label geometry and training loss (reference
# grd_model_v5.py:224-250, 375-527), batched over videos
# ---------------------------------------------------------------------------

def _bin_edges(num_bins: int, device=None):
    """``jnp.linspace(0, 1, num_bins + 1)`` in float32, bit for bit (i times
    the float32 step, the end point exact)."""
    edges = torch.arange(num_bins + 1, dtype=torch.float32, device=device) \
        * torch.tensor(1.0 / num_bins, dtype=torch.float32, device=device)
    edges[-1] = 1.0
    return edges


def grounding_gt_labels(target, n_clips, t: int, num_bins: int):
    """FCOS-style labels for normalized target spans.

    Args:
      target: (B, Q, 2) normalized [start, end] in [0, 1].
      n_clips: (B,) true clip counts.
      t: the clip bucket.

    Returns (gt_regrs (B,Q,T,2), gt_ctness (B,Q,T), gt_scores (B,Q,T),
    bin_ids (B,Q) int64); positions >= n_clips are all zero.
    """
    dev = target.device
    denom = torch.clamp(n_clips - 1, min=1).to(torch.float32)
    steps = torch.arange(t, device=dev)
    clip_range = steps.to(torch.float32)[None] / denom[:, None]    # (B, T)
    clip_valid = steps[None] < n_clips[:, None]
    bins = _bin_edges(num_bins, dev)
    target_ct = target.mean(-1)                                   # (B, Q)
    offset = target_ct[..., None] - bins
    bin_ids = torch.clamp((offset > 0).sum(-1) - 1, 0, num_bins - 1)

    left = clip_range[:, None, :] - target[..., 0, None]          # (B, Q, T)
    right = target[..., 1, None] - clip_range[:, None, :]
    inside = (left > 0) & (right > 0) & clip_valid[:, None, :]
    ratio = torch.where(inside, torch.minimum(left, right) / torch.clamp(
        torch.maximum(left, right), min=1e-12), 0.0)
    gt_ctness = torch.sqrt(torch.clamp(ratio, min=0.0))
    gt_scores = inside.to(torch.float32)
    return torch.stack([left, right], -1), gt_ctness, gt_scores, bin_ids


def _bce_logits(logits, target):
    return torch.clamp(logits, min=0) - logits * target + \
        torch.log1p(torch.exp(-logits.abs()))


def grounding_loss(outputs, neg_outputs, labels, group_rep, is_rep,
                   query_mask, clip_mask, cfg: GroundingConfig, mesh=None):
    """Loss over one padded batch (``grounding_loss`` of the JAX package).

    Args:
      outputs: (regrs, conf, cls) of the positive query slots, one slot per
        (possibly duplicated) GT predicate; duplicates carry the same
        network outputs as their group representative.
      neg_outputs: the same for the sampled negative-predicate queries
        (read on representative slots only).
      labels: (gt_regrs (B,Q,T,2), gt_ctness, gt_scores, bin_ids) per slot.
      group_rep: (B, Q) index of each slot's dedup-group representative.
      is_rep: (B, Q) bool, True on group representatives.
      query_mask: (B, Q); clip_mask: (B, T).
      mesh: the counts are summed over its data ranks (global means).

    Returns (total, {pos_cls, neg_cls, pos_ct, neg_ct, regr}).
    """
    regrs, conf, cls = outputs                 # (B,Q,T,2,K), (B,Q,T,K)
    _, n_conf, n_cls = neg_outputs
    gt_regrs, gt_ctness, gt_scores, bin_ids = labels
    k = cfg.num_bins
    b, qn, t = conf.shape[:3]
    group_rep, bin_ids = group_rep.long(), bin_ids.long()

    def take_rep(x):
        idx = group_rep.reshape(b, qn, *([1] * (x.dim() - 2)))
        return torch.gather(x, 1, idx.expand(b, qn, *x.shape[2:]))

    def take_bin(x):
        idx = bin_ids.reshape(b, qn, *([1] * (x.dim() - 2)))
        return torch.gather(x, -1, idx.expand(*x.shape[:-1], 1))[..., 0]

    # positives: slot q reads its representative's outputs at its bin
    pos_conf = take_bin(take_rep(conf))                          # (B, Q, T)
    pos_cls = take_bin(take_rep(cls))
    pos_regr = take_bin(take_rep(regrs))                         # (B,Q,T,2)

    valid_qc = query_mask[:, :, None] & clip_mask[:, None, :]    # (B, Q, T)
    wq = valid_qc.to(torch.float32)
    n_pos = torch.clamp(data_sum(wq.sum(), mesh), min=1.0)
    pos_cls_loss = (_bce_logits(pos_cls, gt_scores) * wq).sum() / n_pos

    ct_mask = (gt_ctness > 0) & valid_qc
    wct = ct_mask.to(torch.float32)
    n_ct = torch.clamp(data_sum(wct.sum(), mesh), min=1.0)
    pos_ct_loss = (_bce_logits(pos_conf, gt_ctness) * wct).sum() / n_ct
    reg_iou = tiou_left_right(pos_regr, torch.where(ct_mask[..., None],
                                                    gt_regrs, 1.0))
    reg_iou = torch.where(ct_mask, reg_iou, 1.0)
    regr_loss = (-torch.log(torch.clamp(reg_iou, min=0.0) + 1e-6) * wct
                 ).sum() / n_ct

    # negatives: (a) representative slots, bins outside the group's
    # positive-bin set (the OR over the group's members, kept on the
    # representative)
    bins_onehot = F.one_hot(bin_ids, k).bool() & query_mask[..., None]
    group_bins = torch.zeros((b, qn, k), dtype=torch.int32,
                             device=conf.device).scatter_reduce(
        1, group_rep[..., None].expand(b, qn, k), bins_onehot.to(torch.int32),
        reduce="amax").bool()
    neg_bins = ~group_bins & is_rep[..., None] & query_mask[..., None]
    w_nb = (neg_bins[:, :, None, :] & valid_qc[..., None]).to(torch.float32)
    # (b) negative-predicate queries (representative slots), all bins
    w_nq = (is_rep[:, :, None, None] & valid_qc[..., None]).to(
        torch.float32) * torch.ones((1, 1, 1, k), device=conf.device)
    n_neg = torch.clamp(data_sum(w_nb.sum() + w_nq.sum(), mesh), min=1.0)
    neg_cls_loss = ((_bce_logits(cls, 0.0) * w_nb).sum() +
                    (_bce_logits(n_cls, 0.0) * w_nq).sum()) / n_neg
    neg_ct_loss = ((_bce_logits(conf, 0.0) * w_nb).sum() +
                   (_bce_logits(n_conf, 0.0) * w_nq).sum()) / n_neg

    loss_dict = {
        "pos_cls": cfg.loss_cls * pos_cls_loss,
        "neg_cls": cfg.loss_cls * neg_cls_loss,
        "pos_ct": cfg.loss_ctn * pos_ct_loss,
        "neg_ct": cfg.loss_ctn * neg_ct_loss,
        "regr": cfg.loss_reg * regr_loss,
    }
    return sum(loss_dict.values()), loss_dict


# ---------------------------------------------------------------------------
# test-time multi-bin decoding (reference grd_model_v5.py:530-576, 667-737),
# batched over videos
# ---------------------------------------------------------------------------

def temporal_pooling(regrs, scores, n_clips, clip_mask, score_th: float,
                     tiou_th: float):
    """Pool per-clip FCOS spans into one span per (query, bin).

    regrs (B, Q, T, 2, K); scores (B, Q, T, K); n_clips (B,); clip_mask
    (B, T).  Returns (B, Q, K, 2).  Only the top-scoring clip's gIoU row is
    needed, not the full T x T matrix.
    """
    t = regrs.shape[2]
    denom = torch.clamp(n_clips - 1, min=1).to(torch.float32)
    clip_range = torch.arange(t, device=regrs.device) / denom[:, None]
    start = clip_range[:, None, :, None] - regrs[:, :, :, 0, :]  # (B,Q,T,K)
    end = clip_range[:, None, :, None] + regrs[:, :, :, 1, :]
    cm = clip_mask[:, None, :, None]
    s = scores.masked_fill(~cm, -math.inf)
    top, top_id = s.amax(dim=2), s.argmax(dim=2)                # (B,Q,K)
    mask1 = s > score_th * top[:, :, None, :]
    b0 = torch.gather(start, 2, top_id[:, :, None, :])           # (B,Q,1,K)
    b1 = torch.gather(end, 2, top_id[:, :, None, :])
    g = (torch.minimum(end, b1) - torch.maximum(start, b0)) / (
        torch.maximum(end, b1) - torch.minimum(start, b0))
    m = mask1 & (g > tiou_th) & cm
    pooled_s = start.masked_fill(~m, math.inf).amin(dim=2)
    pooled_e = end.masked_fill(~m, -math.inf).amax(dim=2)
    # the top clip is always in its own mask, so neither stays infinite
    return torch.stack([pooled_s, pooled_e], dim=-1)


def temporal_nms(spans, probs, nms_th: float):
    """Per-query greedy 1-D NMS over the K+1 bins (reference
    grd_model_v5.py:667-695).  spans (..., K1, 2); probs (..., K1).
    Returns the kept mask (..., K1)."""
    k1 = probs.shape[-1]
    pair = tiou(spans, spans)                                    # (...,K1,K1)
    alive = torch.ones_like(probs, dtype=torch.bool)
    kept = torch.zeros_like(alive)
    for _ in range(k1):
        best = probs.masked_fill(~alive, -math.inf).argmax(dim=-1)
        onehot = F.one_hot(best, k1).bool() & alive.any(-1, keepdim=True)
        kept |= onehot
        row = torch.gather(pair, -2, best[..., None, None].expand(
            *best.shape, 1, k1))[..., 0, :]
        alive = alive & ~onehot & (row < nms_th)
    return kept


def grounding_decode(regrs, conf_logits, cls_logits, inter_dura, n_clips,
                     clip_mask, query_mask, *, score_th=0.5, tiou_th=0.5,
                     bins_th=0.1, nms_th=0.5):
    """Test-time decoding of a batch of videos (reference
    grd_model_v5.py:530-576).

    inter_dura (B, Q, 2) normalized subject∩object spans.  Returns pooled
    spans (B, Q, K+1, 2), bins_probs (B, Q, K+1), bins_mask (B, Q, K+1).
    """
    k = conf_logits.shape[-1]
    scores = torch.sigmoid(conf_logits) * torch.sigmoid(cls_logits)
    scores = scores.masked_fill(~clip_mask[:, None, :, None], 0.0)
    bins_probs = scores.amax(dim=2)                              # (B,Q,K)
    bins_probs = torch.cat([bins_probs, torch.ones_like(bins_probs[..., :1])],
                           dim=-1)                               # (B,Q,K+1)
    bins_mask = bins_probs > bins_th

    pooled = temporal_pooling(regrs, scores, n_clips, clip_mask, score_th,
                              tiou_th)                           # (B,Q,K,2)
    # clamp each span to the subject∩object window; spans that miss it fall
    # back to the window itself
    s = torch.maximum(pooled[..., 0], inter_dura[..., None, 0])
    e = torch.minimum(pooled[..., 1], inter_dura[..., None, 1])
    overlap = s <= e
    window = inter_dura[..., None, :].expand_as(pooled)
    pooled = torch.where(overlap[..., None], torch.stack([s, e], -1), window)
    overlap = torch.cat([overlap, torch.ones_like(overlap[..., :1])], dim=-1)
    pooled = torch.cat([pooled, inter_dura[..., None, :]], dim=-2)

    bins_mask = bins_mask & overlap & temporal_nms(pooled, bins_probs, nms_th)
    # every query keeps at least its best bin
    none_kept = ~bins_mask.any(-1, keepdim=True)
    best = F.one_hot(bins_probs.argmax(dim=-1), k + 1).bool()
    bins_mask = bins_mask | (best & none_kept)
    # "grounding corrects classification": if every regression bin is weak,
    # the fallback subject∩object bin scores 0 (reference :568-573)
    weak = bins_probs[..., :-1].amax(dim=-1) <= bins_th
    bins_probs = torch.cat([bins_probs[..., :-1], bins_probs[..., -1:]
                            .masked_fill(weak[..., None], 0.0)], dim=-1)
    bins_mask = bins_mask & query_mask[..., None]
    return pooled, bins_probs, bins_mask
