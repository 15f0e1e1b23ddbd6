"""Multi-bin temporal grounding model (stage 2 of BIG), for the card.

Port of the JAX package's ``models/grounding.py`` (reference class ``DEBUG``,
models/grd_model_v5.py:140-737): QANet-style encoders over the clips and the
query words, video/query similarity fusion, a combined QANet encoder over
every (query, clip) pair, and three per-bin conv heads; then the test-time
decode.  Queries of one video are padded to a fixed Q and clips to a fixed
T; clip validity rides through attention, pooling and the decode.  The
modules keep the reference parameter names, so a reference ``state_dict``
loads with ``strict=True``.  Inference only: the loss and the training-time
label geometry come with grounding training.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import chunked_attention, composed_qkvo
from ..ops.composed_attn import fused_composed_attention
from ..ops.temporal import tiou
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
    # compute dtype of the conv/attention stacks; params stay float32,
    # layernorms and softmaxes compute in float32
    compute_dtype: str = "float32"
    attn_dropout: float = 0.1
    attn_bytes_budget: int = 1 << 30
    fused_attention: bool = True

    @classmethod
    def from_dict(cls, d: dict):
        """Build from a reference-style ``model_config`` dict.  The JAX
        package's ``fused_interpret`` (Pallas interpret mode) is accepted and
        ignored; the loss factors wait for grounding training."""
        return cls(dim_feat=d["dim_feat"], dim_clsme=d["dim_clsme"],
                   dim_hidden=d["dim_hidden"], num_bins=d["num_bins"],
                   num_pred_cats=d.get("num_pred_cats", 51),
                   num_enti_cats=d.get("num_enti_cats", 81),
                   compute_dtype=d.get("compute_dtype", "float32"),
                   attn_dropout=d.get("attn_dropout", 0.1),
                   attn_bytes_budget=d.get("attn_bytes_budget", 1 << 30),
                   fused_attention=d.get("fused_attention", True))


def attention_lowering(b: int, t: int, d: int, budget: int,
                       composed: bool = True):
    """Which lowering the QANet attention takes for a (b, t, d) input, as
    ``models/grounding.py:299-331`` of the JAX package: ``("direct", b)``
    while the (b, 8, t, t) float32 logits fit ``budget``; past it the batch
    halves into chunks and, when the halving got below b, ``("composed",
    chunk)`` for 128-aligned t and d (the kernel on the card) or
    ``("chunked", chunk)``.  ``composed=False`` (train mode, or the fused
    path switched off) never picks the composed path."""
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
    grd_model_v5.py:36-56), (B, T, C_in) -> (B, T, C_out).

    float32 runs the two convs as they are; bfloat16 composes them into one
    dense (C_out, C_in, k) conv first (W[o, c, k] = pw[o, c] dw[c, k], the
    bias folded), as the JAX package does in bf16.  Either way the weights
    are float32 and are cast to the compute dtype after composing.
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int):
        super().__init__()
        self.kernel_size = kernel_size
        self.depth_wise = nn.Conv1d(in_channels, in_channels, kernel_size,
                                    padding=kernel_size // 2,
                                    groups=in_channels)
        self.point_wise = nn.Conv1d(in_channels, out_channels, 1)

    def forward(self, x):
        cdt = x.dtype
        xc = x.transpose(1, 2)                               # (B, C, T)
        dw, pw = self.depth_wise, self.point_wise
        pad = self.kernel_size // 2
        if cdt == torch.bfloat16:
            full = pw.weight * dw.weight[:, 0, :][None]      # (O, C, k)
            bias = pw.weight[:, :, 0] @ dw.bias + pw.bias
            y = F.conv1d(xc, full.to(cdt), bias.to(cdt), padding=pad)
        else:
            y = F.conv1d(xc, dw.weight.to(cdt), dw.bias.to(cdt), padding=pad,
                         groups=xc.shape[1])
            y = F.conv1d(y, pw.weight.to(cdt), pw.bias.to(cdt))
        return y.transpose(1, 2)


class QANetEncoderLayer(nn.Module):
    """QANet block: pos-enc -> convs(+res) -> self-attn(+res) -> fc(+res)
    (reference grd_model_v5.py:81-137), (B, T, D) -> (B, T, D).

    Padded clips are re-zeroed after every sublayer, so valid clips see a
    fixed zero boundary and outputs do not depend on the T bucket.  The
    attention picks its lowering with :func:`attention_lowering`: direct at
    small shapes; past ``attn_bytes_budget`` of logits, in eval mode with
    ``fused_attention`` (or ``flash_attention``, the JAX package's stock
    flash option, which computes the same function) at 128-aligned shapes,
    the composed attention (the CUDA kernel on the card, its plain version
    on the CPU), else the chunked plain path.  Train mode uses the direct or
    chunked path with dropout.
    """

    def __init__(self, d_model: int, num_conv: int, kernel_size: int,
                 dropout: float = 0.1, attn_dropout: float = 0.1,
                 attn_bytes_budget: int = 1 << 30,
                 fused_attention: bool = True, flash_attention: bool = False,
                 compute_dtype: str = "float32"):
        super().__init__()
        self.dropout, self.attn_dropout = dropout, attn_dropout
        self.attn_bytes_budget = attn_bytes_budget
        self.composed = fused_attention or flash_attention
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

    def forward(self, x, mask=None):
        cdt = self.compute_dtype
        x = x.to(cdt)
        t, d = x.shape[1], x.shape[2]
        drop = lambda o, p: F.dropout(o, p, self.training)
        ln = lambda norm, o: norm(o.float()).to(cdt)
        z = ((lambda o: o.masked_fill(~mask[..., None], 0.0))
             if mask is not None else (lambda o: o))
        pos = torch.from_numpy(sine_pos_embedding(t, d)).to(x.device, cdt)
        out = z(x + pos[None])
        res = out
        out = z(ln(self.normb, out))
        n = len(self.convs)
        for i, (conv, norm) in enumerate(zip(self.convs, self.norm_seq)):
            out = z(F.relu(conv(out)) + res)
            if (i + 1) % 2 == 0:
                out = drop(out, self.dropout * (i + 1) / n)
            res = out
            out = z(ln(norm, out))
        out = z(self._attention(out, mask) + res)
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

    def _attention(self, x, mask):
        b, t, d = x.shape
        cdt = x.dtype
        a = self.mh_attn
        hd = d // HEADS
        way, chunk = attention_lowering(
            b, t, d, self.attn_bytes_budget,
            composed=self.composed and not self.training)
        if way == "composed":
            comp = composed_qkvo(*self._head_weights())
            return fused_composed_attention(x, mask, *comp, hd=hd)
        if mask is None:
            mask = torch.ones((b, t), dtype=torch.bool, device=x.device)
        w, bias = a.in_proj_weight.to(cdt), a.in_proj_bias.to(cdt)
        q, k, v = (F.linear(x, w[i * d:(i + 1) * d], bias[i * d:(i + 1) * d]
                            ).reshape(b, t, HEADS, hd) for i in range(3))
        o = chunked_attention(q, k, v, mask, chunk=chunk, dropout=(
            self.attn_dropout if self.training else 0.0))
        return _linear(a.out_proj, o.reshape(b, t, d))


class ConvHead(nn.Sequential):
    """4 x (dw-sep conv + relu) + a final dw-sep conv (reference
    grd_model_v5.py:182-193; torch indices ``i.0`` and ``4``), padded clips
    re-zeroed between convs; the output is float32."""

    def __init__(self, d_model: int, out_channels: int, sigmoid: bool = False):
        super().__init__(*[nn.Sequential(
            DepthwiseSeparableConv(d_model, d_model, 3), nn.ReLU())
            for _ in range(4)],
            DepthwiseSeparableConv(d_model, out_channels, 3))
        self.sigmoid = sigmoid

    def forward(self, x, mask=None):
        z = ((lambda o: o.masked_fill(~mask[..., None], 0.0))
             if mask is not None else (lambda o: o))
        for block in list(self)[:-1]:
            x = z(block(x))
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
    float32.  ``generator`` seeds the initial weights.
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
        convs kaiming-normal, zero biases, N(0, 0.02) name tables."""
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

    def forward(self, video_feats, clip_mask, query_cats, temporal,
                query_mask=None):
        cfg = self.cfg
        cdt = getattr(torch, cfg.compute_dtype)
        b, t, _ = video_feats.shape
        q = query_cats.shape[1]
        hid = cfg.dim_hidden
        qc = query_cats.long()
        words_emb = torch.stack([self.EntiNameEmb[qc[..., 0]],
                                 self.PredNameEmb[qc[..., 1]],
                                 self.EntiNameEmb[qc[..., 2]]], dim=2)
        video = _linear(self.video_fc, video_feats.to(cdt))        # (B,T,H)
        words = _linear(self.query_fc, words_emb.to(cdt))          # (B,Q,3,H)
        temp = _linear(self.temp_fc, temporal.to(cdt))             # (B,Q,H)
        query = words + temp[:, :, None, :]

        video = self.video_encoder(video, mask=clip_mask)
        query = self.query_encoder(query.reshape(b * q, 3, hid)).reshape(
            b, q, 3, hid)

        # similarity fusion (reference grd_model_v5.py:331-368)
        vproj = _linear(self.proj2sim, video)                     # (B,T,H)
        sim = torch.einsum("bth,bqlh->bqtl", vproj, query).float()
        sim_r = torch.softmax(sim, dim=-1).to(cdt)               # over words
        cm = clip_mask[:, None, :, None]
        sim_c = torch.softmax(sim.masked_fill(
            ~cm, torch.finfo(torch.float32).min), dim=-2)        # over clips
        sim_c = sim_c.masked_fill(~cm, 0.0).to(cdt)
        mat_a = torch.einsum("bqtl,bqlh->bqth", sim_r, query)
        # sim_r (sim_c^T video) instead of (sim_r sim_c^T) video: the same
        # product through the small (Q, 3, H) contraction, no (Q, T, T)
        cv = torch.einsum("bqsl,bsh->bqlh", sim_c, video)
        mat_b = torch.einsum("bqtl,bqlh->bqth", sim_r, cv)
        vexp = video[:, None]
        combined = torch.cat([vexp.expand_as(mat_a), mat_a, mat_a * vexp,
                              mat_b * vexp], dim=-1)             # (B,Q,T,4H)
        combined = _linear(self.vq_fc, combined)
        flat_mask = clip_mask.repeat_interleave(q, dim=0)        # (BQ, T)
        flat = self.combined_encoder(combined.reshape(b * q, t, hid),
                                     mask=flat_mask)
        k = cfg.num_bins
        regrs = self.regr_head(flat, mask=flat_mask).reshape(b, q, t, 2, k)
        conf = self.conf_head(flat, mask=flat_mask).reshape(b, q, t, k)
        cls = self.cls_head(flat, mask=flat_mask).reshape(b, q, t, k)
        return regrs, conf, cls


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
