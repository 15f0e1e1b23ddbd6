"""Shared transformer building blocks, batched and masked.

Port of the JAX package's ``models/layers.py`` with the reference torch
parameter names and layouts (reference models/model_0v10.py:70-225):
``nn.Sequential`` MLPs indexed 0, 2, ...; a packed ``in_proj_weight``
(3D, D) and ``out_proj`` per attention; LayerNorm ``weight``/``bias`` with
flax's epsilon of 1e-6.  Every layer takes a (B, ...) batch with validity
masks, so a whole bucket of videos is one call.  In train mode every
dropout (JAX ``models/layers.py:142, 164-172, 239``) draws from the
``generator`` handed to the forward, never from torch's global stream, so a
step's randomness is a function of that generator alone.  An int8 input
to an :class:`MLP` (int8 feature storage) runs its first layer as an int8
product with int32 accumulation (JAX ``Int8Dense``, ``models/layers.py:
53-79``) and the later layers in bfloat16.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import dropout
from ..ops.role_attn import role_attention, role_attention_plain

LN_EPS = 1e-6      # flax nn.LayerNorm's default (torch's is 1e-5)
_LOW = (torch.bfloat16, torch.float16)


def _linear(layer: nn.Linear, x):
    """``layer(x)``; a bf16/fp16 input runs with the weights cast to its
    dtype and keeps it (flax ``nn.Dense(dtype=x.dtype)``)."""
    if x.dtype in _LOW:
        bias = None if layer.bias is None else layer.bias.to(x.dtype)
        return F.linear(x, layer.weight.to(x.dtype), bias)
    return layer(x)


def sine_pos_embedding(length: int, d_model: int) -> np.ndarray:
    """Sinusoidal positional embedding (reference models/model_0v10.py:
    228-237; the grounding QANet's clip positions use the same table),
    (length, d_model) float32."""
    i = np.arange(d_model)
    freqs = np.where(i % 2 == 0, 10000.0 ** (-i / d_model),
                     -(10000.0 ** ((1 - i) / d_model)))
    phases = np.where(i % 2 == 0, 0.0, np.pi / 2)
    pos = np.arange(length)[:, None].astype(np.float64)
    return np.sin(pos * freqs[None, :] + phases[None, :]).astype(np.float32)


def check_int_mm_shape(m: int, k: int, n: int) -> None:
    """``torch._int_mm``'s shape rules on CUDA: more than 16 rows, K and
    N positive multiples of 8.  Raises naming the product's shape."""
    if m <= 16 or k <= 0 or k % 8 or n <= 0 or n % 8:
        raise ValueError(
            f"int8 product ({m} x {k}) @ ({k} x {n}): torch._int_mm on CUDA "
            "needs more than 16 rows and K, N positive multiples of 8")


def quantize_weight(weight):
    """Per-output quantization of an ``nn.Linear`` weight (out, in), as
    JAX ``Int8Dense`` quantizes its (in, out) kernel per column: ``sw =
    max|W| / 127`` (out,), differentiable, and ``kq = round(W / sw)`` int8
    (out, in), which carries no gradient (JAX's int8 cast has none)."""
    absmax = weight.abs().amax(dim=1)
    # a tensor divisor: CUDA turns division by a Python scalar into a
    # product with its reciprocal, which rounds differently from JAX's
    # division (and the CPU's)
    sw = absmax / torch.full_like(absmax, 127.0)
    with torch.no_grad():
        kq = torch.round(weight / sw[:, None]).to(torch.int8)
    return sw, kq


def int8_accumulate(x, kq):
    """``x`` (..., K) int8 @ ``kq.T`` (K, N) with int32 accumulation
    (``torch._int_mm`` on the card and on the CPU): (..., N) int32."""
    x2 = x.reshape(-1, x.shape[-1])
    if x2.is_cuda:
        check_int_mm_shape(x2.shape[0], x2.shape[1], kq.shape[0])
    # kq.t() is K-major (column-major (K, N)), the layout cuBLASLt's int8
    # product takes
    acc = torch._int_mm(x2, kq.t())
    return acc.reshape(*x.shape[:-1], kq.shape[0])


def int8_linear(layer: nn.Linear, x, input_scale):
    """JAX ``Int8Dense``: ``y = acc * (input_scale * sw) + bias`` in
    float32 over the int32 accumulator, returned in bfloat16 as JAX does.
    ``input_scale`` broadcasts against ``x`` without its last axis."""
    if x.dtype != torch.int8:
        raise TypeError(f"int8_linear takes int8 input, not {x.dtype}")
    sw, kq = quantize_weight(layer.weight)
    acc = int8_accumulate(x, kq)
    y = acc.to(torch.float32) * (input_scale * sw) + layer.bias
    return y.to(torch.bfloat16)


class MLP(nn.Sequential):
    """Linear->ReLU stacks (fc_feat2enti etc.), indexed as the reference's
    ``nn.Sequential``: Linear at 0, 2, ...; ReLU after each but the last
    unless ``final_relu``.  A low-precision input runs in its dtype; an int8
    input takes :func:`int8_linear` at the first layer (``input_scale`` its
    dequantization scale) and bfloat16 after it (JAX ``MLP`` :99-106)."""

    def __init__(self, in_dim: int, features, final_relu: bool = True):
        mods, d = [], in_dim
        for k, f in enumerate(features):
            mods.append(nn.Linear(d, f))
            if k < len(features) - 1 or final_relu:
                mods.append(nn.ReLU())
            d = f
        super().__init__(*mods)

    def forward(self, x, input_scale=None):
        for i, m in enumerate(self):
            if i == 0 and x.dtype == torch.int8:
                if input_scale is None:
                    raise ValueError("an int8 MLP input needs its scale")
                x = int8_linear(m, x, input_scale)
            else:
                x = _linear(m, x) if isinstance(m, nn.Linear) else m(x)
        return x


class Dropout(nn.Module):
    """flax ``nn.Dropout`` as a module (:func:`ops.attention.dropout`): the
    mask comes from the ``generator`` given to ``forward``; the identity in
    eval mode."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p

    def forward(self, x, generator=None):
        return dropout(x, self.p, generator, self.training)

    def extra_repr(self):
        return f"p={self.p}"


class MultiHeadAttention(nn.Module):
    """Multi-head attention with key-padding masking, written out by hand.

    Same parameters as ``torch.nn.MultiheadAttention`` (packed in_proj +
    out_proj) but the JAX package's masking: masked keys get the float32
    minimum and their weights are zeroed after the softmax, so a row with
    no valid key gives zeros, not NaN.
    """

    def __init__(self, dim: int, num_heads: int, dropout: float = 0.1):
        super().__init__()
        self.dim, self.num_heads, self.dropout = dim, num_heads, dropout
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, q, k, v, key_mask=None, generator=None):
        # q: (B, Lq, D); k, v: (B, Lk, D); key_mask: (B, Lk) bool (True=valid)
        h, d = self.num_heads, self.dim
        hd = d // h
        w, b = self.in_proj_weight, self.in_proj_bias

        def heads(x, i):
            y = F.linear(x, w[i * d:(i + 1) * d], b[i * d:(i + 1) * d])
            return y.reshape(*x.shape[:-1], h, hd)

        qh, kh, vh = heads(q, 0), heads(k, 1), heads(v, 2)
        logits = torch.einsum("bqhd,bkhd->bhqk", qh, kh) / math.sqrt(hd)
        if key_mask is not None:
            valid = key_mask[:, None, None, :]
            logits = logits.masked_fill(~valid, torch.finfo(logits.dtype).min)
        attn = torch.softmax(logits, dim=-1)
        if key_mask is not None:
            attn = attn.masked_fill(~valid, 0.0)
        attn = dropout(attn, self.dropout, generator, self.training)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, vh)
        return self.out_proj(out.reshape(*out.shape[:-2], d))


class TransformerEncoderLayer(nn.Module):
    """Post-norm encoder layer (reference models/model_0v10.py:70-139)."""

    def __init__(self, dim: int, num_heads: int, dim_ffn: int,
                 dropout: float = 0.1):
        super().__init__()
        self.self_attn = MultiHeadAttention(dim, num_heads, dropout)
        self.linear1 = nn.Linear(dim, dim_ffn)
        self.linear2 = nn.Linear(dim_ffn, dim)
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.dropout = dropout

    def forward(self, src, key_mask=None, pos=None, generator=None):
        drop = lambda x: dropout(x, self.dropout, generator, self.training)
        qk = src if pos is None else src + pos
        src = self.norm1(src + drop(self.self_attn(qk, qk, src, key_mask,
                                                   generator)))
        src2 = self.linear2(drop(F.relu(self.linear1(src))))
        return self.norm2(src + drop(src2))


class RoleAttnDecoderLayer(nn.Module):
    """Role-factored cross-attention decoder (reference model_0v10.py:142-225).

    Produces the soft bipartite adjacency ``att`` (B, 2, Q, N): a product of
    a softmax over entities (masked to valid trajectories) and a softmax over
    the two roles.  In eval mode the role attention goes through
    :func:`role_attention` (the CUDA kernel on the card, always, at every
    batch size); in train mode through the plain version, since the kernel
    is forward-only.
    """

    def __init__(self, dim_pred: int, num_heads: int, dim_enti: int,
                 dim_att: int, dim_ffn: int, dropout: float = 0.1):
        super().__init__()
        self.dim_enti, self.dim_att = dim_enti, dim_att
        self.self_attn = MultiHeadAttention(dim_pred, num_heads, dropout)
        self.norm1 = nn.LayerNorm(dim_pred, eps=LN_EPS)
        self.fc_enti2att = nn.Linear(dim_enti, dim_att)
        self.fc_pred2att = nn.Linear(dim_pred, dim_att)
        # role r reads the r-th half of the att projections
        self.fc_rolewise = nn.ModuleList(
            MLP(dim_enti, (dim_pred, dim_pred), final_relu=False)
            for _ in range(2))
        self.norm2 = nn.LayerNorm(dim_pred, eps=LN_EPS)
        # the reference's Sequential (Linear, ReLU, Dropout, Linear): its
        # parameters stay fc2.0 and fc2.3
        self.fc2 = nn.Sequential(nn.Linear(dim_pred, dim_ffn), nn.ReLU(),
                                 Dropout(dropout),
                                 nn.Linear(dim_ffn, dim_pred))
        self.norm3 = nn.LayerNorm(dim_pred, eps=LN_EPS)

    def forward(self, pred_query, pos_emb, enco_output, traj_mask,
                generator=None):
        # pred_query: (B, Q, Dp); pos_emb: (Q, Dp); enco_output: (B, N, De)
        qk = pred_query + pos_emb[None]
        pq2 = self.self_attn(qk, qk, pred_query, generator=generator)
        pred_query = self.norm1(pred_query + pq2)

        pred_query = pred_query + pos_emb[None]
        enti2att = self.fc_enti2att(enco_output)             # (B, N, Da)
        pred2att = self.fc_pred2att(pred_query)              # (B, Q, Da)
        # role r reads the r-th half: views (B, 2, *, half), no copy
        half = self.dim_att // 2
        e = enti2att.unflatten(-1, (2, half)).transpose(1, 2)
        p = pred2att.unflatten(-1, (2, half)).transpose(1, 2)
        fn = role_attention_plain if self.training else role_attention
        att, values = fn(p, e, enco_output, traj_mask, self.dim_enti)
        role_q = (self.fc_rolewise[0](values[:, 0])
                  + self.fc_rolewise[1](values[:, 1]))
        pred_query = self.norm2(pred_query + role_q)
        lin1, relu, drop, lin2 = self.fc2
        ffn = lin2(drop(relu(lin1(pred_query)), generator))
        pred_query = self.norm3(pred_query + ffn)
        return pred_query, att
