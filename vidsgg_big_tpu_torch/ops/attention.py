"""Plain lowerings of the grounding QANet's masked multi-head attention.

Port of the JAX package's ``ops/attention.py``, forward only:

* :func:`composed_qkvo` folds the per-head projections into d-width
  composites (W_q W_k^T, W_v W_o), the operands of the composed attention
  (``ops/composed_attn.py``);
* :func:`chunked_attention` is exact masked softmax attention over the batch
  axis in chunks of rows, the counterpart of ``attn_chunked_stored`` (its
  stored-softmax VJP belongs to grounding training, a later slice).  With
  one chunk it is the layer's direct path.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def composed_qkvo(wq, bq, wk, wv, wo, bv, bo):
    """Fold per-head projections into d-width composites.

    Args: wq/wk/wv (d, h, hd); bq/bv (h, hd); wo (h, hd, d); bo (d,).
    Returns (wqk (h, d, d), wb (h, d), wvo (h, d, d), cb (d,)).  b_k drops
    out: its logit terms are constant along each softmax row; A's row sums
    of 1 absorb b_v into the constant output bias cb.
    """
    wqk = torch.einsum("chd,ehd->hce", wq, wk)
    wb = torch.einsum("hd,ehd->he", bq, wk)
    wvo = torch.einsum("chd,hde->hce", wv, wo)
    cb = torch.einsum("hd,hde->e", bv, wo) + bo
    return wqk, wb, wvo, cb


def chunked_attention(q, k, v, mask, *, chunk: int, dropout: float = 0.0):
    """Exact masked attention, (B, T, h, hd) -> (B, T, h, hd).

    ``mask`` (B, T) marks valid keys.  Logits are float32 (after the
    product in the inputs' dtype, as the JAX einsum); masked keys take the
    float32 minimum and are zeroed after the softmax, so a row with no valid
    key attends to nothing.  The batch axis goes ``chunk`` rows at a time,
    bounding the (chunk, h, T, T) logits; ``dropout`` > 0 drops attention
    weights (train mode).
    """
    b, t, h, hd = q.shape
    out = torch.empty_like(q)
    for s in range(0, b, chunk):
        sl = slice(s, s + chunk)
        logits = torch.einsum("bqhd,bkhd->bhqk", q[sl], k[sl]).float() / \
            math.sqrt(hd)
        valid = mask[sl, None, None, :]
        logits = logits.masked_fill(~valid, torch.finfo(torch.float32).min)
        att = torch.softmax(logits, dim=-1).masked_fill(~valid, 0.0)
        att = F.dropout(att, dropout, training=dropout > 0.0)
        out[sl] = torch.einsum("bhqk,bkhd->bqhd", att.to(v.dtype), v[sl])
    return out
