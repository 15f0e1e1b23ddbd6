"""Plain lowerings of the grounding QANet's masked multi-head attention.

Port of the JAX package's ``ops/attention.py``:

* :func:`composed_qkvo` folds the per-head projections into d-width
  composites (W_q W_k^T, W_v W_o), the operands of the composed attention
  (``ops/composed_attn.py``);
* :func:`chunked_attention` is exact masked softmax attention over the batch
  axis in chunks of rows; with one chunk it is the layer's direct path
  (train mode included: its dropout draws from an explicit generator);
* :func:`attn_chunked_stored` is the training path of the chunked lowering
  (``attn_chunked_stored`` of the JAX package): each chunk's softmax output
  is stored in the value dtype with its bit-packed dropout keep-mask, so the
  backward recomputes nothing.  Its keep-mask is drawn at the 16-bit
  realized rate :func:`drop_rate_eff`, as the JAX path's.

Every random draw goes through :func:`draw_share`: a step sharded over
ranks (``parallel/``) hands its layers a :class:`ShardedDraws` in place of
the generator, and each draw is made at the global batch's shape and cut
to this rank's rows (and, in a tensor-parallel layer, to its features), so
a sharded step draws the bits of the single-process step.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch


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


def device_generator(generator, device):
    """A generator on ``device`` whose stream is a function of
    ``generator``'s: the CPU generator itself, or a fresh device generator
    seeded with one draw from it.  ``None`` stays ``None`` (the device's
    default generator)."""
    device = torch.device(device)
    if generator is None or generator.device.type == device.type:
        return generator
    seed = int(torch.randint(0, 2 ** 62, (), generator=generator))
    return torch.Generator(device=device).manual_seed(seed)


@dataclasses.dataclass(frozen=True)
class ShardedDraws:
    """A step's generator and this rank's share of every draw from it:
    ``rows`` = (index, count) of the leading (batch-major) axis, split in
    ``count`` equal parts, and ``features`` = (index, count) of the axis a
    tensor-parallel layer shards (its heads or hidden features)."""
    generator: Optional[torch.Generator]
    rows: tuple = (0, 1)
    features: tuple = (0, 1)


def base_generator(generator):
    """The torch generator behind ``generator`` (a :class:`ShardedDraws`
    or a generator or None)."""
    return generator.generator if isinstance(generator, ShardedDraws) \
        else generator


def row_share(generator) -> tuple:
    """(index, count) of this rank's rows: (0, 1) unless sharded."""
    return generator.rows if isinstance(generator, ShardedDraws) else (0, 1)


def draw_share(generator, shape, make, feature_dim: Optional[int] = None):
    """``make(shape, torch generator)`` made at the global shape and cut to
    this rank's share.  ``shape`` is the rank's; its leading axis is a
    ``rows`` share of the global one and, where ``feature_dim`` is given,
    that axis a ``features`` share.  Unsharded, ``make`` runs at ``shape``
    itself, so the draw is the single-process draw."""
    g = base_generator(generator)
    if not isinstance(generator, ShardedDraws):
        return make(tuple(shape), g)
    (ri, rn), (fi, fn) = generator.rows, generator.features
    cuts = [(0, ri, rn)]
    if feature_dim is not None and fn > 1:
        cuts.append((feature_dim % len(shape), fi, fn))
    full = list(shape)
    for dim, _, n in cuts:
        full[dim] *= n
    out = make(tuple(full), g)
    for dim, i, _ in cuts:
        out = out.narrow(dim, i * shape[dim], shape[dim])
    return out


def dropout_mask(shape, p: float, generator, device,
                 feature_dim: Optional[int] = None):
    """Bernoulli(1 - p) keep-mask (flax ``nn.Dropout``'s), drawn from
    ``generator`` (see :func:`device_generator`, :func:`draw_share`)."""
    return draw_share(generator, shape, lambda s, g: torch.rand(
        s, generator=device_generator(g, device), device=device) >= p,
        feature_dim)


def dropout(x, p: float, generator=None, training: bool = True,
            feature_dim: Optional[int] = None):
    """flax ``nn.Dropout``: keep with probability 1 - p and rescale kept
    values by 1 / (1 - p) in x's dtype; the identity in eval mode or at
    p = 0.  Unlike ``F.dropout`` the mask comes from ``generator``;
    ``feature_dim`` names the axis a tensor-parallel layer shards."""
    if not training or p <= 0.0:
        return x
    keep = dropout_mask(x.shape, p, generator, x.device, feature_dim)
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def chunked_attention(q, k, v, mask, *, chunk: int, dropout: float = 0.0,
                      generator=None):
    """Exact masked attention, (B, T, h, hd) -> (B, T, h, hd).

    ``mask`` (B, T) marks valid keys.  Logits are float32 (after the
    product in the inputs' dtype, as the JAX einsum); masked keys take the
    float32 minimum and are zeroed after the softmax, so a row with no valid
    key attends to nothing.  The batch axis goes ``chunk`` rows at a time,
    bounding the (chunk, h, T, T) logits; ``dropout`` > 0 drops attention
    weights with a mask from ``generator`` (train mode's direct path).
    """
    b, t, h, hd = q.shape
    outs = []
    for s in range(0, b, chunk):
        sl = slice(s, s + chunk)
        logits = torch.einsum("bqhd,bkhd->bhqk", q[sl], k[sl]).float() / \
            math.sqrt(hd)
        valid = mask[sl, None, None, :]
        logits = logits.masked_fill(~valid, torch.finfo(torch.float32).min)
        att = torch.softmax(logits, dim=-1).masked_fill(~valid, 0.0)
        if dropout > 0.0:
            keep = dropout_mask(att.shape, dropout, generator, att.device)
            att = torch.where(keep, att / (1.0 - dropout), 0.0)
        outs.append(torch.einsum("bhqk,bkhd->bqhd", att.to(v.dtype), v[sl]))
    return outs[0] if len(outs) == 1 else torch.cat(outs)


# --------------------------------------------------------------------------
# chunked attention with a stored softmax (training path)
# --------------------------------------------------------------------------

def drop_rate_eff(dropout: float) -> float:
    """The dropout rate the 16-bit keep-mask realizes: ``round(dropout *
    2**16) / 2**16`` (0.1 becomes 0.100006...); threshold and rescale both
    use it, so the dropout stays unbiased at the quantized rate."""
    return round(dropout * 65536.0) / 65536.0


def keep_mask16(shape, dropout: float, generator, device):
    """Bernoulli(1 - drop_rate_eff(dropout)) keep-mask from 16-bit draws of
    ``generator`` (the JAX path draws 16-bit halves of the TPU's hardware
    RNG words at the same threshold)."""
    thr = round(dropout * 65536.0)
    return draw_share(generator, shape, lambda s, g: torch.randint(
        0, 1 << 16, s, generator=device_generator(g, device), device=device,
        dtype=torch.int32) >= thr)


_BIT_WEIGHTS = [1 << i for i in range(8)]


def _pack_bits(keep):
    """(..., k) bool -> (..., ceil(k/8)) uint8, bit i of byte j = element
    8j + i (an eighth of a byte per element)."""
    *lead, k = keep.shape
    if k % 8:
        keep = torch.nn.functional.pad(keep, (0, 8 - k % 8))
        k += 8 - k % 8
    w = torch.tensor(_BIT_WEIGHTS, dtype=torch.uint8, device=keep.device)
    g = keep.reshape(*lead, k // 8, 8).to(torch.uint8)
    return (g * w).sum(-1, dtype=torch.uint8)


def _unpack_bits(packed, k: int):
    """Inverse of :func:`_pack_bits`."""
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    return bits.to(torch.bool).reshape(*packed.shape[:-1], -1)[..., :k]


class _BlockStored(torch.autograd.Function):
    """One chunk of :func:`attn_chunked_stored` (``_blk_stored`` of the JAX
    package): the forward stores the pre-dropout softmax in the value dtype
    and the bit-packed keep-mask; the backward recomputes nothing."""

    @staticmethod
    def forward(ctx, qc, kc, vc, mc, dropout, keep):
        hd = qc.shape[-1]
        lg = torch.einsum("bqhd,bkhd->bhqk", qc, kc).float() / math.sqrt(hd)
        valid = mc[:, None, None, :]
        lg = lg.masked_fill(~valid, torch.finfo(torch.float32).min)
        at = torch.softmax(lg, dim=-1).masked_fill(~valid, 0.0).to(vc.dtype)
        at_d, packed = at, None
        if dropout > 0.0:
            p = drop_rate_eff(dropout)
            at_d = torch.where(keep, at / (1.0 - p), torch.zeros_like(at))
            packed = _pack_bits(keep)
        ctx.save_for_backward(qc, kc, vc, mc, at, packed)
        ctx.dropout = dropout
        return torch.einsum("bhqk,bkhd->bqhd", at_d, vc)

    @staticmethod
    def backward(ctx, do):
        qc, kc, vc, mc, at, packed = ctx.saved_tensors
        hd = qc.shape[-1]
        zero = torch.zeros((), dtype=at.dtype, device=at.device)
        if ctx.dropout > 0.0:
            p = drop_rate_eff(ctx.dropout)
            keep = _unpack_bits(packed, at.shape[-1])
            at_d = torch.where(keep, at / (1.0 - p), zero)
        else:
            at_d = at
        do = do.to(vc.dtype)
        dv = torch.einsum("bhqk,bqhd->bkhd", at_d, do)
        dat = torch.einsum("bqhd,bkhd->bhqk", do, vc)
        if ctx.dropout > 0.0:
            dat = torch.where(keep, dat / (1.0 - p), zero)
        a32, g = at.float(), dat.float()
        dlg = a32 * (g - (g * a32).sum(-1, keepdim=True)) / math.sqrt(hd)
        dlg = dlg.masked_fill(~mc[:, None, None, :], 0.0).to(qc.dtype)
        dq = torch.einsum("bhqk,bkhd->bqhd", dlg, kc)
        dk = torch.einsum("bhqk,bqhd->bkhd", dlg, qc)
        return dq, dk, dv, None, None, None


def attn_chunked_stored(q, k, v, mask, *, chunk: int, dropout: float = 0.0,
                        generator=None):
    """Chunked exact attention with a stored softmax, (B, T, h, hd) ->
    (B, T, h, hd): the same function as :func:`chunked_attention`, with a
    recompute-free backward; the keep-mask of ``dropout`` > 0 is drawn from
    ``generator`` at :func:`drop_rate_eff`, one draw per chunk in order.

    Under a :class:`ShardedDraws` generator ``chunk`` is a chunk of the
    global batch: every global chunk's mask is drawn in order, as the
    single process draws them, and this rank's rows of each are kept."""
    b, _, h, _ = q.shape
    t = k.shape[1]
    ri, rn = row_share(generator)
    total, lo = b * rn, b * ri
    if total % chunk:
        raise ValueError(f"attn_chunked_stored: chunk {chunk} does not "
                         f"divide the batch {total}")
    g = base_generator(generator)
    outs = []
    for s in range(0, total, chunk):
        a, z = max(s, lo), min(s + chunk, lo + b)
        keep = None
        if dropout > 0.0:
            keep = keep_mask16((chunk, h, t, t), dropout, g, q.device)
        if a >= z:
            continue
        rows = slice(a - lo, z - lo)
        if keep is not None:
            keep = keep[a - s:z - s]
        outs.append(_BlockStored.apply(q[rows], k[rows], v[rows], mask[rows],
                                       float(dropout), keep))
    return outs[0] if len(outs) == 1 else torch.cat(outs)
