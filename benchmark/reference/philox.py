"""Philox4x32-10 in plain PyTorch: the keep-mask of the composed attention's
dropout, a pure function of (row seed, head, query, key).  A frozen copy of
the port's ``ops/philox.py`` (the kernels' own counter-based generator), so
that the reference draws the mask the kernels draw; the benchmark keeps it
as it stands here whatever the port later does.

For row seed ``s`` (one uint32 per row), head ``h``, query ``q`` and key
``k``::

    words = philox4x32_10(counter=(q >> 1, k >> 1, h, 0), key=(s, 0))
    bits  = words[2 * (q & 1) + (k & 1)]
    keep  = bits >= thr,    thr = round(p * 2**32)
"""
from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
PHILOX_M0, PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
PHILOX_W0, PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
ROUNDS = 10


def _mulhilo(m: int, c):
    """(hi, lo) 32-bit words of the 64-bit product of the constant ``m``
    and the int64 tensor ``c`` (values in [0, 2**32))."""
    mh, ml = m >> 16, m & 0xFFFF
    x = c * mh                       # < 2**48
    y = c * ml                       # < 2**48
    lo = ((x & 0xFFFF) << 16) + y
    hi = (x + (y >> 16)) >> 16
    return hi & MASK32, lo & MASK32


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Philox4x32 with 10 rounds (Random123's constants) on int64 tensors
    (or ints) holding uint32 values; returns the four output words."""
    c0, c1, c2, c3, k0, k1 = (torch.as_tensor(v).to(torch.int64)
                              for v in (c0, c1, c2, c3, k0, k1))
    for _ in range(ROUNDS):
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + PHILOX_W0) & MASK32
        k1 = (k1 + PHILOX_W1) & MASK32
    return c0, c1, c2, c3


def drop_threshold(dropout: float) -> tuple[int, float]:
    """(thr, rescale) of ``_drop_consts`` (pallas_attention.py:56-59):
    ``thr = round(p * 2**32)``, keep iff bits >= thr, rescale by
    ``1 / (1 - thr / 2**32)``, so the realized rate and the rescale agree."""
    thr = int(round(dropout * 4294967296.0))
    if not 0 <= thr < 1 << 32:
        raise ValueError(f"dropout {dropout} is outside [0, 1)")
    return thr, 1.0 / (1.0 - thr / 4294967296.0)


def attention_bits(seeds, heads: int, t_q: int, t_k: int):
    """The keep-mask words, (R, heads, t_q, t_k) int64 in [0, 2**32), of
    rows with int32 ``seeds`` (R,); ``t_q`` and ``t_k`` even."""
    dev = seeds.device
    seeds = seeds.to(torch.int64) & MASK32
    r = seeds.shape[0]
    qp = torch.arange(t_q // 2, device=dev, dtype=torch.int64)
    kp = torch.arange(t_k // 2, device=dev, dtype=torch.int64)
    hh = torch.arange(heads, device=dev, dtype=torch.int64)
    shape = (r, heads, t_q // 2, t_k // 2)
    c0 = qp[None, None, :, None].expand(shape)
    c1 = kp[None, None, None, :].expand(shape)
    c2 = hh[None, :, None, None].expand(shape)
    k0 = seeds[:, None, None, None].expand(shape)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    w = torch.stack(philox4x32_10(c0, c1, c2, zero, k0, zero), dim=-1)
    # (R, H, q/2, k/2, [q&1][k&1]) -> (R, H, t_q, t_k)
    w = w.reshape(*shape, 2, 2).permute(0, 1, 2, 4, 3, 5)
    return w.reshape(r, heads, t_q, t_k)


def attention_keep(seeds, heads: int, t_q: int, t_k: int, dropout: float):
    """Boolean keep-mask (R, heads, t_q, t_k) of ``dropout`` (see the
    module docstring); all True at dropout 0."""
    thr, _ = drop_threshold(dropout)
    return attention_bits(seeds, heads, t_q, t_k) >= thr
