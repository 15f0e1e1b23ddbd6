"""Operations and bytes of one call of each hand-written kernel of the port,
from its shapes alone, frozen with the benchmark.

Each input is counted as read once and each output as written once, as the
kernel takes them (float32 here, a bool mask at one byte), whatever the
kernel reads again; the products are the matmuls its equations need.
"""
from __future__ import annotations

from .peaks import bound_seconds


def role_attention_flops(b: int, q: int, n: int, dh: int, de: int) -> float:
    """Logits p e^T (2 Q N Dh) and values att enco (2 Q N De), per video
    and role."""
    return 2.0 * b * (2.0 * q * n * dh + 2.0 * q * n * de)


def role_attention_bound(b: int, q: int, n: int, dh: int, de: int,
                         itemsize: int = 4) -> float:
    """Seconds: p (B,2,Q,Dh), e (B,2,N,Dh), enco (B,N,De) and the mask
    (B,N) read, att (B,2,Q,N) and values (B,2,Q,De) written."""
    nbytes = itemsize * (b * 2 * q * dh + b * 2 * n * dh + b * n * de
                         + b * 2 * q * n + b * 2 * q * de) + b * n
    return bound_seconds(role_attention_flops(b, q, n, dh, de), nbytes,
                         "float32" if itemsize == 4 else "bfloat16")


def fused_attention_flops(rows: int, t: int, e: int, heads: int,
                          backward: bool = False) -> float:
    """Composed attention: per row and head the forward does S = qh x^T
    (2 T^2 e) and out += A vt (2 T^2 e); the backward 10 T^2 e.  ``e`` is
    the composite width."""
    fwd = 4.0 * heads * rows * t * t * e
    bwd = 10.0 * heads * rows * t * t * e
    return fwd + (bwd if backward else 0.0)


def composed_forward_bound(rows: int, heads: int, t: int, d: int,
                           dtype: str = "float32") -> float:
    """Seconds of one forward call, with or without dropout: qh and vt
    (R,H,T,d), x (R,T,d) and the bias (R,T) read, out (R,T,d) written."""
    item = 4 if dtype == "float32" else 2
    nbytes = (2 * rows * heads * t * d + 2 * rows * t * d) * item \
        + rows * t * 4
    return bound_seconds(fused_attention_flops(rows, t, d, heads), nbytes,
                         dtype)


def composed_backward_bound(rows: int, heads: int, t: int, d: int,
                            dtype: str = "float32") -> float:
    """Seconds of one backward (dq and dk/dv kernels together): qh, vt, x,
    do and the bias read, dqh, dvt and dx written."""
    item = 4 if dtype == "float32" else 2
    nbytes = (4 * rows * heads * t * d + 3 * rows * t * d) * item \
        + rows * t * 4
    flop = fused_attention_flops(rows, t, d, heads, backward=True) \
        - fused_attention_flops(rows, t, d, heads)
    return bound_seconds(flop, nbytes, dtype)


def dwsep_conv_flops(rows: int, t: int, c: int, co: int, k: int) -> float:
    """A depthwise-separable conv over (rows, t, c): the depthwise taps
    (2 c k a step) and the pointwise product (2 c co a step)."""
    return 2.0 * rows * t * (c * k + c * co)


def dwsep_conv_bound(rows: int, t: int, c: int, co: int, k: int,
                     residual: bool = False, mask: bool = False) -> float:
    """Seconds of one ``dwsep_conv`` call (float32): x (rows, t, c), the
    depthwise and pointwise weights and biases, the residual (rows, t, co)
    and the mask (rows, t, one byte) where the call takes them read, y
    (rows, t, co) written."""
    nbytes = 4 * (rows * t * c + c * k + c + co * c + co
                  + rows * t * co * (2 if residual else 1)) \
        + (rows * t if mask else 0)
    return bound_seconds(dwsep_conv_flops(rows, t, c, co, k), nbytes,
                         "float32")
