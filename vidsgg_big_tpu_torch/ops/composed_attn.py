"""Head-composed QANet self-attention: CUDA kernel and plain version.

The grounding QANet blocks run 8 heads of head_dim 16 over up to (B*Q, T) =
(1024, 512) token grids.  Per head, the logits factor through the d x d
composite W_q W_k^T, so the contraction runs at the full width d = 128 and
the keys and values are the raw ``x`` rows (``ops/attention.composed_qkvo``
folds the weights).  Ported from the TPU kernel ``_fwd_kernel`` in
``vidsgg_big_tpu/ops/pallas_attention.py``; forward only:

  S_h = qh_h x^T * scale + bias       scale = 1/sqrt(hd), hd = d / heads
  A_h = softmax(S_h)                  float32
  out = sum_h A_h vt_h                A_h cast to x's dtype, f32 sums

``composed_attention`` launches the kernel of ``csrc/composed_attn.cu`` for
CUDA tensors and uses :func:`composed_attention_plain` for CPU tensors; it
never falls back from the card to the plain version.
"""
from __future__ import annotations

import ctypes
import math

import torch

# the plain version holds at most this many bytes of float32 logits at once
PLAIN_LOGIT_BYTES = 1 << 30
KERNEL_WIDTH = 128          # the composite width d the kernel is built for


def fused_attention_flops(rows: int, t: int, e: int, heads: int,
                          backward: bool = False) -> float:
    """Matmul FLOPs of the composed attention (``fused_attention_flops`` of
    pallas_attention.py): per row and head the forward does S = qh x^T
    (2 T^2 e) and out += A vt (2 T^2 e); the backward 10 T^2 e.  ``e`` is
    the composite width."""
    fwd = 4.0 * heads * rows * t * t * e
    bwd = 10.0 * heads * rows * t * t * e
    return fwd + (bwd if backward else 0.0)


def composed_attention_plain(qh, x, vt, bias, scale: float):
    """Plain PyTorch version (the CPU path and the kernel's oracle).

    Args:
      qh: (R, H, T, d) composed queries, float32 or bfloat16.
      x: (R, T, d) keys (the layer input), same dtype.
      vt: (R, H, T, d) composed values, same dtype.
      bias: (R, T) float32 additive key bias (0 valid, -1e30 masked).
      scale: softmax scale, 1/sqrt(original head_dim).

    Returns (R, T, d) in x's dtype.  Rows go in chunks whose float32 logits
    stay under ``PLAIN_LOGIT_BYTES``; products take bf16 inputs in float32
    (exact), so they accumulate in float32 as the kernel's do.
    """
    r, h, t, _ = qh.shape
    chunk = max(1, PLAIN_LOGIT_BYTES // (4 * h * t * t))
    out = torch.empty_like(x)
    for s in range(0, r, chunk):
        sl = slice(s, s + chunk)
        logits = torch.einsum("rhtd,rkd->rhtk", qh[sl].float(),
                              x[sl].float()) * scale + bias[sl, None, None, :]
        a = torch.softmax(logits, dim=-1).to(x.dtype).float()
        out[sl] = torch.einsum("rhtk,rhkd->rtd", a, vt[sl].float()).to(
            x.dtype)
    return out


def composed_attention(qh, x, vt, bias, scale: float, dropout: float = 0.0):
    """Composed attention on the inputs' device.

    Shapes as :func:`composed_attention_plain`.  CPU tensors take the plain
    version; CUDA tensors launch the kernel (d must be 128, T a multiple of
    64) and count the launch in ``composed_attention.launches``.  Dropout on
    the attention weights belongs to grounding training, which is not
    ported yet: ``dropout > 0`` raises.
    """
    if dropout > 0.0:
        raise NotImplementedError(
            "composed_attention: attention dropout comes with grounding "
            "training, the next slice of the port (ROADMAP A6)")
    if x.device.type == "cpu":
        return composed_attention_plain(qh, x, vt, bias, scale)
    if x.device.type != "cuda":
        raise ValueError(f"composed_attention: unsupported device "
                         f"{x.device}")
    r, h, t, d = qh.shape
    if d != KERNEL_WIDTH:
        raise ValueError(f"composed_attention: the kernel takes d = "
                         f"{KERNEL_WIDTH} only, got {d}")
    if (x.shape != (r, t, d) or vt.shape != qh.shape
            or bias.shape != (r, t)):
        raise ValueError(f"composed_attention: shapes qh {tuple(qh.shape)}, "
                         f"x {tuple(x.shape)}, vt {tuple(vt.shape)}, bias "
                         f"{tuple(bias.shape)} do not agree")
    if t % 64 != 0:
        raise ValueError(f"composed_attention: T = {t} is not a multiple "
                         "of 64")
    if x.dtype not in (torch.float32, torch.bfloat16) or \
            qh.dtype != x.dtype or vt.dtype != x.dtype or \
            bias.dtype != torch.float32:
        raise TypeError(f"composed_attention: qh/x/vt must share float32 or "
                        f"bfloat16 and bias must be float32, got "
                        f"{qh.dtype}/{x.dtype}/{vt.dtype}/{bias.dtype}")
    if any(a.device != x.device for a in (qh, vt, bias)):
        raise ValueError("composed_attention: inputs lie on different "
                         "devices")
    if not all(a.is_contiguous() and a.data_ptr() % 16 == 0
               for a in (qh, x, vt, bias)):
        raise ValueError("composed_attention: inputs must be contiguous "
                         "and 16-byte aligned")
    out = torch.empty_like(x)
    if r == 0:                        # an empty grid cannot be launched
        return out
    is_bf16 = int(x.dtype == torch.bfloat16)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.composed_attn_forward(
            qh.data_ptr(), x.data_ptr(), vt.data_ptr(), bias.data_ptr(),
            out.data_ptr(), r, h, t, is_bf16, scale, stream)
    if err != 0:
        raise RuntimeError(
            f"composed_attention kernel launch failed (T={t}, "
            f"{lib.composed_attn_smem_bytes(t, is_bf16)} B shared memory): "
            f"{lib.composed_attn_error_string(err).decode()}")
    composed_attention.launches += 1
    return out


composed_attention.launches = 0


def fused_composed_attention(x, mask, wqk, wb, wvo, cb, *, hd: int,
                             dropout: float = 0.0):
    """Composed attention including the output projection, (B, T, d) ->
    (B, T, d); ``fused_composed_attention`` of pallas_attention.py.

    ``wqk, wb, wvo, cb`` are :func:`~.attention.composed_qkvo`'s float32
    composites; they are cast to x's dtype here, after composing.  ``hd``
    is the original head_dim (the softmax scale is 1/sqrt(hd)); ``mask``
    (B, T) marks valid keys, None for all.
    """
    b, t, _ = x.shape
    cdt = x.dtype
    qh = torch.einsum("btc,hce->bhte", x, wqk.to(cdt)) + \
        wb.to(cdt)[None, :, None, :]
    vt = torch.einsum("btc,hce->bhte", x, wvo.to(cdt))
    if mask is None:
        bias = torch.zeros((b, t), dtype=torch.float32, device=x.device)
    else:
        bias = torch.where(mask, 0.0, -1e30).to(torch.float32)
    o = composed_attention(qh.contiguous(), x.contiguous(), vt.contiguous(),
                           bias.contiguous(), 1.0 / math.sqrt(hd), dropout)
    return o + cb.to(cdt)


def _library():
    from .build import load

    lib = load("composed_attn")
    if lib.composed_attn_forward.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.composed_attn_forward.argtypes = [ptr] * 5 + [i32] * 4 + [
            ctypes.c_float, ptr]
        lib.composed_attn_forward.restype = i32
        lib.composed_attn_smem_bytes.argtypes = [i32, i32]
        lib.composed_attn_smem_bytes.restype = ctypes.c_longlong
        lib.composed_attn_error_string.argtypes = [i32]
        lib.composed_attn_error_string.restype = ctypes.c_char_p
    return lib
