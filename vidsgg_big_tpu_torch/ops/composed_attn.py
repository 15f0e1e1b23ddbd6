"""Head-composed QANet self-attention: CUDA kernels and plain versions.

The grounding QANet blocks run 8 heads of head_dim 16 over up to (B*Q, T) =
(1024, 512) token grids.  Per head, the logits factor through the d x d
composite W_q W_k^T, so the contraction runs at the full width d = 128 and
the keys and values are the raw ``x`` rows (``ops/attention.composed_qkvo``
folds the weights).  Ported from the TPU kernels ``_fwd_kernel`` and
``_bwd_kernel`` in ``vidsgg_big_tpu/ops/pallas_attention.py``:

  S_h = qh_h x^T * scale + bias       scale = 1/sqrt(hd), hd = d / heads
  A_h = softmax(S_h)                  float32
  Ã_h = A_h * keep_h / (1 - p)        train mode, dropout p
  out = sum_h Ã_h vt_h                Ã_h cast to x's dtype, f32 sums

The keep-mask is a pure function of (row seed, head, query, key)
(``ops/philox.py``), so the forward kernel, the backward kernel and the
plain versions draw the same mask.  For CUDA tensors the wrappers launch
the kernels of ``csrc/composed_attn.cu`` (forward) and
``csrc/composed_attn_bwd.cu`` (backward) and count each launch; CPU tensors
take the plain versions.  Nothing falls back from the card to the plain
version.  The inference forward (dropout 0) goes through the registered op
``vidsgg_big_tpu_torch::composed_attention`` (``torch.library``), so that
``torch.export`` traces through it; the train forward and the backward
stay behind :class:`ComposedAttention` (export is inference only).
"""
from __future__ import annotations

import ctypes
import math

import torch

from .attention import draw_share
from .philox import attention_keep, drop_threshold

# the plain versions hold at most this many bytes of float32 logits at once
PLAIN_LOGIT_BYTES = 1 << 30
KERNEL_WIDTH = 128          # the composite width d the kernels are built for


def fused_attention_flops(rows: int, t: int, e: int, heads: int,
                          backward: bool = False) -> float:
    """Matmul FLOPs of the composed attention (``fused_attention_flops`` of
    pallas_attention.py): per row and head the forward does S = qh x^T
    (2 T^2 e) and out += A vt (2 T^2 e); the backward 10 T^2 e.  ``e`` is
    the composite width."""
    fwd = 4.0 * heads * rows * t * t * e
    bwd = 10.0 * heads * rows * t * t * e
    return fwd + (bwd if backward else 0.0)


def _row_chunk(h: int, t: int) -> int:
    return max(1, PLAIN_LOGIT_BYTES // (4 * h * t * t))


def _softmax_and_keep(qh, x, bias, scale, seeds, dropout):
    """float32 softmax A (r, h, t, t) of one chunk and its keep-mask (None
    at dropout 0)."""
    r, h, t, _ = qh.shape
    if dropout > 0.0 and seeds is None:
        raise ValueError("composed attention: dropout needs the rows' seeds")
    logits = torch.einsum("rhtd,rkd->rhtk", qh.float(), x.float()) * scale \
        + bias[:, None, None, :]
    a = torch.softmax(logits, dim=-1)
    keep = attention_keep(seeds, h, t, t, dropout) if dropout > 0.0 else None
    return a, keep


def composed_attention_plain(qh, x, vt, bias, scale: float,
                             dropout: float = 0.0, seeds=None):
    """Plain PyTorch version (the CPU path and the kernels' oracle).

    Args:
      qh: (R, H, T, d) composed queries, float32 or bfloat16.
      x: (R, T, d) keys (the layer input), same dtype.
      vt: (R, H, T, d) composed values, same dtype.
      bias: (R, T) float32 additive key bias (0 valid, -1e30 masked).
      scale: softmax scale, 1/sqrt(original head_dim).
      dropout: attention-dropout rate; ``seeds`` (R,) int32 are the rows'
        Philox seeds (needed when dropout > 0).

    Returns (R, T, d) in x's dtype.  Rows go in chunks whose float32 logits
    stay under ``PLAIN_LOGIT_BYTES``; products take bf16 inputs in float32
    (exact), so they accumulate in float32 as the kernels' do.
    """
    r, h, t, _ = qh.shape
    _, inv = drop_threshold(dropout)
    chunk = _row_chunk(h, t)
    out = torch.empty_like(x)
    for s in range(0, r, chunk):
        sl = slice(s, s + chunk)
        a, keep = _softmax_and_keep(qh[sl], x[sl], bias[sl], scale,
                                    None if seeds is None else seeds[sl],
                                    dropout)
        if keep is not None:
            a = torch.where(keep, a * inv, 0.0)
        a = a.to(x.dtype).float()
        out[sl] = torch.einsum("rhtk,rhkd->rtd", a, vt[sl].float()).to(
            x.dtype)
    return out


def composed_attention_plain_bwd(qh, x, vt, bias, do, scale: float,
                                 dropout: float = 0.0, seeds=None):
    """Gradients (dqh, dx, dvt) of :func:`composed_attention_plain` for the
    output cotangent ``do`` (R, T, d), written out as ``_bwd_kernel``
    (pallas_attention.py:89-131): recompute S and the pre-dropout A,
    ``u = do vt_h^T``, ``da = keep u inv``, ``r = sum_k da a``, ``ds = a (da
    - r) scale`` rounded to x's dtype before its products, ``dvt_h =
    cast(a_d)^T do``, ``dqh_h = ds x``, ``dx = sum_h ds^T qh_h``; float32
    sums.  Outputs in x's dtype."""
    r, h, t, _ = qh.shape
    _, inv = drop_threshold(dropout)
    chunk = _row_chunk(h, t)
    dqh, dvt, dx = (torch.empty_like(qh), torch.empty_like(vt),
                    torch.empty_like(x))
    cdt = x.dtype
    for s in range(0, r, chunk):
        sl = slice(s, s + chunk)
        a, keep = _softmax_and_keep(qh[sl], x[sl], bias[sl], scale,
                                    None if seeds is None else seeds[sl],
                                    dropout)
        dof = do[sl].float()
        u = torch.einsum("rtd,rhkd->rhtk", dof, vt[sl].float())
        if keep is not None:
            a_d = torch.where(keep, a * inv, 0.0)
            da = torch.where(keep, u * inv, 0.0)
        else:
            a_d, da = a, u
        dvt[sl] = torch.einsum("rhtk,rtd->rhkd", a_d.to(cdt).float(),
                               dof).to(cdt)
        rr = (da * a).sum(-1, keepdim=True)
        ds = (a * (da - rr) * scale).to(cdt).float()
        dqh[sl] = torch.einsum("rhtk,rkd->rhtd", ds, x[sl].float()).to(cdt)
        dx[sl] = torch.einsum("rhtk,rhtd->rkd", ds, qh[sl].float()).to(cdt)
    return dqh, dx, dvt


def _check_card_inputs(name, qh, x, vt, bias, *more):
    r, h, t, d = qh.shape
    if d != KERNEL_WIDTH:
        raise ValueError(f"{name}: the kernel takes d = {KERNEL_WIDTH} "
                         f"only, got {d}")
    if (x.shape != (r, t, d) or vt.shape != qh.shape
            or bias.shape != (r, t)):
        raise ValueError(f"{name}: shapes qh {tuple(qh.shape)}, x "
                         f"{tuple(x.shape)}, vt {tuple(vt.shape)}, bias "
                         f"{tuple(bias.shape)} do not agree")
    if t % 64 != 0:
        raise ValueError(f"{name}: T = {t} is not a multiple of 64")
    if x.dtype not in (torch.float32, torch.bfloat16) or \
            qh.dtype != x.dtype or vt.dtype != x.dtype or \
            bias.dtype != torch.float32:
        raise TypeError(f"{name}: qh/x/vt must share float32 or bfloat16 "
                        f"and bias must be float32, got "
                        f"{qh.dtype}/{x.dtype}/{vt.dtype}/{bias.dtype}")
    tensors = (qh, x, vt, bias) + tuple(a for a in more if a is not None)
    if any(a.device != x.device for a in tensors):
        raise ValueError(f"{name}: inputs lie on different devices")
    if not all(a.is_contiguous() and a.data_ptr() % 16 == 0
               for a in tensors):
        raise ValueError(f"{name}: inputs must be contiguous and 16-byte "
                         "aligned")


def _device_kind(name, x):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    return x.device.type


def _check_seeds(name, seeds, r, device):
    if seeds is None or seeds.shape != (r,) or seeds.dtype != torch.int32 \
            or seeds.device != device:
        raise ValueError(f"{name}: dropout needs seeds, an int32 tensor "
                         f"({r},) on {device}")


def _launch_forward(train: bool, qh, x, vt, bias, scale, dropout, seeds,
                    lib=None):
    """The forward kernel on the card: the inference instance, or the train
    instance (dropout and the softmax statistics).  Returns (out, stats).
    ``lib``: another build of ``csrc/composed_attn.cu`` bound by
    :func:`bind_library` (``tools/forward_turns.py``), else this one."""
    name = "composed_attention_train" if train else "composed_attention"
    _check_card_inputs(name, qh, x, vt, bias, seeds)
    r, h, t, _ = qh.shape
    out = torch.empty_like(x)
    stats = torch.empty((r, h, t, 2), dtype=torch.float32,
                        device=x.device) if train else None
    if r == 0:                        # an empty grid cannot be launched
        return out, stats
    is_bf16 = int(x.dtype == torch.bfloat16)
    lib = lib or _library("composed_attn")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if train:
            thr, inv = drop_threshold(dropout)
            err = lib.composed_attn_forward_train(
                qh.data_ptr(), x.data_ptr(), vt.data_ptr(), bias.data_ptr(),
                seeds.data_ptr(), out.data_ptr(), stats.data_ptr(), r, h, t,
                is_bf16, scale, thr, inv, stream)
        else:
            err = lib.composed_attn_forward(
                qh.data_ptr(), x.data_ptr(), vt.data_ptr(), bias.data_ptr(),
                out.data_ptr(), r, h, t, is_bf16, scale, stream)
    if err != 0:
        raise RuntimeError(
            f"{name} kernel launch failed (T={t}, "
            f"{lib.composed_attn_smem_bytes(t, is_bf16)} B shared memory): "
            f"{lib.composed_attn_error_string(err).decode()}")
    (composed_attention_train if train else composed_attention).launches += 1
    return out, stats


def composed_attention(qh, x, vt, bias, scale: float, dropout: float = 0.0,
                       seeds=None):
    """Composed attention forward on the inputs' device, no gradient.

    Shapes as :func:`composed_attention_plain`.  CPU tensors take the plain
    version; CUDA tensors launch the kernel (d must be 128, T a multiple of
    64): at dropout 0 the inference instance, counted in
    ``composed_attention.launches``; with dropout (``seeds`` (R,) int32 on
    the card) the train instance, counted in
    ``composed_attention_train.launches``.
    """
    on_cpu = _device_kind("composed_attention", x) == "cpu"
    if dropout > 0.0:
        if on_cpu:
            return composed_attention_plain(qh, x, vt, bias, scale, dropout,
                                            seeds)
        _check_seeds("composed_attention", seeds, qh.shape[0], x.device)
        return composed_attention_train(qh, x, vt, bias, scale, dropout,
                                        seeds)[0]
    return composed_attention_op(qh, x, vt, bias, float(scale))


composed_attention.launches = 0


def _composed_attention_cpu(qh, x, vt, bias, scale):
    """The op's CPU kernel: the plain version, whose output is
    ``empty_like(x)`` as the fake's."""
    return composed_attention_plain(qh, x, vt, bias, scale)


def _composed_attention_cuda(qh, x, vt, bias, scale):
    return _launch_forward(False, qh, x, vt, bias, scale, 0.0, None)[0]


def _composed_attention_fake(qh, x, vt, bias, scale):
    return torch.empty_like(x)


# the inference forward (dropout 0) as a registered op, through
# torch.library.Library as role attention's (ops/role_attn.py)
_LIB = torch.library.Library("vidsgg_big_tpu_torch", "FRAGMENT")
_LIB.define("composed_attention(Tensor qh, Tensor x, Tensor vt, "
            "Tensor bias, float scale) -> Tensor")
_LIB.impl("composed_attention", _composed_attention_cpu, "CPU")
_LIB.impl("composed_attention", _composed_attention_cuda, "CUDA")
torch.library.register_fake("vidsgg_big_tpu_torch::composed_attention",
                            _composed_attention_fake, lib=_LIB)
composed_attention_op = \
    torch.ops.vidsgg_big_tpu_torch.composed_attention.default


def composed_attention_train(qh, x, vt, bias, scale: float, dropout: float,
                             seeds):
    """The forward of training on the card: (out, stats), where ``stats``
    (R, H, T, 2) float32 holds each (row, head, query)'s softmax max and
    reciprocal sum in the kernel's units, the backward kernel's input.
    ``seeds`` (R,) int32 on the card (read at dropout 0 too).  Counts
    ``composed_attention_train.launches``."""
    _check_seeds("composed_attention_train", seeds, qh.shape[0], x.device)
    return _launch_forward(True, qh, x, vt, bias, scale, dropout, seeds)


composed_attention_train.launches = 0


def composed_attention_backward(qh, x, vt, bias, seeds, stats, do,
                                scale: float, dropout: float = 0.0):
    """(dqh, dx, dvt) for the output cotangent ``do`` (R, T, d).

    CPU tensors take :func:`composed_attention_plain_bwd` (``stats`` is not
    read).  CUDA tensors launch the backward kernels (one call: the
    query-parallel dq kernel, then the key-parallel dk/dv kernel; bf16 on
    wgmma, f32 as 3xTF32 on the tensor cores) on the forward's ``stats``
    and ``seeds``, and count one launch in
    ``composed_attention_backward.launches``.  A launch the card refuses
    (shared memory, registers) raises; nothing falls back.
    """
    if _device_kind("composed_attention_backward", x) == "cpu":
        return composed_attention_plain_bwd(qh, x, vt, bias, do, scale,
                                            dropout, seeds)
    name = "composed_attention_backward"
    _check_card_inputs(name, qh, x, vt, bias, seeds, stats, do)
    r, h, t, _ = qh.shape
    _check_seeds(name, seeds, r, x.device)
    if stats is None or stats.shape != (r, h, t, 2) or \
            stats.dtype != torch.float32:
        raise ValueError(f"{name}: stats must be the train forward's "
                         f"({r}, {h}, {t}, 2) float32")
    if do.shape != x.shape or do.dtype != x.dtype:
        raise ValueError(f"{name}: do {tuple(do.shape)} {do.dtype} must "
                         f"match x {tuple(x.shape)} {x.dtype}")
    dqh, dvt, dx = (torch.empty_like(qh), torch.empty_like(vt),
                    torch.empty_like(x))
    if r == 0:
        return dqh, dx, dvt
    rbuf = torch.empty((r, h, t), dtype=torch.float32, device=x.device)
    is_bf16 = int(x.dtype == torch.bfloat16)
    thr, inv = drop_threshold(dropout)
    lib = _library("composed_attn_bwd")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.composed_attn_backward(
            qh.data_ptr(), x.data_ptr(), vt.data_ptr(), bias.data_ptr(),
            seeds.data_ptr(), stats.data_ptr(), do.data_ptr(),
            dqh.data_ptr(), dx.data_ptr(), dvt.data_ptr(), rbuf.data_ptr(),
            r, h, t, is_bf16, scale, thr, inv, stream)
    if err != 0:
        raise RuntimeError(
            f"{name} kernel launch failed (T={t}, "
            f"{lib.composed_attn_bwd_smem_bytes(t, is_bf16, 0)} / "
            f"{lib.composed_attn_bwd_smem_bytes(t, is_bf16, 1)} B shared "
            f"memory): {lib.composed_attn_bwd_error_string(err).decode()}")
    composed_attention_backward.launches += 1
    return dqh, dx, dvt


composed_attention_backward.launches = 0


class ComposedAttention(torch.autograd.Function):
    """Composed attention with its gradient (the custom VJP ``_fused`` of
    pallas_attention.py:294-311): the train forward and the backward kernels
    for CUDA tensors, the plain versions for CPU tensors.  Gradients flow to
    qh, x and vt; bias and seeds get none."""

    @staticmethod
    def forward(ctx, qh, x, vt, bias, seeds, scale, dropout):
        if _device_kind("ComposedAttention", x) == "cpu":
            out, stats = composed_attention_plain(
                qh, x, vt, bias, scale, dropout, seeds), None
        else:
            out, stats = composed_attention_train(qh, x, vt, bias, scale,
                                                  dropout, seeds)
        ctx.save_for_backward(qh, x, vt, bias, seeds, stats)
        ctx.scale, ctx.dropout = scale, dropout
        return out

    @staticmethod
    def backward(ctx, do):
        qh, x, vt, bias, seeds, stats = ctx.saved_tensors
        do = do.contiguous()
        if do.data_ptr() % 16:
            do = do.clone()
        dqh, dx, dvt = composed_attention_backward(
            qh, x, vt, bias, seeds, stats, do, ctx.scale, ctx.dropout)
        return dqh, dx, dvt, None, None, None, None


def fused_composed_attention(x, mask, wqk, wb, wvo, cb, *, hd: int,
                             dropout: float = 0.0, generator=None):
    """Composed attention including the output projection, (B, T, d) ->
    (B, T, d); ``fused_composed_attention`` of pallas_attention.py.

    ``wqk, wb, wvo, cb`` are :func:`~.attention.composed_qkvo`'s float32
    composites; they are cast to x's dtype here, after composing.  ``hd``
    is the original head_dim (the softmax scale is 1/sqrt(hd)); ``mask``
    (B, T) marks valid keys, None for all.  With ``dropout`` > 0 the (B,)
    per-row seeds are drawn from ``generator`` (as pallas_attention.py:352-356
    draws them from ``rng``; a :class:`~.attention.ShardedDraws` gives
    this rank's rows of the global batch's seeds).  When a gradient is wanted the call goes
    through :class:`ComposedAttention`.
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
    if dropout > 0.0:
        # a sharded step's rows take their slice of the global batch's
        # seeds, so its keep-masks are the single process's
        seeds = draw_share(generator, (b,), lambda s, g: torch.randint(
            -2 ** 31, 2 ** 31, s, dtype=torch.int32, generator=g)).to(
            x.device)
    else:
        seeds = torch.zeros((b,), dtype=torch.int32, device=x.device)
    operands = (qh.contiguous(), x.contiguous(), vt.contiguous(),
                bias.contiguous())
    scale = 1.0 / math.sqrt(hd)
    if torch.is_grad_enabled() and any(
            a.requires_grad for a in (x, wqk, wb, wvo)):
        o = ComposedAttention.apply(*operands, seeds, scale, float(dropout))
    else:
        o = composed_attention(*operands, scale, dropout, seeds)
    return o + cb.to(cdt)


def _library(name: str):
    from .build import load

    return bind_library(load(name), name)


def bind_library(lib, name: str):
    """Declare the C signatures of the kernel library ``name``
    ("composed_attn" or "composed_attn_bwd") on the loaded ``lib``."""
    ptr, i32, u32, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32,
                          ctypes.c_float)
    if name == "composed_attn" and lib.composed_attn_forward.argtypes is None:
        lib.composed_attn_forward.argtypes = [ptr] * 5 + [i32] * 4 + [
            f32, ptr]
        lib.composed_attn_forward.restype = i32
        lib.composed_attn_forward_train.argtypes = [ptr] * 7 + [i32] * 4 + [
            f32, u32, f32, ptr]
        lib.composed_attn_forward_train.restype = i32
        lib.composed_attn_smem_bytes.argtypes = [i32, i32]
        lib.composed_attn_smem_bytes.restype = ctypes.c_longlong
        lib.composed_attn_error_string.argtypes = [i32]
        lib.composed_attn_error_string.restype = ctypes.c_char_p
    if name == "composed_attn_bwd" and \
            lib.composed_attn_backward.argtypes is None:
        lib.composed_attn_backward.argtypes = [ptr] * 11 + [i32] * 4 + [
            f32, u32, f32, ptr]
        lib.composed_attn_backward.restype = i32
        lib.composed_attn_bwd_smem_bytes.argtypes = [i32, i32, i32]
        lib.composed_attn_bwd_smem_bytes.restype = ctypes.c_longlong
        lib.composed_attn_bwd_error_string.argtypes = [i32]
        lib.composed_attn_bwd_error_string.restype = ctypes.c_char_p
    return lib
