"""Depthwise-separable 1-D conv over time, channels last, with its
callers' epilogue: CUDA kernel and plain version.

The grounding model's QANet blocks and conv heads (reference
grd_model_v5.py:36-56, 182-193) run a depthwise conv (kernel k, padding
k // 2) and a pointwise conv over (R, T, C) activations, then ReLU, a
residual and the clip mask:

  d = depthwise(x) + db                     (R, T, C)
  y = epi(d pw^T + pb)                      (R, T, Co)
  epi: ReLU, then + residual, then 0 where mask is false (each optional)

:func:`dwsep_conv_aten` is that arithmetic as ATen ops (a transpose to (R,
C, T) around the two ``conv1d`` calls, each epilogue step its own pass),
the grounding model's route for a call that records a gradient.  The
registered op ``vidsgg_big_tpu_torch::dwsep_conv`` (``torch.library``, so
that ``torch.export`` traces through it) takes float32 inference calls:
its CUDA kernel launches ``csrc/dwsep_conv.cu`` (one kernel, channels
last, the pointwise product in 3xTF32, the epilogue fused) and counts
``dwsep_conv.launches``; its CPU kernel is :func:`dwsep_conv_plain`.
Nothing falls back from the card to the plain version.  The kernel
replaces no TPU kernel (the JAX package leaves these convs to XLA).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

KERNEL_CHANNELS = 128      # the input width C the kernel is built for
MAX_KERNEL_SIZE = 7        # the widest depthwise kernel it takes (odd k)


def kernel_takes(c: int, co: int, k: int) -> bool:
    """Whether the kernel takes C input and Co output channels and a
    depthwise kernel of size k."""
    return c == KERNEL_CHANNELS and 1 <= co <= KERNEL_CHANNELS and \
        k % 2 == 1 and k <= MAX_KERNEL_SIZE


def conv_epilogue(y, relu: bool = False, residual=None, mask=None):
    """The callers' passes after a conv, in their order: ReLU, + residual,
    then zero at positions whose ``mask`` (R, T) is false."""
    if relu:
        y = F.relu(y)
    if residual is not None:
        y = y + residual
    if mask is not None:
        y = y.masked_fill(~mask[..., None], 0.0)
    return y


def dwsep_conv_aten(x, dw, db, pw, pb, relu: bool = False, residual=None,
                    mask=None):
    """The conv as ATen ops, in x's dtype: x (R, T, C) transposed to (R, C,
    T), the depthwise conv (dw (C, 1, k), db (C,), padding k // 2), the
    pointwise conv (pw (Co, C, 1), pb (Co,)), transposed back, then
    :func:`conv_epilogue`.  Returns (R, T, Co) as a transposed view's
    result (not contiguous)."""
    cdt = x.dtype
    xc = x.transpose(1, 2)
    y = F.conv1d(xc, dw.to(cdt), db.to(cdt), padding=dw.shape[-1] // 2,
                 groups=xc.shape[1])
    y = F.conv1d(y, pw.to(cdt), pb.to(cdt))
    return conv_epilogue(y.transpose(1, 2), relu, residual, mask)


def dwsep_conv_plain(x, dw, db, pw, pb, relu: bool = False, residual=None,
                     mask=None):
    """Plain PyTorch version (the CPU path and the kernel's oracle):
    :func:`dwsep_conv_aten`'s values, contiguous as the kernel's output."""
    return dwsep_conv_aten(x, dw, db, pw, pb, relu, residual,
                           mask).contiguous()


def dwsep_conv(x, dw, db, pw, pb, relu: bool = False, residual=None,
               mask=None):
    """The conv and its epilogue on the inputs' device, no gradient.

    x (R, T, C), residual (R, T, Co) and the weights float32; mask (R, T)
    bool.  CPU tensors take :func:`dwsep_conv_plain`; CUDA tensors launch
    the kernel (C = 128, Co <= 128, odd k <= 7; x and residual contiguous),
    counted in ``dwsep_conv.launches``."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"dwsep_conv: unsupported device {x.device}")
    return dwsep_conv_op(x, dw, db, pw, pb, bool(relu), residual, mask)


dwsep_conv.launches = 0


def _check_card_inputs(x, dw, db, pw, pb, residual, mask):
    name = "dwsep_conv"
    if x.dim() != 3:
        raise ValueError(f"{name}: x must be (R, T, C), got "
                         f"{tuple(x.shape)}")
    r, t, c = x.shape
    co, k = pw.shape[0], dw.shape[-1]
    if not kernel_takes(c, co, k):
        raise ValueError(f"{name}: the kernel takes C = {KERNEL_CHANNELS}, "
                         f"Co <= {KERNEL_CHANNELS} and odd k <= "
                         f"{MAX_KERNEL_SIZE}, got C = {c}, Co = {co}, "
                         f"k = {k}")
    if (dw.shape != (c, 1, k) or db.shape != (c,) or pw.shape != (co, c, 1)
            or pb.shape != (co,)
            or (residual is not None and residual.shape != (r, t, co))
            or (mask is not None and mask.shape != (r, t))):
        raise ValueError(
            f"{name}: shapes x {tuple(x.shape)}, dw {tuple(dw.shape)}, db "
            f"{tuple(db.shape)}, pw {tuple(pw.shape)}, pb {tuple(pb.shape)}"
            + ("" if residual is None else
               f", residual {tuple(residual.shape)}")
            + ("" if mask is None else f", mask {tuple(mask.shape)}")
            + " do not agree")
    floats = [x, dw, db, pw, pb] + ([] if residual is None else [residual])
    if any(a.dtype != torch.float32 for a in floats) or (
            mask is not None and mask.dtype != torch.bool):
        raise TypeError(f"{name}: x, the weights and the residual must be "
                        f"float32 and the mask bool, got "
                        f"{[a.dtype for a in floats]}"
                        + ("" if mask is None else f", {mask.dtype}"))
    tensors = floats + ([] if mask is None else [mask])
    if any(a.device != x.device for a in tensors):
        raise ValueError(f"{name}: inputs lie on different devices")
    if not all(a.is_contiguous() for a in tensors) or x.data_ptr() % 16 or \
            (residual is not None and residual.data_ptr() % 8):
        raise ValueError(f"{name}: inputs must be contiguous, x 16-byte and "
                         "the residual 8-byte aligned")


def _launch(x, dw, db, pw, pb, relu, residual, mask):
    """The op's CUDA kernel: checks the operands, launches the kernel and
    counts the launch."""
    _check_card_inputs(x, dw, db, pw, pb, residual, mask)
    r, t, c = x.shape
    co, k = pw.shape[0], dw.shape[-1]
    y = torch.empty((r, t, co), dtype=torch.float32, device=x.device)
    if r == 0 or t == 0:              # an empty grid cannot be launched
        return y
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dwsep_conv_launch(
            x.data_ptr(), dw.data_ptr(), db.data_ptr(), pw.data_ptr(),
            pb.data_ptr(), None if residual is None else residual.data_ptr(),
            None if mask is None else mask.data_ptr(), y.data_ptr(), r, t, c,
            co, k, int(relu), stream)
    if err != 0:
        raise RuntimeError(
            f"dwsep_conv kernel launch failed (R={r}, T={t}, Co={co}, k={k}, "
            f"{lib.dwsep_conv_smem_bytes(co, k)} B shared memory): "
            f"{lib.dwsep_conv_error_string(err).decode()}")
    dwsep_conv.launches += 1
    return y


def _dwsep_conv_fake(x, dw, db, pw, pb, relu, residual, mask):
    return x.new_empty((x.shape[0], x.shape[1], pw.shape[0]))


_LIB = torch.library.Library("vidsgg_big_tpu_torch", "FRAGMENT")
_LIB.define("dwsep_conv(Tensor x, Tensor dw, Tensor db, Tensor pw, "
            "Tensor pb, bool relu, Tensor? residual, Tensor? mask) -> Tensor")
_LIB.impl("dwsep_conv", dwsep_conv_plain, "CPU")
_LIB.impl("dwsep_conv", _launch, "CUDA")
torch.library.register_fake("vidsgg_big_tpu_torch::dwsep_conv",
                            _dwsep_conv_fake, lib=_LIB)
dwsep_conv_op = torch.ops.vidsgg_big_tpu_torch.dwsep_conv.default


def _library():
    """The kernel library, built first if needed, its C signatures
    declared."""
    from .build import load

    lib = load("dwsep_conv")
    if lib.dwsep_conv_launch.argtypes is None:
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.dwsep_conv_launch.argtypes = [ptr] * 8 + [i64] + [i32] * 5 + [
            ptr]
        lib.dwsep_conv_launch.restype = i32
        lib.dwsep_conv_smem_bytes.argtypes = [i32, i32]
        lib.dwsep_conv_smem_bytes.restype = i64
        lib.dwsep_conv_error_string.argtypes = [i32]
        lib.dwsep_conv_error_string.restype = ctypes.c_char_p
    return lib
