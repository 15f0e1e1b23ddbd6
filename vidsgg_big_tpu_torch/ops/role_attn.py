"""Fused role-factored bipartite attention: CUDA kernel and plain version.

The BIG-C decoder's signature op (reference models/model_0v10.py:196-214),
ported from the TPU kernel in ``vidsgg_big_tpu/ops/pallas_role_attn.py``.
For each of 2 roles r, attention logits between predicate queries and entity
nodes, the *product* of a softmax over entities and a softmax over roles,
then the value matmul against the entity nodes:

  logits[r, q, n] = <p[r, q], e[r, n]> / sqrt(dim_enti)
  att = softmax_n(mask(logits)) * softmax_r(logits)
  values[r, q, :] = att[r, q, :] @ enco

``role_attention`` calls the registered op ``vidsgg_big_tpu_torch::
role_attention`` (``torch.library``), so that ``torch.export`` traces
through it: its CUDA kernel launches the kernel of ``csrc/role_attn.cu``,
its CPU kernel is :func:`role_attention_plain`, and its fake gives the
outputs' shapes.  Nothing falls back from the card to the plain version.
"""
from __future__ import annotations

import ctypes
import math

import torch

QUERY_TILE = 16          # query rows of one block (csrc/role_attn.cu QT)
MAX_SPLITS = 4           # blocks that may share one query tile's De columns
MIN_SPLIT_COLUMNS = 128  # the fewest De columns a split leaves a block

_sm_count: dict = {}


def role_attention_flops(b: int, q: int, n: int, dh: int, de: int) -> float:
    """Matmul FLOPs of one call: logits p e^T (2*Q*N*Dh) and values
    att enco (2*Q*N*De) per video and role."""
    return 2.0 * b * (2.0 * q * n * dh + 2.0 * q * n * de)


def de_splits(b: int, q: int, de: int, sms: int) -> int:
    """How many blocks share the De columns of one query tile: the most, up
    to MAX_SPLITS, that keep the grid of B x ceil(Q / 16) tiles within one
    block an SM and leave each block at least MIN_SPLIT_COLUMNS columns.
    Each of them recomputes the tile's logits (a third of the products at
    De = 2 Dh)."""
    tiles = b * -(-q // QUERY_TILE)
    splits = 1
    while (2 * splits <= MAX_SPLITS and 2 * splits * tiles <= sms
           and de // (2 * splits) >= MIN_SPLIT_COLUMNS):
        splits *= 2
    return splits


def role_attention_plain(pred2att, enti2att, enco, traj_mask, dim_enti: int):
    """Plain PyTorch version (the CPU path and the kernel's oracle).

    Args:
      pred2att: (B, 2, Q, Dh) query projections (role-split halves).
      enti2att: (B, 2, N, Dh) entity projections.
      enco: (B, N, De) entity nodes (value source).
      traj_mask: (B, N) validity.

    Returns:
      att (B, 2, Q, N), values (B, 2, Q, De), in the inputs' dtype.
    """
    logits = torch.einsum("brqd,brnd->brqn", pred2att, enti2att) / math.sqrt(
        dim_enti)
    valid = traj_mask.bool()[:, None, None, :]
    neg = torch.finfo(logits.dtype).min
    att_enti = torch.softmax(logits.masked_fill(~valid, neg), dim=-1)
    att_enti = att_enti.masked_fill(~valid, 0.0)
    att_role = torch.softmax(logits, dim=1)
    att = att_enti * att_role
    values = torch.einsum("brqn,bnd->brqd", att, enco)
    return att, values


def role_attention(pred2att, enti2att, enco, traj_mask, dim_enti: int):
    """Fused role attention in float32 (inputs are cast, as on the TPU).

    Shapes as :func:`role_attention_plain`; views are taken as they are
    (the decoder passes the halves of its projections, (B, 2, *, Dh) with
    strides).  Returns float32 ``att`` and ``values``.  CPU tensors take
    the plain version; CUDA tensors launch the kernel (and count the launch
    in ``role_attention.launches``), inside an exported program too; other
    devices raise.
    """
    if not all(x.is_floating_point() for x in (pred2att, enti2att, enco)):
        raise TypeError("role_attention: p, e and enco must be floating "
                        "point")
    if pred2att.device.type not in ("cpu", "cuda"):
        raise ValueError(f"role_attention: unsupported device "
                         f"{pred2att.device}")
    f32 = [x.to(torch.float32) for x in (pred2att, enti2att, enco)]
    return role_attention_op(*f32, traj_mask, dim_enti)


role_attention.launches = 0


def _role_attention_cpu(p, e, enco, traj_mask, dim_enti):
    """The op's CPU kernel: the plain version, its outputs contiguous as
    the fake's."""
    att, values = role_attention_plain(p, e, enco, traj_mask, dim_enti)
    return att.contiguous(), values.contiguous()


def _role_attention_cuda(p, e, enco, traj_mask, dim_enti):
    return _launch(p, e, enco, traj_mask, dim_enti)


def _role_attention_fake(p, e, enco, traj_mask, dim_enti):
    b, _, q, _ = p.shape
    return (p.new_empty((b, 2, q, e.shape[2]), dtype=torch.float32),
            p.new_empty((b, 2, q, enco.shape[2]), dtype=torch.float32))


# Registered through torch.library.Library, not torch.library.custom_op:
# the dispatcher and torch.export see the same op, without custom_op's
# Python layer around each call (PERF.md gives the wrapper's wall time a
# call under each registration).
_LIB = torch.library.Library("vidsgg_big_tpu_torch", "FRAGMENT")
_LIB.define("role_attention(Tensor p, Tensor e, Tensor enco, "
            "Tensor traj_mask, int dim_enti) -> (Tensor, Tensor)")
_LIB.impl("role_attention", _role_attention_cpu, "CPU")
_LIB.impl("role_attention", _role_attention_cuda, "CUDA")
torch.library.register_fake("vidsgg_big_tpu_torch::role_attention",
                            _role_attention_fake, lib=_LIB)
role_attention_op = torch.ops.vidsgg_big_tpu_torch.role_attention.default


def _kernel_strides(name, x):
    """The strides the kernel reads ``x`` (float32, card) through; raises
    for a layout it cannot read.  It reads rows of float32 with unit stride
    along the last dimension, a width and other strides that are multiples
    of 4, 16-byte alignment, and one video's elements within 2^31 of its
    first.  A dimension of size 1 has no stride to keep."""
    strides = [s if n > 1 else 0 for n, s in zip(x.shape, x.stride())]
    video = 1 + sum((n - 1) * s for n, s in zip(x.shape[1:], strides[1:]))
    if (x.shape[-1] % 4 or (x.shape[-1] > 1 and strides[-1] != 1)
            or any(s % 4 for s in strides[:-1]) or x.data_ptr() % 16
            or video >= 2 ** 31):
        raise ValueError(
            f"role_attention: unsupported strides {tuple(x.stride())} of "
            f"{name} {tuple(x.shape)}: the kernel reads rows of float32 "
            "with unit stride along the last dimension, a width and other "
            "strides that are multiples of 4, 16-byte alignment, and one "
            "video's elements within 2^31 of its first")
    return strides[:-1]


def _launch(p, e, c, traj_mask, dim_enti: int, splits: int = 0, lib=None):
    """Checks float32 card operands and launches the kernel of ``lib``
    (default: this checkout's) with ``splits`` blocks a query tile (0:
    :func:`de_splits`); counts the launch."""
    b, two, q, dh = p.shape
    n, de = e.shape[2], c.shape[2]
    if (two != 2 or e.shape != (b, 2, n, dh) or c.shape != (b, n, de)
            or traj_mask.shape != (b, n)):
        raise ValueError(f"role_attention: shapes p {tuple(p.shape)}, e "
                         f"{tuple(e.shape)}, enco {tuple(c.shape)}, mask "
                         f"{tuple(traj_mask.shape)} do not agree")
    if any(x.device != p.device for x in (e, c, traj_mask)):
        raise ValueError("role_attention: inputs lie on different devices")
    strides = (_kernel_strides("p", p) + _kernel_strides("e", e)
               + _kernel_strides("enco", c))
    mask = traj_mask if traj_mask.dtype in (torch.bool, torch.uint8) else \
        traj_mask != 0
    att = torch.empty((b, 2, q, n), dtype=torch.float32, device=p.device)
    values = torch.empty((b, 2, q, de), dtype=torch.float32, device=p.device)
    if b == 0 or q == 0:              # an empty grid cannot be launched
        return att, values
    lib = _library() if lib is None else lib
    if lib.role_attn_smem_bytes(n, dh) > lib.role_attn_smem_limit():
        raise ValueError(
            f"role_attention: N={n} tracklets exceed the kernel's limit of "
            f"{max_tracklets(lib, dh)} at Dh={dh} (the logits of 16 query "
            f"rows stay in {lib.role_attn_smem_limit()} bytes of shared "
            "memory)")
    if splits <= 0:
        splits = de_splits(b, q, de, _sms(p.device))
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.role_attn_launch(
            p.data_ptr(), e.data_ptr(), c.data_ptr(), mask.data_ptr(),
            att.data_ptr(), values.data_ptr(), b, q, n, dh, de, *strides,
            mask.stride(0), mask.stride(1), 1.0 / math.sqrt(dim_enti),
            splits, stream)
    if err != 0:
        raise RuntimeError(
            f"role_attention kernel launch failed (N={n}, "
            f"{lib.role_attn_smem_bytes(n, dh)} B shared memory): "
            f"{lib.role_attn_error_string(err).decode()}")
    role_attention.launches += 1
    return att, values


def max_tracklets(lib, dh: int) -> int:
    """The largest N whose shared memory fits the card at width ``dh``."""
    lo, hi = 0, 1 << 16
    limit = lib.role_attn_smem_limit()
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if lib.role_attn_smem_bytes(mid, dh) <= limit:
            lo = mid
        else:
            hi = mid - 1
    return lo


def _sms(device) -> int:
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    if index not in _sm_count:
        _sm_count[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _sm_count[index]


def _library():
    from .build import load

    return bind_library(load("role_attn"))


def bind_library(lib):
    """Declare the C signatures of a loaded role-attention library."""
    if lib.role_attn_launch.argtypes is None:
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.role_attn_launch.argtypes = [ptr] * 6 + [i32] * 5 + [i64] * 10 + [
            ctypes.c_float, i32, ptr]
        lib.role_attn_launch.restype = i32
        lib.role_attn_smem_bytes.argtypes = [i32, i32]
        lib.role_attn_smem_bytes.restype = i64
        lib.role_attn_smem_limit.argtypes = []
        lib.role_attn_smem_limit.restype = i64
        lib.role_attn_error_string.argtypes = [i32]
        lib.role_attn_error_string.restype = ctypes.c_char_p
    return lib
