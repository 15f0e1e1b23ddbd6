"""Fused role-factored bipartite attention: CUDA kernel and plain version.

The BIG-C decoder's signature op (reference models/model_0v10.py:196-214),
ported from the TPU kernel in ``vidsgg_big_tpu/ops/pallas_role_attn.py``.
For each of 2 roles r, attention logits between predicate queries and entity
nodes, the *product* of a softmax over entities and a softmax over roles,
then the value matmul against the entity nodes:

  logits[r, q, n] = <p[r, q], e[r, n]> / sqrt(dim_enti)
  att = softmax_n(mask(logits)) * softmax_r(logits)
  values[r, q, :] = att[r, q, :] @ enco

``role_attention`` launches the kernel of ``csrc/role_attn.cu`` for CUDA
tensors and uses :func:`role_attention_plain` for CPU tensors; it never
falls back from the card to the plain version.
"""
from __future__ import annotations

import ctypes
import math

import torch


def role_attention_flops(b: int, q: int, n: int, dh: int, de: int) -> float:
    """Matmul FLOPs of one call: logits p e^T (2*Q*N*Dh) and values
    att enco (2*Q*N*De) per video and role."""
    return 2.0 * b * (2.0 * q * n * dh + 2.0 * q * n * de)


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

    Shapes as :func:`role_attention_plain`; returns float32 ``att`` and
    ``values``.  CPU tensors take the plain version; CUDA tensors launch
    the kernel (and count the launch in ``role_attention.launches``).
    """
    if not all(x.is_floating_point() for x in (pred2att, enti2att, enco)):
        raise TypeError("role_attention: p, e and enco must be floating "
                        "point")
    f32 = [x.to(torch.float32) for x in (pred2att, enti2att, enco)]
    if pred2att.device.type == "cpu":
        return role_attention_plain(*f32, traj_mask, dim_enti)
    if pred2att.device.type != "cuda":
        raise ValueError(f"role_attention: unsupported device "
                         f"{pred2att.device}")
    p, e, c = f32
    b, two, q, dh = p.shape
    n, de = e.shape[2], c.shape[2]
    if (two != 2 or e.shape != (b, 2, n, dh) or c.shape != (b, n, de)
            or traj_mask.shape != (b, n)):
        raise ValueError(f"role_attention: shapes p {tuple(p.shape)}, e "
                         f"{tuple(e.shape)}, enco {tuple(c.shape)}, mask "
                         f"{tuple(traj_mask.shape)} do not agree")
    if any(x.device != p.device for x in (e, c, traj_mask)):
        raise ValueError("role_attention: inputs lie on different devices")
    if not all(x.is_contiguous() for x in f32):
        raise ValueError("role_attention: inputs must be contiguous")
    mask = traj_mask.to(torch.int32).contiguous()
    att = torch.empty((b, 2, q, n), dtype=torch.float32, device=p.device)
    values = torch.empty((b, 2, q, de), dtype=torch.float32, device=p.device)
    if b == 0 or q == 0:              # an empty grid cannot be launched
        return att, values
    lib = _library()
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.role_attn_forward(
            p.data_ptr(), e.data_ptr(), c.data_ptr(), mask.data_ptr(),
            att.data_ptr(), values.data_ptr(), b, q, n, dh, de,
            1.0 / math.sqrt(dim_enti), stream)
    if err != 0:
        raise RuntimeError(
            f"role_attention kernel launch failed (N={n}, "
            f"{lib.role_attn_smem_bytes(n)} B shared memory): "
            f"{lib.role_attn_error_string(err).decode()}")
    role_attention.launches += 1
    return att, values


role_attention.launches = 0


def _library():
    from .build import load

    lib = load("role_attn")
    if lib.role_attn_forward.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.role_attn_forward.argtypes = [ptr] * 6 + [i32] * 5 + [
            ctypes.c_float, ptr]
        lib.role_attn_forward.restype = i32
        lib.role_attn_smem_bytes.argtypes = [i32]
        lib.role_attn_smem_bytes.restype = ctypes.c_longlong
        lib.role_attn_error_string.argtypes = [i32]
        lib.role_attn_error_string.restype = ctypes.c_char_p
    return lib
