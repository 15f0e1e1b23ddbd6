"""Segment / sequence utilities: stretch-padding, pooling, fixed-shape dedup.

Port of the JAX package's ``ops/segments.py``.  ``stretch`` padding replaces
the reference's ``stack_with_repeat_2d`` (reference utils/utils_func.py:
93-121): a trajectory of L frames is padded to T frames by repeating row i
``ceil((T - i) / L)`` times.  The gather index is computed once on the host
and applied on the device, so features are stored un-stretched.

Every tensor function takes any leading batch dimensions.
"""
from __future__ import annotations

import numpy as np
import torch


def stretch_index_np(lengths, t: int):
    """Gather indices reproducing the reference repeat-padding.

    Args:
      lengths: (N,) int array of true lengths (>= 1; 0 allowed for padding
        rows, which map to index 0).
      t: target length.

    Returns:
      (N, T) int32 ``idx`` with ``stretched[n, k] = x[n, idx[n, k]]``.
    """
    lengths = np.asarray(lengths)
    n = lengths.shape[0]
    out = np.zeros((n, t), dtype=np.int32)
    k = np.arange(t)
    for i in range(n):
        L = int(lengths[i])
        if L <= 0:
            continue
        if L >= t:
            out[i] = np.minimum(k, L - 1)[:t]
            continue
        # counts[j] = ceil((t - j) / L) for j in [0, L)
        j = np.arange(L)
        counts = -(-(t - j) // L)
        csum = np.cumsum(counts)
        out[i] = np.searchsorted(csum, k, side="right").astype(np.int32)
    return out


def adaptive_max_pool1d(x, out_len: int, axis: int = -2):
    """``torch.nn.functional.adaptive_max_pool1d`` bins over any axis.

    Bin i covers [floor(i*L/out), ceil((i+1)*L/out)).  x: (..., L, ...) ->
    (..., out_len, ...).  An evenly dividing L pools as one reshape+reduce.
    """
    L = x.shape[axis]
    ax = axis % x.ndim
    if L % out_len == 0:
        shape = x.shape[:ax] + (out_len, L // out_len) + x.shape[ax + 1:]
        return torch.amax(x.reshape(shape), dim=ax + 1)
    pieces = []
    for i in range(out_len):
        s = (i * L) // out_len
        e = -(-((i + 1) * L) // out_len)
        pieces.append(torch.amax(x.narrow(ax, s, e - s), dim=ax,
                                 keepdim=True))
    return torch.cat(pieces, dim=ax)


def pack_rows(rows, limits):
    """Pack small non-negative int columns into sortable int32 key words.

    rows: (..., K) ints with rows[..., k] in [0, limits[k]).  Columns are
    grouped greedily so every word stays below 2**30 (the JAX package's
    grouping, kept so keys match it word for word); returns (..., W) int32.
    """
    words, cur, prod = [], None, 1
    cap = 1 << 30
    for k, lim in enumerate(limits):
        lim = int(lim)
        col = rows[..., k].to(torch.int32)
        if cur is None or prod * lim >= cap:
            if cur is not None:
                words.append(cur)
            cur, prod = col, lim
        else:
            cur = cur * lim + col
            prod *= lim
    words.append(cur)
    return torch.stack(words, dim=-1)


# Up to this many rows the dense O(M^2) comparison is used, above it the
# lexicographic sort; the JAX package's threshold, so both take one path.
DENSE_DEDUP_MAX = 4096


def unique_max(keys, scores, valid):
    """Deduplicate by key keeping the max-score representative (fixed shape).

    Args:
      keys: (..., M, W) int32 group ids (multi-word keys from
        :func:`pack_rows` are compared lexicographically).
      scores: (..., M) float; within a key group the max-score element wins
        (score ties: lowest index).
      valid: (..., M) bool; invalid elements never win and never suppress.

    Returns:
      keep: (..., M) bool, True for the single winner of each valid group.
    """
    if keys.shape[-2] <= DENSE_DEDUP_MAX:
        return _unique_max_dense(keys, scores, valid)
    return _unique_max_sort(keys, scores, valid)


def _unique_max_dense(keys, scores, valid):
    m = keys.shape[-2]
    eq = torch.all(keys[..., :, None, :] == keys[..., None, :, :], dim=-1)
    eq = eq & valid[..., :, None] & valid[..., None, :]
    idx = torch.arange(m, device=keys.device)
    s_other, s_self = scores[..., None, :], scores[..., :, None]
    better = eq & ((s_other > s_self) |
                   ((s_other == s_self) & (idx[None, :] < idx[:, None])))
    return valid & ~better.any(-1)


def _unique_max_sort(keys, scores, valid):
    big = torch.iinfo(keys.dtype).max
    k = torch.where(valid[..., None], keys, torch.full_like(keys, big))
    # lexsort by stable passes, least significant first: -score, then the
    # key words minor -> major (ties keep the lowest index, as jnp.lexsort)
    order = torch.argsort(-scores, dim=-1, stable=True)
    for w in range(k.shape[-1] - 1, -1, -1):
        kw = torch.gather(k[..., w], -1, order)
        order = torch.gather(order, -1,
                             torch.argsort(kw, dim=-1, stable=True))
    ks = torch.gather(k, -2, order[..., None].expand(k.shape))
    first = torch.ones(ks.shape[:-2] + (1,), dtype=torch.bool,
                       device=ks.device)
    head = torch.cat([first, (ks[..., 1:, :] != ks[..., :-1, :]).any(-1)],
                     dim=-1)
    head = head & (ks[..., 0] != big)
    return torch.zeros_like(valid).scatter(-1, order, head)


def stretch_counts(lengths, t: int):
    """Repeat counts of each source row under the stretch gather.

    counts[..., l] = #{k : stretch_index(lengths, t)[..., k] == l}; rows sum
    to t for lengths >= 1.  Lets a mean over the *stretched* axis be a
    counts-weighted mean over the raw axis without the gather.
    """
    L = torch.clamp(lengths, min=1)[..., None]                # (..., 1)
    j = torch.arange(t, device=lengths.device)
    counts = torch.where(j < L, -(-(t - j) // L), torch.zeros_like(j))
    return torch.where(L >= t, (j < t).to(counts.dtype), counts)


def stretch_weighted_mean(x, lengths, t: int | None = None):
    """Mean of ``stretch(x)`` over the time axis, computed without the gather.

    x: (..., T, D); lengths: (...,).  Weights are float32 (counts reach T);
    a low-precision float ``x`` keeps its dtype, as in the JAX package.
    """
    t = t if t is not None else x.shape[-2]
    w = stretch_counts(lengths, t).to(torch.float32) / t       # (..., T)
    if not torch.is_floating_point(x):
        x = x.to(torch.float32)
    else:
        w = w.to(x.dtype)
    return torch.einsum("...td,...t->...d", x, w)


def stretch_conv_src(idx, t: int, kernel_size: int = 3, stride: int = 2,
                     pad: int = 1):
    """(N, T_out, k) stretched source row per conv tap; -1 = zero pad."""
    t_out = (t + 2 * pad - kernel_size) // stride + 1
    cols = (stride * torch.arange(t_out, device=idx.device)[:, None]
            + torch.arange(kernel_size, device=idx.device)[None, :] - pad)
    valid = (cols >= 0) & (cols < t)
    src = idx[:, cols.clamp(0, t - 1)]                         # (N, To, k)
    return torch.where(valid[None], src, torch.full_like(src, -1))


def stretch_conv_patches(x, idx, kernel_size: int = 3, stride: int = 2,
                         pad: int = 1):
    """Patches of ``conv(stretch(x))`` without materializing the stretch.

    A k=3 s=2 p=1 conv over the repeat-stretched sequence reads stretched
    columns (s*j - 1, s*j, s*j + 1) for output j; composed with the stretch
    gather that is one row gather per tap.  The JAX package applies it as a
    one-hot matmul (which suits the TPU's matrix unit); here it is an exact
    gather, with index -1 reading an appended zero row.  Both select rows
    without arithmetic, so the results are bit-identical.

    Args:
      x:   (N, T, D) raw rows.
      idx: (N, T) stretch gather index (see :func:`stretch_index_np`).

    Returns:
      (N, T_out, kernel_size * D) patches in (tap, channel) order, matching
      a (k, D, F) conv kernel reshaped to (k*D, F).
    """
    n, t, d = x.shape
    src = stretch_conv_src(idx, t, kernel_size, stride, pad)   # (N, To, k)
    x_pad = torch.cat([x, x.new_zeros(n, 1, d)], dim=1)
    src = torch.where(src < 0, torch.full_like(src, t), src).long()
    rows = torch.arange(n, device=x.device)[:, None, None]
    return x_pad[rows, src].reshape(n, src.shape[1], kernel_size * d)
