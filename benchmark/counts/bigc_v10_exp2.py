"""Matmul and convolution FLOPs of one BIG-C v10 step, from the layer
equations at a batch's bucket shapes (padding counts, as the reference model
computes it), frozen with the benchmark.

Only products are counted (2 m k n each, a convolution as its im2col
product), as ``torch.utils.flop_counter.FlopCounterMode`` counts them;
elementwise work, softmaxes, norms, pooling and the triplet sort are not.
A train step counts the forward three times: the backward does twice the
forward's products.
"""
from __future__ import annotations


def _mlp(rows, dims):
    return sum(2.0 * rows * a * b for a, b in zip(dims[:-1], dims[1:]))


def _self_attention(b, length, d):
    """Packed in_proj (3 d^2 a token), the two attention products (2 L d
    each a token) and out_proj (d^2)."""
    return 2.0 * b * (4 * length * d * d + 2 * length * length * d)


def forward_flops(m: dict, b: int, n: int, t: int) -> float:
    """One forward of ``b`` videos at ``n`` tracklet slots x ``t`` frames;
    ``m`` is the configuration's ``model_config``."""
    e, dp, da, f = m["dim_enti"], m["dim_pred"], m["dim_att"], m["dim_ffn"]
    q, pool = m["num_querys"], m["enco_pool_len"]
    frames, nodes, queries = b * n * t, b * n, b * q
    t_out = (t + 2 - 3) // 2 + 1
    total = _mlp(frames, (8, e, e)) + _mlp(frames, (m["dim_feat"], e, e))
    total += 2.0 * nodes * t_out * e * 2 * e * 3
    total += _mlp(nodes, (e * pool, e, e))
    for _ in range(m["n_enco_layers"]):
        total += _self_attention(b, n, e) + _mlp(nodes, (e, f, e))
    for _ in range(m["n_deco_layers"]):
        total += _self_attention(b, q, dp)
        total += 2.0 * nodes * e * da + 2.0 * queries * dp * da
        total += 2.0 * b * 2 * q * n * (da // 2) + 2.0 * b * 2 * q * n * e
        total += 2 * _mlp(queries, (e, dp, dp)) + _mlp(queries, (dp, f, dp))
    head_in = dp + 2 * e + 2 * m["dim_clsme"]
    if m.get("dim_i3d"):
        total += 2 * _mlp(queries, (m["dim_i3d"], e))
        head_in += 2 * e
    total += _mlp(queries, (head_in, m["num_pred_cats"]))
    return total


def train_step_flops(m: dict, b: int, n: int, t: int) -> float:
    """One train step: the forward, and the backward at twice its products."""
    return 3.0 * forward_flops(m, b, n, t)
