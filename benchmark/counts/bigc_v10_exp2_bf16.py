"""The FLOPs of one BIG-C v10 forward split by the dtype the port runs each
product in under ``compute_dtype`` bfloat16 with features stored in
bfloat16, frozen with the benchmark: ``TrackletEncoder.encode``'s per-frame
MLPs and temporal conv, and the head's ``fc_i3d`` on the tracklets' mean
I3D features (bfloat16 as stored), run in bfloat16; everything else
(``fc_enti2enco``, the encoder and decoder layers, role attention, the head's
last layer) in float32.  Counted as ``counts/bigc_v10_exp2.py`` counts them.
"""
from __future__ import annotations

from .bigc_v10_exp2 import _mlp, forward_flops


def bf16_flops(m: dict, b: int, n: int, t: int) -> float:
    """The bfloat16 products of one forward of ``b`` videos at ``n`` slots
    x ``t`` frames."""
    e = m["dim_enti"]
    frames, nodes, queries = b * n * t, b * n, b * m["num_querys"]
    t_out = (t + 2 - 3) // 2 + 1
    total = _mlp(frames, (8, e, e)) + _mlp(frames, (m["dim_feat"], e, e))
    total += 2.0 * nodes * t_out * e * 2 * e * 3
    if m.get("dim_i3d"):
        total += 2 * _mlp(queries, (m["dim_i3d"], e))
    return total


def forward_flops_by_dtype(m: dict, b: int, n: int, t: int) -> dict:
    """{dtype: FLOPs} of one forward; the two sum to ``forward_flops``."""
    low = bf16_flops(m, b, n, t)
    return {"bfloat16": low, "float32": forward_flops(m, b, n, t) - low}
