"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W power limit), frozen with the benchmark.

float32 products in this benchmark run with TF32 off, so their fastest
exact route on the card is 3xTF32 on the tensor cores: three TF32 products
for one float32 product, 495 / 3 = 165 TFLOP/s, above the CUDA cores' 67.
That is the float32 peak of every roofline and ``mfu`` metric, so no float32
kernel can read over 100% of it.
"""
from __future__ import annotations

PEAK_BYTES_S = 3.35e12          # HBM3
PEAK_BF16_FLOP_S = 989e12       # tensor cores, dense
PEAK_TF32_FLOP_S = 495e12       # tensor cores, dense
PEAK_F32_CORE_FLOP_S = 67e12    # CUDA cores
PEAK_F32_FLOP_S = PEAK_TF32_FLOP_S / 3


def peak_flop_s(dtype: str) -> float:
    """The peak FLOP/s of products in ``dtype`` ("float32" or "bfloat16")."""
    if dtype == "bfloat16":
        return PEAK_BF16_FLOP_S
    if dtype == "float32":
        return PEAK_F32_FLOP_S
    raise ValueError(f"no peak for {dtype!r}")


def bound_seconds(flop: float, nbytes: float, dtype: str) -> float:
    """The least time a call can take: the larger of its operations at the
    dtype's peak and its bytes at the memory peak."""
    return max(flop / peak_flop_s(dtype), nbytes / PEAK_BYTES_S)
