"""The whole bfloat16 serve step's share of the card's peaks
(``counts/peaks.py``): each product of the frozen count priced at the peak
of the dtype the port runs it in (``counts/bigc_v10_exp2_bf16.py``: the
encoder's per-frame products in bfloat16, the rest in float32), over the
measured window's seconds a step."""
from benchmark.counts.peaks import peak_flop_s


def read(run):
    """The least time of one step at the peaks, the sum over dtypes of the
    frozen FLOPs in that dtype (``work.flops_by_dtype``) over its peak, as
    a share of the measured window's seconds a step, in percent."""
    flops = getattr(run.work, "flops_by_dtype", None)
    if run.kind != "serve" or not run.steps or not flops:
        return None
    least = sum(f / peak_flop_s(dtype) for dtype, f in flops.items())
    return 100.0 * least / (run.window_s / run.steps)
