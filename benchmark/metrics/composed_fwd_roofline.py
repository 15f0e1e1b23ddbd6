"""The composed inference forward (``csrc/composed_attn.cu``,
``TRAIN=false``): the frozen bound of one call over its device time a
launch in the trace."""
from benchmark.metrics._readers import roofline


def read(run):
    return roofline(run, "composed_fwd",
                    [r"composed_attn_f32_kernel<(false|\(bool\)0)>"])
