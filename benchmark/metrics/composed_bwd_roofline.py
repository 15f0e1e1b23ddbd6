"""The composed backward (``csrc/composed_attn_bwd.cu``): the frozen bound
of one call over the device time of its dq and dk/dv kernels a call."""
from benchmark.metrics._readers import roofline


def read(run):
    return roofline(run, "composed_bwd",
                    [r"composed_attn_bwd_dq_f32_kernel",
                     r"composed_attn_bwd_dkv_f32_kernel"])
