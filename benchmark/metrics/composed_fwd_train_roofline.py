"""The composed train forward with dropout (``csrc/composed_attn.cu``,
``TRAIN=true``): the frozen bound of one call over its device time a
launch in the trace."""
from benchmark.metrics._readers import roofline


def read(run):
    return roofline(run, "composed_fwd_train",
                    [r"composed_attn_f32_kernel<(true|\(bool\)1)>"])
