"""Role attention (``csrc/role_attn.cu``): the frozen bound of one call over
its device time a launch in the trace."""
from benchmark.metrics._readers import roofline


def read(run):
    return roofline(run, "role_attention", [r"role_attn_kernel"])
