"""The grounding convs' kernel (``csrc/dwsep_conv.cu``, float32 serving):
the frozen bounds of a request's 27 calls (``counts/kernels.
dwsep_conv_bound``) over the device time of the kernel's launches in the
trace, in percent.  The calls, as the model makes them: the QANet blocks'
four convs each over the clips (k 7), the query words (k 3) and the (query,
clip) rows (k 7), each with ReLU and residual and, but for the words, the
clip mask; each of the three heads' four (k 3, ReLU, mask) and its last
(k 3, 2K or K channels out, nothing fused).  The calls' shapes differ, so
the launches in the trace are priced at their mean bound."""
from benchmark.counts.kernels import dwsep_conv_bound

PATTERN = r"dwsep_conv_kernel"


def request_bounds(m: dict, traffic: dict) -> list:
    """The bound of each of a request's calls, in seconds."""
    b, q, t = traffic["batch"], traffic["queries"], traffic["clips"]
    h, k = m["dim_hidden"], m["num_bins"]
    # (rows, length, channels out, kernel, residual, mask)
    calls = 4 * [(b, t, h, 7, True, True)] + \
        4 * [(b * q, 3, h, 3, True, False)] + \
        4 * [(b * q, t, h, 7, True, True)]
    for out in (2 * k, k, k):
        calls += 4 * [(b * q, t, h, 3, False, True)] + \
            [(b * q, t, out, 3, False, False)]
    return [dwsep_conv_bound(rows, length, h, co, kk, res, mask)
            for rows, length, co, kk, res, mask in calls]


def read(run):
    if run.kind != "serve" or run.trace is None:
        return None
    launches = run.trace.kernels(PATTERN)
    if not launches:
        return None
    bounds = request_bounds(run.work.m, run.work.traffic)
    mean = sum(bounds) / len(bounds)
    return 100.0 * mean * len(launches) / sum(s for _, s in launches)
