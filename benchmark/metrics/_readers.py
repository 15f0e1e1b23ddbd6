"""Arithmetic shared by the per-layer metrics' readers.  Each reader returns
None where its run has nothing to read (another kind of step, a kernel the
window does not launch), and the harness then leaves the metric out."""
from benchmark.counts.peaks import peak_flop_s


def mfu(run, kind):
    """The step's FLOPs over (the measured window's time per step x the
    dtype's peak), in percent."""
    if run.kind != kind or not run.steps:
        return None
    per_step = run.window_s / run.steps
    return 100.0 * run.work.flops_per_step / (
        per_step * peak_flop_s(run.work.dtype))


def kernels_per_step(run, kind):
    if run.kind != kind or run.trace is None:
        return None
    return len(run.trace.kernels()) / run.traced_steps


def idle_share(run, kind):
    """1 minus the device's busy seconds a step, from the device's traced
    pass (CUDA activity alone), over the measured window's seconds a step,
    in percent.  The denominator is the untraced window's, so the
    profiler's own cost on the host, which stretches a launch-bound step
    by half, does not read as idle time."""
    if run.kind != kind or run.trace is None or not run.steps:
        return None
    busy = run.trace.busy_s / run.traced_steps
    return 100.0 * (1.0 - busy / (run.window_s / run.steps))


def roofline(run, role, patterns):
    """The frozen bound of one call of kernel ``role`` over its device time
    a call in the trace, in percent.  ``patterns``: the kernel names that
    make up one call (the backward's dq and dk/dv kernels); the number of
    calls is the launches of the first."""
    bound = run.work.kernel_bounds.get(role)
    if bound is None or run.trace is None:
        return None
    launches = run.trace.kernels(patterns[0])
    if not launches:
        return None
    seconds = sum(s for p in patterns for _, s in run.trace.kernels(p))
    return 100.0 * bound * len(launches) / seconds
