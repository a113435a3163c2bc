"""Step driver: the CUDA runtime's kernel-launch calls (the profiler's
*LaunchKernel events) over the traced slice, per step: the step, the host
read and the diagnostics together."""

UNIT = "launches/step"


def read(run):
    if run.trace is None or not run.trace["steps"] or not run.trace["launches"]:
        return None
    return run.trace["launches"] / run.trace["steps"]
