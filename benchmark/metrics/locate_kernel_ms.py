"""locate_kernel_ms: the search kernel's device time per call, from the
profiler's trace (every device operation whose name holds the kernel's)."""

KERNEL = "locate_kernel"


def read(run):
    if run.trace is None or run.calls <= 0:
        return None
    s = run.trace.device_s_matching(KERNEL)
    return s / run.calls * 1e3 if s > 0 else None
