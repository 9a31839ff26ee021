"""locate_overhead_ms: per call, the harness's host span around the call
(checks, fill, launch, flag read-back) less the search kernel's device
time, from the traced run."""

KERNEL = "locate_kernel"


def read(run):
    if run.trace is None or run.calls <= 0:
        return None
    kernel_s = run.trace.device_s_matching(KERNEL)
    if kernel_s <= 0:
        return None
    return (run.host_call_s - kernel_s) / run.calls * 1e3
