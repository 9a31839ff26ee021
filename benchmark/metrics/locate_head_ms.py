"""locate_head_ms: per call, from the start of the program's span
``search.locate`` to the start of the search kernel (checks, the flag's
allocation and fill, the launch and the card's start), from the traced run.

The profiler puts device intervals on the host's clock with an offset that
can jump by tenths of a millisecond within a window, so a kernel is not
found by its place in the trace: the calls' kernels are taken in order, one
a call, and each is kept where the trace puts it only as far as causality
allows. It starts no earlier than its launch call (``cudaLaunchKernel``)
starts and ends no later than the copy call that waits for it
(``cudaMemcpyAsync``) ends, both host events inside the span; a kernel
outside that window is moved to its nearest edge, its duration kept."""

import bisect

SPAN = "search.locate"
KERNEL = "locate_kernel"
LAUNCH = "cudaLaunchKernel"
WAIT = "cudaMemcpyAsync"


def calls(run):
    """``(span start, span end, kernel start, kernel end)`` of each call, the
    kernel placed on the host's clock as above; None without a trace, when
    the spans or the kernels are not one a call, or when a span holds no
    launch call or no copy call."""
    if run.trace is None or run.calls <= 0:
        return None
    host = run.trace.host
    spans = [(a, b) for name, a, b in host if name == SPAN]
    kernels = [(a, b) for name, a, b in run.trace.device if KERNEL in name]
    if len(spans) != run.calls or len(kernels) != run.calls:
        return None
    starts = [a for _, a, _ in host]
    out = []
    for (a, b), (k0, k1) in zip(spans, kernels):
        inside = host[bisect.bisect_left(starts, a):
                      bisect.bisect_right(starts, b)]
        launch = [h for h in inside if h[0] == LAUNCH]
        wait = [h for h in inside if h[0] == WAIT]
        if not launch or not wait:
            return None
        shift = min(max(0.0, launch[-1][1] - k0), wait[-1][2] - k1)
        out.append((a, b, k0 + shift, k1 + shift))
    return out


def read(run):
    got = calls(run)
    if got is None:
        return None
    return sum(k0 - a for a, _, k0, _ in got) / len(got) * 1e3
