"""locate_launch_ms: the mean duration of the program's span
``search.locate.launch`` (the kernel library's handle, the arguments'
marshalling, the launcher's attribute and occupancy queries, the launch and
its check), one a call, from the traced run."""

SPAN = "search.locate.launch"


def read(run):
    if run.trace is None or run.calls <= 0:
        return None
    spans = [b - a for name, a, b in run.trace.host if name == SPAN]
    if len(spans) != run.calls:
        return None
    return sum(spans) / len(spans) * 1e3
