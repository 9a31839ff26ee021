"""queries_per_s: patterns answered in all batches completed in the window,
over the window's seconds by the host's clock (first call issued to the
last call's return)."""


def read(run):
    if run.window_s <= 0 or run.queries <= 0:
        return None
    return run.queries / run.window_s
