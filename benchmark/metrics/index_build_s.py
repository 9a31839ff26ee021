"""index_build_s: the harness's span around build_index, ending in a
synchronise."""


def read(run):
    return run.spans.get("index_build_s")
