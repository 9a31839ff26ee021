"""build_peak_gib: torch.cuda.max_memory_allocated over build_index alone,
after reset_peak_memory_stats, in GiB (the genome the build is given
included)."""


def read(run):
    b = run.spans.get("build_peak_bytes")
    return None if b is None else b / 2 ** 30
