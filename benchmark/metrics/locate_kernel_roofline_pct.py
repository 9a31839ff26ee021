"""locate_kernel_roofline_pct: the least time of a batch's work over the
search kernel's device time per call, in %.  The least time is the larger
of the bytes over the card's memory bandwidth, the integer operations
over its integer lanes' rate and the popcounts over theirs (peaks.json),
the work counted by counts/locate.py
from the inputs and the table sizes alone, averaged over the calls."""

import importlib.util
from pathlib import Path

KERNEL = "locate_kernel"
_COUNTS = Path(__file__).resolve().parent.parent / "counts" / "locate.py"


def _counts():
    spec = importlib.util.spec_from_file_location("bench_counts_locate",
                                                  _COUNTS)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read(run):
    if run.trace is None or not run.work or run.peak is None:
        return None
    kernel_s = run.trace.device_s_matching(KERNEL)
    if kernel_s <= 0 or run.calls <= 0:
        return None
    counts = _counts()
    n = int(run.config["genome_length"])
    rate = int(run.config["sa_sample_rate"])
    least = 0.0
    for w, k in zip(run.work, run.calls_per_batch):
        least += k * counts.least_seconds(
            *counts.work(n=n, sa_rate=rate, **w), run.peak)[0]
    return 100.0 * least / kernel_s
