"""locate_tail_ms: per call, from the end of the search kernel to the end
of the program's span ``search.locate`` around it (the flag's copy, the
wake-up of the host that waits for it, the slice), from the traced run;
each kernel placed on the host's clock as locate_head_ms places it."""

import importlib.util
from pathlib import Path

_HEAD = Path(__file__).resolve().parent / "locate_head_ms.py"


def _head():
    spec = importlib.util.spec_from_file_location("bench_metrics_head",
                                                  _HEAD)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read(run):
    got = _head().calls(run)
    if got is None:
        return None
    return sum(b - k1 for _, b, _, k1 in got) / len(got) * 1e3
