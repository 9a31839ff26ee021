"""batch_p95_ms: the 95th percentile, over every call in the window, of
the time from issuing the call to its return (the call synchronises on
its flag), by the host's clock around the call."""

import numpy as np


def read(run):
    if len(run.batch_ms) < 20:  # fewer than one sample beyond the p95
        return None
    return float(np.percentile(np.asarray(run.batch_ms), 95))
