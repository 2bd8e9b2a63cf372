"""The 95th percentile, in ms, of the whole call's time, from its call to
its return, over every call made with no profiler running (``run.untraced``:
in a traced run, those after the trace stopped)."""

import numpy as np


def read(run):
    lat = [c.t_ret - c.t_call for c in run.untraced]
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
