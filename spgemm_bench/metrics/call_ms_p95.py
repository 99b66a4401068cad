"""call_ms_p95: the 95th percentile of every call's latency in the window,
from entering the program to the synchronize of its output (numpy's
linear interpolation between order statistics)."""
import numpy as np


def read(ctx):
    return float(np.percentile(np.asarray(ctx.latencies_s), 95)) * 1e3
