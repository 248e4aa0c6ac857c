"""90th percentile latency of every request due in the window, from
when it was due to its last byte read on the client (a late send counts
its lateness; one percentile over all of them). The highest percentile
with at least ten requests beyond it in a window of 100 or more. Read in
a traced run, so the profiler's cost is in the part of the window it
covers."""

import numpy as np


def read(ctx):
    lat = [r["t_done"] - r["t_due"] for r in ctx.records]
    return float(np.percentile(lat, 90)) * 1e3 if lat else None
