"""Median latency of every request due in the window, from when it was
due to its last byte read on the client (a late send counts its
lateness; one percentile over all of them). Read in a traced run, so the
profiler's cost is in the part of the window it covers."""

import numpy as np


def read(ctx):
    lat = [r["t_done"] - r["t_due"] for r in ctx.records]
    return float(np.percentile(lat, 50)) * 1e3 if lat else None
