"""Median over the probes of the least time the card could take for a
probe, its least bytes (counted by its configuration's kind from the
query's meaning) over the card's published HBM rate, as a share (%) of
the device time the profiler attributes to the probe (every kernel,
copy and fill that started while it was served alone)."""

import numpy as np


def read(ctx):
    if not ctx.hbm_bytes_per_s:
        return None
    shares = [100.0 * least / ctx.hbm_bytes_per_s / dev
              for least, dev in ctx.probes if dev > 0]
    return float(np.median(shares)) if shares else None
