"""Share (%) of the traced part of the window in which no kernel, copy or
fill ran on the card, from the profiler's CUDA activity."""


def read(ctx):
    if ctx.events is None or ctx.window_ns is None:
        return None
    lo, hi = ctx.window_ns
    busy = ctx.events.busy_ns(lo, hi)
    if busy == 0:
        return None  # no device activity traced: nothing to read
    return 100.0 * (1 - busy / (hi - lo))
