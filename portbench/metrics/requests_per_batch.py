"""Requests a coalescer flush over the window: the requests its flushes
carried (``batched_requests`` of the flushes of more than one, plus one
for each lone flush) over the flushes (every ``flush.<reason>``)."""


def at_window(env):
    c = dict(env.coalescer.counters)
    flushes = sum(v for k, v in c.items() if k.startswith("flush."))
    return flushes, c.get("batches", 0), c.get("batched_requests", 0)


def read(ctx):
    (f0, b0, r0), (f1, b1, r1) = ctx.snaps["requests_per_batch"]
    flushes = f1 - f0
    if flushes <= 0:
        return None
    return ((r1 - r0) + flushes - (b1 - b0)) / flushes
