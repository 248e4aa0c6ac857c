"""Median queue wait (ms) of the requests due in the window: each
``Coalescer.queue`` span (a request's enqueue to the start of the flush
that serves it) under an ``HTTP.request`` root that started in the
window, from the server's tracer ring."""

from portbench import spans


def at_window(env):
    return spans.mark(env)


def read(ctx):
    got = spans.window_roots(ctx.snaps.get("queue_wait_ms"))
    if got is None:
        return None
    roots, t_open, t_close = got
    reqs = [r for r in roots
            if r.name == "HTTP.request" and t_open <= r.start < t_close]
    waits = [spans.duration(s) for s in spans.walk(reqs)
             if s.name == "Coalescer.queue"]
    m = spans.median(waits)
    return None if m is None else m * 1e3
