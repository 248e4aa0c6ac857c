"""Share (%) of the traced part of the window in which no kernel, copy
or fill ran on the card while the server was running the executor: the
union of the spans that run it (``spans.EXECUTOR_SPANS``: the
coalescer's flush and drain, a direct-path ``API.Query``), less the
profiler's device activity, joined on the wall clock."""

from portbench import devtrace, spans


def at_window(env):
    return spans.mark(env)


def read(ctx):
    if ctx.events is None or ctx.window_ns is None:
        return None
    got = spans.window_roots(ctx.snaps.get("idle_host_busy_share"))
    if got is None:
        return None
    lo, hi = ctx.window_ns
    host = spans.union([
        (max(a, lo), min(b, hi)) for a, b in (
            spans.span_ns(s) for s in spans.walk(got[0])
            if s.name in spans.EXECUTOR_SPANS)])
    if not host or not ctx.events.device:
        return None
    idle = spans.minus(host, devtrace.merged(ctx.events.device, lo, hi))
    return 100.0 * sum(b - a for a, b in idle) / (hi - lo)
