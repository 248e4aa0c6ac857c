"""Median duration (ms) of the GroupBy calls the executor ran in the
window: the outermost ``Executor.groupBy`` spans that closed between the
window's open and close, from the server's tracer ring. A program
without that span reads nothing."""

from portbench import spans


def at_window(env):
    return spans.mark(env)


def read(ctx):
    got = spans.window_roots(ctx.snaps.get("groupby_ms"))
    if got is None:
        return None
    roots, t_open, t_close = got
    calls = [spans.duration(s) for s in spans.outermost(roots,
                                                         "Executor.groupBy")
             if t_open <= s.end <= t_close]
    m = spans.median(calls)
    return None if m is None else m * 1e3
