"""Share (%) of the GroupBy calls run in the window whose frontier
outgrew the executor's device budget and went to host memory: the
change of ``Executor.groupby_spill_events`` over the change of
``Executor.groupby_calls``. A program without those counters, or a
window with no GroupBy run, reads nothing."""


def at_window(env):
    ex = env.executor
    return (getattr(ex, "groupby_spill_events", None),
            getattr(ex, "groupby_calls", None))


def read(ctx):
    (s0, c0), (s1, c1) = ctx.snaps["groupby_spill_share"]
    if None in (s0, c0, s1, c1) or c1 <= c0:
        return None
    return 100.0 * (s1 - s0) / (c1 - c0)
