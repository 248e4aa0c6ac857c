"""Share (%) of the calls answered in the window that the batch path ran
in a ``mega_interpret`` launch: the change of ``Executor.mega_queries``
over the calls answered."""


def at_window(env):
    return env.executor.mega_queries


def read(ctx):
    a, b = ctx.snaps["mega_calls_share"]
    if not ctx.calls_answered:
        return None
    return 100.0 * (b - a) / ctx.calls_answered
