"""Share (%) of the calls answered in the taxi cell's window that the
batch path ran in a ``mega_interpret`` launch, read as
``mega_calls_share`` reads it: the change of ``Executor.mega_queries``
over the calls answered."""

from portbench.metrics.mega_calls_share import at_window  # noqa: F401


def read(ctx):
    a, b = ctx.snaps["taxi_mega_calls_share"]
    if not ctx.calls_answered:
        return None
    return 100.0 * (b - a) / ctx.calls_answered
