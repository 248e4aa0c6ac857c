"""Seconds of the device banks' cold builds and patches before the
window's open: the summed outermost ``Bank.build`` spans (the positions
bank and the dense banks, each a gather and an upload) closed by then,
from the server's tracer ring."""

from portbench import spans


def at_window(env):
    return spans.mark(env)


def read(ctx):
    roots = spans.setup_roots(ctx.snaps.get("bank_build_s"))
    if roots is None:
        return None
    builds = spans.outermost(roots, "Bank.build")
    return sum(map(spans.duration, builds)) if builds else None
