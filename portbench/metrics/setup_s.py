"""Seconds from the interpreter's start to the window's open: data,
import, server, load generator, warm-up (and, in a checkout's first
run, the kernels' build)."""


def read(ctx):
    return ctx.setup_s
