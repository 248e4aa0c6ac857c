"""Seconds of the warm-up requests, which build the device banks (and
the positions bank) on their first use, on the harness's clock."""


def read(ctx):
    return ctx.warm_s
