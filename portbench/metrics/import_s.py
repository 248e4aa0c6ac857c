"""Seconds of the bulk import into the port (the configuration's
``load``: ``Field.import_bits`` and the like), on the harness's clock."""


def read(ctx):
    return ctx.import_s
