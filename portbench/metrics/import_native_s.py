"""Seconds of the import builder before the window's open: the summed
``Bitmap.importBatch`` spans (the C++ builder and the merge of its
containers, ``storage/roaring.py`` ``import_batch``) closed by then,
from the server's tracer ring."""

from portbench import spans


def at_window(env):
    return spans.mark(env)


def read(ctx):
    roots = spans.setup_roots(ctx.snaps.get("import_native_s"))
    if roots is None:
        return None
    batches = spans.outermost(roots, "Bitmap.importBatch")
    return sum(map(spans.duration, batches)) if batches else None
