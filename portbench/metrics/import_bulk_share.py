"""Share (%) of the set imports that reached the import builder's sort
path (the C++ dense builder declined them) and took its batch path,
recounting no row: their rows' counts came from the builder, or the
cache wanted none (``core/fragment.py`` ``Fragment.import_bits``), by
the window's open: the holder's summed ``batch_calls`` over
``sorted_calls`` (``Holder.import_stats``). A program without those
counters, or a set-up that sorted no import, reads nothing."""


def at_window(env):
    stats = getattr(env.api.holder, "import_stats", None)
    return stats() if stats is not None else None


def read(ctx):
    stats = ctx.snaps["import_bulk_share"][0]
    if not stats or not stats["sorted_calls"]:
        return None
    return 100.0 * stats["batch_calls"] / stats["sorted_calls"]
