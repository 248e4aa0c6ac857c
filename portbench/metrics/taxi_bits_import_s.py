"""Seconds in ``Fragment.import_bits`` (the set fields' and the
existence row's bulk imports, ``core/fragment.py``) by the window's
open: the holder's summed counter (``Holder.import_stats``), not the
span ring, which may have let the set-up's roots go. A program without
the counter reads nothing."""


def at_window(env):
    stats = getattr(env.api.holder, "import_stats", None)
    return stats()["seconds"] if stats is not None else None


def read(ctx):
    return ctx.snaps["taxi_bits_import_s"][0]
