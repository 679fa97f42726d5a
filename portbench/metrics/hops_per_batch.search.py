"""Level-0 hops a search batch ran (``SearchStats.hops``), averaged over
the window's batches (traced runs search with ``with_stats``)."""


def read(ctx):
    c = ctx.counters
    if not c.get("batches") or "hops" not in c:
        return None
    return c["hops"] / c["batches"]
