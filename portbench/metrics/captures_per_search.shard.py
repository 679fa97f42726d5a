"""CUDA graph captures of searches (the program's counter
``captures.search``) from the window's start to its end, summed over the
ranks, over the window's searches. Once the warm-up has captured, a
search replays: 0."""


def read(ctx):
    every = ctx.counters.get("shard") or []
    searches = ctx.counters.get("batches")
    if not every or not searches or any(r.get("counters") is None
                                        for r in every):
        return None
    return sum(r["counters"].get("captures.search", 0)
               for r in every) / searches
