"""Device ms of a sharded search's exchange on rank 0's card (phase span
``hnsw.shard.gather``: the ``all_gather`` of every shard's top-k, with the
wait for the slowest rank), from CUDA events between the phases of each
search in the traced part, a search."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.busy_s:
        return None
    every = ctx.counters.get("shard") or []
    if not every:
        return None
    n, ms = (every[0].get("device") or {}).get("hnsw.shard.gather",
                                                (0, 0.0))
    return ms / n if n else None
