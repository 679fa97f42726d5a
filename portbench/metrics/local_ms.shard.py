"""Device ms of a sharded search's local phase (phase span
``hnsw.shard.local``: the rank's own shard search and its id map), from
CUDA events between the phases of each search in the traced part, a
search on each card, averaged over the cards."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.busy_s:
        return None
    per = []
    for r in ctx.counters.get("shard") or []:
        n, ms = (r.get("device") or {}).get("hnsw.shard.local", (0, 0.0))
        if n:
            per.append(ms / n)
    return sum(per) / len(per) if per else None
