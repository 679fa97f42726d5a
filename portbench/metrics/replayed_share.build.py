"""Insert batches replayed from a captured CUDA graph, as a share of all
the window's insert batches, in % (each ``add()``'s
``StagedBuild.stats()``)."""


def read(ctx):
    st = ctx.counters.get("build_stats")
    if not st:
        return None
    batches = sum(s.get("batches", 0) for s in st)
    if not batches:
        return None
    return 100.0 * sum(s.get("replayed", 0) for s in st) / batches
