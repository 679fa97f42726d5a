"""Device ms of a search's hops phase (span ``hnsw.search.hops``: the
level-0 beam), from CUDA events between the replayed graphs of a
``with_stats`` search, averaged over the traced part's searches."""

from portbench import spans


def read(ctx):
    return spans.device_ms(ctx, "hnsw.search.hops")
