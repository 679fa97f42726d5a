"""Device ms of a search's rerank phase (span ``hnsw.search.rerank``: the
exact rerank of the final buffer and the top-k), from CUDA events between
the replayed graphs of a ``with_stats`` search, averaged over the traced
part's searches."""

from portbench import spans


def read(ctx):
    return spans.device_ms(ctx, "hnsw.search.rerank")
