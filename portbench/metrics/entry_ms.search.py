"""Device ms of a search's entry phase (span ``hnsw.search.entry``: the
entry-point scan and its rescore), from CUDA events between the replayed
graphs of a ``with_stats`` search, averaged over the traced part's
searches."""

from portbench import spans


def read(ctx):
    return spans.device_ms(ctx, "hnsw.search.entry")
