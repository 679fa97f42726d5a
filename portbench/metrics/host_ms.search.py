"""Host ms of ``HnswIndex.search`` that is not the wait for the device: span
``hnsw.search`` less its child ``hnsw.search.wait``, per search of the
traced part."""

from portbench import spans


def read(ctx):
    return spans.host_ms(ctx, "hnsw.search")
