"""Host ms of a serving flush that is not the wait for the device: span
``hnsw.serve.flush`` less its child ``hnsw.search.wait``, per flush of the
traced part."""

from portbench import spans


def read(ctx):
    return spans.host_ms(ctx, "hnsw.serve.flush")
