"""Device ms of the level-0 beam stage (span ``hnsw.build.beams``: the
beam search and the batch's own nearest neighbours) per replayed insert
batch of the traced ``add()``, from CUDA events between its graphs."""

from portbench import spans


def read(ctx):
    return spans.device_ms(ctx, "hnsw.build.beams")
