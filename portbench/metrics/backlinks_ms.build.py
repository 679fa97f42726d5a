"""Device ms of the level-0 back-link repair stage (span
``hnsw.build.backlinks``: ``apply_backlinks``) per replayed insert batch of
the traced ``add()``, from CUDA events between its graphs."""

from portbench import spans


def read(ctx):
    return spans.device_ms(ctx, "hnsw.build.backlinks")
