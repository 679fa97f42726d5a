"""Host ms of an ``add()``'s planning (span ``hnsw.build.plan``: the
level draw, the batch schedule and its staging copies) per ``add()`` of the
traced part."""

from portbench import spans


def read(ctx):
    return spans.span_ms(ctx, "hnsw.build.plan", per="hnsw.build.plan")
