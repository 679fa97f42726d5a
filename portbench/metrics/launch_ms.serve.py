"""Host ms of CUDA graph launches (span ``hnsw.graph.launch``) per serving
flush (span ``hnsw.serve.flush``) of the traced part."""

from portbench import spans


def read(ctx):
    return spans.span_ms(ctx, "hnsw.graph.launch", per="hnsw.serve.flush")
