"""The bundled serial C++ HNSW (faiss semantics): the single-core host
baseline (``cpu_baseline.CpuHnsw``)."""
