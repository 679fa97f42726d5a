"""portbench: the benchmark of hnsw_tpu_torch; see run.py."""
