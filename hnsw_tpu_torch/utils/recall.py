"""Recall metrics (ann-benchmarks protocol), as in ``hnsw_tpu.utils.recall``."""

from __future__ import annotations

import numpy as np


def recall_at_k(pred_ids: np.ndarray, true_ids: np.ndarray, k: int) -> float:
    """recall@k = |pred[:k] ∩ true[:k]| / k, averaged over queries."""
    pred = np.asarray(pred_ids)[:, :k]
    true = np.asarray(true_ids)[:, :k]
    hits = 0
    for p, t in zip(pred, true):
        hits += len(set(p.tolist()) & set(t.tolist()))
    return hits / (pred.shape[0] * k)
