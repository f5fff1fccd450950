"""Exact (brute-force) index — the recall oracle.

Replacement for the reference's BruteForce engine
(src/hnswm/bruteforce.cpp:27-110): squared-L2 top-k as a tiled matmul +
lax.top_k (ops/topk.py) instead of per-thread heaps.  The products are
pinned at lax.Precision.HIGHEST (ops/topk.EXACT), so the oracle is exact in
fp32 on the GPU too, where the default would be TF32.  Ids are sequential
positions in insertion order, which for the dense windowed reference equal the
label ids (2*pos | strand).
"""

from __future__ import annotations

import os

import numpy as np

from deepreadmapper_tpu.index.registry import register_index
from deepreadmapper_tpu.ops.topk import l2_topk


@register_index("FLAT")
class FlatIndex:
    def __init__(self, embeddings: np.ndarray):
        self.embeddings = np.ascontiguousarray(embeddings, dtype=np.float32)

    @property
    def ntotal(self) -> int:
        return self.embeddings.shape[0]

    def search(self, queries: np.ndarray, k: int, ef: int = 0):
        """ef is accepted for interface parity and ignored (exact search)."""
        d, i = l2_topk(queries, self.embeddings, k)
        return np.asarray(i, dtype=np.int64), np.asarray(d, dtype=np.float32)

    def save(self, index_prefix: str) -> None:
        os.makedirs(index_prefix, exist_ok=True)
        np.save(os.path.join(index_prefix, "vectors.npy"), self.embeddings)

    @classmethod
    def load(cls, index_prefix: str, config: dict | None = None):
        return cls(np.load(os.path.join(index_prefix, "vectors.npy")))
