"""Exhaustive PQ/ADC scan index.

The IVF-style fallback SURVEY.md §7 anticipates: instead of traversing a
graph, scan ALL PQ codes with ADC distances.  Same quantization error as
FAISS IndexHNSWPQ (src/hnswpq/index.cpp:86-193), none of its graph recall
loss, at 8 B/vector of device residency — the human-genome engine.

Formulation: ADC distance to the PQ reconstruction equals the exact squared
L2 to the reconstructed vector, so the scan reconstructs each code chunk
(a gather from the int8-valued codebook, exact) and scores it with int8
products exactly like INT8FLAT's scan:

    score = ||q8||^2 + ||recon8||^2 - 2 * q8 . recon8      (exact int32)

Codes live on the device as uint8 [N, m] (8 B/row at m=8).  At genome scale
on the GPU the search is the windowed scan of ops/scan_kernel.py; this
module holds the engine plumbing plus the chunked exact-in-quantized-space
top-k used for parity and on the CPU.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from deepreadmapper_tpu.config import BuildConfig
from deepreadmapper_tpu.index.registry import register_index
from deepreadmapper_tpu.ops import pq as pq_ops
from deepreadmapper_tpu.ops import scan_kernel as sk

_BIG = np.float32(3.4e38)  # np scalar: a module-level jnp call would init the backend at import


@functools.partial(jax.jit, static_argnames=("k", "chunk", "exact"))
def _pq_int8_topk(q8: jax.Array, codes: jax.Array, cent8: jax.Array,
                  ntotal: jax.Array, k: int, chunk: int, exact: bool = True,
                  ratio=1.0):
    """Streaming top-k over a reconstruct-then-int8-scan of PQ codes.

    q8 [Q, d] int8, codes [N, m] uint8 (N a chunk multiple), cent8
    [m, ksub, dsub] int8 codebook.  ratio = sq/sc, the query/code
    quantization-scale ratio (1.0 when the query batch fits the codebook
    scale without clipping); all terms are exact integers (< 2^24) carried
    in fp32, so at ratio == 1 ordering equals exact int32 ordering.
    """
    qn = jnp.sum(
        q8.astype(jnp.int32) * q8.astype(jnp.int32), axis=-1, dtype=jnp.int32
    ).astype(jnp.float32)
    n, m = codes.shape
    n_chunks = n // chunk
    code_chunks = codes.reshape(n_chunks, chunk, m)
    r = jnp.asarray(ratio, jnp.float32)

    def step(carry, inp):
        best_d, best_i = carry
        cc, c_idx = inp
        recon8 = sk.reconstruct_pq(cc, cent8)  # [chunk, d] int8, exact
        ri = recon8.astype(jnp.int32)
        rn = jnp.sum(ri * ri, axis=-1)
        dot = jax.lax.dot_general(
            q8,
            recon8,
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.int32,
        )  # [Q, chunk] int32, exact
        d = (
            r * r * qn[:, None]
            + rn[None, :].astype(jnp.float32)
            - (2.0 * r) * dot.astype(jnp.float32)
        )
        ids = c_idx * chunk + jax.lax.broadcasted_iota(jnp.int32, (1, chunk), 1)
        d = jnp.where(ids < ntotal, d, _BIG)
        if exact:
            nd, pos = jax.lax.top_k(-d, k)
        else:
            nd, pos = jax.lax.approx_max_k(-d, k, recall_target=0.95)
        nid = jnp.take_along_axis(jnp.broadcast_to(ids, d.shape), pos, axis=1)
        cat_d = jnp.concatenate([best_d, -nd], axis=1)
        cat_i = jnp.concatenate([best_i, nid], axis=1)
        neg, pos2 = jax.lax.top_k(-cat_d, k)
        return (-neg, jnp.take_along_axis(cat_i, pos2, axis=1)), None

    init = (
        jnp.full((q8.shape[0], k), _BIG, dtype=jnp.float32),
        jnp.zeros((q8.shape[0], k), dtype=jnp.int32),
    )
    (d, i), _ = jax.lax.scan(
        step, init, (code_chunks, jnp.arange(n_chunks, dtype=jnp.int32)),
    )
    return d, i


@register_index("PQFLAT")
class PQFlatIndex:
    _CHUNK = 131072  # bounds the per-chunk [Q, chunk] score tensor

    def __init__(self, codes: np.ndarray, codebook: pq_ops.PQCodebook,
                 ntotal: int, rot: np.ndarray | None = None):
        self.codes = codes
        self.codebook = codebook
        self.ntotal = ntotal
        # Optional OPQ rotation Rt [d, d]: codes/codebook live in the
        # ROTATED space (y = x @ Rt); queries rotate at search time.  Rt is
        # orthogonal so L2 distances are unchanged.
        self.rot = None if rot is None else np.asarray(rot, np.float32)
        self.cb8 = pq_ops.quantize_codebook(codebook)
        self._dev = None

    @classmethod
    def build(cls, embeddings: np.ndarray, cfg: BuildConfig | None = None):
        cfg = cfg or BuildConfig()
        train = pq_ops.sample_training_set(embeddings, cfg.sample_rate)
        if cfg.opq:
            cb, rot = pq_ops.train_opq(
                np.asarray(train), m=cfg.m_pq, nbits=cfg.nbits,
                iters=cfg.opq_iters, seed=cfg.seed,
            )
            # rotation applied per 262k-row chunk inside encode_pq — the
            # full rotated fp32 matrix would not fit HBM at genome scale
            codes = pq_ops.encode_pq(embeddings, cb, rot=rot)
            return cls(codes, cb, embeddings.shape[0], rot)
        cb = pq_ops.train_pq(
            train, m=cfg.m_pq, nbits=cfg.nbits, iters=cfg.kmeans_iters, seed=cfg.seed
        )
        codes = pq_ops.encode_pq(embeddings, cb)
        return cls(codes, cb, embeddings.shape[0])

    def _padded_codes(self) -> np.ndarray:
        codes = self.codes
        n = codes.shape[0]
        base = sk._PAD_BASE if n >= sk._PAD_BASE else sk.CT
        pad = (-n) % min(base, max(n, 1))
        if pad:
            codes = np.concatenate(
                [codes, np.zeros((pad, codes.shape[1]), np.uint8)], axis=0
            )
        return codes

    def _device(self):
        """Codes [Np, m] uint8 (padded ONCE to a chunk multiple; per-search
        padding would re-copy + re-upload) + the int8 codebook on device."""
        if self._dev is None:
            self._dev = (
                jnp.asarray(self._padded_codes()),
                jnp.asarray(self.cb8.cent8),
            )
        return self._dev

    def search(self, queries: np.ndarray, k: int, ef: int = 0,
               chunk: int | None = None, exact: bool = False):
        """ef accepted for interface parity; an exhaustive scan ignores it.
        exact=True forces a full per-chunk top_k in the quantized space (the
        parity oracle); otherwise the GPU takes the windowed scan at genome
        scale (one survivor per 128-row window, exact merge)."""
        n = self.ntotal
        queries = np.asarray(queries, np.float32)
        if self.rot is not None and queries.size:
            queries = queries @ self.rot  # into the OPQ-rotated space
        if n == 0:
            return (
                np.full((queries.shape[0], k), -1, np.int64),
                np.full((queries.shape[0], k), np.inf, np.float32),
            )
        k_eff = min(k, n)
        codes, cent8 = self._device()
        np_ = int(codes.shape[0])
        from deepreadmapper_tpu.index.int8_flat import (
            quantize_host,
            query_scale_ratio,
        )

        # Queries quantize with their OWN scale when the batch exceeds the
        # codebook range (clipping at the codebook scale would bias every
        # out-of-range dim); the sq/sc ratio folds into the score instead.
        sc = np.float32(self.cb8.scale)
        sq, ratio = query_scale_ratio(queries, sc)
        q8_all = quantize_host(queries, sq)
        nq = queries.shape[0]
        q_batch = 8192  # bound the [q_batch, chunk] score tensor
        use_fused = not exact and sk.can_fuse(n, np_, k_eff)
        pending = []
        qn_all = None
        if use_fused:
            fchunk = sk.choose_chunk(np_)
            qn_all = (q8_all.astype(np.int64) ** 2).sum(1).astype(np.float32)
            width = sk.pad_queries(nq, q_batch)
            for s in range(0, nq, q_batch):
                e = min(s + q_batch, nq)
                qb = q8_all[s:e]
                if qb.shape[0] < width:
                    qb = np.pad(qb, ((0, width - qb.shape[0]), (0, 0)))
                pending.append(
                    (s, e,
                     sk.fused_scan_topk(jnp.asarray(qb), codes, n, k_eff,
                                        fchunk, "pq", cent8=cent8,
                                        ratio=ratio))
                )
        else:
            eff_chunk = min(chunk or self._CHUNK, np_)
            if np_ % eff_chunk:  # padding granularity (sk.CT) < _CHUNK
                eff_chunk = np_
            for s in range(0, nq, q_batch):
                e = min(s + q_batch, nq)
                qb = q8_all[s:e]
                if e - s < q_batch and nq > q_batch:
                    # pad the tail batch: one compiled program per signature
                    qb = np.pad(qb, ((0, q_batch - (e - s)), (0, 0)))
                pending.append(
                    (s, e,
                     _pq_int8_topk(jnp.asarray(qb), codes, cent8,
                                   jnp.int32(n), k_eff, eff_chunk, exact,
                                   ratio))
                )
        d = np.empty((nq, k_eff), np.float32)
        i = np.empty((nq, k_eff), np.int64)
        s2 = sc * sc
        for s, e, (db, ib) in pending:
            # quantized-space scores -> fp32 squared L2 estimate; the
            # windowed scan returns rn - 2(sq/sc) q.r, so add the query norm
            db = np.asarray(db)[: e - s]
            if use_fused:
                db = db + (ratio * ratio) * qn_all[s:e, None]
            d[s:e] = db * s2
            i[s:e] = np.asarray(ib, dtype=np.int64)[: e - s]
        if k_eff < k:
            d = np.pad(d, ((0, 0), (0, k - k_eff)), constant_values=np.inf)
            i = np.pad(i, ((0, 0), (0, k - k_eff)), constant_values=-1)
        return i, d

    def save(self, index_prefix: str) -> None:
        os.makedirs(index_prefix, exist_ok=True)
        payload = dict(
            codes=self.codes,
            centroids=np.asarray(self.codebook.centroids),
            ntotal=self.ntotal,
        )
        if self.rot is not None:
            payload["rot"] = self.rot
        np.savez(os.path.join(index_prefix, "pq.npz"), **payload)

    @classmethod
    def load(cls, index_prefix: str, config: dict | None = None):
        z = np.load(os.path.join(index_prefix, "pq.npz"))
        return cls(
            z["codes"],
            pq_ops.PQCodebook(jnp.asarray(z["centroids"])),
            int(z["ntotal"]),
            rot=z["rot"] if "rot" in z.files else None,
        )
