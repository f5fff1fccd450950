"""INT8 exhaustive-scan index: symmetric int8 quantization + int8 products.

The genome-scale serving engine.  It stores whole vectors quantized to int8
and scores them with int8 x int8 -> int32 products (tensor cores on the
GPU):

    ||q - r||^2 = s^2 * (qn8 + rn8 - 2 * q8 . r8)

with ONE global scale s (the read encoder's outputs are final bi-GRU hidden
states, tanh-bounded in [-1, 1], so s ~= 1/127 and the quantization error is
~4e-3 per dim — recall is essentially exact, unlike PQ).  All distance
arithmetic is exact int32; ties and ordering are deterministic.

Memory: 128 B/vector (vs 512 fp32, 8 PQ) — 10M windows = 1.28 GB.
Storage-compatible role: FAISS IndexScalarQuantizer(QT_8bit) equivalent.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from deepreadmapper_tpu.config import BuildConfig
from deepreadmapper_tpu.index.registry import register_index
from deepreadmapper_tpu.ops import scan_kernel as sk

_BIGF = np.float32(3.4e38)  # np scalar: a module-level jnp call would init the backend at import


@jax.jit
def _row_norms(c: jax.Array) -> jax.Array:
    """Squared row norms of an int8 code matrix, computed in 262144-row
    chunks — a whole-matrix int32 cast would transiently need 8x the codes'
    memory (41 GB at 40M windows)."""
    n, d = c.shape
    chunk = min(262144, n)
    if n % chunk:
        return jnp.sum(
            c.astype(jnp.int32) * c.astype(jnp.int32), axis=-1, dtype=jnp.int32
        )

    def step(_, cc):
        return 0, jnp.sum(
            cc.astype(jnp.int32) * cc.astype(jnp.int32), axis=-1,
            dtype=jnp.int32,
        )

    _, rn = jax.lax.scan(step, 0, c.reshape(n // chunk, chunk, d))
    return rn.reshape(n)


def quantize(x, scale: float):
    """fp32 -> int8 with symmetric clipping at +-127 (device)."""
    xj = jnp.asarray(x, jnp.float32)
    return jnp.clip(jnp.round(xj / scale), -127, 127).astype(jnp.int8)


def quantize_host(x: np.ndarray, scale) -> np.ndarray:
    """Host twin of quantize() — same rounding (banker's) and clipping;
    the single definition both engines' query paths share."""
    return np.clip(
        np.round(np.asarray(x, np.float32) / np.float32(scale)), -127, 127
    ).astype(np.int8)


def query_scale_ratio(queries: np.ndarray, code_scale: float):
    """Pick the query quantization scale: the code scale when the batch
    fits it (exact shared-scale integer scoring), else the batch's own
    amax/127 (no clipping; the sq/sc ratio folds into the score)."""
    sc = np.float32(code_scale)
    qmax = np.float32(np.max(np.abs(queries))) if queries.size else sc
    sq = max(sc, qmax / np.float32(127.0))
    return sq, np.float32(sq / sc)


@functools.partial(jax.jit, static_argnames=("k", "chunk", "exact"))
def _int8_topk(q8: jax.Array, r8: jax.Array, rn: jax.Array, ntotal, k: int,
               chunk: int, exact: bool = False, ratio=1.0):
    """Top-k in the quantized space.  q8 [Q,D] int8, r8 [N,D] int8
    (N padded to a chunk multiple), rn [N] int32 = per-row squared norms.
    Scores: r^2*qn + rn - 2r*(q8.r8) with r = sq/sc, the query/code
    quantization-scale ratio (1.0 when the query batch fits the code scale;
    then every term is an exact integer and ordering equals int32 ordering).

    exact=False uses lax.approx_max_k per chunk (an exact top-k on the CPU
    and the GPU); the cross-chunk merge is an exact top_k over k-sized
    lists."""
    qn = jnp.sum(
        q8.astype(jnp.int32) * q8.astype(jnp.int32), axis=-1, dtype=jnp.int32
    ).astype(jnp.float32)
    r = jnp.asarray(ratio, jnp.float32)
    n = r8.shape[0]
    n_chunks = n // chunk
    r_chunks = r8.reshape(n_chunks, chunk, r8.shape[1])
    rn_chunks = rn.reshape(n_chunks, chunk)

    def step(carry, inp):
        best_d, best_i = carry
        rc, rnc, c_idx = inp
        dot = jax.lax.dot_general(
            q8,
            rc,
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.int32,
        )  # [Q, chunk] int32, exact
        # int32 top_k lowers to a full stable SORT (three [Q,chunk] HBM
        # temps — OOM at scale); all terms are bounded by 4*127^2*D < 2^24
        # so they are EXACTLY representable in fp32, whose top_k lowering is
        # the efficient partial-reduction path.
        scores = (
            r * r * qn[:, None]
            + rnc[None, :].astype(jnp.float32)
            - (2.0 * r) * dot.astype(jnp.float32)
        )
        ids = c_idx * chunk + jax.lax.broadcasted_iota(jnp.int32, (1, chunk), 1)
        scores = jnp.where(ids < ntotal, scores, _BIGF)
        if exact:
            nd, pos = jax.lax.top_k(-scores, k)
        else:
            nd, pos = jax.lax.approx_max_k(-scores, k, recall_target=0.95)
        nid = jnp.take_along_axis(jnp.broadcast_to(ids, scores.shape), pos, axis=1)
        cat_d = jnp.concatenate([best_d, -nd], axis=1)
        cat_i = jnp.concatenate([best_i, nid], axis=1)
        neg, pos2 = jax.lax.top_k(-cat_d, k)
        return (-neg, jnp.take_along_axis(cat_i, pos2, axis=1)), None

    init = (
        jnp.full((q8.shape[0], k), _BIGF, dtype=jnp.float32),
        jnp.zeros((q8.shape[0], k), dtype=jnp.int32),
    )
    (d, i), _ = jax.lax.scan(
        step,
        init,
        (r_chunks, rn_chunks, jnp.arange(n_chunks, dtype=jnp.int32)),
    )
    return d, i


@register_index("INT8FLAT")
class Int8FlatIndex:
    """Exhaustive int8 scan (near-exact recall, 128 B/vector)."""

    def __init__(self, codes: np.ndarray, scale: float, ntotal: int):
        self.codes = codes              # [N, D] int8
        self.scale = float(scale)
        self.ntotal = ntotal
        self._rn = None
        self._dev = None

    @classmethod
    def build(cls, embeddings, cfg: BuildConfig | None = None):
        del cfg
        x = jnp.asarray(embeddings, jnp.float32)
        # Global symmetric scale; encoder outputs are tanh-bounded so this is
        # ~1/127, but compute it from the data for generic vectors.
        amax = float(jnp.max(jnp.abs(x))) if x.size else 1.0
        scale = max(amax, 1e-30) / 127.0
        codes = np.asarray(quantize(x, scale))
        return cls(codes, scale, codes.shape[0])

    # XLA's GPU backend refuses a k=128 top_k over [8192, 2^18] scores
    # ("Invalid dimension size"); 2^17-row chunks compile
    _CHUNK = 131072

    def _device(self):
        """Codes + norms on device, padded ONCE to a chunk multiple (search
        is the hot path; per-call jnp.pad would copy the whole array).
        Padding granularity: 2^18 rows above 2^18 total, else the windowed
        scan's candidate tile (sk.CT) — both divide evenly for every
        chunked scan; both paths mask pad rows by ntotal themselves."""
        if self._dev is None:
            codes = self.codes
            n = codes.shape[0]
            base = sk._PAD_BASE if n >= sk._PAD_BASE else sk.CT
            pad = (-n) % min(base, max(n, 1))
            if pad:
                codes = np.pad(codes, ((0, pad), (0, 0)))
            self._dev = jnp.asarray(codes)
        return self._dev

    def _device_norms(self):
        """Row norms for the per-chunk top-k scan, computed lazily on first
        use — the windowed scan (the GPU path at genome scale) recomputes
        norms per tile and never reads them, so eager norms would pin
        4 B/row of device memory plus a full pass at upload for nothing."""
        if self._rn is None:
            self._rn = _row_norms(self._device())
        return self._rn

    def search(self, queries: np.ndarray, k: int, ef: int = 0,
               exact: bool = False):
        """ef accepted for interface parity; an exhaustive scan ignores it.
        exact=True forces the per-chunk full top_k (the parity oracle);
        otherwise the GPU takes the windowed scan at genome scale."""
        n = self.ntotal
        queries = np.asarray(queries, np.float32)
        if n == 0:
            return (
                np.full((queries.shape[0], k), -1, np.int64),
                np.full((queries.shape[0], k), np.inf, np.float32),
            )
        k_eff = min(k, n)
        c = self._device()  # already padded to a chunk multiple
        np_ = int(c.shape[0])
        use_fused = not exact and sk.can_fuse(n, np_, k_eff)
        # queries exceeding the code scale get their own scale (no
        # clipping); the sq/sc ratio folds into the score
        sq, ratio = query_scale_ratio(queries, self.scale)
        q8_all = quantize_host(queries, sq)
        nq = q8_all.shape[0]
        q_batch = 8192  # bounds the per-call [q_batch, chunk] work
        pending = []
        qn_all = None
        if use_fused:
            # windowed-min scan (ops/scan_kernel): scores never reach
            # device memory; the query norm is added back below
            chunk = sk.choose_chunk(np_)
            qn_all = (
                q8_all.astype(np.int64) ** 2
            ).sum(1).astype(np.float32)
            width = sk.pad_queries(nq, q_batch)
            for s in range(0, nq, q_batch):
                e = min(s + q_batch, nq)
                qb = q8_all[s:e]
                if qb.shape[0] < width:
                    qb = np.pad(qb, ((0, width - qb.shape[0]), (0, 0)))
                pending.append(
                    (s, e,
                     sk.fused_scan_topk(jnp.asarray(qb), c, n, k_eff, chunk,
                                        "int8", ratio=ratio))
                )
        else:
            rn = self._device_norms()
            eff_chunk = min(self._CHUNK, np_)
            for s in range(0, nq, q_batch):
                e = min(s + q_batch, nq)
                q8 = jnp.asarray(q8_all[s:e])
                if e - s < q_batch and nq > q_batch:
                    q8 = jnp.pad(q8, ((0, q_batch - (e - s)), (0, 0)))
                pending.append(
                    (s, e,
                     _int8_topk(q8, c, rn, jnp.int32(n), k_eff, eff_chunk,
                                exact, ratio))
                )
        d = np.empty((nq, k_eff), np.float32)
        i = np.empty((nq, k_eff), np.int64)
        s2 = np.float32(self.scale) ** 2
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
        np.savez(
            os.path.join(index_prefix, "int8.npz"),
            codes=self.codes,
            scale=np.float64(self.scale),
            ntotal=self.ntotal,
        )

    @classmethod
    def load(cls, index_prefix: str, config: dict | None = None):
        z = np.load(os.path.join(index_prefix, "int8.npz"))
        return cls(z["codes"], float(z["scale"]), int(z["ntotal"]))
