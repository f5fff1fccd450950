"""Product quantization: codebook training, encoding, ADC distances.

Rebuild of the reference's FAISS IndexHNSWPQ quantization layer
(src/hnswpq/index.cpp:86-193): M_pq sub-vectors x 2^nbits centroids trained by
k-means on an evenly-sampled training set (SAMPLE_RATE = 0.5,
create_training_set index.cpp:57-84), vectors encoded to M_pq uint8 codes,
query-time distances via asymmetric distance computation (ADC) lookup tables.

Device design:
  * Training runs ALL subquantizers as one batched k-means: data [m, n, dsub]
    against centroids [m, ksub, dsub]; the assignment step is one batched
    matmul, the update one segment-sum.
  * ADC scanning: the production form is reconstruct-then-int8-scan (ADC
    distance to the PQ reconstruction == exact L2 to the reconstructed
    vector) — see PQInt8Codebook below and the windowed scan in
    ops/scan_kernel.py / the chunked oracle in index/pq_flat.py.  The
    historical forms kept here for tests/HNSW-ADC: gather
    (T[q, m, codes[n, m]] summed over m) and one-hot-tables matmul
    ([chunk, m*ksub] @ [m*ksub, Q]; 256x FLOP inflation — superseded).
  * Everything is deterministic given the seed (FAISS's k-means is not).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class PQCodebook(NamedTuple):
    centroids: jax.Array  # [m, ksub, dsub] fp32

    @property
    def m(self) -> int:
        return self.centroids.shape[0]

    @property
    def ksub(self) -> int:
        return self.centroids.shape[1]

    @property
    def dsub(self) -> int:
        return self.centroids.shape[2]


def sample_training_set(vectors: np.ndarray, sample_rate: float = 0.5) -> np.ndarray:
    """Evenly-spaced training sample (create_training_set, index.cpp:57-84)."""
    total = vectors.shape[0]
    n_train = max(1, int(total * sample_rate))
    step = total / n_train
    idx = np.minimum((np.arange(n_train) * step).astype(np.int64), total - 1)
    return vectors[idx]


def _split(x: jax.Array, m: int) -> jax.Array:
    """[n, d] -> [m, n, dsub]."""
    n, d = x.shape
    return jnp.moveaxis(x.reshape(n, m, d // m), 1, 0)


@functools.partial(jax.jit, static_argnames=("iters",))
def _kmeans_batched(data: jax.Array, init: jax.Array, iters: int):
    """Batched Lloyd iterations.  data [m, n, dsub], init [m, k, dsub]."""

    def assign(cent):
        # [m, n, k] squared distances via matmul.
        d2 = (
            jnp.sum(data * data, axis=-1, keepdims=True)
            - 2.0 * jnp.einsum("mnd,mkd->mnk", data, cent)
            + jnp.sum(cent * cent, axis=-1)[:, None, :]
        )
        return jnp.argmin(d2, axis=-1)  # [m, n]

    def body(cent, _):
        a = assign(cent)
        k = cent.shape[1]
        onehot = jax.nn.one_hot(a, k, dtype=data.dtype)  # [m, n, k]
        counts = jnp.sum(onehot, axis=1)  # [m, k]
        sums = jnp.einsum("mnk,mnd->mkd", onehot, data)
        new = sums / jnp.maximum(counts[..., None], 1.0)
        # Empty clusters keep their previous centroid (deterministic).
        new = jnp.where(counts[..., None] > 0, new, cent)
        return new, None

    cent, _ = jax.lax.scan(body, init, None, length=iters)
    return cent


def train_pq(
    train_vectors: np.ndarray,
    m: int = 8,
    nbits: int = 8,
    iters: int = 25,
    seed: int = 1234,
) -> PQCodebook:
    ksub = 1 << nbits
    n, d = train_vectors.shape
    if d % m:
        raise ValueError(f"dim {d} not divisible by M_pq {m}")
    data = _split(jnp.asarray(train_vectors, jnp.float32), m)
    # Deterministic init: evenly spaced distinct training points per subq
    # (stable across runs, unlike FAISS's RNG init).
    if n < ksub:
        reps = -(-ksub // n)
        idx = np.tile(np.arange(n), reps)[:ksub]
    else:
        idx = (np.arange(ksub) * (n / ksub)).astype(np.int64)
    rng = np.random.default_rng(seed)
    jitter = rng.standard_normal((m, ksub, d // m)).astype(np.float32) * 1e-5
    init = data[:, idx, :] + jitter  # tiny jitter splits duplicate points
    cent = _kmeans_batched(data, init, iters)
    return PQCodebook(centroids=cent)


def train_opq(
    train_vectors: np.ndarray,
    m: int = 8,
    nbits: int = 8,
    iters: int = 10,
    pq_iters: int = 8,
    seed: int = 1234,
) -> tuple[PQCodebook, np.ndarray]:
    """OPQ (Ge et al., non-parametric): learn an orthogonal rotation that
    minimizes PQ quantization error (FAISS OPQMatrix analog; the reference's
    FAISS build does not enable it — beyond-reference quality knob).

    Alternates (a) k-means in the rotated space, warm-started from the
    previous centroids, with (b) the orthogonal-Procrustes update
    Rt = U @ Vt from svd(X^T @ recon).  Returns (codebook trained in the
    ROTATED space, Rt [d, d]) with y = x @ Rt the rotated embedding; L2 is
    preserved exactly (Rt orthogonal), so distances stay comparable with
    every other engine.
    """
    if iters < 1:
        raise ValueError("train_opq needs iters >= 1 (opq_iters in BuildConfig)")
    x = np.asarray(train_vectors, np.float32)
    n, d = x.shape
    rt = np.eye(d, dtype=np.float32)
    cb = None
    for it in range(iters):
        y = x @ rt
        if cb is None:
            cb = train_pq(y, m=m, nbits=nbits, iters=pq_iters, seed=seed)
        else:
            # warm start: refine the previous centroids in the new rotation
            data = _split(jnp.asarray(y), m)
            cb = PQCodebook(_kmeans_batched(data, cb.centroids, pq_iters))
        codes = encode_pq(y, cb)
        recon = pq_reconstruct(codes, cb)
        # min ||x @ Rt - recon||_F over orthogonal Rt (Procrustes)
        u, _, vt = np.linalg.svd(x.T @ recon)
        rt = (u @ vt).astype(np.float32)
    # final codebook consistent with the final rotation
    data = _split(jnp.asarray(x @ rt), m)
    cb = PQCodebook(_kmeans_batched(data, cb.centroids, pq_iters))
    return cb, rt


@jax.jit
def _encode(data_split: jax.Array, cent: jax.Array) -> jax.Array:
    d2 = (
        jnp.sum(data_split * data_split, axis=-1, keepdims=True)
        - 2.0 * jnp.einsum("mnd,mkd->mnk", data_split, cent)
        + jnp.sum(cent * cent, axis=-1)[:, None, :]
    )
    return jnp.argmin(d2, axis=-1).astype(jnp.uint8).T  # [n, m]


def encode_pq(vectors: np.ndarray, codebook: PQCodebook, chunk: int = 262144,
              rot: np.ndarray | None = None) -> np.ndarray:
    """Chunked encode; rot (the OPQ rotation) is applied PER CHUNK on
    device so the full rotated fp32 matrix never materializes (20 GB at
    40M rows)."""
    n = vectors.shape[0]
    out = np.empty((n, codebook.m), dtype=np.uint8)
    rot_dev = None if rot is None else jnp.asarray(rot, jnp.float32)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        x = jnp.asarray(vectors[s:e], jnp.float32)
        if rot_dev is not None:
            x = x @ rot_dev
        data = _split(x, codebook.m)
        out[s:e] = np.asarray(_encode(data, codebook.centroids))
    return out


@jax.jit
def adc_tables(queries: jax.Array, cent: jax.Array) -> jax.Array:
    """[Q, d] -> ADC tables [Q, m, ksub] of squared sub-distances."""
    q = _split(queries, cent.shape[0])  # [m, Q, dsub]
    d2 = (
        jnp.sum(q * q, axis=-1, keepdims=True)
        - 2.0 * jnp.einsum("mqd,mkd->mqk", q, cent)
        + jnp.sum(cent * cent, axis=-1)[:, None, :]
    )
    return jnp.moveaxis(d2, 0, 1)  # [Q, m, ksub]


@jax.jit
def adc_distances_gather(tables: jax.Array, codes: jax.Array) -> jax.Array:
    """tables [Q, m, ksub], codes [C, m] -> distances [Q, C] (gather form)."""
    # [Q, C, m]: for each query pick table entries at the codes.
    t = jnp.swapaxes(tables, 0, 1)  # [m, Q, ksub]
    c = codes.astype(jnp.int32).T  # [m, C]
    picked = jax.vmap(lambda tm, cm: tm[:, cm])(t, c)  # [m, Q, C]
    return jnp.sum(picked, axis=0)


@functools.partial(jax.jit, static_argnames=("ksub",))
def codes_to_onehot(codes: jax.Array, ksub: int = 256) -> jax.Array:
    """[C, m] uint8 -> bf16 one-hot [C, m*ksub] (exact 0/1 values)."""
    c, m = codes.shape
    offsets = jax.lax.broadcasted_iota(jnp.int32, (1, m), 1) * ksub
    flat = codes.astype(jnp.int32) + offsets  # [C, m] in [0, m*ksub)
    iota = jax.lax.broadcasted_iota(jnp.int32, (1, 1, m * ksub), 2)
    return (flat[:, :, None] == iota).any(axis=1).astype(jnp.bfloat16)


@jax.jit
def adc_distances_onehot(tables: jax.Array, onehot: jax.Array) -> jax.Array:
    """tables [Q, m, ksub], onehot [C, m*ksub] -> [Q, C] as one matmul.

    The one-hot is exact in bf16 and the table is cast to bf16; products are
    exact table entries, accumulated in fp32 — only the table's bf16 rounding
    (~0.4% rel) differs from the gather form.
    """
    q = tables.shape[0]
    t_flat = tables.reshape(q, -1).astype(jnp.bfloat16)  # [Q, m*ksub]
    return jax.lax.dot_general(
        t_flat,
        onehot,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    )  # [Q, C]


class PQInt8Codebook(NamedTuple):
    """Int8-quantized codebook for the reconstruct-then-int8-scan ADC form.

    ADC distance to the PQ reconstruction IS the exact squared L2 to the
    reconstructed vector, so instead of the one-hot-matmul over tables
    ([Q, m*ksub] — 256x FLOP inflation), the scan can reconstruct each code
    chunk on the fly and score it as a plain [Q, d] x [d, chunk] matmul —
    16x fewer FLOPs at m=8/ksub=256/d=128.  Quantizing the centroids to
    int8 (one global scale; encoder outputs are tanh-bounded like INT8FLAT's)
    makes the reconstruction exactly int8-valued, so the score matmul runs
    as int8 products with exact int32 arithmetic.
    """

    cent8: np.ndarray       # [m, ksub, dsub] int8
    scale: float            # fp32 dequant scale (value = cent8 * scale)
    cent_norms: np.ndarray  # [m, ksub] int32 squared sub-norms


def quantize_codebook(codebook: PQCodebook) -> PQInt8Codebook:
    cent = np.asarray(codebook.centroids, np.float32)
    amax = float(np.max(np.abs(cent))) if cent.size else 1.0
    scale = max(amax, 1e-30) / 127.0
    cent8 = np.clip(np.round(cent / scale), -127, 127).astype(np.int8)
    cn = np.sum(cent8.astype(np.int32) ** 2, axis=-1, dtype=np.int32)
    return PQInt8Codebook(cent8, scale, cn)


def recon_norms(codes: np.ndarray, cent_norms: np.ndarray) -> np.ndarray:
    """[N, m] uint8 codes -> [N] int32 squared norms of the int8 recon."""
    n, m = codes.shape
    out = np.zeros(n, np.int32)
    for j in range(m):
        out += cent_norms[j][codes[:, j].astype(np.int64)]
    return out


def pq_reconstruct(codes: np.ndarray, codebook: PQCodebook) -> np.ndarray:
    """Decode codes back to vectors [n, d] (exactness oracle for tests)."""
    cent = np.asarray(codebook.centroids)
    parts = [cent[j][codes[:, j].astype(np.int64)] for j in range(codebook.m)]
    return np.concatenate(parts, axis=1)
