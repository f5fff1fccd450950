"""Exact L2 top-k as tiled matrix products.

The reference's exact-search oracle is a per-thread-heap brute force
(src/hnswm/bruteforce.cpp:27-86).  Here the same computation is
``||q||^2 - 2 q R^T + ||r||^2`` followed by ``lax.top_k`` — one large
product at HIGHEST precision, streamed over reference chunks with a running
top-k merge so arbitrarily large references fit in device memory.

Distances are SQUARED L2 (FAISS convention, matching the dense pipeline's
distances.npy); the rerank layer applies sqrt where the reference does.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# The exact oracle's products run at full fp32 precision on every backend
# (the GPU's default for fp32 products is TF32, about three digits).
EXACT = jax.lax.Precision.HIGHEST

_MAX_SCORE_ELEMS = 1 << 30

_BIG = np.float32(3.4e38)  # np scalar: a module-level jnp call would init the backend at import


@functools.partial(jax.jit, static_argnames=("k",))
def _topk_once(q: jax.Array, r: jax.Array, qn: jax.Array, k: int):
    rn = jnp.sum(r * r, axis=-1)
    scores = qn[:, None] + rn[None, :] - 2.0 * jnp.dot(q, r.T, precision=EXACT)
    neg, idx = jax.lax.top_k(-scores, k)
    return -neg, idx


@functools.partial(jax.jit, static_argnames=("k", "chunk"))
def _topk_chunked(q: jax.Array, r: jax.Array, qn: jax.Array, k: int,
                  chunk: int, n_real):
    """r is padded to a chunk multiple; rows at or past n_real never win
    (masked by id: a padding VALUE such as 3.4e38 would square to inf and
    turn scores into NaN, which top_k orders differently per backend)."""
    n = r.shape[0]
    n_chunks = n // chunk
    r_chunks = r.reshape(n_chunks, chunk, r.shape[1])

    def step(carry, inp):
        best_d, best_i = carry
        rc, c_idx = inp
        rn = jnp.sum(rc * rc, axis=-1)
        scores = qn[:, None] + rn[None, :] - 2.0 * jnp.dot(q, rc.T, precision=EXACT)
        ids = c_idx * chunk + jax.lax.broadcasted_iota(jnp.int32, (1, chunk), 1)
        scores = jnp.where(ids < n_real, scores, _BIG)
        cat_d = jnp.concatenate([best_d, scores], axis=1)
        cat_i = jnp.concatenate([best_i, jnp.broadcast_to(ids, scores.shape)], axis=1)
        neg, pos = jax.lax.top_k(-cat_d, k)
        return (-neg, jnp.take_along_axis(cat_i, pos, axis=1)), None

    init = (
        jnp.full((q.shape[0], k), _BIG, dtype=jnp.float32),
        jnp.zeros((q.shape[0], k), dtype=jnp.int32),
    )
    (d, i), _ = jax.lax.scan(
        step, init, (r_chunks, jnp.arange(n_chunks, dtype=jnp.int32))
    )
    return d, i


def l2_topk(queries, refs, k: int, chunk: int = 262144):
    """Exact top-k by squared L2.  queries [Q,D], refs [N,D] -> (dists [Q,k],
    ids [Q,k]) sorted ascending; ties broken toward lower id."""
    q = jnp.asarray(queries, dtype=jnp.float32)
    r = jnp.asarray(refs, dtype=jnp.float32)
    n = r.shape[0]
    k_eff = min(k, n)
    # XLA's GPU backend refuses a k=128 top_k over [8192, 2^18] scores, so
    # the [Q, chunk] block shrinks as Q grows (Q * chunk <= 2^30)
    chunk = max(1024, min(chunk, _MAX_SCORE_ELEMS // max(q.shape[0], 1)))
    qn = jnp.sum(q * q, axis=-1)
    if n <= chunk:
        d, i = _topk_once(q, r, qn, k_eff)
    else:
        pad = (-n) % chunk
        if pad:
            r = jnp.concatenate(
                [r, jnp.zeros((pad, r.shape[1]), dtype=r.dtype)], axis=0
            )
        d, i = _topk_chunked(q, r, qn, k_eff, chunk, jnp.int32(n))
    if k_eff < k:
        # Fewer refs than k: pad with the last (worst) column, FAISS-style
        # behaviour is to return -1/inf; we replicate FAISS's "-1 id" padding.
        d = jnp.concatenate(
            [d, jnp.full((d.shape[0], k - k_eff), _BIG, d.dtype)], axis=1
        )
        i = jnp.concatenate(
            [i, jnp.full((i.shape[0], k - k_eff), -1, i.dtype)], axis=1
        )
    return d, i
