"""Candidate post-processing: sparse->dense expansion, dedup, L2 rerank.

Reference semantics (src/utils/post_processor.cpp):

* Dense index (stride == 1): passthrough of the ANN results — no rerank
  (post_processor.cpp:630-657).
* Sparse index (stride > 1): each sparse hit id expands to the window ids
  ``[ap - stride + 1, ap + stride)`` with ``ap = sparse_id * stride`` clipped
  to [0, bound); candidates are globally deduplicated, ONLY unique windows are
  re-embedded, then every query reranks its (duplicate-retaining) expanded
  candidate list by sqrt'd L2 against pre-computed query embeddings
  (post_process_l2_*, :551-748; batch_reranker, reranker.cpp:98-196).
* Invariant: k <= k_clusters * 2 * stride (post_processor.cpp:567-570).

Device mapping: expansion/dedup is cheap host integer work (the reference also
does it scalar on host); the rerank is a fixed-shape device kernel — candidate
slots are a dense [Q, k_clusters*(2*stride-1)] matrix with invalid slots
masked to +inf, embeddings gathered from the unique pool, one top-k per row.

Divergences from the reference (deliberate, documented):
* The reference computes per-query rerank boundaries assuming every sparse id
  expands to exactly 2*stride-1 candidates, but its expansion clips at the
  bound — when clipping occurs the boundaries misalign across queries
  (post_processor.cpp:616-623 vs :124-135), silently corrupting edge results.
  We mask clipped slots instead, which keeps alignment exact.
* Windows whose position would run past the genome end (dynamic mode returns
  "" for them, then tokenizes the empty string — UB) are masked invalid here.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

_INF = np.float32(np.inf)


def expand_candidates(
    neighbors: np.ndarray,
    stride: int,
    bound: int,
    k_clusters: int,
    sparse_off: np.ndarray | None = None,
    dense_off: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Expand sparse hits to dense window-id candidates.

    neighbors: int array [Q, >=k_clusters] of sparse ids (-1 = missing).
    Returns (cand_ids [Q, C] int64 with -1 for invalid, C = k_clusters*(2s-1)).

    Multi-record references pass per-record window tables (sparse_off at the
    index stride, dense_off at stride 1, from io.fasta.record_window_table):
    the reference expansion arithmetic then runs in each hit's RECORD-LOCAL
    id space and candidates are clipped to that record, so expansions never
    leak across chromosome boundaries; returned ids are global dense ids
    (2*dense_off[r] + local).  With tables omitted (single record) the
    arithmetic is byte-identical to before.
    """
    s = stride
    q = neighbors.shape[0]
    sparse = neighbors[:, :k_clusters].astype(np.int64)
    offs = np.arange(-(s - 1), s, dtype=np.int64)  # 2s-1 offsets
    if sparse_off is None:
        ap = sparse * s  # [Q, kc]
        cand = ap[:, :, None] + offs[None, None, :]  # [Q, kc, 2s-1]
        valid = (
            (sparse[:, :, None] >= 0)
            & (ap[:, :, None] < bound)
            & (cand >= 0)
            & (cand < bound)
        )
        cand = np.where(valid, cand, -1)
        return cand.reshape(q, -1), valid.reshape(q, -1)

    from deepreadmapper_tpu.io.fasta import record_of

    st = sparse & 1
    r, w_loc = record_of(sparse >> 1, sparse_off)
    sparse_loc = 2 * w_loc + st
    ap = sparse_loc * s
    bound_r = 2 * (dense_off[r + 1] - dense_off[r])  # [Q, kc]
    cand_loc = ap[:, :, None] + offs[None, None, :]
    valid = (
        (sparse[:, :, None] >= 0)
        & (ap[:, :, None] < bound_r[:, :, None])
        & (cand_loc >= 0)
        & (cand_loc < bound_r[:, :, None])
    )
    cand = 2 * dense_off[r][:, :, None] + cand_loc
    cand = np.where(valid, cand, -1)
    return cand.reshape(q, -1), valid.reshape(q, -1)


def unique_pool(cand_ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Global dedup.  Returns (unique ids sorted ascending [U], pool index per
    candidate slot [Q, C] int32 with -1 for invalid)."""
    flat = cand_ids.ravel()
    valid = flat >= 0
    uniq = np.unique(flat[valid])
    pool_idx = np.full(flat.shape, -1, dtype=np.int32)
    pool_idx[valid] = np.searchsorted(uniq, flat[valid]).astype(np.int32)
    return uniq, pool_idx.reshape(cand_ids.shape)


@functools.partial(jax.jit, static_argnames=("k",))
def _rerank_l2_device(query_emb, pool_emb, pool_idx, cand_ids, k: int):
    """Per-query sqrt-L2 rerank over padded candidate slots.

    query_emb [Q,D], pool_emb [U,D], pool_idx [Q,C] (-1 invalid),
    cand_ids [Q,C] -> (dists [Q,k], ids [Q,k]).
    """
    safe_idx = jnp.maximum(pool_idx, 0)
    ce = pool_emb[safe_idx]  # [Q, C, D]
    diff = ce - query_emb[:, None, :]
    d = jnp.sqrt(jnp.sum(diff * diff, axis=-1))
    d = jnp.where(pool_idx >= 0, d, jnp.inf)
    neg, pos = jax.lax.top_k(-d, k)
    ids = jnp.take_along_axis(cand_ids, pos, axis=1)
    return -neg, ids


def check_invariant(k: int, k_clusters: int, stride: int) -> None:
    """The reference checks ``k <= k_clusters * 2 * stride``
    (post_processor.cpp:567-570) but expansion yields only
    ``k_clusters * (2*stride - 1)`` candidate slots, so ks in the gap crash
    downstream (top_k with k > C / shape mismatch in the SW path).  Validate
    against the REAL candidate count with a clear error instead."""
    if stride > 1:
        n_cands = k_clusters * (2 * stride - 1)
        if k > n_cands:
            raise ValueError(
                f"Final k={k} too large: sparse expansion yields only "
                f"k_clusters*(2*stride-1) = {k_clusters}*{2 * stride - 1} = "
                f"{n_cands} candidates per query. Reduce k or raise "
                "k_clusters."
            )


def post_process_sw(
    neighbors: np.ndarray,
    query_mat: np.ndarray,
    query_lens: np.ndarray,
    fetch_windows,
    stride: int,
    k: int,
    k_clusters: int,
    bound: int,
    query_chunk: int = 512,
    sparse_off: np.ndarray | None = None,
    dense_off: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Smith-Waterman post-processing (reference post_process_sw_{static,
    dynamic}, post_processor.cpp:357-549): expand sparse hits, rerank every
    candidate slot by SW score against the (wrapped) query, keep top-k by
    score descending.  Unlike the L2 path there is no dense short-circuit —
    the reference reranks even at stride 1.

    Args:
      query_mat/query_lens: query byte matrix (wrapped reads) + true lengths.
      fetch_windows: callable(ids [M]) -> (bytes [M, W], lens [M]) unwrapped
        candidate windows.

    Returns (final_ids [Q, k] int64, final_scores [Q, k] int32).
    """
    from deepreadmapper_tpu.ops.sw import sw_scores

    check_invariant(k, k_clusters, stride)
    if stride == 1:
        if k > k_clusters:
            raise ValueError(
                f"Final k={k} > k_clusters={k_clusters}: the dense SW rerank "
                "has only k_clusters candidates per query."
            )
        # Identity "expansion" (find_sequences dense short-circuit) but the
        # SW rerank still runs over the k_clusters hits.
        cand_ids = neighbors[:, :k_clusters].astype(np.int64)
    else:
        cand_ids, _ = expand_candidates(
            neighbors, stride, bound, k_clusters, sparse_off, dense_off
        )
    q, c = cand_ids.shape
    out_ids = np.empty((q, k), dtype=np.int64)
    out_scores = np.empty((q, k), dtype=np.int32)
    for start in range(0, q, query_chunk):
        end = min(start + query_chunk, q)
        ids_b = cand_ids[start:end]
        nb = end - start
        flat_ids = ids_b.ravel()
        valid = flat_ids >= 0
        w_mat, w_lens = fetch_windows(np.where(valid, flat_ids, 0))
        qa = np.repeat(query_mat[start:end], c, axis=0)
        ql = np.repeat(query_lens[start:end], c, axis=0)
        scores = sw_scores(w_mat, w_lens, qa, ql)
        scores = np.where(valid, scores, np.int32(np.iinfo(np.int32).min))
        scores = scores.reshape(nb, c)
        order = np.argsort(-scores, axis=1, kind="stable")[:, :k]
        out_scores[start:end] = np.take_along_axis(scores, order, axis=1)
        out_ids[start:end] = np.take_along_axis(ids_b, order, axis=1)
    return out_ids, out_scores


def post_process_l2(
    neighbors: np.ndarray,
    distances: np.ndarray,
    query_embeddings: np.ndarray,
    embed_windows,
    stride: int,
    k: int,
    k_clusters: int,
    bound: int,
    force_rerank: bool = False,
    sparse_off: np.ndarray | None = None,
    dense_off: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """L2 post-processing (reference post_process_l2_{static,dynamic}).

    Args:
      neighbors/distances: ANN output [Q, >=k or >=k_clusters].
      query_embeddings: [Q, D] fp32 (the same embeddings that searched).
      embed_windows: callable(np.ndarray unique_window_ids) -> [U, D] fp32
        embeddings of those windows (the "vectorize only unique candidates"
        step; index/pipeline provides window fetch + encoder).
      bound: dense-id validity bound (len(ref window list) in static mode,
        genome length in dynamic mode).
      force_rerank: rerank even at stride == 1 (beyond reference, which
        passes dense results through, post_processor.cpp:630-657): the ANN
        candidates are re-embedded exactly and re-ordered by true L2 —
        restores near-exact top-1 when the index metric is quantized (PQ at
        8 B/vector scores 92.9% raw vs ~99.7% reranked at 10M windows).

    Returns (final_ids [Q, k] int64, final_dists [Q, k] fp32).
    """
    check_invariant(k, k_clusters, stride)
    if stride == 1 and not force_rerank:
        # Dense: passthrough of ANN ids/distances (squared L2, FAISS style).
        return (
            neighbors[:, :k].astype(np.int64),
            distances[:, :k].astype(np.float32),
        )

    if stride == 1:
        # Dense rerank: the candidate set IS the ANN list (no expansion).
        if k > neighbors.shape[1]:
            raise ValueError(
                f"Final k={k} > ANN candidate count {neighbors.shape[1]} "
                "for the dense rerank."
            )
        cand_ids = neighbors.astype(np.int64)
    else:
        cand_ids, _ = expand_candidates(
            neighbors, stride, bound, k_clusters, sparse_off, dense_off
        )
    uniq, pool_idx = unique_pool(cand_ids)
    pool_emb = embed_windows(uniq)
    d, ids = _rerank_l2_device(
        jnp.asarray(query_embeddings, dtype=jnp.float32),
        jnp.asarray(pool_emb, dtype=jnp.float32),
        jnp.asarray(pool_idx),
        jnp.asarray(cand_ids),
        k,
    )
    return np.asarray(ids, dtype=np.int64), np.asarray(d, dtype=np.float32)
