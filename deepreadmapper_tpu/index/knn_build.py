"""Graph construction: exact kNN as matmuls + vectorized pruning.

The reference ships a second, parallel graph builder — the GANN-paper CPU port
(src/gann_hnsw/gann_hnsw.cpp:168-278): every worker brute-forces a kNN graph
over its partition (dmin=M forward edges), backward edges are gathered and
scattered in (:612-659), and degrees are pruned to dmax=2M.  That design is a
much better fit for an accelerator than incremental HNSW insertion, so this build
inverts the default: the *entire* kNN graph is computed as tiled
``||a-b||^2 = ||a||^2 - 2ab + ||b||^2`` matmuls (ops/topk.py), the FAISS
shrink heuristic (faiss HNSW::shrink_neighbor_list semantics, same as
hnsw_build._select_neighbors_heuristic) runs as ONE lax.scan over candidate
rank — all N nodes pruned in lockstep — and backward edges are a
host integer scatter followed by a second vectorized prune to the 2M cap.

Upper HNSW levels reuse the same deterministic exponential level assignment as
the insertion builder (hnsw_build.assign_levels) so the two builders produce
interchangeable HNSWGraphData; upper layers are tiny (N/M^l nodes) and are
built by the same kNN+prune on the subset.

Complexity is O(N^2 D) flops — pure matmul work.  For genome-scale N the
builder streams reference chunks, so memory is O(N*K), not O(N^2).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from deepreadmapper_tpu.index.hnsw_build import HNSWGraphData, assign_levels
from deepreadmapper_tpu.ops.topk import l2_topk

_BIG = np.float32(3.4e38)  # np scalar: a module-level jnp call would init the backend at import


def exact_knn(
    vectors: np.ndarray,
    k: int,
    query_chunk: int = 8192,
    ref_chunk: int = 131072,
):
    """Self-excluded exact kNN of every row against all rows.

    Returns (dists [N,k] squared-L2 ascending, ids [N,k], -1 padded when
    N-1 < k).  Queries stream in chunks so peak memory is
    O(query_chunk * ref_chunk), refs stream inside l2_topk.
    """
    vj = vectors if isinstance(vectors, jax.Array) else jnp.asarray(
        np.asarray(vectors, dtype=np.float32)
    )  # device-resident ONCE; never re-uploaded per chunk
    n = vj.shape[0]
    kq = min(k + 1, n)  # +1 so the self hit can be dropped
    out_d = np.empty((n, k), dtype=np.float32)
    out_i = np.empty((n, k), dtype=np.int64)
    # Dispatch every chunk before fetching any result: a fetch blocks the
    # host, so interleaving fetches with dispatch would serialize the sweep.
    pending = []
    for s in range(0, n, query_chunk):
        e = min(s + query_chunk, n)
        q = vj[s:e]
        if e - s < query_chunk:
            # pad the tail chunk so every call shares ONE compiled program
            # (remote AOT compiles cost tens of seconds per shape signature)
            q = jnp.pad(q, ((0, query_chunk - (e - s)), (0, 0)))
        pending.append((s, e, l2_topk(q, vj, kq, chunk=ref_chunk)))
    for s, e, (d, i) in pending:
        d = np.asarray(d)[: e - s]
        i = np.asarray(i, dtype=np.int64)[: e - s]
        rows = np.arange(s, e)[:, None]
        # Drop the self column: the self hit has distance exactly 0 and wins
        # the lower-id tie-break unless an identical lower-id row exists, so
        # locate it explicitly and compact the row around it.
        self_col = np.argmax(i == rows, axis=1)
        has_self = np.take_along_axis(i == rows, self_col[:, None], axis=1)[:, 0]
        self_col = np.where(has_self, self_col, kq - 1)
        keep = np.arange(kq)[None, :] != self_col[:, None]
        d = d[keep].reshape(e - s, kq - 1)
        i = i[keep].reshape(e - s, kq - 1)
        if kq - 1 < k:
            pad = k - (kq - 1)
            d = np.pad(d, ((0, 0), (0, pad)), constant_values=np.float32(3.4e38))
            i = np.pad(i, ((0, 0), (0, pad)), constant_values=-1)
        out_d[s:e] = d[:, :k]
        out_i[s:e] = i[:, :k]
    return out_d, out_i


@functools.partial(jax.jit, static_argnames=("cap",))
def _prune_heuristic_device(vecs, cand_vecs, cand_d, cand_valid, cap: int):
    """FAISS shrink heuristic for a slab of nodes at once.

    vecs       [B, D]    the node vectors (unused in the rule but kept for
                         clarity; the rule uses candidate-candidate distances)
    cand_vecs  [B, K, D] candidate vectors, rank-ascending by cand_d
    cand_d     [B, K]    squared L2 node->candidate
    cand_valid [B, K]    bool
    Keep candidate j iff d(node, c_j) < d(c_j, c_s) for every already-kept s
    (and fewer than cap kept so far).  Returns keep mask [B, K].
    """
    del vecs
    b, kk, _ = cand_vecs.shape
    # Pairwise candidate-candidate squared L2: [B, K, K] batched matmul.
    sq = jnp.sum(cand_vecs * cand_vecs, axis=-1)
    cross = jnp.einsum("bkd,bjd->bkj", cand_vecs, cand_vecs)
    pair = sq[:, :, None] + sq[:, None, :] - 2.0 * cross

    def step(carry, j):
        keep, count = carry
        # min distance from candidate j to any already-kept candidate
        dj = jnp.where(keep, pair[:, j, :], _BIG).min(axis=1)
        ok = cand_valid[:, j] & (cand_d[:, j] < dj) & (count < cap)
        keep = keep.at[:, j].set(ok)
        return (keep, count + ok.astype(jnp.int32)), None

    init = (jnp.zeros((b, kk), dtype=bool), jnp.zeros((b,), dtype=jnp.int32))
    (keep, _), _ = jax.lax.scan(step, init, jnp.arange(kk))
    return keep


def prune_neighbors(
    vectors: np.ndarray,
    cand_ids: np.ndarray,
    cand_d: np.ndarray,
    cap: int,
    slab: int | None = None,
) -> np.ndarray:
    """Run the device prune slab-by-slab; compact kept ids to [N, cap], -1 pad.

    cand_ids rows must be distance-ascending (exact_knn output order)."""
    vj = vectors if isinstance(vectors, jax.Array) else jnp.asarray(
        np.asarray(vectors, np.float32)
    )
    n, kk = cand_ids.shape
    if slab is None:
        # Bound the [slab, K, K] pairwise tensor (+ its copy) to ~2 GB HBM.
        slab = max(256, min(16384, int(2e9 / max(kk * kk * 8, 1))))
    out = np.full((n, cap), -1, dtype=np.int32)
    for s in range(0, n, slab):
        e = min(s + slab, n)
        b = e - s
        ids = cand_ids[s:e]
        valid = ids >= 0
        if b < slab:  # pad the tail slab: one compiled program per width
            ids_p = np.pad(ids, ((0, slab - b), (0, 0)), constant_values=-1)
            d_p = np.pad(cand_d[s:e], ((0, slab - b), (0, 0)))
            val_p = np.pad(valid, ((0, slab - b), (0, 0)))
            vq = jnp.pad(vj[s:e], ((0, slab - b), (0, 0)))
        else:
            ids_p, d_p, val_p, vq = ids, cand_d[s:e], valid, vj[s:e]
        gat = jnp.take(vj, jnp.asarray(np.maximum(ids_p, 0)), axis=0)
        keep = np.asarray(
            _prune_heuristic_device(
                vq,
                gat,
                jnp.asarray(d_p),
                jnp.asarray(val_p),
                cap,
            )
        )[:b]
        # compact kept ids to the left (stable: kept entries stay rank-sorted)
        order = np.argsort(~keep, axis=1, kind="stable")
        c = min(cap, kk)
        sel = np.take_along_axis(ids, order, axis=1)[:, :c]
        nkeep = keep.sum(axis=1, keepdims=True)
        out[s:e, :c] = np.where(np.arange(c)[None, :] < nkeep, sel, -1)
    return out


@jax.jit
def _edge_dists(v, vq, cand):
    """Squared L2 from each slab node to its candidate list; BIG for -1."""
    g = jnp.take(v, jnp.maximum(cand, 0), axis=0)
    dd = jnp.sum((g - vq[:, None, :]) ** 2, axis=2)
    return jnp.where(cand >= 0, dd, _BIG)


def _add_reverse_edges(fwd: np.ndarray, n: int, cap: int):
    """GANN backward-edge gather/scatter (gann_hnsw.cpp:580-659) as fully
    vectorized numpy integer work: every edge a->b contributes b->a; returns
    candidate lists [N, fwd_w + in_cap] (forward first, then incoming), -1
    padded.  Hub in-degree is capped at 4*cap — hubs are already densely
    connected and the later distance-rank+prune keeps <= cap anyway."""
    fwd_w = fwd.shape[1]
    src = np.repeat(np.arange(n, dtype=np.int64), fwd_w)
    dst = fwd.reshape(-1).astype(np.int64)
    ok = dst >= 0
    src, dst = src[ok], dst[ok]
    order = np.argsort(dst, kind="stable")
    rsrc, rdst = src[order], dst[order]
    counts = np.bincount(rdst, minlength=n)
    offs = np.concatenate([[0], np.cumsum(counts[:-1])])
    pos = np.arange(rdst.size, dtype=np.int64) - offs[rdst]
    in_cap = int(min(counts.max(initial=0), 4 * cap))
    cand = np.full((n, fwd_w + in_cap), -1, dtype=np.int64)
    cand[:, :fwd_w] = fwd
    sel = pos < in_cap
    cand[rdst[sel], fwd_w + pos[sel]] = rsrc[sel]
    return cand


def _dedup_rows(cand: np.ndarray) -> np.ndarray:
    """Per-row dedup preserving first appearance; -1 padded.  Vectorized:
    sort each row by (value, position), mark non-first members of each equal
    run, scatter the mask back, then stable-compact valid entries left."""
    n, w = cand.shape
    if w == 0:
        return cand.copy()
    posk = np.arange(w, dtype=np.int64)[None, :]
    key = cand * w + posk  # value-major, position-minor; -1 stays smallest
    order = np.argsort(key, axis=1, kind="stable")
    sv = np.take_along_axis(cand, order, axis=1)
    dup_sorted = np.zeros((n, w), dtype=bool)
    dup_sorted[:, 1:] = sv[:, 1:] == sv[:, :-1]
    dup = np.zeros((n, w), dtype=bool)
    np.put_along_axis(dup, order, dup_sorted, axis=1)
    valid = (cand >= 0) & ~dup
    corder = np.argsort(~valid, axis=1, kind="stable")
    out = np.take_along_axis(np.where(valid, cand, -1), corder, axis=1)
    return out


def _prune_host(v: np.ndarray, cand: np.ndarray, d: np.ndarray, cap: int):
    """Host shrink heuristic (same rule as _prune_heuristic_device)."""
    from deepreadmapper_tpu.index.hnsw_build import _select_neighbors_heuristic

    n = cand.shape[0]
    out = np.full((n, cap), -1, dtype=np.int32)
    for r in range(n):
        ok = cand[r] >= 0
        sel = _select_neighbors_heuristic(
            v, r, list(zip(d[r][ok].tolist(), cand[r][ok].tolist())), cap
        )
        out[r, : len(sel)] = sel
    return out


def _knn_layer_host(v: np.ndarray, m: int, cap: int, k_cand: int) -> np.ndarray:
    """Tiny layers (upper HNSW levels) run entirely on host: a device round
    would recompile per distinct level size (~20s each on remote AOT)."""
    n = v.shape[0]
    # x2+y2-2xy form: the [n,n,D] broadcast difference would transiently
    # allocate up to ~8.6 GB at the n=4096 cutoff for a 67 MB result.
    sq = (v * v).sum(axis=1)
    d2 = (sq[:, None] + sq[None, :] - 2.0 * (v @ v.T)).astype(np.float32)
    np.fill_diagonal(d2, np.inf)
    k = min(k_cand, n - 1)
    ki = np.argsort(d2, axis=1, kind="stable")[:, :k]
    kd = np.take_along_axis(d2, ki, axis=1)
    fwd = _prune_host(v, ki.astype(np.int64), kd, m)
    cand = _dedup_rows(_add_reverse_edges(fwd, n, cap))
    dc = np.where(
        cand >= 0,
        np.take_along_axis(d2, np.maximum(cand, 0), axis=1),
        np.float32(np.inf),
    )
    order = np.argsort(dc, axis=1, kind="stable")
    cand = np.take_along_axis(cand, order, axis=1)
    dc = np.take_along_axis(dc, order, axis=1)
    return _prune_host(v, cand, dc, cap)


def _knn_layer(
    vectors: np.ndarray, m: int, cap: int, k_cand: int
) -> np.ndarray:
    """One graph layer: exact kNN -> heuristic prune to m forward edges ->
    reverse edges -> rank by distance -> prune to cap.  Returns [N, cap]."""
    n = vectors.shape[0]
    if n <= 1:
        return np.full((n, cap), -1, dtype=np.int32)
    if n <= 4096:
        return _knn_layer_host(np.asarray(vectors, np.float32), m, cap, k_cand)
    vj = vectors if isinstance(vectors, jax.Array) else jnp.asarray(
        np.asarray(vectors, np.float32)
    )
    kd, ki = exact_knn(vj, min(k_cand, n - 1))
    fwd = prune_neighbors(vj, ki, kd, m)
    cand = _dedup_rows(_add_reverse_edges(fwd, n, cap))
    # distance-rank the merged candidate lists slab-wise on device
    width = cand.shape[1]
    d = np.empty((n, width), dtype=np.float32)
    slab = 16384
    for s in range(0, n, slab):
        e = min(s + slab, n)
        b = e - s
        if b < slab:
            vq = jnp.pad(vj[s:e], ((0, slab - b), (0, 0)))
            cp = np.pad(cand[s:e], ((0, slab - b), (0, 0)), constant_values=-1)
        else:
            vq, cp = vj[s:e], cand[s:e]
        d[s:e] = np.asarray(_edge_dists(vj, vq, jnp.asarray(cp)))[:b]
    order = np.argsort(d, axis=1, kind="stable")
    cand = np.take_along_axis(cand, order, axis=1)
    d = np.take_along_axis(d, order, axis=1)
    # Hub nodes can have huge in-degree; the heuristic keeps <= cap diverse
    # neighbors and essentially never reaches past the nearest few*cap, so
    # bound the pairwise-prune width (keeps the [slab,K,K] tensor in HBM).
    w = min(cand.shape[1], max(4 * cap, k_cand))
    return prune_neighbors(vj, cand[:, :w], d[:, :w], cap)


def build_hnsw_knn(
    vectors: np.ndarray,
    m: int = 16,
    seed: int = 5489,
    k_cand: int | None = None,
    level_mode: str = "rng",
) -> HNSWGraphData:
    """Matmul kNN-graph HNSW construction (GANN-equivalent).

    Produces the same HNSWGraphData layout as hnsw_build.build_hnsw so the
    batched beam search (hnsw.py) is builder-agnostic.  k_cand (default 3M)
    is the kNN width fed to the pruning heuristic — wider = better diversity.
    """
    vd = vectors if isinstance(vectors, jax.Array) else jnp.asarray(
        np.asarray(vectors, np.float32)
    )
    n = vd.shape[0]
    if k_cand is None:
        k_cand = 3 * m
    if level_mode == "rng":
        levels = assign_levels(n, m, seed)
    else:
        from deepreadmapper_tpu.index.hnsw_build import _levels_for

        levels = _levels_for(np.asarray(vectors, np.float32), m, seed, level_mode)
    max_level = int(levels.max(initial=0))

    neighbors0 = _knn_layer(vd, m, 2 * m, k_cand)

    level_gids: list[np.ndarray] = []
    level_nbrs: list[np.ndarray] = []
    for lvl in range(1, max_level + 1):
        gids = np.flatnonzero(levels >= lvl).astype(np.int64)
        nb = _knn_layer(
            vd[jnp.asarray(gids)], m, m, min(k_cand, max(int(gids.size) - 1, 1))
        )
        level_gids.append(gids)
        level_nbrs.append(nb.astype(np.int32))  # already row indices in-level
    # entry point: deepest node, lowest id on ties (hnsw_build puts the last
    # inserted deepest node at entry; any top-level node is a valid entry)
    if max_level >= 1:
        entry = int(level_gids[-1][0])
    else:
        entry = 0 if n else -1
    return HNSWGraphData(
        neighbors0=neighbors0.astype(np.int32),
        level_gids=level_gids,
        level_nbrs=level_nbrs,
        entry_gid=entry,
        max_level=max_level,
        m=m,
    )
