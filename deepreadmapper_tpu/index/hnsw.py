"""HNSW index with a vectorized batched beam search.

The reference's active engine is FAISS IndexHNSWPQ (src/hnswpq/): HNSW graph
over PQ codes, per-query sequential descent parallelized with OpenMP.  A
literal port would be a poor accelerator program — graph traversal is sequential
and divergent.  Instead (SURVEY.md §3.4, §7) the per-query loop of
hnswm's searchLayer (src/hnswm/hnsw.cpp:575-633) is vectorized ACROSS a batch
of queries:

  * upper levels: greedy descent, all queries stepping in lockstep
    (gather neighbor rows -> distances -> conditional move);
  * level 0: fixed-ef batched beam search — each iteration expands every
    query's best unexpanded beam slot, gathers its padded neighbor row,
    computes distances (exact fp32 or PQ/ADC), masks duplicates against the
    beam, and merges with lax.top_k.  The visited-set of the scalar algorithm
    (visited.h epoch trick) becomes the beam-dedup mask — fixed shapes, no
    hashing.

Distances: storage="pq" reproduces FAISS IndexHNSWPQ's ADC search (and its
quantization error); storage="flat" searches exact fp32 (an IndexHNSWFlat
equivalent, higher recall).  Graph construction (hnsw_build.py) always uses
exact vectors — better graphs than FAISS's code-based construction.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from deepreadmapper_tpu.config import BuildConfig
from deepreadmapper_tpu.index.hnsw_build import HNSWGraphData, build_hnsw
from deepreadmapper_tpu.index.registry import register_index
from deepreadmapper_tpu.ops import pq as pq_ops

_INF = np.float32(np.inf)  # np scalar: a module-level jnp call would init the backend at import


def _make_dist_fn(mode: str, storage, qdata):
    """Returns dist(ids [Q, W]) -> [Q, W] fp32 (ids assumed valid/clamped)."""
    if mode == "flat":
        vectors = storage  # [N, D]
        q = qdata  # [Q, D]

        def dist(ids):
            v = vectors[ids]  # [Q, W, D]
            diff = v - q[:, None, :]
            return jnp.sum(diff * diff, axis=-1)

    else:  # "pq"
        codes = storage  # [N, m] uint8
        tables = qdata  # [Q, m, ksub]

        def dist(ids):
            c = codes[ids].astype(jnp.int32)  # [Q, W, m]
            # t[q, w, m] = tables[q, m, c[q, w, m]]
            t = jnp.take_along_axis(
                tables[:, None, :, :],  # [Q, 1, m, ksub]
                c[:, :, :, None],  # [Q, W, m, 1]
                axis=3,
            )[..., 0]
            return jnp.sum(t, axis=-1)

    return dist


@functools.partial(jax.jit, static_argnames=("ef", "iters", "k", "mode", "descent_steps"))
def hnsw_search_device(
    neigh0: jax.Array,
    levels: tuple,  # tuple of (gids [nl] int32 sorted, nbr_rows [nl, M] int32)
    entry_gid: jax.Array,
    storage: jax.Array,
    qdata: jax.Array,
    *,
    ef: int,
    iters: int,
    k: int,
    mode: str,
    descent_steps: int = 16,
):
    qn = qdata.shape[0]
    dist = _make_dist_fn(mode, storage, qdata)

    # ---- upper-level greedy descent (lockstep across the batch) ----
    cur_gid = jnp.broadcast_to(entry_gid.astype(jnp.int32), (qn,))
    cur_d = dist(cur_gid[:, None])[:, 0]
    for gids, nbr_rows in reversed(levels):  # highest level first
        rows = jnp.searchsorted(gids, cur_gid).astype(jnp.int32)
        rows = jnp.clip(rows, 0, gids.shape[0] - 1)
        # Entry may not exist at this level for later queries — it always
        # does in HNSW (entry is the max-level node), safe.

        def body(_, carry):
            cur_gid, rows, cur_d = carry
            nr = nbr_rows[rows]  # [Q, M]
            valid = nr >= 0
            ng = gids[jnp.maximum(nr, 0)]
            nd = jnp.where(valid, dist(ng), _INF)
            bi = jnp.argmin(nd, axis=1)
            bd = jnp.take_along_axis(nd, bi[:, None], axis=1)[:, 0]
            bg = jnp.take_along_axis(ng, bi[:, None], axis=1)[:, 0]
            br = jnp.take_along_axis(nr, bi[:, None], axis=1)[:, 0]
            move = bd < cur_d
            return (
                jnp.where(move, bg, cur_gid),
                jnp.where(move, br, rows),
                jnp.minimum(bd, cur_d),
            )

        cur_gid, rows, cur_d = jax.lax.fori_loop(
            0, descent_steps, body, (cur_gid, rows, cur_d)
        )

    # ---- level-0 batched beam search ----
    width = neigh0.shape[1]
    beam_ids = jnp.full((qn, ef), -1, dtype=jnp.int32)
    beam_ids = beam_ids.at[:, 0].set(cur_gid)
    beam_d = jnp.full((qn, ef), _INF).at[:, 0].set(cur_d)
    expanded = jnp.zeros((qn, ef), dtype=bool)

    def step(_, carry):
        beam_ids, beam_d, expanded = carry
        frontier_d = jnp.where(expanded | (beam_ids < 0), _INF, beam_d)
        j = jnp.argmin(frontier_d, axis=1)  # [Q]
        has_frontier = jnp.take_along_axis(frontier_d, j[:, None], 1)[:, 0] < _INF
        expanded = expanded.at[jnp.arange(qn), j].set(True)
        node = jnp.take_along_axis(beam_ids, j[:, None], 1)[:, 0]
        nbrs = neigh0[jnp.maximum(node, 0).astype(jnp.int32)]  # [Q, 2M]
        valid = (nbrs >= 0) & has_frontier[:, None]
        ng = jnp.maximum(nbrs, 0).astype(jnp.int32)
        nd = jnp.where(valid, dist(ng), _INF)
        dup = (ng[:, :, None] == beam_ids[:, None, :]).any(axis=2)
        nd = jnp.where(dup, _INF, nd)
        cat_d = jnp.concatenate([beam_d, nd], axis=1)
        cat_i = jnp.concatenate([beam_ids, jnp.where(nd < _INF, ng, -1)], axis=1)
        cat_e = jnp.concatenate(
            [expanded, jnp.zeros_like(nd, dtype=bool)], axis=1
        )
        neg, pos = jax.lax.top_k(-cat_d, ef)
        return (
            jnp.take_along_axis(cat_i, pos, axis=1),
            -neg,
            jnp.take_along_axis(cat_e, pos, axis=1),
        )

    beam_ids, beam_d, expanded = jax.lax.fori_loop(
        0, iters, step, (beam_ids, beam_d, expanded)
    )
    return beam_d[:, :k], beam_ids[:, :k]


def _graph_to_device(g: HNSWGraphData):
    levels = tuple(
        (jnp.asarray(gids), jnp.asarray(nbrs))
        for gids, nbrs in zip(g.level_gids, g.level_nbrs)
    )
    return jnp.asarray(g.neighbors0), levels, jnp.asarray(g.entry_gid)


@register_index("HNSWPQ")
class HNSWPQIndex:
    """HNSW graph + PQ codes, ADC search (FAISS IndexHNSWPQ equivalent)."""

    storage_mode = "pq"

    def __init__(self, graph: HNSWGraphData, codes, codebook, vectors, ntotal):
        self.graph = graph
        self.codes = codes
        self.codebook = codebook
        self.vectors = vectors  # only kept for flat mode / None for pq
        self.ntotal = ntotal
        self._dev = None

    @classmethod
    def build(cls, embeddings: np.ndarray, cfg: BuildConfig | None = None):
        cfg = cfg or BuildConfig()
        if cfg.build_mode == "knn":
            from deepreadmapper_tpu.index.knn_build import build_hnsw_knn

            graph = build_hnsw_knn(
                embeddings, m=cfg.m_hnsw, seed=cfg.seed, level_mode=cfg.level_mode
            )
        else:
            graph = build_hnsw(
                embeddings, m=cfg.m_hnsw, efc=cfg.efc, seed=cfg.seed,
                level_mode=cfg.level_mode,
            )
        if cls.storage_mode == "pq":
            train = pq_ops.sample_training_set(embeddings, cfg.sample_rate)
            cb = pq_ops.train_pq(
                train, m=cfg.m_pq, nbits=cfg.nbits,
                iters=cfg.kmeans_iters, seed=cfg.seed,
            )
            codes = pq_ops.encode_pq(embeddings, cb)
            return cls(graph, codes, cb, None, embeddings.shape[0])
        return cls(graph, None, None, embeddings.astype(np.float32), embeddings.shape[0])

    def _device(self):
        if self._dev is None:
            neigh0, levels, entry = _graph_to_device(self.graph)
            if self.storage_mode == "pq":
                storage = jnp.asarray(self.codes)
            else:
                storage = jnp.asarray(self.vectors)
            self._dev = (neigh0, levels, entry, storage)
        return self._dev

    def search(self, queries: np.ndarray, k: int, ef: int = 128,
               stats: dict | None = None):
        """stats, when a dict is passed, is filled with SEARCH-EFFORT
        counters (the hnswm distance-call profiling idea,
        src/hnswm/hnsw.cpp:18-39, recast for the fixed-shape
        beam): the SPMD beam search does DETERMINISTIC
        work per query — `ef` expansion iterations of 2M neighbor slots
        each plus the greedy level descent — so the counters are computed
        from the graph shape rather than device-side instrumentation
        (which would serialize the beam)."""
        neigh0, levels, entry, storage = self._device()
        ef = max(ef, k)
        if stats is not None:
            g = self.graph
            upper = sum(lg.shape[0] for lg in g.level_gids)
            stats["queries"] = stats.get("queries", 0) + len(queries)
            stats["beam_expansions_per_query"] = ef
            stats["neighbor_slots_scored_per_query"] = ef * 2 * g.m
            stats["descent_levels"] = g.max_level
            stats["graph_degree"] = 2 * g.m
            stats["upper_level_nodes"] = upper
            stats["ntotal"] = self.ntotal
            stats["coverage"] = round(
                ef * 2 * g.m / max(self.ntotal, 1), 6
            )
        q = jnp.asarray(queries, jnp.float32)
        if self.storage_mode == "pq":
            qdata = pq_ops.adc_tables(q, self.codebook.centroids)
        else:
            qdata = q
        d, i = hnsw_search_device(
            neigh0, levels, entry, storage, qdata,
            ef=ef, iters=ef, k=min(k, ef), mode=self.storage_mode,
        )
        i = np.array(i, dtype=np.int64)
        d = np.array(d, dtype=np.float32)
        d[i < 0] = np.inf
        if k > i.shape[1]:
            i = np.pad(i, ((0, 0), (0, k - i.shape[1])), constant_values=-1)
            d = np.pad(d, ((0, 0), (0, k - d.shape[1])), constant_values=np.inf)
        return i, d

    # -- persistence --
    def save(self, index_prefix: str) -> None:
        os.makedirs(index_prefix, exist_ok=True)
        g = self.graph
        payload = {
            "neighbors0": g.neighbors0,
            "entry_gid": g.entry_gid,
            "max_level": g.max_level,
            "m": g.m,
            "ntotal": self.ntotal,
            "n_levels": len(g.level_gids),
        }
        for l, (gids, nbrs) in enumerate(zip(g.level_gids, g.level_nbrs)):
            payload[f"gids_{l}"] = gids
            payload[f"nbrs_{l}"] = nbrs
        if self.storage_mode == "pq":
            payload["codes"] = self.codes
            payload["centroids"] = np.asarray(self.codebook.centroids)
        else:
            payload["vectors"] = self.vectors
        np.savez(os.path.join(index_prefix, "hnsw.npz"), **payload)

    @classmethod
    def load(cls, index_prefix: str, config: dict | None = None):
        z = np.load(os.path.join(index_prefix, "hnsw.npz"))
        n_levels = int(z["n_levels"])
        graph = HNSWGraphData(
            neighbors0=z["neighbors0"],
            level_gids=[z[f"gids_{l}"] for l in range(n_levels)],
            level_nbrs=[z[f"nbrs_{l}"] for l in range(n_levels)],
            entry_gid=int(z["entry_gid"]),
            max_level=int(z["max_level"]),
            m=int(z["m"]),
        )
        if cls.storage_mode == "pq":
            cb = pq_ops.PQCodebook(jnp.asarray(z["centroids"]))
            return cls(graph, z["codes"], cb, None, int(z["ntotal"]))
        return cls(graph, None, None, z["vectors"], int(z["ntotal"]))


@register_index("HNSWFLAT")
class HNSWFlatIndex(HNSWPQIndex):
    """HNSW graph over exact fp32 vectors (IndexHNSWFlat equivalent)."""

    storage_mode = "flat"
