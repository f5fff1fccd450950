"""HNSW graph construction (host).

A from-scratch HNSW builder in the spirit of the reference's native engines
(FAISS IndexHNSWPQ, src/hnswpq/index.cpp:110-175; hand-written hnswm,
src/hnswm/hnsw.cpp:466-796): exponential level assignment (seeded,
deterministic), efConstruction beam search per insert, heuristic neighbor
selection with degree pruning M / 2M.

Construction is sequential by nature, so it runs on host over fp32 vectors
with vectorized numpy distance batches; the search side (hnsw.py) is the
vectorized part.  A native C++ builder can drop in behind the same arrays
for genome-scale builds.

Graph layout produced (device-friendly padded CSR):
  neighbors0  [N, 2M] int32, -1 padded              (level 0)
  levels[l>=1]: gids [nl] int64 ascending, nbr_rows [nl, M] int32 row indices
                within the SAME level, -1 padded
  entry_gid, max_level
"""

from __future__ import annotations

import heapq
from typing import NamedTuple

import numpy as np


class HNSWGraphData(NamedTuple):
    neighbors0: np.ndarray
    level_gids: list[np.ndarray]
    level_nbrs: list[np.ndarray]
    entry_gid: int
    max_level: int
    m: int


def assign_levels(n: int, m: int, seed: int = 5489) -> np.ndarray:
    """Exponential level assignment, deterministic by seed (hnswlib/FAISS
    use mult = 1/ln(M))."""
    rng = np.random.default_rng(seed)
    mult = 1.0 / np.log(m)
    u = rng.random(n)
    return np.floor(-np.log(u) * mult).astype(np.int32)


def _layer_sizes(n: int, m: int) -> list[int]:
    """Expected node count per level from the exponential CDF — the
    reference's deterministic replacement for per-node RNG draws
    (src/hnswm/hnsw.cpp:331-349 calculateNumNodesInLayers_): size[k] =
    round((cdf(k+1)-cdf(k))*n) with mean 1/ln(M), zeros dropped, last entry
    adjusted so the sizes sum exactly to n."""
    ml = 1.0 / np.log(m)
    cdf = lambda x: 1.0 - np.exp(-x / ml)  # noqa: E731
    k = np.arange(64, dtype=np.float64)
    sizes = np.round((cdf(k + 1) - cdf(k)) * n).astype(np.int64)
    sizes = sizes[sizes > 0]
    if sizes.size == 0:
        return [n]
    sizes[-1] = n - int(sizes[:-1].sum())
    if sizes[-1] <= 0:  # tiny n rounding: fold the tail into level 0
        sizes = sizes[:-1]
        sizes[-1] = n - int(sizes[:-1].sum())
    return [int(s) for s in sizes]


def _segment_medoids(v: np.ndarray, starts: np.ndarray, ends: np.ndarray):
    """Index (into v) of the point closest to each segment's mean.  Segments
    are contiguous [start, end) ranges; vectorized over all segments."""
    starts = np.asarray(starts, dtype=np.int64)
    ends = np.asarray(ends, dtype=np.int64)
    lens = ends - starts
    sums = np.add.reduceat(v, starts, axis=0)
    # reduceat quirk: if starts[i] >= starts[i+1] it returns v[starts[i]]
    # alone; our segments are strictly increasing and non-empty, so fine.
    mu = sums / lens[:, None]
    seg = np.repeat(np.arange(starts.size), lens)
    pts = v[starts[0] : ends[-1]]  # segments are contiguous and adjacent
    d2 = ((pts - mu[seg]) ** 2).sum(axis=1)
    seg_min = np.minimum.reduceat(d2, starts - starts[0])
    hit = np.flatnonzero(d2 == seg_min[seg])
    # first hit per segment (ties -> lowest index, matching min_element)
    _, first = np.unique(seg[hit], return_index=True)
    return hit[first] + starts[0]


def assign_levels_centroid(vectors: np.ndarray, m: int) -> np.ndarray:
    """hnswm's deterministic centroid-partition level assignment
    (src/hnswm/hnsw.cpp:701-796 buildIndex), adapted to nested HNSW levels.

    Per-level counts come from the exponential CDF (no RNG at all); the
    nodes RAISED to each upper level are the medoids of equal contiguous
    sub-partitions of the insertion order, chosen top-down, with every
    selected node becoming a partition endpoint for the next level below
    (so upper-level nodes spread evenly through the data order — for genome
    windows, evenly along the genome).  The reference inserts each selection
    into one layer of a non-nested structure; here a node selected at layer
    L gets level() = L in the standard nested builder, which reproduces the
    same per-layer membership counts.
    """
    v = np.ascontiguousarray(vectors, dtype=np.float32)
    n = v.shape[0]
    sizes = _layer_sizes(n, m)
    levels = np.zeros(n, dtype=np.int32)
    # partition endpoints (exclusive), as in the reference: (-1, n) to start
    parts = np.array([-1, n], dtype=np.int64)
    for layer in range(len(sizes) - 1, 0, -1):
        n_points = sizes[layer]
        n_parts = parts.size - 1
        per_part = max(1, int(round(n_points / n_parts)))
        new_parts = []
        for i in range(n_parts):
            a, b = int(parts[i]), int(parts[i + 1])
            new_parts.append(np.array([a], dtype=np.int64))
            size = b - a - 1
            if size <= 0:
                continue
            if size < per_part:
                sel = np.arange(a + 1, b, dtype=np.int64)
            else:
                sub = size // per_part
                bounds = a + 1 + sub * np.arange(per_part + 1, dtype=np.int64)
                bounds[-1] = b  # last sub-partition absorbs the remainder
                sel = _segment_medoids(v, bounds[:-1], bounds[1:])
            levels[sel] = layer
            new_parts.append(sel)
        new_parts.append(np.array([n], dtype=np.int64))
        parts = np.concatenate(new_parts)
    return levels


def _select_neighbors_heuristic(
    vectors: np.ndarray, q_idx: int, cand: list[tuple[float, int]], m: int
) -> list[int]:
    """FAISS/hnswlib shrink heuristic: keep a candidate only if it is closer
    to the query than to every already-selected neighbor."""
    cand = sorted(cand)
    selected: list[int] = []
    for dq, c in cand:
        if len(selected) >= m:
            break
        if not selected:
            selected.append(c)
            continue
        vc = vectors[c]
        dsel = ((vectors[selected] - vc) ** 2).sum(axis=1)
        if (dq < dsel).all():
            selected.append(c)
    return selected


def _levels_for(
    vectors: np.ndarray, m: int, seed: int, level_mode: str
) -> np.ndarray:
    if level_mode == "rng":
        return assign_levels(vectors.shape[0], m, seed)
    if level_mode == "centroid":
        return assign_levels_centroid(vectors, m)
    raise ValueError(f"level_mode must be 'rng' or 'centroid', got {level_mode!r}")


class _Builder:
    def __init__(
        self,
        vectors: np.ndarray,
        m: int,
        efc: int,
        seed: int,
        level_mode: str = "rng",
    ):
        self.v = vectors.astype(np.float32)
        n = vectors.shape[0]
        self.m = m
        self.m0 = 2 * m
        self.efc = efc
        self.levels = _levels_for(self.v, m, seed, level_mode)
        self.max_level = int(self.levels.max(initial=0))
        # adjacency per level: arrays [N, cap] with counts
        self.nbrs = []
        self.cnt = []
        for lvl in range(self.max_level + 1):
            cap = self.m0 if lvl == 0 else self.m
            mask = self.levels >= lvl
            self.nbrs.append(np.full((n, cap), -1, dtype=np.int32))
            self.cnt.append(np.zeros(n, dtype=np.int32))
        self.entry = -1

    def _dist(self, q: np.ndarray, ids) -> np.ndarray:
        d = self.v[ids] - q
        return np.einsum("ij,ij->i", d, d)

    def _search_layer(self, q: np.ndarray, eps: list[int], ef: int, lvl: int):
        """Returns list of (dist, id), ascending, len <= ef."""
        visited = set(eps)
        cand = [(float(d), e) for d, e in zip(self._dist(q, eps), eps)]
        heapq.heapify(cand)  # min-heap on distance
        best = [(-d, e) for d, e in cand]
        heapq.heapify(best)  # max-heap via negation
        while len(best) > ef:
            heapq.heappop(best)
        while cand:
            d, c = heapq.heappop(cand)
            if len(best) >= ef and d > -best[0][0]:
                break
            nb = self.nbrs[lvl][c]
            nb = nb[nb >= 0]
            fresh = [x for x in nb if x not in visited]
            if not fresh:
                continue
            visited.update(fresh)
            ds = self._dist(q, fresh)
            for dn, x in zip(ds, fresh):
                if len(best) < ef or dn < -best[0][0]:
                    heapq.heappush(cand, (float(dn), int(x)))
                    heapq.heappush(best, (-float(dn), int(x)))
                    if len(best) > ef:
                        heapq.heappop(best)
        return sorted((-d, e) for d, e in best)

    def _connect(self, lvl: int, a: int, b: int, cap: int):
        """Add edge a->b, pruning with the heuristic when full."""
        row = self.nbrs[lvl][a]
        c = self.cnt[lvl][a]
        if c < cap:
            row[c] = b
            self.cnt[lvl][a] = c + 1
            return
        # prune: rank current neighbors + b by the selection heuristic
        ids = np.append(row[:c], b)
        dq = self._dist(self.v[a], ids)
        keep = _select_neighbors_heuristic(
            self.v, a, list(zip(dq.tolist(), ids.tolist())), cap
        )
        row[:] = -1
        row[: len(keep)] = keep
        self.cnt[lvl][a] = len(keep)

    def add(self, i: int):
        lvl = int(self.levels[i])
        if self.entry < 0:
            self.entry = i
            return
        q = self.v[i]
        ep = [self.entry]
        top = int(self.levels[self.entry])
        for l in range(top, lvl, -1):
            res = self._search_layer(q, ep, 1, l)
            ep = [res[0][1]]
        for l in range(min(top, lvl), -1, -1):
            res = self._search_layer(q, ep, self.efc, l)
            cap = self.m0 if l == 0 else self.m
            sel = _select_neighbors_heuristic(self.v, i, res, self.m)
            for s in sel:
                self._connect(l, i, s, cap)
                self._connect(l, s, i, cap)
            ep = [e for _, e in res]
        if lvl > top:
            self.entry = i

    def finish(self) -> HNSWGraphData:
        n = self.v.shape[0]
        level_gids: list[np.ndarray] = []
        level_nbrs: list[np.ndarray] = []
        for lvl in range(1, self.max_level + 1):
            gids = np.flatnonzero(self.levels >= lvl).astype(np.int64)
            rowmap = np.full(n, -1, dtype=np.int32)
            rowmap[gids] = np.arange(gids.size, dtype=np.int32)
            nb = self.nbrs[lvl][gids]
            nb_rows = np.where(nb >= 0, rowmap[np.maximum(nb, 0)], -1).astype(np.int32)
            level_gids.append(gids)
            level_nbrs.append(nb_rows)
        return HNSWGraphData(
            neighbors0=self.nbrs[0],
            level_gids=level_gids,
            level_nbrs=level_nbrs,
            entry_gid=int(self.entry),
            max_level=self.max_level,
            m=self.m,
        )


def build_hnsw_python(
    vectors: np.ndarray,
    m: int = 16,
    efc: int = 200,
    seed: int = 5489,
    level_mode: str = "rng",
) -> HNSWGraphData:
    """Pure-Python builder — the readable specification and fallback."""
    b = _Builder(vectors, m, efc, seed, level_mode)
    for i in range(vectors.shape[0]):
        b.add(i)
    return b.finish()


def build_hnsw(
    vectors: np.ndarray,
    m: int = 16,
    efc: int = 200,
    seed: int = 5489,
    use_native: bool | None = None,
    level_mode: str = "rng",
) -> HNSWGraphData:
    """HNSW construction: native C++ builder (native/drm_hnsw.cpp, ~1000x
    faster) when available, Python fallback.  Both run the same algorithm on
    the same deterministic level assignment (level_mode 'rng' = seeded
    exponential draws; 'centroid' = hnswm's deterministic centroid-partition
    scheme, src/hnswm/hnsw.cpp:701-796 — measured A/B in
    scripts/exp_centroid_levels.py, results in BASELINE.md)."""
    from deepreadmapper_tpu import native

    if use_native is None:
        use_native = native.available()
    if not use_native:
        return build_hnsw_python(vectors, m, efc, seed, level_mode)

    n = vectors.shape[0]
    levels = _levels_for(np.asarray(vectors, dtype=np.float32), m, seed, level_mode)
    max_level = int(levels.max(initial=0))
    neighbors0, upper, entry = native.hnsw_build(vectors, levels, m, efc)
    level_gids: list[np.ndarray] = []
    level_nbrs: list[np.ndarray] = []
    row = 0
    for lvl in range(1, max_level + 1):
        gids = np.flatnonzero(levels >= lvl).astype(np.int64)
        rowmap = np.full(n, -1, dtype=np.int32)
        rowmap[gids] = np.arange(gids.size, dtype=np.int32)
        nb = upper[row : row + gids.size]
        nb_rows = np.where(nb >= 0, rowmap[np.maximum(nb, 0)], -1).astype(np.int32)
        level_gids.append(gids)
        level_nbrs.append(nb_rows)
        row += gids.size
    return HNSWGraphData(
        neighbors0=neighbors0,
        level_gids=level_gids,
        level_nbrs=level_nbrs,
        entry_gid=entry,
        max_level=max_level,
        m=m,
    )
