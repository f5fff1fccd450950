"""IVF-pruned int8 scan: k-means coarse quantizer + slab-major int8 codes.

The sub-linear engine for the >100M-rows-per-card tier.  The reference's
HNSW exists to avoid exhaustive scanning (src/hnswpq/search.cpp:6-57); its
graph traversal is a chain of dependent gathers, so this engine prunes with
a COARSE QUANTIZER instead: score every query against nlist k-means
centroids (one small matmul), keep the top-nprobe clusters, and scan only
those clusters' rows.

Device mapping — everything is static-shape:

* Every row lives in its NEAREST cluster, always (probe coverage depends on
  it; spilling rows to other clusters makes them unfindable — measured as a
  hard recall plateau).  Clusters larger than the slab capacity are
  recursively 2-means split (with a forced halving fallback for slabs of
  identical rows — repeat-heavy genomes), so density grows local centroid
  resolution instead of overflowing.
* Codes live SLAB-MAJOR in a dense [(n_slabs+1) * cap, D] int8 array.
  Small clusters are bin-packed several-per-slab (first-fit decreasing), so
  fill stays high; scanning a probed cluster scans its whole slab — the
  extra rows are real candidates, so recall only improves.  Empty slots
  carry +inf norms so they never win; the final slab is the all-empty dump
  target for deduplicated probes.
* Query->slab inversion happens on host (cheap integer work, like the
  reference's host-side dedup): probe top-nprobe clusters on device, map
  cluster->slab, dedup per query, and build S steps of
  (slab_id, query-tile[QTILE]) padded to geometric step buckets so batches
  share compiled programs.
* One lax.scan runs the steps: gather <=QTILE int8 queries, slice the
  slab, int8 product, approx_max_k of the per-slab top-kp — stacked, no
  scatter into a [Q, k] carry.  Each
  (query, probe) pair owns one slot of the stacked output, so the final
  merge is pure gathers + one top_k.  Distance math matches Int8FlatIndex:
  r^2*qn + rn - 2r*(q8.r8), exact int32 values in fp32 (< 2^24).

Compute shrinks from Q*N to ~S*QTILE*cap MACs — at Q=8192, nlist=4096,
nprobe=32 that is ~64x less than the exhaustive scan; recall is bounded
only by the probe set (scan over probed clusters is exact, verified in
tests/test_ivf.py).
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from deepreadmapper_tpu.config import BuildConfig
from deepreadmapper_tpu.index.int8_flat import (
    quantize_host,
    query_scale_ratio,
)
from deepreadmapper_tpu.index.registry import register_index

_BIGF = np.float32(3.4e38)
QTILE = 128          # queries per (slab, tile) step


def auto_nlist(n: int) -> int:
    """~sqrt(N) clusters, power of two, clamped to [16, 8192]."""
    if n <= 0:
        return 16
    return int(min(8192, max(16, 1 << int(round(np.log2(max(np.sqrt(n), 2)))))))


@functools.partial(jax.jit, static_argnames=("nlist", "iters"))
def _kmeans_coarse(data, init, nlist: int, iters: int):
    """Lloyd iterations for the coarse quantizer (data/init fp32 in the
    scaled-int8 domain).  Unlike ops/pq._kmeans_batched the assignment runs
    CHUNKED so the [n, nlist] distance tensor stays bounded."""
    n = data.shape[0]
    chunk = min(n, 16384)
    n_pad = n + (-n) % chunk
    if n_pad != n:
        data = jnp.pad(data, ((0, n_pad - n), (0, 0)),
                       constant_values=np.float32(np.nan))
    parts = data.reshape(n_pad // chunk, chunk, -1)

    def assign_chunk(cent, dc):
        d2 = (
            jnp.sum(dc * dc, axis=-1, keepdims=True)
            - 2.0 * (dc @ cent.T)
            + jnp.sum(cent * cent, axis=-1)[None, :]
        )
        a = jnp.argmin(d2, axis=-1)
        oh = jax.nn.one_hot(a, nlist, dtype=jnp.float32)
        oh = jnp.where(jnp.isnan(dc[:, :1]), 0.0, oh)  # mask pad rows
        dc0 = jnp.nan_to_num(dc)
        return oh.T @ dc0, jnp.sum(oh, axis=0)

    def body(cent, _):
        def step(carry, dc):
            s, c = carry
            ds, dcnt = assign_chunk(cent, dc)
            return (s + ds, c + dcnt), None

        (sums, counts), _ = jax.lax.scan(
            step, (jnp.zeros_like(cent), jnp.zeros((nlist,), jnp.float32)),
            parts,
        )
        new = sums / jnp.maximum(counts[:, None], 1.0)
        return jnp.where(counts[:, None] > 0, new, cent), None

    cent, _ = jax.lax.scan(body, init, None, length=iters)
    return cent


@functools.partial(jax.jit, static_argnames=("chunk",))
def _assign_nearest(codes8, cent, chunk: int):
    """Nearest centroid per row (codes int8 [N_pad, D], cent fp32 [nlist, D]
    in the scaled domain).  Chunked; returns ids [N_pad] int32."""
    n, d = codes8.shape
    cn = jnp.sum(cent * cent, axis=-1)

    def step(_, rc):
        r = rc.astype(jnp.float32)
        d2 = cn[None, :] - 2.0 * (r @ cent.T)  # + rn (constant per row)
        return 0, jnp.argmin(d2, axis=-1).astype(jnp.int32)

    _, out = jax.lax.scan(step, 0, codes8.reshape(n // chunk, chunk, d))
    return out.reshape(n)


def _two_means(sub: np.ndarray, rng, iters: int = 8):
    """Host 2-means on one oversized cluster's fp32 rows; returns (side_b
    mask, mean_a, mean_b).  Lloyd iterations run on a <=16k-row SUBSAMPLE
    (the split boundary needs two rough centroids, not converged ones —
    at the 500M-row tier full-cluster iterations made splitting the
    longest build phase), then ONE full assignment pass splits every row.
    Falls back to an arbitrary halving when the rows are (near-)identical
    — planted repeats — which 2-means cannot split."""
    n = sub.shape[0]
    step = max(1, n // 16384)
    samp = sub[::step]
    ns = samp.shape[0]
    ca, cb = samp[rng.integers(ns)], samp[rng.integers(ns)]
    for _ in range(iters):
        da = ((samp - ca) ** 2).sum(1)
        db = ((samp - cb) ** 2).sum(1)
        nb = db < da
        if nb.all() or (~nb).all():
            break
        ca = samp[~nb].mean(0)
        cb = samp[nb].mean(0)
    b = ((sub - cb) ** 2).sum(1) < ((sub - ca) ** 2).sum(1)
    if b.all() or (~b).all():
        b = np.zeros(n, bool)
        b[n // 2:] = True
    ca = sub[~b].mean(0)
    cb = sub[b].mean(0)
    return b, ca, cb


def _split_and_pack(codes: np.ndarray, assign: np.ndarray, cent0: np.ndarray,
                    cap: int, seed: int, fetch=None):
    """Recursively split oversized clusters, then bin-pack clusters into
    fixed-capacity slabs (first-fit decreasing).

    fetch(rows) -> fp32 vectors for the 2-means split; defaults to reading
    `codes` rows directly (IVFPQ passes a PQ-reconstruction callback so
    only oversized clusters ever materialize as vectors).

    Returns (row_order_per_slot, slot_per_row omitted), concretely:
    clusters as (rows, centroid) in pack order, slab_of [C] int32, n_slabs.
    """
    if fetch is None:
        fetch = lambda rows: codes[rows].astype(np.float32)  # noqa: E731
    nlist0 = cent0.shape[0]
    order = np.argsort(assign, kind="stable")
    counts = np.bincount(assign, minlength=nlist0)
    bounds = np.concatenate([[0], np.cumsum(counts)])
    rng = np.random.default_rng(seed)
    stack = [
        (order[bounds[c]:bounds[c + 1]], cent0[c], None)
        for c in range(nlist0)
        if counts[c] > 0
    ]
    clusters = []
    # vectors are fetched ONCE per oversized root and sliced down the
    # recursion (re-fetching per level dominated genome-scale builds);
    # degenerate giants (>4M rows) halve by id order first — adjacent row
    # ids are shifted windows of one locus, so the halves stay coherent
    # and the fetch stays bounded
    _FETCH_CAP = 4_000_000
    while stack:
        rows, cc, vecs = stack.pop()
        if len(rows) <= cap:
            clusters.append((rows, cc))
            continue
        if vecs is None and len(rows) > _FETCH_CAP:
            h = len(rows) // 2
            stack.append((rows[:h], cc, None))
            stack.append((rows[h:], cc, None))
            continue
        if vecs is None:
            vecs = fetch(rows)
        b, ca, cb = _two_means(vecs, rng)
        stack.append((rows[~b], ca, vecs[~b]))
        stack.append((rows[b], cb, vecs[b]))
        del vecs

    # first-fit decreasing: vectorized first-slab-with-room lookup per
    # cluster keeps this O(C) numpy calls, not O(C*S) python loops
    clusters.sort(key=lambda rc: -len(rc[0]))
    sizes = np.array([len(rc[0]) for rc in clusters], np.int64)
    n_slabs_hint = int(-(-sizes.sum() // cap)) + 1
    free = np.full(n_slabs_hint, cap, np.int64)
    slab_of = np.empty(len(clusters), np.int32)
    hi = 0  # slabs opened so far
    for ci, sz in enumerate(sizes):
        fits = np.nonzero(free[: hi + 1] >= sz)[0]
        si = int(fits[0]) if fits.size else hi
        if si >= hi:
            hi = si + 1
            if hi > free.size:
                free = np.concatenate([free, np.full(hi, cap, np.int64)])
        free[si] -= sz
        slab_of[ci] = si
    return clusters, slab_of, hi


@jax.jit
def _slab_row_norms(c3):
    """Squared row norms of [S, cap, D] int8 codes -> [S, cap] fp32,
    one slab at a time (lax.scan) so the int32 square temporaries never
    exceed one slab's footprint."""

    def step(_, cc):
        return 0, jnp.sum(
            cc.astype(jnp.int32) * cc.astype(jnp.int32), axis=-1,
            dtype=jnp.int32,
        ).astype(jnp.float32)

    _, rn = jax.lax.scan(step, 0, c3)
    return rn


def scan_probed_slabs(q8, codes_cm, rn_cm, step_cluster, step_qidx, ratio,
                      cap: int, d: int, kp: int):
    """The IVF hot loop: one lax.scan over (slab, query-tile) steps.

    Per-step per-cluster top-kp, STACKED rather than scattered into a
    [Q, k] carry: the host-known slot map makes the downstream merge pure
    gathers instead.  Returns
    (ds [n_steps*QTILE, kp] quantized scores, rs [.., kp] codes_cm row ids).
    Shared by the single-chip engine and the sharded per-shard scan
    (parallel/sharded_ann.py) — trace-level, callers jit/shard_map it.
    """

    def step(_, xs):
        cid, qi = xs
        qs = q8[qi]  # [QTILE, D] int8 gather
        start = cid * cap
        slab = jax.lax.dynamic_slice(codes_cm, (start, 0), (cap, d))
        rns = jax.lax.dynamic_slice(rn_cm, (start,), (cap,))
        dot = jax.lax.dot_general(
            qs, slab,
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.int32,
        )
        scores = rns[None, :] - (2.0 * ratio) * dot.astype(jnp.float32)
        nd, pos = jax.lax.approx_max_k(-scores, kp, recall_target=0.99)
        rows = start + pos.astype(jnp.int32)
        return 0, (-nd, rows)

    _, (ds, rs) = jax.lax.scan(step, 0, (step_cluster, step_qidx))
    return ds.reshape(-1, kp), rs.reshape(-1, kp)


@register_index("IVFINT8")
class IVFInt8Index:
    """Cluster-pruned int8 scan (sub-linear; `ef` acts as nprobe)."""

    def __init__(self, codes_cm, centroids, row_ids, slab_of, scale, ntotal,
                 cap, n_slabs):
        self.codes_cm = codes_cm        # [(n_slabs+1)*cap, D] int8
        self.centroids = centroids      # [C, D] fp32 (scaled domain)
        self.row_ids = row_ids          # [(n_slabs+1)*cap] int64, -1 = empty
        self.slab_of = slab_of          # [C] int32: cluster -> slab
        self.scale = float(scale)
        self.ntotal = int(ntotal)
        self.cap = int(cap)
        self.n_slabs = int(n_slabs)     # excludes the trailing empty slab
        self.nlist = centroids.shape[0]
        self._dev = None
        self._fns: dict = {}

    # ------------------------------------------------------------- build

    @classmethod
    def build(cls, embeddings, cfg: BuildConfig | None = None):
        x = np.asarray(embeddings, np.float32)
        amax = float(np.max(np.abs(x))) if x.size else 1.0
        scale = max(amax, 1e-30) / 127.0
        codes = quantize_host(x, scale)
        return cls.build_from_codes(codes, scale, cfg)

    @classmethod
    def build_from_codes(cls, codes: np.ndarray, scale: float,
                         cfg: BuildConfig | None = None):
        """Build from int8 codes (the streaming FASTA path hands these
        straight from the device quantizer — fp32 never materializes)."""
        cfg = cfg or BuildConfig()
        n, d = codes.shape
        nlist = cfg.nlist if cfg.nlist else auto_nlist(n)
        nlist = min(nlist, max(n, 1))
        # slab capacity: ~1.25x the mean cluster, a multiple of 128 rows
        cap = -(-int(np.ceil(n / nlist * 1.25)) // 128) * 128
        cap = max(cap, 128)

        # --- coarse k-means on an evenly spaced sample (scaled domain) ---
        target = min(n, max(nlist * 24, 4096), 131_072)
        step = max(1, n // max(target, 1))
        sample = codes[::step].astype(np.float32)
        idx = (np.arange(nlist) * (sample.shape[0] / nlist)).astype(np.int64)
        rng = np.random.default_rng(cfg.seed)
        init = sample[idx] + rng.standard_normal((nlist, d)).astype(
            np.float32
        ) * 1e-3
        cent0 = np.asarray(
            _kmeans_coarse(jnp.asarray(sample), jnp.asarray(init), nlist, 15)
        )

        # --- nearest-cluster assignment for every row (device, chunked) ---
        chunk = min(8192, n)
        n_pad = n + (-n) % chunk
        codes_p = (
            np.concatenate([codes, np.zeros((n_pad - n, d), np.int8)])
            if n_pad != n
            else codes
        )
        assign = np.asarray(
            _assign_nearest(jnp.asarray(codes_p), jnp.asarray(cent0), chunk)
        )[:n]

        # --- split oversized clusters, bin-pack into slabs, lay out ---
        clusters, slab_of, n_slabs = _split_and_pack(
            codes, assign, cent0, cap, cfg.seed + 1
        )
        cent = np.stack([cc for _rows, cc in clusters]).astype(np.float32)
        codes_cm = np.zeros(((n_slabs + 1) * cap, d), np.int8)
        row_ids = np.full((n_slabs + 1) * cap, -1, np.int64)
        used = np.zeros(n_slabs, np.int64)
        for ci, (rows, _cc) in enumerate(clusters):
            si = slab_of[ci]
            base = si * cap + used[si]
            codes_cm[base:base + len(rows)] = codes[rows]
            row_ids[base:base + len(rows)] = rows
            used[si] += len(rows)
        return cls(codes_cm, cent, row_ids, slab_of, scale, n, cap, n_slabs)

    # ------------------------------------------------------------ device

    def _device(self):
        """Slab-space codes, row norms (+inf on empty slots) and the coarse
        centroids with their norms, on device."""
        if self._dev is None:
            cent = jnp.asarray(self.centroids)
            cn = jnp.sum(cent * cent, axis=-1)
            c = jnp.asarray(self.codes_cm)
            c3 = c.reshape(-1, self.cap, c.shape[1])
            # per-slab norm pass: a whole-matrix int32 cast needs 4x the
            # codes' device memory transiently
            rn = _slab_row_norms(c3).reshape(-1)
            rn = jnp.where(jnp.asarray(self.row_ids >= 0), rn, _BIGF)
            self._dev = (c, rn, cent, cn)
        return self._dev

    # ------------------------------------------------------------ search

    def _probe_fn(self, nprobe: int, approx: bool = False):
        key = ("probe", nprobe, approx)
        fn = self._fns.get(key)
        if fn is None:

            @jax.jit
            def probe(q8f, cent, cn, ratio):
                # centroid scores in the scaled domain; qn is constant per
                # row so argmin doesn't need it
                d2 = cn[None, :] - 2.0 * ratio * (q8f @ cent.T)
                if approx:
                    # the probe only needs a high-recall cluster set, so
                    # backends with a partial-reduction lowering may skip
                    # the full sort (on the GPU both lower to one top-k)
                    _, ids = jax.lax.approx_max_k(
                        -d2, nprobe, recall_target=0.99
                    )
                else:
                    _, ids = jax.lax.top_k(-d2, nprobe)
                return ids.astype(jnp.int32)

            fn = self._fns[key] = probe
        return fn

    def _scan_fn(self, k: int, kp: int, nprobe: int):
        key = ("scan", k, kp, nprobe)
        fn = self._fns.get(key)
        if fn is None:
            cap, d = self.cap, self.codes_cm.shape[1]

            @jax.jit
            def scan(q8, codes_cm, rn_cm, step_cluster, step_qidx, slot_of,
                     ratio):
                ds, rs = scan_probed_slabs(
                    q8, codes_cm, rn_cm, step_cluster, step_qidx, ratio,
                    cap, d, kp,
                )
                # each (query, probe) pair owns exactly one slot in the
                # [S*QTILE, kp] stack; gather nprobe slots per query, merge
                q = slot_of.shape[0]
                cat_d = ds[slot_of].reshape(q, nprobe * kp)
                cat_i = rs[slot_of].reshape(q, nprobe * kp)
                neg, sel = jax.lax.top_k(-cat_d, k)
                return -neg, jnp.take_along_axis(cat_i, sel, axis=1)

            fn = self._fns[key] = scan
        return fn

    def _build_plan(self, probe: np.ndarray, qtile: int = QTILE):
        """Invert probed clusters [Q, nprobe] -> steps of (slab, query-tile),
        padded to geometric S buckets so step counts share compiled programs.
        Also returns slot_of [Q, nprobe]: the slot in the [S*qtile, kp]
        stacked step output that holds each (query, probe) pair's results.

        Clusters map to slabs first; duplicate slabs within a query (two
        small probed clusters bin-packed together) are redirected to the
        trailing all-empty slab so the merge never sees the same row twice.
        """
        q, nprobe = probe.shape
        slabs = self.slab_of[probe].astype(np.int64)  # [Q, nprobe]
        srt = np.sort(slabs, axis=1)
        dup_sorted = np.concatenate(
            [np.zeros((q, 1), bool), srt[:, 1:] == srt[:, :-1]], axis=1
        )
        # mark duplicates in the original (unsorted) layout: a pair is a dup
        # if its (row, slab) has a lower-index twin
        empty = self.n_slabs
        for_rank = np.argsort(slabs, axis=1, kind="stable")
        dup = np.zeros_like(dup_sorted)
        np.put_along_axis(dup, for_rank, dup_sorted, axis=1)
        slabs = np.where(dup, empty, slabs)
        pairs_c = slabs.ravel()
        pairs_q = np.repeat(np.arange(q, dtype=np.int32), nprobe)
        order = np.argsort(pairs_c, kind="stable")
        cs = pairs_c[order]
        qs = pairs_q[order]
        counts = np.bincount(cs, minlength=self.n_slabs + 1)
        steps_per = -(-counts // qtile)
        s_real = int(steps_per.sum())
        # step bucket: geometric to 1024, then 1024-multiples — pad steps
        # re-scan slab 0, so the waste stays <10% for a bounded number of
        # compile signatures
        s_pad = 64
        while s_pad < s_real and s_pad < 1024:
            s_pad *= 2
        if s_pad < s_real:
            s_pad = -(-s_real // 1024) * 1024
        step_cluster = np.zeros(s_pad, np.int32)
        used = counts > 0
        step_cluster[:s_real] = np.repeat(
            np.nonzero(used)[0].astype(np.int32), steps_per[used]
        )
        qidx = np.full(s_pad * qtile, q, np.int32)  # q = dump row
        seg_start = np.concatenate([[0], np.cumsum(counts)[:-1]])
        step_base = np.concatenate([[0], np.cumsum(steps_per)[:-1]])
        r = np.arange(cs.size) - seg_start[cs]
        slot = (step_base[cs] + r // qtile) * qtile + r % qtile
        qidx[slot] = qs
        slot_of = np.empty(q * nprobe, np.int32)
        slot_of[order] = slot
        return step_cluster, qidx.reshape(s_pad, qtile), slot_of.reshape(
            q, nprobe
        )

    def _slab_fill_counts(self):
        """Real (non-empty) rows per slab — the denominator-side of the
        search-effort counters."""
        if getattr(self, "_slabfill", None) is None:
            self._slabfill = (
                (self.row_ids >= 0).reshape(-1, self.cap).sum(1)
            ).astype(np.int64)
        return self._slabfill

    def _accum_stats(self, stats: dict, probe: np.ndarray, nprobe: int):
        """Accumulate per-batch effort counters from the probe set (dups
        within a row scan nothing extra, mirroring the plan's dedup)."""
        fill = self._slab_fill_counts()
        slabs = np.sort(self.slab_of[probe].astype(np.int64), axis=1)
        dup = np.concatenate(
            [np.zeros((len(slabs), 1), bool), slabs[:, 1:] == slabs[:, :-1]],
            axis=1,
        )
        rows_per_q = np.where(dup, 0, fill[slabs]).sum(1)
        stats["queries"] = stats.get("queries", 0) + len(slabs)
        stats["probed_rows"] = stats.get("probed_rows", 0) + int(
            rows_per_q.sum()
        )
        stats["nprobe"] = nprobe
        stats["nlist"] = self.nlist
        stats["ntotal"] = self.ntotal

    _APPROX_PROBE_NLIST = 2048  # auto threshold: full-sort top_k on a
    # [Q, nlist] probe matrix costs ~5x approx_max_k past a few k columns

    def search(self, queries: np.ndarray, k: int, ef: int = 32,
               exact: bool = False, approx_probe: bool | None = None,
               stats: dict | None = None):
        """ef = nprobe (clusters scanned per query).  The probed-slab scan
        is exact within the probed slabs, so the probe set is the only
        approximation; exact=True also keeps the probe an exact top_k.
        approx_probe selects clusters with approx_max_k instead of the
        full-sort top_k (>=0.99 per-row cluster recall); None (default)
        enables it when nlist >= 2048.  Returns (ids [Q, k] int64 original
        row ids, dists [Q, k] fp32 squared-L2 estimates, same convention as
        Int8FlatIndex).

        stats, when a dict is passed, is filled with SEARCH-EFFORT counters
        (the hnswm profiling idea, src/hnswm/hnsw.cpp:18-39, recast for
        nprobe tuning): probed_rows_per_query (real rows dot-scored per
        query), coverage (fraction of the index scanned),
        centroid_evals_per_query."""
        queries = np.asarray(queries, np.float32)
        nq = queries.shape[0]
        if self.ntotal == 0 or nq == 0:
            return (
                np.full((nq, k), -1, np.int64),
                np.full((nq, k), np.inf, np.float32),
            )
        if approx_probe is None:
            approx_probe = (
                not exact and self.nlist >= self._APPROX_PROBE_NLIST
            )
        nprobe = int(np.clip(ef if ef else 32, 1, self.nlist))
        k_eff = min(k, self.ntotal)
        kp = min(k_eff, self.cap)
        # the merge sees nprobe*kp candidate columns; k cannot exceed that
        k_scan = min(k_eff, nprobe * kp)
        c, rn, cent, cn = self._device()
        sq, ratio = query_scale_ratio(queries, self.scale)
        q8_all = quantize_host(queries, sq)
        qn_all = (q8_all.astype(np.int64) ** 2).sum(1).astype(np.float32)
        probe_fn = self._probe_fn(nprobe, approx=approx_probe)
        scan_fn = self._scan_fn(k_scan, kp, nprobe)
        s2 = np.float32(self.scale) ** 2
        r2 = np.float32(ratio) ** 2
        out_d = np.empty((nq, k_scan), np.float32)
        out_i = np.empty((nq, k_scan), np.int64)
        q_batch = 8192
        for s in range(0, nq, q_batch):
            e = min(s + q_batch, nq)
            q8 = q8_all[s:e]
            probe = np.asarray(
                probe_fn(jnp.asarray(q8, jnp.float32), cent, cn,
                         jnp.float32(ratio))
            )
            if stats is not None:
                self._accum_stats(stats, probe, nprobe)
            step_cluster, qidx, slot_of = self._build_plan(probe, QTILE)
            q8_pad = np.concatenate(
                [q8, np.zeros((1, q8.shape[1]), np.int8)]
            )
            d_b, i_b = scan_fn(
                jnp.asarray(q8_pad), c, rn, jnp.asarray(step_cluster),
                jnp.asarray(qidx), jnp.asarray(slot_of),
                jnp.float32(ratio),
            )
            d_b = np.asarray(d_b)
            i_b = np.asarray(i_b)
            # slab-space rows -> original row ids; empty-slot hits -> -1
            valid = (i_b >= 0) & (d_b < _BIGF / 2)
            ids = np.where(valid, self.row_ids[np.maximum(i_b, 0)], -1)
            out_i[s:e] = ids
            out_d[s:e] = np.where(
                valid, (d_b + r2 * qn_all[s:e, None]) * s2, np.inf
            )
        if k_scan < k:
            out_d = np.pad(out_d, ((0, 0), (0, k - k_scan)),
                           constant_values=np.inf)
            out_i = np.pad(out_i, ((0, 0), (0, k - k_scan)),
                           constant_values=-1)
        if stats is not None and stats.get("queries"):
            stats["probed_rows_per_query"] = round(
                stats["probed_rows"] / stats["queries"], 1
            )
            stats["coverage"] = round(
                stats["probed_rows_per_query"] / max(self.ntotal, 1), 6
            )
            stats["centroid_evals_per_query"] = self.nlist
        return out_i, out_d

    # -------------------------------------------------------- persistence

    def save(self, index_prefix: str) -> None:
        os.makedirs(index_prefix, exist_ok=True)
        np.savez(
            os.path.join(index_prefix, "ivf_int8.npz"),
            codes_cm=self.codes_cm,
            centroids=self.centroids,
            row_ids=self.row_ids,
            slab_of=self.slab_of,
            scale=np.float64(self.scale),
            ntotal=self.ntotal,
            cap=self.cap,
            n_slabs=self.n_slabs,
        )

    @classmethod
    def load(cls, index_prefix: str, config: dict | None = None):
        z = np.load(os.path.join(index_prefix, "ivf_int8.npz"))
        return cls(
            z["codes_cm"], z["centroids"], z["row_ids"], z["slab_of"],
            float(z["scale"]), int(z["ntotal"]), int(z["cap"]),
            int(z["n_slabs"]),
        )
