"""Mesh-sharded ANN index: per-shard HNSW graphs, global top-k merge.

This is the multi-host index scale-out named in SURVEY.md §5/§7: the genome-
scale object (windows' PQ codes + graph) is the thing that outgrows one chip,
so each position along the mesh 'shard' axis holds a COMPLETE sub-index over
a contiguous slice of the vectors (graph + codes/vectors + its own PQ
codebook, like one FAISS IndexHNSWPQ per host).  Search runs the batched beam
search (index/hnsw.py) on every shard in lockstep under shard_map, localizes
ids to the global space by the shard's row offset, and merges with
all_gather + lax.top_k — XLA hands the collectives to NCCL on the GPU.

Shards must execute ONE program, so per-shard graphs are padded to common
shapes: gids pad with n_local (sorted-tail sentinel, unreachable) and
neighbor rows with -1; shards with fewer HNSW levels get all-sentinel levels
whose descent is a no-op.  Padded VECTOR rows (when N % n_shard != 0) sit at
+1e9 so their distances never win, and their ids are masked to -1 after the
merge.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from deepreadmapper_tpu.config import BuildConfig
from deepreadmapper_tpu.index.hnsw import hnsw_search_device
from deepreadmapper_tpu.index.ivf_int8 import (
    _BIGF as _IVF_BIGF,
    QTILE as _IVF_QTILE,
    scan_probed_slabs,
)
from deepreadmapper_tpu.index.ivf_pq import (
    pack_codes_t,
    scan_probed_slabs_pq,
)
from deepreadmapper_tpu.index.registry import _REGISTRY
from deepreadmapper_tpu.ops import pq as pq_ops
from deepreadmapper_tpu.ops import scan_kernel as sk
from deepreadmapper_tpu.ops.platform import use_kernels

# per-shard int8 padding unit (a _PAD_BASE multiple, so the windowed scan
# applies) and the plain scan's chunk: XLA's GPU backend refuses a k=128
# top_k over [8192, 2^18] scores
_INT8_CHUNK = 262144
_SCAN_CHUNK = 131072
_Q_SUPER_PER_DATA = 8192  # queries per data-axis position per device call


def read_manifest(index_prefix: str) -> dict:
    """Parse <prefix>/sharded.txt (key:value lines) — the single source of
    truth for shard count shared by the registry loader and load()."""
    import os

    meta = {}
    with open(os.path.join(index_prefix, "sharded.txt")) as f:
        for line in f:
            line = line.strip()
            if not line or ":" not in line:
                continue
            k, v = line.split(":", 1)
            meta[k] = v
    return meta


def compose_global_ids(local: np.ndarray, shard: np.ndarray,
                       n_local: int) -> np.ndarray:
    """(local int32, shard int32) -> int64 global ids (shard*n_local+local).

    The device merge never forms global ids, so a sharded index may exceed
    2^31 total vectors; -1 locals (masked/invalid) stay -1."""
    loc = local.astype(np.int64)
    shd = shard.astype(np.int64)
    return np.where(loc >= 0, shd * np.int64(n_local) + loc, np.int64(-1))


def _pad_graph_stack(subs):
    """Stack per-shard HNSWGraphData into common-shape device arrays.

    Returns (neigh0 [S,n,2M], levels: tuple of (gids [S,nl], nbrs [S,nl,M]),
    entries [S])."""
    s = len(subs)
    n_local = subs[0].graph.neighbors0.shape[0]
    m = subs[0].graph.m
    max_levels = max(g.graph.max_level for g in subs)
    neigh0 = np.stack([g.graph.neighbors0 for g in subs])
    entries = np.array([g.graph.entry_gid for g in subs], dtype=np.int32)
    levels = []
    for lvl in range(max_levels):
        nl = max(
            (g.graph.level_gids[lvl].shape[0] if lvl < g.graph.max_level else 0)
            for g in subs
        )
        nl = max(nl, 1)
        gids = np.full((s, nl), n_local, dtype=np.int64)  # sorted-tail sentinel
        nbrs = np.full((s, nl, m), -1, dtype=np.int32)
        for si, g in enumerate(subs):
            if lvl < g.graph.max_level:
                lg = g.graph.level_gids[lvl]
                gids[si, : lg.shape[0]] = lg
                nbrs[si, : lg.shape[0]] = g.graph.level_nbrs[lvl]
        levels.append((gids, nbrs))
    return neigh0, tuple(levels), entries


class ShardedANNIndex:
    """Build/search a mesh-sharded ANN index (HNSWPQ / HNSWFLAT)."""

    def __init__(self, subs, mesh: Mesh, ntotal: int, index_type: str):
        self.subs = subs
        self.mesh = mesh
        self.ntotal = ntotal
        self.index_type = index_type
        if index_type == "FLAT":
            self.kind = "flat"
            self.n_local = subs[0].embeddings.shape[0]
            self.mode = None
        elif index_type == "INT8FLAT":
            self.kind = "int8flat"
            self.n_local = subs[0].codes.shape[0]
            self.mode = None
        elif index_type == "PQFLAT":
            self.kind = "pqflat"
            self.n_local = subs[0].codes.shape[0]
            self.mode = None
        elif index_type == "IVFINT8":
            self.kind = "ivfint8"
            # real rows per shard (the slab layout is bigger and per-shard;
            # merge validity + global-id composition live in row space)
            self.n_local = subs[0].ntotal
            self.mode = None
        elif index_type == "IVFPQ":
            self.kind = "ivfpq"
            self.n_local = subs[0].ntotal
            self.mode = None
        else:
            self.kind = "graph"
            self.n_local = subs[0].graph.neighbors0.shape[0]
            self.mode = subs[0].storage_mode
        self._dev = None
        self._fns: dict = {}
        # multi-process mode (load_distributed): self.subs holds ONLY this
        # process's shards; device arrays are assembled process-locally
        self._local_only = False

    @classmethod
    def build(
        cls,
        embeddings: np.ndarray,
        mesh: Mesh,
        cfg: BuildConfig | None = None,
        index_type: str = "INT8FLAT",
    ):
        cfg = cfg or BuildConfig()
        n_shard = mesh.shape["shard"]
        n = embeddings.shape[0]
        pad = (-n) % n_shard
        if pad:
            # Pad by REPEATING the last real row: pad ids are masked after the
            # merge anyway (gid >= ntotal), and unlike sentinel values a real
            # row does not poison the last shard's PQ k-means training.
            embeddings = np.concatenate(
                [embeddings, np.repeat(embeddings[-1:], pad, axis=0)]
            )
        # No 2^31 id cap: the merge carries (local id, shard id) as two
        # int32 payloads and the host composes int64 global ids, so only
        # the PER-SHARD row count must fit int32 (it must fit HBM anyway).
        if (n + pad) // n_shard >= 2**31:
            raise NotImplementedError(
                f"{(n + pad) // n_shard} rows/shard exceeds the int32 "
                "local-id space; use more shards"
            )
        parts = np.split(np.asarray(embeddings, np.float32), n_shard)
        eng = _REGISTRY[index_type]
        subs = [
            eng.build(p, cfg) if hasattr(eng, "build") else eng(p)
            for p in parts
        ]
        return cls(subs, mesh, n, index_type)

    # -------------------------------------------------------------- device

    def _global_max(self, v: int) -> int:
        """Max of a per-process host scalar across processes (identity in
        single-controller mode).  Multi-process SPMD needs one shape
        everywhere; slab/centroid/plan-step counts are data-dependent per
        shard, so the padded shapes take the global max."""
        if not self._local_only:
            return int(v)
        from jax.experimental import multihost_utils

        return int(np.max(multihost_utils.process_allgather(np.array([v]))))

    def _put(self, arr_np, *spec):
        """Host array -> sharded device array.  In multi-process mode
        (load_distributed) arr_np is this PROCESS'S portion — the stack of
        its own shards — and the global array assembles across processes;
        single-controller mode device_puts the full host array."""
        shd = NamedSharding(self.mesh, P(*spec))
        if self._local_only:
            return jax.make_array_from_process_local_data(
                shd, np.asarray(arr_np)
            )
        return jax.device_put(jnp.asarray(arr_np), shd)

    def _device(self):
        if self._dev is not None:
            return self._dev
        mesh = self.mesh
        sh = lambda *spec: NamedSharding(mesh, P(*spec))
        if self.kind == "flat":
            vecs = self._put(
                np.stack([s.embeddings for s in self.subs]),
                "shard", None, None,
            )
            self._dev = (None, (), None, vecs, None)
            return self._dev
        if self.kind == "pqflat":
            stack = np.stack([s.codes for s in self.subs])
            base = sk._PAD_BASE if self.n_local >= sk._PAD_BASE else sk.CT
            pad = (-self.n_local) % min(base, max(self.n_local, 1))
            if pad:  # pad so the per-shard scan can chunk (rows masked)
                stack = np.pad(stack, ((0, 0), (0, pad), (0, 0)))
            codes = self._put(stack, "shard", None, None)  # [S, Np, m] u8
            # Reconstruct-then-int8-scan per shard: each shard carries its
            # own int8 codebook; shards merge in fp32 squared-L2
            # (d * scale^2).
            cent8s = self._put(
                np.stack([s.cb8.cent8 for s in self.subs]),
                "shard", None, None, None,
            )
            scales = self._put(
                np.array([s.cb8.scale for s in self.subs], np.float32),
                "shard",
            )
            d = self.subs[0].codes.shape[1] * self.subs[0].cb8.cent8.shape[-1]
            rots = self._put(
                np.stack([
                    s.rot if s.rot is not None
                    else np.eye(d, dtype=np.float32)
                    for s in self.subs
                ]),
                "shard", None, None,
            )
            self._dev = (
                None, (), None, codes,
                (None, None, scales, cent8s, rots),
            )
            return self._dev
        if self.kind == "ivfint8":
            # Shards must run ONE program, so per-shard slab layouts pad to
            # a common slab count (extra slabs are all-empty: zero codes,
            # row_ids -1, +inf norms — exactly how the engine marks empty
            # slots, so correctness is untouched).  Slab CAPACITY must match
            # across shards; it does by construction (equal per-shard row
            # counts -> equal auto nlist -> equal cap), asserted here.
            caps = {s.cap for s in self.subs}
            # run BOTH collectives unconditionally: a short-circuited raise
            # on one process while the others sit in process_allgather would
            # deadlock the deployment instead of surfacing the error
            cap_max = self._global_max(max(caps))
            cap_min = -self._global_max(-min(caps))
            if cap_max != cap_min:
                raise ValueError(
                    "sharded IVFINT8 needs one slab capacity across shards "
                    f"(equal shard sizes / nlist); got {sorted(caps)} "
                    f"locally, [{cap_min}, {cap_max}] globally"
                )
            cap = cap_max
            d = self.subs[0].codes_cm.shape[1]
            s_cnt = len(self.subs)
            max_slabs = self._global_max(max(s.n_slabs for s in self.subs))
            space = (max_slabs + 1) * cap
            if space >= _INT8_CHUNK:
                # round up to _row_norms' chunk so the norm pass stays
                # chunked (a whole-matrix int32 cast needs 4x the codes'
                # memory transiently); the extra rows are plain empty slots
                space += (-space) % _INT8_CHUNK
            cmax = self._global_max(
                max(s.centroids.shape[0] for s in self.subs)
            )
            cent_np = np.zeros((s_cnt, cmax, d), np.float32)
            cmask_np = np.zeros((s_cnt, cmax), bool)
            for si, sub in enumerate(self.subs):
                c = sub.centroids.shape[0]
                cent_np[si, :c] = sub.centroids
                cmask_np[si, :c] = True
            codes_np = np.zeros((s_cnt, space, d), np.int8)
            rowid_np = np.full((s_cnt, space), -1, np.int32)
            for si, sub in enumerate(self.subs):
                rows = sub.codes_cm.shape[0]
                codes_np[si, :rows] = sub.codes_cm
                # local row ids fit int32 (per-shard row count is int32-
                # bounded by build()); -1 marks empty slots
                rowid_np[si, :rows] = sub.row_ids.astype(np.int32)
            rowid = self._put(rowid_np, "shard", None)
            from deepreadmapper_tpu.index.int8_flat import _row_norms

            codes = self._put(codes_np, "shard", None, None)
            # eager SPMD ops over the sharded global arrays
            rn = jnp.where(rowid >= 0,
                           jax.vmap(_row_norms)(codes), _IVF_BIGF)
            cent = self._put(cent_np, "shard", None, None)
            # centroid norms on DEVICE in fp32 — the same op the single-chip
            # engine runs, so probe ordering cannot diverge at rounding
            # level; padded dummy rows get +inf so top_k never selects them
            cn = jnp.where(self._put(cmask_np, "shard", None),
                           jnp.sum(cent * cent, axis=-1), _IVF_BIGF)
            scales = self._put(
                np.array([s.scale for s in self.subs], np.float32), "shard"
            )
            self._dev = (None, (), None, codes,
                         (rn, rowid, cent, cn, scales))
            return self._dev
        if self.kind == "ivfpq":
            # Same common-slab-layout contract as IVFINT8 (one program over
            # all shards; padded slabs are all-empty), with PQ storage:
            # byte-packed transposed codes + HOST-computed recon norms (the
            # per-shard codebooks are host arrays anyway) + per-shard
            # int8-valued centroid tables and OPQ rotations, exactly like
            # the sharded PQFLAT conventions.
            caps = {sub.cap for sub in self.subs}
            cap_max = self._global_max(max(caps))
            cap_min = -self._global_max(-min(caps))
            if cap_max != cap_min:
                raise ValueError(
                    "sharded IVFPQ needs one slab capacity across shards "
                    f"(equal shard sizes / nlist); got {sorted(caps)} "
                    f"locally, [{cap_min}, {cap_max}] globally"
                )
            cap = cap_max
            m = self.subs[0].codes_cm.shape[1]
            mp = -(-m // 4)
            s_cnt = len(self.subs)
            max_slabs = self._global_max(max(s.n_slabs for s in self.subs))
            space = (max_slabs + 1) * cap
            cmax = self._global_max(
                max(sub.centroids.shape[0] for sub in self.subs)
            )
            d = self.subs[0].centroids.shape[1]
            cent_np = np.zeros((s_cnt, cmax, d), np.float32)
            cmask_np = np.zeros((s_cnt, cmax), bool)
            cent_bf_np = np.stack(
                [sub.cb8.cent8.astype(np.float32) for sub in self.subs]
            )
            rot_np = np.stack([
                sub.rot if sub.rot is not None else np.eye(d, dtype=np.float32)
                for sub in self.subs
            ])
            for si, sub in enumerate(self.subs):
                c = sub.centroids.shape[0]
                cent_np[si, :c] = sub.centroids
                cmask_np[si, :c] = True
            packed_np = np.zeros((s_cnt, mp, space), np.int32)
            rn_np = np.full((s_cnt, space), _IVF_BIGF, np.float32)
            rowid_np = np.full((s_cnt, space), -1, np.int32)
            for si, sub in enumerate(self.subs):
                cols = sub.codes_cm.shape[0]
                packed_np[si, :, :cols] = pack_codes_t(sub.codes_cm)
                rn = pq_ops.recon_norms(
                    sub.codes_cm, sub.cb8.cent_norms
                ).astype(np.float32)
                rn_np[si, :cols] = np.where(
                    sub.row_ids >= 0, rn, _IVF_BIGF
                )
                rowid_np[si, :cols] = sub.row_ids.astype(np.int32)
            codes = self._put(packed_np, "shard", None, None)
            rn = self._put(rn_np, "shard", None)
            rowid = self._put(rowid_np, "shard", None)
            cent = self._put(cent_np, "shard", None, None)
            cn = jnp.where(self._put(cmask_np, "shard", None),
                           jnp.sum(cent * cent, axis=-1), _IVF_BIGF)
            scales = self._put(
                np.array([sub.scale for sub in self.subs], np.float32),
                "shard",
            )
            cent_bf = jnp.asarray(
                self._put(cent_bf_np, "shard", None, None, None),
                jnp.bfloat16,
            )
            rots = self._put(rot_np, "shard", None, None)
            self._dev = (None, (), None, codes,
                         (rn, rowid, cent, cn, scales, cent_bf, rots))
            return self._dev
        if self.kind == "int8flat":
            # Pad n_local to a chunk multiple so the per-shard scan can bound
            # its [Q, chunk] score tensor (pad rows -> ids >= n_local, masked
            # inside _int8_topk and again at the merge).  In multi-process
            # mode the stack holds only THIS process's shards; _put
            # assembles the process-spanning global array.
            stack = np.stack([s.codes for s in self.subs])
            pad = (-self.n_local) % min(_INT8_CHUNK, max(self.n_local, 1))
            if pad:
                stack = np.pad(stack, ((0, 0), (0, pad), (0, 0)))
            codes = self._put(stack, "shard", None, None)
            from deepreadmapper_tpu.index.int8_flat import _row_norms

            # chunked (no whole-matrix cast); eager vmap over the sharded
            # global array runs SPMD on every process and inherits the
            # P('shard', None) layout
            rn = jax.vmap(_row_norms)(codes)
            scales = self._put(
                np.array([s.scale for s in self.subs], np.float32), "shard"
            )
            self._dev = (None, (), None, codes, (rn, scales))
            return self._dev
        neigh0, levels, entries = _pad_graph_stack(self.subs)
        neigh0 = jax.device_put(jnp.asarray(neigh0), sh("shard", None, None))
        levels = tuple(
            (
                jax.device_put(jnp.asarray(g), sh("shard", None)),
                jax.device_put(jnp.asarray(nb), sh("shard", None, None)),
            )
            for g, nb in levels
        )
        entries = jax.device_put(jnp.asarray(entries), sh("shard"))
        if self.mode == "pq":
            storage = jax.device_put(
                jnp.asarray(np.stack([s.codes for s in self.subs])),
                sh("shard", None, None),
            )
            cents = jax.device_put(
                jnp.asarray(
                    np.stack(
                        [np.asarray(s.codebook.centroids) for s in self.subs]
                    )
                ),
                sh("shard", None, None, None),
            )
        else:
            storage = jax.device_put(
                jnp.asarray(np.stack([s.vectors for s in self.subs])),
                sh("shard", None, None),
            )
            cents = None
        self._dev = (neigh0, levels, entries, storage, cents)
        return self._dev

    # ----------------------------------------------------------- ivf search

    def _ivf_probe_fn(self, nprobe: int, approx: bool = False):
        """Coarse-quantizer probe on every shard: [Q, D] fp32 queries ->
        [Q, nprobe, S] int32 per-shard cluster ids.  Queries quantize to each
        shard's own scale (shards train independent coarse codebooks, like
        the per-shard PQ codebooks); the scale is computed on HOST over the
        FULL batch (qscale [S]) so every data position — and the single-chip
        engine — quantizes identically.  approx follows the single-chip
        auto rule (nlist >= _APPROX_PROBE_NLIST): the fp32 full-sort top_k
        costs ~5x there.  Dummy (padded) centroids carry +inf norms; if the
        approximate selection ever surfaces one, the host plan clips it to
        the shard's last real cluster and dup-redirects it to the empty
        slab — the exact machinery that already absorbs cross-shard
        nprobe overshoot."""
        key = ("ivf_probe", nprobe, approx)
        fn = self._fns.get(key)
        if fn is not None:
            return fn
        mesh = self.mesh

        @functools.partial(
            jax.shard_map,
            mesh=mesh,
            in_specs=(
                P("data", None),
                P("shard", None, None),
                P("shard", None),
                P("shard"),
                P("shard"),
            ),
            out_specs=P("data", None, "shard"),
            check_vma=False,
        )
        def body(q, cent_s, cn_s, qscale_s, ratio_s):
            q8f = jnp.round(q / qscale_s[0])
            # qn is constant per row; padded dummy centroids carry +inf
            # norms so selection avoids them (nprobe <= real clusters)
            d2 = cn_s[0][None, :] - 2.0 * ratio_s[0] * (q8f @ cent_s[0].T)
            if approx:
                _, ids = jax.lax.approx_max_k(-d2, nprobe,
                                              recall_target=0.99)
            else:
                _, ids = jax.lax.top_k(-d2, nprobe)
            return ids.astype(jnp.int32)[:, :, None]

        fn = jax.jit(
            lambda q, dev, qscale, ratio: body(
                q, dev[4][2], dev[4][3], qscale, ratio
            )
        )
        self._fns[key] = fn
        return fn

    def _ivf_scan_fn(self, k: int, k_local: int, kp: int, nprobe: int,
                     s_pad: int, qb_local: int):
        """Per-shard probed-slab scan + slot->row mapping + global merge.

        The host-built plan arrays are sharded over BOTH mesh axes — every
        (data position, shard) pair scans its own (slab, query-tile) steps
        — and the merge is the same two-int32 all_gather used by every
        other engine kind (local ROW ids, not slot ids, cross the
        collective)."""
        key = ("ivf_scan", k, k_local, kp, nprobe, s_pad, qb_local)
        fn = self._fns.get(key)
        if fn is not None:
            return fn
        mesh = self.mesh
        cap = self.subs[0].cap
        d_dim = self.subs[0].codes_cm.shape[1]
        merge = self._merge_fn(k)

        @functools.partial(
            jax.shard_map,
            mesh=mesh,
            in_specs=(
                P("data", None),
                P("shard", None, None),            # slab-space codes
                P("shard", None),                  # row norms
                P("shard", None),                  # -> local row ids
                P("shard"),                        # int8 scales
                P("shard"),                        # host-computed q scales
                P("shard"),                        # sq/sc ratios
                P("data", "shard", None),          # step_cluster
                P("data", "shard", None, None),    # step query tiles
                P("data", "shard", None, None),    # (query, probe) -> slot
            ),
            out_specs=(P("data", None), P("data", None), P("data", None)),
            check_vma=False,
        )
        def body(q, codes_s, rn_s, rowid_s, scale_s, qscale_s, ratio_s,
                 stepc_s, qidx_s, slot_s):
            s = scale_s[0]
            rat = ratio_s[0]
            q8f = jnp.round(q / qscale_s[0])
            qn = jnp.sum(q8f * q8f, axis=-1)
            # dump row (plan index qb_local) gathers zeros
            q8 = jnp.concatenate(
                [q8f.astype(jnp.int8),
                 jnp.zeros((1, q.shape[1]), jnp.int8)]
            )
            ds, rs = scan_probed_slabs(
                q8, codes_s[0], rn_s[0], stepc_s[0, 0], qidx_s[0, 0],
                rat, cap, d_dim, kp,
            )
            cat_d = ds[slot_s[0, 0]].reshape(qb_local, nprobe * kp)
            cat_i = rs[slot_s[0, 0]].reshape(qb_local, nprobe * kp)
            neg, sel = jax.lax.top_k(-cat_d, k_local)
            d_cand = -neg
            slots = jnp.take_along_axis(cat_i, sel, axis=1)
            # -1 for empty slots -> merge-masked
            rows = jnp.where(d_cand < _IVF_BIGF / 2, rowid_s[0][slots], -1)
            # quantized int-score -> fp32 squared L2 so shards with
            # different scales merge in one metric space
            d_loc = (d_cand + rat * rat * qn[:, None]) * (s * s)
            return merge(d_loc, rows)

        fn = jax.jit(
            lambda q, dev, qscale, ratio, stepc, qidx, slot: body(
                q, dev[3], dev[4][0], dev[4][1], dev[4][4], qscale, ratio,
                stepc, qidx, slot,
            )
        )
        self._fns[key] = fn
        return fn

    def _ivfpq_probe_fn(self, nprobe: int, approx: bool = False):
        """IVFPQ probe: identical to the IVFINT8 probe plus the per-shard
        OPQ rotation applied BEFORE quantization (coarse centroids live in
        the rotated code space)."""
        key = ("ivfpq_probe", nprobe, approx)
        fn = self._fns.get(key)
        if fn is not None:
            return fn
        mesh = self.mesh

        @functools.partial(
            jax.shard_map,
            mesh=mesh,
            in_specs=(
                P("data", None),
                P("shard", None, None),
                P("shard", None),
                P("shard"),
                P("shard"),
                P("shard", None, None),
            ),
            out_specs=P("data", None, "shard"),
            check_vma=False,
        )
        def body(q, cent_s, cn_s, qscale_s, ratio_s, rot_s):
            q8f = jnp.round((q @ rot_s[0]) / qscale_s[0])
            d2 = cn_s[0][None, :] - 2.0 * ratio_s[0] * (q8f @ cent_s[0].T)
            if approx:
                _, ids = jax.lax.approx_max_k(-d2, nprobe,
                                              recall_target=0.99)
            else:
                _, ids = jax.lax.top_k(-d2, nprobe)
            return ids.astype(jnp.int32)[:, :, None]

        fn = jax.jit(
            lambda q, dev, qscale, ratio: body(
                q, dev[4][2], dev[4][3], qscale, ratio, dev[4][6]
            )
        )
        self._fns[key] = fn
        return fn

    def _ivfpq_scan_fn(self, k: int, k_local: int, kp: int, nprobe: int,
                       s_pad: int, qb_local: int):
        """IVFPQ per-shard probed-slab scan: the IVFINT8 body with PQ slab
        reconstruction (scan_probed_slabs_pq) and per-shard rotation."""
        key = ("ivfpq_scan", k, k_local, kp, nprobe, s_pad, qb_local)
        fn = self._fns.get(key)
        if fn is not None:
            return fn
        mesh = self.mesh
        cap = self.subs[0].cap
        merge = self._merge_fn(k)

        @functools.partial(
            jax.shard_map,
            mesh=mesh,
            in_specs=(
                P("data", None),
                P("shard", None, None),            # packed codes stack
                P("shard", None),                  # recon norms
                P("shard", None),                  # -> local row ids
                P("shard"),                        # codebook scales
                P("shard"),                        # host-computed q scales
                P("shard"),                        # sq/sc ratios
                P("shard", None, None, None),      # int8 centroid tables
                P("shard", None, None),            # OPQ rotations
                P("data", "shard", None),          # step_cluster
                P("data", "shard", None, None),    # step query tiles
                P("data", "shard", None, None),    # (query, probe) -> slot
            ),
            out_specs=(P("data", None), P("data", None), P("data", None)),
            check_vma=False,
        )
        def body(q, codes_s, rn_s, rowid_s, scale_s, qscale_s, ratio_s,
                 cent_bf_s, rot_s, stepc_s, qidx_s, slot_s):
            sc = scale_s[0]
            rat = ratio_s[0]
            q8f = jnp.round((q @ rot_s[0]) / qscale_s[0])
            qn = jnp.sum(q8f * q8f, axis=-1)
            q8 = jnp.concatenate(
                [q8f.astype(jnp.int8),
                 jnp.zeros((1, q.shape[1]), jnp.int8)]
            )
            ds, rs = scan_probed_slabs_pq(
                q8, codes_s[0], rn_s[0], cent_bf_s[0], stepc_s[0, 0],
                qidx_s[0, 0], rat, cap, kp,
            )
            cat_d = ds[slot_s[0, 0]].reshape(qb_local, nprobe * kp)
            cat_i = rs[slot_s[0, 0]].reshape(qb_local, nprobe * kp)
            neg, sel = jax.lax.top_k(-cat_d, k_local)
            d_cand = -neg
            slots = jnp.take_along_axis(cat_i, sel, axis=1)
            rows = jnp.where(d_cand < _IVF_BIGF / 2, rowid_s[0][slots], -1)
            d_loc = (d_cand + rat * rat * qn[:, None]) * (sc * sc)
            return merge(d_loc, rows)

        fn = jax.jit(
            lambda q, dev, qscale, ratio, stepc, qidx, slot: body(
                q, dev[3], dev[4][0], dev[4][1], dev[4][4], qscale, ratio,
                dev[4][5], dev[4][6], stepc, qidx, slot,
            )
        )
        self._fns[key] = fn
        return fn

    def _fetch_probe_local(self, arr):
        """[Q, nprobe, S] probe output -> host.  Single-controller: the
        whole array.  Multi-process: only this process's shard columns (in
        shard-id order — own_shards blocks are contiguous ascending), since
        plans are built for local shards only."""
        if not self._local_only:
            return np.asarray(arr)
        cols = {}
        for shard in arr.addressable_shards:
            c = shard.index[2].start or 0
            if c not in cols:  # shard-axis replicas carry identical data
                cols[c] = np.asarray(shard.data)
        return np.concatenate([cols[c] for c in sorted(cols)], axis=2)

    def _search_ivf(self, queries: np.ndarray, k: int, ef: int):
        """IVF sharded search: probe (device) -> plan inversion (host, per
        (data position, shard) pair — the same cheap integer work the
        single-chip engine does) -> slab scan + merge (device)."""
        queries = np.asarray(queries, np.float32)
        nq = queries.shape[0]
        n_data = self.mesh.shape["data"]
        dev = self._device()
        # In multi-process mode this process plans only for ITS shards
        # (self.subs is the local slice, in shard-id order)
        s_loc = len(self.subs)
        # nprobe may reach the LARGEST shard's cluster count so a full probe
        # is exhaustive on every shard (post-split counts differ per shard);
        # ids probed past a smaller shard's real clusters are +inf-norm
        # dummies, clipped below and dup-redirected to the empty slab
        ccounts = [s.centroids.shape[0] for s in self.subs]
        cmax = self._global_max(max(ccounts))
        nprobe = int(np.clip(ef if ef else 32, 1, cmax))
        # auto approx probe, same rule as the single-chip engines
        from deepreadmapper_tpu.index.ivf_int8 import IVFInt8Index

        approx = cmax >= IVFInt8Index._APPROX_PROBE_NLIST
        cap = self.subs[0].cap
        k_eff = min(k, self.ntotal)
        kp = min(k_eff, cap)
        k_local = min(k_eff, nprobe * kp, self.n_local)
        k_merge = min(k, self.mesh.shape["shard"] * k_local)
        pq_kind = self.kind == "ivfpq"
        probe_fn = (
            self._ivfpq_probe_fn(nprobe, approx) if pq_kind
            else self._ivf_probe_fn(nprobe, approx)
        )
        # Host-side per-shard query quantization scales over the FULL batch
        # — every data position (and the single-chip engine, bit-for-bit)
        # quantizes queries identically.  Zero pad rows don't move the max.
        # IVFPQ scales are over the ROTATED queries (rotation happens before
        # quantization on device too).
        from deepreadmapper_tpu.index.int8_flat import query_scale_ratio

        sr = [
            query_scale_ratio(
                queries @ sub.rot
                if pq_kind and sub.rot is not None else queries,
                sub.scale,
            )
            for sub in self.subs
        ]
        qscale = self._put(np.array([x[0] for x in sr], np.float32), "shard")
        ratio = self._put(np.array([x[1] for x in sr], np.float32), "shard")
        q_super = _Q_SUPER_PER_DATA * n_data
        out_i = np.full((nq, k), -1, np.int64)
        out_d = np.full((nq, k), np.inf, np.float32)
        pending = []
        for s in range(0, nq, q_super):
            e = min(s + q_super, nq)
            qb = queries[s:e]
            width = q_super if nq > q_super else (
                e - s + (-(e - s)) % n_data
            )
            if qb.shape[0] < width:
                qb = np.pad(qb, ((0, width - qb.shape[0]), (0, 0)))
            qj = self._put(qb, "data", None)
            # [width, nprobe, S_loc]: this process's probe columns
            probe = self._fetch_probe_local(probe_fn(qj, dev, qscale, ratio))
            qb_local = width // n_data
            # host plan inversion per (data position, local shard); pad
            # every plan to one step count so all devices run one program
            qtile = _IVF_QTILE

            def _clip(db, li):
                # dummy probes (nprobe > this shard's real cluster count)
                # clip to the last real cluster; the plan's duplicate-slab
                # redirect then sends them to the empty slab
                return np.minimum(
                    probe[db * qb_local:(db + 1) * qb_local, :, li],
                    ccounts[li] - 1,
                )

            plans = [
                [
                    self.subs[li]._build_plan(_clip(db, li), qtile)
                    for li in range(s_loc)
                ]
                for db in range(n_data)
            ]
            s_pad = self._global_max(
                max(p[0].shape[0] for row in plans for p in row)
            )
            stepc = np.zeros((n_data, s_loc, s_pad), np.int32)
            qidx = np.full(
                (n_data, s_loc, s_pad, qtile), qb_local, np.int32
            )
            slot = np.zeros(
                (n_data, s_loc, qb_local, nprobe), np.int32
            )
            for db in range(n_data):
                for li in range(s_loc):
                    sc, qi, so = plans[db][li]
                    stepc[db, li, : sc.shape[0]] = sc
                    qidx[db, li, : qi.shape[0]] = qi
                    slot[db, li] = so
            scan_fn = (
                self._ivfpq_scan_fn if pq_kind else self._ivf_scan_fn
            )
            fn = scan_fn(k_merge, k_local, kp, nprobe, s_pad, qb_local)
            # dispatch only — results fetch after the loop so batch i+1's
            # probe overlaps batch i's scan (the probe fetch itself must
            # block: the plan depends on it)
            pending.append((s, e, fn(
                qj, dev, qscale, ratio,
                self._put(stepc, "data", "shard", None),
                self._put(qidx, "data", "shard", None, None),
                self._put(slot, "data", "shard", None, None),
            )))
        for s, e, (d, i, shd) in pending:
            out_i[s:e, :k_merge] = compose_global_ids(
                np.asarray(i)[: e - s], np.asarray(shd)[: e - s],
                self.n_local,
            )
            out_d[s:e, :k_merge] = np.asarray(d, np.float32)[: e - s]
        return out_i, out_d

    # -------------------------------------------------------------- search

    def _merge_fn(self, k: int):
        """Shard-local -> global merge without a 2^31 id cap: the collectives
        carry TWO int32 payloads (local id, shard id) and the host composes
        int64 global ids (shard * n_local + local), so total index size is
        bounded only by per-shard HBM.  Validity of (shard, local) against
        ntotal is decided in pure int32: shards before ntotal // n_local are
        full; the boundary shard keeps rows below ntotal % n_local."""
        n_local, ntotal = self.n_local, self.ntotal
        full_shards = ntotal // n_local
        boundary_rows = ntotal % n_local

        def merge(d, i):
            shard = jax.lax.axis_index("shard").astype(jnp.int32)
            valid = (i >= 0) & (i < n_local) & (
                (shard < full_shards)
                | ((shard == full_shards) & (i < boundary_rows))
            )
            d = jnp.where(valid, d, jnp.float32(np.inf))
            i = jnp.where(valid, i, -1)
            sh = jnp.where(valid, jnp.broadcast_to(shard, i.shape), -1)
            d_all = jax.lax.all_gather(d, "shard", axis=1, tiled=True)
            i_all = jax.lax.all_gather(i, "shard", axis=1, tiled=True)
            s_all = jax.lax.all_gather(sh, "shard", axis=1, tiled=True)
            neg, pos = jax.lax.top_k(-d_all, k)
            return (
                -neg,
                jnp.take_along_axis(i_all, pos, axis=1),
                jnp.take_along_axis(s_all, pos, axis=1),
            )

        return merge

    def _get_search_fn(self, k: int, ef_eff: int, k_local: int):
        """Build (once per (k, ef) signature) the jit-wrapped shard_map search
        — redefining the closure per call would retrace + recompile every
        search() invocation.  Search calls fn(q, dev)."""
        key = (k, ef_eff, k_local)
        hit = self._fns.get(key)
        if hit is not None:
            return hit
        mesh = self.mesh
        mode = self.mode
        n_local = self.n_local
        merge = self._merge_fn(k)

        if self.kind == "flat":

            @functools.partial(
                jax.shard_map,
                mesh=mesh,
                in_specs=(P("data", None), P("shard", None, None)),
                out_specs=(P("data", None), P("data", None), P("data", None)),
                check_vma=False,
            )
            def body(q, vecs_s):
                from deepreadmapper_tpu.ops.topk import _topk_once

                qn = jnp.sum(q * q, axis=-1)
                d, i = _topk_once(q, vecs_s[0], qn, k_local)
                return merge(d, i)

            fn = jax.jit(lambda q, dev: body(q, dev[3]))
        elif self.kind in ("pqflat", "int8flat"):
            pq = self.kind == "pqflat"
            n_pad = int(self._device()[3].shape[1])
            fused = sk.can_fuse(n_local, n_pad, k_local)
            if fused:
                chunk = sk.choose_chunk(n_pad)
            else:
                chunk = min(_SCAN_CHUNK, n_pad)
                if n_pad % chunk:  # sub-chunk pads
                    chunk = n_pad

            @functools.partial(
                jax.shard_map,
                mesh=mesh,
                in_specs=(
                    P("data", None),
                    P("shard", None, None),
                    # int8: row norms; pq: int8 codebooks
                    P("shard", None, None, None) if pq else P("shard", None),
                    P("shard"),
                    P("shard", None, None) if pq else None,  # OPQ rotations
                ),
                out_specs=(P("data", None), P("data", None), P("data", None)),
                check_vma=False,
            )
            def body(q, codes_s, aux_s, scale_s, rot_s):
                from deepreadmapper_tpu.index.int8_flat import _int8_topk
                from deepreadmapper_tpu.index.pq_flat import _pq_int8_topk

                if pq:
                    q = q @ rot_s[0]  # per-shard OPQ rotation (or identity)
                s = scale_s[0]
                # clip-free query scale; the sq/sc ratio folds into the
                # score (query dims may exceed the code range)
                sq, rat = sk.query_scale_ratio_jnp(q, s)
                q8f = jnp.round(q / sq)
                q8 = q8f.astype(jnp.int8)
                if fused:
                    d, i = sk.fused_scan_topk(
                        q8, codes_s[0], n_local, k_local, chunk,
                        "pq" if pq else "int8",
                        cent8=aux_s[0] if pq else None, ratio=rat,
                    )
                    d = d + rat * rat * jnp.sum(q8f * q8f, axis=-1)[:, None]
                elif pq:
                    d, i = _pq_int8_topk(
                        q8, codes_s[0], aux_s[0], jnp.int32(n_local),
                        k_local, chunk, exact=False, ratio=rat,
                    )
                else:
                    d, i = _int8_topk(
                        q8, codes_s[0], aux_s[0], jnp.int32(n_local),
                        k_local, chunk, ratio=rat,
                    )
                # quantized scores -> fp32 squared L2 so shards with
                # different scales merge in one metric space
                return merge(d * (s * s), i)

            if pq:
                fn = jax.jit(lambda q, dev: body(
                    q, dev[3], dev[4][3], dev[4][2], dev[4][4]))
            else:
                fn = jax.jit(lambda q, dev: body(
                    q, dev[3], dev[4][0], dev[4][1], None))
        else:
            n_levels = len(self._device()[1])
            level_specs = tuple(
                (P("shard", None), P("shard", None, None))
                for _ in range(n_levels)
            )

            @functools.partial(
                jax.shard_map,
                mesh=mesh,
                in_specs=(
                    P("data", None),
                    P("shard", None, None),
                    level_specs,
                    P("shard"),
                    P("shard", None, None),
                    (P("shard", None, None, None) if mode == "pq" else None),
                ),
                out_specs=(P("data", None), P("data", None), P("data", None)),
                check_vma=False,
            )
            def body(q, neigh0_s, levels_s, entry_s, storage_s, cents_s):
                lv = tuple((g[0], nb[0]) for g, nb in levels_s)
                if mode == "pq":
                    qdata = pq_ops.adc_tables(q, cents_s[0])
                else:
                    qdata = q
                d, i = hnsw_search_device(
                    neigh0_s[0],
                    lv,
                    entry_s[0],
                    storage_s[0],
                    qdata,
                    ef=ef_eff,
                    iters=ef_eff,
                    k=k_local,
                    mode=mode,
                )
                return merge(d, i)

            fn = jax.jit(
                lambda q, dev: body(q, dev[0], dev[1], dev[2], dev[3], dev[4])
            )
        self._fns[key] = fn
        return fn

    def search(self, queries: np.ndarray, k: int, ef: int = 128):
        """queries [Q, D] -> (ids [Q, k] int64 global, dists [Q, k]).

        Queries are data-parallel over the 'data' axis and replicated over
        'shard'; Q is padded up to a multiple of the 'data' axis."""
        queries = np.asarray(queries, np.float32)
        if self.kind in ("ivfint8", "ivfpq"):
            # ef acts as nprobe (engine convention, index/ivf_int8.py)
            return self._search_ivf(queries, k, ef)
        nq = queries.shape[0]
        n_data = self.mesh.shape["data"]
        dev = self._device()
        ef_eff = max(ef, k)
        k_local = min(ef_eff, self.n_local)
        fn = self._get_search_fn(k, ef_eff, k_local)
        # Bound per-call queries (8192/data position) so the per-shard score
        # tensors stay in device memory; pad every batch to the same shape so all
        # batches share one compiled program.
        q_super = _Q_SUPER_PER_DATA * n_data
        out_i = np.empty((nq, k), np.int64)
        out_d = np.empty((nq, k), np.float32)
        pending = []
        # the windowed scans need the per-device query count to be a
        # query-tile multiple; over-padding is harmless for the other kinds
        align = (
            n_data * sk.QT
            if self.kind in ("int8flat", "pqflat") and use_kernels()
            else n_data
        )
        for s in range(0, nq, q_super):
            e = min(s + q_super, nq)
            qb = queries[s:e]
            width = q_super if nq > q_super else (e - s + (-(e - s)) % align)
            if qb.shape[0] < width:
                qb = np.pad(qb, ((0, width - qb.shape[0]), (0, 0)))
            qj = self._put(qb, "data", None)
            pending.append((s, e, fn(qj, dev)))
        for s, e, (d, i, shd) in pending:
            out_i[s:e] = compose_global_ids(
                np.asarray(i)[: e - s], np.asarray(shd)[: e - s], self.n_local
            )
            out_d[s:e] = np.asarray(d, dtype=np.float32)[: e - s]
        return out_i, out_d

    # -------------------------------------------------------- persistence

    def save(self, index_prefix: str) -> None:
        """One sub-index directory per shard (shard_0/..shard_{S-1}/) plus a
        sharded.txt manifest; the per-index config.txt is written by the
        build pipeline exactly as for single-chip indexes."""
        import os

        os.makedirs(index_prefix, exist_ok=True)
        for si, sub in enumerate(self.subs):
            sub_dir = os.path.join(index_prefix, f"shard_{si}")
            os.makedirs(sub_dir, exist_ok=True)
            sub.save(sub_dir)
        with open(os.path.join(index_prefix, "sharded.txt"), "w") as f:
            f.write(f"n_shard:{len(self.subs)}\n")
            f.write(f"ntotal:{self.ntotal}\n")
            f.write(f"inner:{self.index_type}\n")

    @classmethod
    def load(cls, index_prefix: str, mesh: Mesh):
        import os

        meta = read_manifest(index_prefix)
        n_shard = int(meta["n_shard"])
        if mesh.shape["shard"] != n_shard:
            raise ValueError(
                f"index has {n_shard} shards but mesh shard axis is "
                f"{mesh.shape['shard']}"
            )
        eng = _REGISTRY[meta["inner"]]
        subs = [
            eng.load(os.path.join(index_prefix, f"shard_{si}"))
            for si in range(n_shard)
        ]
        return cls(subs, mesh, int(meta["ntotal"]), meta["inner"])

    @classmethod
    def load_distributed(cls, index_prefix: str):
        """Multi-process load: every process loads ONLY its own shards
        (distributed.load_own_shards) and contributes them to
        process-spanning global device arrays; search() then runs the SAME
        SPMD shard_map program on every process, so the per-shard scans run
        host-locally and the two-int32 all_gather merge crosses the process
        boundary on the collective fabric.

        Contract: jax.distributed.initialize() first; every process must
        call search() with the IDENTICAL query batch (replicated read
        stream).  The mesh (make_distributed_mesh) gives each SHARD column
        the contiguous device block of the process that loaded it, and each
        data row one device per column — so every host sees the complete
        merged answer.  Falls back to single-controller behavior with one
        process.  All five scan engines (FLAT / INT8FLAT / IVFINT8 / IVFPQ /
        PQFLAT); the graph parity engines stay single-controller."""
        from deepreadmapper_tpu.parallel.distributed import load_own_shards
        from deepreadmapper_tpu.parallel.mesh import make_distributed_mesh

        subs, _mine, meta = load_own_shards(index_prefix)
        n_shard = int(meta["n_shard"])
        mesh = make_distributed_mesh(n_shard)
        obj = cls(subs, mesh, int(meta["ntotal"]), meta["inner"])
        obj._local_only = jax.process_count() > 1
        if obj._local_only and obj.kind == "graph":
            raise NotImplementedError(
                "multi-process sharded search supports the scan engines "
                f"(FLAT/INT8FLAT/IVFINT8/IVFPQ/PQFLAT); got {meta['inner']} — "
                "load per-host and merge on host (tests/test_distributed.py "
                "pattern)"
            )
        return obj
