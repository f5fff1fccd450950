"""IVFPQ: coarse-pruned ADC scan over PQ codes — the >100M-rows/chip tier
at PQ memory footprint.

IVFINT8 (index/ivf_int8.py) prunes with a coarse quantizer but stores
128 B/row.  PQFLAT (index/pq_flat.py) stores 8-16 B/row but scans every row.
This engine combines them: k-means coarse quantizer + slab-major PQ codes,
with on-the-fly int8 reconstruction inside the probed-slab scan.  At
m_pq=8 a row costs 8 B of codes + 4 B of norms (plus slab padding); past
one card the sharded engine (parallel/sharded_ann.py) spreads one index
across cards.  The probed-slab scan does ~nprobe/nlist of the exhaustive
matmul work.

Reference role being replaced: FAISS IndexHNSWPQ's graph pruning over PQ
codes (src/hnswpq/index.cpp:86-193, search.cpp:6-57) — graph traversal is
a chain of dependent gathers, cluster pruning is matmul-bound.

Device mapping (everything static-shape, shared machinery with IVFINT8):

* Coarse clustering runs in the int8-RECONSTRUCTION domain: rows are
  assigned by their reconstructed vectors (the only vectors that exist at
  search time), so probe geometry matches scan geometry exactly.
* Slab layout, oversized-cluster 2-means splitting, first-fit-decreasing
  bin packing, the host plan inversion, and the stacked-slot merge are the
  IVFINT8 implementations, reused verbatim (this class subclasses it).
* The slab scan reconstructs each probed slab's codes in-step: per
  subquantizer, a [ksub, cap] one-hot (iota == code row) contracts with
  the [ksub, dsub] int8-valued
  centroid table — NOT the [m*ksub, d] block-diagonal decoder, which would
  inflate reconstruction FLOPs 8x at m=8.  Reconstruction costs
  cap*ksub*d MACs/step ≈ 2x the QTILE-query score matmul — acceptable; the
  win is pruning the other (1 - nprobe/nlist) of the index.
* Distance math matches PQFlatIndex exactly: scores are
  r²·qn + rn - 2r·(q8·recon8) in exact int32 values carried in fp32, then
  scaled by the codebook scale² — ADC distance == squared L2 to the
  reconstruction.  Full-probe search therefore equals the exhaustive PQ
  scan (verified in tests/test_ivf_pq.py).
* OPQ: codes live in the rotated space; queries rotate at search time
  (orthogonal rotation, L2 unchanged) — same convention as PQFLAT.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from deepreadmapper_tpu.config import BuildConfig
from deepreadmapper_tpu.index.ivf_int8 import (
    _BIGF,
    IVFInt8Index,
    _kmeans_coarse,
    _split_and_pack,
    auto_nlist,
)
from deepreadmapper_tpu.index.registry import register_index
from deepreadmapper_tpu.ops import pq as pq_ops


def _recon_int8_host(codes: np.ndarray, cent8: np.ndarray) -> np.ndarray:
    """[n, m] uint8 codes -> [n, d] int8 reconstruction (host gather)."""
    parts = [cent8[j][codes[:, j].astype(np.int64)] for j in range(cent8.shape[0])]
    return np.concatenate(parts, axis=1)


@functools.partial(jax.jit, static_argnames=("chunk",))
def _assign_nearest_pq(codes, cent8_bf, cent_bf, cn, chunk: int):
    """Nearest coarse centroid per PQ row, reconstruction ON DEVICE.

    A host reconstruction would upload 64 B/row of int8 vectors and run
    the [chunk, nlist] distance matmul in fp32.  Here the raw [N, m] uint8
    codes upload at 8 B/row and each chunk reconstructs via the
    per-subspace one-hot contraction; the distance matmul runs bf16 with
    fp32 accumulation — the reconstruction side is
    EXACT (int8 values), only the centroid side rounds to bf16, which can
    flip genuinely-boundary rows between near-equidistant clusters (the
    probe ranks those clusters together, so coverage is unaffected)."""
    n, m = codes.shape
    ksub = cent8_bf.shape[1]

    def step(_, cc):
        parts = []
        for j in range(m):
            oh = (
                cc[:, j:j + 1].astype(jnp.int32)
                == jax.lax.broadcasted_iota(jnp.int32, (chunk, ksub), 1)
            ).astype(jnp.bfloat16)
            parts.append(oh @ cent8_bf[j])  # [chunk, dsub] exact int8
        r = jnp.concatenate(parts, axis=1)
        d2 = cn[None, :] - 2.0 * jax.lax.dot_general(
            r, cent_bf,
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        return 0, jnp.argmin(d2, axis=-1).astype(jnp.int32)

    _, out = jax.lax.scan(step, 0, codes.reshape(n // chunk, chunk, m))
    return out.reshape(n)


def pack_codes_t(codes_cm: np.ndarray) -> np.ndarray:
    """[N, m] uint8 codes -> [ceil(m/4), N] int32, 4 codes per word.

    Byte-packed so a slab's codes slice as [mp, cap] words: 1 B/code
    (8 B/row at m=8 + the 4 B/row norm array).
    """
    n, m = codes_cm.shape
    mp = -(-m // 4)
    packed = np.zeros((mp, n), np.uint32)
    # chunk the row range: a whole-matrix uint32 transpose would be a
    # 4 B/code transient (tens of GB at the 500M-row scale)
    chunk = 1 << 22
    for s0 in range(0, n, chunk):
        e0 = min(s0 + chunk, n)
        ct = codes_cm[s0:e0].T.astype(np.uint32)  # [m, chunk]
        for j in range(m):
            packed[j // 4, s0:e0] |= ct[j] << (8 * (j % 4))
    return packed.view(np.int32)


def scan_probed_slabs_pq(q8, packed_t_cm, rn_cm, cent_bf, step_cluster,
                         step_qidx, ratio, cap: int, kp: int):
    """The IVFPQ hot loop: one lax.scan over (slab, query-tile) steps.

    q8 [Q+1, D] int8 (last row = dump), packed_t_cm [ceil(m/4), (S+1)*cap]
    int32 TRANSPOSED byte-packed slab-major PQ codes (pack_codes_t), rn_cm
    [(S+1)*cap] fp32 recon norms (+inf on empty slots), cent_bf
    [m, ksub, dsub] bf16 int8-valued centroid tables.  Per step: slice the
    slab's codes, unpack (shifts), reconstruct to int8 via per-subspace
    one-hot matmuls, score QTILE queries with int8 products, keep the
    per-slab top-kp STACKED (no carry scatter — ivf_int8.scan_probed_slabs
    docstring).  Trace-level; callers jit/shard_map it.
    """
    m, ksub, dsub = cent_bf.shape
    mp = packed_t_cm.shape[0]

    def step(_, xs):
        cid, qi = xs
        qs = q8[qi]  # [QTILE, D] int8 gather
        start = cid * cap
        cc = jax.lax.dynamic_slice(packed_t_cm, (0, start), (mp, cap))
        rns = jax.lax.dynamic_slice(rn_cm, (start,), (cap,))
        parts = []
        for j in range(m):
            byte = jnp.bitwise_and(
                jax.lax.shift_right_logical(
                    cc[j // 4 : j // 4 + 1, :], 8 * (j % 4)
                ),
                255,
            )  # [1, cap] int32
            oh_t = (
                jax.lax.broadcasted_iota(jnp.int32, (ksub, cap), 0) == byte
            ).astype(jnp.bfloat16)  # [ksub, cap]
            parts.append(
                jax.lax.dot_general(
                    cent_bf[j], oh_t,
                    dimension_numbers=(((0,), (0,)), ((), ())),
                    preferred_element_type=jnp.float32,
                )  # [dsub, cap] exact int8-valued
            )
        recon8_t = jnp.concatenate(parts, axis=0).astype(jnp.int8)  # [D, cap]
        dot = jax.lax.dot_general(
            qs, recon8_t,
            dimension_numbers=(((1,), (0,)), ((), ())),
            preferred_element_type=jnp.int32,
        )  # [QTILE, cap] exact
        scores = rns[None, :] - (2.0 * ratio) * dot.astype(jnp.float32)
        nd, pos = jax.lax.approx_max_k(-scores, kp, recall_target=0.99)
        rows = start + pos.astype(jnp.int32)
        return 0, (-nd, rows)

    _, (ds, rs) = jax.lax.scan(step, 0, (step_cluster, step_qidx))
    return ds.reshape(-1, kp), rs.reshape(-1, kp)


@register_index("IVFPQ")
class IVFPQIndex(IVFInt8Index):
    """Cluster-pruned PQ/ADC scan (sub-linear at 8-16 B/row; ef = nprobe).

    Inherits the IVFINT8 probe, host plan inversion, merge, and search
    loop; only storage (PQ codes + codebook) and the slab scan differ.
    """

    def __init__(self, codes_cm, centroids, row_ids, slab_of, codebook,
                 ntotal, cap, n_slabs, rot=None):
        self.codebook = codebook                      # PQCodebook fp32
        self.cb8 = pq_ops.quantize_codebook(codebook)
        self.rot = None if rot is None else np.asarray(rot, np.float32)
        super().__init__(
            codes_cm, centroids, row_ids, slab_of, self.cb8.scale, ntotal,
            cap, n_slabs,
        )

    # ------------------------------------------------------------- build

    @classmethod
    def build(cls, embeddings, cfg: BuildConfig | None = None):
        cfg = cfg or BuildConfig()
        x = np.asarray(embeddings, np.float32)
        train = pq_ops.sample_training_set(x, cfg.sample_rate)
        rot = None
        if cfg.opq:
            cb, rot = pq_ops.train_opq(
                np.asarray(train), m=cfg.m_pq, nbits=cfg.nbits,
                iters=cfg.opq_iters, seed=cfg.seed,
            )
            codes = pq_ops.encode_pq(x, cb, rot=rot)
        else:
            cb = pq_ops.train_pq(
                train, m=cfg.m_pq, nbits=cfg.nbits, iters=cfg.kmeans_iters,
                seed=cfg.seed,
            )
            codes = pq_ops.encode_pq(x, cb)
        return cls.build_from_codes(codes, cb, cfg, rot=rot)

    @classmethod
    def build_from_codes(cls, codes: np.ndarray, codebook, cfg=None,
                         rot=None, scale: float | None = None):
        """Build from PQ codes [N, m] uint8 + their codebook (the streaming
        FASTA path hands these straight from the device encoder — fp32
        embeddings never materialize).  `scale` accepted for signature
        parity with IVFInt8Index and ignored (the codebook carries it)."""
        del scale
        cfg = cfg or BuildConfig()
        cb8 = pq_ops.quantize_codebook(codebook)
        n, m = codes.shape
        d = cb8.cent8.shape[0] * cb8.cent8.shape[2]
        nlist = cfg.nlist if cfg.nlist else auto_nlist(n)
        nlist = min(nlist, max(n, 1))
        # slab capacity: ~1.25x the mean cluster, a multiple of 128 rows
        cap = -(-int(np.ceil(n / nlist * 1.25)) // 128) * 128
        cap = max(cap, 128)

        # --- coarse k-means on a reconstruction sample (int8 domain) ---
        target = min(n, max(nlist * 24, 4096), 131_072)
        step = max(1, n // max(target, 1))
        sample = _recon_int8_host(codes[::step], cb8.cent8).astype(np.float32)
        print(f"[IVFPQ] coarse k-means: {sample.shape[0]} sample rows, "
              f"nlist={nlist}", flush=True)
        idx = (np.arange(nlist) * (sample.shape[0] / nlist)).astype(np.int64)
        rng = np.random.default_rng(cfg.seed)
        init = sample[idx] + rng.standard_normal((nlist, d)).astype(
            np.float32
        ) * 1e-3
        cent0 = np.asarray(
            _kmeans_coarse(jnp.asarray(sample), jnp.asarray(init), nlist, 15)
        )

        # --- nearest-cluster assignment: raw codes upload (8 B/row),
        # reconstruction + bf16 distance matmul ON DEVICE (_assign_nearest_pq
        # docstring) ---
        chunk = 8192
        assign = np.empty(n, np.int32)
        cent8_bf = jnp.asarray(cb8.cent8.astype(np.float32), jnp.bfloat16)
        cent_bf = jnp.asarray(cent0, jnp.bfloat16)
        cn_dev = jnp.asarray((cent0 * cent0).sum(-1).astype(np.float32))
        slice_rows = chunk * 4096  # ~256 MB of codes per upload at m=8
        import time as _t
        _t0 = _t.time()
        for s in range(0, n, slice_rows):
            if s:
                print(f"[IVFPQ] assign {s}/{n} rows "
                      f"({s / (_t.time() - _t0):,.0f} rows/s)", flush=True)
            e = min(s + slice_rows, n)
            cc = np.ascontiguousarray(codes[s:e])
            pad = (-cc.shape[0]) % chunk
            if pad:
                cc = np.concatenate(
                    [cc, np.zeros((pad, cc.shape[1]), np.uint8)]
                )
            assign[s:e] = np.asarray(
                _assign_nearest_pq(
                    jnp.asarray(cc), cent8_bf, cent_bf, cn_dev,
                    min(chunk, cc.shape[0]),
                )
            )[: e - s]

        # --- split oversized clusters, bin-pack into slabs, lay out ---
        # _split_and_pack 2-means over fp32 rows; feed it reconstructions
        # via a fetch callback so only oversized clusters materialize.
        print(f"[IVFPQ] assign done; splitting/packing into cap={cap} "
              "slabs", flush=True)
        clusters, slab_of, n_slabs = _split_and_pack(
            codes, assign, cent0, cap, cfg.seed + 1,
            fetch=lambda rows: _recon_int8_host(
                codes[rows], cb8.cent8
            ).astype(np.float32),
        )
        print(f"[IVFPQ] layout: {len(clusters)} clusters -> {n_slabs} slabs",
              flush=True)
        cent = np.stack([cc for _rows, cc in clusters]).astype(np.float32)
        codes_cm = np.zeros(((n_slabs + 1) * cap, m), np.uint8)
        row_ids = np.full((n_slabs + 1) * cap, -1, np.int64)
        used = np.zeros(n_slabs, np.int64)
        for ci, (rows, _cc) in enumerate(clusters):
            si = slab_of[ci]
            base = si * cap + used[si]
            codes_cm[base:base + len(rows)] = codes[rows]
            row_ids[base:base + len(rows)] = rows
            used[si] += len(rows)
        return cls(codes_cm, cent, row_ids, slab_of, codebook, n, cap,
                   n_slabs, rot=rot)

    # ------------------------------------------------------------ device

    def _device(self):
        """Flat transposed byte-packed codes [mp, (S+1)*cap], recon norms
        (+inf on empty slots), the coarse centroids and their norms, plus
        the int8-valued centroid tables [m, ksub, dsub] for in-step
        reconstruction (self._cent_dev)."""
        if self._dev is None:
            cent = jnp.asarray(self.centroids)
            cn = jnp.sum(cent * cent, axis=-1)
            rn_np = pq_ops.recon_norms(self.codes_cm, self.cb8.cent_norms)
            rn_np = np.where(
                self.row_ids >= 0, rn_np.astype(np.float32), _BIGF
            )
            c = jnp.asarray(pack_codes_t(self.codes_cm))
            rn = jnp.asarray(rn_np)
            self._cent_dev = jnp.asarray(
                self.cb8.cent8.astype(np.float32), jnp.bfloat16
            )
            self._dev = (c, rn, cent, cn)
        return self._dev

    # ------------------------------------------------------------ search

    def _scan_fn(self, k: int, kp: int, nprobe: int):
        key = ("scan", k, kp, nprobe)
        fn = self._fns.get(key)
        if fn is None:
            cap = self.cap

            @jax.jit
            def scan(q8, packed_t_cm, rn_cm, cent_bf, step_cluster,
                     step_qidx, slot_of, ratio):
                ds, rs = scan_probed_slabs_pq(
                    q8, packed_t_cm, rn_cm, cent_bf, step_cluster, step_qidx,
                    ratio, cap, kp,
                )
                q = slot_of.shape[0]
                cat_d = ds[slot_of].reshape(q, nprobe * kp)
                cat_i = rs[slot_of].reshape(q, nprobe * kp)
                neg, sel = jax.lax.top_k(-cat_d, k)
                return -neg, jnp.take_along_axis(cat_i, sel, axis=1)

            # the base search loop calls scan_fn(q8, c, rn, steps, qidx,
            # slot_of, ratio); splice the centroid tables in here so the
            # jitted program still takes them as a real argument (never a
            # closure capture — illegal across processes)
            jit_scan = scan

            def fn(q8, c, rn, step_cluster, qidx, slot_of, ratio):
                return jit_scan(q8, c, rn, self._cent_dev, step_cluster,
                                qidx, slot_of, ratio)

            self._fns[key] = fn
        return fn

    def search(self, queries: np.ndarray, k: int, ef: int = 32,
               exact: bool = False, approx_probe: bool | None = None,
               stats: dict | None = None):
        """ef = nprobe; distances are squared-L2 ADC estimates in the
        PQFlatIndex convention.  OPQ queries rotate into the code space."""
        queries = np.asarray(queries, np.float32)
        if self.rot is not None and queries.size:
            queries = queries @ self.rot
        return super().search(queries, k, ef=ef, exact=exact,
                              approx_probe=approx_probe, stats=stats)

    # -------------------------------------------------------- persistence

    def save(self, index_prefix: str) -> None:
        os.makedirs(index_prefix, exist_ok=True)
        payload = dict(
            codes_cm=self.codes_cm,
            centroids=self.centroids,
            row_ids=self.row_ids,
            slab_of=self.slab_of,
            pq_centroids=np.asarray(self.codebook.centroids),
            ntotal=self.ntotal,
            cap=self.cap,
            n_slabs=self.n_slabs,
        )
        if self.rot is not None:
            payload["rot"] = self.rot
        np.savez(os.path.join(index_prefix, "ivf_pq.npz"), **payload)

    @classmethod
    def load(cls, index_prefix: str, config: dict | None = None):
        z = np.load(os.path.join(index_prefix, "ivf_pq.npz"))
        return cls(
            z["codes_cm"], z["centroids"], z["row_ids"], z["slab_of"],
            pq_ops.PQCodebook(jnp.asarray(z["pq_centroids"])),
            int(z["ntotal"]), int(z["cap"]), int(z["n_slabs"]),
            rot=z["rot"] if "rot" in z.files else None,
        )
