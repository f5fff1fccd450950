"""Windowed-min exhaustive int8 scan for INT8FLAT and PQFLAT on the GPU.

An exhaustive scan that keeps every score writes a [Q, chunk] score tensor
to device memory (8.6 GB in fp32 for Q=8192 x 2^18 rows) only to read it
back for a top-k.  This scan instead reduces every W=128-row window of the
score matrix to (min score, argmin row) as it is computed; the per-query
top-k then runs on the W-times smaller [Q, chunk/W] window minima.

One contract, two implementations:

* ``winmin_kernel`` — Pallas through Triton.  One block per (query tile,
  candidate tile): the block holds its [QT, D] int8 queries, walks its
  candidate tile one window at a time (int8 x int8 -> int32 tensor-core
  product of [QT, D] x [D, W]), and keeps only each window's min/argmin in
  the epilogue.  Scores never reach device memory.
* ``winmin_xla`` — the plain version XLA compiles: int8 ``dot_general``,
  reshape, min/argmin.  It is the reference the tests and the card's
  timing compare the kernel with; the kernel won on the H100 (PERF.md),
  so the engines run the kernel.

Numerics: every term is an exact integer (int8 products accumulate in
int32, |score| < 2^24) carried in fp32, so at ratio == 1 ordering equals
int32 ordering and both implementations agree bit for bit.  Scores are
(rn - 2r q.r) with r = sq/sc, the query/code quantization-scale ratio; the
caller adds the per-query norm term afterwards (constant per query).

Approximation: one candidate per W-row window.  With k=128 drawn from
N/W >= 2048 windows the expected loss is ~C(k,2)/(N/W) candidates.

PQFLAT runs the same scan: each chunk's int8 rows are reconstructed in XLA
by a gather from the int8 codebook, then scored like INT8FLAT codes.

Reference scoring being replaced: FAISS IndexHNSWPQ ADC
(src/hnswpq/search.cpp:6-57) and the exhaustive oracle
(src/hnswm/bruteforce.cpp:27-86).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from deepreadmapper_tpu.ops.platform import use_kernels

QT = 128      # queries per block
W = 128       # rows per window: one (min, argmin) survivor per W rows
NWB = 8       # windows per block
CT = W * NWB  # candidate rows per block
NUM_WARPS = 8
_BIG = 3.4e38

MIN_FUSED_N = 1 << 18  # below this the plain scan is fast anyway; NW must exceed k
_PAD_BASE = 1 << 18    # pad codes to this multiple so chunks divide evenly
# chunk rows per pass: the kernel's output is [Q, chunk/W] (1 GB of window
# minima at Q=8192 x 2^21 rows); the XLA version materializes [Q, chunk]
# int32 scores, so it takes 2^17 rows (4.3 GB at Q=8192)
_MAX_CHUNK_UNITS = 8
XLA_CHUNK = 1 << 17


def can_fuse(n: int, n_padded: int, k: int, platform: str | None = None) -> bool:
    """The windowed scan's eligibility predicate: a kernel platform, enough
    rows for the window reduction to make sense (and NW >= k), and padding
    laid out on the chunk grid.  Elsewhere the engines run their plain
    per-chunk top-k scan."""
    return (
        use_kernels(platform)
        and n >= MIN_FUSED_N
        and n_padded % _PAD_BASE == 0
        and k <= _PAD_BASE // W
    )


def query_scale_ratio_jnp(q, code_scale):
    """Device twin of index.int8_flat.query_scale_ratio: clip-free query
    quantization scale + the sq/sc ratio folded into the scan score
    (shared by every sharded body)."""
    sq = jnp.maximum(code_scale, jnp.max(jnp.abs(q)) / 127.0)
    return sq, sq / code_scale


def choose_chunk(np_: int, impl: str = "kernel") -> int:
    """Rows per pass.  Kernel: the largest multiple of _PAD_BASE that divides
    np_ (a _PAD_BASE multiple) within _MAX_CHUNK_UNITS units.  XLA: the
    fixed XLA_CHUNK, which divides every _PAD_BASE multiple."""
    if impl == "xla":
        return XLA_CHUNK
    units = np_ // _PAD_BASE
    for d in range(min(_MAX_CHUNK_UNITS, units), 0, -1):
        if units % d == 0:
            return d * _PAD_BASE
    return _PAD_BASE


# ------------------------------------------------------------ plain XLA


def winmin_xla(q8, r8, ntotal, ratio2, w: int = W):
    """q8 [Qp, D] int8, r8 [Np, D] int8, ntotal (rows at or beyond it never
    win), ratio2 = 2*sq/sc -> (vals [Qp, Np/w] f32, args [Qp, Np/w] int32)."""
    qp = q8.shape[0]
    n = r8.shape[0]
    dot = jax.lax.dot_general(
        q8, r8, dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    )  # [Qp, Np] exact
    ri = r8.astype(jnp.int32)
    rn = jnp.sum(ri * ri, axis=1).astype(jnp.float32)
    rn = jnp.where(jnp.arange(n, dtype=jnp.int32) < ntotal, rn, _BIG)
    s = (rn[None, :] - ratio2 * dot.astype(jnp.float32)).reshape(
        qp, n // w, w
    )
    vals = jnp.min(s, axis=-1)
    args = jnp.argmin(s, axis=-1).astype(jnp.int32) + (
        jnp.arange(n // w, dtype=jnp.int32) * w
    )[None, :]
    return vals, args


# ------------------------------------------------------------ Triton kernel


def _winmin_kernel(nt_ref, rat_ref, q_ref, r_ref, vals_ref, args_ref, *,
                   w: int, nwb: int):
    """q_ref [QT, D] int8, r_ref [w*nwb, D] int8 -> vals/args [QT, nwb]."""
    c = pl.program_id(1)
    ct = w * nwb
    qt = q_ref.shape[0]
    q = q_ref[...]
    nt = nt_ref[0]
    rat2 = rat_ref[0]
    col = jax.lax.broadcasted_iota(jnp.int32, (qt, nwb), 1)

    def window(j, carry):
        vacc, aacc = carry
        r = r_ref[pl.ds(j * w, w), :]  # [w, D] int8
        dot = jax.lax.dot_general(
            q, r, dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.int32,
        )  # [QT, w] int32, exact
        ri = r.astype(jnp.int32)
        rn = jnp.sum(ri * ri, axis=1)  # [w] exact
        base = c * ct + j * w
        row = base + jax.lax.broadcasted_iota(jnp.int32, (w,), 0)
        rnf = jnp.where(row < nt, rn.astype(jnp.float32), _BIG)
        s = rnf[None, :] - rat2 * dot.astype(jnp.float32)
        vmin = jnp.min(s, axis=1)
        amin = jnp.argmin(s, axis=1).astype(jnp.int32) + base
        vacc = jnp.where(col == j, vmin[:, None], vacc)
        aacc = jnp.where(col == j, amin[:, None], aacc)
        return vacc, aacc

    init = (
        jnp.full((qt, nwb), _BIG, jnp.float32),
        jnp.zeros((qt, nwb), jnp.int32),
    )
    vacc, aacc = jax.lax.fori_loop(0, nwb, window, init)
    vals_ref[...] = vacc
    args_ref[...] = aacc


@functools.partial(jax.jit, static_argnames=("w", "nwb", "interpret"))
def winmin_kernel(q8, r8, ntotal, ratio2, w: int = W, nwb: int = NWB,
                  interpret: bool = False):
    """Same contract as winmin_xla; Qp % QT == 0 and Np % (w*nwb) == 0."""
    qp, d = q8.shape
    np_ = r8.shape[0]
    ct = w * nwb
    return pl.pallas_call(
        functools.partial(_winmin_kernel, w=w, nwb=nwb),
        grid=(qp // QT, np_ // ct),
        in_specs=[
            pl.BlockSpec((1,), lambda i, c: (0,)),
            pl.BlockSpec((1,), lambda i, c: (0,)),
            pl.BlockSpec((QT, d), lambda i, c: (i, 0)),
            pl.BlockSpec((ct, d), lambda i, c: (c, 0)),
        ],
        out_specs=[
            pl.BlockSpec((QT, nwb), lambda i, c: (i, c)),
            pl.BlockSpec((QT, nwb), lambda i, c: (i, c)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((qp, np_ // w), jnp.float32),
            jax.ShapeDtypeStruct((qp, np_ // w), jnp.int32),
        ],
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS,
                                           num_stages=2),
        interpret=interpret,
        name="int8_winmin",
    )(
        jnp.asarray(ntotal, jnp.int32).reshape(1),
        jnp.asarray(ratio2, jnp.float32).reshape(1),
        q8,
        r8,
    )


# ------------------------------------------------------------ chunked scan


def reconstruct_pq(codes, cent8):
    """PQ codes [n, m] uint8 + int8 codebook [m, ksub, dsub] -> int8 rows
    [n, m*dsub] (an XLA gather; exact)."""
    n, m = codes.shape
    parts = cent8[jnp.arange(m)[None, :], codes.astype(jnp.int32)]
    return parts.reshape(n, m * cent8.shape[2])


@functools.partial(
    jax.jit, static_argnames=("k", "chunk", "kind", "impl", "interpret")
)
def fused_scan_topk(q8, store, ntotal, k: int, chunk: int,
                    kind: str = "int8", cent8=None, ratio=1.0,
                    impl: str = "kernel", interpret: bool = False):
    """Chunked windowed-min scan with exact cross-chunk merge.

    q8 [Qp, D] int8 (Qp % QT == 0); store = r8 [Np, D] int8 (kind='int8')
    or PQ codes [Np, m] uint8 (kind='pq', with cent8 [m, ksub, dsub] int8);
    ntotal = count of real rows (the rest is padding, masked inside the
    scan); Np % chunk == 0, chunk % CT == 0.  Returns (scores [Qp, k] f32 =
    rn - 2r q.r ascending — caller adds the query norm — and ids [Qp, k]
    int32; all-padding windows surface as _BIG scores)."""
    qp = q8.shape[0]
    np_ = store.shape[0]
    n_chunks = np_ // chunk
    nt = jnp.asarray(ntotal, jnp.int32)
    ratio2 = 2.0 * jnp.asarray(ratio, jnp.float32)

    def one_chunk(st, nt_c, c_idx):
        r8 = reconstruct_pq(st, cent8) if kind == "pq" else st
        if impl == "kernel":
            vals, args = winmin_kernel(q8, r8, nt_c, ratio2,
                                       interpret=interpret)
        else:
            vals, args = winmin_xla(q8, r8, nt_c, ratio2)
        nd, pos = jax.lax.top_k(-vals, k)
        return -nd, jnp.take_along_axis(args, pos, axis=1) + c_idx * chunk

    if n_chunks == 1:
        return one_chunk(store, nt, jnp.int32(0))

    def step(carry, c_idx):
        best_d, best_i = carry
        st = jax.lax.dynamic_slice(
            store, (c_idx * chunk, 0), (chunk, store.shape[1])
        )
        d, i = one_chunk(st, nt - c_idx * chunk, c_idx)
        cat_d = jnp.concatenate([best_d, d], axis=1)
        cat_i = jnp.concatenate([best_i, i], axis=1)
        neg, pos = jax.lax.top_k(-cat_d, k)
        return (-neg, jnp.take_along_axis(cat_i, pos, axis=1)), None

    init = (
        jnp.full((qp, k), _BIG, dtype=jnp.float32),
        jnp.zeros((qp, k), dtype=jnp.int32),
    )
    (d, i), _ = jax.lax.scan(
        step, init, jnp.arange(n_chunks, dtype=jnp.int32)
    )
    return d, i


def pad_queries(nq: int, q_batch: int) -> int:
    """Query rows per device call: the batch itself when it is the whole
    request, else the request padded to a QT multiple."""
    return q_batch if nq > q_batch else nq + (-nq) % QT
