"""Smith-Waterman scoring as a batched anti-diagonal wavefront.

Parity target: calc_sw_score (reference src/utils/metrics.cpp:10-45) —
match +1, mismatch -1, linear gap -1, score = max DP cell, comparing RAW bytes
(the reference scores '<'-wrapped queries against unwrapped candidates, so the
wrap characters simply mismatch; we reproduce that).

Formulation: the per-pair O(m*n) DP has a sequential chain along rows and
columns but every cell on an anti-diagonal d = i + j is independent.  We scan
over the 2L-1 anti-diagonals carrying two diagonal vectors, vectorized over
BOTH the diagonal axis and a large batch-of-pairs axis.  No masking is required: rows are padded with
sentinel byte 254 and columns with 255, which can never match anything, so
ghost cells outside the true m x n region provably stay at 0 (exactly the SW
border condition) and never affect the running max.

The b-char gather per diagonal, b[d - i], is a single dynamic slice of a
REVERSED padded array (index algebra hoists the flip out of the loop).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

_PAD_A = 254
_PAD_B = 255


@functools.partial(jax.jit, static_argnames=("lr", "lc"))
def _sw_batch(av: jax.Array, bflip: jax.Array, lr: int, lc: int) -> jax.Array:
    """av [P, lr+1] uint8 (row chars, av[:,0] sentinel); bflip [P, lr+lc+2]
    uint8 with bflip[:, lr+lc+1-t] = b[t] (1-based).  Returns max cell [P]."""
    p = av.shape[0]
    width = lr + 1
    av_i = av.astype(jnp.int32)

    def step(carry, d):
        h1, h2, best = carry  # H_{d-1}, H_{d-2}, running max
        bv = jax.lax.dynamic_slice_in_dim(bflip, lr + lc + 1 - d, width, axis=1)
        s = jnp.where(av_i == bv.astype(jnp.int32), 1, -1)
        h2s = jnp.pad(h2[:, :-1], ((0, 0), (1, 0)))  # H[i-1, j-1]
        h1s = jnp.pad(h1[:, :-1], ((0, 0), (1, 0)))  # H[i-1, j]
        h = jnp.maximum(
            jnp.maximum(h2s + s, 0),
            jnp.maximum(h1s - 1, h1 - 1),
        )
        best = jnp.maximum(best, jnp.max(h, axis=1))
        return (h, h1, best), None

    zeros = jnp.zeros((p, width), dtype=jnp.int32)
    init = (zeros, zeros, jnp.zeros((p,), dtype=jnp.int32))
    (h1, h2, best), _ = jax.lax.scan(
        step, init, jnp.arange(2, lr + lc + 1, dtype=jnp.int32)
    )
    return best


def _pack(seqs_mat: np.ndarray, lens: np.ndarray, pad: int) -> np.ndarray:
    """Replace bytes past each row's length with the sentinel."""
    out = seqs_mat.copy()
    cols = np.arange(out.shape[1])[None, :]
    out[cols >= lens[:, None]] = pad
    return out


def sw_scores(
    a_mat: np.ndarray,
    a_lens: np.ndarray,
    b_mat: np.ndarray,
    b_lens: np.ndarray,
    chunk: int = 8192,
) -> np.ndarray:
    """Batched SW scores.  a_mat [P, La] / b_mat [P, Lb] uint8 with per-row
    true lengths; returns int32 [P]."""
    p = a_mat.shape[0]
    if p == 0:
        return np.zeros(0, dtype=np.int32)
    lr = int(a_mat.shape[1])
    lc = int(b_mat.shape[1])
    a = _pack(np.ascontiguousarray(a_mat), np.asarray(a_lens), _PAD_A)
    b = _pack(np.ascontiguousarray(b_mat), np.asarray(b_lens), _PAD_B)

    # av: row chars 1-based with sentinel at column 0.
    av = np.full((p, lr + 1), _PAD_A, dtype=np.uint8)
    av[:, 1:] = a
    # bflip: bflip[:, lr+lc+1-t] = b[t] for t in 1..lc; sentinel elsewhere.
    # Width 2*lr+lc+2 so the slice [lr+lc+1-d, +lr+1) stays in bounds for the
    # smallest diagonal d=2 (jax dynamic_slice would otherwise clamp the
    # start and silently misalign).
    bflip = np.full((p, 2 * lr + lc + 2), _PAD_B, dtype=np.uint8)
    bflip[:, lr + 1 : lr + lc + 1] = b[:, ::-1]

    out = np.empty(p, dtype=np.int32)
    for start in range(0, p, chunk):
        end = min(start + chunk, p)
        n = end - start
        av_c, bf_c = av[start:end], bflip[start:end]
        if n < chunk and p > chunk:
            av_c = np.pad(av_c, ((0, chunk - n), (0, 0)), constant_values=_PAD_A)
            bf_c = np.pad(bf_c, ((0, chunk - n), (0, 0)), constant_values=_PAD_B)
        res = np.asarray(_sw_batch(jnp.asarray(av_c), jnp.asarray(bf_c), lr, lc))
        out[start:end] = res[:n]
    return out


def sw_score_pair(seq1: str | bytes, seq2: str | bytes) -> int:
    """Single-pair convenience (parity with calc_sw_score's signature)."""
    a = np.frombuffer(seq1.encode() if isinstance(seq1, str) else seq1, np.uint8)
    b = np.frombuffer(seq2.encode() if isinstance(seq2, str) else seq2, np.uint8)
    return int(
        sw_scores(
            a[None, :], np.array([a.size]), b[None, :], np.array([b.size])
        )[0]
    )


def sw_score_reference(seq1: str, seq2: str) -> int:
    """Scalar transliteration of calc_sw_score (metrics.cpp:10-45) — the
    parity oracle for tests."""
    m, n = len(seq1), len(seq2)
    prev = [0] * (n + 1)
    best = 0
    for i in range(1, m + 1):
        cur = [0] * (n + 1)
        for j in range(1, n + 1):
            sc = 1 if seq1[i - 1] == seq2[j - 1] else -1
            cur[j] = max(0, prev[j - 1] + sc, prev[j] - 1, cur[j - 1] - 1)
            if cur[j] > best:
                best = cur[j]
        prev = cur
    return best
