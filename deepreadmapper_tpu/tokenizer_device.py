"""On-device tokenization from 2-bit packed bases.

The host<->device link is the scarcest resource in the serving path (the
reference's analog is the OpenVINO tensor memcpy, src/inference/
fast_model.cpp:174-206; ours is PCIe uploads).  Uploading raw sequence
bytes costs ~1 B/base and uploading uint16 token ids ~2 B/token; DNA carries
2 bits/base, so instead the host packs bases into 2-bit codes plus an N-mask
bitmap (~0.28 B/base total) and the tokenizer runs ON DEVICE as a few shifts,
masks and a 256-entry gather, fused by XLA into the encoder's first gather.

Semantics are bit-identical to tokenizer.tokenize_bytes (itself parity-tested
against the reference Preprocessor, src/inference/preprocess.cpp:20-42),
restricted to '<'-wrapped input — which is what every embedding call in the
pipeline uses (reads and windows are always wrapped; includes/utils/
parse_inputs.hpp:10-11).

Wire format: ONE uint8 row of 48 bytes per sequence (wrapped length
lw = n_bases + 2, tokens = min(123, lw)) — a single buffer per transfer,
so each batch pays the per-transfer latency once:
  bytes  0..30  packed bases 0..122, 4 per byte, little-endian 2-bit lanes
  bytes 31..46  N-mask bitmap — bit i set when base i is not acgt (e.g. 'N')
  byte  47      base count, clamped to 255 (only min(count,123) and the
                "is truncated" predicate count>121 affect tokens)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from deepreadmapper_tpu.tokenizer import CHAR_VAL, HASH_TO_ID, MAX_LEN

N_BASES_MAX = MAX_LEN  # bases 0..122 can influence the 123 tokens
PACKED_WIDTH = (N_BASES_MAX + 3) // 4    # 31
NMASK_WIDTH = (N_BASES_MAX + 7) // 8     # 16
WIRE_WIDTH = PACKED_WIDTH + NMASK_WIDTH + 1  # 48


def pack_wrapped(mat: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Pack a wrapped byte matrix into the 2-bit wire format: native C++
    (OpenMP) when available, numpy fallback.  Returns uint8 [N, 48]."""
    from deepreadmapper_tpu import native

    if native.available():
        return native.pack_wrapped(mat, lengths)
    return pack_wrapped_numpy(mat, lengths)


def pack_wrapped_numpy(mat: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Pack a wrapped byte matrix ('<'+seq+'>', as parse_fastq_bytes emits)
    into the single-buffer 2-bit wire format.  Returns uint8 [N, 48]."""
    lengths = np.asarray(lengths, dtype=np.int64)
    nb = np.maximum(lengths - 2, 0)
    n, w = mat.shape
    take = min(max(w - 1, 0), N_BASES_MAX)
    v = np.full((n, N_BASES_MAX), 7, dtype=np.uint8)
    if take:
        v[:, :take] = CHAR_VAL[mat[:, 1 : 1 + take]].astype(np.uint8)
    # zero out beyond each row's base count so pad lanes are deterministic
    valid = np.arange(N_BASES_MAX)[None, :] < nb[:, None]
    code = np.where(valid, v & 3, 0).astype(np.uint8)
    isn = np.where(valid, v >= 4, False)

    wire = np.zeros((n, WIRE_WIDTH), dtype=np.uint8)
    code4 = np.zeros((n, PACKED_WIDTH * 4), dtype=np.uint8)
    code4[:, :N_BASES_MAX] = code
    code4 = code4.reshape(n, PACKED_WIDTH, 4)
    wire[:, :PACKED_WIDTH] = (
        code4[:, :, 0]
        | (code4[:, :, 1] << 2)
        | (code4[:, :, 2] << 4)
        | (code4[:, :, 3] << 6)
    )
    bits = np.zeros((n, NMASK_WIDTH * 8), dtype=np.uint8)
    bits[:, :N_BASES_MAX] = isn.astype(np.uint8)
    wire[:, PACKED_WIDTH : PACKED_WIDTH + NMASK_WIDTH] = np.packbits(
        bits.reshape(n, NMASK_WIDTH, 8), axis=2, bitorder="little"
    )[:, :, 0]
    wire[:, WIRE_WIDTH - 1] = np.minimum(nb, 255).astype(np.uint8)
    return wire


def tokens_from_packed(wire: jax.Array):
    """Device tokenizer: [B, 48] uint8 wire rows -> [B, 123] int32 vocab ids.

    Pure jnp (trace-safe); callers jit it fused with the encoder."""
    packed = wire[:, :PACKED_WIDTH]
    nmask = wire[:, PACKED_WIDTH : PACKED_WIDTH + NMASK_WIDTH]
    nbases = wire[:, WIRE_WIDTH - 1]
    pos = jnp.arange(N_BASES_MAX, dtype=jnp.int32)
    code = (packed[:, pos // 4].astype(jnp.int32) >> (2 * (pos % 4))) & 3
    isn = (nmask[:, pos // 8].astype(jnp.int32) >> (pos % 8)) & 1
    vb = jnp.where(isn == 1, 7, code)  # [B, 123] base values

    nb = nbases.astype(jnp.int32)[:, None]          # [B, 1]
    lw = nb + 2                                     # wrapped length
    ltok = jnp.minimum(lw, MAX_LEN)                 # tokens per row

    # wrapped-position values w[i], i in 0..123: '<' and everything past the
    # last base (including '>') has value 7, matching CHAR_VAL of those bytes
    wpos = jnp.arange(N_BASES_MAX + 1, dtype=jnp.int32)[None, :]  # [1, 124]
    vw = jnp.where(
        (wpos == 0) | (wpos > nb),
        7,
        jnp.pad(vb, ((0, 0), (1, 0))),
    )
    # tokens t = 1..122 use wrapped chars (t-1, t, t+1)
    t = jnp.arange(1, MAX_LEN, dtype=jnp.int32)[None, :]  # [1, 122]
    v0 = vw[:, 0 : MAX_LEN - 1]
    v1 = vw[:, 1:MAX_LEN]
    v2 = vw[:, 2 : MAX_LEN + 1]
    # c2 is '>' when it sits at wrapped index nb+1, or at the final token of
    # an untruncated row (tokenizer.tokenize_bytes force_gt rule)
    force_gt = (t + 1 == ltok) & (ltok == lw)
    c2_gt = (t + 1 == nb + 1) | force_gt
    v2 = jnp.where(c2_gt, 7, v2)

    h_prefix = (v1 << 2) + v2
    h_suffix = 16 + (v0 << 2) + v1
    h_inner = 32 + (v0 << 4) + (v1 << 2) + v2
    h = jnp.where(t == 1, h_prefix, jnp.where(c2_gt, h_suffix, h_inner))

    table = jnp.asarray(HASH_TO_ID)
    toks = jnp.take(table, jnp.clip(h, 0, 255), axis=0)
    tok0 = jnp.take(table, 28 + vw[:, 1], axis=0)
    out = jnp.concatenate([tok0[:, None], toks], axis=1)
    valid = jnp.arange(MAX_LEN, dtype=jnp.int32)[None, :] < ltok
    return jnp.where(valid, out, 0).astype(jnp.int32)
