"""2-layer bidirectional GRU read encoder (JAX).

Replaces the reference's OpenVINO inference engine (src/inference/fast_model.cpp,
src/inference/vectorize.cpp) with a jitted JAX model.  Where the reference
pipelines 2048 concurrent CPU infer-requests of batch 100 at fixed shape
[123, 100], we run one large batch-major [B, 123] device batch.

Math (ONNX/OpenVINO GRU, gate order z,r,h, linear_before_reset=true — matching
PyTorch GRU semantics, models/finetuned_sgn33-new-a-Apr6.xml GRUSequence layers):

    z = sigmoid(x Wz^T + h Rz^T + bz)
    r = sigmoid(x Wr^T + h Rr^T + br)
    n = tanh(x Wh^T + Wbh + r * (h Rh^T + Rbh))
    h' = (1 - z) * n + z * h

with B = [bz(=Wbz+Rbz), br(=Wbr+Rbr), Wbh, Rbh] (shape 256 per direction).

Device mapping:
  * Each layer is one call of gru_pallas.gru_bi: on the GPU a Triton kernel
    that fuses the input projection, the recurrence and the gate math for
    both directions; on the CPU a hoisted [B*T, in] @ [in, 192] projection
    plus a lax.scan over 123 steps.
  * compute dtype bfloat16 or float32 (the default, for parity); params are
    kept fp32 and cast at entry.

Output parity target: the reference model's [B, 128] fp32 embeddings (final
fwd || final bwd hidden of layer 2).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from deepreadmapper_tpu.models import ir_loader

HIDDEN = 64
OUT_SIZE = 2 * HIDDEN
MAX_LEN = 123

# The encoder's XLA products run at full fp32 precision on every backend:
# the GPU's default is TF32 (about three decimal digits), which would make
# GPU embeddings differ from the CPU reference by more than summation
# order.  The GPU GRU kernel uses 3xTF32 instead (gru_pallas.KERNEL_PRECISION,
# fp32-level: 2.4e-6 max abs against this path at B=8192 on the H100).
MATMUL_PRECISION = "highest"


class GRULayerParams(NamedTuple):
    # Per direction d (0=fwd, 1=bwd):
    w: jax.Array  # [2, in, 192]   (transposed for x @ w)
    r: jax.Array  # [2, 64, 192]
    bzr: jax.Array  # [2, 192]     z,r summed biases + Wbh in one vector
    rbh: jax.Array  # [2, 64]      recurrent hidden bias (inside the r gate)


class EncoderParams(NamedTuple):
    embedding: jax.Array  # [7638, 64]
    layers: tuple[GRULayerParams, GRULayerParams]


def _layer_from_ir(w: np.ndarray, r: np.ndarray, b: np.ndarray) -> GRULayerParams:
    # IR layout: w [2, 192, in], r [2, 192, 64], b [2, 256].
    w = w.astype(np.float32)
    r = r.astype(np.float32)
    b = b.astype(np.float32)
    bzr = np.concatenate([b[:, :128], b[:, 128:192]], axis=1)  # [2,192]: bz,br,Wbh
    rbh = b[:, 192:256]
    return GRULayerParams(
        w=jnp.asarray(np.swapaxes(w, 1, 2)),
        r=jnp.asarray(np.swapaxes(r, 1, 2)),
        bzr=jnp.asarray(bzr),
        rbh=jnp.asarray(rbh),
    )


def load_params(npz_path: str = ir_loader.DEFAULT_NPZ) -> EncoderParams:
    z = ir_loader.load_npz_weights(npz_path)
    return EncoderParams(
        embedding=jnp.asarray(z["embedding"].astype(np.float32)),
        layers=(
            _layer_from_ir(z["gru1_W"], z["gru1_R"], z["gru1_B"]),
            _layer_from_ir(z["gru2_W"], z["gru2_R"], z["gru2_B"]),
        ),
    )


def encode_tokens_impl(params: EncoderParams, tokens: jax.Array, dtype: str = "float32") -> jax.Array:
    """Trace-safe body of encode_tokens (callers may jit it fused with more).

    Layout: the tokens (2 B/element) are transposed rather than any
    activation, so the embedding gather lands directly in time-major
    [T, B, 64] and no activation relayout happens.  Each layer runs both
    directions in one call (gru_pallas.gru_bi): the input projection is
    fused with the recurrence, the reverse direction walks time backwards
    by index, and layer 1 writes forward || backward straight into the
    [T, B, 128] input of layer 2.  XLA's products run at MATMUL_PRECISION.
    """
    from deepreadmapper_tpu.models.gru_pallas import gru_bi

    cdt = jnp.dtype(dtype)
    with jax.default_matmul_precision(MATMUL_PRECISION):
        emb = params.embedding.astype(cdt)
        # tokens travel host->device as uint16 (ids < 7638)
        x = emb[tokens.astype(jnp.int32).T]  # [T, B, 64] time-major

        def cast_layer(p: GRULayerParams) -> GRULayerParams:
            return GRULayerParams(*(a.astype(cdt) for a in p))

        p0 = cast_layer(params.layers[0])
        out1 = gru_bi(x, p0.w, p0.bzr, p0.r, p0.rbh, False)  # [T, B, 128]
        p1 = cast_layer(params.layers[1])
        out = gru_bi(out1, p1.w, p1.bzr, p1.r, p1.rbh, True)  # [B, 128]
    return out.astype(jnp.float32)


@functools.partial(jax.jit, static_argnames=("dtype",))
def encode_tokens(params: EncoderParams, tokens: jax.Array, dtype: str = "float32") -> jax.Array:
    """tokens: int32 [B, T] (zero-padded) -> embeddings fp32 [B, 128]."""
    return encode_tokens_impl(params, tokens, dtype)


@functools.partial(jax.jit, static_argnames=("dtype",))
def encode_packed(
    params: EncoderParams,
    wire: jax.Array,
    dtype: str = "float32",
) -> jax.Array:
    """2-bit packed bases (tokenizer_device single-buffer wire format,
    48 B/read on the host->device link vs 246 raw bytes) -> embeddings fp32
    [B, 128].  Tokenization happens on device and XLA fuses it into the
    embedding gather."""
    from deepreadmapper_tpu.tokenizer_device import tokens_from_packed

    tokens = tokens_from_packed(wire)
    return encode_tokens(params, tokens, dtype=dtype)


class Vectorizer:
    """String/bytes -> embeddings, the analog of the reference Vectorizer
    (src/inference/vectorize.cpp:34-141): tokenize on host, embed on device in
    large batches."""

    def __init__(
        self,
        params: EncoderParams | None = None,
        max_len: int = MAX_LEN,
        device_batch: int = 8192,
        dtype: str = "float32",
    ):
        self.params = params if params is not None else load_params()
        self.max_len = max_len
        self.device_batch = device_batch
        self.dtype = dtype

    def _dispatch_batches(self, rows: np.ndarray, encode_one, device_out: bool):
        """Shared batching engine: pad rows to fixed device batches, dispatch
        ALL batches before fetching any result (jax async dispatch overlaps
        host->HBM uploads with compute — the reference gets the same overlap
        from 2048 in-flight OpenVINO requests, fast_model.cpp:110-225).
        device_out=True keeps the result on device (consumers like the sparse
        rerank read it there, skipping a 512 B/seq host round-trip)."""
        n = rows.shape[0]
        bs = self.device_batch
        if n == 0:
            z = np.zeros((0, OUT_SIZE), dtype=np.float32)
            return jnp.asarray(z) if device_out else z
        pending = []
        for start in range(0, n, bs):
            chunk = rows[start : start + bs]
            if chunk.shape[0] < bs:
                chunk = np.pad(chunk, ((0, bs - chunk.shape[0]), (0, 0)))
            pending.append((start, encode_one(chunk)))
        if device_out:
            embs = [e for _, e in pending]
            out = jnp.concatenate(embs, axis=0) if len(embs) > 1 else embs[0]
            return out[:n]
        out = np.empty((n, OUT_SIZE), dtype=np.float32)
        for start, emb in pending:
            out[start : start + bs] = np.asarray(emb)[: min(bs, n - start)]
        return out

    def vectorize_tokens(self, tokens: np.ndarray, device_out: bool = False):
        """tokens int [N, T] -> fp32 [N, 128].  Tokens travel as uint16."""
        return self._dispatch_batches(
            tokens,
            lambda c: encode_tokens(
                self.params,
                jnp.asarray(np.ascontiguousarray(c.astype(np.uint16))),
                dtype=self.dtype,
            ),
            device_out,
        )

    def vectorize(self, seqs: list[str]) -> np.ndarray:
        from deepreadmapper_tpu import tokenizer as tok

        tokens = tok.tokenize_strings(seqs, self.max_len)
        return self.vectorize_tokens(tokens)

    def vectorize_wrapped_bytes(
        self, mat: np.ndarray, lengths: np.ndarray
    ) -> np.ndarray:
        """'<'-wrapped byte matrix -> embeddings via the 2-bit packed upload
        + on-device tokenizer (minimal host->device traffic)."""
        from deepreadmapper_tpu.tokenizer_device import pack_wrapped

        return self.vectorize_wire(pack_wrapped(mat, lengths))

    def vectorize_wire(self, wire: np.ndarray, device_out: bool = False):
        """Pre-packed 48-byte wire rows (tokenizer_device format) ->
        embeddings (tokenization happens on device)."""
        return self._dispatch_batches(
            wire,
            lambda w: encode_packed(self.params, jnp.asarray(w), dtype=self.dtype),
            device_out,
        )
