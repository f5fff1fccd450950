"""Encoder parity tests.

The shipped IR was exported from a PyTorch bi-GRU (ONNX GRU with
linear_before_reset=1 == PyTorch GRU semantics).  We rebuild the exact model in
torch.nn.GRU from the same IR weights (independent code path, gate order
remapped zrh -> rzn) and require the JAX encoder to match to fp32 tolerance.
"""

import numpy as np
import pytest

from deepreadmapper_tpu import tokenizer as tok
from deepreadmapper_tpu.models import encoder, ir_loader


def _torch_reference(tokens: np.ndarray) -> np.ndarray:
    torch = pytest.importorskip("torch")
    z = ir_loader.load_npz_weights()
    emb = torch.tensor(z["embedding"].astype(np.float32))
    gru = torch.nn.GRU(64, 64, num_layers=2, bidirectional=True, batch_first=False)

    def put(layer, w, r, b):
        w = torch.tensor(w.astype(np.float32))
        r = torch.tensor(r.astype(np.float32))
        b = torch.tensor(b.astype(np.float32))
        for d, suffix in enumerate(["", "_reverse"]):
            # zrh -> rzn reorder of 64-row blocks.
            perm = torch.cat([torch.arange(64, 128), torch.arange(0, 64), torch.arange(128, 192)])
            getattr(gru, f"weight_ih_l{layer}{suffix}").data = w[d][perm]
            getattr(gru, f"weight_hh_l{layer}{suffix}").data = r[d][perm]
            # B = [bz+, br+, Wbh, Rbh]; torch splits ih/hh biases: put the
            # summed z/r biases on ih, zero on hh, Wbh on ih_n, Rbh on hh_n.
            b_ih = torch.cat([b[d, 64:128], b[d, 0:64], b[d, 128:192]])
            b_hh = torch.cat([torch.zeros(128), b[d, 192:256]])
            getattr(gru, f"bias_ih_l{layer}{suffix}").data = b_ih
            getattr(gru, f"bias_hh_l{layer}{suffix}").data = b_hh

    put(0, z["gru1_W"], z["gru1_R"], z["gru1_B"])
    put(1, z["gru2_W"], z["gru2_R"], z["gru2_B"])

    with torch.no_grad():
        x = emb[torch.tensor(tokens.astype(np.int64))]  # [B, T, 64]
        x = x.transpose(0, 1)  # [T, B, 64]
        _, h_n = gru(x)
        out = torch.cat([h_n[2], h_n[3]], dim=-1)  # layer-2 fwd || bwd
    return out.numpy()


def test_encoder_matches_torch_on_fixture_reads(data_dir):
    from deepreadmapper_tpu.io import fastq

    seqs, _ = fastq.parse_fastq(str(data_dir / "test_data.fastq"))
    tokens = tok.tokenize_strings(seqs[:32])
    params = encoder.load_params()
    got = np.asarray(encoder.encode_tokens(params, tokens))
    want = _torch_reference(tokens)
    assert got.shape == (32, 128)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_encoder_random_tokens():
    rng = np.random.default_rng(1)
    tokens = rng.integers(7542, 7638, size=(8, 123)).astype(np.int32)
    # Sprinkle zero padding like short sequences produce.
    tokens[:, 100:] = 0
    params = encoder.load_params()
    got = np.asarray(encoder.encode_tokens(params, tokens))
    want = _torch_reference(tokens)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_vectorizer_batching_consistency(data_dir):
    from deepreadmapper_tpu.io import fastq

    seqs, _ = fastq.parse_fastq(str(data_dir / "test_data.fastq"))
    params = encoder.load_params()
    v_small = encoder.Vectorizer(params, device_batch=64)
    v_big = encoder.Vectorizer(params, device_batch=4096)
    a = v_small.vectorize(seqs)
    b = v_big.vectorize(seqs)
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    assert a.shape == (150, 128)


def test_bfloat16_close_to_fp32(data_dir):
    from deepreadmapper_tpu.io import fastq

    seqs, _ = fastq.parse_fastq(str(data_dir / "test_data.fastq"))
    tokens = tok.tokenize_strings(seqs[:16])
    params = encoder.load_params()
    f32 = np.asarray(encoder.encode_tokens(params, tokens, dtype="float32"))
    bf16 = np.asarray(encoder.encode_tokens(params, tokens, dtype="bfloat16"))
    # bf16 recurrence over 123 steps accumulates ~0.1 absolute error on the
    # unit-scale outputs; rankings survive (fp32 is the parity default).
    assert np.max(np.abs(f32 - bf16)) < 0.25
    # Rankings by L2 between reads should be essentially identical; check
    # nearest-neighbor structure is preserved for a simple case.
    d32 = ((f32[:1] - f32) ** 2).sum(-1)
    dbf = ((bf16[:1] - bf16) ** 2).sum(-1)
    assert np.argsort(d32)[:3].tolist() == np.argsort(dbf)[:3].tolist()


def test_bfloat16_mode_close_to_fp32():
    """bf16 compute mode (Vectorizer(dtype='bfloat16')) stays within
    quantization distance of fp32 — the documented fast inference mode."""
    import numpy as np

    from deepreadmapper_tpu.models.encoder import Vectorizer

    rng = np.random.default_rng(2)
    seqs = ["".join(rng.choice(list("acgt"), size=150)) for _ in range(16)]
    v32 = Vectorizer(device_batch=16)
    vb = Vectorizer(device_batch=16, dtype="bfloat16")
    e32 = v32.vectorize([f"<{s}>" for s in seqs])
    eb = vb.vectorize([f"<{s}>" for s in seqs])
    # bf16 inputs with fp32 gates and carry in both GRU implementations;
    # the bound is far below typical inter-window distances.
    assert np.abs(e32 - eb).max() < 0.3


def _gru_case(seed, t=9, b=6, din=64, dtype=None):
    import jax.numpy as jnp

    from deepreadmapper_tpu.models import gru_pallas as gp

    dtype = dtype or jnp.float32
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.standard_normal((t, b, din)) * 0.5, dtype)
    w = jnp.asarray(rng.standard_normal((2, din, gp.G)) * 0.2, dtype)
    bzr = jnp.asarray(rng.standard_normal((2, gp.G)) * 0.1, dtype)
    r_mat = jnp.asarray(rng.standard_normal((2, gp.H, gp.G)) * 0.2, dtype)
    rbh = jnp.asarray(rng.standard_normal((2, gp.H)) * 0.1, dtype)
    return x, w, bzr, r_mat, rbh


@pytest.mark.parametrize("last", [False, True])
def test_manual_gru_vjp_matches_autodiff(last):
    """The hand-written backward (gru_pallas._bwd_manual: parallel gate
    recompute + light cotangent scan + hoisted weight contractions) must
    reproduce jax.vjp of the differentiable scan reference, both directions
    at once, for both outputs (all states / final carries)."""
    import jax
    import jax.numpy as jnp

    from deepreadmapper_tpu.models import gru_pallas as gp

    args = _gru_case(0)
    ref_fn = lambda *a: gp._scan_bi(*a, last)  # noqa: E731
    out, vjp = jax.vjp(ref_fn, *args)
    rng = np.random.default_rng(1)
    ct = jnp.asarray(rng.standard_normal(out.shape), jnp.float32)
    ref_grads = vjp(ct)
    out2, vjp2 = jax.vjp(lambda *a: gp.gru_bi(*a, last), *args)
    got = vjp2(ct)
    np.testing.assert_allclose(
        np.asarray(out), np.asarray(out2), rtol=2e-6, atol=2e-6
    )
    for g_ref, g_man in zip(ref_grads, got):
        ref = np.asarray(g_ref)
        rel = np.max(np.abs(ref - np.asarray(g_man))) / (
            np.max(np.abs(ref)) + 1e-9
        )
        assert rel < 3e-6, (last, rel)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("last", [False, True])
@pytest.mark.parametrize("direction", ["fwd", "rev"])
def test_gru_kernel_interpret_matches_scan(direction, last, dtype):
    """The Triton GRU kernel (interpret mode) against the per-direction
    lax.scan reference: the forward half of its output is the forward
    recurrence, the backward half the time-reversed one."""
    import jax.numpy as jnp

    from deepreadmapper_tpu.models import gru_pallas as gp

    dt = jnp.dtype(dtype)
    x, w, bzr, r_mat, rbh = _gru_case(2, t=7, b=16, din=64, dtype=dt)
    d = 0 if direction == "fwd" else 1
    got = gp.gru_bi_kernel(x, w, bzr, r_mat, rbh, last, bt=16,
                           interpret=True)
    want = gp._scan_proj_impl(x, w[d], bzr[d], r_mat[d], rbh[d], d == 1, last)
    half = np.asarray(got[..., d * gp.H:(d + 1) * gp.H], np.float32)
    assert got.dtype == (jnp.float32 if last else dt)
    # fp32: identical op order; bf16: per-step outputs round to bf16
    tol = 1e-6 if dtype == "float32" or last else 8e-3
    np.testing.assert_allclose(half, np.asarray(want, np.float32),
                               rtol=0, atol=tol)


def test_gru_kernel_interpret_pads_batch():
    """A batch that is not a multiple of the block rows is padded inside
    the wrapper and sliced back; layer-2 width (din=128) on the way."""
    from deepreadmapper_tpu.models import gru_pallas as gp

    args = _gru_case(3, t=5, b=21, din=128)
    for last in (False, True):
        got = gp.gru_bi_kernel(*args, last, bt=16, interpret=True)
        want = gp._scan_bi(*args, last)
        assert got.shape == want.shape
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=0, atol=1e-6)


def test_gru_grad_through_encoder_matches_scan_grad():
    """jax.grad through gru_bi (custom_vjp) equals jax.grad of the plain
    scan for a scalar loss over a two-layer stack."""
    import jax
    import jax.numpy as jnp

    from deepreadmapper_tpu.models import gru_pallas as gp

    x, w, bzr, r_mat, rbh = _gru_case(4, t=6, b=5)
    w2 = w[:, :, :].repeat(2, axis=1)  # layer-2 input width 128

    def loss(fn, w1, w2_):
        h = fn(x, w1, bzr, r_mat, rbh, False)
        return jnp.sum(fn(h, w2_, bzr, r_mat, rbh, True) ** 2)

    g_ref = jax.grad(lambda a, b: loss(gp._scan_bi, a, b), (0, 1))(w, w2)
    g_man = jax.grad(lambda a, b: loss(gp.gru_bi, a, b), (0, 1))(w, w2)
    for a, b in zip(g_ref, g_man):
        a = np.asarray(a)
        rel = np.max(np.abs(a - np.asarray(b))) / (np.max(np.abs(a)) + 1e-9)
        assert rel < 3e-6, rel


@pytest.mark.parametrize(
    "platform,dtype,want",
    [("gpu", "float32", True), ("gpu", "bfloat16", True),
     ("gpu", "int32", False), ("cpu", "float32", False)],
)
def test_gru_kernel_selection(platform, dtype, want):
    import jax.numpy as jnp

    from deepreadmapper_tpu.models import gru_pallas as gp

    assert gp.kernel_applies(jnp.dtype(dtype), platform) is want
