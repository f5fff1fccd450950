"""Windowed-min scan tests: the Triton kernel in interpret mode and the plain
XLA version, both bit-exact against numpy.

Both compute integer arithmetic in int32/fp32 (exact for int8 inputs,
|score| < 2^24), so the oracle comparison is exact equality.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from deepreadmapper_tpu.ops import scan_kernel as sk
from deepreadmapper_tpu.ops.platform import use_kernels

IMPLS = ["kernel", "xla"]


@pytest.fixture(scope="module")
def int8_case():
    rng = np.random.default_rng(0)
    np_, qp, d = 8 * sk.CT, sk.QT, 128
    r8 = rng.integers(-127, 128, (np_, d)).astype(np.int8)
    q8 = rng.integers(-127, 128, (qp, d)).astype(np.int8)
    return r8, q8


def _oracle_winmin(scores, w=sk.W):
    """scores [Q, N] -> per-window (min [Q, NW], global argmin [Q, NW])."""
    qp, np_ = scores.shape
    s3 = scores.reshape(qp, np_ // w, w)
    vals = s3.min(-1)
    args = s3.argmin(-1) + np.arange(np_ // w)[None, :] * w
    return vals, args


def _scores(q8, r8, ntotal):
    rn = (r8.astype(np.int64) ** 2).sum(1).astype(np.float32)
    rn[ntotal:] = np.float32(3.4e38)
    return rn[None, :] - 2.0 * (
        q8.astype(np.float32) @ r8.astype(np.float32).T
    )


def _winmin(impl, q8, r8, ntotal, w=sk.W):
    if impl == "kernel":
        return sk.winmin_kernel(jnp.asarray(q8), jnp.asarray(r8), ntotal, 2.0,
                                w=w, interpret=True)
    return sk.winmin_xla(jnp.asarray(q8), jnp.asarray(r8), ntotal, 2.0, w=w)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("w", [128, 512])
def test_int8_winmin_matches_oracle(int8_case, w, impl):
    r8, q8 = int8_case
    vals, args = _winmin(impl, q8, r8, r8.shape[0], w)
    ov, oa = _oracle_winmin(_scores(q8, r8, r8.shape[0]), w)
    np.testing.assert_array_equal(np.asarray(vals), ov)
    np.testing.assert_array_equal(np.asarray(args), oa)


@pytest.mark.parametrize("impl", IMPLS)
def test_pq_winmin_matches_oracle(int8_case, impl):
    """PQFLAT scans reconstructed int8 rows: the XLA gather reconstruction
    is exact and the windowed scan over it matches the numpy oracle."""
    _, q8 = int8_case
    rng = np.random.default_rng(1)
    np_, m, ksub, dsub = 2 * sk.CT, 8, 256, 16
    cent8 = rng.integers(-127, 128, (m, ksub, dsub)).astype(np.int8)
    codes = rng.integers(0, ksub, (np_, m)).astype(np.uint8)
    recon = np.concatenate(
        [cent8[j][codes[:, j]] for j in range(m)], axis=1
    )
    got = np.asarray(sk.reconstruct_pq(jnp.asarray(codes),
                                       jnp.asarray(cent8)))
    np.testing.assert_array_equal(got, recon)
    d, i = sk.fused_scan_topk(
        jnp.asarray(q8), jnp.asarray(codes), np_, 8, sk.CT, "pq",
        cent8=jnp.asarray(cent8), impl=impl, interpret=True,
    )
    wv, wa = _oracle_winmin(_scores(q8, recon, np_))
    order = np.argsort(wv, axis=1, kind="stable")[:, :8]
    np.testing.assert_array_equal(np.asarray(d),
                                  np.take_along_axis(wv, order, 1))
    np.testing.assert_array_equal(np.sort(np.asarray(i), 1),
                                  np.sort(np.take_along_axis(wa, order, 1), 1))


@pytest.mark.parametrize("impl", IMPLS)
def test_fused_topk_multichunk_merge(int8_case, impl):
    r8, q8 = int8_case
    k = 16
    d, i = sk.fused_scan_topk(
        jnp.asarray(q8), jnp.asarray(r8), r8.shape[0], k, 4 * sk.CT, "int8",
        impl=impl, interpret=True,
    )
    d, i = np.asarray(d), np.asarray(i)
    wv, wa = _oracle_winmin(_scores(q8, r8, r8.shape[0]))
    order = np.argsort(wv, axis=1, kind="stable")[:, :k]
    np.testing.assert_array_equal(d, np.take_along_axis(wv, order, 1))
    oi = np.take_along_axis(wa, order, 1)
    for r in range(d.shape[0]):
        assert set(i[r]) == set(oi[r])


@pytest.mark.parametrize("impl", IMPLS)
def test_ntotal_masks_padding_rows(int8_case, impl):
    r8, q8 = int8_case
    n_real = r8.shape[0] - sk.CT - 100  # the tail counts as padding
    d, i = sk.fused_scan_topk(
        jnp.asarray(q8), jnp.asarray(r8), n_real, 8, 2 * sk.CT, "int8",
        impl=impl, interpret=True,
    )
    assert np.all(np.asarray(i) < n_real)
    # and the kept scores equal the oracle restricted to real rows
    wv, _ = _oracle_winmin(_scores(q8, r8, n_real))
    order = np.argsort(wv, axis=1, kind="stable")[:, :8]
    np.testing.assert_array_equal(
        np.asarray(d), np.take_along_axis(wv, order, 1)
    )


def test_choose_chunk():
    base = sk._PAD_BASE
    assert sk.choose_chunk(8 * base) == 8 * base
    assert sk.choose_chunk(16 * base) == 8 * base
    assert sk.choose_chunk(9 * base) == 3 * base   # largest divisor <= 8
    assert sk.choose_chunk(41 * base) == base      # prime unit count
    assert sk.choose_chunk(12 * base) == 6 * base
    # the XLA version materializes [Q, chunk] scores: one unit per pass
    assert sk.choose_chunk(12 * base, "xla") == sk.XLA_CHUNK


@pytest.mark.parametrize("impl", IMPLS)
def test_fused_ratio_path_matches_mixed_scale_oracle(int8_case, impl):
    """ratio != 1 (clip-free query scale): the scan score
    r^2*qn + rn - 2r*dot must rank exactly like the mixed-scale oracle."""
    r8, q8 = int8_case
    n = r8.shape[0]
    qf = q8.astype(np.float32) * 3.0  # out-of-range queries
    sc = np.float32(1.0)
    sq = np.float32(np.abs(qf).max() / 127.0)
    ratio = np.float32(sq / sc)
    q8q = np.clip(np.round(qf / sq), -127, 127).astype(np.int8)
    d, i = sk.fused_scan_topk(
        jnp.asarray(q8q), jnp.asarray(r8), n, 8, n, "int8", ratio=ratio,
        impl=impl, interpret=True,
    )
    qq = q8q.astype(np.float32)
    rn = (r8.astype(np.int64) ** 2).sum(1).astype(np.float32)
    s = (ratio * ratio * (qq**2).sum(1)[:, None]
         + rn[None, :]
         - 2 * ratio * (qq @ r8.astype(np.float32).T))
    # the scan omits the constant qn term; compare AFTER adding it back
    d_full = np.asarray(d) + (ratio * ratio) * (qq**2).sum(1)[:, None]
    sw = s.reshape(s.shape[0], n // sk.W, sk.W).min(-1)
    order = np.argsort(sw, axis=1, kind="stable")[:, :8]
    np.testing.assert_allclose(
        d_full, np.take_along_axis(sw, order, 1), rtol=1e-5
    )
    # argmin row ids land in the winning windows
    oi = np.asarray(i) // sk.W
    np.testing.assert_array_equal(np.sort(oi, 1), np.sort(order, 1))


@pytest.mark.parametrize("platform,want", [("gpu", True), ("cpu", False)])
def test_use_kernels_by_platform(platform, want):
    assert use_kernels(platform) is want


def test_use_kernels_rejects_other_platforms():
    with pytest.raises(RuntimeError, match="no code path"):
        use_kernels("rocm")


@pytest.mark.parametrize(
    "platform,n,n_pad,k,want",
    [
        ("gpu", 1 << 20, 1 << 20, 128, True),
        ("gpu", (1 << 18) - 1, 1 << 18, 128, False),   # too few rows
        ("gpu", 1 << 20, (1 << 20) + 1024, 128, False),  # off the chunk grid
        ("gpu", 1 << 20, 1 << 20, 4096, False),        # k past the windows
        ("cpu", 1 << 20, 1 << 20, 128, False),         # plain path on CPU
    ],
)
def test_can_fuse_predicate(platform, n, n_pad, k, want):
    assert sk.can_fuse(n, n_pad, k, platform) is want


def test_pad_queries():
    assert sk.pad_queries(10, 8192) == sk.QT
    assert sk.pad_queries(sk.QT + 1, 8192) == 2 * sk.QT
    assert sk.pad_queries(9000, 8192) == 8192
