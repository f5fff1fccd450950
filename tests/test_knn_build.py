"""kNN-graph builder (index/knn_build.py): the GANN-equivalent
(reference src/gann_hnsw/gann_hnsw.cpp) built as matmuls.

Gates: exact-kNN correctness vs numpy, heuristic-prune equivalence with the
insertion builder's scalar heuristic, and search recall parity with the
incremental builder through the same batched beam search."""

import numpy as np
import pytest

from deepreadmapper_tpu.config import BuildConfig
from deepreadmapper_tpu.index.flat import FlatIndex
from deepreadmapper_tpu.index.hnsw import HNSWFlatIndex, HNSWPQIndex
from deepreadmapper_tpu.index.hnsw_build import _select_neighbors_heuristic
from deepreadmapper_tpu.index.knn_build import (
    build_hnsw_knn,
    exact_knn,
    prune_neighbors,
)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    return rng.standard_normal((2000, 64)).astype(np.float32)


def test_exact_knn_matches_numpy(data):
    x = data[:300]
    d, i = exact_knn(x, 10)
    # numpy oracle
    full = ((x[:, None, :] - x[None, :, :]) ** 2).sum(axis=2)
    np.fill_diagonal(full, np.inf)
    oi = np.argsort(full, axis=1, kind="stable")[:, :10]
    od = np.take_along_axis(full, oi, axis=1)
    np.testing.assert_allclose(d, od.astype(np.float32), rtol=1e-4, atol=1e-3)
    # ids can differ on exact ties only
    agree = (i == oi).mean()
    assert agree > 0.999


def test_exact_knn_small_n_pads():
    x = np.random.default_rng(0).standard_normal((5, 8)).astype(np.float32)
    d, i = exact_knn(x, 10)
    assert i.shape == (5, 10)
    assert (i[:, 4:] == -1).all()
    assert (i[:, :4] >= 0).all()


def test_prune_matches_scalar_heuristic(data):
    x = data[:400]
    d, i = exact_knn(x, 24)
    pruned = prune_neighbors(x, i, d, 8)
    for row in [0, 17, 133, 399]:
        cand = list(zip(d[row].tolist(), i[row].tolist()))
        want = _select_neighbors_heuristic(x, row, cand, 8)
        got = pruned[row][pruned[row] >= 0].tolist()
        assert got == want, f"row {row}: {got} != {want}"


def test_knn_graph_structure(data):
    g = build_hnsw_knn(data[:500], m=8)
    assert g.neighbors0.shape == (500, 16)
    counts = (g.neighbors0 >= 0).sum(axis=1)
    assert counts.min() >= 1, "isolated node in level-0 graph"
    assert g.entry_gid >= 0
    assert g.m == 8
    # no self-loops, ids in range
    for r in range(500):
        nb = g.neighbors0[r][g.neighbors0[r] >= 0]
        assert r not in nb
        assert (nb < 500).all()
    # deterministic
    g2 = build_hnsw_knn(data[:500], m=8)
    np.testing.assert_array_equal(g.neighbors0, g2.neighbors0)


def test_knn_build_recall_matches_insert(data):
    x = data
    q = x[:100] + np.float32(0.05)
    oracle = FlatIndex(x)
    ids_o, _ = oracle.search(q, 10)

    idx = HNSWFlatIndex.build(x, BuildConfig(m_hnsw=16, build_mode="knn"))
    ids_h, d_h = idx.search(q, 10, ef=64)
    recall = np.mean([len(set(ids_o[i]) & set(ids_h[i])) / 10 for i in range(100)])
    assert recall >= 0.95, f"knn-build recall {recall}"
    # distances are true squared L2 of the returned ids
    dd = ((x[ids_h[0]] - q[0]) ** 2).sum(axis=1)
    np.testing.assert_allclose(d_h[0], dd, rtol=1e-3, atol=1e-3)


def test_knn_build_pq_roundtrip(tmp_path, data):
    idx = HNSWPQIndex.build(data[:800], BuildConfig(build_mode="knn"))
    prefix = str(tmp_path / "kidx")
    import os

    os.makedirs(prefix, exist_ok=True)
    idx.save(prefix)
    loaded = HNSWPQIndex.load(prefix)
    q = data[:20] + np.float32(0.05)
    i1, d1 = idx.search(q, 8, ef=64)
    i2, d2 = loaded.search(q, 8, ef=64)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(d1, d2, rtol=1e-5)
