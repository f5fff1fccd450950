"""IVFINT8 engine: cluster-pruned int8 scan (index/ivf_int8.py).

The sub-linear tier replacing the pruning role of the reference's HNSW
(src/hnswpq/search.cpp:6-57).  Correctness invariants under test:
achieved recall must equal probe coverage (the scan over probed clusters is
exact), every row lives in exactly one slab slot, and the id/distance
conventions match Int8FlatIndex.
"""

import numpy as np
import pytest

from deepreadmapper_tpu.config import BuildConfig
from deepreadmapper_tpu.index.int8_flat import Int8FlatIndex
from deepreadmapper_tpu.index.ivf_int8 import IVFInt8Index, auto_nlist


@pytest.fixture(scope="module")
def clustered():
    """Clustered data (what genome-window embeddings look like): recall is
    meaningful here, unlike iid gaussian where neighbors spread uniformly."""
    rng = np.random.default_rng(7)
    centers = np.tanh(rng.standard_normal((64, 128))).astype(np.float32)
    assign = rng.integers(0, 64, 8000)
    x = centers[assign] + 0.05 * rng.standard_normal((8000, 128)).astype(
        np.float32
    )
    return np.clip(x, -1, 1)


def test_layout_invariants(clustered):
    idx = IVFInt8Index.build(clustered)
    ids = idx.row_ids[idx.row_ids >= 0]
    # every row in exactly one slot
    assert len(ids) == idx.ntotal
    assert len(np.unique(ids)) == idx.ntotal
    # per-cluster occupancy never exceeds cap
    slots = np.nonzero(idx.row_ids >= 0)[0]
    counts = np.bincount(slots // idx.cap, minlength=idx.nlist)
    assert counts.max() <= idx.cap


def test_full_probe_matches_int8flat(clustered):
    """nprobe == nlist scans everything -> must match the exhaustive int8
    engine's candidate set (same quantized metric)."""
    x = clustered
    q = x[:48] + np.float32(0.01)
    idx = IVFInt8Index.build(x)
    oracle = Int8FlatIndex.build(x)
    oi, od = oracle.search(q, 10)
    ii, dd = idx.search(q, 10, ef=idx.nlist)
    recall = np.mean(
        [len(set(oi[i]) & set(ii[i])) / 10 for i in range(len(q))]
    )
    assert recall >= 0.99, recall
    # distances share Int8FlatIndex's squared-L2 convention
    np.testing.assert_allclose(dd[:, 0], od[:, 0], rtol=1e-5, atol=1e-5)


def test_pruned_recall_on_clustered(clustered):
    x = clustered
    q = x[:128] + np.float32(0.01)
    idx = IVFInt8Index.build(x)
    oracle = Int8FlatIndex.build(x)
    oi, _ = oracle.search(q, 10)
    nprobe = max(4, idx.nlist // 8)
    ii, _ = idx.search(q, 10, ef=nprobe)
    recall = np.mean(
        [len(set(oi[i]) & set(ii[i])) / 10 for i in range(len(q))]
    )
    assert recall >= 0.9, f"recall {recall} at nprobe={nprobe}/{idx.nlist}"


def test_save_load_roundtrip(tmp_path, clustered):
    idx = IVFInt8Index.build(clustered[:2000])
    q = clustered[:16]
    i1, d1 = idx.search(q, 5, ef=8)
    idx.save(str(tmp_path))
    idx2 = IVFInt8Index.load(str(tmp_path))
    i2, d2 = idx2.search(q, 5, ef=8)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(d1, d2)


def test_edge_cases(clustered):
    x = clustered[:300]
    idx = IVFInt8Index.build(x, BuildConfig(nlist=8))
    assert idx.nlist >= 8  # oversized clusters split, growing the list
    # k > ntotal pads with -1 / inf
    ii, dd = idx.search(x[:4], 400, ef=8)
    assert ii.shape == (4, 400)
    assert (ii[:, 350:] == -1).all()
    assert np.isinf(dd[:, 350:]).all()
    # empty query batch
    ii, dd = idx.search(np.zeros((0, 128), np.float32), 5)
    assert ii.shape == (0, 5)
    # ef beyond nlist clamps
    ii, dd = idx.search(x[:4], 5, ef=10_000)
    assert (ii[:, 0] >= 0).all()


def test_build_from_codes_matches_build(clustered):
    """The streaming path (int8 codes in, fp32 never materialized) builds
    the same index as build() given the same quantization scale."""
    x = clustered[:2000]
    idx_a = IVFInt8Index.build(x)
    from deepreadmapper_tpu.index.int8_flat import quantize_host

    codes = quantize_host(x, idx_a.scale)
    idx_b = IVFInt8Index.build_from_codes(codes, idx_a.scale)
    q = x[:16] + np.float32(0.01)
    ia, da = idx_a.search(q, 5, ef=idx_a.nlist)
    ib, db = idx_b.search(q, 5, ef=idx_b.nlist)
    np.testing.assert_array_equal(ia, ib)


def test_e2e_pipeline_ecoli(tmp_path, data_dir):
    """Full FASTA -> IVFINT8 build -> FASTQ -> SAM pipeline on the ecoli
    fixture; top-1 must match the exact FLAT engine (ample nprobe)."""
    from deepreadmapper_tpu.models.encoder import Vectorizer
    from deepreadmapper_tpu.pipeline.build import build_index
    from deepreadmapper_tpu.pipeline.search import run_pipeline

    vec = Vectorizer(device_batch=2048)
    prefix = str(tmp_path / "idx")
    cfg = build_index(
        str(data_dir / "ecoli_150.fna"), prefix, ref_len=150, stride=1,
        index_type="IVFINT8", vectorizer=vec,
    )
    assert cfg["n_vects"] == 1702
    out = str(tmp_path / "out")
    run_pipeline(
        prefix, str(data_dir / "test_data.fastq"),
        str(data_dir / "ecoli_150.fna"), ef=128, k=16, output_dir=out,
        vectorizer=vec,
    )
    ids = np.load(tmp_path / "out" / "indices.npy")
    assert ids.shape == (150, 16)

    fprefix = str(tmp_path / "fidx")
    build_index(
        str(data_dir / "ecoli_150.fna"), fprefix, ref_len=150, stride=1,
        index_type="FLAT", vectorizer=vec,
    )
    fout = str(tmp_path / "fout")
    run_pipeline(
        fprefix, str(data_dir / "test_data.fastq"),
        str(data_dir / "ecoli_150.fna"), ef=128, k=16, output_dir=fout,
        vectorizer=vec,
    )
    fids = np.load(tmp_path / "fout" / "indices.npy")
    agree = np.mean(ids[:, 0] == fids[:, 0])
    assert agree >= 0.95, agree


def test_auto_nlist():
    assert auto_nlist(0) == 16
    assert auto_nlist(1000) >= 16
    assert auto_nlist(100_000_000) == 8192
    # power of two
    for n in (5000, 123_456, 2_000_000):
        v = auto_nlist(n)
        assert v & (v - 1) == 0


def test_approx_probe_matches_exact_probe(clustered):
    """approx_probe swaps the probe's full-sort top_k for approx_max_k —
    the probed cluster sets must agree at >=0.99 recall, so the final
    candidates barely move."""
    x = clustered
    q = x[:64] + np.float32(0.01)
    idx = IVFInt8Index.build(x)
    nprobe = max(4, idx.nlist // 4)
    ie, _ = idx.search(q, 10, ef=nprobe)
    ia, _ = idx.search(q, 10, ef=nprobe, approx_probe=True)
    overlap = np.mean(
        [len(set(ie[i]) & set(ia[i])) / 10 for i in range(len(q))]
    )
    assert overlap >= 0.95, f"approx-probe overlap {overlap}"


@pytest.mark.parametrize("engine", ["IVFINT8", "IVFPQ"])
def test_full_probe_large_cap_matches_oracle(clustered, engine):
    """cap > 128 (few, large slabs): a full probe scans every slab, so the
    probed-slab scan must reproduce the exhaustive scan over the same
    codes — the int8 engine for IVFINT8, the exact PQ scan for IVFPQ."""
    from deepreadmapper_tpu.index.ivf_pq import IVFPQIndex
    from deepreadmapper_tpu.index.pq_flat import PQFlatIndex

    x = clustered
    q = x[:48] + np.float32(0.01)
    if engine == "IVFINT8":
        idx = IVFInt8Index.build(x, BuildConfig(nlist=16))
        oi, od = Int8FlatIndex.build(x).search(q, 10, exact=True)
    else:
        idx = IVFPQIndex.build(x, BuildConfig(nlist=16))
        codes = np.zeros((idx.ntotal, idx.codes_cm.shape[1]), np.uint8)
        filled = idx.row_ids >= 0
        codes[idx.row_ids[filled]] = idx.codes_cm[filled]
        oi, od = PQFlatIndex(codes, idx.codebook, idx.ntotal,
                             rot=idx.rot).search(q, 10, exact=True)
    assert idx.cap > 128
    ii, dd = idx.search(q, 10, ef=idx.nlist)
    recall = np.mean(
        [len(set(oi[i]) & set(ii[i])) / 10 for i in range(len(q))]
    )
    assert recall >= 0.99, recall
    np.testing.assert_allclose(dd[:, 0], od[:, 0], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("engine", ["IVFINT8", "IVFPQ"])
def test_exact_flag_agrees_at_full_probe(clustered, engine):
    """search(exact=True) keeps the probe an exact top_k; at a full probe
    the probed set is everything either way, so results are identical."""
    from deepreadmapper_tpu.index.ivf_pq import IVFPQIndex

    cls = IVFInt8Index if engine == "IVFINT8" else IVFPQIndex
    x = clustered[:3000]
    q = x[:16] + np.float32(0.01)
    idx = cls.build(x)
    ia, da = idx.search(q, 10, ef=idx.nlist)
    ie, de = idx.search(q, 10, ef=idx.nlist, exact=True)
    np.testing.assert_array_equal(ia, ie)
    np.testing.assert_allclose(da, de, rtol=0, atol=0)


def test_search_stats_counters(clustered):
    """search_stats: a full probe covers every row; a pruned probe covers
    a strict subset, and the counters are per query."""
    x = clustered
    q = x[:32] + np.float32(0.01)
    idx = IVFInt8Index.build(x)
    full, part = {}, {}
    idx.search(q, 5, ef=idx.nlist, stats=full)
    idx.search(q, 5, ef=4, stats=part)
    assert full["queries"] == part["queries"] == 32
    assert full["coverage"] == pytest.approx(1.0)
    assert 0 < part["coverage"] < 1.0
    assert part["probed_rows_per_query"] < full["probed_rows_per_query"]
    assert full["centroid_evals_per_query"] == idx.nlist
