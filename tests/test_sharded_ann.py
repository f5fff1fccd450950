"""Mesh-sharded ANN index (parallel/sharded_ann.py) on the virtual 8-device
CPU mesh: recall parity with a single-shard index, global-id correctness,
PQ mode, and non-divisible padding."""

import numpy as np
import pytest

from deepreadmapper_tpu.config import BuildConfig
from deepreadmapper_tpu.index.flat import FlatIndex
from deepreadmapper_tpu.parallel.mesh import make_mesh
from deepreadmapper_tpu.parallel.sharded_ann import ShardedANNIndex


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(21)
    return rng.standard_normal((2048, 64)).astype(np.float32)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(n_data=2, n_shard=4)


def test_sharded_hnswflat_recall(data, mesh):
    x = data
    q = x[:64] + np.float32(0.05)
    ids_o, _ = FlatIndex(x).search(q, 10)
    idx = ShardedANNIndex.build(
        x, mesh, BuildConfig(m_hnsw=12), index_type="HNSWFLAT"
    )
    ids, d = idx.search(q, 10, ef=64)
    recall = np.mean([len(set(ids_o[i]) & set(ids[i])) / 10 for i in range(64)])
    assert recall >= 0.9, f"sharded recall {recall}"
    # distances are true squared L2 of the returned global ids
    dd = ((x[ids[0]] - q[0]) ** 2).sum(axis=1)
    np.testing.assert_allclose(d[0], dd, rtol=1e-3, atol=1e-3)
    # ids valid and globally unique per query
    assert ids.min() >= 0 and ids.max() < x.shape[0]
    for r in range(64):
        assert len(set(ids[r])) == 10


def test_sharded_pads_non_divisible(mesh):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1001, 32)).astype(np.float32)  # 1001 % 4 != 0
    q = x[:16] + np.float32(0.02)
    idx = ShardedANNIndex.build(
        x, mesh, BuildConfig(m_hnsw=8), index_type="HNSWFLAT"
    )
    assert idx.ntotal == 1001
    ids, d = idx.search(q, 8, ef=48)
    assert ids.max() < 1001, "padded rows leaked into results"
    ids_o, _ = FlatIndex(x).search(q, 8)
    recall = np.mean([len(set(ids_o[i]) & set(ids[i])) / 8 for i in range(16)])
    assert recall >= 0.85, recall


def test_sharded_hnswpq_smoke(data, mesh):
    x = data
    q = x[:32] + np.float32(0.05)
    idx = ShardedANNIndex.build(x, mesh, BuildConfig(), index_type="HNSWPQ")
    ids, d = idx.search(q, 10, ef=64)
    assert ids.shape == (32, 10)
    assert ids.min() >= 0 and ids.max() < x.shape[0]
    # ADC on random gaussians is coarse; gate vs the UNSHARDED HNSWPQ —
    # sharding must not lose recall (it usually gains: 4 codebooks).
    ids_o, _ = FlatIndex(x).search(q, 10)
    recall = np.mean([len(set(ids_o[i]) & set(ids[i])) / 10 for i in range(32)])
    from deepreadmapper_tpu.index.hnsw import HNSWPQIndex

    ref = HNSWPQIndex.build(x, BuildConfig())
    ids_r, _ = ref.search(q, 10, ef=64)
    recall_ref = np.mean(
        [len(set(ids_o[i]) & set(ids_r[i])) / 10 for i in range(32)]
    )
    assert recall >= recall_ref - 0.1, (recall, recall_ref)


def test_sharded_matches_per_shard_reference(data, mesh):
    """The shard_map search must equal searching each sub-index on one chip
    and merging on host."""
    x = data
    q = x[:16] + np.float32(0.03)
    idx = ShardedANNIndex.build(
        x, mesh, BuildConfig(m_hnsw=12, seed=7), index_type="HNSWFLAT"
    )
    ids, d = idx.search(q, 10, ef=48)
    # host-side reference merge
    n_local = idx.n_local
    all_d, all_i = [], []
    for si, sub in enumerate(idx.subs):
        i_s, d_s = sub.search(q, min(48, n_local), ef=48)
        all_i.append(np.where(i_s >= 0, i_s + si * n_local, -1))
        all_d.append(np.where(i_s >= 0, d_s, np.inf))
    cat_i = np.concatenate(all_i, axis=1)
    cat_d = np.concatenate(all_d, axis=1)
    order = np.argsort(cat_d, axis=1, kind="stable")[:, :10]
    want_i = np.take_along_axis(cat_i, order, axis=1)
    want_d = np.take_along_axis(cat_d, order, axis=1)
    np.testing.assert_allclose(np.sort(d, axis=1), np.sort(want_d, axis=1), rtol=1e-5)
    for r in range(16):
        assert set(ids[r]) == set(want_i[r])


def test_sharded_save_load_roundtrip(tmp_path, data, mesh):
    x = data[:1024]
    q = x[:16] + np.float32(0.04)
    idx = ShardedANNIndex.build(
        x, mesh, BuildConfig(m_hnsw=8), index_type="HNSWFLAT"
    )
    prefix = str(tmp_path / "sidx")
    idx.save(prefix)
    loaded = ShardedANNIndex.load(prefix, mesh)
    i1, d1 = idx.search(q, 8, ef=32)
    i2, d2 = loaded.search(q, 8, ef=32)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(d1, d2, rtol=1e-6)


def test_sharded_end_to_end_pipeline(tmp_path):
    """build-index --shards 4 -> registry auto-loads the sharded engine ->
    full pipeline produces npy/SAM on the fixture data."""
    import os

    from deepreadmapper_tpu.pipeline.build import build_index
    from deepreadmapper_tpu.pipeline.search import run_pipeline

    prefix = str(tmp_path / "shidx")
    outdir = str(tmp_path / "out")
    build_index(
        "tests/data/ecoli_150.fna", prefix, 150,
        index_type="HNSWFLAT", n_shards=4,
    )
    assert os.path.exists(os.path.join(prefix, "sharded.txt"))
    res = run_pipeline(prefix, "tests/data/test_data.fastq",
                       "tests/data/ecoli_150.fna", ef=96, k=16,
                       output_dir=outdir)
    ids = np.load(os.path.join(outdir, "indices.npy"))
    assert ids.shape == (150, 16)
    assert ids.max() < 1702
    # quality: top hit position near the wgsim-encoded truth for most reads
    from deepreadmapper_tpu.io.fastq import parse_fastq

    _, names = parse_fastq("tests/data/test_data.fastq")
    ok = sum(
        abs(int(ids[i][0] // 2) - int(names[i].split("_")[1])) <= 10
        for i in range(150)
    )
    assert ok >= 120, f"only {ok}/150 reads map near truth"


def test_sharded_flat_exact(data, mesh):
    """Sharded FLAT must EQUAL the single-device exact oracle."""
    x = data
    q = x[:32] + np.float32(0.05)
    idx = ShardedANNIndex.build(x, mesh, index_type="FLAT")
    ids, d = idx.search(q, 10)
    ids_o, d_o = FlatIndex(x).search(q, 10)
    np.testing.assert_array_equal(ids, ids_o)
    np.testing.assert_allclose(d, d_o, rtol=1e-4, atol=1e-4)


def test_sharded_pqflat_matches_per_shard(data, mesh):
    """Sharded PQFLAT == host merge of each shard's exhaustive ADC scan."""
    x = data[:1024]
    q = x[:16] + np.float32(0.03)
    idx = ShardedANNIndex.build(x, mesh, BuildConfig(), index_type="PQFLAT")
    ids, d = idx.search(q, 8)
    n_local = idx.n_local
    all_i, all_d = [], []
    for si, sub in enumerate(idx.subs):
        i_s, d_s = sub.search(q, 8)
        all_i.append(np.where(i_s >= 0, i_s + si * n_local, -1))
        all_d.append(d_s)
    cat_i = np.concatenate(all_i, axis=1)
    cat_d = np.concatenate(all_d, axis=1)
    order = np.argsort(cat_d, axis=1, kind="stable")[:, :8]
    want_d = np.take_along_axis(cat_d, order, axis=1)
    np.testing.assert_allclose(
        np.sort(d, axis=1), np.sort(want_d, axis=1), rtol=1e-4, atol=1e-4
    )
    # roundtrip
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        idx.save(tmp)
        loaded = ShardedANNIndex.load(tmp, mesh)
        i2, d2 = loaded.search(q, 8)
        np.testing.assert_array_equal(ids, i2)


def test_sharded_int8flat(data, mesh):
    """Sharded INT8FLAT: near-exact recall, roundtrip, global ids."""
    x = np.tanh(data).astype(np.float32)
    q = np.clip(x[:32] + np.float32(0.01), -1, 1)
    idx = ShardedANNIndex.build(x, mesh, index_type="INT8FLAT")
    ids, d = idx.search(q, 10)
    ids_o, _ = FlatIndex(x).search(q, 10)
    recall = np.mean([len(set(ids_o[i]) & set(ids[i])) / 10 for i in range(32)])
    assert recall >= 0.95, f"sharded int8 recall {recall}"
    assert ids.min() >= 0 and ids.max() < x.shape[0]
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        idx.save(tmp)
        loaded = ShardedANNIndex.load(tmp, mesh)
        i2, _d2 = loaded.search(q, 10)
        np.testing.assert_array_equal(ids, i2)


def test_sharded_query_super_batching(data, mesh, monkeypatch):
    """Search with more queries than one super-batch: results must equal the
    single-call path (batches share one compiled program; tails padded)."""
    from deepreadmapper_tpu.parallel import sharded_ann

    x = data[:512]
    idx = ShardedANNIndex.build(x, mesh, index_type="FLAT")
    q = x[:50] + np.float32(0.02)
    want_i, want_d = idx.search(q, 5)
    monkeypatch.setattr(sharded_ann, "_Q_SUPER_PER_DATA", 16)  # force 2 batches
    idx2 = ShardedANNIndex.build(x, mesh, index_type="FLAT")
    got_i, got_d = idx2.search(q, 5)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_d, want_d, rtol=1e-5)


def test_stream_quantized_sharded_int8_build(tmp_path):
    """build_index(INT8FLAT, n_shards=4) takes the stream-quantize branch
    (codes split across shards, no fp32 materialization); the saved index
    loads through the registry and maps the fixture reads."""
    import os

    from deepreadmapper_tpu.index.registry import load_index
    from deepreadmapper_tpu.pipeline.build import build_index

    prefix = str(tmp_path / "si8")
    build_index("tests/data/ecoli_150.fna", prefix, 150,
                index_type="INT8FLAT", n_shards=4)
    assert os.path.exists(os.path.join(prefix, "sharded.txt"))
    engine, cfg = load_index(prefix)
    assert engine.ntotal == 1702 and cfg["index_type"] == "INT8FLAT"
    from deepreadmapper_tpu.io.fastq import parse_fastq
    from deepreadmapper_tpu.models.encoder import Vectorizer

    seqs, names = parse_fastq("tests/data/test_data.fastq")
    emb = Vectorizer(device_batch=256).vectorize(seqs[:48])
    ids, d = engine.search(emb, 5)
    ok = sum(abs(int(ids[i][0] // 2) - int(names[i].split("_")[1])) <= 10
             for i in range(48))
    assert ok >= 42, f"{ok}/48"


def test_compose_global_ids_beyond_int32():
    """The merge carries (local, shard) int32 pairs; host composition must
    produce correct int64 ids past 2^31 (one-index human genome: 6.2e9
    windows over 8 shards)."""
    from deepreadmapper_tpu.parallel.sharded_ann import compose_global_ids

    n_local = 800_000_000  # 0.8e9 rows/shard, fits int32
    local = np.array([[0, 123, n_local - 1, -1]], dtype=np.int32)
    shard = np.array([[7, 3, 7, 2]], dtype=np.int32)
    gid = compose_global_ids(local, shard, n_local)
    assert gid.dtype == np.int64
    assert gid[0, 0] == 7 * 800_000_000
    assert gid[0, 1] == 3 * 800_000_000 + 123
    assert gid[0, 2] == 8 * 800_000_000 - 1  # 6.4e9 > 2^31
    assert gid[0, 3] == -1


def test_sharded_boundary_shard_masking():
    """ntotal not divisible by n_shard: the pad rows (repeat of the last
    real row) in the boundary shard must never be returned even though
    they score identically to the real last row."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1003, 32)).astype(np.float32)
    mesh = make_mesh(n_shard=4)
    idx = ShardedANNIndex.build(x, mesh, index_type="FLAT")
    ids, d = idx.search(x[-1:], 1003)
    valid = ids[ids >= 0]
    assert valid.max() < 1003
    assert len(set(valid.tolist())) == len(valid)
    # the duplicated last row appears exactly once
    assert (valid == 1002).sum() == 1


def test_sharded_ivfint8_matches_per_shard(data, mesh):
    """Sharded IVFINT8 == host merge of each shard's own engine search at
    the same nprobe: probe, plan inversion, slab scan and distance algebra
    must be the single-chip engine's, just laid out over the mesh."""
    x = np.tanh(data).astype(np.float32)
    q = np.clip(x[:16] + np.float32(0.01), -1, 1)
    idx = ShardedANNIndex.build(x, mesh, BuildConfig(), index_type="IVFINT8")
    # equal-nprobe parity holds when nprobe <= every shard's cluster count
    nprobe = min(s.centroids.shape[0] for s in idx.subs)
    ids, d = idx.search(q, 8, ef=nprobe)
    n_local = idx.n_local
    all_i, all_d = [], []
    for si, sub in enumerate(idx.subs):
        i_s, d_s = sub.search(q, 8, ef=nprobe)
        all_i.append(np.where(i_s >= 0, i_s + si * n_local, -1))
        all_d.append(np.where(i_s >= 0, d_s, np.inf))
    cat_i = np.concatenate(all_i, axis=1)
    cat_d = np.concatenate(all_d, axis=1)
    order = np.argsort(cat_d, axis=1, kind="stable")[:, :8]
    want_d = np.take_along_axis(cat_d, order, axis=1)
    want_i = np.take_along_axis(cat_i, order, axis=1)
    np.testing.assert_allclose(
        np.sort(d, axis=1), np.sort(want_d, axis=1), rtol=1e-4, atol=1e-5
    )
    for r in range(16):
        assert set(ids[r]) == set(want_i[r]), f"row {r}"


def test_sharded_ivfint8_recall_and_roundtrip(data, mesh):
    """Full-probe sharded IVF is an exhaustive int8 scan: near-exact recall
    vs the fp32 oracle; save/load through the manifest reproduces results;
    ids are global and valid."""
    x = np.tanh(data).astype(np.float32)
    q = np.clip(x[:32] + np.float32(0.01), -1, 1)
    idx = ShardedANNIndex.build(x, mesh, BuildConfig(), index_type="IVFINT8")
    # max over shards + per-shard clipping = truly exhaustive on EVERY shard
    nprobe = max(s.centroids.shape[0] for s in idx.subs)
    ids, d = idx.search(q, 10, ef=nprobe)
    ids_o, _ = FlatIndex(x).search(q, 10)
    recall = np.mean(
        [len(set(ids_o[i]) & set(ids[i])) / 10 for i in range(32)]
    )
    assert recall >= 0.9, f"sharded ivf full-probe recall {recall}"
    assert ids.min() >= 0 and ids.max() < x.shape[0]
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        idx.save(tmp)
        loaded = ShardedANNIndex.load(tmp, mesh)
        i2, _d2 = loaded.search(q, 10, ef=nprobe)
        np.testing.assert_array_equal(ids, i2)


def test_stream_quantized_sharded_ivf_build(tmp_path):
    """build_index(IVFINT8, n_shards=4) takes the stream-quantize branch
    (per-shard coarse quantizers from split codes); the saved index loads
    through the registry and maps the fixture reads."""
    import os

    from deepreadmapper_tpu.index.registry import load_index
    from deepreadmapper_tpu.pipeline.build import build_index

    prefix = str(tmp_path / "sivf")
    build_index("tests/data/ecoli_150.fna", prefix, 150,
                index_type="IVFINT8", n_shards=4)
    assert os.path.exists(os.path.join(prefix, "sharded.txt"))
    engine, cfg = load_index(prefix)
    assert engine.ntotal == 1702 and cfg["index_type"] == "IVFINT8"
    from deepreadmapper_tpu.io.fastq import parse_fastq
    from deepreadmapper_tpu.models.encoder import Vectorizer

    seqs, names = parse_fastq("tests/data/test_data.fastq")
    emb = Vectorizer(device_batch=256).vectorize(seqs[:48])
    ids, d = engine.search(emb, 5, ef=8)
    ok = sum(abs(int(ids[i][0] // 2) - int(names[i].split("_")[1])) <= 10
             for i in range(48))
    assert ok >= 40, f"{ok}/48"


def test_sharded_pqflat_with_opq():
    """Per-shard OPQ rotations flow through the sharded scan: results match
    the single-index engine on the same data (both deterministic)."""
    from deepreadmapper_tpu.config import BuildConfig
    from deepreadmapper_tpu.index.pq_flat import PQFlatIndex

    rng = np.random.default_rng(11)
    mix = rng.standard_normal((64, 64)).astype(np.float32)
    x = rng.standard_normal((2000, 64)).astype(np.float32) @ mix
    x /= np.abs(x).max()
    q = x[:32] + 0.001
    cfg = BuildConfig(opq=True, opq_iters=3, kmeans_iters=5)
    mesh = make_mesh(n_shard=2)
    idx = ShardedANNIndex.build(x, mesh, cfg, index_type="PQFLAT")
    assert all(s.rot is not None for s in idx.subs)
    ids, d = idx.search(q, 8)
    # oracle: per-shard single-engine searches merged by distance
    subs = [PQFlatIndex.build(p, cfg) for p in np.split(x, 2)]
    cand = []
    for si, sub in enumerate(subs):
        i_s, d_s = sub.search(q, 8)
        cand.append((i_s + si * 1000, d_s))
    all_i = np.concatenate([c[0] for c in cand], axis=1)
    all_d = np.concatenate([c[1] for c in cand], axis=1)
    order = np.argsort(all_d, axis=1, kind="stable")[:, :8]
    want_i = np.take_along_axis(all_i, order, axis=1)
    for r in range(len(q)):
        assert set(ids[r]) == set(want_i[r]), f"row {r}"


def test_load_distributed_single_process_fallback(tmp_path, data, mesh):
    """load_distributed with one process == plain load (all shards local,
    single-controller device arrays), so the same entry point serves both
    deployments."""
    from deepreadmapper_tpu.parallel.sharded_ann import ShardedANNIndex

    x = np.tanh(data[:1024]).astype(np.float32)
    q = np.clip(x[:16] + np.float32(0.01), -1, 1)
    idx = ShardedANNIndex.build(x, mesh, index_type="INT8FLAT")
    prefix = str(tmp_path / "dsi")
    idx.save(prefix)
    got = ShardedANNIndex.load_distributed(prefix)
    assert not got._local_only and len(got.subs) == 4
    got_i, got_d = got.search(q, 8)
    # oracle on the SAME mesh (the int8 query scale is computed per data
    # block, so distances differ in the last ulps across mesh shapes)
    from deepreadmapper_tpu.parallel.mesh import make_distributed_mesh

    oracle = ShardedANNIndex.load(prefix, make_distributed_mesh(4))
    want_i, want_d = oracle.search(q, 8)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_d, want_d, rtol=1e-6)


def test_sharded_ivfpq_matches_per_shard(data, mesh):
    """Sharded IVFPQ == host merge of each shard's own engine search at the
    same nprobe (probe, plan inversion, PQ slab scan and distance algebra
    are the single-chip engine's, laid out over the mesh)."""
    x = np.tanh(data).astype(np.float32)
    q = np.clip(x[:16] + np.float32(0.01), -1, 1)
    idx = ShardedANNIndex.build(x, mesh, BuildConfig(), index_type="IVFPQ")
    nprobe = min(s.centroids.shape[0] for s in idx.subs)
    ids, d = idx.search(q, 8, ef=nprobe)
    n_local = idx.n_local
    all_i, all_d = [], []
    for si, sub in enumerate(idx.subs):
        i_s, d_s = sub.search(q, 8, ef=nprobe)
        all_i.append(np.where(i_s >= 0, i_s + si * n_local, -1))
        all_d.append(np.where(i_s >= 0, d_s, np.inf))
    cat_i = np.concatenate(all_i, axis=1)
    cat_d = np.concatenate(all_d, axis=1)
    order = np.argsort(cat_d, axis=1, kind="stable")[:, :8]
    want_d = np.take_along_axis(cat_d, order, axis=1)
    want_i = np.take_along_axis(cat_i, order, axis=1)
    np.testing.assert_allclose(
        np.sort(d, axis=1), np.sort(want_d, axis=1), rtol=1e-4, atol=1e-4
    )
    for r in range(16):
        assert set(ids[r]) == set(want_i[r]), f"row {r}"


def test_sharded_ivfpq_opq_recall_and_roundtrip(data, mesh):
    """Full-probe sharded IVFPQ (with per-shard OPQ rotations) is an
    exhaustive ADC scan: high recall vs the fp32 oracle; save/load through
    the manifest reproduces results; ids are global and valid."""
    x = np.tanh(data).astype(np.float32)
    q = np.clip(x[:32] + np.float32(0.01), -1, 1)
    idx = ShardedANNIndex.build(
        x, mesh, BuildConfig(opq=True, opq_iters=2), index_type="IVFPQ"
    )
    assert all(s.rot is not None for s in idx.subs)
    nprobe = max(s.centroids.shape[0] for s in idx.subs)
    ids, d = idx.search(q, 10, ef=nprobe)
    ids_o, _ = FlatIndex(x).search(q, 10)
    recall = np.mean(
        [len(set(ids_o[i]) & set(ids[i])) / 10 for i in range(32)]
    )
    # iid gaussian is PQ8's worst case (no subspace structure to exploit;
    # neighbors spread uniformly): recall@10 vs the fp32 oracle measured
    # ~0.57 here — the quantizer's floor, not the engine's (full-probe
    # IVFPQ == exhaustive ADC, tests/test_ivf_pq.py proves set equality)
    assert recall >= 0.45, f"sharded ivfpq full-probe recall {recall}"
    # PQ8 quantization blurs the tail; top-1 self-hits must survive it
    top1 = np.mean(ids[:, 0] == np.arange(32))
    assert top1 >= 0.9, top1
    assert ids.min() >= 0 and ids.max() < x.shape[0]
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        idx.save(tmp)
        loaded = ShardedANNIndex.load(tmp, mesh)
        i2, _d2 = loaded.search(q, 10, ef=nprobe)
        np.testing.assert_array_equal(ids, i2)


def test_stream_encoded_sharded_ivfpq_build(tmp_path):
    """build_index(IVFPQ, n_shards=4) takes the two-pass PQ stream-encode
    branch (shared codebook, per-shard coarse quantizers); the saved index
    loads through the registry and maps the fixture reads."""
    import os

    from deepreadmapper_tpu.index.registry import load_index
    from deepreadmapper_tpu.pipeline.build import build_index

    prefix = str(tmp_path / "sivfpq")
    build_index("tests/data/ecoli_150.fna", prefix, 150,
                index_type="IVFPQ", n_shards=4)
    assert os.path.exists(os.path.join(prefix, "sharded.txt"))
    engine, cfg = load_index(prefix)
    assert engine.ntotal == 1702 and cfg["index_type"] == "IVFPQ"
    from deepreadmapper_tpu.io.fastq import parse_fastq
    from deepreadmapper_tpu.models.encoder import Vectorizer

    seqs, names = parse_fastq("tests/data/test_data.fastq")
    emb = Vectorizer(device_batch=256).vectorize(seqs[:48])
    ids, d = engine.search(emb, 5, ef=8)
    ok = sum(abs(int(ids[i][0] // 2) - int(names[i].split("_")[1])) <= 10
             for i in range(48))
    assert ok >= 40, f"{ok}/48"


@pytest.mark.parametrize("itype", ["IVFINT8", "IVFPQ"])
def test_sharded_ivf_matches_per_shard_engines(data, mesh, itype):
    """The probed-slab scan under shard_map: both IVF kinds must reproduce
    the per-shard single-chip engines through the sharded plan + two-int32
    merge."""
    x = np.tanh(data).astype(np.float32)
    q = np.clip(x[:16] + np.float32(0.01), -1, 1)
    idx = ShardedANNIndex.build(x, mesh, BuildConfig(), index_type=itype)
    nprobe = min(s.centroids.shape[0] for s in idx.subs)
    ids, d = idx.search(q, 8, ef=nprobe)
    n_local = idx.n_local
    all_i, all_d = [], []
    for si, sub in enumerate(idx.subs):
        i_s, d_s = sub.search(q, 8, ef=nprobe)
        all_i.append(np.where(i_s >= 0, i_s + si * n_local, -1))
        all_d.append(np.where(i_s >= 0, d_s, np.inf))
    cat_d = np.concatenate(all_d, axis=1)
    cat_i = np.concatenate(all_i, axis=1)
    order = np.argsort(cat_d, axis=1, kind="stable")[:, :8]
    want_d = np.take_along_axis(cat_d, order, axis=1)
    np.testing.assert_allclose(
        np.sort(d, axis=1), np.sort(want_d, axis=1),
        rtol=1e-4, atol=1e-4, err_msg=itype,
    )
    want_i = np.take_along_axis(cat_i, order, axis=1)
    overlap = np.mean([
        len(set(ids[r]) & set(want_i[r])) / 8 for r in range(len(q))
    ])
    assert overlap >= 0.9, f"{itype}: {overlap}"
