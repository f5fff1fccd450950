"""INT8FLAT engine: near-exact recall via an int8 scan (index/int8_flat.py)."""

import numpy as np
import pytest

from deepreadmapper_tpu.index.flat import FlatIndex
from deepreadmapper_tpu.index.int8_flat import Int8FlatIndex


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(33)
    # tanh-bounded like real encoder outputs
    return np.tanh(rng.standard_normal((4000, 128))).astype(np.float32)


def test_recall_near_exact(data):
    x = data
    q = np.clip(x[:64] + np.float32(0.01), -1, 1)
    ids_o, d_o = FlatIndex(x).search(q, 10)
    idx = Int8FlatIndex.build(x)
    ids, d = idx.search(q, 10)
    recall = np.mean([len(set(ids_o[i]) & set(ids[i])) / 10 for i in range(64)])
    assert recall >= 0.97, f"int8 recall {recall}"
    # distances approximate true squared L2 closely
    np.testing.assert_allclose(d[:, 0], d_o[:, 0], atol=5e-3)


def test_gaussian_data_recall():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2000, 64)).astype(np.float32)  # unbounded
    q = x[:32] + np.float32(0.05)
    ids_o, _ = FlatIndex(x).search(q, 10)
    idx = Int8FlatIndex.build(x)
    ids, _ = idx.search(q, 10)
    recall = np.mean([len(set(ids_o[i]) & set(ids[i])) / 10 for i in range(32)])
    assert recall >= 0.9, recall


def test_roundtrip_and_padding(tmp_path, data):
    x = data[:777]  # forces chunk padding paths
    idx = Int8FlatIndex.build(x)
    q = x[:8]
    i1, d1 = idx.search(q, 200)  # k > ... still < n
    assert i1.shape == (8, 200)
    assert (i1 < 777).all() and (i1 >= 0).all()
    assert i1[0][0] == 0  # self-match first
    prefix = str(tmp_path / "i8")
    idx.save(prefix)
    loaded = Int8FlatIndex.load(prefix)
    i2, d2 = loaded.search(q, 200)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(d1, d2)
    # k > n pads with -1/inf
    small = Int8FlatIndex.build(x[:5])
    i3, d3 = small.search(q, 8)
    assert (i3[:, 5:] == -1).all() and np.isinf(d3[:, 5:]).all()


def test_pipeline_end_to_end(tmp_path):
    from deepreadmapper_tpu.pipeline.build import build_index
    from deepreadmapper_tpu.pipeline.search import run_pipeline

    prefix = str(tmp_path / "idx8")
    out = str(tmp_path / "out")
    build_index("tests/data/ecoli_150.fna", prefix, 150, index_type="INT8FLAT")
    run_pipeline(prefix, "tests/data/test_data.fastq",
                 "tests/data/ecoli_150.fna", ef=128, k=16, output_dir=out)
    ids = np.load(f"{out}/indices.npy")
    from deepreadmapper_tpu.io.fastq import parse_fastq

    _, names = parse_fastq("tests/data/test_data.fastq")
    ok = sum(abs(int(ids[i][0] // 2) - int(names[i].split("_")[1])) <= 10
             for i in range(150))
    assert ok >= 135, f"{ok}/150"
