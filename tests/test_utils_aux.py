"""Auxiliary subsystems: tracing, memory estimators, id_map, streaming npy,
inference CLI streaming path."""

import numpy as np

from deepreadmapper_tpu.io.idmap import load_id_map, save_id_map
from deepreadmapper_tpu.io.npy_stream import NpyStreamWriter
from deepreadmapper_tpu.utils.memory import (
    estimate_index_memory,
    estimate_window_count,
)
from deepreadmapper_tpu.utils.trace import Tracer


def test_tracer_spans_and_counters():
    t = Tracer()
    with t.span("embed"):
        with t.span("tokenize"):
            pass
    t.count("dist_evals", 42)
    s = t.summary()
    assert "embed" in s and "tokenize" in s and "dist_evals" in s


def test_memory_estimator_matches_reference_formula():
    est = estimate_index_memory(1702, 128, 8, 8, 16, n_train=851)
    # PQ codebooks: 8 * 256 * 16 * 4 bytes.
    assert est["pq_codebooks"] == 8 * 256 * 16 * 4
    assert est["pq_codes"] == 1702 * 8
    assert est["hnsw_graph"] == int(1702 * 16 * 1.5) * 4
    assert "training_peak" in est


def test_window_count_estimate(data_dir):
    est = estimate_window_count(str(data_dir / "ecoli_150.fna"), 150, 1)
    # Estimator is file-size based (reference semantics): right order of
    # magnitude vs the true 1702.
    assert 1000 < est < 2200


def test_id_map_roundtrip(tmp_path):
    labels = np.array([0, 1, 4, 5, 2**40], dtype=np.uint64)
    p = save_id_map(labels, str(tmp_path))
    got = load_id_map(p)
    np.testing.assert_array_equal(got, labels)


def test_npy_stream_writer(tmp_path):
    path = str(tmp_path / "s.npy")
    with NpyStreamWriter(path, 7, 3) as w:
        w.append(np.ones((4, 3), np.float32))
        w.append(np.arange(9, dtype=np.float32).reshape(3, 3))
    arr = np.load(path)
    assert arr.shape == (7, 3)
    np.testing.assert_array_equal(arr[:4], 1.0)
    np.testing.assert_array_equal(arr[4:], np.arange(9).reshape(3, 3))


def test_cli_plan_and_info(capsys, tmp_path):
    """`plan` sizes a human genome without touching JAX; `info` reads an
    index dir without loading an engine."""
    from deepreadmapper_tpu import cli

    assert cli.main(["plan", "3.1e9", "150"]) == 0
    out = capsys.readouterr().out
    assert "INT8FLAT" in out and "--shards" in out
    assert cli.main(["info", str(tmp_path / "nope")]) == 1


def test_npy_stream_writer_int_dtype(tmp_path):
    # rows must be cast to the DECLARED header dtype, not hardcoded f4
    path = str(tmp_path / "i.npy")
    with NpyStreamWriter(path, 3, 2, dtype="<i8") as w:
        w.append(np.arange(6).reshape(3, 2))
    arr = np.load(path)
    assert arr.dtype == np.int64
    np.testing.assert_array_equal(arr, np.arange(6).reshape(3, 2))


def test_npy_stream_writer_enforces_shape(tmp_path):
    import pytest

    path = str(tmp_path / "s.npy")
    w = NpyStreamWriter(path, 2, 3)
    with pytest.raises(ValueError):
        w.append(np.ones((1, 4), np.float32))
    w.append(np.ones((2, 3), np.float32))
    w.close()


def test_inference_cli_streams_fasta(tmp_path, data_dir):
    from deepreadmapper_tpu import cli

    out = str(tmp_path / "emb.npy")
    rc = cli.main(["inference", str(data_dir / "ecoli_150.fna"), "150", out])
    assert rc == 0
    arr = np.load(out)
    assert arr.shape == (1702, 128)
    # Spot-check against the non-streamed path.
    from deepreadmapper_tpu.models.encoder import Vectorizer
    from deepreadmapper_tpu.pipeline.build import embed_input_file

    want = embed_input_file(str(data_dir / "ecoli_150.fna"), 150, 1, Vectorizer(device_batch=2048))
    np.testing.assert_allclose(arr, want, rtol=1e-5, atol=1e-6)


def test_progress_renders_and_closes(capsys):
    """utils/progress.Progress: the reference's progressbar.h affordance —
    renders count/percent/rate, terminates the line on close, and stays
    completely silent when disabled."""
    from deepreadmapper_tpu.utils.progress import Progress

    p = Progress(100, "embed", enabled=True, min_interval=0.0)
    p.update(40)
    p.update(60)
    p.close()
    err = capsys.readouterr().err
    assert "100/100" in err and "100%" in err and err.endswith("\n")

    p2 = Progress(10, enabled=False)
    p2.update(10)
    p2.close()
    assert capsys.readouterr().err == ""

    with Progress(0, "empty", enabled=True, min_interval=0.0) as p3:
        p3.update(0)  # zero-total inputs must not divide by zero


def test_inference_cli_streams_reads(tmp_path, data_dir):
    """FASTQ/txt read files honor the [batch_size] positional: streamed in
    chunks through the pre-headered npy writer, matching the one-shot
    embedding path (reference test_inference.cpp:49 batch semantics)."""
    from deepreadmapper_tpu import cli
    from deepreadmapper_tpu.models.encoder import Vectorizer
    from deepreadmapper_tpu.pipeline.build import embed_input_file

    out = str(tmp_path / "emb.npy")
    rc = cli.main(
        ["inference", str(data_dir / "test_data.fastq"), "150", out, "64"]
    )
    assert rc == 0
    arr = np.load(out)
    assert arr.shape == (150, 128)
    want = embed_input_file(
        str(data_dir / "test_data.fastq"), 150, 1, Vectorizer()
    )
    np.testing.assert_allclose(arr, want, rtol=1e-5, atol=1e-6)

    # txt input (one sequence per line) through the same streamed path;
    # txt sequences tokenize as-is (no explicit '<seq>' wrap — that's the
    # FASTQ parser's doing), so the oracle is vectorize() on the same lines
    txt = tmp_path / "reads.txt"
    with open(data_dir / "test_data.fastq") as f:
        seqs = [l.strip() for i, l in enumerate(f) if i % 4 == 1][:10]
    txt.write_text("\n".join(seqs) + "\n")
    out2 = str(tmp_path / "emb2.npy")
    rc = cli.main(["inference", str(txt), "150", out2, "4"])
    assert rc == 0
    want2 = Vectorizer().vectorize(seqs)
    np.testing.assert_allclose(np.load(out2), want2, rtol=1e-5, atol=1e-6)


def test_compile_cache_dir_rules(monkeypatch):
    """JAX_COMPILATION_CACHE_DIR wins and nothing else is set; otherwise the
    GPU caches at the fixed <repo>/.jax_cache; the CPU keeps no cache."""
    import jax

    from deepreadmapper_tpu.utils import compile_cache as cc

    before = jax.config.jax_compilation_cache_dir
    try:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere")
        assert cc.enable_compile_cache("gpu") == "/elsewhere"
        assert jax.config.jax_compilation_cache_dir == before
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
        assert cc.enable_compile_cache("cpu") is None
        assert jax.config.jax_compilation_cache_dir == before
        assert cc.enable_compile_cache("gpu") == str(cc.REPO_CACHE)
        assert jax.config.jax_compilation_cache_dir == str(cc.REPO_CACHE)
        assert cc.REPO_CACHE.name == ".jax_cache"
        assert (cc.REPO_CACHE.parent / "chip_smoke.py").exists()
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
