"""Crash-resumable streaming builds (build-index --resume).

The reference's resumability (format_fasta_batch's resume_pos state,
parse_inputs.cpp:371-482) lives inside one process; here the embed stream
checkpoints to disk so a killed genome-scale build continues where it died
instead of re-embedding (genome-scale builds run for minutes to hours)."""

import json
import os

import numpy as np
import pytest

from deepreadmapper_tpu.index.int8_flat import quantize
from deepreadmapper_tpu.io import fasta as fasta_io
from deepreadmapper_tpu.models.encoder import Vectorizer
from deepreadmapper_tpu.pipeline.build import (
    build_index,
    stream_codes_resumable,
)

SCALE = 1.0 / 127.0


@pytest.fixture(scope="module")
def vec():
    return Vectorizer(device_batch=2048)


@pytest.fixture(scope="module")
def record(data_dir):
    return fasta_io.parse_fasta_records(str(data_dir / "ecoli_150.fna"))[0]


def _q(e):
    return quantize(e, SCALE)


def test_interrupted_stream_resumes_without_reembedding(
    record, vec, tmp_path
):
    cache = str(tmp_path / "codes.npy")
    calls = {"n": 0}

    def dying_q(e):
        if calls["n"] == 2:
            raise RuntimeError("simulated crash")
        calls["n"] += 1
        return quantize(e, SCALE)

    with pytest.raises(RuntimeError):
        stream_codes_resumable(
            [record], 150, 1, vec, dying_q, cache, 128, "|i1",
            window_chunk=64,
        )
    assert os.path.exists(cache)

    # a crash mid-write can also leave a *partial* row — simulate it
    with open(cache, "ab") as f:
        f.write(b"\x01" * 37)

    calls2 = {"n": 0}

    def counting_q(e):
        calls2["n"] += 1
        return quantize(e, SCALE)

    got = stream_codes_resumable(
        [record], 150, 1, vec, counting_q, cache, 128, "|i1",
        window_chunk=64,
    )
    n_chunks = -(-851 // 64)
    assert calls2["n"] == n_chunks - 2  # first two chunks were skipped

    ref = stream_codes_resumable(
        [record], 150, 1, vec, _q, str(tmp_path / "ref.npy"), 128, "|i1",
        window_chunk=64,
    )
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def test_build_index_resume_matches_plain_build(data_dir, vec, tmp_path):
    fna = str(data_dir / "ecoli_150.fna")
    p_plain = str(tmp_path / "plain")
    p_res = str(tmp_path / "res")
    build_index(fna, p_plain, 150, index_type="INT8FLAT", vectorizer=vec)
    build_index(
        fna, p_res, 150, index_type="INT8FLAT", vectorizer=vec, resume=True
    )
    a = np.load(os.path.join(p_plain, "int8.npz"))
    b = np.load(os.path.join(p_res, "int8.npz"))
    np.testing.assert_array_equal(a["codes"], b["codes"])
    assert not os.path.exists(os.path.join(p_res, ".build_cache"))


def test_resume_refuses_changed_params(data_dir, vec, tmp_path):
    fna = str(data_dir / "ecoli_150.fna")
    prefix = str(tmp_path / "idx")
    cache = os.path.join(prefix, ".build_cache")
    os.makedirs(cache)
    with open(os.path.join(cache, "state.json"), "w") as f:
        json.dump({"stride": 999}, f)
    with pytest.raises(ValueError, match="does not match"):
        build_index(
            fna, prefix, 150, index_type="INT8FLAT", vectorizer=vec,
            resume=True,
        )


def test_resume_pq_reuses_codebook(data_dir, vec, tmp_path):
    """PQ pass A (codebook training) checkpoints too: an interrupted pass B
    rerun must reuse the trained codebook and produce the same index as an
    uninterrupted build."""
    import deepreadmapper_tpu.pipeline.build as build_mod

    fna = str(data_dir / "ecoli_150.fna")
    p_plain = str(tmp_path / "plain")
    p_res = str(tmp_path / "res")
    build_index(fna, p_plain, 150, index_type="PQFLAT", vectorizer=vec)

    real_stream = build_mod.stream_codes_resumable
    state = {"first": True}

    def dying_stream(*a, **kw):
        if state["first"]:
            state["first"] = False
            raise RuntimeError("simulated crash after codebook training")
        return real_stream(*a, **kw)

    build_mod.stream_codes_resumable = dying_stream
    try:
        with pytest.raises(RuntimeError):
            build_index(
                fna, p_res, 150, index_type="PQFLAT", vectorizer=vec,
                resume=True,
            )
        assert os.path.exists(
            os.path.join(p_res, ".build_cache", "codebook.npz")
        )
        build_index(
            fna, p_res, 150, index_type="PQFLAT", vectorizer=vec,
            resume=True,
        )
    finally:
        build_mod.stream_codes_resumable = real_stream
    a = np.load(os.path.join(p_plain, "pq.npz"))
    b = np.load(os.path.join(p_res, "pq.npz"))
    np.testing.assert_array_equal(a["codes"], b["codes"])
    np.testing.assert_allclose(a["centroids"], b["centroids"], rtol=1e-6)
    assert not os.path.exists(os.path.join(p_res, ".build_cache"))
