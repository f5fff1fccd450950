"""Multi-chip sharding tests on the virtual 8-device CPU mesh."""

import numpy as np
import jax
import pytest

from deepreadmapper_tpu.ops.topk import l2_topk
from deepreadmapper_tpu.parallel.mesh import make_mesh
from deepreadmapper_tpu.parallel.sharded_search import sharded_l2_topk


def test_mesh_shapes():
    mesh = make_mesh(n_data=4, n_shard=2)
    assert mesh.shape == {"data": 4, "shard": 2}


def test_sharded_topk_matches_oracle():
    rng = np.random.default_rng(0)
    q = rng.standard_normal((16, 128)).astype(np.float32)
    r = rng.standard_normal((512, 128)).astype(np.float32)
    mesh = make_mesh(n_data=4, n_shard=2)
    d, i = sharded_l2_topk(q, r, k=10, mesh=mesh)
    d_ref, i_ref = l2_topk(q, r, 10)
    np.testing.assert_allclose(np.asarray(d), np.asarray(d_ref), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(np.asarray(i), np.asarray(i_ref))


def test_sharded_topk_4way():
    rng = np.random.default_rng(1)
    q = rng.standard_normal((8, 64)).astype(np.float32)
    r = rng.standard_normal((256, 64)).astype(np.float32)
    mesh = make_mesh(n_data=2, n_shard=4)
    d, i = sharded_l2_topk(q, r, k=16, mesh=mesh)
    d_ref, i_ref = l2_topk(q, r, 16)
    np.testing.assert_allclose(np.asarray(d), np.asarray(d_ref), rtol=1e-4, atol=1e-4)


def test_dryrun_multichip():
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)


def test_entry_compiles():
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    assert out.shape == (256, 128)
    assert np.all(np.isfinite(np.asarray(out)))


def test_make_fasta_embed_rows_row_algebra(tmp_path):
    """The distributed-build embed_rows callback must return exactly the
    global row slice of the full interleaved (fwd, rev) window stream —
    record-aware, including ranges that straddle records and strand pairs."""
    from deepreadmapper_tpu.io import fasta as fasta_io
    from deepreadmapper_tpu.models.encoder import Vectorizer
    from deepreadmapper_tpu.pipeline.build import (
        embed_fasta_windows,
        make_fasta_embed_rows,
    )

    rng = np.random.default_rng(3)
    bases = np.array(list("ACGT"))
    fa = tmp_path / "multi.fna"
    with open(fa, "w") as f:
        for ri, ln in enumerate((400, 310, 355)):
            f.write(f">rec{ri}\n")
            f.write("".join(bases[rng.integers(0, 4, ln)]) + "\n")
    vec = Vectorizer(device_batch=1024)
    records = fasta_io.parse_fasta_records(str(fa))
    full = embed_fasta_windows(records, 150, 4, vec)
    er = make_fasta_embed_rows(str(fa), 150, 4, vec)
    assert er.n_vectors == full.shape[0]
    for s, e in ((0, 7), (5, er.n_vectors - 3), (127, 130),
                 (er.n_vectors - 1, er.n_vectors)):
        np.testing.assert_allclose(
            er(s, e), full[s:e], rtol=1e-6, atol=1e-6,
            err_msg=f"rows [{s}, {e})",
        )


def test_build_index_distributed_single_process(tmp_path):
    """Single-process build_index_distributed produces the same on-disk
    layout as build_index(n_shards=...) — loadable through the registry
    with matching search results."""
    from deepreadmapper_tpu.index.registry import load_index
    from deepreadmapper_tpu.models.encoder import Vectorizer
    from deepreadmapper_tpu.pipeline.build import (
        build_index,
        build_index_distributed,
    )

    vec = Vectorizer(device_batch=2048)
    pa = str(tmp_path / "a")
    pb = str(tmp_path / "b")
    build_index("tests/data/ecoli_150.fna", pa, 150,
                index_type="INT8FLAT", n_shards=2, vectorizer=vec)
    build_index_distributed("tests/data/ecoli_150.fna", pb, 150,
                            index_type="INT8FLAT", n_shards=2,
                            vectorizer=vec)
    ea, ca = load_index(pa)
    eb, cb = load_index(pb)
    assert ca["n_vects"] == cb["n_vects"] == 1702
    from deepreadmapper_tpu.io.fastq import parse_fastq

    seqs, _ = parse_fastq("tests/data/test_data.fastq")
    emb = vec.vectorize(seqs[:32])
    ia, _ = ea.search(emb, 5)
    ib, _ = eb.search(emb, 5)
    np.testing.assert_array_equal(ia, ib)


@pytest.mark.parametrize("n", [3000, 4096])
def test_l2_topk_chunked_masks_padding(n):
    """The chunked exact top-k pads the reference to a chunk multiple and
    masks the padding by id: results equal numpy's exact top-k, and no
    padded id ever surfaces (a huge padding VALUE would square to inf and
    turn scores into NaN)."""
    from deepreadmapper_tpu.ops.topk import l2_topk

    rng = np.random.default_rng(3)
    r = rng.standard_normal((n, 16)).astype(np.float32)
    q = rng.standard_normal((5, 16)).astype(np.float32)
    d, i = l2_topk(q, r, 8, chunk=1024)
    d, i = np.asarray(d), np.asarray(i)
    want = ((q[:, None, :] - r[None]) ** 2).sum(-1)
    order = np.argsort(want, axis=1, kind="stable")[:, :8]
    assert (i < n).all() and np.isfinite(d).all()
    np.testing.assert_array_equal(i, order)
    np.testing.assert_allclose(d, np.take_along_axis(want, order, 1),
                               rtol=1e-4, atol=1e-4)
