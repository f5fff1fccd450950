"""Test config: force JAX onto a virtual 8-device CPU mesh.

All tests run on CPU so they're hermetic and can exercise multi-card sharding
(shard_map over 8 virtual devices).  The platform is forced through
jax.config AFTER import but before any backend is initialized, so a GPU
present on the machine is not picked up.

Tests marked ``gpu`` need a CUDA card: they skip here (the ``gpu_device``
fixture decides at run time, never at import) and run on the card with
``python -m pytest tests -m gpu -p no:cacheprovider`` under
``JAX_PLATFORMS=cuda``.
"""

import os

PLATFORM = os.environ.get("JAX_PLATFORMS") or "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if PLATFORM == "cpu" and "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = PLATFORM

import jax  # noqa: E402

jax.config.update("jax_platforms", PLATFORM)

import pathlib  # noqa: E402

import pytest  # noqa: E402

DATA = pathlib.Path(__file__).parent / "data"


@pytest.fixture(scope="session")
def data_dir() -> pathlib.Path:
    return DATA


@pytest.fixture
def gpu_device():
    """The CUDA card for tests marked ``gpu``; skips when the run's JAX
    platform has none (decided here, at run time, never at import)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a CUDA card; this run's platform is "
                    f"{dev.platform!r}")
    return dev


@pytest.fixture(scope="session")
def ecoli_embeddings():
    """(ref_embeddings [1702,128], query_embeddings [150,128]) of the fixture
    genome windows and reads — the realistic distribution for recall tests.
    Computed once per session."""
    from deepreadmapper_tpu.io import fasta as fio, fastq
    from deepreadmapper_tpu.models.encoder import Vectorizer
    from deepreadmapper_tpu.pipeline.build import embed_fasta_windows

    vec = Vectorizer(device_batch=2048)
    recs = fio.parse_fasta_records(str(DATA / "ecoli_150.fna"))
    ref = embed_fasta_windows(recs, 150, 1, vec)
    seqs, _ = fastq.parse_fastq(str(DATA / "test_data.fastq"))
    q = vec.vectorize(seqs)
    return ref, q
