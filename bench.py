"""Benchmark: ecoli_150 dense pipeline end-to-end queries/s on one GPU.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device",
...}, with the device as JAX reports it.  Exits non-zero without a GPU: a
CPU number is never reported under a device metric.

The measured path is the full per-query compute: FASTQ tokenization (host),
bi-GRU embedding, exact top-128 search against the 1,702-vector ecoli_150
index, dense post-process (passthrough).  Reads are tiled to a large batch for
a stable steady-state measurement; jit warmup is excluded.

vs_baseline: the reference publishes no numbers (BASELINE.md) and its
CPU stack (OpenVINO/FAISS) is not installable here, so vs_baseline is the
ratio against a fixed nominal of 1000 q/s — a generous estimate of the
reference's single-socket CPU throughput at this scale (2048 concurrent
batch-100 requests, 128 threads).
"""

import functools
import json
import sys
import time

import numpy as np

NOMINAL_BASELINE_QPS = 1000.0


def main() -> int:
    import jax
    import jax.numpy as jnp

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"bench needs a GPU; JAX found {devs[0].platform!r}",
              file=sys.stderr)
        return 1
    device = {"platform": devs[0].platform, "kind": devs[0].device_kind,
              "count": len(devs)}

    from deepreadmapper_tpu.io import fasta as fasta_io
    from deepreadmapper_tpu.io.fastq import parse_fastq_bytes
    from deepreadmapper_tpu.models.encoder import Vectorizer, encode_packed
    from deepreadmapper_tpu.ops.pack import (
        bits_needed,
        pack_ids_device,
        unpack_ids_host,
    )
    from deepreadmapper_tpu.ops.topk import l2_topk
    from deepreadmapper_tpu.pipeline.build import embed_fasta_windows
    from deepreadmapper_tpu.tokenizer_device import pack_wrapped
    from deepreadmapper_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    # --- build the index once (embed the 1,702 genome windows) ---
    records = fasta_io.parse_fasta_records("tests/data/ecoli_150.fna")
    vec = Vectorizer(device_batch=4096)
    ref_emb = embed_fasta_windows(records, 150, 1, vec)
    assert ref_emb.shape == (1702, 128)
    ref_dev = jax.device_put(ref_emb)

    # --- query stream: fixture reads tiled to a steady-state batch ---
    mat, lengths, _ = parse_fastq_bytes("tests/data/test_data.fastq")
    reps = 100  # 15,000 queries
    mat = np.tile(mat, (reps, 1))
    lengths = np.tile(lengths, reps)
    nq = mat.shape[0]
    k = 128
    nbits = bits_needed(ref_emb.shape[0])  # 12 bits/id for 1,702 vectors

    # The query stream moves as ONE packed upload (48 B/read: 2-bit bases +
    # N-mask + length, tokenized ON DEVICE) and ONE packed download (12-bit
    # ids); device tokenizer, bi-GRU, exact top-k and id pack are one jit.
    @functools.partial(jax.jit, donate_argnums=(1,))
    def fused(params, wire, ref):
        emb = encode_packed(params, wire)
        d, i = l2_topk(emb, ref, k)
        return pack_ids_device(i, nbits).reshape(-1)

    def run_once():
        wire = pack_wrapped(mat, lengths)
        out = fused(vec.params, jnp.asarray(wire), ref_dev)
        ids = unpack_ids_host(np.asarray(out).reshape(nq, -1), k, nbits)
        assert ids.shape == (nq, k)
        return nq

    run_once()  # warmup/compile
    # Record ALL trials; headline = best, median shows the spread.
    e2e_times = []
    for _ in range(5):
        t0 = time.perf_counter()
        run_once()
        e2e_times.append(time.perf_counter() - t0)
    qps = nq / min(e2e_times)
    qps_median = nq / float(np.median(e2e_times))

    # --- device-time metric: same fused compute, wire pre-uploaded
    fused_nodonate = jax.jit(
        lambda params, wire, ref: pack_ids_device(
            l2_topk(encode_packed(params, wire), ref, k)[1], nbits
        ).reshape(-1)
    )
    wire_host = pack_wrapped(mat, lengths)
    wire_dev = jax.device_put(jnp.asarray(wire_host))
    jax.block_until_ready(fused_nodonate(vec.params, wire_dev, ref_dev))
    dev_times = []
    for _ in range(5):
        t0 = time.perf_counter()
        out = jax.block_until_ready(
            fused_nodonate(vec.params, wire_dev, ref_dev)
        )
        dev_times.append(time.perf_counter() - t0)
    device_qps = nq / min(dev_times)
    device_qps_median = nq / float(np.median(dev_times))

    # --- per-stage split: upload / device compute / download
    t0 = time.perf_counter()
    jax.block_until_ready(jax.device_put(jnp.asarray(wire_host)))
    t_upload = time.perf_counter() - t0
    t_compute = float(np.median(dev_times))
    t0 = time.perf_counter()
    np.asarray(out)  # full result download (the e2e path unpacks this)
    t_fetch = time.perf_counter() - t0

    print(
        json.dumps(
            {
                "metric": "ecoli150_dense_e2e_qps",
                "value": qps,
                "unit": "queries/s",
                "vs_baseline": qps / NOMINAL_BASELINE_QPS,
                "device": device,
                "device_qps": device_qps,
                "qps_median": qps_median,
                "device_qps_median": device_qps_median,
                "e2e_trials_s": e2e_times,
                "device_trials_s": dev_times,
                "stage_s": {
                    "upload": t_upload,
                    "compute": t_compute,
                    "fetch": t_fetch,
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
