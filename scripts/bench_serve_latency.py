"""Per-request serving latency at genome scale: exhaustive scan vs IVF.

Batched throughput hides IVF's real win: an exhaustive scan reads/multiplies
all N rows PER REQUEST no matter how small the batch, while the IVF scan
covers ~nprobe/nlist of the index.  This measures wall-clock per request
(including the result fetch — what a serve-daemon client sees) for request
sizes a mapper daemon actually gets.

Reuses the bench_crossover --keep-dir artifacts:

    python scripts/bench_serve_latency.py --keep-dir chiprun_out/ivf40m \
        --batches 128 512 2048
"""

import argparse
import json
import os
import time

import numpy as np
import jax  # noqa: F401


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--keep-dir", default="chiprun_out/ivf40m")
    ap.add_argument("--batches", type=int, nargs="+", default=[128, 512, 2048])
    ap.add_argument("--nprobe", type=int, default=32)
    ap.add_argument("--k", type=int, default=128)
    ap.add_argument("--nlist", type=int, default=0,
                    help="which cached ivf_nlist<N> dir to load")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from deepreadmapper_tpu.index.int8_flat import Int8FlatIndex
    from deepreadmapper_tpu.index.ivf_int8 import IVFInt8Index
    from deepreadmapper_tpu.index.registry import load_index
    from deepreadmapper_tpu.io.fastq import parse_fastq_bytes
    from deepreadmapper_tpu.models.encoder import Vectorizer

    flat, _cfg = load_index(os.path.join(args.keep_dir, "idx"))
    assert isinstance(flat, Int8FlatIndex)
    ivf_dir = os.path.join(args.keep_dir, f"ivf_nlist{args.nlist}")
    ivf = IVFInt8Index.load(ivf_dir)
    print(json.dumps({
        "n_rows": flat.ntotal, "nlist": ivf.nlist, "cap": ivf.cap,
    }), flush=True)

    vec = Vectorizer()
    mat, lengths, _ = parse_fastq_bytes(
        os.path.join(args.keep_dir, "reads.fastq")
    )
    emb_all = np.asarray(vec.vectorize_wrapped_bytes(mat, lengths))

    # engines outer, batches inner: both resident would be ~12 GB at 40M
    # rows — drop one before the other uploads
    def measure(name, search):
        for b in args.batches:
            q = emb_all[:b]
            search(q)  # warm/compile this batch signature
            t0 = time.time()
            for _ in range(args.iters):
                search(q)
            dt = (time.time() - t0) / args.iters
            print(json.dumps({
                "engine": name, "batch": b, "nprobe": args.nprobe,
                "ms_per_request": round(dt * 1e3, 1),
                "qps": round(b / dt, 0),
            }), flush=True)

    measure("INT8FLAT", lambda q: flat.search(q, args.k))
    del flat
    measure("IVFINT8", lambda q: ivf.search(q, args.k, ef=args.nprobe,
                                            approx_probe=True))
    print("DONE", flush=True)


if __name__ == "__main__":
    main()
