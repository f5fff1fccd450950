"""IVFPQ at the >100M-row tier: one card, 8 B/row codes + 4 B/row norms.

INT8FLAT needs 12.8 GB of codes at 100M rows and the exhaustive scans go
linear.  IVFPQ holds 100M rows in ~1.5 GB and prunes to ~nprobe/nlist of
the matmul work via the probed-slab scan.  This script builds a 50 Mbp
genome (~100M windows, both strands), streams the two-pass PQ build, and
reports q/s + planted-truth top-1 over an nprobe ladder.

    python scripts/bench_ivfpq_scale.py [--n-bp 50000000] [--opq] \
        --keep-dir chiprun_out/ivfpq100m
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import jax  # noqa: F401  (backend selection must precede engine imports)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-bp", type=int, default=50_000_000)
    ap.add_argument("--n-queries", type=int, default=8192)
    ap.add_argument("--err", type=float, default=0.01)
    ap.add_argument("--nlist", type=int, default=0)
    ap.add_argument("--nprobe", type=int, nargs="+", default=[16, 32, 64])
    ap.add_argument("--opq", action="store_true")
    ap.add_argument("--weights", default="",
                    help="fine-tuned encoder npz (noise/shift-matched); "
                         "used for windows AND queries, recorded in the index")
    ap.add_argument("--m-pq", type=int, default=8,
                    help="PQ subquantizers (16 = 16 B/row, the 0.99-class rung)")
    ap.add_argument("--dense-rerank", action="store_true",
                    help="after the ladder, run the full pipeline with "
                         "--dense-rerank for the accuracy recipe number")
    ap.add_argument("--k", type=int, default=128)
    ap.add_argument("--keep-dir", default="chiprun_out/ivfpq_scale")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    sys.path.insert(0, os.path.join(os.getcwd(), "scripts"))
    from demo_genome_scale import make_genome, simulate_reads

    from deepreadmapper_tpu.config import BuildConfig
    from deepreadmapper_tpu.index.registry import load_index
    from deepreadmapper_tpu.io.fastq import parse_fastq_bytes
    from deepreadmapper_tpu.models.encoder import Vectorizer
    from deepreadmapper_tpu.pipeline.build import build_index

    os.makedirs(args.keep_dir, exist_ok=True)
    genome = make_genome(args.n_bp)
    reads, _names, starts, strands = simulate_reads(
        genome, args.n_queries, 150, err=args.err
    )
    ref = os.path.join(args.keep_dir, "ref.fna")
    fq = os.path.join(args.keep_dir, "reads.fastq")
    if not os.path.exists(ref):
        with open(ref, "w") as f:
            f.write("> synthetic\n")
            for i in range(0, args.n_bp, 80):
                f.write(genome[i:i + 80] + "\n")
    if not os.path.exists(fq):
        with open(fq, "w") as f:
            for i, r in enumerate(reads):
                f.write(f"@r{i}\n{r}\n+\n{'I' * 150}\n")

    if args.weights:
        from deepreadmapper_tpu.models.encoder import load_params

        vec = Vectorizer(load_params(args.weights))
    else:
        vec = Vectorizer()
    tag = (("_opq" if args.opq else "") + (f"_m{args.m_pq}" if args.m_pq != 8 else "")
           + ("_tuned" if args.weights else ""))
    prefix = os.path.join(args.keep_dir, "idx" + tag)
    t0 = time.time()
    if not os.path.exists(os.path.join(prefix, "config.txt")):
        cfg = BuildConfig(nlist=args.nlist, opq=args.opq, m_pq=args.m_pq)
        build_index(ref, prefix, 150, index_type="IVFPQ", build_cfg=cfg,
                    vectorizer=vec, resume=True,
                    weights=args.weights or None)
        print(json.dumps({"t_build_s": round(time.time() - t0, 0)}),
              flush=True)
    engine, _cfg = load_index(prefix)
    print(json.dumps({
        "n_rows": engine.ntotal, "nlist": engine.nlist, "cap": engine.cap,
        "n_slabs": engine.n_slabs,
        "codes_gb": round(engine.codes_cm.nbytes / 1e9, 2),
        "device_gb": round(
            ((engine.n_slabs + 1) * engine.cap
             * (engine.codes_cm.shape[1] + 4)) / 1e9, 2),
    }), flush=True)

    mat, lengths, _ = parse_fastq_bytes(fq)
    emb = np.asarray(vec.vectorize_wrapped_bytes(mat, lengths))
    for nprobe in args.nprobe:
        ids, _d = engine.search(emb, args.k, ef=nprobe, approx_probe=True)
        t0 = time.time()
        ids, _d = engine.search(emb, args.k, ef=nprobe, approx_probe=True)
        dt = time.time() - t0
        pos = (ids[:, 0] // 2).astype(np.int64)
        top1 = float(np.mean(
            (np.abs(pos - starts) <= 2) & (ids[:, 0] % 2 == strands)
        ))
        print(json.dumps({
            "engine": "IVFPQ" + ("+OPQ" if args.opq else ""),
            "nprobe": nprobe,
            "qps": round(args.n_queries / dt, 0),
            "truth_top1": round(top1, 4),
        }), flush=True)
    if args.dense_rerank:
        from deepreadmapper_tpu.pipeline.search import run_pipeline

        out = os.path.join(args.keep_dir, "out" + tag)
        res = run_pipeline(prefix, fq, ref, k=args.k, ef=32,
                           output_dir=out, dense_rerank=True,
                           vectorizer=vec, preloaded=(engine, _cfg))
        ids = np.asarray(res["final_ids"])
        pos = (ids[:, 0] // 2).astype(np.int64)
        top1 = float(np.mean(
            (np.abs(pos - starts) <= 2) & (ids[:, 0] % 2 == strands)
        ))
        print(json.dumps({
            "engine": "IVFPQ" + ("+OPQ" if args.opq else "")
                      + f"+m{args.m_pq}+dense-rerank",
            "nprobe": 32,
            "t_search_s": round(res["t_search"], 1),
            "t_post_s": round(res["t_post"], 1),
            "truth_top1": round(top1, 4),
        }), flush=True)
    print("DONE", flush=True)


if __name__ == "__main__":
    main()
