"""Measure the exact-matmul vs HNSW-beam search crossover on one card.

On an accelerator the brute-force top-k is pure matmul work while graph
traversal is a chain of dependent gathers, so — unlike CPU FAISS —
exhaustive search stays competitive to surprisingly large N.  This script documents the crossover that motivates the
index_type choice (FLAT/PQFLAT for small-to-mid N, HNSW* beyond).

--ivf mode: the >100M-row-tier crossover.  Builds one genome's int8 codes,
serves them through both the full windowed scan (INT8FLAT) and the
cluster-pruned engine (IVFINT8) at a ladder of nprobe values, and reports
q/s + relative recall@128 (IVF top-128 overlap vs the full scan's top-128
over the SAME codes — the probe set is the only approximation).

    python scripts/bench_crossover.py --ivf --n-bp 20000000   # ~40M rows
"""

import argparse
import json
import os
import tempfile
import time

import numpy as np
import jax

from deepreadmapper_tpu.config import BuildConfig
from deepreadmapper_tpu.index.hnsw import HNSWFlatIndex, HNSWPQIndex
from deepreadmapper_tpu.ops.topk import l2_topk


def ivf_mode(args):
    import sys

    # run from the repo root: python scripts/bench_crossover.py --ivf
    sys.path.insert(0, os.path.join(os.getcwd(), "scripts"))
    from demo_genome_scale import make_genome, simulate_reads

    from deepreadmapper_tpu.index.ivf_int8 import IVFInt8Index
    from deepreadmapper_tpu.index.registry import load_index
    from deepreadmapper_tpu.io.fastq import parse_fastq_bytes
    from deepreadmapper_tpu.models.encoder import Vectorizer
    from deepreadmapper_tpu.pipeline.build import build_index

    k = 128
    genome = make_genome(args.n_bp)
    reads, _names, starts, strands = simulate_reads(
        genome, args.n_queries, 150, err=0.01
    )
    import shutil

    tmp = args.keep_dir or tempfile.mkdtemp(prefix="bench_ivf_")
    os.makedirs(tmp, exist_ok=True)
    try:
        ref = os.path.join(tmp, "ref.fna")
        fq = os.path.join(tmp, "reads.fastq")
        # keep-dir staleness guard: the FASTQ line count alone can't catch
        # a rerun with a different --n-bp (stale index vs fresh truth)
        marker = os.path.join(tmp, "bench_marker.json")
        if os.path.exists(marker):
            with open(marker) as f:
                mk = json.load(f)
            if mk.get("n_bp") != args.n_bp:
                raise ValueError(
                    f"--keep-dir {tmp} was built with n_bp={mk.get('n_bp')} "
                    f"but this run asks n_bp={args.n_bp}; a cached index "
                    "would be scored against mismatched truth — use a "
                    "fresh --keep-dir"
                )
        else:
            with open(marker, "w") as f:
                json.dump({"n_bp": args.n_bp}, f)
        if os.path.exists(fq):
            n_lines = sum(1 for _ in open(fq))
            if n_lines != 4 * args.n_queries:
                raise ValueError(
                    f"{fq} caches {n_lines // 4} reads but --n-queries is "
                    f"{args.n_queries}; truth arrays would mis-score — "
                    "use a fresh --keep-dir"
                )
        if not os.path.exists(ref):
            with open(ref, "w") as f:
                f.write("> synthetic\n")
                for i in range(0, args.n_bp, 80):
                    f.write(genome[i:i + 80] + "\n")
        if not os.path.exists(fq):
            with open(fq, "w") as f:
                for i, r in enumerate(reads):
                    f.write(f"@r{i}\n{r}\n+\n{'I' * 150}\n")

        vec = Vectorizer()
        prefix = os.path.join(tmp, "idx")
        t0 = time.time()
        # one embedding pass: the INT8FLAT stream-quantize build produces
        # the int8 codes both engines serve (resumable for bench iteration)
        if not os.path.exists(os.path.join(prefix, "config.txt")):
            build_index(ref, prefix, 150, index_type="INT8FLAT",
                        vectorizer=vec, resume=bool(args.keep_dir))
            print(f"[IVF] codes built in {time.time()-t0:.0f}s", flush=True)

        flat, _cfg = load_index(prefix)
        n = flat.ntotal
        mat, lengths, _ = parse_fastq_bytes(fq)
        emb = np.asarray(vec.vectorize_wrapped_bytes(mat, lengths))

        def truth_top1(ids):
            """Planted-truth hit rate: the pipeline metric (strand-aware
            window id within +-2 of the simulated origin)."""
            pos = (ids[:, 0] // 2).astype(np.int64)
            return float(np.mean(
                (np.abs(pos - starts) <= 2) & (ids[:, 0] % 2 == strands)
            ))

        ids_f, d_f = flat.search(emb, k)  # warm: index upload + compile
        t0 = time.time()
        ids_f, d_f = flat.search(emb, k)
        dt_flat = time.time() - t0
        print(json.dumps({
            "engine": "INT8FLAT", "n_rows": n,
            "qps": round(args.n_queries / dt_flat, 0),
            "truth_top1": round(truth_top1(ids_f), 4),
        }), flush=True)
        truth = [set(row.tolist()) for row in ids_f]
        # int8 scores tie heavily at genome scale: the flat top-128 is an
        # arbitrary 128 of a larger equal-score class, so set overlap
        # understates IVF recall.  Tie-aware recall counts an IVF candidate
        # as a hit when its distance dominates the flat kth distance (both
        # engines share one quantized-L2 convention).
        kth = d_f[:, k - 1:k]
        del flat  # drop device residency before the IVF copy uploads

        ivf_dir = os.path.join(tmp, f"ivf_nlist{args.nlist}")
        if os.path.exists(os.path.join(ivf_dir, "ivf_int8.npz")):
            ivf = IVFInt8Index.load(ivf_dir)
            print(f"[IVF] loaded cached coarse layout "
                  f"(nlist={ivf.nlist} slabs={ivf.n_slabs} cap={ivf.cap})",
                  flush=True)
        else:
            codes = np.load(os.path.join(prefix, "int8.npz"))
            t0 = time.time()
            ivf = IVFInt8Index.build_from_codes(
                codes["codes"], float(codes["scale"]),
                BuildConfig(nlist=args.nlist),
            )
            print(f"[IVF] coarse build {time.time()-t0:.0f}s "
                  f"(nlist={ivf.nlist} slabs={ivf.n_slabs} cap={ivf.cap})",
                  flush=True)
            if args.keep_dir:
                ivf.save(ivf_dir)

        for nprobe in args.nprobe:
            ids_v, d_v = ivf.search(emb, k, ef=nprobe,
                                    approx_probe=args.approx_probe)  # warm
            t0 = time.time()
            ids_v, d_v = ivf.search(emb, k, ef=nprobe,
                                    approx_probe=args.approx_probe)
            dt = time.time() - t0
            rr = float(np.mean([
                len(truth[i] & set(ids_v[i].tolist())) / len(truth[i])
                for i in range(args.n_queries)
            ]))
            tol = 1e-3 + 1e-5 * np.abs(kth)
            rr_tie = float(np.mean(
                np.sum((d_v <= kth + tol) & (ids_v >= 0), axis=1)
                / k
            ))
            print(json.dumps({
                "engine": "IVFINT8", "nprobe": nprobe,
                "qps": round(args.n_queries / dt, 0),
                "rel_recall_at_128": round(rr, 4),
                "tie_aware_recall_at_128": round(min(rr_tie, 1.0), 4),
                "truth_top1": round(truth_top1(ids_v), 4),
                "speedup_vs_flat": round(dt_flat / dt, 2),
            }), flush=True)
    finally:
        if not args.keep_dir:
            shutil.rmtree(tmp, ignore_errors=True)
    print("DONE", flush=True)


def main():
    rng = np.random.default_rng(0)
    q_count = 4096
    q = rng.standard_normal((q_count, 128)).astype(np.float32)

    for n in (100_000, 200_000):
        x = rng.standard_normal((n, 128)).astype(np.float32)
        xj = jax.device_put(x)
        qj = jax.device_put(q)
        np.asarray(l2_topk(qj, xj, 128)[1][:1])
        t0 = time.time()
        for _ in range(3):
            np.asarray(l2_topk(qj, xj, 128)[1][:1, :1])
        dt = (time.time() - t0) / 3
        print(f"N={n}: exact matmul top-128: {dt*1000:6.0f} ms -> {q_count/dt:8.0f} q/s", flush=True)

        t0 = time.time()
        idx = HNSWFlatIndex.build(x, BuildConfig(build_mode="knn"))
        print(f"N={n}: knn build {time.time()-t0:.0f}s", flush=True)
        ids, _ = idx.search(q, 128, ef=128)
        t0 = time.time()
        for _ in range(3):
            idx.search(q, 128, ef=128)
        dt = (time.time() - t0) / 3
        print(f"N={n}: HNSWFLAT beam ef=128: {dt*1000:6.0f} ms -> {q_count/dt:8.0f} q/s", flush=True)
        io_ = np.asarray(l2_topk(qj, xj, 10)[1])
        rec = np.mean([len(set(io_[r]) & set(ids[r][:10])) / 10 for r in range(256)])
        print(f"N={n}: HNSWFLAT recall@10: {rec:.3f}", flush=True)

        pidx = HNSWPQIndex.build(x, BuildConfig(build_mode="knn"))
        pidx.search(q, 128, ef=128)
        t0 = time.time()
        for _ in range(3):
            pidx.search(q, 128, ef=128)
        dt = (time.time() - t0) / 3
        print(f"N={n}: HNSWPQ beam ef=128:  {dt*1000:6.0f} ms -> {q_count/dt:8.0f} q/s", flush=True)

        from deepreadmapper_tpu.index.pq_flat import PQFlatIndex

        fidx = PQFlatIndex.build(x, BuildConfig())
        fidx.search(q, 128)
        t0 = time.time()
        for _ in range(3):
            fidx.search(q, 128)
        dt = (time.time() - t0) / 3
        print(f"N={n}: PQFLAT ADC scan:     {dt*1000:6.0f} ms -> {q_count/dt:8.0f} q/s", flush=True)
    print("DONE", flush=True)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--ivf", action="store_true",
                    help="IVFINT8 vs full exhaustive scan crossover")
    ap.add_argument("--n-bp", type=int, default=20_000_000,
                    help="--ivf genome size (20 Mbp -> ~40M windows)")
    ap.add_argument("--n-queries", type=int, default=8192)
    ap.add_argument("--nlist", type=int, default=0, help="0 = auto ~sqrt(N)")
    ap.add_argument("--nprobe", type=int, nargs="+",
                    default=[8, 16, 32, 64, 128])
    ap.add_argument("--approx-probe", action="store_true",
                    help="probe clusters with approx_max_k (vs full-sort "
                         "top_k) — A/B the probe cost at large nlist")
    ap.add_argument("--cpu", action="store_true",
                    help="force the host CPU backend (smoke tests)")
    ap.add_argument("--keep-dir", default="",
                    help="persist codes + coarse layout here so bench "
                         "iterations skip the 950 s embed pass")
    cli = ap.parse_args()
    if cli.cpu:
        jax.config.update("jax_platforms", "cpu")
    if cli.ivf:
        ivf_mode(cli)
    else:
        main()
