"""Reproducible accuracy/memory ladder: one command regenerates the
quantization-ladder and engine-comparison numbers recorded in BASELINE.md.

Builds one simulated genome + read set, then for every requested engine
config: builds the index (via the same streaming paths production uses),
searches the same query embeddings, and reports raw top-1 accuracy vs the
simulated truth, warm search throughput, and index size on disk — a single
JSON document at the end makes round-over-round claims auditable.

    python scripts/eval_ladder.py                        # 2 Mbp quick run
    python scripts/eval_ladder.py --n-bp 5000000         # BASELINE.md scale
    python scripts/eval_ladder.py --stride 4 --pipeline-acc   # sparse+rerank

Engine specs (comma list): FLAT | INT8FLAT | IVFINT8 | PQFLAT | PQFLAT+OPQ
| PQFLAT16 | PQFLAT16+OPQ | HNSWPQ | HNSWFLAT.  The reference publishes no
numbers (BASELINE.md); this harness is the measured substitute.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

# `python - < scripts/eval_ladder.py` leaves __file__ as '<stdin>'; fall
# back to ./scripts then.
_here = os.path.dirname(os.path.abspath(__file__))
if not os.path.exists(os.path.join(_here, "demo_genome_scale.py")):
    _here = os.path.join(os.getcwd(), "scripts")
sys.path.insert(0, _here)
from demo_genome_scale import make_genome, simulate_reads  # noqa: E402

from deepreadmapper_tpu.config import BuildConfig  # noqa: E402


def parse_engine_spec(spec: str):
    """'PQFLAT16+OPQ' -> (index_type, BuildConfig kwargs)."""
    s = spec.upper()
    kw = {}
    if "+OPQ" in s:
        kw["opq"] = True
        s = s.replace("+OPQ", "")
    for base in ("PQFLAT", "IVFPQ"):
        if s.startswith(base) and s != base and s[len(base):].isdigit():
            kw["m_pq"] = int(s[len(base):])
            s = base
    return s, kw


def dir_bytes(path: str) -> int:
    total = 0
    for root, _dirs, files in os.walk(path):
        for f in files:
            total += os.path.getsize(os.path.join(root, f))
    return total


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-bp", type=int, default=2_000_000)
    ap.add_argument("--n-reads", type=int, default=4096)
    ap.add_argument("--err", type=float, default=0.01)
    ap.add_argument("--stride", type=int, default=1)
    ap.add_argument("--k", type=int, default=16)
    ap.add_argument("--ef", type=int, default=128)
    ap.add_argument(
        "--engines",
        default="INT8FLAT,IVFINT8,PQFLAT,PQFLAT+OPQ,PQFLAT16+OPQ",
    )
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="eval_ladder.json")
    ap.add_argument(
        "--pipeline-acc", action="store_true",
        help="also run the full pipeline (expansion + rerank) per engine",
    )
    ap.add_argument(
        "--keep-dir", default="",
        help="reuse/keep build artifacts here instead of a temp dir",
    )
    ap.add_argument(
        "--weights", default="",
        help="fine-tuned encoder npz (shift/noise-matched weights are the "
             "documented sparse-mode lever); embeds queries AND windows "
             "with it and records it in the index for pipeline runs",
    )
    args = ap.parse_args()

    genome = make_genome(args.n_bp, seed=args.seed)
    reads, names, starts, strands = simulate_reads(
        genome, args.n_reads, 150, err=args.err, seed=args.seed + 1
    )

    workdir = args.keep_dir or tempfile.mkdtemp(prefix="eval_ladder_")
    os.makedirs(workdir, exist_ok=True)
    ref = os.path.join(workdir, "ref.fna")
    fq = os.path.join(workdir, "reads.fastq")
    if not os.path.exists(ref):
        with open(ref, "w") as f:
            f.write("> synthetic\n")
            for i in range(0, args.n_bp, 80):
                f.write(genome[i:i + 80] + "\n")
    if not os.path.exists(fq):
        with open(fq, "w") as f:
            for r, n in zip(reads, names):
                f.write(f"@{n}\n{r}\n+\n{'I' * 150}\n")

    from deepreadmapper_tpu.index.registry import load_index
    from deepreadmapper_tpu.io.fastq import parse_fastq_bytes
    from deepreadmapper_tpu.models.encoder import Vectorizer
    from deepreadmapper_tpu.pipeline.build import build_index

    if args.weights:
        from deepreadmapper_tpu.models.encoder import load_params

        vec = Vectorizer(load_params(args.weights))
    else:
        vec = Vectorizer()
    mat, lengths, _ = parse_fastq_bytes(fq)
    emb = np.asarray(vec.vectorize_wrapped_bytes(mat, lengths))
    tol = 5 + args.stride

    results = []
    for spec in args.engines.split(","):
        spec = spec.strip()
        index_type, kw = parse_engine_spec(spec)
        cfg = BuildConfig(stride=args.stride, seed=1234, **kw)
        prefix = os.path.join(workdir, "idx_" + spec.replace("+", "_"))
        row = {"engine": spec, "index_type": index_type, **kw}
        t0 = time.time()
        if not os.path.exists(os.path.join(prefix, "config.txt")):
            build_index(
                ref, prefix, 150, stride=args.stride, index_type=index_type,
                build_cfg=cfg, vectorizer=vec,
                weights=args.weights or None,
            )
            row["t_build_s"] = round(time.time() - t0, 1)
        engine, _cfg = load_index(prefix)
        row["index_bytes"] = dir_bytes(prefix)
        ids, dists = engine.search(emb, args.k, ef=args.ef)  # warm/compile
        t0 = time.time()
        ids, dists = engine.search(emb, args.k, ef=args.ef)
        row["search_qps"] = round(args.n_reads / (time.time() - t0), 0)
        top_pos = (ids[:, 0] // 2) * args.stride
        ok = (np.abs(top_pos.astype(np.int64) - starts) <= tol) & (
            ids[:, 0] % 2 == strands
        )
        row["raw_top1"] = round(float(ok.mean()), 4)

        if args.pipeline_acc:
            from deepreadmapper_tpu.pipeline.search import run_pipeline

            out = os.path.join(workdir, "out_" + spec.replace("+", "_"))
            res = run_pipeline(
                prefix, fq, ref, ef=args.ef, k=args.k, output_dir=out,
                write_sam=False,
                dense_rerank=args.stride == 1,
                vectorizer=vec,  # one resident encoder (tuned when
                # --weights); a fresh Vectorizer per engine re-jits
            )
            fid = (
                res["final_ids"][:, 0]
                if res.get("final_ids") is not None
                else np.load(os.path.join(out, "indices.npy"))[:, 0]
            )
            ok2 = (np.abs((fid // 2).astype(np.int64) - starts) <= tol) & (
                fid % 2 == strands
            )
            row["pipeline_top1"] = round(float(ok2.mean()), 4)
        results.append(row)
        print(json.dumps(row), flush=True)
        # free device HBM before the next engine uploads its arrays
        del engine

    n_windows = 2 * ((args.n_bp - 150) // args.stride + 1)
    doc = {
        "n_bp": args.n_bp,
        "n_windows": n_windows,
        "n_reads": args.n_reads,
        "err": args.err,
        "stride": args.stride,
        "k": args.k,
        "ef": args.ef,
        "seed": args.seed,
        "engines": results,
    }
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=2)
    print(f"[EVAL] wrote {args.out}", flush=True)
    if not args.keep_dir:
        shutil.rmtree(workdir, ignore_errors=True)


if __name__ == "__main__":
    main()
