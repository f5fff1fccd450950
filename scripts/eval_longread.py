"""Long-read mapping accuracy harness: read-length x error-rate grid.

Simulates reads far beyond the encoder's 121-base window (the reference
truncates; --long-reads chains chunk votes), both strands, substitution +
indel errors, plus a chimera set to measure split-read detection.  One
JSON row per config, a JSON document at the end.

    python - [--n-bp 2000000] < scripts/eval_longread.py
"""

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.join(os.getcwd(), "scripts"))
from demo_genome_scale import make_genome  # noqa: E402

_COMP = str.maketrans("ACGT", "TGCA")


def mutate(seq, sub, indel, rng):
    out = []
    bases = "ACGT"
    for ch in seq:
        r = rng.random()
        if r < indel / 2:
            continue  # deletion
        if r < indel:
            out.append(rng.choice(list(bases)))  # insertion (keep base too)
            out.append(ch)
            continue
        if r < indel + sub:
            out.append(rng.choice([b for b in bases if b != ch]))
        else:
            out.append(ch)
    return "".join(out)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-bp", type=int, default=2_000_000)
    ap.add_argument("--n-reads", type=int, default=256)
    ap.add_argument("--read-lens", default="1000,5000,20000")
    ap.add_argument("--errs", default="0.01,0.05,0.10")
    ap.add_argument("--indel-frac", type=float, default=0.4,
                    help="fraction of the error budget spent on indels "
                         "(PacBio/ONT-style)")
    ap.add_argument("--ref-len", type=int, default=150)
    ap.add_argument("--index-type", default="INT8FLAT")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="eval_longread.json")
    ap.add_argument("--keep-dir", default=None,
                    help="persistent work dir: reuse the ref + index across "
                         "runs (marker-checked against --n-bp/--seed/"
                         "--ref-len/--index-type)")
    ap.add_argument("--skip-chimera", action="store_true")
    ap.add_argument("--max-chunks", type=int, default=128,
                    help="votes per read cap (pipeline --lr-max-chunks); "
                         "A/B the 20 kb search-bound cells")
    args = ap.parse_args()

    genome = make_genome(args.n_bp, seed=args.seed)
    from deepreadmapper_tpu.pipeline.build import build_index
    from deepreadmapper_tpu.pipeline.search import run_pipeline

    rows = []
    ctx = (tempfile.TemporaryDirectory() if args.keep_dir is None
           else contextlib.nullcontext(args.keep_dir))
    with ctx as tmp:
        os.makedirs(tmp, exist_ok=True)
        ref = os.path.join(tmp, "ref.fna")
        prefix = os.path.join(tmp, "idx")
        marker = os.path.join(tmp, "lr_marker.json")
        want = {"n_bp": args.n_bp, "seed": args.seed,
                "ref_len": args.ref_len, "index_type": args.index_type}
        cached = False
        if args.keep_dir is not None and os.path.exists(marker):
            with open(marker) as f:
                have = json.load(f)
            if have != want:
                raise SystemExit(f"--keep-dir marker mismatch: {have} != "
                                 f"{want}; use a fresh dir")
            cached = os.path.exists(os.path.join(prefix, "config.txt"))
        t_build = None  # null in the output doc when the index was cached
        if not cached:
            with open(ref, "w") as f:
                f.write("> sim\n")
                for i in range(0, len(genome), 80):
                    f.write(genome[i: i + 80] + "\n")
            t0 = time.time()
            build_index(ref, prefix, args.ref_len,
                        index_type=args.index_type)
            t_build = time.time() - t0
            if args.keep_dir is not None:
                with open(marker, "w") as f:
                    json.dump(want, f)

        # ONE resident vectorizer + engine across the whole grid: without
        # this every cell re-uploads the index (1.3 GB at 10M windows) and
        # re-jits the encoder, and reads/s measures that, not the mapper
        from deepreadmapper_tpu.index.registry import load_index
        from deepreadmapper_tpu.models.encoder import Vectorizer

        vec = Vectorizer()
        preloaded = load_index(prefix)

        # warm the resident engine+encoder before the timed grid: the FIRST
        # search pays the index upload plus compiles, which belong to load,
        # not mapping.  Serving is resident (cli serve), so per-cell reads/s
        # should measure the warm path.
        rngw = np.random.default_rng(args.seed + 7)
        wreads = [
            "".join(rngw.choice(list("ACGT"), size=1200))
            for _ in range(4)
        ]
        fqw = os.path.join(tmp, "warm.fastq")
        with open(fqw, "w") as f:
            for i, seq in enumerate(wreads):
                f.write(f"@w{i}\n{seq}\n+\n{'I' * len(seq)}\n")
        run_pipeline(prefix, fqw, ref, k=4,
                     output_dir=os.path.join(tmp, "out_warm"),
                     long_reads=True, mapq=True, vectorizer=vec,
                     preloaded=preloaded)

        for L in [int(x) for x in args.read_lens.split(",")]:
            for err in [float(x) for x in args.errs.split(",")]:
                rng = np.random.default_rng(args.seed + L + int(err * 1000))
                sub = err * (1 - args.indel_frac)
                indel = err * args.indel_frac
                reads, starts, strands = [], [], []
                for i in range(args.n_reads):
                    s = int(rng.integers(0, args.n_bp - L))
                    seq = mutate(genome[s: s + L], sub, indel, rng)
                    st = int(rng.integers(0, 2))
                    if st:
                        seq = seq.translate(_COMP)[::-1]
                    reads.append((f"r{i}", seq))
                    starts.append(s)
                    strands.append(st)
                fq = os.path.join(tmp, f"lr_{L}_{err}.fastq")
                with open(fq, "w") as f:
                    for name, seq in reads:
                        f.write(f"@{name}\n{seq}\n+\n{'I' * len(seq)}\n")
                out = os.path.join(tmp, f"out_{L}_{err}")
                t0 = time.time()
                res = run_pipeline(prefix, fq, ref, k=4, output_dir=out,
                                   long_reads=True, mapq=True,
                                   lr_max_chunks=args.max_chunks,
                                   vectorizer=vec, preloaded=preloaded)
                dt = time.time() - t0
                ids = np.load(os.path.join(out, "indices.npy"))
                got = (ids[:, 0] // 2).astype(np.int64)
                tol = max(20, int(L * err))  # indel drift scales with L*err
                ok = (np.abs(got - np.asarray(starts)) <= tol) & (
                    ids[:, 0] % 2 == np.asarray(strands)
                )
                mq = []
                for line in open(os.path.join(out, "results.sam")):
                    if line.startswith("@"):
                        continue
                    f2 = line.split("\t")
                    if int(f2[1]) & 0x900 == 0:
                        mq.append(int(f2[4]))
                mq = np.asarray(mq)
                hi = mq >= 30
                row = {
                    "read_len": L, "err": err,
                    "top1": round(float(ok.mean()), 4),
                    "mapq30_precision": round(
                        float(ok[hi].mean()) if hi.any() else 1.0, 4),
                    "mapq30_frac": round(float(hi.mean()), 4),
                    "reads_per_s": round(args.n_reads / dt, 1),
                    # device/host split: embed+search
                    # are device stages, host_pack/chain/t_post are host
                    "split_s": {
                        k2: round(v2, 3)
                        for k2, v2 in (res.get("t_lr_split") or {}).items()
                    },
                    "t_post_s": round(res["t_post"], 3),
                }
                rows.append(row)
                print(json.dumps(row), flush=True)

        # chimera detection: half-and-half fusion reads
        if not args.skip_chimera:
            rng = np.random.default_rng(args.seed + 99)
            reads = []
            for i in range(64):
                a = int(rng.integers(0, args.n_bp // 2 - 1000))
                b = int(rng.integers(args.n_bp // 2, args.n_bp - 1000))
                seq = mutate(genome[a: a + 800], 0.005, 0.005, rng) + mutate(
                    genome[b: b + 700], 0.005, 0.005, rng)
                reads.append((f"c{i}", seq))
            fq = os.path.join(tmp, "chim.fastq")
            with open(fq, "w") as f:
                for name, seq in reads:
                    f.write(f"@{name}\n{seq}\n+\n{'I' * len(seq)}\n")
            out = os.path.join(tmp, "out_chim")
            run_pipeline(prefix, fq, ref, k=4, output_dir=out,
                         long_reads=True, lr_max_chunks=args.max_chunks,
                         vectorizer=vec, preloaded=preloaded)
            with_supp = set()
            for line in open(os.path.join(out, "results.sam")):
                if line.startswith("@"):
                    continue
                f2 = line.split("\t")
                if int(f2[1]) & 0x800:
                    with_supp.add(f2[0])
            row = {"mode": "chimera_64x1500bp",
                   "supplementary_rate": round(len(with_supp) / 64, 4)}
            rows.append(row)
            print(json.dumps(row), flush=True)

    doc = {"n_bp": args.n_bp, "n_reads": args.n_reads,
           "index_type": args.index_type,
           "t_build_s": None if t_build is None else round(t_build, 1),
           "cached_index": t_build is None,
           "rows": rows}
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=2)
    print(f"[EVAL] wrote {args.out}", flush=True)


if __name__ == "__main__":
    main()
