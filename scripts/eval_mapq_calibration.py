"""MAPQ calibration harness: predicted error vs observed error per MAPQ bin.

MAPQ is only useful downstream (variant callers, IGV filters) if
10^(-MAPQ/10) tracks the real mis-mapping probability.  The reference
hardcodes MAPQ 60 (src/utils/utils.cpp:373) — trivially
uncalibrated; this harness measures OUR margin-based compute_mapq
(pipeline/search.py) on a synthetic harder than the uniform planted-repeat
evals:

* TANDEM ARRAYS: repeat units (300-1500 bp) copied 3-12x in place with
  per-copy divergence — near-identical local competitors, the worst case
  for a margin heuristic.
* DISPERSED REPEAT FAMILIES: 1-4 kb family consensus copied 5-30x genome-
  wide at ~1% divergence — the segdup/transposon analog.
* Unique background between them.

Reads are simulated wgsim-style across the WHOLE genome (so a realistic
fraction lands in repeats), mapped single-end (--mapq) and paired, and
binned by reported MAPQ; each bin reports observed error (primary further
than --tol from truth, or wrong strand) vs predicted 10^(-q/10).

    python - [--n-bp 2000000 --n-reads 8192] < scripts/eval_mapq_calibration.py
"""

import argparse
import json
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.join(os.getcwd(), "scripts"))
from demo_genome_scale import make_genome, simulate_reads  # noqa: E402
from eval_paired import simulate_pairs, write_fq  # noqa: E402

BINS = [(0, 0), (1, 9), (10, 19), (20, 29), (30, 39), (40, 49), (50, 59),
        (60, 60)]


def harden_genome(genome: str, seed: int, tandem_frac: float = 0.05,
                  family_frac: float = 0.08) -> str:
    """Plant tandem arrays + multi-copy dispersed families into a uniform
    genome; returns the modified genome (same length)."""
    rng = np.random.default_rng(seed)
    g = np.frombuffer(genome.encode(), np.uint8).copy()
    n = len(g)
    bases = np.frombuffer(b"ACGT", np.uint8)

    def diverge(arr, rate):
        out = arr.copy()
        mask = rng.random(len(out)) < rate
        out[mask] = bases[rng.integers(0, 4, int(mask.sum()))]
        return out

    # tandem arrays until tandem_frac of the genome is array territory
    placed = 0
    while placed < n * tandem_frac:
        unit = int(rng.integers(300, 1500))
        copies = int(rng.integers(3, 12))
        span = unit * copies
        at = int(rng.integers(0, n - span))
        u = g[at: at + unit].copy()
        for c in range(1, copies):
            g[at + c * unit: at + (c + 1) * unit] = diverge(u, 0.005)
        placed += span
    # dispersed families
    placed = 0
    while placed < n * family_frac:
        flen = int(rng.integers(1000, 4000))
        copies = int(rng.integers(5, 30))
        src = int(rng.integers(0, n - flen))
        fam = g[src: src + flen].copy()
        for _ in range(copies):
            dst = int(rng.integers(0, n - flen))
            g[dst: dst + flen] = diverge(fam, 0.01)
            placed += flen
    return g.tobytes().decode()


def bin_table(mapq: np.ndarray, wrong: np.ndarray) -> list[dict]:
    rows = []
    for lo, hi in BINS:
        m = (mapq >= lo) & (mapq <= hi)
        cnt = int(m.sum())
        if cnt == 0:
            continue
        obs = float(wrong[m].mean())
        mid = float(mapq[m].mean())
        pred = float(10 ** (-mid / 10.0))
        rows.append({
            "bin": f"{lo}-{hi}", "n": cnt,
            "mean_mapq": round(mid, 1),
            "pred_err": round(pred, 5),
            "obs_err": round(obs, 5),
            "obs_over_pred": round(obs / max(pred, 1e-12), 2),
        })
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-bp", type=int, default=2_000_000)
    ap.add_argument("--n-reads", type=int, default=8192)
    ap.add_argument("--n-pairs", type=int, default=4096)
    ap.add_argument("--read-len", type=int, default=150)
    ap.add_argument("--err", type=float, default=0.01)
    ap.add_argument("--tol", type=int, default=5)
    ap.add_argument("--k", type=int, default=16)
    ap.add_argument("--index-type", default="INT8FLAT")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--out", default="chiprun_out/mapq_calibration.json")
    args = ap.parse_args()
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    genome = harden_genome(make_genome(args.n_bp, seed=args.seed),
                           args.seed + 3)
    reads, names, starts, strands = simulate_reads(
        genome, args.n_reads, args.read_len, err=args.err,
        seed=args.seed + 1,
    )
    r1, r2, truth = simulate_pairs(
        genome, args.n_pairs, args.read_len, 500, 50, args.err,
        seed=args.seed + 2,
    )
    t1 = np.array([t[0] for t in truth], np.int64)
    t2 = np.array([t[1] for t in truth], np.int64)

    from deepreadmapper_tpu.pipeline.build import build_index
    from deepreadmapper_tpu.pipeline.search import (
        calibrate_mapq,
        compute_mapq,
        run_pipeline,
        run_pipeline_paired,
    )

    with tempfile.TemporaryDirectory() as tmp:
        ref = os.path.join(tmp, "ref.fna")
        with open(ref, "w") as f:
            f.write("> sim\n")
            for i in range(0, len(genome), 80):
                f.write(genome[i: i + 80] + "\n")
        fq = os.path.join(tmp, "se.fastq")
        with open(fq, "w") as f:
            for r, nm in zip(reads, names):
                f.write(f"@{nm}\n{r}\n+\n{'I' * len(r)}\n")
        f1, f2 = os.path.join(tmp, "r1.fastq"), os.path.join(tmp, "r2.fastq")
        write_fq(f1, r1)
        write_fq(f2, r2)
        prefix = os.path.join(tmp, "idx")
        build_index(ref, prefix, args.read_len, index_type=args.index_type)

        # --- single-end ---
        res = run_pipeline(prefix, fq, ref, k=args.k,
                           output_dir=os.path.join(tmp, "se"),
                           write_sam=False)
        ids = np.asarray(res["final_ids"])
        d = np.asarray(res["final_d"])
        mq = compute_mapq(ids, d, args.read_len)
        pos = (ids[:, 0] >> 1).astype(np.int64)
        wrong = (np.abs(pos - starts) > args.tol) | (
            (ids[:, 0] & 1) != strands
        ) | (ids[:, 0] < 0)
        se_rows = bin_table(mq, wrong)
        for r in se_rows:
            print(json.dumps({"mode": "single", **r}), flush=True)
        se_cal = bin_table(calibrate_mapq(mq), wrong)
        for r in se_cal:
            print(json.dumps({"mode": "single_cal", **r}), flush=True)

        # --- paired (per-end pair MAPQ from the SAM) ---
        out = os.path.join(tmp, "pe")
        run_pipeline_paired(prefix, f1, f2, ref, k=args.k, output_dir=out,
                            mapq=True, max_isize=700)
        mq_l, wrong_l = [], []
        for line in open(os.path.join(out, "results.sam")):
            if line.startswith("@"):
                continue
            fld = line.split("\t")
            flag = int(fld[1])
            if flag & 0x900:
                continue
            i = int(fld[0][1:])
            tcol = t2[i] if flag & 0x80 else t1[i]
            mq_l.append(int(fld[4]))
            if flag & 0x4:
                wrong_l.append(True)
            else:
                wrong_l.append(abs(int(fld[3]) - 1 - tcol) > args.tol)
        pe_rows = bin_table(np.array(mq_l), np.array(wrong_l))
        for r in pe_rows:
            print(json.dumps({"mode": "paired", **r}), flush=True)
        pe_cal = bin_table(calibrate_mapq(np.array(mq_l)),
                           np.array(wrong_l))
        for r in pe_cal:
            print(json.dumps({"mode": "paired_cal", **r}), flush=True)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    doc = {
        "n_bp": args.n_bp, "n_reads": args.n_reads, "n_pairs": args.n_pairs,
        "err": args.err, "index_type": args.index_type, "tol": args.tol,
        "genome": "tandem arrays 5% + dispersed families 8% + unique",
        "single_end": se_rows, "paired": pe_rows,
        "single_end_calibrated": se_cal, "paired_calibrated": pe_cal,
    }
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=2)
    print(f"[EVAL] wrote {args.out}", flush=True)


if __name__ == "__main__":
    main()
