"""HNSWPQ quality evidence: recall-vs-ef against the exact oracle and the
exhaustive-ADC ceiling.

FAISS is not installable here, so the candidate-set comparison target is the
repo's own PQFLAT exhaustive ADC scan built from the SAME codes+codebook as
the HNSWPQ index — by construction the best any ADC-metric search (including
FAISS IndexHNSWPQ) can do; the HNSW graph can only lose candidates relative
to it.  Two datasets:

  * ecoli_150 fixture (851 windows x 2 strands, the reference's own test
    genome + its 150-read FASTQ)
  * a simulated genome at --n-bp (default 200 kbp -> ~400k windows) with
    1k wgsim-style reads at 1% error

Reports, per ef in {64,128,256,512}: recall@10 / recall@128 vs the exact
fp32 oracle, and candidate-set overlap@128 vs the same-codebook exhaustive
ADC (the FAISS-equivalence measure).  Also prints the ADC ceiling itself and
INT8FLAT for context.  One JSON line at the end.

Usage: python scripts/eval_hnswpq.py [--n-bp N]   (CPU hermetic by
default, JAX_CPU=0 for the GPU).
"""

import argparse
import json
import os
import sys
import time

if os.environ.get("JAX_CPU", "1") == "1":
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    import jax

    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.join(os.getcwd(), "scripts"))
from demo_genome_scale import make_genome, simulate_reads  # noqa: E402

from deepreadmapper_tpu.config import BuildConfig  # noqa: E402
from deepreadmapper_tpu.index.flat import FlatIndex  # noqa: E402
from deepreadmapper_tpu.index.hnsw import HNSWPQIndex  # noqa: E402
from deepreadmapper_tpu.index.int8_flat import Int8FlatIndex  # noqa: E402
from deepreadmapper_tpu.index.pq_flat import PQFlatIndex  # noqa: E402
from deepreadmapper_tpu.io import fasta, fastq  # noqa: E402
from deepreadmapper_tpu.models.encoder import Vectorizer  # noqa: E402

EFS = (64, 128, 256, 512)
KBIG = 128


def _recall(ids: np.ndarray, gt: np.ndarray, k: int) -> float:
    ids = np.asarray(ids)[:, :k]
    gt = np.asarray(gt)[:, :k]
    return float(
        np.mean([len(set(a.tolist()) & set(b.tolist())) / k for a, b in zip(ids, gt)])
    )


def eval_dataset(name: str, x: np.ndarray, q: np.ndarray):
    out = {"name": name, "n": int(x.shape[0]), "nq": int(q.shape[0])}
    gt, _ = FlatIndex(x).search(q, KBIG)

    t0 = time.time()
    hp = HNSWPQIndex.build(x, BuildConfig())
    out["build_s"] = round(time.time() - t0, 1)

    # Exhaustive ADC over the SAME codes/codebook: the ceiling for any
    # ADC-metric search, FAISS IndexHNSWPQ included.
    adc = PQFlatIndex(hp.codes, hp.codebook, hp.ntotal)
    adc_ids, _ = adc.search(q, KBIG, exact=True)
    out["adc_ceiling"] = {
        "recall@10": round(_recall(adc_ids, gt, 10), 4),
        "recall@128": round(_recall(adc_ids, gt, KBIG), 4),
    }
    i8 = Int8FlatIndex.build(x, BuildConfig())
    i8_ids, _ = i8.search(q, KBIG)
    out["int8flat"] = {
        "recall@10": round(_recall(i8_ids, gt, 10), 4),
        "recall@128": round(_recall(i8_ids, gt, KBIG), 4),
    }

    out["hnswpq"] = {}
    for ef in EFS:
        ids10, _ = hp.search(q, 10, ef=ef)  # the real k=10 operating point
        entry = {"recall@10": round(_recall(ids10, gt, 10), 4)}
        if ef >= KBIG:
            ids, _ = hp.search(q, KBIG, ef=ef)
            entry["recall@128"] = round(_recall(ids, gt, KBIG), 4)
            entry["adc_overlap@128"] = round(_recall(ids, adc_ids, KBIG), 4)
        out["hnswpq"][ef] = entry
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-bp", type=int, default=50_000)
    args = ap.parse_args()

    vec = Vectorizer(device_batch=512)
    res = {"datasets": []}

    # ecoli_150 fixture: the reference's own genome + reads
    recs = fasta.parse_fasta_records("tests/data/ecoli_150.fna")
    win, _ = fasta.windows_as_strings(recs, 150, 1, lookup_mode=True)
    seqs, _ = fastq.parse_fastq("tests/data/test_data.fastq")
    x = np.asarray(vec.vectorize(win), np.float32)
    q = np.asarray(vec.vectorize(seqs), np.float32)
    res["datasets"].append(eval_dataset("ecoli_150", x, q))

    genome = make_genome(args.n_bp, seed=7)
    rec = np.frombuffer(genome.encode(), dtype=np.uint8)
    win, _ = fasta.windows_as_strings([rec], 150, 1, lookup_mode=True)
    reads, _, _, _ = simulate_reads(genome, 1000, 150, err=0.01, seed=11)
    x = np.asarray(vec.vectorize(win), np.float32)
    q = np.asarray(vec.vectorize(reads), np.float32)
    res["datasets"].append(eval_dataset(f"sim_{args.n_bp}bp", x, q))

    print(json.dumps(res))


if __name__ == "__main__":
    main()
