"""Shift-matched fine-tuning validation for SPARSE indexes.

A sparse (stride s) index only holds every s-th window, so real reads start
up to s-1 bases off the nearest indexed window.  The pretrained encoder is
shift-sensitive: at genome scale this caps sparse top-1 accuracy regardless
of how many candidates the rerank sees (measured 0.806 -> 0.814 going from
k_clusters 5 to 64 at 46 Mbp).  `finetune(..., max_shift=s-1)` trains
(shifted noisy read, window) InfoNCE pairs and removes the ceiling:

    5 Mbp, stride 4, INT8FLAT + rerank:  0.826 -> 0.9961  (400 steps)

Usage (from the repo root):
    python scripts/demo_shift_tune.py [n_bp] [n_reads] [stride] [steps]
"""

import os
import sys
import tempfile
import time

import numpy as np

# Reuse the genome/read simulators from the genome-scale demo (run from
# the repo root, so the scripts namespace package resolves).
sys.path.insert(0, os.getcwd())
from scripts.demo_genome_scale import make_genome, simulate_reads  # noqa: E402


def run(n_bp, n_reads, stride, steps, read_len=150):
    genome = make_genome(n_bp)
    reads, names, starts, strands = simulate_reads(
        genome, n_reads, read_len, err=0.01
    )
    with tempfile.TemporaryDirectory() as tmp:
        ref = os.path.join(tmp, "ref.fna")
        fq = os.path.join(tmp, "reads.fastq")
        with open(ref, "w") as f:
            f.write("> synthetic\n")
            for i in range(0, n_bp, 80):
                f.write(genome[i : i + 80] + "\n")
        with open(fq, "w") as f:
            for r, n in zip(reads, names):
                f.write(f"@{n}\n{r}\n+\n{'I' * read_len}\n")

        from deepreadmapper_tpu.models.encoder import Vectorizer
        from deepreadmapper_tpu.pipeline.build import build_index
        from deepreadmapper_tpu.pipeline.finetune import finetune
        from deepreadmapper_tpu.pipeline.search import run_pipeline

        def measure(prefix, vec):
            res = run_pipeline(
                prefix, fq, ref, ef=128, k=16, k_clusters=16,
                output_dir=prefix + "_out", write_sam=False, vectorizer=vec,
            )
            fid = res["final_ids"][:, 0]
            return float(
                np.mean(
                    (np.abs((fid // 2).astype(np.int64) - starts) <= 5)
                    & ((fid % 2) == strands)
                )
            )

        vec0 = Vectorizer()
        build_index(ref, os.path.join(tmp, "base"), read_len, stride=stride,
                    index_type="INT8FLAT", vectorizer=vec0)
        acc0 = measure(os.path.join(tmp, "base"), vec0)
        print(f"pretrained encoder, stride-{stride} rerank top-1: {acc0:.4f}",
              flush=True)

        t0 = time.time()
        params, losses = finetune(
            ref, read_len, steps=steps, batch=1024, sub_rate=0.01,
            max_shift=stride - 1, seed=1,
        )
        loss_str = (f"loss {losses[0]:.3f} -> {losses[-1]:.3f}"
                    if losses else "no steps")
        print(f"shift-tune ({steps} steps, max_shift={stride-1}): "
              f"{time.time()-t0:.0f}s, {loss_str}", flush=True)
        vec_t = Vectorizer(params=params)
        build_index(ref, os.path.join(tmp, "tuned"), read_len, stride=stride,
                    index_type="INT8FLAT", vectorizer=vec_t)
        acc1 = measure(os.path.join(tmp, "tuned"), vec_t)
        print(f"shift-tuned encoder, stride-{stride} rerank top-1: "
              f"{acc1:.4f}  ({acc1-acc0:+.4f})", flush=True)


if __name__ == "__main__":
    n_bp = int(sys.argv[1]) if len(sys.argv) > 1 else 5_000_000
    n_reads = int(sys.argv[2]) if len(sys.argv) > 2 else 20_000
    stride = int(sys.argv[3]) if len(sys.argv) > 3 else 4
    steps = int(sys.argv[4]) if len(sys.argv) > 4 else 400
    run(n_bp, n_reads, stride, steps)
