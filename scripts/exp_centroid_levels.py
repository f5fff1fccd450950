"""A/B: hnswm centroid-partition HNSW levels vs seeded-RNG levels.

SURVEY.md asked for a measured keep/drop decision on the reference's
deterministic centroid-partition level assignment (src/hnswm/hnsw.cpp:701-796)
versus the hnswlib-style exponential RNG draws the repo defaults to.  The
structural hypothesis: genome-window embeddings arrive genome-ordered, so
partition medoids spread upper-level nodes evenly along the genome (and RNG
doesn't) — this could improve greedy-descent entry quality and recall at a
given ef.

Two datasets, same protocol:
  * genome:   embeddings of every stride-1 window (+revcomp) of a simulated
    genome — ordered, locally correlated (the production distribution)
  * gaussian: iid N(0,1) — structure-free control

Builds both graphs with the native insert builder (identical efc/M/seed),
searches the same queries at ef in {16..256}, reports recall@10 vs the exact
oracle plus build/search times, prints ONE JSON line.

Usage: python scripts/exp_centroid_levels.py [n_bp] [n_gauss]
CPU is fine and hermetic; pass JAX_CPU=0 to allow the GPU.
"""

import json
import os
import sys
import time

if os.environ.get("JAX_CPU", "1") == "1":
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    import jax

    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from deepreadmapper_tpu.config import BuildConfig  # noqa: E402
from deepreadmapper_tpu.index.flat import FlatIndex  # noqa: E402
from deepreadmapper_tpu.index.hnsw import HNSWFlatIndex  # noqa: E402

EFS = (16, 32, 64, 128, 256)
K = 10


def recall_table(x: np.ndarray, q: np.ndarray, mode: str, efc: int):
    gt, _ = FlatIndex(x).search(q, K)
    gt_sets = [set(row.tolist()) for row in gt]
    t0 = time.time()
    idx = HNSWFlatIndex.build(x, BuildConfig(level_mode=mode, efc=efc))
    build_s = time.time() - t0
    out = {}
    for ef in EFS:
        t0 = time.time()
        ids, _ = idx.search(q, K, ef=ef)
        dt = time.time() - t0
        ids = np.asarray(ids)
        rec = float(
            np.mean([len(gt_sets[i] & set(ids[i].tolist())) / K for i in range(len(q))])
        )
        out[ef] = {"recall": round(rec, 4), "search_s": round(dt, 3)}
    return out, round(build_s, 2), [len(g) for g in idx.graph.level_gids]


def genome_embeddings(n_bp: int):
    sys.path.insert(0, os.path.join(os.getcwd(), "scripts"))
    from demo_genome_scale import make_genome, simulate_reads

    from deepreadmapper_tpu.io.fasta import windows_as_strings
    from deepreadmapper_tpu.models.encoder import Vectorizer

    genome = make_genome(n_bp, seed=7)
    rec = np.frombuffer(genome.encode(), dtype=np.uint8)
    win, _ = windows_as_strings([rec], 150, 1, lookup_mode=True)
    vec = Vectorizer(device_batch=512)
    emb = vec.vectorize(win)
    reads, _, _, _ = simulate_reads(genome, 1000, 150, err=0.01, seed=11)
    qry = vec.vectorize(reads)
    return np.asarray(emb, np.float32), np.asarray(qry, np.float32)


def main():
    n_bp = int(sys.argv[1]) if len(sys.argv) > 1 else 50_000
    n_gauss = int(sys.argv[2]) if len(sys.argv) > 2 else 100_000
    rng = np.random.default_rng(0)
    res = {"n_bp": n_bp, "n_gauss": n_gauss, "datasets": {}}

    x, q = genome_embeddings(n_bp)
    res["datasets"]["genome"] = {"n": int(x.shape[0])}
    for mode in ("rng", "centroid"):
        tab, bs, lsz = recall_table(x, q, mode, efc=200)
        res["datasets"]["genome"][mode] = {
            "build_s": bs, "upper_level_sizes": lsz, "ef": tab,
        }

    g = rng.standard_normal((n_gauss, 128)).astype(np.float32)
    gq = g[rng.integers(0, n_gauss, 1000)] + 0.1 * rng.standard_normal(
        (1000, 128)
    ).astype(np.float32)
    res["datasets"]["gaussian"] = {"n": n_gauss}
    for mode in ("rng", "centroid"):
        tab, bs, lsz = recall_table(g, gq, mode, efc=200)
        res["datasets"]["gaussian"][mode] = {
            "build_s": bs, "upper_level_sizes": lsz, "ef": tab,
        }

    print(json.dumps(res))


if __name__ == "__main__":
    main()
