"""Genome-scale end-to-end demo: N-Mbp genome -> 2N M windows -> INT8FLAT
(or any --index-type) -> simulated reads, on one chip.

Reports build time, cold and steady-state search queries/s, and top-1
accuracy against the simulated truth (read start positions), exercising every
genome-scale path: native window packing, device tokenization,
device-resident quantized encode, int8 windowed scan search, dense passthrough
post-processing.  argv: [n_bp] [n_reads] [index_type].
"""

import os
import sys
import tempfile
import time

import numpy as np


def make_genome(n_bp: int, seed: int = 0) -> str:
    rng = np.random.default_rng(seed)
    return "".join(np.array(list("ACGT"))[rng.integers(0, 4, n_bp)])


def simulate_reads(genome: str, n_reads: int, read_len: int, err: float, seed: int = 1):
    """wgsim-style: uniform start, either strand, substitution errors."""
    comp = str.maketrans("ACGT", "TGCA")
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, len(genome) - read_len + 1, n_reads)
    strands = rng.integers(0, 2, n_reads)
    bases = np.array(list("ACGT"))
    reads, names = [], []
    for i, (s, st) in enumerate(zip(starts, strands)):
        r = genome[s : s + read_len]
        if st:
            r = r.translate(comp)[::-1]
        arr = np.array(list(r))
        mask = rng.random(read_len) < err
        arr[mask] = bases[rng.integers(0, 4, int(mask.sum()))]
        reads.append("".join(arr))
        names.append(f"_{s}_{int(st)}_{i}")
    return reads, names, starts, strands


def main():
    n_bp = int(sys.argv[1]) if len(sys.argv) > 1 else 1_000_000
    n_reads = int(sys.argv[2]) if len(sys.argv) > 2 else 10_000
    stride = int(sys.argv[4]) if len(sys.argv) > 4 else 1
    read_len = 150
    genome = make_genome(n_bp)
    reads, names, starts, strands = simulate_reads(genome, n_reads, read_len, err=0.01)

    with tempfile.TemporaryDirectory() as tmp:
        ref = os.path.join(tmp, "ref.fna")
        fq = os.path.join(tmp, "reads.fastq")
        with open(ref, "w") as f:
            f.write("> synthetic\n")
            for i in range(0, n_bp, 80):
                f.write(genome[i : i + 80] + "\n")
        with open(fq, "w") as f:
            for r, n in zip(reads, names):
                f.write(f"@{n}\n{r}\n+\n{'I'*read_len}\n")

        from deepreadmapper_tpu.pipeline.build import build_index
        from deepreadmapper_tpu.pipeline.search import run_pipeline

        prefix = os.path.join(tmp, "idx")
        index_type = sys.argv[3] if len(sys.argv) > 3 else "INT8FLAT"
        t0 = time.time()
        build_index(ref, prefix, read_len, stride=stride, index_type=index_type)
        t_build = time.time() - t0
        n_windows = 2 * ((n_bp - read_len) // stride + 1)
        print(f"build: {n_windows} windows in {t_build:.1f}s "
              f"({n_windows/t_build:.0f} windows/s)", flush=True)

        out = os.path.join(tmp, "out")
        t0 = time.time()
        res = run_pipeline(prefix, fq, ref, ef=128, k=16, output_dir=out,
                           write_sam=False)
        t_cold = time.time() - t0
        if stride > 1 and res.get("final_ids") is not None:
            # reranked dense ids (the sparse path's real output): id = 2*pos
            # + strand after expansion + exact re-embedding rerank
            fid = res["final_ids"][:, 0]
            racc = float(np.mean(
                (np.abs((fid // 2).astype(np.int64) - starts) <= 5)
                & ((fid % 2) == strands)
            ))
            print(f"top-1 after sparse rerank (pos within 5bp + strand): "
                  f"{racc:.4f}", flush=True)
        print(f"pipeline cold (incl. index upload + compiles): {t_cold:.1f}s "
              f"| embed {res['t_embed']:.1f}s search {res['t_search']:.1f}s "
              f"post {res['t_post']:.1f}s", flush=True)

        # steady-state serving: index resident on device, jits warm
        from deepreadmapper_tpu.index.registry import load_index
        from deepreadmapper_tpu.io.fastq import parse_fastq_bytes
        from deepreadmapper_tpu.models.encoder import Vectorizer

        engine, _cfg = load_index(prefix)
        mat, lengths, _ = parse_fastq_bytes(fq)
        vec = Vectorizer()
        emb = vec.vectorize_wrapped_bytes(mat, lengths)
        engine.search(emb, 16)  # warm (uploads index + compiles)
        t0 = time.time()
        emb = vec.vectorize_wrapped_bytes(mat, lengths)
        ids_w, _d = engine.search(emb, 16)
        t_warm = time.time() - t0
        print(f"steady-state embed+search: {n_reads} reads in {t_warm:.1f}s "
              f"({n_reads/t_warm:.0f} q/s)", flush=True)

        ids = np.load(os.path.join(out, "indices.npy"))
        # raw ANN rows: row = 2*window_index + strand; window position =
        # window_index * stride (dense: stride == 1)
        top_pos = (ids[:, 0] // 2) * stride
        top_strand = ids[:, 0] % 2
        tol = 5 + stride
        pos_ok = np.abs(top_pos.astype(np.int64) - starts) <= tol
        strand_ok = top_strand == strands
        acc = float((pos_ok & strand_ok).mean())
        print(f"top-1 accuracy (pos within {tol}bp + strand): {acc:.4f}",
              flush=True)

        if index_type == "PQFLAT" and stride == 1:
            # --dense-rerank: exact re-embedding rerank of the quantized
            # engine's candidates (recovers near-exact top-1 at 8 B/vector)
            out2 = os.path.join(tmp, "out_rr")
            t0 = time.time()
            run_pipeline(prefix, fq, ref, ef=128, k=16, output_dir=out2,
                         write_sam=False, dense_rerank=True)
            ids2 = np.load(os.path.join(out2, "indices.npy"))
            pos_ok2 = np.abs((ids2[:, 0] // 2).astype(np.int64) - starts) <= tol
            acc2 = float((pos_ok2 & (ids2[:, 0] % 2 == strands)).mean())
            print(f"top-1 with --dense-rerank: {acc2:.4f} "
                  f"(+{time.time()-t0:.1f}s incl. re-search)", flush=True)


if __name__ == "__main__":
    main()
