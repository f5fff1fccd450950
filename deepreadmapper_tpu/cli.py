"""Command-line entry points.

Four subcommands mirror the reference's four binaries:

  pipeline     <index_prefix> <query> <ref> [...]   (reference src/main.cpp)
  build-index  <ref> <index_prefix> <ref_len> [...] (src/hnswpq/index.cpp)
  inference    <seqs> <ref_len> [out.npy] [batch]   (src/inference/test_inference.cpp)
  gen-ref      -i input -l ref_len -s stride -o out (src/gen_ref.cpp)
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def _add_pipeline(sub):
    p = sub.add_parser("pipeline", help="full search pipeline")
    p.add_argument("index_prefix")
    p.add_argument("query_file")
    p.add_argument("ref_file")
    p.add_argument("ef", nargs="?", type=int, default=None)
    p.add_argument("k", nargs="?", type=int, default=None)
    p.add_argument("k_clusters", nargs="?", type=int, default=None)
    p.add_argument("output_dir", nargs="?", default=".")
    p.add_argument("use_dynamic", nargs="?", type=int, default=0)
    p.add_argument("use_streaming", nargs="?", type=int, default=0)
    p.add_argument("--no-sam", action="store_true")
    p.add_argument("--rerank", default="l2", choices=["l2", "sw"])
    p.add_argument("--cigar", action="store_true",
                   help="emit real SW-traceback CIGARs (soft clips + M/I/D) "
                        "and alignment-exact POS for primary SAM lines "
                        "(the reference writes a pseudo <len>M)")
    p.add_argument("--mapq", action="store_true",
                   help="real margin-based MAPQ on primary SAM lines "
                        "(best vs best-at-a-different-locus; repeats get "
                        "0, unique placements 60 — the reference "
                        "hardcodes 60)")
    p.add_argument("--long-reads", action="store_true",
                   help="map reads LONGER than the index window by "
                        "chunk->search->chain voting (the reference "
                        "truncates every read to ~121 bases); emits "
                        "chained read-START placements + support-based "
                        "distances")
    p.add_argument("--mapq-calibrated", action="store_true",
                   help="map the margin MAPQ through the empirically "
                        "fitted monotone calibration table "
                        "(scripts/eval_mapq_calibration.py) so "
                        "10^(-MAPQ/10) tracks observed mis-mapping "
                        "probability; the raw margin heuristic is "
                        "10-30x optimistic mid-range")
    p.add_argument("--lr-max-chunks", type=int, default=128,
                   help="--long-reads: max chunks (votes) per read; the "
                        "stride widens past half-window beyond "
                        "~(N/2)*ref_len read length — fewer chunks = "
                        "proportionally faster, voting needs a majority "
                        "not a density")
    p.add_argument("--qual", action="store_true",
                   help="emit real base qualities in the SAM QUAL column "
                        "(reversed with SEQ on real-CIGAR reverse lines; "
                        "the reference writes '*')")
    p.add_argument("--sort", action="store_true",
                   help="coordinate-sort the SAM (SO:coordinate, samtools "
                        "order) before returning")
    p.add_argument("--bam", action="store_true",
                   help="also write results.bam (BGZF-compressed binary "
                        "BAM; with --sort it is samtools-index-ready)")
    p.add_argument("--mark-duplicates", action="store_true",
                   help="mark PCR duplicates (FLAG 0x400, samtools "
                        "markdup rule: same RNAME/POS/strand[/TLEN]; "
                        "best MAPQ stays unmarked)")
    p.add_argument("--read-group", default=None, metavar="RG",
                   help="@RG header + RG:Z tag on every line; comma- or "
                        "tab-separated fields with a required ID: "
                        "(e.g. 'ID:run1,SM:sampleA,PL:ONT') — GATK-class "
                        "tools require read groups")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a jax profiler trace of the search stage "
                        "(view with tensorboard/xprof)")
    p.add_argument(
        "--dense-rerank", action="store_true",
        help="exactly re-rank ANN candidates even on a dense (stride=1) "
             "index; recovers near-exact top-1 on quantized engines (PQFLAT)",
    )
    p.add_argument("--distributed", action="store_true",
                   help="multi-host serving under jax.distributed: each "
                        "host loads ONLY its index shards, the search "
                        "merges across hosts, process 0 writes outputs; "
                        "run the same command on every host")
    p.add_argument("--weights", default=None, metavar="NPZ",
                   help="encoder weights npz for query embedding "
                        "(overrides the index-recorded encoder.npz; "
                        "default: index-matched weights if recorded, else "
                        "the shipped pretrained model)")
    p.add_argument("--paired2", default=None, metavar="R2_FASTQ",
                   help="paired-end mode: mate (R2) FASTQ; FR proper-pair "
                        "resolution, full paired SAM FLAG/RNEXT/PNEXT/"
                        "TLEN, pair-margin MAPQ (the reference maps every "
                        "read independently)")
    p.add_argument("--max-isize", type=int, default=1000,
                   help="paired-end: maximum outer insert size")
    p.add_argument("--min-isize", type=int, default=0,
                   help="paired-end: minimum outer insert size")
    p.add_argument("--paired-interleaved", action="store_true",
                   help="the query FASTQ holds interleaved R1/R2 records "
                        "(fastq-dump / trimmer output); split and map as "
                        "pairs")
    p.add_argument("--no-rescue", action="store_true",
                   help="paired-end: disable SW mate rescue (scanning the "
                        "expected mate interval next to an anchored end "
                        "when no proper pair exists)")


def _add_build(sub):
    p = sub.add_parser("build-index", help="build an index from a reference")
    p.add_argument("ref_file")
    p.add_argument("index_prefix")
    p.add_argument("ref_len", type=int)
    p.add_argument("stride", nargs="?", type=int, default=1)
    p.add_argument("M_pq", nargs="?", type=int, default=8)
    p.add_argument("nbits", nargs="?", type=int, default=8)
    p.add_argument("M_hnsw", nargs="?", type=int, default=16)
    p.add_argument("EFC", nargs="?", type=int, default=200)
    p.add_argument("--index-type", default="INT8FLAT",
                   help="INT8FLAT (production default: int8 exhaustive "
                        "scan, near-exact recall where HNSWPQ is capped by "
                        "PQ8; see scripts/eval_hnswpq.py) | FLAT | IVFINT8 "
                        "(cluster-pruned int8 scan, sub-linear — the "
                        ">100M-row tier; EF acts as nprobe) | IVFPQ "
                        "(cluster-pruned ADC scan over PQ codes: sub-"
                        "linear at 8-16 B/row — the >1B-row tier; EF "
                        "acts as nprobe, honors --opq) | PQFLAT "
                        "(16x less HBM) | HNSWPQ (reference-parity "
                        "engine) | HNSWFLAT")
    p.add_argument("--nlist", type=int, default=0,
                   help="IVFINT8/IVFPQ coarse clusters (0 = auto ~sqrt(N))")
    p.add_argument("--level-mode", default="rng", choices=["rng", "centroid"],
                   help="HNSW level assignment: seeded exponential RNG "
                        "(default) or hnswm's deterministic centroid-"
                        "partition medoids")
    p.add_argument("--build-mode", default="insert", choices=["insert", "knn"],
                   help="HNSW construction: incremental insert (default) or "
                        "the matmul kNN-graph builder")
    p.add_argument("--shards", type=int, default=1,
                   help="shard the index over N mesh positions "
                        "(multi-chip/multi-host serving)")
    p.add_argument("--distributed", action="store_true",
                   help="per-host sharded build under jax.distributed: "
                        "every process embeds + persists ONLY its own "
                        "shards (its genome slice); run the same command "
                        "on every host")
    p.add_argument("--opq", action="store_true",
                   help="learn an orthogonal rotation before PQ (FAISS "
                        "OPQMatrix analog; improves PQFLAT recall at the "
                        "same 8 B/vector)")
    p.add_argument("--resume", action="store_true",
                   help="crash-resumable streaming build: embedded code "
                        "chunks checkpoint to <prefix>/.build_cache/ and a "
                        "rerun skips everything already embedded (PQFLAT/"
                        "INT8FLAT/IVFINT8 from FASTA)")
    p.add_argument("--weights", default=None, metavar="NPZ",
                   help="fine-tuned encoder weights (finetune output); "
                        "copied into the index dir so pipeline "
                        "automatically embeds queries with the SAME "
                        "encoder that embedded the index")


def _add_serve(sub):
    p = sub.add_parser(
        "serve",
        help="serving daemon: load the index once, answer FASTQ->SAM "
             "requests over line-delimited JSON on stdin/stdout",
    )
    p.add_argument("index_prefix")
    p.add_argument("ref_file")
    p.add_argument("--ef", type=int, default=None)
    p.add_argument("--k", type=int, default=None)
    p.add_argument("--k-clusters", type=int, default=None)
    p.add_argument("--rerank", default="l2", choices=["l2", "sw"])
    p.add_argument("--dense-rerank", action="store_true")
    p.add_argument("--cigar", action="store_true")
    p.add_argument("--mapq", action="store_true")


def _add_info(sub):
    p = sub.add_parser(
        "info", help="inspect an index directory (no engine load)"
    )
    p.add_argument("index_prefix")


def _add_plan(sub):
    p = sub.add_parser(
        "plan",
        help="deployment sizing advisor: engine/stride/shard "
             "recommendations for a genome size + HBM budget",
    )
    p.add_argument("genome", help="reference FASTA path OR a base count "
                                  "like 3.1e9 / 3100000000")
    p.add_argument("ref_len", nargs="?", type=int, default=150)
    p.add_argument("--stride", type=int, default=0,
                   help="fix the stride (default: recommend one)")
    p.add_argument("--hbm-gb", type=float, default=60.0,
                   help="device memory per card for index residency "
                        "(an 80 GB H100 times JAX's 0.75 preallocation; "
                        "default 60)")


def _add_inference(sub):
    p = sub.add_parser("inference", help="embed sequences to npy")
    p.add_argument("input_file")
    p.add_argument("ref_len", type=int)
    p.add_argument("output", nargs="?", default="embeddings.npy")
    p.add_argument("batch_size", nargs="?", type=int, default=65536,
                   help="windows embedded per streamed chunk (the reference "
                        "test_inference.cpp:49 [batch_size] argv slot)")
    p.add_argument("--stride", type=int, default=1)
    p.add_argument("--weights", default=None, metavar="NPZ",
                   help="fine-tuned encoder weights npz (default: shipped "
                        "pretrained model)")


def _add_finetune(sub):
    p = sub.add_parser("finetune", help="fine-tune the encoder on a reference")
    p.add_argument("ref_file")
    p.add_argument("ref_len", type=int)
    p.add_argument("-o", "--output", default="finetuned.npz")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=512)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sub-rate", type=float, default=0.01,
                   help="substitution noise for simulated training reads; "
                        "match the expected read error rate")
    p.add_argument("--indel-rate", type=float, default=0.0,
                   help="insertion+deletion noise (each, per base) for "
                        "training reads; match long-read error profiles")
    p.add_argument("--max-shift", type=int, default=0,
                   help="offset training reads 0..N bases from their source "
                        "window (shift-matched tuning for sparse indexes: "
                        "use stride-1)")
    p.add_argument("--resume", default=None, metavar="NPZ",
                   help="resume from a previously saved weights npz "
                        "(checkpoint/continue fine-tuning)")
    p.add_argument("--state", default=None, metavar="NPZ",
                   help="full training-state checkpoint file (params + "
                        "optimizer moments + rng); loaded if it exists, "
                        "saved back after training — exact resume")


def _add_gen_ref(sub):
    p = sub.add_parser("gen-ref", help="dump windowed sequences to txt")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-l", "--ref-len", type=int, required=True)
    p.add_argument("-s", "--stride", type=int, default=1)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("-L", "--lookup", action="store_true",
                   help="no <...> wrapping (lookup mode)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="deepreadmapper_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)
    _add_pipeline(sub)
    _add_build(sub)
    _add_serve(sub)
    _add_info(sub)
    _add_plan(sub)
    _add_inference(sub)
    _add_finetune(sub)
    _add_gen_ref(sub)
    args = ap.parse_args(argv)
    if args.cmd in ("pipeline", "build-index", "serve", "inference",
                    "finetune"):
        from deepreadmapper_tpu.utils.compile_cache import (
            enable_compile_cache,
        )

        enable_compile_cache()

    if args.cmd == "pipeline":
        from deepreadmapper_tpu.pipeline.search import run_pipeline

        if args.read_group:
            # fail fast: a malformed read group would otherwise only raise
            # inside the SAM writer, AFTER the whole embed+search ran
            from deepreadmapper_tpu.io.sam import parse_read_group

            parse_read_group(args.read_group)

        if args.distributed:
            from deepreadmapper_tpu.parallel.distributed import (
                init_distributed,
            )

            init_distributed()
        vectorizer = None
        if args.weights:
            from deepreadmapper_tpu.models.encoder import (
                Vectorizer,
                load_params,
            )

            vectorizer = Vectorizer(load_params(args.weights))
        if args.paired_interleaved and not args.paired2:
            # split interleaved records into two temp FASTQs next to the
            # outputs (kept for provenance), then run the paired driver
            import os as _os

            from deepreadmapper_tpu.io.fileio import read_bytes

            data = read_bytes(args.query_file).split(b"\n")
            recs = [data[i: i + 4] for i in range(0, len(data) - 3, 4)]
            if len(recs) % 2:
                print("[MAIN] ERROR: interleaved FASTQ holds an odd "
                      "number of records")
                return 1
            _os.makedirs(args.output_dir, exist_ok=True)
            p1 = _os.path.join(args.output_dir, "_interleaved_R1.fastq")
            p2 = _os.path.join(args.output_dir, "_interleaved_R2.fastq")
            # under jax.distributed only process 0 writes the split (all
            # processes share output_dir on a common filesystem); a barrier
            # keeps the others from reading a half-written file
            import jax as _jax

            if _jax.process_index() == 0:
                with open(p1, "wb") as f1, open(p2, "wb") as f2:
                    for j, rec in enumerate(recs):
                        (f1 if j % 2 == 0 else f2).write(
                            b"\n".join(rec) + b"\n"
                        )
            if _jax.process_count() > 1:
                from jax.experimental import multihost_utils

                multihost_utils.sync_global_devices("interleave-split")
            args.paired2 = p2
            args.query_file = p1
        if args.paired2:
            from deepreadmapper_tpu.pipeline.search import run_pipeline_paired

            res = run_pipeline_paired(
                args.index_prefix,
                args.query_file,
                args.paired2,
                args.ref_file,
                ef=args.ef,
                k=args.k,
                k_clusters=args.k_clusters,
                output_dir=args.output_dir,
                rerank=args.rerank,
                dense_rerank=args.dense_rerank,
                write_sam=not args.no_sam,
                mapq=args.mapq,
                mapq_calibrated=args.mapq_calibrated,
                qual=args.qual,
                max_isize=args.max_isize,
                min_isize=args.min_isize,
                cigar=args.cigar,
                long_reads=args.long_reads,
                use_streaming=bool(args.use_streaming),
                sort=args.sort,
                bam=args.bam,
                mark_dups=args.mark_duplicates,
                read_group=args.read_group,
                rescue=not args.no_rescue,
                vectorizer=vectorizer,
            )
            print(
                f"[MAIN] {res['num_queries']} reads | "
                f"{res['n_proper']}/{res['num_pairs']} proper pairs | "
                f"embed {res['t_embed']:.2f}s | search {res['t_search']:.2f}s"
            )
            return 0
        res = run_pipeline(
            args.index_prefix,
            args.query_file,
            args.ref_file,
            vectorizer=vectorizer,
            ef=args.ef,
            k=args.k,
            k_clusters=args.k_clusters,
            output_dir=args.output_dir,
            use_dynamic=bool(args.use_dynamic),
            use_streaming=bool(args.use_streaming),
            rerank=args.rerank,
            dense_rerank=args.dense_rerank,
            write_sam=not args.no_sam,
            cigar=args.cigar,
            mapq=args.mapq,
            mapq_calibrated=args.mapq_calibrated,
            long_reads=args.long_reads,
            lr_max_chunks=args.lr_max_chunks,
            qual=args.qual,
            sort=args.sort,
            bam=args.bam,
            mark_dups=args.mark_duplicates,
            read_group=args.read_group,
            profile_dir=args.profile,
        )
        print(
            f"[MAIN] {res['num_queries']} queries | embed {res['t_embed']:.2f}s "
            f"| search {res['t_search']:.2f}s | post {res['t_post']:.2f}s"
        )
        return 0

    if args.cmd == "info":
        from deepreadmapper_tpu.io.configstore import load_config

        cfg_path = os.path.join(args.index_prefix, "config.txt")
        if not os.path.exists(cfg_path):
            print(f"[INFO] no config.txt under {args.index_prefix}")
            return 1
        config = load_config(cfg_path)
        for key, val in config.items():
            print(f"{key}: {val}")
        manifest = os.path.join(args.index_prefix, "sharded.txt")
        if os.path.exists(manifest):
            shard_ids = sorted(
                d for d in os.listdir(args.index_prefix)
                if d.startswith("shard_")
            )
            print(f"sharded: yes ({len(shard_ids)} shard dirs on disk)")
        total = 0
        for root, _dirs, files in os.walk(args.index_prefix):
            for fn in sorted(files):
                p = os.path.join(root, fn)
                sz = os.path.getsize(p)
                total += sz
                rel = os.path.relpath(p, args.index_prefix)
                print(f"file: {rel}  {sz/1e6:.2f} MB")
        print(f"disk_total_mb: {total/1e6:.2f}")
        nv = int(config.get("n_vects", 0))
        if nv:
            print(f"bytes_per_vector: {total/nv:.1f}")
        if config.get("weights"):
            print("encoder: index-matched fine-tuned weights (encoder.npz)")
        return 0

    if args.cmd == "plan":
        # Sizing heuristics: bytes/vector per engine (docs/DEPLOYMENT.md),
        # accuracy levers.
        if os.path.exists(args.genome):
            from deepreadmapper_tpu.utils.memory import estimate_window_count

            n_bases = os.path.getsize(args.genome)  # ~1 B/base incl headers
            dense = estimate_window_count(args.genome, args.ref_len, 1)
        else:
            n_bases = int(float(args.genome))
            dense = max(0, (n_bases - args.ref_len) + 1) * 2
        hbm = args.hbm_gb * 1e9
        stride = args.stride or (1 if dense * 128 <= hbm else 4)
        nv = dense // stride
        print(f"genome: ~{n_bases/1e6:.1f} Mbp -> {nv} vectors at "
              f"stride {stride} (both strands)")
        engines = [
            ("INT8FLAT", nv * 128, "near-exact (0.995+ recall@10)"),
            ("IVFINT8", int(nv * 128 / 0.8),
             "sub-linear scan; the >100M-row tier (EF = nprobe)"),
            ("PQFLAT+OPQ", nv * 8 + 2 ** 8 * 128 * 4,
             "16x less HBM; 0.96-0.99 raw top-1 with rerank"),
            ("PQFLAT16+OPQ", nv * 16 + 2 ** 8 * 128 * 4,
             "0.989 raw at 16 B/vector"),
            ("FLAT", nv * 128 * 4, "exact fp32 oracle (small refs only)"),
        ]
        print(f"{'engine':<14}{'index':>10}  {'chips':>5}  notes")
        for name, nbytes, note in engines:
            shards = max(1, -(-nbytes // int(hbm)))
            print(f"{name:<14}{nbytes/1e9:>9.2f}G  {shards:>5}  {note}")
        print(
            "recommend: "
            + (
                "INT8FLAT, 1 chip"
                if nv * 128 <= hbm
                else f"INT8FLAT over --shards {-(-nv * 128 // int(hbm))} "
                     f"(or PQFLAT+OPQ on "
                     f"{max(1, -(-(nv * 8) // int(hbm)))} chip(s) at 8 B/vec)"
            )
        )
        if stride > 1:
            print(
                f"stride {stride} halves nothing for free: run finetune "
                f"--max-shift {stride - 1} first (sparse top-1 0.81 -> "
                "0.995 measured at 46 Mbp), then build with "
                "--weights tuned.npz"
            )
        print("long reads: add pipeline --long-reads (chunk+chain); "
              "crash safety: build-index --resume")
        return 0

    if args.cmd == "serve":
        from deepreadmapper_tpu.pipeline.serve import serve

        defaults = {
            k: v
            for k, v in {
                "ef": args.ef,
                "k": args.k,
                "k_clusters": args.k_clusters,
                "rerank": args.rerank,
                "dense_rerank": args.dense_rerank,
                "cigar": args.cigar,
                "mapq": args.mapq,
            }.items()
            if v not in (None, False)
        }
        n = serve(args.index_prefix, args.ref_file, defaults=defaults)
        print(f"[SERVE] answered {n} requests", file=sys.stderr)
        return 0

    if args.cmd == "build-index":
        from deepreadmapper_tpu.config import BuildConfig
        from deepreadmapper_tpu.pipeline.build import build_index

        cfg = BuildConfig(
            stride=args.stride,
            m_pq=args.M_pq,
            nbits=args.nbits,
            m_hnsw=args.M_hnsw,
            efc=args.EFC,
            build_mode=args.build_mode,
            opq=args.opq,
            nlist=args.nlist,
            level_mode=args.level_mode,
        )
        if args.distributed:
            from deepreadmapper_tpu.parallel.distributed import (
                init_distributed,
            )
            from deepreadmapper_tpu.pipeline.build import (
                build_index_distributed,
            )

            init_distributed()
            config = build_index_distributed(
                args.ref_file,
                args.index_prefix,
                args.ref_len,
                stride=args.stride,
                index_type=args.index_type,
                build_cfg=cfg,
                n_shards=args.shards,
                weights=args.weights,
            )
        else:
            config = build_index(
                args.ref_file,
                args.index_prefix,
                args.ref_len,
                stride=args.stride,
                index_type=args.index_type,
                build_cfg=cfg,
                n_shards=args.shards,
                resume=args.resume,
                weights=args.weights,
            )
        print(f"[BUILD INDEX] saved {config['n_vects']} vectors to {args.index_prefix}")
        return 0

    if args.cmd == "inference":
        from deepreadmapper_tpu.io.readers import FASTA_EXTS, FASTQ_EXTS
        from deepreadmapper_tpu.models.encoder import Vectorizer
        from deepreadmapper_tpu.pipeline.build import (
            embed_input_file,
            stream_embed_fasta_to_npy,
            stream_embed_seqs_to_npy,
        )

        if args.weights:
            from deepreadmapper_tpu.models.encoder import load_params

            vec = Vectorizer(load_params(args.weights))
        else:
            vec = Vectorizer()
        from deepreadmapper_tpu.io.fileio import true_ext

        ext = true_ext(args.input_file)
        if ext in FASTA_EXTS:
            # Streamed: bounded memory for genome-scale inputs.
            n = stream_embed_fasta_to_npy(
                args.input_file, args.output, args.ref_len, args.stride,
                vec, window_chunk=args.batch_size,
            )
            print(f"[INFERENCE] streamed ({n}, 128) to {args.output}")
            return 0
        if ext in FASTQ_EXTS or ext == ".txt":
            # Read files honor [batch_size] too (test_inference.cpp:49):
            # embedding temporaries + npy write cadence stay bounded.
            n = stream_embed_seqs_to_npy(
                args.input_file, args.output, vec,
                batch=args.batch_size,
            )
            print(f"[INFERENCE] streamed ({n}, 128) to {args.output}")
            return 0
        emb = embed_input_file(args.input_file, args.ref_len, args.stride, vec)
        np.save(args.output, emb)
        print(f"[INFERENCE] wrote {emb.shape} to {args.output}")
        return 0

    if args.cmd == "finetune":
        from deepreadmapper_tpu.pipeline.finetune import finetune, save_params_npz

        start_params = None
        if args.resume:
            from deepreadmapper_tpu.models.encoder import load_params

            start_params = load_params(args.resume)
        params, losses = finetune(
            args.ref_file, args.ref_len, steps=args.steps, batch=args.batch,
            lr=args.lr, seed=args.seed, sub_rate=args.sub_rate,
            max_shift=args.max_shift,
            indel_rate=args.indel_rate,
            params=start_params, state_path=args.state,
        )
        save_params_npz(params, args.output)
        print(
            f"[FINETUNE] {args.steps} steps, loss {losses[0]:.4f} -> "
            f"{losses[-1]:.4f}, saved {args.output}"
        )
        return 0

    if args.cmd == "gen-ref":
        from deepreadmapper_tpu.io.fasta import parse_fasta_records, windows_as_strings

        records = parse_fasta_records(args.input)
        seqs, _ = windows_as_strings(
            records, args.ref_len, args.stride, lookup_mode=args.lookup
        )
        with open(args.output, "w") as f:
            for s in seqs:
                f.write(s + "\n")
        print(f"[GEN-REF] wrote {len(seqs)} windows to {args.output}")
        return 0

    return 1


if __name__ == "__main__":
    sys.exit(main())
