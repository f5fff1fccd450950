"""End-to-end search pipeline (reference: src/main.cpp).

index load -> query load/embed -> ANN search -> post-process -> outputs
(indices.npy / distances.npy hold the RAW ANN results exactly like the
reference, main.cpp:377-384; SAM holds the reranked candidates).
"""

from __future__ import annotations

import os
import time

import numpy as np

from deepreadmapper_tpu import tokenizer as tok
from deepreadmapper_tpu.config import SearchConfig
from deepreadmapper_tpu.index.registry import load_index
from deepreadmapper_tpu.io import fasta as fasta_io
from deepreadmapper_tpu.io import sam as sam_io
from deepreadmapper_tpu.io.fastq import parse_fastq_bytes
from deepreadmapper_tpu.io.readers import FASTA_EXTS, FASTQ_EXTS, read_txt
from deepreadmapper_tpu.io.results import load_embeddings_npy, save_results
from deepreadmapper_tpu.models.encoder import Vectorizer
from deepreadmapper_tpu.pipeline import postprocess as pp


def _load_queries(path: str, vectorizer: Vectorizer, embed: bool = True):
    """Returns (embeddings, wrapped query seqs or None, query ids).

    embed=False skips the encoder pass entirely (long-read requests embed
    CHUNKS, not whole reads — a whole-read embedding would only cover the
    first ~121 bases and then be thrown away)."""
    from deepreadmapper_tpu.io.fileio import true_ext

    ext = true_ext(path)
    if ext == ".npy":
        return load_embeddings_npy(path), None, []
    if ext in FASTQ_EXTS:
        if not embed:
            from deepreadmapper_tpu.io.fastq import parse_fastq

            seqs, ids = parse_fastq(path)
            return None, seqs, ids
        mat, lengths, ids = parse_fastq_bytes(path)
        if vectorizer.max_len == tok.MAX_LEN:
            # 2-bit packed upload + on-device tokenization (tokenizer_device):
            # ~5x less host->device traffic than uint16 token uploads.  The
            # device tokenizer hardcodes the 123-token wire format, so any
            # non-default max_len falls back to host tokenization.
            emb = vectorizer.vectorize_wrapped_bytes(mat, lengths)
        else:
            tokens = tok.tokenize_bytes_fast(mat, lengths, vectorizer.max_len)
            emb = vectorizer.vectorize_tokens(tokens)
        seqs = [bytes(row[: int(n)]).decode() for row, n in zip(mat, lengths)]
        return emb, seqs, ids
    if ext in FASTA_EXTS or ext == ".txt":
        if ext == ".txt":
            seqs = read_txt(path)
        else:
            records = fasta_io.parse_fasta_records(path)
            seqs = ["".join(r.tobytes().decode()) for r in records]
        if not embed:
            return None, seqs, []
        emb = vectorizer.vectorize(seqs)
        return emb, seqs, []
    raise ValueError(f"Unsupported query input: {path}")


def _primary_alignment_cigars(
    query_seqs, primary_ids, genome, ref_len, multi, dense_off, base_off
):
    """Real SW-traceback CIGARs (native) for each query's primary hit, in
    REFERENCE orientation: reverse-strand alignments reverse their op runs
    and swap soft clips, and the returned pos_off shifts the SAM POS to the
    alignment's leftmost reference base.  Returns (cigars [Q], pos_off [Q],
    tags [Q] — preformatted "\tNM:i:..\tMD:Z:..\tAS:i:.." suffixes from
    io.sam.alignment_tags) or (None, None, None) when the native library
    is unavailable."""
    import re

    from deepreadmapper_tpu import native
    from deepreadmapper_tpu.io.sam import alignment_tags
    from deepreadmapper_tpu.tokenizer import strings_to_bytes

    if not native.available():
        print("[MAIN] WARNING: --cigar needs the native library; skipping")
        return None, None, None
    ids = np.asarray(primary_ids, np.int64)
    fetch_ids = (
        fasta_io.translate_window_ids(ids, dense_off, base_off)
        if multi
        else ids
    )
    w_mat, w_lens = fasta_io.fetch_windows_by_id(
        genome, np.maximum(fetch_ids, 0), ref_len, max_len=ref_len, wrap=False
    )
    reads = [
        q[1:-1] if q.startswith("<") and q.endswith(">") else q
        for q in query_seqs
    ]
    a_mat, a_lens = strings_to_bytes(reads)
    _, a_span, b_span, cigs = native.sw_cigar(a_mat, a_lens, w_mat, w_lens)
    cigars: list[str] = []
    tags: list[str] = []
    pos_off = np.zeros(len(reads), np.int64)
    run_re = re.compile(r"(\d+)([MID])")
    for i in range(len(reads)):
        body = cigs[i]
        if not body or ids[i] < 0:
            cigars.append("")  # overflow / invalid -> pseudo CIGAR
            tags.append("")
            continue
        alen = int(a_lens[i])
        a0, a1 = int(a_span[i, 0]), int(a_span[i, 1])
        b0, b1 = int(b_span[i, 0]), int(b_span[i, 1])
        runs = [(int(n), op) for n, op in run_re.findall(body)]
        # NM/MD/AS from the native-orientation alignment; reverse-strand MD
        # re-expresses in forward-reference orientation inside the helper
        nm, md, as_ = alignment_tags(
            a_mat[i], w_mat[i], a0, b0, runs, reverse=bool(ids[i] & 1)
        )
        tags.append(f"\tNM:i:{nm}\tMD:Z:{md}\tAS:i:{as_}")
        if ids[i] & 1:  # reverse strand: reference orientation reverses ops
            body = "".join(f"{n}{op}" for n, op in reversed(runs))
            left, right = alen - a1, a0
            pos_off[i] = ref_len - b1
        else:
            left, right = a0, alen - a1
            pos_off[i] = b0
        cig = (f"{left}S" if left else "") + body + (f"{right}S" if right else "")
        cigars.append(cig)
    return cigars, pos_off, tags


# Empirical MAPQ recalibration: raw margin-quality bin -> observed
# mis-mapping rate, measured by scripts/eval_mapq_calibration.py on the
# hard synthetic (tandem arrays 5% + dispersed 1%-divergent repeat
# families 8%, read err 1%, INT8FLAT, 2 Mbp, seeds 0 fit / 1 validate).
# The margin heuristic is systematically optimistic mid-range (observed
# error 10-30x the 10^(-q/10) prediction at raw 20-40); this monotone
# (PAVA-pooled) table maps raw bins to -10*log10(observed error), so the
# REPORTED MAPQ means what SAM consumers assume.  Raw 60 ("no competitor
# in the candidate list") keeps a residual error floor from search
# misses, so even calibrated MAPQ caps well below 60 on hard genomes —
# an honest ceiling, vs the reference's hardcoded 60 (utils.cpp:373).
# Keys: raw bin lower edges; values: calibrated MAPQ for the bin.
_MAPQ_CAL_BINS = np.array([0, 1, 10, 20, 30, 40, 50, 60], np.int32)
_MAPQ_CAL_VALS = np.array([0, 3, 5, 12, 19, 19, 24, 24], np.int32)


def calibrate_mapq(q_raw: np.ndarray) -> np.ndarray:
    """Map raw margin MAPQ through the empirically fitted monotone table
    (see _MAPQ_CAL_BINS).  Within-bin interpolation keeps the ordering of
    raw values (ties in the table still rank by raw margin)."""
    q = np.asarray(q_raw, np.float64)
    idx = np.clip(
        np.searchsorted(_MAPQ_CAL_BINS, q, side="right") - 1, 0,
        len(_MAPQ_CAL_BINS) - 1,
    )
    lo_b = _MAPQ_CAL_BINS[idx].astype(np.float64)
    hi_b = np.concatenate([_MAPQ_CAL_BINS[1:], [61]])[idx].astype(np.float64)
    lo_v = _MAPQ_CAL_VALS[idx].astype(np.float64)
    hi_v = np.concatenate([_MAPQ_CAL_VALS[1:], [_MAPQ_CAL_VALS[-1] + 1]])[
        idx
    ].astype(np.float64)
    frac = np.where(hi_b > lo_b, (q - lo_b) / (hi_b - lo_b), 0.0)
    return np.clip(np.rint(lo_v + frac * (hi_v - lo_v)), 0, 60).astype(
        np.int32
    )


def compute_mapq(
    ids: np.ndarray,
    vals: np.ndarray,
    ref_len: int,
    higher_is_better: bool = False,
    dense_off: np.ndarray | None = None,
) -> np.ndarray:
    """Margin-based mapping quality for each query's PRIMARY candidate.

    The reference hardcodes MAPQ 60 (utils.cpp:373); downstream SAM
    consumers (variant callers, IGV filters) actually use MAPQ, so this
    computes the standard uniqueness heuristic: how much better the best
    placement scores than the best placement at a DIFFERENT locus.
    "Same locus" = same strand, same record, position within ref_len of
    the primary (overlapping windows of one alignment) — an
    opposite-strand hit at the same spot or a hit just across a record
    boundary is a genuinely different placement and stays a competitor.

    dense_off (multi-record references): per-record cumulative window
    offsets, so adjacency in global dense-id space across a chromosome
    boundary is not mistaken for the same locus.

    mapq = round(60 * relative margin), clipped to [0, 60]; 60 when no
    competing locus appears in the candidate list; 0 for an exact tie
    (a true repeat) or an invalid (-1) primary."""
    ids = np.asarray(ids, np.int64)
    vals = np.asarray(vals, np.float64)
    nq, k = ids.shape
    out = np.full(nq, 60, np.int32)
    if k < 2:
        out[ids[:, 0] < 0] = 0
        return out
    pos = ids >> 1
    same_locus = (np.abs(pos - pos[:, :1]) <= ref_len) & (
        (ids & 1) == (ids[:, :1] & 1)
    )
    if dense_off is not None:
        rec = np.searchsorted(dense_off, pos, side="right") - 1
        same_locus &= rec == rec[:, :1]
    competitor = ~same_locus & (ids >= 0)
    has = competitor.any(axis=1)
    j2 = np.argmax(competitor, axis=1)
    best = vals[:, 0]
    second = vals[np.arange(nq), j2]
    if higher_is_better:
        margin = best - second
        scale = np.maximum(np.abs(best), 1e-9)
    else:
        margin = second - best
        scale = np.maximum(np.abs(second), 1e-9)
    q = np.clip(np.rint(60.0 * margin / scale), 0, 60).astype(np.int32)
    out[has] = q[has]
    out[ids[:, 0] < 0] = 0
    return out


def vectorizer_for_index(
    index_prefix: str, config: dict, vectorizer: Vectorizer | None = None
) -> Vectorizer:
    """The encoder that must embed queries against this index: an explicit
    vectorizer wins; else the index-recorded fine-tuned weights (build-index
    --weights copies them to <prefix>/encoder.npz — a mismatched encoder
    silently destroys accuracy); else the shipped pretrained model."""
    if vectorizer is None and config.get("weights"):
        from deepreadmapper_tpu.models.encoder import load_params

        wpath = os.path.join(index_prefix, str(config["weights"]))
        print(f"[MAIN] using index-matched encoder weights: {wpath}")
        return Vectorizer(load_params(wpath))
    return vectorizer or Vectorizer()


def run_pipeline(
    index_prefix: str,
    query_file: str,
    ref_file: str,
    ef: int | None = None,
    k: int | None = None,
    k_clusters: int | None = None,
    output_dir: str = ".",
    use_dynamic: bool = False,
    use_streaming: bool = False,
    rerank: str = "l2",
    dense_rerank: bool = False,
    write_sam: bool = True,
    cigar: bool = False,
    mapq: bool = False,
    mapq_calibrated: bool = False,
    long_reads: bool = False,
    lr_max_chunks: int = 128,
    qual: bool = False,
    sort: bool = False,
    bam: bool = False,
    mark_dups: bool = False,
    read_group: str | None = None,
    profile_dir: str | None = None,
    vectorizer: Vectorizer | None = None,
    search_cfg: SearchConfig | None = None,
    preloaded: tuple | None = None,
    search_stats: dict | None = None,
) -> dict:
    """Run the full pipeline; returns a timing/result summary dict.

    dense_rerank=True re-embeds and exactly reranks the ANN candidates even
    on a dense (stride == 1) index — beyond the reference's passthrough;
    restores near-exact top-1 on quantized-metric engines (PQFLAT).  NOTE:
    the saved distances then follow the reranker's sqrt-L2 convention
    (reference reranker.cpp:147-166) instead of the engines' squared L2.
    The flag needs query SEQUENCES (not precomputed .npy embeddings) and the
    L2 reranker; incompatible combinations warn and fall back.

    preloaded=(engine, config) skips the index load — the serving daemon
    (pipeline.serve) keeps one resident engine (and its compiled search)
    across requests."""
    scfg = search_cfg or SearchConfig()
    ef = ef if ef is not None else scfg.ef
    k = k if k is not None else scfg.k

    t0 = time.time()
    engine, config = preloaded if preloaded else load_index(index_prefix)
    ref_len = int(config["ref_len"])
    stride = int(config["stride"])
    # K_clusters handling mirrors main.cpp:55-63.
    if stride == 1:
        k_clusters = k
    elif k_clusters is None:
        k_clusters = scfg.k_clusters
    t_index = time.time() - t0

    vectorizer = vectorizer_for_index(index_prefix, config, vectorizer)
    t0 = time.time()
    query_emb, query_seqs, query_ids = _load_queries(
        query_file, vectorizer, embed=not long_reads
    )
    t_embed = time.time() - t0

    t0 = time.time()
    if long_reads:
        # the chunk->search->chain path below issues its own (bigger)
        # search batch; the whole-read embedding/search would only see the
        # first ~121 bases (the reference's truncation, preprocess.cpp)
        neighbors = distances = None
    elif profile_dir:
        # jax profiler trace around the hot stage (host + device timelines;
        # view with tensorboard or xprof).  Device events may be missing on
        # remote-plugin backends -- the host trace still captures dispatch.
        import jax

        with jax.profiler.trace(profile_dir):
            neighbors, distances = engine.search(query_emb, k_clusters, ef)
    elif search_stats is not None:
        # search-effort counters (nprobe/ef tuning): only the IVF engines
        # expose them; others answer without stats
        try:
            neighbors, distances = engine.search(
                query_emb, k_clusters, ef, stats=search_stats
            )
        except TypeError:
            neighbors, distances = engine.search(query_emb, k_clusters, ef)
    else:
        neighbors, distances = engine.search(query_emb, k_clusters, ef)
    t_search = time.time() - t0

    # Under jax.distributed every process runs the identical pipeline
    # (replicated reads, SPMD sharded search); only process 0 touches the
    # output files so hosts on a shared filesystem don't race.  write_sam
    # keeps its USER-INTENT role for control flow (the streaming fallback
    # below) — non-main hosts must still stream per batch, they just skip
    # the file writes.
    import jax as _jax

    is_main = _jax.process_index() == 0
    sam_out = write_sam and is_main
    os.makedirs(output_dir, exist_ok=True)
    sam_file = os.path.join(output_dir, "results.sam")
    have_seqs = query_seqs is not None

    t0 = time.time()
    final_ids = None
    final_d = None
    if use_streaming and not write_sam:
        # streaming exists to bound SAM memory; without SAM it would rerank
        # per batch and emit nothing at all
        print(
            "[MAIN] WARNING: use_streaming without SAM output has nothing to "
            "stream; falling back to the non-streaming path"
        )
        use_streaming = False
    if cigar and not have_seqs:
        print(
            "[MAIN] WARNING: --cigar ignored (precomputed query embeddings "
            "carry no sequences to align)"
        )
        cigar = False
    if mapq and not have_seqs:
        print(
            "[MAIN] WARNING: --mapq ignored (no SAM output without query "
            "sequences)"
        )
        mapq = False
    if long_reads:
        if not have_seqs:
            raise ValueError(
                "--long-reads needs query SEQUENCES (precomputed embeddings "
                "only cover the first ~121 bases of each read)"
            )
        if cigar:
            from deepreadmapper_tpu import native as _native

            if not _native.available():
                print(
                    "[MAIN] WARNING: --cigar needs the native library "
                    "(banded long-read aligner); skipping"
                )
                cigar = False
        if use_streaming:
            print(
                "[MAIN] WARNING: use_streaming ignored with --long-reads"
            )
            use_streaming = False
        if rerank == "sw":
            print(
                "[MAIN] WARNING: --rerank sw ignored with --long-reads "
                "(placements are chunk-support chains, not SW-reranked)"
            )
            rerank = "l2"
        if dense_rerank:
            print(
                "[MAIN] WARNING: --dense-rerank ignored with --long-reads"
            )
            dense_rerank = False
        # support-margin MAPQ is intrinsic to chain voting — long-read
        # primaries and their supplementaries always score on that scale
        # (the parity constant 60 would mix semantics within one read)
        mapq = True
    if dense_rerank and stride == 1 and (not have_seqs or rerank == "sw"):
        print(
            "[MAIN] WARNING: --dense-rerank ignored ("
            + ("precomputed query embeddings carry no sequences"
               if not have_seqs else "SW rerank already reranks at stride 1")
            + "); saving raw ANN results"
        )
    quals = None
    if qual:
        from deepreadmapper_tpu.io.fileio import true_ext as _te

        if have_seqs and _te(query_file) in FASTQ_EXTS:
            # real base qualities in QUAL (the reference drops them and
            # writes '*'); loaded in a separate pass off the hot path
            from deepreadmapper_tpu.io.fastq import parse_fastq_quals

            quals = parse_fastq_quals(query_file)
        else:
            print("[MAIN] WARNING: --qual needs FASTQ queries; ignored")
    # @PG provenance for every SAM header (standard practice; the
    # reference emits none)
    pg = (
        f"pipeline {index_prefix} {query_file} ef={ef} k={k}"
        f" k_clusters={k_clusters} rerank={rerank}"
        + (" dense_rerank" if dense_rerank else "")
        + (" cigar" if cigar else "")
        + (" mapq" if mapq else "")
        + (" long_reads" if long_reads else "")
    )
    records = None
    if have_seqs:
        records = fasta_io.parse_fasta_records(ref_file)
        multi = len(records) > 1
        if multi and use_dynamic:
            print(
                "[MAIN] WARNING: use_dynamic has no separate meaning for "
                "multi-record references; using record-aware static handling"
            )
        if multi:
            # Multi-chromosome reference: window ids are per-record
            # cumulative WINDOW counts while fetches address the
            # concatenated BASE stream, so candidate ids translate through
            # per-record tables (and never expand across record
            # boundaries).  The reference's dynamic loader concatenates the
            # raw file after line 1 — header characters leak into its
            # stream and record arithmetic breaks; divergence documented.
            genome = np.concatenate(records)
            dense_off, base_off = fasta_io.record_window_table(
                records, ref_len, 1
            )
            sparse_off, _ = fasta_io.record_window_table(
                records, ref_len, stride
            )
            bound = 2 * int(dense_off[-1])
            rec_names = fasta_io.parse_fasta_names(ref_file)
            rec_lens = [int(len(r)) for r in records]
        else:
            # single record: its cleaned bytes ARE the reference stream (no
            # second file parse); headerless/.txt refs keep the reference's
            # skip-first-line loader
            genome = (
                records[0]
                if len(records) == 1
                else fasta_io.extract_fasta_sequence(ref_file)
            )
            dense_off = sparse_off = base_off = None
            rec_names = rec_lens = None
            if use_dynamic:
                bound = int(genome.size)
            else:
                # Static mode bound = number of dense windows x 2 strands
                # (main.cpp:190 loads the stride-1 window list).
                bound = 2 * max(0, int(genome.size) - ref_len + 1)

        from deepreadmapper_tpu import native

        def embed_windows(unique_ids: np.ndarray) -> np.ndarray:
            if multi:
                unique_ids = fasta_io.translate_window_ids(
                    unique_ids, dense_off, base_off
                )
            # Candidates are re-embedded WRAPPED — the same embedding space
            # the index was built in.  The reference re-embeds the UNWRAPPED
            # lookup windows (post_processor.cpp:659-684 on the lookup-mode
            # ref of main.cpp:190), a space mismatch measured to cost ~14
            # points of top-1 accuracy at stride 4 (80.4% -> 94.0% on a 2 Mbp
            # simulation); a deliberate divergence.
            if native.available() and vectorizer.max_len == tok.MAX_LEN:
                # 48 B/candidate wire upload + on-device tokenization; the
                # pool embeddings stay ON DEVICE for the rerank (no host
                # round-trip of 512 B per candidate).
                wire = native.pack_windows_by_id(genome, ref_len, unique_ids)
                return vectorizer.vectorize_wire(wire, device_out=True)
            if native.available():
                tokens = native.tokenize_windows_by_id(
                    genome, ref_len, unique_ids, wrap=True,
                    max_len=vectorizer.max_len,
                )
            else:
                mat, lengths = fasta_io.fetch_windows_by_id(
                    genome, unique_ids, ref_len, vectorizer.max_len, wrap=True
                )
                tokens = tok.tokenize_bytes_fast(mat, lengths, vectorizer.max_len)
            return vectorizer.vectorize_tokens(tokens, device_out=True)

        if long_reads:
            # chunk -> search -> chain (pipeline/longread.py): every read
            # is cut into ref_len windows at half-window stride, chunks
            # search as one big batch, per-chunk hits vote for a
            # consistent (strand, read-start) placement.  Chained ids are
            # already dense read-START window ids — no expansion/rerank.
            from deepreadmapper_tpu.pipeline import longread as lr_mod

            clean = [sam_io._clean_query(q) for q in query_seqs]
            if multi:
                def ids_to_base(w):
                    r, loc = fasta_io.record_of(w, sparse_off)
                    return base_off[r] + loc * stride

                def base_to_dense(s, rev):
                    r = np.clip(
                        np.searchsorted(base_off, s, side="right") - 1,
                        0, len(base_off) - 2,
                    )
                    loc = np.clip(
                        s - base_off[r], 0,
                        dense_off[r + 1] - dense_off[r] - 1,
                    )
                    return 2 * (dense_off[r] + loc) + rev
            else:
                n_dense = max(1, int(genome.size) - ref_len + 1)

                def ids_to_base(w):
                    return w * stride

                def base_to_dense(s, rev):
                    return 2 * np.minimum(s, n_dense - 1) + rev

            t1 = time.time()
            lr_timings: dict = {}
            final_ids, final_d, lr_mapq, lr_supp = lr_mod.map_long_reads(
                clean, vectorizer, engine, ref_len, k, ef, stride=stride,
                ids_to_base=ids_to_base, base_to_dense=base_to_dense,
                timings=lr_timings, max_chunks=lr_max_chunks,
            )
            t_search = time.time() - t1
            if lr_supp:
                print(
                    f"[MAIN] split-read: {len(lr_supp)} reads carry "
                    "supplementary (FLAG 2048) segments"
                )
            if sam_out:
                pc = po = pt = None
                if cigar:
                    # real long-read CIGARs: banded native alignment along
                    # the chained diagonal (band = one window length)
                    pc, po, pt = lr_mod.banded_primary_cigars(
                        clean, final_ids[:, 0], genome, band=ref_len,
                        dense_off=dense_off if multi else None,
                        base_off=base_off if multi else None,
                    )
                sam_io.write_sam(
                    query_seqs, query_ids, final_ids.ravel(), "ref", ref_len,
                    k, sam_file, record_names=rec_names,
                    record_lens=rec_lens, dense_off=dense_off,
                    mapq=lr_mapq if mapq else None,
                    supplementary=lr_supp, pg=pg, quals=quals,
                    primary_cigars=pc, primary_pos_off=po, primary_tags=pt,
                    rg=read_group,
                )
        elif rerank == "sw":
            # SW rerank path (reference post_process_sw_*, plumbed but
            # disabled in the reference's main; first-class here).
            from deepreadmapper_tpu.tokenizer import strings_to_bytes

            q_mat, q_lens = strings_to_bytes(query_seqs)

            def fetch_windows(ids: np.ndarray):
                if multi:
                    ids = fasta_io.translate_window_ids(
                        ids, dense_off, base_off
                    )
                return fasta_io.fetch_windows_by_id(
                    genome, ids, ref_len, max_len=ref_len, wrap=False
                )

            final_ids, final_scores = pp.post_process_sw(
                neighbors, q_mat, q_lens, fetch_windows, stride, k,
                k_clusters, bound, sparse_off=sparse_off, dense_off=dense_off,
            )
            final_d = final_scores  # SW scores (descending-better)
            if sam_out:
                mq = (
                    compute_mapq(
                        final_ids, final_scores, ref_len,
                        higher_is_better=True, dense_off=dense_off,
                    )
                    if mapq
                    else None
                )
                sam_io.write_sam(
                    query_seqs, query_ids, final_ids.ravel(), "ref", ref_len,
                    k, sam_file, record_names=rec_names,
                    record_lens=rec_lens, dense_off=dense_off, mapq=mq,
                    pg=pg, quals=quals, rg=read_group,
                )
        elif use_streaming:
            from deepreadmapper_tpu.utils.progress import Progress

            bs = scfg.query_batch_size
            nq = query_emb.shape[0]
            sprog = Progress(nq, "[MAIN] rerank+SAM reads")
            for start in range(0, nq, bs):
                end = min(start + bs, nq)
                ids_b, d_b = pp.post_process_l2(
                    neighbors[start:end],
                    distances[start:end],
                    query_emb[start:end],
                    embed_windows,
                    stride,
                    k,
                    k_clusters,
                    bound,
                    force_rerank=dense_rerank,
                    sparse_off=sparse_off,
                    dense_off=dense_off,
                )
                if sam_out:
                    pc = po = mq = pt = None
                    if cigar:
                        pc_b, po_b, pt_b = _primary_alignment_cigars(
                            query_seqs[start:end], ids_b[:, 0], genome,
                            ref_len, multi, dense_off, base_off,
                        )
                        if pc_b is not None:
                            # per-batch lists are indexed by the GLOBAL query
                            # number inside format_sam_records
                            pc = [""] * start + pc_b
                            pt = [""] * start + pt_b
                            po = np.concatenate(
                                [np.zeros(start, np.int64), po_b]
                            )
                    if mapq:
                        # global-query indexing, like primary_cigars above
                        mq = np.concatenate([
                            np.zeros(start, np.int32),
                            compute_mapq(ids_b, d_b, ref_len, dense_off=dense_off),
                        ])
                    sam_io.write_sam(
                        query_seqs[start:end],
                        query_ids,
                        ids_b.ravel(),
                        "ref",
                        ref_len,
                        k,
                        sam_file,
                        append=start > 0,
                        write_header=start == 0,
                        query_offset=start,
                        record_names=rec_names,
                        record_lens=rec_lens,
                        dense_off=dense_off,
                        primary_cigars=pc,
                        primary_pos_off=po,
                        primary_tags=pt,
                        mapq=mq,
                        pg=pg,
                        quals=quals,
                        rg=read_group,
                    )
                sprog.update(end - start)
            sprog.close()
        else:
            final_ids, final_d = pp.post_process_l2(
                neighbors,
                distances,
                query_emb,
                embed_windows,
                stride,
                k,
                k_clusters,
                bound,
                force_rerank=dense_rerank,
                sparse_off=sparse_off,
                dense_off=dense_off,
            )
            if sam_out:
                pc = po = mq = pt = None
                if cigar:
                    pc, po, pt = _primary_alignment_cigars(
                        query_seqs, final_ids[:, 0], genome, ref_len, multi,
                        dense_off, base_off,
                    )
                if mapq:
                    mq = compute_mapq(final_ids, final_d, ref_len,
                                      dense_off=dense_off)
                    if mapq_calibrated:
                        mq = calibrate_mapq(mq)
                sam_io.write_sam(
                    query_seqs,
                    query_ids,
                    final_ids.ravel(),
                    "ref",
                    ref_len,
                    k,
                    sam_file,
                    record_names=rec_names,
                    record_lens=rec_lens,
                    dense_off=dense_off,
                    primary_cigars=pc,
                    primary_pos_off=po,
                    primary_tags=pt,
                    mapq=mq,
                    pg=pg,
                    quals=quals,
                    rg=read_group,
                )
    if sort and sam_out and os.path.exists(sam_file):
        sam_io.sort_sam_file(sam_file)
    if mark_dups and sam_out and os.path.exists(sam_file):
        nd = sam_io.mark_duplicates(sam_file)
        if nd:
            print(f"[MAIN] marked {nd} duplicate lines (FLAG 0x400)")
    if bam and sam_out and os.path.exists(sam_file):
        from deepreadmapper_tpu.io.bam import sam_to_bam

        bam_file = os.path.join(output_dir, "results.bam")
        # a BAI is only valid over coordinate-sorted records; drop any
        # stale index from a previous sorted run into the same dir
        if not sort and os.path.exists(bam_file + ".bai"):
            os.remove(bam_file + ".bai")
        sam_to_bam(sam_file, bam_file,
                   bai_path=bam_file + ".bai" if sort else None)
    t_post = time.time() - t0
    if long_reads:
        t_post -= t_search  # the chain path's search ran inside this timer

    if not use_streaming and is_main:
        if long_reads:
            # chained read-START placements; "distances" are
            # 1 - chunk-support fraction (ascending better)
            save_results(
                final_ids,
                final_d,
                os.path.join(output_dir, "indices.npy"),
                os.path.join(output_dir, "distances.npy"),
                k,
            )
        elif (dense_rerank and stride == 1 and rerank != "sw"
                and final_d is not None):
            # Extension path: surface the exactly-reranked results (the
            # reference always saves raw ANN output, main.cpp:371-384, and
            # routes reranked results to SAM only).
            save_results(
                final_ids,
                final_d,
                os.path.join(output_dir, "indices.npy"),
                os.path.join(output_dir, "distances.npy"),
                k,
            )
        else:
            # Raw ANN results, k columns for dense / k_clusters for sparse
            # (main.cpp:371-384).
            out_k = k if stride == 1 else k_clusters
            save_results(
                neighbors,
                distances,
                os.path.join(output_dir, "indices.npy"),
                os.path.join(output_dir, "distances.npy"),
                out_k,
            )

    return {
        "num_queries": (
            len(query_seqs) if query_emb is None else int(query_emb.shape[0])
        ),
        "k": k,
        "k_clusters": k_clusters,
        "stride": stride,
        "neighbors": neighbors,
        "distances": distances,
        "final_ids": final_ids,
        "final_d": final_d,
        "query_seqs": query_seqs,
        "query_ids": query_ids,
        "records": records,
        "t_index": t_index,
        "t_embed": t_embed,
        "t_search": t_search,
        "t_post": t_post,
        "t_lr_split": lr_timings if long_reads else None,
    }


def run_pipeline_paired(
    index_prefix: str,
    query_file1: str,
    query_file2: str,
    ref_file: str,
    ef: int | None = None,
    k: int | None = None,
    k_clusters: int | None = None,
    output_dir: str = ".",
    rerank: str = "l2",
    dense_rerank: bool = False,
    write_sam: bool = True,
    mapq: bool = False,
    mapq_calibrated: bool = False,
    qual: bool = False,
    max_isize: int = 1000,
    min_isize: int = 0,
    cigar: bool = False,
    long_reads: bool = False,
    use_streaming: bool = False,
    sort: bool = False,
    bam: bool = False,
    mark_dups: bool = False,
    read_group: str | None = None,
    rescue: bool = True,
    vectorizer: Vectorizer | None = None,
    search_cfg: SearchConfig | None = None,
    preloaded: tuple | None = None,
    search_stats: dict | None = None,
) -> dict:
    """Paired-end mapping (beyond the reference, which maps every read
    independently): both ends run the normal single-end pipeline against
    one resident engine, then pipeline/paired.resolve_pairs picks the
    FR-proper candidate combination per pair.  SAM gets the full paired
    vocabulary — FLAG 0x1/0x2/0x20/0x40/0x80/0x8, RNEXT '=' / mate rname,
    PNEXT, signed TLEN — and the chosen pair members become the primary
    lines (pairing may promote a non-top single-end candidate).  --mapq
    uses the PAIR margin for proper pairs (pairing disambiguates repeats:
    a repeat locus rarely ties together with the mate's locus);
    indices.npy / distances.npy stack R1's rows then R2's."""
    from deepreadmapper_tpu.pipeline.paired import resolve_pairs

    for flag, name in ((cigar, "--cigar"), (long_reads, "--long-reads"),
                       (use_streaming, "use_streaming")):
        if flag:
            print(f"[MAIN] WARNING: {name} not supported in paired-end "
                  "mode yet; ignored")
    engine, config = preloaded if preloaded else load_index(index_prefix)
    vectorizer = vectorizer_for_index(index_prefix, config, vectorizer)
    ref_len = int(config["ref_len"])
    common = dict(
        ef=ef, k=k, k_clusters=k_clusters, output_dir=output_dir,
        rerank=rerank, dense_rerank=dense_rerank, write_sam=False,
        vectorizer=vectorizer, search_cfg=search_cfg,
        preloaded=(engine, config),
    )
    res1 = run_pipeline(index_prefix, query_file1, ref_file, **common)
    res2 = run_pipeline(index_prefix, query_file2, ref_file, **common)

    def _final(res):
        if res["final_ids"] is not None:
            return np.asarray(res["final_ids"]), np.asarray(res["final_d"])
        return np.asarray(res["neighbors"]), np.asarray(res["distances"])

    ids1, d1 = _final(res1)
    ids2, d2 = _final(res2)
    if ids1.shape[0] != ids2.shape[0]:
        raise ValueError(
            f"paired inputs differ in read count: {ids1.shape[0]} vs "
            f"{ids2.shape[0]}"
        )

    seqs1, qids1 = res1["query_seqs"], res1["query_ids"]
    seqs2, qids2 = res2["query_seqs"], res2["query_ids"]
    if qids1 and qids2 and qids1 != qids2:
        raise ValueError(
            "paired FASTQs disagree on read names/order (mates must share "
            "QNAME row by row; ids are /1 /2-suffix-stripped at parse)"
        )
    lens1 = np.array([len(s) - 2 for s in seqs1], np.int64)
    lens2 = np.array([len(s) - 2 for s in seqs2], np.int64)

    records = res1["records"] or fasta_io.parse_fasta_records(ref_file)
    multi = len(records) > 1
    if multi:
        dense_off, _base_off = fasta_io.record_window_table(
            records, ref_len, 1
        )
        rec_names = fasta_io.parse_fasta_names(ref_file)
        rec_lens = [int(len(r)) for r in records]
    else:
        dense_off = None
        rec_names = rec_lens = None

    # resolve_pairs expects ASCENDING-better scores; SW rerank scores are
    # descending-better
    sgn = -1.0 if rerank == "sw" else 1.0
    pair = resolve_pairs(
        ids1, sgn * d1, ids2, sgn * d2, lens1, lens2, max_isize, min_isize,
        ref_len, dense_off=dense_off,
    )

    n_rescued = 0
    if rescue and not pair["proper"].all():
        from deepreadmapper_tpu.pipeline.paired import PAD_ID, rescue_mates

        # base-coordinate translation for the scan (multi-record ids are
        # record-cumulative window indices)
        if multi:
            _do, base_off = fasta_io.record_window_table(records, ref_len, 1)

            def _to_base(ids_arr):
                return fasta_io.translate_window_ids(ids_arr, dense_off,
                                                     base_off)

            def _to_dense(base_id):
                bpos = base_id >> 1
                r = int(np.clip(
                    np.searchsorted(base_off, bpos, side="right") - 1,
                    0, len(base_off) - 2,
                ))
                # clamp into the record's stride-1 window grid; a mate
                # SHORTER than ref_len rescued within the last (ref_len -
                # mate_len) bases of a record shifts left by that clamp —
                # bounded by the read/window length difference
                loc = min(int(bpos - base_off[r]),
                          int(dense_off[r + 1] - dense_off[r] - 1))
                return 2 * (int(dense_off[r]) + loc) + (base_id & 1)

            def _bounds(base_id):
                bpos = base_id >> 1
                r = int(np.clip(
                    np.searchsorted(base_off, bpos, side="right") - 1,
                    0, len(base_off) - 2,
                ))
                return int(base_off[r]), int(base_off[r + 1])
        else:
            def _to_base(ids_arr):
                return ids_arr

            def _to_dense(base_id):
                return int(base_id)

            def _bounds(_base_id):
                return 0, int(sum(len(r) for r in records))
        genome_cat = (
            records[0] if len(records) == 1 else np.concatenate(records)
        )
        imp = np.flatnonzero(~pair["proper"])
        # anchor confidence = its single-end margin (an ambiguous anchor
        # must not mint a confident rescued pair)
        se1 = compute_mapq(ids1, sgn * d1, ref_len, dense_off=dense_off)
        se2 = compute_mapq(ids2, sgn * d2, ref_len, dense_off=dense_off)
        anchors, targets, alens, bounds, tgt_end = [], [], [], [], []
        for i in imp:
            # anchor on the end whose top candidate scores better
            use1 = sgn * d1[i, 0] <= sgn * d2[i, 0]
            aid = int(ids1[i, 0] if use1 else ids2[i, 0])
            if aid < 0:
                continue
            base_aid = int(_to_base(np.asarray([aid]))[0])
            anchors.append(base_aid)
            alens.append(int(lens1[i] if use1 else lens2[i]))
            tread = seqs2[i] if use1 else seqs1[i]
            targets.append(tread[1:-1] if len(tread) > 2 else tread)
            bounds.append(_bounds(base_aid))
            tgt_end.append((i, 2 if use1 else 1))
        if anchors:
            r_ids, r_scores = rescue_mates(
                np.asarray(anchors), targets, np.asarray(alens),
                genome_cat, max_isize, min_isize,
                rec_bounds=np.asarray(bounds, np.int64),
            )
            for (i, end), rid, rsc in zip(tgt_end, r_ids, r_scores):
                if rid == PAD_ID:
                    continue
                did = _to_dense(int(rid))
                if end == 2:
                    pair["b_id"][i] = did
                    pair["a_id"][i] = ids1[i, 0]
                    lq = int(lens2[i])
                else:
                    pair["a_id"][i] = did
                    pair["b_id"][i] = ids2[i, 0]
                    lq = int(lens1[i])
                pair["proper"][i] = True
                a_id_i = int(pair["a_id"][i])
                b_id_i = int(pair["b_id"][i])
                ap, bp = a_id_i >> 1, b_id_i >> 1
                if a_id_i & 1:
                    pair["tlen"][i] = -(ap + int(lens1[i]) - bp)
                else:
                    pair["tlen"][i] = bp + int(lens2[i]) - ap
                # rescued end: SW-identity-scaled quality, capped at 40
                rq = int(min(40, round(60.0 * int(rsc) / max(lq, 1))))
                if end == 2:
                    pair["mapq2"][i] = rq
                    pair["mapq1"][i] = int(se1[i])
                else:
                    pair["mapq1"][i] = rq
                    pair["mapq2"][i] = int(se2[i])
                n_rescued += 1
    if n_rescued:
        print(f"[MAIN] mate rescue: {n_rescued} pairs recovered by SW scan")

    def _promote(ids, d, chosen):
        """Swap each row's chosen pair member into the primary column; a
        rescued id absent from the candidate list overwrites column 0
        (its npy distance keeps the displaced value — rescue scores live
        on the SW scale, not the engine's)."""
        ids = ids.copy()
        d = d.copy()
        for i in range(ids.shape[0]):
            if chosen[i] < 0 or ids[i, 0] == chosen[i]:
                continue
            js = np.flatnonzero(ids[i] == chosen[i])
            if js.size:
                j = int(js[0])
                ids[i, 0], ids[i, j] = ids[i, j], ids[i, 0]
                d[i, 0], d[i, j] = d[i, j], d[i, 0]
            else:
                ids[i, 0] = chosen[i]
        return ids, d

    ids1p, d1p = _promote(ids1, d1, pair["a_id"])
    ids2p, d2p = _promote(ids2, d2, pair["b_id"])

    def _rname_pos(wid):
        if wid < 0:
            return "*", 0
        w = int(wid) >> 1
        if multi:
            r, loc = fasta_io.record_of(np.asarray([w]), dense_off)
            return rec_names[int(r[0])], int(loc[0]) + 1
        return "ref", w + 1

    def _mate_dict(my_ids, other_ids, first, tl_sign):
        out = {}
        base = 0x1 | (0x40 if first else 0x80)
        for i in range(my_ids.shape[0]):
            o = int(other_ids[i, 0])
            flag = base
            if pair["proper"][i]:
                flag |= 0x2
            if o < 0:
                flag |= 0x8
                rnext, pnext = "=", 0
            else:
                if o & 1:
                    flag |= 0x20
                rn_o, pn_o = _rname_pos(o)
                rn_m, _ = _rname_pos(int(my_ids[i, 0]))
                rnext = "=" if rn_o == rn_m else rn_o
                pnext = pn_o
            tlen = tl_sign * int(pair["tlen"][i])
            out[i] = (flag, rnext, pnext, tlen)
        return out

    mate1 = _mate_dict(ids1p, ids2p, first=True, tl_sign=1)
    mate2 = _mate_dict(ids2p, ids1p, first=False, tl_sign=-1)

    mq1 = mq2 = None
    if mapq:
        hib = rerank == "sw"
        s1 = compute_mapq(ids1p, d1p, ref_len, dense_off=dense_off,
                          higher_is_better=hib)
        s2 = compute_mapq(ids2p, d2p, ref_len, dense_off=dense_off,
                          higher_is_better=hib)
        mq1 = np.where(pair["proper"], pair["mapq1"], s1).astype(np.int32)
        mq2 = np.where(pair["proper"], pair["mapq2"], s2).astype(np.int32)
        if mapq_calibrated:
            mq1 = calibrate_mapq(mq1)
            mq2 = calibrate_mapq(mq2)

    import jax as _jax

    is_main = _jax.process_index() == 0
    os.makedirs(output_dir, exist_ok=True)
    if write_sam and is_main:
        from deepreadmapper_tpu.io.fastq import parse_fastq_quals

        quals1 = parse_fastq_quals(query_file1) if qual else None
        quals2 = parse_fastq_quals(query_file2) if qual else None
        pg = (
            f"pipeline-paired {index_prefix} {query_file1} {query_file2} "
            f"max_isize={max_isize}"
        )
        sam_file = os.path.join(output_dir, "results.sam")
        out_k = ids1p.shape[1]
        sam_io.write_sam(
            seqs1, qids1, ids1p.ravel(), "ref", ref_len, out_k, sam_file,
            record_names=rec_names, record_lens=rec_lens,
            dense_off=dense_off, mapq=mq1, quals=quals1, mate=mate1, pg=pg,
            rg=read_group,
        )
        sam_io.write_sam(
            seqs2, qids2, ids2p.ravel(), "ref", ref_len, out_k, sam_file,
            append=True, write_header=False,
            record_names=rec_names, record_lens=rec_lens,
            dense_off=dense_off, mapq=mq2, quals=quals2, mate=mate2,
            rg=read_group,
        )
        if sort:
            sam_io.sort_sam_file(sam_file)
        if mark_dups:
            nd = sam_io.mark_duplicates(sam_file)
            if nd:
                print(f"[MAIN] marked {nd} duplicate lines (FLAG 0x400)")
        if bam:
            from deepreadmapper_tpu.io.bam import sam_to_bam

            bam_file = os.path.join(output_dir, "results.bam")
            if not sort and os.path.exists(bam_file + ".bai"):
                os.remove(bam_file + ".bai")
            sam_to_bam(sam_file, bam_file,
                       bai_path=bam_file + ".bai" if sort else None)
    if is_main:
        save_results(
            np.vstack([ids1p, ids2p]),
            np.vstack([d1p, d2p]),
            os.path.join(output_dir, "indices.npy"),
            os.path.join(output_dir, "distances.npy"),
            ids1p.shape[1],
        )
    n_proper = int(pair["proper"].sum())
    print(
        f"[MAIN] paired: {n_proper}/{ids1.shape[0]} proper pairs "
        f"(max_isize {max_isize})"
    )
    return {
        "num_pairs": int(ids1.shape[0]),
        "n_proper": n_proper,
        "pair": pair,
        "t_embed": res1["t_embed"] + res2["t_embed"],
        "t_search": res1["t_search"] + res2["t_search"],
        "t_post": res1["t_post"] + res2["t_post"],
        "num_queries": int(ids1.shape[0]) * 2,
    }
