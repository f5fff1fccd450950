"""Long-read mapping: chunk -> search -> chain.

The reference truncates every read to MAX_LEN=123 tokens (~121 bases,
preprocess.cpp:20-42), so a PacBio/Nanopore-scale read is mapped by its
first ~121 bp only — one embedding, one vote, no use of the rest of the
read.  This module maps reads of ANY length against the same window
index: the read is cut into ref_len-sized chunks at half-window stride,
every chunk is embedded and searched as a normal query (one big batch —
the chunk axis is just more batch parallelism for the scan), and the
per-chunk candidates then VOTE for a consistent (strand, read-start)
placement:

    forward chunk at read offset o hitting window pos p  =>  start s = p - o
    reverse chunk at read offset o hitting window pos p  =>  s = p + o + c - L

(c = chunk length, L = read length: if revcomp(genome[s:s+L]) is the
read, the chunk at read offset o matches the reverse window at genome
position s + L - o - c.)  Votes within `tol` bases collapse into one
cluster; the cluster with the largest support wins.  Support fractions
give a margin-based MAPQ for free, and disagreeing chunks (chimeras,
SVs) simply fail to form a majority — support is reported, not hidden.

Chains are scored on CHUNK support, not re-aligned: a full-length SW of
a 10 kb read is a different cost class (the SW kernel tiles ~150x150
pairs) and the reference offers no long-read baseline at all.
"""

from __future__ import annotations

import numpy as np

PAD_ID = -1


def chunk_read(read_len: int, ref_len: int, max_chunks: int = 128) -> list[int]:
    """Chunk start offsets: half-window stride, final chunk end-aligned so
    the read tail is always covered (every chunk has length ref_len except
    for reads shorter than one window, handled by the normal path).

    Chunks per read are capped at max_chunks (the stride widens past
    ref_len/2 only for reads beyond ~(max_chunks/2)*ref_len — ~9.7 kb at
    the default 150/128): chain voting needs a MAJORITY of consistent
    chunks, not a fixed density, and 128 votes decide a placement as
    surely as 265 — while embed+search cost is linear in chunk count (the
    20 kb eval cells were search-bound at 265 chunks/read).  Sampling
    coarser than half-window keeps tail coverage (end-aligned final
    chunk); breakpoint resolution for split reads degrades to the stride,
    still << the vote tolerance."""
    if read_len <= ref_len:
        return [0]
    span = read_len - ref_len
    step = max(1, ref_len // 2, -(-span // max(max_chunks - 1, 1)))
    offs = list(range(0, span, step))
    offs.append(span)
    return offs


def chain_votes(
    cand_ids: np.ndarray,
    cand_d: np.ndarray,
    chunk_offs: np.ndarray,
    chunk_len: int,
    read_len: int,
    k: int,
    tol: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Chain one read's per-chunk candidates into top-k placements.

    cand_ids/cand_d: [n_chunks, kc] window ids + distances (PAD_ID rows
    allowed).  Returns (ids[k], support[k], n_chunks, coverage[k, 2])
    where ids are dense window ids 2*start + strand of the chained
    read-START placements (PAD_ID padded), support is each cluster's vote
    weight, and coverage is the READ interval [lo, hi) the cluster's
    supporting chunks span — disjoint coverage between the top clusters is
    the split-read (chimera) signal.  A chunk contributes at most one vote
    per cluster (its best-ranked one), so a repeat locus cannot stuff the
    ballot with its own k candidates.

    Vectorized (lexsort + reduceat group-bys): the dict formulation in
    `_chain_votes_ref` cost ~11 ms/read at 5 kb — the dominant host stage
    of long-read mapping.  Semantics are replicated
    including tie order: per-chunk slots keep the FIRST entry among equal
    weights (stable sort), merged bins prefer strictly-greater support
    with shift-0/first-touch precedence (minflat tiebreak), and the final
    ranking breaks (-support, dmin) ties by merged-bin first-touch order,
    matching dict insertion order.  The one permitted divergence is float
    summation ORDER (reduceat segments vs dict-value iteration), which can
    move a weighted mean sitting exactly on .5 by one base — a parity test
    drives both over randomized + adversarial-tie grids and bounds the
    start gap at 1.  The same rounding can in principle flip a support
    comparison that ties EXACTLY in one summation order but not the other,
    letting a different cluster win a merged bin — so dmin/coverage (which
    ride the winning cluster) are also subject to the divergence, not just
    the ±1 start drift; no observed grid hits it, but callers comparing
    against the oracle should treat those fields as tie-divergent too."""
    tol_ = max(tol, 1)
    ids = np.asarray(cand_ids, np.int64).ravel()
    dmat = np.asarray(cand_d, np.float64)
    d = dmat.ravel()
    kc = cand_ids.shape[1]
    rank_mat = (dmat[:, :, None] > dmat[:, None, :]).sum(-1)
    chunk_of = np.repeat(np.arange(len(chunk_offs)), kc)
    offs = np.repeat(np.asarray(chunk_offs, np.int64), kc)
    valid = ids >= 0
    rank = rank_mat.ravel().astype(np.float64)[valid]
    ids, d, offs, chunk_of = ids[valid], d[valid], offs[valid], chunk_of[valid]
    n = ids.size
    if n == 0:
        return (
            np.full(k, PAD_ID, np.int64),
            np.zeros(k, np.float64),
            0,
            np.zeros((k, 2), np.int64),
        )
    pos = ids >> 1
    rev = ids & 1
    start = np.where(rev == 0, pos - offs, pos + offs + chunk_len - read_len)
    w = 1.0 / (1.0 + rank)
    flat = np.arange(n, dtype=np.int64)

    # two clustering passes (shift 0 and tol//2) as one doubled batch
    two = lambda a: np.concatenate([a, a])  # noqa: E731
    sh = np.repeat(np.arange(2, dtype=np.int64), n)
    st2, rv2, w2, d2, off2, ch2, fl2 = map(
        two, (start, rev, w, d, offs, chunk_of, flat)
    )
    bin2 = (st2 + np.where(sh == 0, 0, tol // 2)) // tol_

    # sort by cluster (sh, rv, bin) then chunk then weight desc; lexsort is
    # stable, so equal weights keep entry order (first-seen wins the slot)
    order = np.lexsort((-w2, ch2, bin2, rv2, sh))
    shs, rvs, bins, chs = sh[order], rv2[order], bin2[order], ch2[order]
    clus_new = np.empty(order.size, bool)
    clus_new[0] = True
    clus_new[1:] = (
        (shs[1:] != shs[:-1]) | (rvs[1:] != rvs[:-1]) | (bins[1:] != bins[:-1])
    )
    slot_new = clus_new.copy()
    slot_new[1:] |= chs[1:] != chs[:-1]
    # first-touch (dict insertion) order = min flat index over ALL cluster
    # entries (setdefault touches the key even for losing entries)
    cseg = np.flatnonzero(clus_new)
    minflat = np.minimum.reduceat(fl2[order], cseg)

    sel = order[slot_new]  # per-chunk winners, cluster-sorted
    w_s, st_s, d_s, off_s = w2[sel], st2[sel], d2[sel], off2[sel]
    cseg_s = np.flatnonzero(clus_new[slot_new])
    sup_c = np.add.reduceat(w_s, cseg_s)
    ssum_c = np.add.reduceat(w_s * st_s, cseg_s)
    dmin_c = np.minimum.reduceat(d_s, cseg_s)
    lo_c = np.minimum.reduceat(off_s, cseg_s)
    hi_c = np.maximum.reduceat(off_s, cseg_s) + chunk_len
    rv_c = rvs[clus_new]
    sh_c = shs[clus_new]
    s_hat = np.rint(ssum_c / np.maximum(sup_c, 1e-12)).astype(np.int64)

    # merge the two passes per (strand, s_hat bin): strictly-greater
    # support replaces, ties keep the earliest-inserted cluster
    mbin = s_hat // tol_
    morder = np.lexsort((minflat, sh_c, -sup_c, mbin, rv_c))
    mrv, mb = rv_c[morder], mbin[morder]
    mnew = np.empty(morder.size, bool)
    mnew[0] = True
    mnew[1:] = (mrv[1:] != mrv[:-1]) | (mb[1:] != mb[:-1])
    mseg = np.flatnonzero(mnew)
    win = morder[mseg]
    # merged-dict first-touch order: min (sh, minflat) over the bin's
    # clusters — the stable tiebreak of the final python sort
    torder = np.minimum.reduceat(
        (sh_c * (2 * n + 1) + minflat)[morder], mseg
    )
    fin = np.lexsort((torder, dmin_c[win], -sup_c[win]))
    win = win[fin]

    out_ids = np.full(k, PAD_ID, np.int64)
    out_sup = np.zeros(k, np.float64)
    out_cov = np.zeros((k, 2), np.int64)
    accepted: list[tuple[int, int]] = []
    for ci in win:
        r, s_ = int(rv_c[ci]), int(s_hat[ci])
        if any(r == r2 and abs(s_ - s2) <= tol for r2, s2 in accepted):
            continue
        out_ids[len(accepted)] = 2 * max(0, s_) + r
        out_sup[len(accepted)] = sup_c[ci]
        out_cov[len(accepted)] = (lo_c[ci], hi_c[ci])
        accepted.append((r, s_))
        if len(accepted) == k:
            break
    return out_ids, out_sup, len(chunk_offs), out_cov


def _chain_votes_ref(
    cand_ids: np.ndarray,
    cand_d: np.ndarray,
    chunk_offs: np.ndarray,
    chunk_len: int,
    read_len: int,
    k: int,
    tol: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Scalar dict-based oracle for chain_votes (kept for the parity
    test; the vectorized version must match it up to float summation
    order — starts within 1 base, everything else exact)."""
    ids = np.asarray(cand_ids, np.int64).ravel()
    dmat = np.asarray(cand_d, np.float64)
    d = dmat.ravel()
    kc = cand_ids.shape[1]
    # dense rank on DISTANCE, not position: an exact tie (true repeat) must
    # weigh both copies equally or the arbitrary ANN tiebreak would forge a
    # confident-looking majority
    rank_mat = (dmat[:, :, None] > dmat[:, None, :]).sum(-1)
    chunk_of = np.repeat(np.arange(len(chunk_offs)), kc)
    offs = np.repeat(np.asarray(chunk_offs, np.int64), kc)
    valid = ids >= 0
    rank = rank_mat.ravel().astype(np.float64)[valid]
    ids, d, offs, chunk_of = ids[valid], d[valid], offs[valid], chunk_of[valid]
    if ids.size == 0:
        return (
            np.full(k, PAD_ID, np.int64),
            np.zeros(k, np.float64),
            0,
            np.zeros((k, 2), np.int64),
        )
    pos = ids >> 1
    rev = ids & 1
    start = np.where(rev == 0, pos - offs, pos + offs + chunk_len - read_len)
    # rank weight: a chunk's best-distance candidates count 1, then 1/2, ...
    w = 1.0 / (1.0 + rank)

    # cluster by (strand, start // tol) with a half-bin shifted pass so a
    # cluster straddling a bin edge is still found; keys are exact enough
    # for vote collapsing (tol ~ chunk stride)
    best: dict[tuple[int, int, int], dict] = {}
    for shift in (0, tol // 2):
        key_bin = (start + shift) // max(tol, 1)
        for kb, r, s, wt, ch, dd in zip(
            key_bin, rev, start, w, chunk_of, d
        ):
            key = (int(r), int(kb), shift)
            # per-chunk best (weight, start): one vote per chunk per cluster
            per_chunk = best.setdefault(key, {})
            prev = per_chunk.get(int(ch))
            if prev is None or wt > prev[0]:
                per_chunk[int(ch)] = (wt, int(s), float(dd))
    # keep the better of the two passes per (strand, rounded start)
    merged: dict[tuple[int, int], tuple] = {}
    for (r, _kb, _sh), per_chunk in best.items():
        sup = sum(wt for wt, _s, _d in per_chunk.values())
        ssum = sum(wt * s for wt, s, _d in per_chunk.values())
        dmin = min(dd for _w, _s, dd in per_chunk.values())
        s_hat = int(round(ssum / max(sup, 1e-12)))
        lo = min(chunk_offs[ch] for ch in per_chunk)
        hi = max(chunk_offs[ch] for ch in per_chunk) + chunk_len
        mkey = (r, s_hat // max(tol, 1))
        cur = merged.get(mkey)
        if cur is None or sup > cur[0]:
            merged[mkey] = (sup, s_hat, r, dmin, int(lo), int(hi))
    ranked = sorted(merged.values(), key=lambda t: (-t[0], t[3]))
    out_ids = np.full(k, PAD_ID, np.int64)
    out_sup = np.zeros(k, np.float64)
    out_cov = np.zeros((k, 2), np.int64)
    # suppress near-duplicates: the two shifted clustering passes can land
    # one physical cluster in two merged bins — without this the winner
    # competes against its own echo and the support margin (MAPQ) collapses
    accepted: list[tuple[int, int]] = []
    for sup, s_hat, r, _dmin, lo, hi in ranked:
        if any(r == r2 and abs(s_hat - s2) <= tol for r2, s2 in accepted):
            continue
        out_ids[len(accepted)] = 2 * max(0, s_hat) + r
        out_sup[len(accepted)] = sup
        out_cov[len(accepted)] = (lo, hi)
        accepted.append((r, s_hat))
        if len(accepted) == k:
            break
    return out_ids, out_sup, len(chunk_offs), out_cov


_COMP_TABLE = bytes.maketrans(b"ACGTNacgtn", b"TGCANtgcan")


def banded_primary_cigars(
    reads: list[str],
    primary_ids: np.ndarray,
    genome: np.ndarray,
    band: int,
    dense_off: np.ndarray | None = None,
    base_off: np.ndarray | None = None,
) -> tuple[list[str], np.ndarray, list[str]]:
    """Real CIGARs for chained long-read primaries via the native BANDED
    aligner (O(len*band) instead of the full O(len^2) DP — a 10 kb read at
    band 150 is ~3M cells, microseconds in C++).  The chain already places
    the read to within the vote tolerance, so the true alignment diagonal
    sits inside the band.

    Returns (cigars, pos_off, tags) in the primary_cigars/primary_pos_off/
    primary_tags convention of io.sam.format_sam_records: reference-
    orientation CIGARs with soft clips, '' for invalid/overflowed rows
    (pseudo fallback), POS shifts relative to the chained start, and
    preformatted NM/MD/AS tag suffixes (io.sam.alignment_tags; the aligner
    already works in forward-reference orientation here, so no reversal).
    Segments are clipped to record boundaries on multi-record
    references."""
    from deepreadmapper_tpu import native
    from deepreadmapper_tpu.io.fasta import record_of

    ids = np.asarray(primary_ids, np.int64)
    n = len(reads)
    pos_w = np.maximum(ids, 0) >> 1
    if dense_off is not None:
        rec, loc = record_of(pos_w, dense_off)
        base = base_off[rec] + loc
        rec_lo = base_off[rec]
        rec_hi = base_off[rec + 1]
    else:
        base = pos_w
        rec_lo = np.zeros(n, np.int64)
        rec_hi = np.full(n, genome.size, np.int64)

    a_rows, seg_rows, seg_los = [], [], []
    for i, read in enumerate(reads):
        L = len(read)
        lo = int(max(rec_lo[i], base[i] - band))
        hi = int(min(rec_hi[i], base[i] + L + band))
        seg_los.append(lo)
        seg_rows.append(genome[lo:hi])
        rb = read.encode()
        if ids[i] >= 0 and ids[i] & 1:
            rb = rb.translate(_COMP_TABLE)[::-1]  # reference orientation
        a_rows.append(np.frombuffer(rb, np.uint8))
    a_w = max((r.size for r in a_rows), default=1)
    s_w = max((r.size for r in seg_rows), default=1)
    a_mat = np.zeros((n, a_w), np.uint8)
    s_mat = np.zeros((n, s_w), np.uint8)
    a_lens = np.empty(n, np.int64)
    s_lens = np.empty(n, np.int64)
    for i in range(n):
        a_mat[i, : a_rows[i].size] = a_rows[i]
        s_mat[i, : seg_rows[i].size] = seg_rows[i]
        a_lens[i] = a_rows[i].size
        s_lens[i] = seg_rows[i].size
    _s, a_span, b_span, bodies = native.banded_cigar(
        a_mat, a_lens, s_mat, s_lens, band
    )
    import re

    from deepreadmapper_tpu.io.sam import alignment_tags

    run_re = re.compile(r"(\d+)([MID])")
    cigars: list[str] = []
    tags: list[str] = []
    pos_off = np.zeros(n, np.int64)
    for i in range(n):
        body = bodies[i]
        if not body or ids[i] < 0:
            cigars.append("")
            tags.append("")
            continue
        L = len(reads[i])
        a0, a1 = int(a_span[i, 0]), int(a_span[i, 1])
        cig = (
            (f"{a0}S" if a0 else "")
            + body
            + (f"{L - a1}S" if L - a1 else "")
        )
        cigars.append(cig)
        runs = [(int(c), op) for c, op in run_re.findall(body)]
        nm, md, as_ = alignment_tags(
            a_mat[i], s_mat[i], a0, int(b_span[i, 0]), runs, reverse=False
        )
        tags.append(f"\tNM:i:{nm}\tMD:Z:{md}\tAS:i:{as_}")
        pos_off[i] = seg_los[i] + int(b_span[i, 0]) - int(base[i])
    return cigars, pos_off, tags


def map_long_reads(
    seqs: list[str],
    vectorizer,
    engine,
    ref_len: int,
    k: int,
    ef: int,
    kc: int = 8,
    tol: int | None = None,
    stride: int = 1,
    ids_to_base=None,
    base_to_dense=None,
    timings: dict | None = None,
    max_chunks: int = 128,
):
    """Map reads longer than one window.  Returns (ids, dists, mapq, supp):
    ids [nq, k] dense window ids of chained read-START placements (PAD_ID
    padded), dists [nq, k] = 1 - support_fraction (ascending better, same
    orientation as L2 so downstream sorting conventions hold), a
    margin-based MAPQ [nq], and supp — a dict {query_i: [(dense_segment_id,
    cigar, mapq)]} of SPLIT-READ supplementary alignments: secondary vote
    clusters whose supporting chunks cover a read region DISJOINT from the
    primary's (a chimera / structural-variant junction).  Their soft-clip
    CIGARs mark which read interval aligns where.  Disjoint-coverage
    clusters are also EXCLUDED from the primary's MAPQ competitor set —
    the other half of a chimera is not an alternative placement of the
    same bases.

    ids_to_base(window_index) -> concatenated-base-stream position and
    base_to_dense(start, strand) -> dense output id: the two coordinate
    hops that make sparse (stride>1) and multi-record indexes chain in
    one global base space.  Defaults cover the single-record case.

    max_chunks caps the chunks (votes) per read — chain voting needs a
    MAJORITY of consistent chunks, not a fixed density, and embed+search
    cost is linear in chunk count; the 20 kb eval cells are
    search-bound.  The eval_longread --max-chunks A/B picks the
    default."""
    import time as _time

    if ids_to_base is None:
        ids_to_base = lambda w: w * stride  # noqa: E731
    if base_to_dense is None:
        base_to_dense = lambda s, r: 2 * s + r  # noqa: E731
    from deepreadmapper_tpu import tokenizer as tok

    t_mark = _time.time()

    def _lap(key):
        nonlocal t_mark
        now = _time.time()
        if timings is not None:
            timings[key] = timings.get(key, 0.0) + (now - t_mark)
        t_mark = now

    chunk_lists = [chunk_read(len(s), ref_len, max_chunks) for s in seqs]
    # seqs are UNWRAPPED reads; chunks are embedded '<'-wrapped, the same
    # space the index windows were built in (parse_inputs.cpp:337-349).
    # Built as a byte matrix straight from each read's bytes (no per-chunk
    # Python strings) and shipped through the 48 B/row packed-wire path —
    # the chunk batch is the dominant transfer of every long-read request.
    n_total = sum(len(o) for o in chunk_lists)
    mat = np.zeros((n_total, ref_len + 2), np.uint8)
    lengths = np.empty(n_total, np.int64)
    r = 0
    for s, offs in zip(seqs, chunk_lists):
        b = np.frombuffer(s.encode(), np.uint8)
        for o in offs:
            chunk = b[o: o + ref_len]
            mat[r, 0] = 0x3C  # '<'
            mat[r, 1: 1 + chunk.size] = chunk
            mat[r, 1 + chunk.size] = 0x3E  # '>'
            lengths[r] = chunk.size + 2
            r += 1
    _lap("host_pack")
    if vectorizer.max_len == tok.MAX_LEN:
        emb = vectorizer.vectorize_wrapped_bytes(mat, lengths)
    else:
        tokens = tok.tokenize_bytes_fast(mat, lengths, vectorizer.max_len)
        emb = vectorizer.vectorize_tokens(tokens)
    emb = np.asarray(emb)  # host fetch = the only real device sync
    _lap("embed")
    cand_ids, cand_d = engine.search(emb, kc, ef)
    cand_ids = np.asarray(cand_ids, np.int64)
    cand_d = np.asarray(cand_d)
    _lap("search")
    # into base coordinates: 2*base_pos + strand, invalids pass through
    cand_ids = np.where(
        cand_ids >= 0,
        (ids_to_base(cand_ids >> 1) << 1) | (cand_ids & 1),
        cand_ids,
    )

    nq = len(seqs)
    ids = np.full((nq, k), PAD_ID, np.int64)
    dists = np.ones((nq, k), np.float32)
    mapq = np.zeros(nq, np.int32)
    supp: dict[int, list[tuple[int, str, int]]] = {}
    row = 0
    for i, (s, offs) in enumerate(zip(seqs, chunk_lists)):
        n_ch = len(offs)
        c = min(len(s), ref_len)
        L = len(s)
        cids, sup, _, cov = chain_votes(
            cand_ids[row: row + n_ch],
            cand_d[row: row + n_ch],
            np.asarray(offs, np.int64),
            c,
            L,
            k,
            tol if tol is not None else max(1, ref_len // 2),
        )
        row += n_ch
        ids[i] = np.where(
            cids >= 0, base_to_dense(np.maximum(cids, 0) >> 1, cids & 1),
            cids,
        )
        total = max(float(n_ch), 1e-12)  # max support = 1 vote per chunk
        dists[i] = (1.0 - sup / total).astype(np.float32)
        if cids[0] == PAD_ID:
            continue
        p_lo, p_hi = int(cov[0, 0]), int(cov[0, 1])
        v2 = 0.0
        for j in range(1, k):
            if cids[j] == PAD_ID:
                break
            lo, hi = int(cov[j, 0]), int(cov[j, 1])
            ov = max(0, min(p_hi, hi) - max(p_lo, lo))
            if ov >= 0.5 * min(p_hi - p_lo, hi - lo):
                # overlapping coverage: an alternative placement of the
                # SAME read bases -> a MAPQ competitor
                v2 = max(v2, sup[j])
            elif sup[j] >= 2.0 and len(supp.get(i, ())) < 2:
                # disjoint coverage: the other half of a split read
                s_hat = int(cids[j]) >> 1
                strand = int(cids[j]) & 1
                seg_start = s_hat + lo if strand == 0 else s_hat + L - hi
                seg_id = int(
                    base_to_dense(np.int64(max(0, seg_start)), strand)
                )
                m = hi - lo
                # ref orientation: clips swap on the reverse strand
                a, b = (lo, L - hi) if strand == 0 else (L - hi, lo)
                cig = (f"{a}S" if a else "") + f"{m}M" + (f"{b}S" if b else "")
                n_exp = sum(1 for o in offs if lo <= o <= hi - c)
                q = int(np.clip(round(60.0 * sup[j] / max(n_exp, 1)), 0, 60))
                supp.setdefault(i, []).append((seg_id, cig, q))
        v1 = sup[0]
        mapq[i] = int(np.clip(round(60.0 * (v1 - v2) / max(v1, 1e-12)),
                              0, 60))
    _lap("chain")
    return ids, dists, mapq, supp
