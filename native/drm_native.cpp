// Native data-loader for deepreadmapper_tpu.
//
// Device-side compute is JAX/Pallas; this library covers the host-side hot
// paths the reference implements in C++ (src/utils/parse_inputs.cpp,
// src/inference/preprocess.cpp): FASTA byte cleaning, and a FUSED
// window-generation + reverse-complement + tokenization kernel that emits
// encoder-ready token matrices straight from the genome byte array — no
// intermediate window strings or byte matrices.
//
// Exposed via a plain C ABI for ctypes (no pybind11 in this image).
// Token semantics are identical to deepreadmapper_tpu/tokenizer.py (which is
// itself parity-tested against the reference): 96-token 3-mer vocabulary at
// ids 7542-7637, wrapped-window first-token quirk, 123-token truncation,
// out-of-table hashes (N runs) -> 0.
//
// Build: g++ -O3 -march=native -fopenmp -shared -fPIC drm_native.cpp -o _drm_native.so

#include <cstdint>
#include <cstring>
#include <algorithm>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

constexpr int MAX_LEN_DEFAULT = 123;

struct Tables {
    uint8_t val[256];      // a/c/g/t (any case) -> 0..3, else 7
    uint8_t comp[256];     // A<->T, C<->G, N->N, else 0
    uint8_t clean[256];    // ACGTNacgtn -> uppercase, else 0
    int32_t hash2id[256];  // hash -> vocab id, >=96 -> 0
    Tables() {
        std::memset(val, 7, sizeof(val));
        const char* bases = "acgt";
        for (int i = 0; i < 4; ++i) {
            val[(uint8_t)bases[i]] = (uint8_t)i;
            val[(uint8_t)(bases[i] - 32)] = (uint8_t)i;
        }
        std::memset(comp, 0, sizeof(comp));
        comp['A'] = 'T'; comp['T'] = 'A'; comp['C'] = 'G'; comp['G'] = 'C';
        comp['N'] = 'N';
        std::memset(clean, 0, sizeof(clean));
        const char* up = "ACGTN";
        for (int i = 0; i < 5; ++i) {
            clean[(uint8_t)up[i]] = (uint8_t)up[i];
            clean[(uint8_t)(up[i] + 32)] = (uint8_t)up[i];
        }
        std::memset(hash2id, 0, sizeof(hash2id));
        for (int h = 0; h < 16; ++h) hash2id[h] = 7542 + h;
        for (int xy = 0; xy < 16; ++xy) hash2id[16 + xy] = 7558 + 5 * xy;
        for (int xy = 0; xy < 16; ++xy)
            for (int z = 0; z < 4; ++z) hash2id[32 + 4 * xy + z] = 7559 + 5 * xy + z;
    }
};
const Tables T;

inline int32_t hash3(uint8_t c0, uint8_t c1, uint8_t c2) {
    if (c0 == '<') return (T.val[c1] << 2) + T.val[c2];
    if (c2 == '>') return 16 + (T.val[c0] << 2) + T.val[c1];
    return 32 + (T.val[c0] << 4) + (T.val[c1] << 2) + T.val[c2];
}

// Character j (0-based) of the virtual wrapped window string
// '<' + w[0..ref_len) + '>', where w is forward or revcomp of genome[p..).
struct WindowView {
    const uint8_t* g;
    int64_t p;
    int64_t ref_len;
    bool rev;
    inline uint8_t at(int64_t j) const {
        if (j == 0) return '<';
        if (j == ref_len + 1) return '>';
        int64_t b = j - 1;  // base index 0..ref_len-1
        return rev ? T.comp[g[p + ref_len - 1 - b]] : g[p + b];
    }
};

inline void tokenize_window(const WindowView& w, int32_t* out, int max_len) {
    int64_t size = w.ref_len + 2;
    int len = (int)std::min<int64_t>(max_len, size);
    // result[0] = hash('<', seq[0], seq[1]) — seq[0] is '<' itself.
    out[0] = T.hash2id[hash3('<', w.at(0), w.at(1))];
    int i = 0;
    for (; i < len - 2; ++i)
        out[i + 1] = T.hash2id[hash3(w.at(i), w.at(i + 1), w.at(i + 2))];
    uint8_t c0 = w.at(i), c1 = w.at(i + 1);
    uint8_t c2 = (i + 2 < size) ? w.at(i + 2) : (uint8_t)'>';
    out[len - 1] = T.hash2id[hash3(c0, c1, c2)];
    for (int t = len; t < max_len; ++t) out[t] = 0;
}

}  // namespace

extern "C" {

// Clean a FASTA byte buffer: keep uppercase ACGTN of record bodies, skipping
// header lines; record starts at every '>' line.  Returns n_records (or -1 if
// more than max_records).  out must be >= data_len bytes; record_ends[i] is
// the END offset of record i within out.
int64_t drm_clean_fasta(const uint8_t* data, int64_t data_len, uint8_t* out,
                        int64_t* record_ends, int64_t max_records) {
    int64_t n_rec = 0, w = 0;
    bool in_seq = false, in_header = false;
    for (int64_t i = 0; i < data_len; ++i) {
        uint8_t c = data[i];
        if (c == '>' && !in_header) {
            if (in_seq) {
                if (n_rec >= max_records) return -1;
                record_ends[n_rec++] = w;
            }
            in_header = true;
            in_seq = true;
            continue;
        }
        if (in_header) {
            if (c == '\n') in_header = false;
            continue;
        }
        if (!in_seq) continue;
        uint8_t cl = T.clean[c];
        if (cl) out[w++] = cl;
    }
    if (in_seq) {
        if (n_rec >= max_records) return -1;
        record_ends[n_rec++] = w;
    }
    return n_rec;
}

// Fused windows -> tokens: for windows [first, first+n) of a genome record
// (window w starts at w*stride), emit interleaved (forward, revcomp) token
// rows into out [2*n, max_len] int32.  OpenMP-parallel over windows.
void drm_tokenize_windows(const uint8_t* genome, int64_t glen, int64_t ref_len,
                          int64_t stride, int64_t first, int64_t n,
                          int32_t* out, int32_t max_len) {
#pragma omp parallel for schedule(static)
    for (int64_t w = 0; w < n; ++w) {
        int64_t p = (first + w) * stride;
        (void)glen;
        WindowView fwd{genome, p, ref_len, false};
        WindowView rev{genome, p, ref_len, true};
        tokenize_window(fwd, out + (2 * w) * max_len, max_len);
        tokenize_window(rev, out + (2 * w + 1) * max_len, max_len);
    }
}

// Tokenize arbitrary byte sequences (e.g. wrapped FASTQ reads) given as a
// padded matrix rows [n, width] with true lengths.  Matches
// tokenizer.tokenize_bytes.
void drm_tokenize_seqs(const uint8_t* mat, int64_t n, int64_t width,
                       const int64_t* lengths, int32_t* out, int32_t max_len) {
#pragma omp parallel for schedule(static)
    for (int64_t r = 0; r < n; ++r) {
        const uint8_t* s = mat + r * width;
        int64_t size = lengths[r];
        int32_t* o = out + r * max_len;
        int len = (int)std::min<int64_t>(max_len, size);
        if (len < 2) {  // degenerate, mirror numpy path (reads s[1] as pad 0)
            for (int t = 0; t < max_len; ++t) o[t] = 0;
            if (len == 1) o[0] = T.hash2id[hash3('<', s[0], width > 1 ? s[1] : 0)];
            continue;
        }
        o[0] = T.hash2id[hash3('<', s[0], s[1])];
        int i = 0;
        for (; i < len - 2; ++i)
            o[i + 1] = T.hash2id[hash3(s[i], s[i + 1], s[i + 2])];
        uint8_t c0 = s[i], c1 = s[i + 1];
        uint8_t c2 = (i + 2 < size) ? s[i + 2] : (uint8_t)'>';
        o[len - 1] = T.hash2id[hash3(c0, c1, c2)];
        for (int t = len; t < max_len; ++t) o[t] = 0;
    }
}

// Tokenize windows fetched by dense id (2*pos | strand), unwrapped or
// wrapped — the candidate re-embedding path (find_sequence semantics).
// ids with pos + ref_len > glen produce all-zero rows.
void drm_tokenize_windows_by_id(const uint8_t* genome, int64_t glen,
                                int64_t ref_len, const int64_t* ids, int64_t n,
                                int32_t wrap, int32_t* out, int32_t max_len) {
#pragma omp parallel for schedule(static)
    for (int64_t r = 0; r < n; ++r) {
        int64_t id = ids[r];
        int64_t pos = id >> 1;
        bool rev = (id & 1) != 0;
        int32_t* o = out + r * max_len;
        if (pos < 0 || pos + ref_len > glen) {
            for (int t = 0; t < max_len; ++t) o[t] = 0;
            continue;
        }
        if (wrap) {
            WindowView wv{genome, pos, ref_len, rev};
            tokenize_window(wv, o, max_len);
        } else {
            // Unwrapped: seq = w[0..ref_len); same rule set, no '<'/'>'.
            auto at = [&](int64_t b) -> uint8_t {
                return rev ? T.comp[genome[pos + ref_len - 1 - b]]
                           : genome[pos + b];
            };
            int len = (int)std::min<int64_t>(max_len, ref_len);
            o[0] = T.hash2id[hash3('<', at(0), at(1))];
            int i = 0;
            for (; i < len - 2; ++i)
                o[i + 1] = T.hash2id[hash3(at(i), at(i + 1), at(i + 2))];
            uint8_t c0 = at(i), c1 = at(i + 1);
            uint8_t c2 = (i + 2 < ref_len) ? at(i + 2) : (uint8_t)'>';
            o[len - 1] = T.hash2id[hash3(c0, c1, c2)];
            for (int t = len; t < max_len; ++t) o[t] = 0;
        }
    }
}

// ---- 2-bit packed wire format (tokenizer_device.py) ----------------------
// One 48-byte row per sequence: 31 bytes of 2-bit base codes (bases 0..122,
// little-endian lanes), 16 bytes of N-mask bits, 1 byte base count (clamped
// 255).  The device tokenizer consumes this directly (tokens_from_packed).

constexpr int WIRE_PACKED = 31;
constexpr int WIRE_NMASK = 16;
constexpr int WIRE_WIDTH = 48;
constexpr int WIRE_BASES = 123;

inline void pack_wire_row(const uint8_t* bases_src, int64_t nb, bool rev,
                          const uint8_t* genome_end, uint8_t* wire) {
    // bases_src: forward pointer to first base (if !rev), else genome_end is
    // the pointer ONE PAST the last base and we walk backwards complementing.
    std::memset(wire, 0, WIRE_WIDTH);
    int64_t take = std::min<int64_t>(nb, WIRE_BASES);
    for (int64_t i = 0; i < take; ++i) {
        uint8_t c = rev ? T.comp[genome_end[-1 - i]] : bases_src[i];
        uint8_t v = T.val[c];
        wire[i >> 2] |= (uint8_t)((v & 3) << (2 * (i & 3)));
        if (v >= 4) wire[WIRE_PACKED + (i >> 3)] |= (uint8_t)(1 << (i & 7));
    }
    wire[WIRE_WIDTH - 1] = (uint8_t)std::min<int64_t>(nb, 255);
}

// Wrapped byte-matrix rows ('<'+seq+'>') -> wire rows [n, 48].
// Mirrors tokenizer_device.pack_wrapped exactly.
void drm_pack_wrapped(const uint8_t* mat, int64_t n, int64_t width,
                      const int64_t* lengths, uint8_t* wire) {
#pragma omp parallel for schedule(static)
    for (int64_t r = 0; r < n; ++r) {
        int64_t nb = lengths[r] >= 2 ? lengths[r] - 2 : 0;
        // bases live at columns 1..; only min(nb, width-1) are present,
        // the rest read as pad (val 7) in the numpy path — but pack_wrapped
        // zeroes beyond nb, and callers always size width >= nb+1.
        int64_t avail = width > 1 ? width - 1 : 0;
        int64_t eff = std::min(nb, avail);
        uint8_t* w = wire + r * WIRE_WIDTH;
        std::memset(w, 0, WIRE_WIDTH);
        const uint8_t* src = mat + r * width + 1;
        int64_t take = std::min<int64_t>(eff, WIRE_BASES);
        for (int64_t i = 0; i < take; ++i) {
            uint8_t v = T.val[src[i]];
            w[i >> 2] |= (uint8_t)((v & 3) << (2 * (i & 3)));
            if (v >= 4) w[WIRE_PACKED + (i >> 3)] |= (uint8_t)(1 << (i & 7));
        }
        // columns beyond the matrix width count as N (val 7), matching numpy
        for (int64_t i = take; i < std::min<int64_t>(nb, WIRE_BASES); ++i) {
            w[i >> 2] |= (uint8_t)(3 << (2 * (i & 3)));
            w[WIRE_PACKED + (i >> 3)] |= (uint8_t)(1 << (i & 7));
        }
        w[WIRE_WIDTH - 1] = (uint8_t)std::min<int64_t>(nb, 255);
    }
}

// Fused genome windows -> wire rows: windows [first, first+n) at w*stride,
// interleaved (forward, revcomp) -> wire [2*n, 48].
void drm_pack_windows(const uint8_t* genome, int64_t glen, int64_t ref_len,
                      int64_t stride, int64_t first, int64_t n, uint8_t* wire) {
    (void)glen;
#pragma omp parallel for schedule(static)
    for (int64_t w = 0; w < n; ++w) {
        int64_t p = (first + w) * stride;
        pack_wire_row(genome + p, ref_len, false, nullptr,
                      wire + (2 * w) * WIRE_WIDTH);
        pack_wire_row(nullptr, ref_len, true, genome + p + ref_len,
                      wire + (2 * w + 1) * WIRE_WIDTH);
    }
}

// Windows fetched by dense id (2*pos | strand) -> wire rows [n, 48]
// (the sparse-rerank candidate path; wrap semantics are implicit in the
// wire format).  Out-of-range ids produce zero rows (nb=0 -> zero tokens).
void drm_pack_windows_by_id(const uint8_t* genome, int64_t glen,
                            int64_t ref_len, const int64_t* ids, int64_t n,
                            uint8_t* wire) {
#pragma omp parallel for schedule(static)
    for (int64_t r = 0; r < n; ++r) {
        int64_t id = ids[r];
        int64_t pos = id >> 1;
        bool rev = (id & 1) != 0;
        uint8_t* w = wire + r * WIRE_WIDTH;
        if (id < 0 || pos < 0 || pos + ref_len > glen) {
            std::memset(w, 0, WIRE_WIDTH);
            continue;
        }
        pack_wire_row(genome + pos, ref_len, rev, genome + pos + ref_len, w);
    }
}

// Nibble-packed id download -> int64 ids (ops/pack.unpack_ids_host).
void drm_unpack_ids(const uint8_t* packed, int64_t n, int64_t nbytes,
                    int64_t k, int32_t nbits, int64_t* out) {
    int nnib = nbits / 4;
#pragma omp parallel for schedule(static)
    for (int64_t r = 0; r < n; ++r) {
        const uint8_t* row = packed + r * nbytes;
        int64_t* o = out + r * k;
        for (int64_t j = 0; j < k; ++j) {
            int64_t v = 0;
            int64_t nib0 = j * nnib;
            for (int q = 0; q < nnib; ++q) {
                int64_t nib = nib0 + q;
                uint8_t byte = row[nib >> 1];
                uint8_t x = (nib & 1) ? (byte >> 4) : (byte & 0xF);
                v |= (int64_t)x << (4 * q);
            }
            o[j] = v;
        }
    }
}

// Batched local Smith-Waterman WITH traceback for CIGAR emission
// (match +1 / mismatch -1 / gap -1 linear — the reference's scoring,
// src/utils/metrics.cpp:10-45, which computes scores only; the traceback
// is beyond-reference, used for real SAM CIGARs).
//
// a = read (as sequenced), b = candidate window.  Outputs per pair: best
// score, aligned half-open spans [a_start, a_end) / [b_start, b_end), and
// a run-length CIGAR over the aligned region (op 0 = M, 1 = I consumes
// read only, 2 = D consumes window only).  n_ops = 0 signals overflow
// (caller falls back to the pseudo CIGAR).
void drm_sw_cigar(const uint8_t* a_mat, const int64_t* a_lens, int64_t a_width,
                  const uint8_t* b_mat, const int64_t* b_lens, int64_t b_width,
                  int64_t n, int32_t* scores, int32_t* a_start,
                  int32_t* a_end, int32_t* b_start, int32_t* b_end,
                  uint8_t* cigar_ops, int32_t* cigar_lens, int32_t* n_ops,
                  int64_t max_ops) {
#if defined(_OPENMP)
#pragma omp parallel
#endif
    {
        // per-thread scratch sized for the largest pair
        int64_t max_a = a_width, max_b = b_width;
        int32_t* h_prev = new int32_t[max_b + 1];
        int32_t* h_cur = new int32_t[max_b + 1];
        uint8_t* dir = new uint8_t[(max_a + 1) * (max_b + 1)];
        uint8_t* rev_ops = new uint8_t[max_a + max_b + 2];
#if defined(_OPENMP)
#pragma omp for schedule(dynamic, 16)
#endif
        for (int64_t i = 0; i < n; ++i) {
            const uint8_t* a = a_mat + i * a_width;
            const uint8_t* b = b_mat + i * b_width;
            int la = (int)std::min<int64_t>(a_lens[i], a_width);
            int lb = (int)std::min<int64_t>(b_lens[i], b_width);
            for (int j = 0; j <= lb; ++j) h_prev[j] = 0;
            std::memset(dir, 0, (size_t)(la + 1) * (lb + 1));
            int best = 0, bi = 0, bj = 0;
            for (int r = 1; r <= la; ++r) {
                h_cur[0] = 0;
                uint8_t ac = a[r - 1];
                uint8_t* drow = dir + (int64_t)r * (lb + 1);
                for (int c = 1; c <= lb; ++c) {
                    int sub = h_prev[c - 1] + (ac == b[c - 1] ? 1 : -1);
                    int up = h_prev[c] - 1;    // consume read only (I)
                    int left = h_cur[c - 1] - 1;  // consume window only (D)
                    int v = sub, d = 1;
                    if (up > v) { v = up; d = 2; }
                    if (left > v) { v = left; d = 3; }
                    if (v <= 0) { v = 0; d = 0; }
                    h_cur[c] = v;
                    drow[c] = (uint8_t)d;
                    if (v > best) { best = v; bi = r; bj = c; }
                }
                std::swap(h_prev, h_cur);
            }
            scores[i] = best;
            // traceback from the best cell to the first zero
            int r = bi, c = bj, m = 0;
            while (r > 0 && c > 0) {
                uint8_t d = dir[(int64_t)r * (lb + 1) + c];
                if (d == 0) break;
                if (d == 1) { rev_ops[m++] = 0; --r; --c; }
                else if (d == 2) { rev_ops[m++] = 1; --r; }
                else { rev_ops[m++] = 2; --c; }
            }
            a_start[i] = r; a_end[i] = bi;
            b_start[i] = c; b_end[i] = bj;
            // run-length encode (reversed ops are in reverse alignment order)
            uint8_t* ops = cigar_ops + i * max_ops;
            int32_t* lens = cigar_lens + i * max_ops;
            int k = 0;
            bool overflow = false;
            for (int t = m - 1; t >= 0;) {
                uint8_t op = rev_ops[t];
                int run = 0;
                while (t >= 0 && rev_ops[t] == op) { ++run; --t; }
                if (k >= max_ops) { overflow = true; break; }
                ops[k] = op; lens[k] = run; ++k;
            }
            n_ops[i] = overflow ? 0 : k;
        }
        delete[] h_prev; delete[] h_cur; delete[] dir; delete[] rev_ops;
    }
}

// Banded local alignment WITH traceback for LONG reads (same scoring as
// drm_sw_cigar: match +1 / mismatch -1 / gap -1 linear).  Full DP on a
// 10 kb read would be 10^8+ cells/pair; the chain step already places the
// read to within +-tol, so the alignment lives inside a diagonal band.
//
// b is expected to be the genome segment starting ~`band` bases BEFORE the
// chained read start, so the alignment diagonal sits mid-band: row r may
// visit columns c in [r, r + 2*band].  Banded dir storage is
// (la+1) x (2*band+1) bytes — 100 kb read at band 150 = ~30 MB/thread.
void drm_banded_cigar(const uint8_t* a_mat, const int64_t* a_lens,
                      int64_t a_width, const uint8_t* b_mat,
                      const int64_t* b_lens, int64_t b_width, int64_t n,
                      int32_t band, int32_t* scores, int32_t* a_start,
                      int32_t* a_end, int32_t* b_start, int32_t* b_end,
                      uint8_t* cigar_ops, int32_t* cigar_lens, int32_t* n_ops,
                      int64_t max_ops) {
    const int W = 2 * band + 1;
    const int32_t NEG = -1000000000;
#if defined(_OPENMP)
#pragma omp parallel
#endif
    {
        int32_t* h_prev = new int32_t[W + 2];
        int32_t* h_cur = new int32_t[W + 2];
        uint8_t* dir = new uint8_t[(size_t)(a_width + 1) * W];
        uint8_t* rev_ops = new uint8_t[2 * (size_t)a_width + 2 * W + 4];
#if defined(_OPENMP)
#pragma omp for schedule(dynamic, 1)
#endif
        for (int64_t i = 0; i < n; ++i) {
            const uint8_t* a = a_mat + i * a_width;
            const uint8_t* b = b_mat + i * b_width;
            int la = (int)std::min<int64_t>(a_lens[i], a_width);
            int lb = (int)std::min<int64_t>(b_lens[i], b_width);
            // h_prev[w+1] = H[r-1][c] at w = c - (r-1) shifted by +1 for
            // sentinel margins; row r visits w = c - r in [0, W-1]
            for (int w = 0; w < W + 2; ++w) h_prev[w] = 0;  // row 0: all 0
            std::memset(dir, 0, (size_t)(la + 1) * W);
            int best = 0, bi = 0, bjw = 0;
            for (int r = 1; r <= la; ++r) {
                uint8_t ac = a[r - 1];
                uint8_t* drow = dir + (size_t)r * W;
                h_cur[0] = NEG;  // w-1 sentinel (left move out of band)
                for (int w = 0; w < W; ++w) {
                    int c = r + w;
                    if (c < 1 || c > lb) {
                        h_cur[w + 1] = (c < 1) ? 0 : NEG;
                        continue;
                    }
                    // prev-row mapping: H[r-1][c-1] -> w, H[r-1][c] -> w+1
                    int sub = h_prev[w + 1] + (ac == b[c - 1] ? 1 : -1);
                    int up = h_prev[w + 2] - 1;    // I: consume read only
                    int left = h_cur[w] - 1;       // D: consume segment only
                    int v = sub, d = 1;
                    if (up > v) { v = up; d = 2; }
                    if (left > v) { v = left; d = 3; }
                    if (v <= 0) { v = 0; d = 0; }
                    h_cur[w + 1] = v;
                    drow[w] = (uint8_t)d;
                    if (v > best) { best = v; bi = r; bjw = w; }
                }
                h_cur[W + 1] = NEG;  // w+1 sentinel for the NEXT row's up
                std::swap(h_prev, h_cur);
            }
            scores[i] = best;
            int r = bi, w = bjw, m = 0;
            while (r > 0) {
                uint8_t d = dir[(size_t)r * W + w];
                if (d == 0) break;
                if (d == 1) { rev_ops[m++] = 0; --r; }       // M: w stays
                else if (d == 2) { rev_ops[m++] = 1; --r; ++w; }  // I
                else { rev_ops[m++] = 2; --w; }              // D: same row
                if (w < 0 || w >= W) break;  // band edge (shouldn't happen)
            }
            a_start[i] = r; a_end[i] = bi;
            b_start[i] = r + w; b_end[i] = bi + bjw;
            uint8_t* ops = cigar_ops + i * max_ops;
            int32_t* lens = cigar_lens + i * max_ops;
            int k = 0;
            bool overflow = false;
            for (int t = m - 1; t >= 0;) {
                uint8_t op = rev_ops[t];
                int run = 0;
                while (t >= 0 && rev_ops[t] == op) { ++run; --t; }
                if (k >= max_ops) { overflow = true; break; }
                ops[k] = op; lens[k] = run; ++k;
            }
            n_ops[i] = overflow ? 0 : k;
        }
        delete[] h_prev; delete[] h_cur; delete[] dir; delete[] rev_ops;
    }
}

int32_t drm_version() { return 5; }

}  // extern "C"
