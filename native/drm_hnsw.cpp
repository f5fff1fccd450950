// Native HNSW graph builder.
//
// Graph construction is inherently sequential/divergent — the one part of the
// index that stays on the host (search is the device-vectorized side,
// deepreadmapper_tpu/index/hnsw.py).  The Python builder in hnsw_build.py is
// the readable specification; this is the production implementation
// (~1000x faster), same algorithm:
//   * caller-provided per-node levels (deterministic, computed in numpy)
//   * efConstruction beam search per insert (visited-epoch trick)
//   * heuristic neighbor selection, degree caps M (upper) / 2M (level 0)
//   * bidirectional links with heuristic pruning
// OpenMP-parallel inserts with per-node locks, hnswlib-style: sequential
// within a small prefix to seed the graph, then parallel batches.
//
// Output layout (matches hnsw_build.HNSWGraphData):
//   neighbors0 [n, 2m] int32, -1 padded (global ids)
//   upper      [sum_{l>=1} nl, m] int32 (global ids), rows ordered by level
//              then ascending gid — the Python wrapper rebuilds level_gids
//              itself from the levels array.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <queue>
#include <utility>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

struct Cand {
    float d;
    int32_t id;
};
struct CandCmpMin {  // min-heap by distance
    bool operator()(const Cand& a, const Cand& b) const { return a.d > b.d; }
};
struct CandCmpMax {  // max-heap by distance
    bool operator()(const Cand& a, const Cand& b) const { return a.d < b.d; }
};

class Builder {
  public:
    Builder(const float* v, int64_t n, int64_t dim, const int32_t* levels,
            int32_t max_level, int32_t m, int32_t efc)
        : v_(v), n_(n), dim_(dim), levels_(levels), max_level_(max_level),
          m_(m), m0_(2 * m), efc_(efc) {
        nbrs_.resize(max_level + 1);
        cnt_.resize(max_level + 1);
        for (int l = 0; l <= max_level; ++l) {
            int cap = (l == 0) ? m0_ : m_;
            nbrs_[l].assign(n_ * cap, -1);
            cnt_[l].assign(n_, 0);
        }
        locks_ = std::vector<std::mutex>(1024);
        entry_ = -1;
        entry_level_ = -1;
    }

    inline float dist(const float* a, const float* b) const {
        float s = 0.f;
        for (int64_t i = 0; i < dim_; ++i) {
            float d = a[i] - b[i];
            s += d * d;
        }
        return s;
    }
    inline float dist_id(int32_t a, int32_t b) const {
        return dist(v_ + (int64_t)a * dim_, v_ + (int64_t)b * dim_);
    }
    inline float dist_q(const float* q, int32_t b) const {
        return dist(q, v_ + (int64_t)b * dim_);
    }

    // Beam search on one layer; returns up to ef candidates ascending.
    void search_layer(const float* q, int32_t ep, int lvl, int ef,
                      std::vector<Cand>& out, std::vector<int32_t>& visited,
                      int32_t& epoch) const {
        ++epoch;
        std::priority_queue<Cand, std::vector<Cand>, CandCmpMin> cand;
        std::priority_queue<Cand, std::vector<Cand>, CandCmpMax> best;
        float d0 = dist_q(q, ep);
        cand.push({d0, ep});
        best.push({d0, ep});
        visited[ep] = epoch;
        int cap = (lvl == 0) ? m0_ : m_;
        while (!cand.empty()) {
            Cand c = cand.top();
            if ((int)best.size() >= ef && c.d > best.top().d) break;
            cand.pop();
            const int32_t* row = nbrs_[lvl].data() + (int64_t)c.id * cap;
            for (int j = 0; j < cap; ++j) {
                int32_t nb = row[j];
                if (nb < 0) break;
                if (visited[nb] == epoch) continue;
                visited[nb] = epoch;
                float dn = dist_q(q, nb);
                if ((int)best.size() < ef || dn < best.top().d) {
                    cand.push({dn, nb});
                    best.push({dn, nb});
                    if ((int)best.size() > ef) best.pop();
                }
            }
        }
        out.clear();
        out.resize(best.size());
        for (int i = (int)best.size() - 1; i >= 0; --i) {
            out[i] = best.top();
            best.pop();
        }
    }

    // Heuristic shrink: keep a candidate only if closer to q than to every
    // already-selected neighbor (candidates must be ascending by d).
    void select_heuristic(const std::vector<Cand>& cand, int m,
                          std::vector<Cand>& sel) const {
        sel.clear();
        for (const Cand& c : cand) {
            if ((int)sel.size() >= m) break;
            bool ok = true;
            for (const Cand& s : sel) {
                if (dist_id(c.id, s.id) <= c.d) {
                    ok = false;
                    break;
                }
            }
            if (ok) sel.push_back(c);
        }
    }

    void connect(int lvl, int32_t a, int32_t b, float dab,
                 std::vector<Cand>& scratch, std::vector<Cand>& sel) {
        int cap = (lvl == 0) ? m0_ : m_;
        std::lock_guard<std::mutex> g(locks_[a & 1023]);
        int32_t* row = nbrs_[lvl].data() + (int64_t)a * cap;
        int c = cnt_[lvl][a];
        for (int j = 0; j < c; ++j)
            if (row[j] == b) return;  // already linked
        if (c < cap) {
            row[c] = b;
            cnt_[lvl][a] = c + 1;
            return;
        }
        scratch.clear();
        for (int j = 0; j < c; ++j) scratch.push_back({dist_id(a, row[j]), row[j]});
        scratch.push_back({dab, b});
        std::sort(scratch.begin(), scratch.end(),
                  [](const Cand& x, const Cand& y) { return x.d < y.d; });
        select_heuristic(scratch, cap, sel);
        for (int j = 0; j < cap; ++j) row[j] = -1;
        for (size_t j = 0; j < sel.size(); ++j) row[j] = sel[j].id;
        cnt_[lvl][a] = (int32_t)sel.size();
    }

    void add(int32_t i, std::vector<int32_t>& visited, int32_t& epoch,
             std::vector<Cand>& res, std::vector<Cand>& sel,
             std::vector<Cand>& scratch, std::vector<Cand>& sel2) {
        int lvl = levels_[i];
        const float* q = v_ + (int64_t)i * dim_;
        int32_t ep;
        int top;
        {
            std::lock_guard<std::mutex> g(entry_mu_);
            if (entry_ < 0) {
                entry_ = i;
                entry_level_ = lvl;
                return;
            }
            ep = entry_;
            top = entry_level_;
        }
        for (int l = top; l > lvl; --l) {
            search_layer(q, ep, l, 1, res, visited, epoch);
            if (!res.empty()) ep = res[0].id;
        }
        for (int l = std::min(top, lvl); l >= 0; --l) {
            search_layer(q, ep, l, efc_, res, visited, epoch);
            select_heuristic(res, m_, sel);
            int cap = (l == 0) ? m0_ : m_;
            {
                std::lock_guard<std::mutex> g(locks_[i & 1023]);
                int32_t* row = nbrs_[l].data() + (int64_t)i * cap;
                int c = cnt_[l][i];
                for (const Cand& s : sel) {
                    if (c >= cap) break;
                    row[c++] = s.id;
                }
                cnt_[l][i] = c;
            }
            for (const Cand& s : sel) connect(l, s.id, i, s.d, scratch, sel2);
            if (!res.empty()) ep = res[0].id;
        }
        if (lvl > top) {
            std::lock_guard<std::mutex> g(entry_mu_);
            if (lvl > entry_level_) {
                entry_ = i;
                entry_level_ = lvl;
            }
        }
    }

    void build(int threads) {
        // Seed the graph sequentially so early inserts see a connected core.
        int64_t seq = std::min<int64_t>(n_, 1024);
        std::vector<int32_t> visited(n_, 0);
        int32_t epoch = 0;
        std::vector<Cand> res, sel, scratch, sel2;
        for (int64_t i = 0; i < seq; ++i)
            add((int32_t)i, visited, epoch, res, sel, scratch, sel2);
#if defined(_OPENMP)
#pragma omp parallel num_threads(threads)
        {
            std::vector<int32_t> vis(n_, 0);
            int32_t ep = 0;
            std::vector<Cand> r, s1, s2, s3;
#pragma omp for schedule(dynamic, 64)
            for (int64_t i = seq; i < n_; ++i)
                add((int32_t)i, vis, ep, r, s1, s2, s3);
        }
#else
        for (int64_t i = seq; i < n_; ++i)
            add((int32_t)i, visited, epoch, res, sel, scratch, sel2);
#endif
    }

    void export_graph(int32_t* neighbors0, int32_t* upper) const {
        std::memcpy(neighbors0, nbrs_[0].data(), (size_t)n_ * m0_ * sizeof(int32_t));
        int64_t row = 0;
        for (int l = 1; l <= max_level_; ++l) {
            for (int64_t i = 0; i < n_; ++i) {
                if (levels_[i] < l) continue;
                std::memcpy(upper + row * m_, nbrs_[l].data() + i * m_,
                            m_ * sizeof(int32_t));
                ++row;
            }
        }
    }

    int32_t entry() const { return entry_; }

  private:
    const float* v_;
    int64_t n_, dim_;
    const int32_t* levels_;
    int32_t max_level_, m_, m0_, efc_;
    std::vector<std::vector<int32_t>> nbrs_;
    std::vector<std::vector<int32_t>> cnt_;
    mutable std::vector<std::mutex> locks_;
    std::mutex entry_mu_;
    int32_t entry_;
    int entry_level_;
};

}  // namespace

extern "C" {

// Returns the entry gid.  neighbors0: [n, 2m]; upper: [sum nl (l>=1), m].
int32_t drm_hnsw_build(const float* vectors, int64_t n, int64_t dim,
                       const int32_t* levels, int32_t max_level, int32_t m,
                       int32_t efc, int32_t threads, int32_t* neighbors0,
                       int32_t* upper) {
    Builder b(vectors, n, dim, levels, max_level, m, efc);
    b.build(threads);
    b.export_graph(neighbors0, upper);
    return b.entry();
}

}  // extern "C"
