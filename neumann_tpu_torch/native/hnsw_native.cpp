// hnsw_native: multi-layer graph ANN index (HNSW) in C++.
//
// The reference implements HNSW in native Rust with per-node embedding
// storage modes and SIMD distance kernels (tensor_store/src/hnsw.rs:
// HNSWIndex insert/search/search_with_ef, EmbeddingStorage at
// hnsw.rs:564, config at hnsw.rs:1434-1553). On TPU the *bulk* scan
// path is an MXU matmul (ops/scan.py, ops/quant.py) which outruns
// graph-walk ANN on-chip, but HNSW remains the right host-side
// structure for incremental small-index workloads (semantic LLM-cache
// lookup, per-collection indexes that live on the host between device
// syncs), so the TPU build carries a genuine native implementation.
//
// Algorithm: Malkov & Yashunin, "Efficient and robust approximate
// nearest neighbor search using Hierarchical Navigable Small World
// graphs" (public algorithm; implemented from the paper, not from the
// reference's code).
//
// Distance semantics match the reference (hnsw.rs:135-160):
//   cosine    distance = 1 - cos(q, v)      similarity = 1 - d
//   euclidean distance = L2(q, v)           similarity = 1 / (1 + d)
//   dot       distance = -dot(q, v)         similarity = -d
//
// Per-node storage kinds (EmbeddingStorage parity): dense f32,
// scalar-quantized u8 (min/scale dequant), binary sign bits (packed
// u64), sparse COO. Delta/TT nodes are densified by the Python layer
// before insertion (the TPU build keeps compressed forms in the
// store/collection layer; see neumann_tpu/ops/hnsw.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <new>
#include <queue>
#include <vector>

namespace {

constexpr uint8_t KIND_F32 = 0;
constexpr uint8_t KIND_U8 = 1;
constexpr uint8_t KIND_BIN = 2;
constexpr uint8_t KIND_SPARSE = 3;

constexpr int METRIC_COSINE = 0;
constexpr int METRIC_EUCLIDEAN = 1;
constexpr int METRIC_DOT = 2;

struct Node {
    uint8_t kind;
    int32_t level;
    uint64_t off;      // element offset into the kind's pool
    uint32_t nnz;      // sparse only
    float scale;       // u8 dequant: v[i] = bias + scale * code[i]
    float bias;
    float norm;        // cached magnitude (cosine)
    float sumsq;       // cached |v|^2 (euclidean)
};

struct Hnsw {
    int dim;
    int m, m0, efc;
    int metric;
    uint64_t max_nodes;
    double ml;
    uint64_t rng;
    int64_t entry = -1;
    int32_t top_level = -1;
    std::mutex mu;
    // access instrumentation (HNSWStatsSnapshot parity,
    // tensor_store/src/instrumentation.rs:359-373)
    uint64_t n_searches = 0;
    uint64_t n_inserts = 0;
    uint64_t n_dist = 0;          // all distance computations
    uint64_t n_search_dist = 0;   // query-path subset

    std::vector<Node> nodes;
    std::vector<float> pool_f32;
    std::vector<uint8_t> pool_u8;
    std::vector<uint64_t> pool_bin;
    std::vector<uint32_t> pool_sp_idx;
    std::vector<float> pool_sp_val;
    // nbrs[id][layer] = neighbor ids
    std::vector<std::vector<std::vector<uint32_t>>> nbrs;

    size_t bin_words() const { return ((size_t)dim + 63) / 64; }

    double rand_uniform() {
        // xorshift64*; never returns 0
        rng ^= rng >> 12;
        rng ^= rng << 25;
        rng ^= rng >> 27;
        uint64_t x = rng * 0x2545F4914F6CDD1DULL;
        return ((x >> 11) + 1) * (1.0 / 9007199254740993.0);
    }

    int random_level() {
        double u = rand_uniform();
        int l = (int)(-std::log(u) * ml);
        return l < 0 ? 0 : (l > 63 ? 63 : l);
    }

    // dot(q, node) with q dense f32 of length dim
    float dot_node(const float* q, const Node& nd) const {
        switch (nd.kind) {
            case KIND_F32: {
                const float* v = pool_f32.data() + nd.off;
                double s = 0;
                for (int i = 0; i < dim; i++) s += (double)q[i] * v[i];
                return (float)s;
            }
            case KIND_U8: {
                const uint8_t* c = pool_u8.data() + nd.off;
                double sc = 0, sq = 0;
                for (int i = 0; i < dim; i++) {
                    sc += (double)q[i] * c[i];
                    sq += q[i];
                }
                return (float)(nd.scale * sc + nd.bias * sq);
            }
            case KIND_BIN: {
                // bit set => +1, clear => -1: dot = 2*sum_set - sum_all
                const uint64_t* w = pool_bin.data() + nd.off;
                double set_sum = 0, all = 0;
                for (int i = 0; i < dim; i++) {
                    all += q[i];
                    if (w[i >> 6] & (1ULL << (i & 63))) set_sum += q[i];
                }
                return (float)(2.0 * set_sum - all);
            }
            default: {  // KIND_SPARSE
                const uint32_t* ix = pool_sp_idx.data() + nd.off;
                const float* va = pool_sp_val.data() + nd.off;
                double s = 0;
                for (uint32_t i = 0; i < nd.nnz; i++)
                    s += (double)q[ix[i]] * va[i];
                return (float)s;
            }
        }
    }

    float distance(const float* q, float qnorm, float qsumsq,
                   const Node& nd) {
        n_dist++;
        float d = dot_node(q, nd);
        switch (metric) {
            case METRIC_COSINE: {
                float denom = qnorm * nd.norm;
                return denom > 0 ? 1.0f - d / denom : 1.0f;
            }
            case METRIC_EUCLIDEAN: {
                float s = qsumsq - 2.0f * d + nd.sumsq;
                return s > 0 ? std::sqrt(s) : 0.0f;
            }
            default:
                return -d;
        }
    }

    void reconstruct(int64_t id, float* out) const {
        const Node& nd = nodes[id];
        switch (nd.kind) {
            case KIND_F32:
                std::memcpy(out, pool_f32.data() + nd.off,
                            sizeof(float) * dim);
                break;
            case KIND_U8: {
                const uint8_t* c = pool_u8.data() + nd.off;
                for (int i = 0; i < dim; i++)
                    out[i] = nd.bias + nd.scale * c[i];
                break;
            }
            case KIND_BIN: {
                const uint64_t* w = pool_bin.data() + nd.off;
                for (int i = 0; i < dim; i++)
                    out[i] = (w[i >> 6] & (1ULL << (i & 63))) ? 1.0f
                                                              : -1.0f;
                break;
            }
            default: {
                std::memset(out, 0, sizeof(float) * dim);
                const uint32_t* ix = pool_sp_idx.data() + nd.off;
                const float* va = pool_sp_val.data() + nd.off;
                for (uint32_t i = 0; i < nd.nnz; i++) out[ix[i]] = va[i];
            }
        }
    }
};

struct Cand {
    float dist;
    uint32_t id;
};
struct NearFirst {
    bool operator()(const Cand& a, const Cand& b) const {
        return a.dist > b.dist;
    }
};
struct FarFirst {
    bool operator()(const Cand& a, const Cand& b) const {
        return a.dist < b.dist;
    }
};

// search one layer: returns up to ef nearest as a near-sorted vector
static std::vector<Cand> search_layer(Hnsw* h, const float* q,
                                      float qn, float qs, uint32_t ep,
                                      size_t ef, int layer,
                                      std::vector<uint8_t>& visited) {
    std::fill(visited.begin(), visited.end(), 0);
    std::priority_queue<Cand, std::vector<Cand>, NearFirst> cands;
    std::priority_queue<Cand, std::vector<Cand>, FarFirst> best;
    float d0 = h->distance(q, qn, qs, h->nodes[ep]);
    visited[ep] = 1;
    cands.push({d0, ep});
    best.push({d0, ep});
    while (!cands.empty()) {
        Cand cur = cands.top();
        if (best.size() >= ef && cur.dist > best.top().dist) break;
        cands.pop();
        for (uint32_t nb : h->nbrs[cur.id][layer]) {
            if (visited[nb]) continue;
            visited[nb] = 1;
            float d = h->distance(q, qn, qs, h->nodes[nb]);
            if (best.size() < ef || d < best.top().dist) {
                cands.push({d, nb});
                best.push({d, nb});
                if (best.size() > ef) best.pop();
            }
        }
    }
    std::vector<Cand> out(best.size());
    for (size_t i = out.size(); i-- > 0;) {
        out[i] = best.top();
        best.pop();
    }
    return out;  // ascending distance
}

// Heuristic neighbor selection (paper's SELECT-NEIGHBORS-HEURISTIC):
// keep a candidate only if it is closer to the base than to every
// already-kept neighbor — preserves graph diversity across clusters.
static std::vector<uint32_t> select_neighbors(Hnsw* h,
                                              std::vector<Cand> cands,
                                              size_t m,
                                              std::vector<float>& scratch) {
    std::sort(cands.begin(), cands.end(),
              [](const Cand& a, const Cand& b) { return a.dist < b.dist; });
    std::vector<uint32_t> kept;
    std::vector<const float*> kept_vec;
    size_t dim = (size_t)h->dim;
    scratch.resize(cands.size() * dim);
    for (size_t ci = 0; ci < cands.size() && kept.size() < m; ci++) {
        float* cv = scratch.data() + ci * dim;
        h->reconstruct(cands[ci].id, cv);
        float cn = 0;
        for (size_t i = 0; i < dim; i++) cn += cv[i] * cv[i];
        float cnorm = std::sqrt(cn);
        bool ok = true;
        for (const float* kv : kept_vec) {
            // distance(candidate, kept) < distance(candidate, base)?
            double dot = 0, kn = 0;
            for (size_t i = 0; i < dim; i++) {
                dot += (double)cv[i] * kv[i];
                kn += (double)kv[i] * kv[i];
            }
            float d_ck;
            switch (h->metric) {
                case METRIC_COSINE: {
                    double denom = cnorm * std::sqrt(kn);
                    d_ck = denom > 0 ? (float)(1.0 - dot / denom) : 1.0f;
                    break;
                }
                case METRIC_EUCLIDEAN: {
                    double s = cn - 2.0 * dot + kn;
                    d_ck = s > 0 ? (float)std::sqrt(s) : 0.0f;
                    break;
                }
                default:
                    d_ck = (float)-dot;
            }
            if (d_ck < cands[ci].dist) {
                ok = false;
                break;
            }
        }
        if (ok) {
            kept.push_back(cands[ci].id);
            kept_vec.push_back(cv);
        }
    }
    // fill remaining slots with the nearest skipped candidates
    if (kept.size() < m) {
        for (const Cand& c : cands) {
            if (kept.size() >= m) break;
            if (std::find(kept.begin(), kept.end(), c.id) == kept.end())
                kept.push_back(c.id);
        }
    }
    return kept;
}

static void prune_node(Hnsw* h, uint32_t id, int layer, size_t cap,
                       std::vector<float>& scratch,
                       std::vector<float>& base) {
    auto& lst = h->nbrs[id][layer];
    if (lst.size() <= cap) return;
    base.resize(h->dim);
    h->reconstruct(id, base.data());
    float bn = 0, bs = 0;
    for (int i = 0; i < h->dim; i++) bs += base[i] * base[i];
    bn = std::sqrt(bs);
    std::vector<Cand> cands;
    cands.reserve(lst.size());
    for (uint32_t nb : lst)
        cands.push_back({h->distance(base.data(), bn, bs, h->nodes[nb]),
                         nb});
    lst = select_neighbors(h, std::move(cands), cap, scratch);
}

static int64_t insert_node(Hnsw* h, uint8_t kind, const float* dense,
                           const uint32_t* sp_idx, const float* sp_val,
                           uint32_t nnz) {
    std::lock_guard<std::mutex> g(h->mu);
    if (h->max_nodes && h->nodes.size() >= h->max_nodes) return -1;

    Node nd{};
    nd.kind = kind;
    nd.level = h->random_level();
    // densify for construction-time queries
    std::vector<float> q((size_t)h->dim, 0.0f);
    switch (kind) {
        case KIND_F32:
            nd.off = h->pool_f32.size();
            h->pool_f32.insert(h->pool_f32.end(), dense, dense + h->dim);
            std::memcpy(q.data(), dense, sizeof(float) * h->dim);
            break;
        case KIND_U8: {
            float lo = dense[0], hi = dense[0];
            for (int i = 1; i < h->dim; i++) {
                lo = std::min(lo, dense[i]);
                hi = std::max(hi, dense[i]);
            }
            float scale = (hi - lo) / 255.0f;
            if (scale <= 0) scale = 1.0f;
            nd.scale = scale;
            nd.bias = lo;
            nd.off = h->pool_u8.size();
            for (int i = 0; i < h->dim; i++) {
                int c = (int)std::lround((dense[i] - lo) / scale);
                uint8_t code =
                    (uint8_t)(c < 0 ? 0 : (c > 255 ? 255 : c));
                h->pool_u8.push_back(code);
                q[i] = lo + scale * code;  // construction sees dequant
            }
            break;
        }
        case KIND_BIN: {
            nd.off = h->pool_bin.size();
            size_t words = h->bin_words();
            h->pool_bin.resize(nd.off + words, 0);
            uint64_t* w = h->pool_bin.data() + nd.off;
            for (int i = 0; i < h->dim; i++) {
                bool set = dense[i] > 0;
                if (set) w[i >> 6] |= 1ULL << (i & 63);
                q[i] = set ? 1.0f : -1.0f;
            }
            break;
        }
        default: {  // KIND_SPARSE
            nd.nnz = nnz;
            nd.off = h->pool_sp_idx.size();
            h->pool_sp_idx.insert(h->pool_sp_idx.end(), sp_idx,
                                  sp_idx + nnz);
            h->pool_sp_val.insert(h->pool_sp_val.end(), sp_val,
                                  sp_val + nnz);
            for (uint32_t i = 0; i < nnz; i++)
                if (sp_idx[i] < (uint32_t)h->dim) q[sp_idx[i]] = sp_val[i];
        }
    }
    double ss = 0;
    for (int i = 0; i < h->dim; i++) ss += (double)q[i] * q[i];
    nd.sumsq = (float)ss;
    nd.norm = (float)std::sqrt(ss);

    h->n_inserts++;
    int64_t id = (int64_t)h->nodes.size();
    h->nodes.push_back(nd);
    h->nbrs.emplace_back((size_t)nd.level + 1);

    if (h->entry < 0) {
        h->entry = id;
        h->top_level = nd.level;
        return id;
    }

    float qn = nd.norm, qs = nd.sumsq;
    std::vector<uint8_t> visited(h->nodes.size(), 0);
    std::vector<float> scratch, base;
    uint32_t ep = (uint32_t)h->entry;
    // greedy descent above the node's level
    for (int layer = h->top_level; layer > nd.level; layer--) {
        bool moved = true;
        float d = h->distance(q.data(), qn, qs, h->nodes[ep]);
        while (moved) {
            moved = false;
            for (uint32_t nb : h->nbrs[ep][layer]) {
                float dn = h->distance(q.data(), qn, qs, h->nodes[nb]);
                if (dn < d) {
                    d = dn;
                    ep = nb;
                    moved = true;
                }
            }
        }
    }
    // connect at each layer from min(level, top) down to 0
    for (int layer = std::min((int)nd.level, (int)h->top_level);
         layer >= 0; layer--) {
        auto found = search_layer(h, q.data(), qn, qs, ep,
                                  (size_t)h->efc, layer, visited);
        size_t cap = layer == 0 ? (size_t)h->m0 : (size_t)h->m;
        auto sel = select_neighbors(h, found, (size_t)h->m, scratch);
        h->nbrs[id][layer] = sel;
        for (uint32_t nb : sel) {
            h->nbrs[nb][layer].push_back((uint32_t)id);
            prune_node(h, nb, layer, cap, scratch, base);
        }
        if (!found.empty()) ep = found[0].id;
    }
    if (nd.level > h->top_level) {
        h->top_level = nd.level;
        h->entry = id;
    }
    return id;
}

template <typename T>
static void put(std::vector<uint8_t>& out, const T& v) {
    const uint8_t* p = (const uint8_t*)&v;
    out.insert(out.end(), p, p + sizeof(T));
}
template <typename T>
static bool take(const uint8_t*& p, const uint8_t* end, T* v) {
    if (p + sizeof(T) > end) return false;
    std::memcpy(v, p, sizeof(T));
    p += sizeof(T);
    return true;
}

}  // namespace

extern "C" {

void* nn_hnsw_new(int dim, int m, int m0, int efc, int metric,
                  uint64_t max_nodes, uint64_t seed) {
    if (dim <= 0 || m <= 0 || m0 <= 0 || efc <= 0) return nullptr;
    auto* h = new (std::nothrow) Hnsw();
    if (!h) return nullptr;
    h->dim = dim;
    h->m = m;
    h->m0 = m0;
    h->efc = efc;
    h->metric = metric;
    h->max_nodes = max_nodes;
    h->ml = 1.0 / std::log((double)m);
    h->rng = seed ? seed : 0x9E3779B97F4A7C15ULL;
    return h;
}

void nn_hnsw_free(void* h) { delete (Hnsw*)h; }

size_t nn_hnsw_len(void* h) {
    auto* x = (Hnsw*)h;
    std::lock_guard<std::mutex> g(x->mu);
    return x->nodes.size();
}

int64_t nn_hnsw_insert(void* h, const float* vec) {
    return insert_node((Hnsw*)h, KIND_F32, vec, nullptr, nullptr, 0);
}

int64_t nn_hnsw_insert_quantized(void* h, const float* vec) {
    return insert_node((Hnsw*)h, KIND_U8, vec, nullptr, nullptr, 0);
}

int64_t nn_hnsw_insert_binary(void* h, const float* vec) {
    return insert_node((Hnsw*)h, KIND_BIN, vec, nullptr, nullptr, 0);
}

int64_t nn_hnsw_insert_sparse(void* h, const uint32_t* idx,
                              const float* val, uint32_t nnz) {
    return insert_node((Hnsw*)h, KIND_SPARSE, nullptr, idx, val, nnz);
}

int nn_hnsw_kind(void* h, int64_t id) {
    auto* x = (Hnsw*)h;
    std::lock_guard<std::mutex> g(x->mu);
    if (id < 0 || (size_t)id >= x->nodes.size()) return -1;
    return x->nodes[id].kind;
}

// reconstruct a stored vector; returns 0 on success
int nn_hnsw_get(void* h, int64_t id, float* out) {
    auto* x = (Hnsw*)h;
    std::lock_guard<std::mutex> g(x->mu);
    if (id < 0 || (size_t)id >= x->nodes.size()) return -1;
    x->reconstruct(id, out);
    return 0;
}

uint64_t nn_hnsw_memory_bytes(void* h) {
    auto* x = (Hnsw*)h;
    std::lock_guard<std::mutex> g(x->mu);
    uint64_t b = x->pool_f32.size() * 4 + x->pool_u8.size() +
                 x->pool_bin.size() * 8 + x->pool_sp_idx.size() * 4 +
                 x->pool_sp_val.size() * 4 +
                 x->nodes.size() * sizeof(Node);
    for (auto& per : x->nbrs)
        for (auto& l : per) b += l.size() * 4 + sizeof(l);
    return b;
}

// search with explicit ef; out_ids/out_scores sized k; returns found
size_t nn_hnsw_search(void* h, const float* q, size_t k, size_t ef,
                      int64_t* out_ids, float* out_scores) {
    auto* x = (Hnsw*)h;
    std::lock_guard<std::mutex> g(x->mu);
    if (x->entry < 0 || k == 0) return 0;
    x->n_searches++;
    uint64_t dist_before = x->n_dist;
    double ss = 0;
    for (int i = 0; i < x->dim; i++) ss += (double)q[i] * q[i];
    float qs = (float)ss, qn = (float)std::sqrt(ss);
    uint32_t ep = (uint32_t)x->entry;
    for (int layer = x->top_level; layer > 0; layer--) {
        bool moved = true;
        float d = x->distance(q, qn, qs, x->nodes[ep]);
        while (moved) {
            moved = false;
            for (uint32_t nb : x->nbrs[ep][layer]) {
                float dn = x->distance(q, qn, qs, x->nodes[nb]);
                if (dn < d) {
                    d = dn;
                    ep = nb;
                    moved = true;
                }
            }
        }
    }
    std::vector<uint8_t> visited(x->nodes.size(), 0);
    if (ef < k) ef = k;
    auto found = search_layer(x, q, qn, qs, ep, ef, 0, visited);
    x->n_search_dist += x->n_dist - dist_before;
    size_t n = std::min(k, found.size());
    for (size_t i = 0; i < n; i++) {
        out_ids[i] = found[i].id;
        float d = found[i].dist;
        switch (x->metric) {
            case METRIC_COSINE:
                out_scores[i] = 1.0f - d;
                break;
            case METRIC_EUCLIDEAN:
                out_scores[i] = 1.0f / (1.0f + d);
                break;
            default:
                out_scores[i] = -d;
        }
    }
    return n;
}

// out4 = [searches, inserts, total distance calcs, query-path calcs]
void nn_hnsw_stats(void* h, uint64_t* out4) {
    auto* x = (Hnsw*)h;
    std::lock_guard<std::mutex> g(x->mu);
    out4[0] = x->n_searches;
    out4[1] = x->n_inserts;
    out4[2] = x->n_dist;
    out4[3] = x->n_search_dist;
}

// Two-call serialize protocol: returns total bytes; fills out if cap
// is sufficient.
size_t nn_hnsw_serialize(void* h, uint8_t* out, size_t cap) {
    auto* x = (Hnsw*)h;
    std::lock_guard<std::mutex> g(x->mu);
    std::vector<uint8_t> buf;
    buf.reserve(64 + x->pool_f32.size() * 4);
    const char magic[4] = {'N', 'H', 'N', '1'};
    buf.insert(buf.end(), magic, magic + 4);
    put(buf, (int32_t)x->dim);
    put(buf, (int32_t)x->m);
    put(buf, (int32_t)x->m0);
    put(buf, (int32_t)x->efc);
    put(buf, (int32_t)x->metric);
    put(buf, (uint64_t)x->max_nodes);
    put(buf, (uint64_t)x->rng);
    put(buf, (int64_t)x->entry);
    put(buf, (int32_t)x->top_level);
    put(buf, (uint64_t)x->nodes.size());
    for (size_t id = 0; id < x->nodes.size(); id++) {
        const Node& nd = x->nodes[id];
        put(buf, nd.kind);
        put(buf, nd.level);
        put(buf, nd.scale);
        put(buf, nd.bias);
        put(buf, nd.norm);
        put(buf, nd.sumsq);
        switch (nd.kind) {
            case KIND_F32: {
                const uint8_t* p =
                    (const uint8_t*)(x->pool_f32.data() + nd.off);
                buf.insert(buf.end(), p, p + (size_t)x->dim * 4);
                break;
            }
            case KIND_U8:
                buf.insert(buf.end(), x->pool_u8.begin() + nd.off,
                           x->pool_u8.begin() + nd.off + x->dim);
                break;
            case KIND_BIN: {
                const uint8_t* p =
                    (const uint8_t*)(x->pool_bin.data() + nd.off);
                buf.insert(buf.end(), p, p + x->bin_words() * 8);
                break;
            }
            default: {
                put(buf, nd.nnz);
                const uint8_t* pi =
                    (const uint8_t*)(x->pool_sp_idx.data() + nd.off);
                buf.insert(buf.end(), pi, pi + (size_t)nd.nnz * 4);
                const uint8_t* pv =
                    (const uint8_t*)(x->pool_sp_val.data() + nd.off);
                buf.insert(buf.end(), pv, pv + (size_t)nd.nnz * 4);
            }
        }
        for (int layer = 0; layer <= nd.level; layer++) {
            put(buf, (uint32_t)x->nbrs[id][layer].size());
            const uint8_t* p =
                (const uint8_t*)x->nbrs[id][layer].data();
            buf.insert(buf.end(), p,
                       p + x->nbrs[id][layer].size() * 4);
        }
    }
    if (out && buf.size() <= cap)
        std::memcpy(out, buf.data(), buf.size());
    return buf.size();
}

void* nn_hnsw_deserialize(const uint8_t* data, size_t size) {
    const uint8_t* p = data;
    const uint8_t* end = data + size;
    if (size < 4 || std::memcmp(p, "NHN1", 4) != 0) return nullptr;
    p += 4;
    int32_t dim, m, m0, efc, metric, top_level;
    uint64_t max_nodes, rng, n;
    int64_t entry;
    if (!take(p, end, &dim) || !take(p, end, &m) || !take(p, end, &m0) ||
        !take(p, end, &efc) || !take(p, end, &metric) ||
        !take(p, end, &max_nodes) || !take(p, end, &rng) ||
        !take(p, end, &entry) || !take(p, end, &top_level) ||
        !take(p, end, &n))
        return nullptr;
    // every record is >= 21 bytes; a corrupt count must not reserve
    if (n > size / 21 + 1) return nullptr;
    if (top_level < -1 || top_level > 63) return nullptr;
    if (metric < 0 || metric > 2) return nullptr;
    auto* h = (Hnsw*)nn_hnsw_new(dim, m, m0, efc, metric, max_nodes, 1);
    if (!h) return nullptr;
    h->rng = rng;
    h->entry = entry;
    h->top_level = top_level;
    for (uint64_t id = 0; id < n; id++) {
        Node nd{};
        if (!take(p, end, &nd.kind) || !take(p, end, &nd.level) ||
            !take(p, end, &nd.scale) || !take(p, end, &nd.bias) ||
            !take(p, end, &nd.norm) || !take(p, end, &nd.sumsq))
            goto fail;
        // level drives allocations (nbrs gets level+1 layers): the
        // writer only emits 0..63, so anything else is corruption —
        // without this check a poisoned byte demands a ~48GB alloc
        if (nd.level < 0 || nd.level > 63) goto fail;
        switch (nd.kind) {
            case KIND_F32: {
                size_t bytes = (size_t)dim * 4;
                if (p + bytes > end) goto fail;
                nd.off = h->pool_f32.size();
                h->pool_f32.resize(nd.off + dim);
                std::memcpy(h->pool_f32.data() + nd.off, p, bytes);
                p += bytes;
                break;
            }
            case KIND_U8: {
                if (p + dim > end) goto fail;
                nd.off = h->pool_u8.size();
                h->pool_u8.insert(h->pool_u8.end(), p, p + dim);
                p += dim;
                break;
            }
            case KIND_BIN: {
                size_t bytes = h->bin_words() * 8;
                if (p + bytes > end) goto fail;
                nd.off = h->pool_bin.size();
                h->pool_bin.resize(nd.off + h->bin_words());
                std::memcpy(h->pool_bin.data() + nd.off, p, bytes);
                p += bytes;
                break;
            }
            case KIND_SPARSE: {
                if (!take(p, end, &nd.nnz)) goto fail;
                if (nd.nnz > (uint32_t)dim) goto fail;
                size_t bytes = (size_t)nd.nnz * 4;
                if (p + 2 * bytes > end) goto fail;
                nd.off = h->pool_sp_idx.size();
                h->pool_sp_idx.resize(nd.off + nd.nnz);
                std::memcpy(h->pool_sp_idx.data() + nd.off, p, bytes);
                p += bytes;
                h->pool_sp_val.resize(nd.off + nd.nnz);
                std::memcpy(h->pool_sp_val.data() + nd.off, p, bytes);
                p += bytes;
                break;
            }
            default:
                goto fail;
        }
        h->nodes.push_back(nd);
        h->nbrs.emplace_back((size_t)nd.level + 1);
        for (int layer = 0; layer <= nd.level; layer++) {
            uint32_t cnt;
            if (!take(p, end, &cnt)) goto fail;
            size_t bytes = (size_t)cnt * 4;
            if (p + bytes > end || cnt > n) goto fail;
            auto& lst = h->nbrs.back()[layer];
            lst.resize(cnt);
            std::memcpy(lst.data(), p, bytes);
            p += bytes;
        }
    }
    if (h->entry >= (int64_t)h->nodes.size()) goto fail;
    return h;
fail:
    delete h;
    return nullptr;
}

}  // extern "C"
