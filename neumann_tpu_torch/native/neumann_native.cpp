// neumann_native: hot host-path routines in C++.
//
// The reference implements its WAL framing, CRC checking, and id codecs
// in native Rust (tensor_store/src/wal.rs, tensor_compress codecs); this
// module is the C++ equivalent for the TPU build's host runtime, exposed
// to Python via ctypes. The Python implementations remain as the
// portable fallback and the format specification.
//
// Build: g++ -O3 -shared -fPIC neumann_native.cpp -o libneumann_native.so

#include <cstdint>
#include <cstring>
#include <cmath>
#include <cstddef>
#include <mutex>
#include <new>
#include <set>
#include <string>

#include <ext/pb_ds/assoc_container.hpp>
#include <ext/pb_ds/tree_policy.hpp>

// ---------------------------------------------------------------------
// OrderedKeyIndex: 16-way sharded ordered key sets.
//
// The reference's MetadataSlab is 16 sharded BTreeMaps routed by the
// first key byte with ordered iteration (tensor_store/src/
// metadata_slab.rs). Here the shard is the HIGH NIBBLE of the first
// byte, so concatenating shards 0..15 in order yields global
// lexicographic order without a merge. Values stay in the Python dict;
// this index makes ordered prefix/range scans O(log n + m).
// ---------------------------------------------------------------------

namespace {

// Order-statistics tree: like std::set<std::string> but with
// order_of_key() rank queries in O(log n), so prefix/range COUNTS are
// two rank lookups instead of an O(m) walk (the reference's
// MetadataSlab count path is similarly sub-linear).
using KeySet = __gnu_pbds::tree<
    std::string, __gnu_pbds::null_type, std::less<std::string>,
    __gnu_pbds::rb_tree_tag, __gnu_pbds::tree_order_statistics_node_update>;

struct OrderedKeyIndex {
    KeySet shards[16];
    std::mutex mu;

    static size_t shard_of(const char* key, size_t len) {
        return len ? ((unsigned char)key[0]) >> 4 : 0;
    }
};

// Smallest string strictly greater than every string with prefix p
// (empty => unbounded). Handles trailing 0xFF by shortening.
static std::string prefix_end(const std::string& p) {
    std::string e = p;
    while (!e.empty() && (unsigned char)e.back() == 0xFF) e.pop_back();
    if (!e.empty()) e.back() = (char)((unsigned char)e.back() + 1);
    return e;  // empty => no upper bound
}

// Walk keys in [lo, hi) (hi empty+unbounded=false means empty string
// bound; use unbounded flag). Appends newline-joined keys to out (up
// to cap) and returns the total byte length required.
static size_t collect(OrderedKeyIndex* ix, const std::string& lo,
                      const std::string& hi, bool unbounded,
                      char* out, size_t cap) {
    size_t need = 0;
    size_t lo_shard = lo.empty() ? 0 : OrderedKeyIndex::shard_of(
        lo.data(), lo.size());
    size_t hi_shard = unbounded ? 15 : (hi.empty() ? 0 :
        OrderedKeyIndex::shard_of(hi.data(), hi.size()));
    for (size_t s = lo_shard; s <= hi_shard && s < 16; s++) {
        auto& set = ix->shards[s];
        auto it = lo.empty() ? set.begin() : set.lower_bound(lo);
        for (; it != set.end(); ++it) {
            if (!unbounded && *it >= hi) break;
            size_t klen = it->size();
            if (out && need + klen + 1 <= cap) {
                std::memcpy(out + need, it->data(), klen);
                out[need + klen] = '\n';
            }
            need += klen + 1;
        }
    }
    return need;
}

}  // namespace

extern "C" {

void* nn_oki_new() {
    return new (std::nothrow) OrderedKeyIndex();
}

void nn_oki_free(void* h) {
    delete (OrderedKeyIndex*)h;
}

int nn_oki_insert(void* h, const char* key, size_t len) {
    auto* ix = (OrderedKeyIndex*)h;
    std::lock_guard<std::mutex> g(ix->mu);
    return ix->shards[OrderedKeyIndex::shard_of(key, len)]
        .insert(std::string(key, len)).second ? 1 : 0;
}

int nn_oki_remove(void* h, const char* key, size_t len) {
    auto* ix = (OrderedKeyIndex*)h;
    std::lock_guard<std::mutex> g(ix->mu);
    return ix->shards[OrderedKeyIndex::shard_of(key, len)]
        .erase(std::string(key, len)) ? 1 : 0;
}

// Bulk insert: one lock + one ctypes crossing for n keys (snapshot
// load / recovery path). buf holds the keys back to back; lens their
// byte lengths. Returns the number of newly inserted keys.
size_t nn_oki_insert_batch(void* h, const char* buf,
                           const uint32_t* lens, size_t n) {
    auto* ix = (OrderedKeyIndex*)h;
    std::lock_guard<std::mutex> g(ix->mu);
    size_t ins = 0, off = 0;
    for (size_t i = 0; i < n; i++) {
        size_t len = lens[i];
        ins += ix->shards[OrderedKeyIndex::shard_of(buf + off, len)]
            .insert(std::string(buf + off, len)).second ? 1 : 0;
        off += len;
    }
    return ins;
}

size_t nn_oki_len(void* h) {
    auto* ix = (OrderedKeyIndex*)h;
    std::lock_guard<std::mutex> g(ix->mu);
    size_t n = 0;
    for (auto& s : ix->shards) n += s.size();
    return n;
}

size_t nn_oki_count_prefix(void* h, const char* p, size_t plen) {
    auto* ix = (OrderedKeyIndex*)h;
    std::lock_guard<std::mutex> g(ix->mu);
    std::string lo(p, plen), hi = prefix_end(lo);
    size_t n = 0;
    size_t lo_shard = lo.empty() ? 0 : OrderedKeyIndex::shard_of(
        lo.data(), lo.size());
    size_t hi_shard = hi.empty() ? 15 : OrderedKeyIndex::shard_of(
        hi.data(), hi.size());
    for (size_t s = lo_shard; s <= hi_shard && s < 16; s++) {
        auto& set = ix->shards[s];
        size_t lo_rank = lo.empty() ? 0 : set.order_of_key(lo);
        size_t hi_rank = hi.empty() ? set.size() : set.order_of_key(hi);
        n += hi_rank - lo_rank;
    }
    return n;
}

// Two-call protocol: returns total bytes of newline-joined keys with
// the given prefix; fills out up to cap bytes when out != NULL.
size_t nn_oki_scan_prefix(void* h, const char* p, size_t plen,
                          char* out, size_t cap) {
    auto* ix = (OrderedKeyIndex*)h;
    std::lock_guard<std::mutex> g(ix->mu);
    std::string lo(p, plen), hi = prefix_end(lo);
    return collect(ix, lo, hi, hi.empty(), out, cap);
}

// Range [lo, hi); pass hi_unbounded=1 to scan to the end.
size_t nn_oki_scan_range(void* h, const char* lo, size_t lolen,
                         const char* hi, size_t hilen, int hi_unbounded,
                         char* out, size_t cap) {
    auto* ix = (OrderedKeyIndex*)h;
    std::lock_guard<std::mutex> g(ix->mu);
    return collect(ix, std::string(lo, lolen), std::string(hi, hilen),
                   hi_unbounded != 0, out, cap);
}

// ---------------------------------------------------------------------
// CRC32 (IEEE, zlib-compatible), table-driven
// ---------------------------------------------------------------------
static uint32_t crc_table[256];
static bool crc_init_done = false;

static void crc_init() {
    for (uint32_t i = 0; i < 256; i++) {
        uint32_t c = i;
        for (int k = 0; k < 8; k++)
            c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
        crc_table[i] = c;
    }
    crc_init_done = true;
}

uint32_t nn_crc32(const uint8_t* buf, size_t len) {
    if (!crc_init_done) crc_init();
    uint32_t c = 0xFFFFFFFFu;
    for (size_t i = 0; i < len; i++)
        c = crc_table[(c ^ buf[i]) & 0xFF] ^ (c >> 8);
    return c ^ 0xFFFFFFFFu;
}

// ---------------------------------------------------------------------
// WAL record framing: [len u32 LE][crc32 u32 LE][payload]
// ---------------------------------------------------------------------

// Frame one payload into out (caller allocates len+8). Returns bytes
// written.
size_t nn_wal_frame(const uint8_t* payload, size_t len, uint8_t* out) {
    uint32_t l = (uint32_t)len;
    uint32_t c = nn_crc32(payload, len);
    std::memcpy(out, &l, 4);
    std::memcpy(out + 4, &c, 4);
    std::memcpy(out + 8, payload, len);
    return len + 8;
}

// Scan a WAL buffer; writes (offset, length) pairs of VALID payloads
// into out (2*max entries). Stops at the first corrupt/torn record.
// Returns the number of records found.
size_t nn_wal_scan(const uint8_t* buf, size_t size,
                   uint64_t* out, size_t max_records) {
    size_t pos = 0, n = 0;
    while (n < max_records && pos + 8 <= size) {
        uint32_t len, crc;
        std::memcpy(&len, buf + pos, 4);
        std::memcpy(&crc, buf + pos + 4, 4);
        size_t start = pos + 8;
        if (start + len > size) break;              // torn tail
        if (nn_crc32(buf + start, len) != crc) break;  // corruption
        out[2 * n] = (uint64_t)start;
        out[2 * n + 1] = (uint64_t)len;
        n++;
        pos = start + len;
    }
    return n;
}

// ---------------------------------------------------------------------
// varint (LEB128, unsigned)
// ---------------------------------------------------------------------

// Returns bytes written; out must hold 10*n bytes worst case.
size_t nn_varint_encode(const uint64_t* vals, size_t n, uint8_t* out) {
    size_t o = 0;
    for (size_t i = 0; i < n; i++) {
        uint64_t v = vals[i];
        while (v >= 0x80) {
            out[o++] = (uint8_t)(v | 0x80);
            v >>= 7;
        }
        out[o++] = (uint8_t)v;
    }
    return o;
}

// Returns count decoded, or (size_t)-1 on truncation. out holds max_n.
size_t nn_varint_decode(const uint8_t* buf, size_t size,
                        uint64_t* out, size_t max_n) {
    size_t n = 0, pos = 0;
    while (pos < size && n < max_n) {
        uint64_t v = 0;
        int shift = 0;
        bool done = false;
        while (pos < size) {
            uint8_t b = buf[pos++];
            v |= (uint64_t)(b & 0x7F) << shift;
            if (!(b & 0x80)) { done = true; break; }
            shift += 7;
        }
        if (!done) return (size_t)-1;
        out[n++] = v;
    }
    return n;
}

// delta-encode sorted ids in place then varint (caller composes); here
// we provide fused helpers for the id-list codec.
size_t nn_delta_encode_ids(const uint64_t* ids, size_t n, uint8_t* out) {
    size_t o = 0;
    uint64_t prev = 0;
    for (size_t i = 0; i < n; i++) {
        uint64_t v = ids[i] - prev;
        prev = ids[i];
        while (v >= 0x80) {
            out[o++] = (uint8_t)(v | 0x80);
            v >>= 7;
        }
        out[o++] = (uint8_t)v;
    }
    return o;
}

size_t nn_delta_decode_ids(const uint8_t* buf, size_t size,
                           uint64_t* out, size_t max_n) {
    size_t n = nn_varint_decode(buf, size, out, max_n);
    if (n == (size_t)-1) return n;
    uint64_t acc = 0;
    for (size_t i = 0; i < n; i++) {
        acc += out[i];
        out[i] = acc;
    }
    return n;
}

// ---------------------------------------------------------------------
// byte RLE: [count u8][byte] pairs
// ---------------------------------------------------------------------
size_t nn_rle_encode(const uint8_t* buf, size_t size, uint8_t* out) {
    size_t o = 0, i = 0;
    while (i < size) {
        uint8_t b = buf[i];
        size_t run = 1;
        while (i + run < size && buf[i + run] == b && run < 255) run++;
        out[o++] = (uint8_t)run;
        out[o++] = b;
        i += run;
    }
    return o;
}

// Returns decoded size, or (size_t)-1 if out_cap too small / bad input.
size_t nn_rle_decode(const uint8_t* buf, size_t size,
                     uint8_t* out, size_t out_cap) {
    if (size % 2) return (size_t)-1;
    size_t o = 0;
    for (size_t i = 0; i < size; i += 2) {
        size_t run = buf[i];
        if (o + run > out_cap) return (size_t)-1;
        std::memset(out + o, buf[i + 1], run);
        o += run;
    }
    return o;
}

// Per-row symmetric int8 quantization (scale = absmax/127), optionally
// with a second int8 plane of the quantization error (residual): one
// cache-resident pass per row instead of the ~8 allocating numpy
// passes (measured 23 s -> ~1 s per GB on the single-core build VM).
// rq/rscale may be NULL to skip the residual plane. Zero rows get
// scale 1 and all-zero codes, matching the numpy path exactly.
void nn_quantize_int8(const float* x, size_t n, size_t d,
                      int8_t* q, float* scale,
                      int8_t* rq, float* rscale) {
    // rintf (current mode = half-even, matching np.round) vectorizes
    // to roundps under -fno-math-errno; lrintf is an unvectorizable
    // libm call (measured 4x slower end to end)
    for (size_t i = 0; i < n; ++i) {
        const float* row = x + i * d;
        int8_t* qr = q + i * d;
        float am = 0.0f;
        for (size_t j = 0; j < d; ++j)
            am = fmaxf(am, fabsf(row[j]));
        float sc = am > 0 ? am / 127.0f : 1.0f;
        float inv = 1.0f / sc;
        scale[i] = sc;
        if (!rq) {
            for (size_t j = 0; j < d; ++j) {
                float v = rintf(row[j] * inv);
                qr[j] = (int8_t)fminf(fmaxf(v, -127.0f), 127.0f);
            }
            continue;
        }
        int8_t* rr = rq + i * d;
        float ram = 0.0f;
        // pass 1: quantize + residual magnitude (residual values are
        // recomputed in pass 2 — recompute beats a d-float spill for
        // the autovectorizer, rows are cache-resident either way)
        for (size_t j = 0; j < d; ++j) {
            float v = rintf(row[j] * inv);
            float qq = fminf(fmaxf(v, -127.0f), 127.0f);
            qr[j] = (int8_t)qq;
            ram = fmaxf(ram, fabsf(row[j] - qq * sc));
        }
        float rsc = ram > 0 ? ram / 127.0f : 1.0f;
        float rinv = 1.0f / rsc;
        rscale[i] = rsc;
        for (size_t j = 0; j < d; ++j) {
            float r = row[j] - (float)qr[j] * sc;
            float v = rintf(r * rinv);
            rr[j] = (int8_t)fminf(fmaxf(v, -127.0f), 127.0f);
        }
    }
}

}  // extern "C"
