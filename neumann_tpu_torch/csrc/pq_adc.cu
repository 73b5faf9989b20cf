// Product-quantization ADC scan, asymmetric distances from per-query
// lookup tables, with the top-k selected inside the kernel.
//
// Replaces the XLA-fused ADC search of the JAX package (`_adc_search_fn`,
// neumann_tpu/ops/pq.py:111-131, the sums at :116 and lax.top_k at :128
// in one jitted function; and the `pq` storage of IVFIndex.search,
// neumann_tpu/ops/ivf.py): score[q, c] = -sum_m T[q, m, codes[row, m]]
// for the row of column c, -inf where the row is dead. Two modes of one
// kernel:
//   * select (1 <= k <= 64): per query the k greatest int64 keys of
//     ops/scan._topk_stable, the score's order-preserving int32 image
//     above the column's complement, so equal codes (exact ties), -inf and
//     NaN come out in lax.top_k's order. No score reaches device memory:
//     each block writes its k best keys a query, and one torch.topk over
//     [Q, parts * k] finishes (ops/kernels.pq_adc_topk);
//   * scores: the [Q, C] f32 scores (k above the cap; the bit-exact check).
// Columns: the full scan (column c is row c) or gathered (column c of
// query q is row cand[q, c], -1 none: the probed lists of IVFIndex).
//
// What bounds it on an H100: the table lookups, 32 shared-memory words a
// clock a SM (Q 1,024 x 2^20 rows x M 96 is 1.0e11 lookups, 12.3 ms); a
// few queries are bound by the code bytes.
//
// Two layouts of the block, chosen by the plan (ops/kernels._pq_adc_plan):
//   * shared (the full scan at 8 queries or more): 512 threads, 8
//     queries, passes of 4,096 rows. Each code byte is read once for the 8
//     queries, and a pass reloads the 8 tables once for 4,096 rows (0.25
//     bytes of table and 0.125 of codes from L2 a lookup). Tables sit in
//     shared memory as [m][code][4 copies][8 queries]: a thread owns 16
//     consecutive rows and 4 queries (a float4 a lookup), lanes 2s and
//     2s + 1 share row slot s and read copy s % 4, so the four slots of a
//     quarter warp read four distinct groups of 8 banks and no lookup
//     conflicts (one copy: 38.9 ms against 29.1 at Q 1,024). The 16 x 4
//     sums stay in registers across the subspaces, each taken in order
//     m = 0 .. M-1, so every sum equals pq_adc_scores_plain bit for bit. A
//     stage of a 3-stage ring holds a subspace's table with its copies (32
//     KB: each thread loads 16 bytes once, a stage ahead, and stores them
//     4 times; four cp.async from one source each cost 9 ms more in L2
//     reads) and, by cp.async, the pass's 4,096 codes of it (transposed to
//     [M, N] by transpose_codes, so they are contiguous; the tables are
//     interleaved to [Q / 8, M, 256, 8] by interleave_tables). Full and
//     empty mbarriers a stage replace block barriers, so warps drift
//     within the ring. The 64 sums leave few of a thread's 128 registers:
//     the selection runs out of line, and 4 or 5 stages spilled (39-40
//     ms). A block walks `span` rows, several passes;
//   * lane (fewer queries, and the gathered mode, whose queries share no
//     codes): 256 threads, one query, passes of 2,048 columns, a row per
//     lane, the table 48 subspaces at a time (loaded once where M <= 48),
//     16-byte code loads where M % 16 == 0.
// Selection: a block keeps each query's k best keys in shared memory. After
// a pass each key is held to a limit, the larger of the block's own k-th
// key and the k-th key that any block has published for the query in
// gthr [Q] (atomicMax; LLONG_MIN until then, set by the entry point), so
// once the first passes are merged almost every key fails one compare.
// Keys that pass go to a buffer of 192 a query (one shared atomicAdd a warp
// and query); one warp a query merges it into the best list (k rounds of a
// warp max) and publishes the k-th.
//
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; scripts/torch_pq_adc_probe.py,
// k 10, 2^20 rows x M 96): 27.6-29.1 ms at Q 1,024, where the design this
// replaced wrote the scores in 52 ms and ops/scan._topk_stable took about
// 53 more over them; with nothing staged 21.5 ms, with nothing looked up
// 17.6.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kCentroids = 256;
constexpr int kMaxK = 64;                      // the wrapper's cap on k
constexpr int kCap = 192;                      // a query's candidate buffer
constexpr int kPerLane = (kMaxK + kCap) / 32;  // keys a lane in a merge
constexpr long long kEmpty = LLONG_MIN;        // below every real key
constexpr int kSmemMax = 232448;               // a block's shared memory
// the lane layout: threads, columns a thread a pass, subspaces a chunk
constexpr int kLaneThreads = 256;
constexpr int kLaneRows = 8;
constexpr int kLanePass = kLaneThreads * kLaneRows;
constexpr int kLaneChunk = 48;
// the shared layout: queries a block, table copies (32 banks / 8 queries),
// threads, rows a thread, rows a pass
constexpr int kQb = 8;
constexpr int kCopies = 4;
constexpr int kRowWords = kQb * kCopies;       // words a (subspace, code)
constexpr int kSharedThreads = 512;
constexpr int kSlotRows = 16;
constexpr int kSharedPass = kSharedThreads / 2 * kSlotRows;
// the shared layout's ring of stages, a subspace each (tables and codes:
// 36 KB), as many as fit beside the selection's buffers
constexpr int kSelectStages = 3;
constexpr int kScoreStages = 6;

// byte offsets of a block's shared memory: the tables (shared: the
// ring's stages of [256][4][8] floats; lane: [chunk][256]), the codes
// (shared: the stages' [4,096] bytes), in select mode per query the best
// keys [k], the buffer [kCap], the limit, the own k-th key and the
// buffer's count, and (shared) each stage's full and empty mbarriers
struct Layout {
  int code, best, buf, lim, thr, cnt, bar, bytes;
};

__host__ __device__ inline Layout layout(bool shared, int chunk, int k,
                                         bool select) {
  const int nq = shared ? kQb : 1;
  const int stages = select ? kSelectStages : kScoreStages;
  Layout l;
  l.code = shared ? stages * kCentroids * kRowWords * 4
                  : chunk * kCentroids * 4;
  l.best = l.code + (shared ? stages * kSharedPass : 0);
  l.buf = l.best + (select ? nq * k * 8 : 0);
  l.lim = l.buf + (select ? nq * kCap * 8 : 0);
  l.thr = l.lim + (select ? nq * 8 : 0);
  l.cnt = l.thr + (select ? nq * 8 : 0);
  l.bar = (l.cnt + (select ? nq * 4 : 0) + 7) / 8 * 8;
  l.bytes = l.bar + (shared ? 2 * stages * 8 : 0);
  return l;
}

struct Args {
  const uint8_t* codes;   // lane: [n_rows, m]; shared: [m, npad]
  const float* tables;    // lane: [n_q, m, 256]; shared: [groups, m, 256, 8]
  const uint8_t* valid;   // [n_rows]
  const int32_t* cand;    // gathered: [n_q, n_cols] row ids; else nullptr
  float* scores;          // scores mode: [n_q, n_cols]
  long long* keys;        // select mode: [n_q, parts, k]
  long long* gthr;        // select mode: [n_q]
  long long n_rows, n_cols, span, npad;
  int n_q, m, k, chunk, parts;
};

struct Sel {
  long long* best;
  long long* buf;
  long long* lim;
  long long* thr;
  int* cnt;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ long long load_relaxed(const long long* p) {
  long long v;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void bar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(b)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* b) {
  asm volatile(
      "{\n\t.reg .b64 st;\n\t"
      "mbarrier.arrive.shared::cta.b64 st, [%0];\n\t}" ::"r"(smem_addr(b))
      : "memory");
}

// an arrival on b once this thread's cp.async copies have landed, counted
// in b's expected arrivals
__device__ __forceinline__ void copies_arrive(uint64_t* b) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   smem_addr(b))
               : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* b, unsigned parity) {
  unsigned ok;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(ok)
        : "r"(smem_addr(b)), "r"(parity)
        : "memory");
  } while (!ok);
}

// ops/scan._topk_stable's key of score s at column c (c < 2^32 - 1)
__device__ __forceinline__ long long make_key(float s, long long c) {
  int b = __float_as_int(s);
  b = b < 0 ? (b ^ 0x7FFFFFFF) : b;
  return static_cast<long long>(
      (static_cast<unsigned long long>(static_cast<unsigned>(b)) << 32) |
      static_cast<unsigned long long>(0xFFFFFFFFu -
                                      static_cast<unsigned>(c)));
}

// A key passes iff it is above the block's own k-th (keys are distinct:
// a column is one block's) and not below the published k-th, g: there
// are k keys at least g, so a smaller key is out
__device__ __forceinline__ long long limit_of(long long own, long long g) {
  return g == kEmpty ? own : max(own, g - 1);
}

// One warp: the k greatest of best[0, k) and buf[0, n) become best,
// sorted descending, kEmpty past the keys there are.
__device__ __forceinline__ void merge(long long* best, const long long* buf,
                                      int n, int k) {
  const int lane = threadIdx.x % 32;
  const int total = k + n;
  long long v[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int j = lane + 32 * i;
    v[i] = j < k ? best[j] : (j < total ? buf[j - k] : kEmpty);
  }
  __syncwarp();
  for (int o = 0; o < k; ++o) {
    long long mx = v[0];
#pragma unroll
    for (int i = 1; i < kPerLane; ++i) mx = max(mx, v[i]);
    const int hi = static_cast<int>(mx >> 32);
    const int hmax = __reduce_max_sync(0xffffffffu, hi);
    const unsigned lo = hi == hmax ? static_cast<unsigned>(mx) : 0u;
    const unsigned lmax = __reduce_max_sync(0xffffffffu, lo);
    const long long w = static_cast<long long>(
        (static_cast<unsigned long long>(static_cast<unsigned>(hmax))
         << 32) |
        lmax);
    if (w == kEmpty) {   // fewer than k keys: the rest stay empty
      for (int j = o + lane; j < k; j += 32) best[j] = kEmpty;
      break;
    }
    if (lane == 0) best[o] = w;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) v[i] = v[i] == w ? kEmpty : v[i];
  }
  __syncwarp();
}

__device__ __forceinline__ void set_limit(const Sel& s, const Args& a,
                                          int qi, int q) {
  s.lim[qi] = q < a.n_q ? limit_of(s.thr[qi], load_relaxed(a.gthr + q))
                        : LLONG_MAX;   // a padding query takes nothing
}

// The block's selection after a pass: each thread offers kN keys,
// key_of(i) of query slot slot_of(i) (kEmpty: no column). Called by every
// thread of the block.
template <int kN, class KeyOf, class SlotOf>
__device__ __forceinline__ void select_pass(const Sel& s, const Args& a,
                                            int nqb, int q0, KeyOf key_of,
                                            SlotOf slot_of) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int warps = blockDim.x / 32;
  if (tid < nqb) set_limit(s, a, tid, q0 + tid);
  __syncthreads();
  unsigned long long pend = 0;
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    if (key_of(i) > s.lim[slot_of(i)]) pend |= 1ull << i;
  }
  while (__syncthreads_or(pend != 0)) {
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      // one atomicAdd a warp and query: the lanes offering key i to the
      // same query take consecutive slots after their leader's
      const bool want = (pend >> i) & 1;
      const int qi = slot_of(i);
      const unsigned group = __match_any_sync(0xffffffffu, want ? qi : -1);
      if (want) {
        const int leader = __ffs(group) - 1;
        int base = 0;
        if (lane == leader) base = atomicAdd(s.cnt + qi, __popc(group));
        base = __shfl_sync(group, base, leader);
        const int at = base + __popc(group & ((1u << lane) - 1));
        if (at < kCap) {   // else kept for the next round
          s.buf[qi * kCap + at] = key_of(i);
          pend &= ~(1ull << i);
        }
      }
    }
    __syncthreads();
    for (int qi = warp; qi < nqb; qi += warps) {
      const int n = s.cnt[qi];
      if (n == 0) continue;
      merge(s.best + qi * a.k, s.buf + qi * kCap, min(n, kCap), a.k);
      if (lane == 0) {
        const long long kth = s.best[qi * a.k + a.k - 1];
        s.thr[qi] = kth;
        s.cnt[qi] = 0;
        if (kth != kEmpty) atomicMax(a.gthr + q0 + qi, kth);
        set_limit(s, a, qi, q0 + qi);
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      if (((pend >> i) & 1) && !(key_of(i) > s.lim[slot_of(i)])) {
        pend &= ~(1ull << i);
      }
    }
  }
}

// a += the 4 table entries one code word selects (bytes in subspace order)
__device__ __forceinline__ float add_word(float a, const float* t,
                                          uint32_t w) {
  a += t[w & 0xFF];
  a += t[kCentroids + ((w >> 8) & 0xFF)];
  a += t[2 * kCentroids + ((w >> 16) & 0xFF)];
  a += t[3 * kCentroids + (w >> 24)];
  return a;
}

// The lane layout: block (part, query), columns [part * span, + span) in
// passes of 2,048, consecutive threads on consecutive columns. kVec:
// bytes of codes a load (16, 4 or 1); a lane reads its own row.
template <bool kGathered, int kVec, bool kSelect>
__device__ __forceinline__ void lane_body(const Args& a, float* tab,
                                          const Sel& s) {
  const int q = blockIdx.y;
  const long long c_begin = static_cast<long long>(blockIdx.x) * a.span;
  const long long c_end = min(c_begin + a.span, a.n_cols);
  const float4* tq = reinterpret_cast<const float4*>(
      a.tables + static_cast<long long>(q) * a.m * kCentroids);
  const bool resident = a.m <= a.chunk;   // one chunk: load it once
  for (long long p0 = c_begin; p0 < c_end; p0 += kLanePass) {
    const long long c0 = p0 + threadIdx.x;
    long long row[kLaneRows];
    bool live[kLaneRows];
    float acc[kLaneRows];
#pragma unroll
    for (int r = 0; r < kLaneRows; ++r) {
      const long long c = c0 + static_cast<long long>(r) * kLaneThreads;
      long long rr = -1;
      if (c < c_end) {
        rr = kGathered ? static_cast<long long>(
                             a.cand[static_cast<long long>(q) * a.n_cols + c])
                       : c;
      }
      live[r] = rr >= 0 && rr < a.n_rows && a.valid[rr] != 0;
      row[r] = live[r] ? rr : 0;
      acc[r] = 0.0f;
    }
    for (int m0 = 0; m0 < a.m; m0 += a.chunk) {
      const int mc = min(a.chunk, a.m - m0);
      if (!resident || p0 == c_begin) {
        __syncthreads();
        float4* t4 = reinterpret_cast<float4*>(tab);
        for (int i = threadIdx.x; i < mc * kCentroids / 4;
             i += kLaneThreads) {
          t4[i] = tq[m0 * kCentroids / 4 + i];
        }
        __syncthreads();
      }
#pragma unroll
      for (int r = 0; r < kLaneRows; ++r) {
        if (!live[r]) continue;
        const uint8_t* cr = a.codes + row[r] * a.m + m0;
        float v = acc[r];
        if (kVec == 16) {
          const uint4* cv = reinterpret_cast<const uint4*>(cr);
          for (int j = 0; j < mc / 16; ++j) {
            const uint4 w = __ldg(cv + j);
            const float* t = tab + 16 * j * kCentroids;
            v = add_word(v, t, w.x);
            v = add_word(v, t + 4 * kCentroids, w.y);
            v = add_word(v, t + 8 * kCentroids, w.z);
            v = add_word(v, t + 12 * kCentroids, w.w);
          }
        } else if (kVec == 4) {
          const uint32_t* cw = reinterpret_cast<const uint32_t*>(cr);
          for (int j = 0; j < mc / 4; ++j) {
            v = add_word(v, tab + 4 * j * kCentroids, __ldg(cw + j));
          }
        } else {
          for (int j = 0; j < mc; ++j) {
            v += tab[j * kCentroids + __ldg(cr + j)];
          }
        }
        acc[r] = v;
      }
    }
    if constexpr (kSelect) {
      select_pass<kLaneRows>(
          s, a, 1, q,
          [&](int r) {
            const long long c = c0 + static_cast<long long>(r) * kLaneThreads;
            return c < c_end ? make_key(live[r] ? -acc[r] : -INFINITY, c)
                             : kEmpty;
          },
          [](int) { return 0; });
    } else {
#pragma unroll
      for (int r = 0; r < kLaneRows; ++r) {
        const long long c = c0 + static_cast<long long>(r) * kLaneThreads;
        if (c < c_end) {
          a.scores[static_cast<long long>(q) * a.n_cols + c] =
              live[r] ? -acc[r] : -INFINITY;
        }
      }
    }
  }
}

// The shared layout's selection after a pass, a query of the thread's 4
// at a time: sums [16 rows][4 queries], lv the live rows. Out of line, so
// the pass loop keeps its registers (inlined, the selection made it spill
// and run 1.5-1.8x slower); it runs once a pass, from local memory.
__device__ __noinline__ void shared_select(const Args& a, const Sel& s,
                                           const float* sums, unsigned lv,
                                           long long col0, long long c_end,
                                           int q0, int quad) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    select_pass<kSlotRows>(
        s, a, kQb, q0,
        [&](int i) {
          const long long c = col0 + i;
          if (c >= c_end) return kEmpty;
          return make_key((lv >> i) & 1 ? -sums[4 * i + e] : -INFINITY, c);
        },
        [&](int) { return quad * 4 + e; });
  }
}

// The shared layout: block (part, group of 8 queries), rows [part * span,
// + span) in passes of 4,096; warp w, lane l: row slot 16 w + l / 2 (rows
// 16 slot .. 16 slot + 15 of the pass), queries 4 (l % 2) .. + 3 of the
// group, table copy (l / 2) % 4. Stage t of the ring (t % kStages) holds
// subspace t % M of pass t / M.
template <bool kSelect>
__device__ __forceinline__ void shared_body(const Args& a,
                                            unsigned char* smem,
                                            const Layout& l, const Sel& s) {
  constexpr int kStages = kSelect ? kSelectStages : kScoreStages;
  constexpr int kTabFloats = kCentroids * kRowWords;   // a stage's table
  float* tab = reinterpret_cast<float*>(smem);
  uint8_t* cod = smem + l.code;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int slot = warp * 16 + lane / 2;
  const int quad = lane & 1;
  const int copy = (lane / 2) % kCopies;
  const int g = blockIdx.y;
  const int q0 = g * kQb;
  const long long c_begin = static_cast<long long>(blockIdx.x) * a.span;
  const long long c_end = min(c_begin + a.span, a.n_cols);
  const int passes =
      static_cast<int>((c_end - c_begin + kSharedPass - 1) / kSharedPass);
  const int total = passes * a.m;
  const float* tg =
      a.tables + static_cast<long long>(g) * a.m * kCentroids * kQb;

  // stage u's table: thread tid loads 16 bytes of it once (code tid / 2,
  // half tid % 2) and stores them into the 4 copies, copy (c + code) % 4
  // at step c, so a quarter warp's four codes write four bank groups; and,
  // by cp.async, the pass's 4,096 codes of its subspace. Each thread
  // arrives on the stage's full barrier once for the table and, where it
  // copies codes, once more when they land. Stages are counted by
  // (buffer, subspace, pass) to keep divisions and 64-bit offsets out of
  // the loop: the 64 sums leave few of the 128 registers.
  // a stage's table is kTabUnits units of 16 bytes: unit j of thread tid
  // is tid + j * kSharedThreads (code unit / 2, half unit % 2)
  constexpr int kTabUnits = 2 * kCentroids;
  constexpr int kUnits = (kTabUnits + kSharedThreads - 1) / kSharedThreads;
  struct Regs {
    float4 v[kUnits];
  };
  const uint8_t* csrc = a.codes + c_begin + tid * 16;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + l.bar);
  uint64_t* empty = full + kStages;
  auto load_tab = [&](int mm) {
    Regs r;
#pragma unroll
    for (int j = 0; j < kUnits; ++j) {
      const int unit = tid + j * kSharedThreads;
      if (unit < kTabUnits) {
        r.v[j] = __ldg(reinterpret_cast<const float4*>(
            tg + (mm * kCentroids + unit / 2) * kQb + (unit % 2) * 4));
      }
    }
    return r;
  };
  auto copy_codes = [&](int b, int mm, int p) {
    cp_async16(cod + b * kSharedPass + tid * 16,
               csrc + static_cast<long long>(mm) * a.npad +
                   p * kSharedPass);
  };
  auto produce = [&](int b, int mm, int p, const Regs& r) {
#pragma unroll
    for (int j = 0; j < kUnits; ++j) {
      const int unit = tid + j * kSharedThreads;
      if (unit < kTabUnits) {
        float* td = tab + b * kTabFloats + (unit / 2) * kRowWords +
                    (unit % 2) * 4;
#pragma unroll
        for (int c = 0; c < kCopies; ++c) {
          *reinterpret_cast<float4*>(td + ((c + unit / 2) % kCopies) * kQb) =
              r.v[j];
        }
      }
    }
    bar_arrive(full + b);
    if (tid < kSharedPass / 16) {
      copy_codes(b, mm, p);
      copies_arrive(full + b);
    }
  };
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      bar_init(full + i, kSharedThreads + kSharedPass / 16);
      bar_init(empty + i, kSharedThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  float acc[kSlotRows][4];
#pragma unroll
  for (int i = 0; i < kSlotRows; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
  }
  // the next stage to produce: its index, buffer, the parity of the
  // buffer's uses so far, subspace and pass
  int u = 0, ub = 0, uphase = 0, um = 0, up = 0;
  auto advance = [&]() {
    ++u;
    if (++ub == kStages) {
      ub = 0;
      uphase ^= 1;
    }
    if (++um == a.m) {
      um = 0;
      ++up;
    }
  };
  for (; u < kStages - 1 && u < total; advance()) {
    produce(ub, um, up, load_tab(um));
  }
  // the table of the next stage produced, loaded a stage before its store
  Regs next = {};
  if (u < total) next = load_tab(um);
  // stage t's buffer, the parity of the buffer's uses, subspace and pass
  int tb = 0, tphase = 0, mm = 0, p = 0;
  for (int t = 0; t < total; ++t) {
    bar_wait(full + tb, tphase);
    {
      const uint4 cv = *reinterpret_cast<const uint4*>(
          cod + tb * kSharedPass + slot * kSlotRows);
      const unsigned w[4] = {cv.x, cv.y, cv.z, cv.w};
      const float* tm = tab + tb * kTabFloats + copy * kQb + quad * 4;
#pragma unroll
      for (int i = 0; i < kSlotRows; ++i) {
        const unsigned code = (w[i / 4] >> (8 * (i % 4))) & 0xFFu;
        const float4 v =
            *reinterpret_cast<const float4*>(tm + code * kRowWords);
        acc[i][0] += v.x;
        acc[i][1] += v.y;
        acc[i][2] += v.z;
        acc[i][3] += v.w;
      }
    }
    __syncwarp();
    if (lane == 0) bar_arrive(empty + tb);   // the warp has read stage t
    if (u < total) {   // into t - 1's buffer, once every warp has read it
      if (t > 0) bar_wait(empty + ub, uphase ^ 1);   // its last use
      produce(ub, um, up, next);
      advance();
      if (u < total) next = load_tab(um);
    }
    if (mm == a.m - 1) {   // the pass is summed
      const long long col0 = c_begin +
                             static_cast<long long>(p) * kSharedPass +
                             slot * kSlotRows;
      unsigned lv = 0;   // live rows of the thread's 16
#pragma unroll
      for (int i = 0; i < kSlotRows; ++i) {
        const long long c = col0 + i;
        if (c < c_end && a.valid[c] != 0) lv |= 1u << i;
      }
      if constexpr (kSelect) {
        float sums[kSlotRows * 4];
#pragma unroll
        for (int i = 0; i < kSlotRows * 4; ++i) sums[i] = acc[i / 4][i % 4];
        shared_select(a, s, sums, lv, col0, c_end, q0, quad);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {   // a query of the thread's 4 at a time
          const int q = q0 + quad * 4 + e;
          if (q >= a.n_q) continue;
          float* o = a.scores + static_cast<long long>(q) * a.n_cols + col0;
          float sv[kSlotRows];
#pragma unroll
          for (int i = 0; i < kSlotRows; ++i) {
            sv[i] = (lv >> i) & 1 ? -acc[i][e] : -INFINITY;
          }
          if (a.n_cols % 4 == 0 && col0 + kSlotRows <= c_end) {
#pragma unroll
            for (int i = 0; i < kSlotRows; i += 4) {
              *reinterpret_cast<float4*>(o + i) =
                  make_float4(sv[i], sv[i + 1], sv[i + 2], sv[i + 3]);
            }
          } else {
#pragma unroll
            for (int i = 0; i < kSlotRows; ++i) {
              if (col0 + i < c_end) o[i] = sv[i];
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kSlotRows; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
      }
    }
    if (++tb == kStages) {
      tb = 0;
      tphase ^= 1;
    }
    if (++mm == a.m) {
      mm = 0;
      ++p;
    }
  }
}

template <bool kShared, bool kGathered, int kVec, bool kSelect>
__global__ void __launch_bounds__(kShared ? kSharedThreads : kLaneThreads,
                                  kShared ? 1 : 2)
    pq_adc_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout l = layout(kShared, a.chunk, a.k, kSelect);
  const Sel s{reinterpret_cast<long long*>(smem + l.best),
              reinterpret_cast<long long*>(smem + l.buf),
              reinterpret_cast<long long*>(smem + l.lim),
              reinterpret_cast<long long*>(smem + l.thr),
              reinterpret_cast<int*>(smem + l.cnt)};
  const int nq = kShared ? kQb : 1;
  if constexpr (kSelect) {   // read after the bodies' first barrier
    for (int i = threadIdx.x; i < nq * a.k; i += blockDim.x) {
      s.best[i] = kEmpty;
    }
    for (int i = threadIdx.x; i < nq; i += blockDim.x) {
      s.thr[i] = kEmpty;
      s.cnt[i] = 0;
    }
  }
  if constexpr (kShared) {
    shared_body<kSelect>(a, smem, l, s);
  } else {
    lane_body<kGathered, kVec, kSelect>(a, reinterpret_cast<float*>(smem),
                                        s);
  }
  if constexpr (kSelect) {
    __syncthreads();
    const int q0 = kShared ? blockIdx.y * kQb : blockIdx.y;
    for (int i = threadIdx.x; i < nq * a.k; i += blockDim.x) {
      const int q = q0 + i / a.k;
      if (q < a.n_q) {
        a.keys[(static_cast<long long>(q) * a.parts + blockIdx.x) * a.k +
               i % a.k] = s.best[i];
      }
    }
  }
}

// codes [n_rows, m] -> [m, npad], zero past n_rows, in tiles of 128 rows
// x 32 subspaces: 4-byte reads where m % 4 == 0 (else bytes) and 4-byte
// writes (4 rows of a subspace; npad is a multiple of 4,096); the tile's
// rows are 33 bytes apart, so a warp's column reads hit distinct banks
__global__ void __launch_bounds__(256)
    transpose_codes(const uint8_t* __restrict__ codes,
                    uint8_t* __restrict__ out, long long n_rows, int m,
                    long long npad) {
  __shared__ uint8_t tile[128][33];
  const long long r0 = static_cast<long long>(blockIdx.x) * 128;
  const int m0 = blockIdx.y * 32;
  const int tid = threadIdx.x;
  if (m % 4 == 0) {
    for (int i = tid; i < 128 * 8; i += 256) {
      const int r = i / 8, c = m0 + 4 * (i % 8);
      const long long row = r0 + r;
      const uint32_t v =
          row < n_rows && c < m
              ? *reinterpret_cast<const uint32_t*>(codes + row * m + c)
              : 0u;
#pragma unroll
      for (int b = 0; b < 4; ++b) tile[r][4 * (i % 8) + b] = v >> (8 * b);
    }
  } else {
    for (int i = tid; i < 128 * 32; i += 256) {
      const int r = i / 32, c = m0 + i % 32;
      const long long row = r0 + r;
      tile[r][i % 32] = row < n_rows && c < m ? codes[row * m + c]
                                              : static_cast<uint8_t>(0);
    }
  }
  __syncthreads();
  for (int i = tid; i < 32 * 32; i += 256) {
    const int c = i / 32, w = i % 32;   // subspace m0 + c, rows 4 w .. + 3
    if (m0 + c >= m) break;             // a warp shares c
    const uint32_t v = tile[4 * w][c] | tile[4 * w + 1][c] << 8 |
                       tile[4 * w + 2][c] << 16 |
                       static_cast<uint32_t>(tile[4 * w + 3][c]) << 24;
    *reinterpret_cast<uint32_t*>(out + (m0 + c) * npad + r0 + 4 * w) = v;
  }
}

// tables [n_q, m, 256] -> [ceil(n_q / 8), m, 256, 8], zero past n_q
__global__ void interleave_tables(const float* __restrict__ t,
                                  float* __restrict__ out, int n_q, int m,
                                  long long total) {
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int j = static_cast<int>(i % kQb);
    const long long rest = i / kQb;   // (g * m + mm) * 256 + code
    const long long code = rest % kCentroids, gm = rest / kCentroids;
    const long long q = gm / m * kQb + j;
    out[i] = q < n_q ? t[(q * m + gm % m) * kCentroids + code] : 0.0f;
  }
}

__global__ void fill_empty(long long* p, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) p[i] = kEmpty;
}

template <bool kShared, bool kGathered, int kVec, bool kSelect>
int launch_kernel(const Args& a, int smem, cudaStream_t s) {
  const auto kernel = pq_adc_kernel<kShared, kGathered, kVec, kSelect>;
  const cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (set != cudaSuccess) return static_cast<int>(set);
  const unsigned gy = kShared ? (a.n_q + kQb - 1) / kQb : a.n_q;
  kernel<<<dim3(static_cast<unsigned>(a.parts), gy),
           kShared ? kSharedThreads : kLaneThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool kSelect>
int dispatch(Args a, const void* codes, const void* tables, void* codes_t,
             void* tables_g, bool shared, cudaStream_t s) {
  const long long per = shared ? kSharedPass : kLanePass;
  if (a.n_q < 1 || a.n_q > 65535 || a.m < 1 || a.n_cols < 1 ||
      a.n_cols >= 0xFFFFFFFFLL || a.n_rows < 1 ||
      (a.cand == nullptr && a.n_cols != a.n_rows) ||
      (shared && (a.cand != nullptr || a.chunk != 1)) ||
      (!shared && a.chunk != min(kLaneChunk, a.m)) || a.span < per ||
      a.span % per || a.parts < 1 ||
      static_cast<long long>(a.parts) * a.span < a.n_cols ||
      static_cast<long long>(a.parts - 1) * a.span >= a.n_cols ||
      (shared && a.npad < static_cast<long long>(a.parts) * a.span) ||
      (kSelect && (a.k < 1 || a.k > kMaxK))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = layout(shared, a.chunk, a.k, kSelect).bytes;
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  if (kSelect) {
    fill_empty<<<(a.n_q + 255) / 256, 256, 0, s>>>(a.gthr, a.n_q);
  }
  if (shared) {
    a.codes = static_cast<const uint8_t*>(codes_t);
    a.tables = static_cast<const float*>(tables_g);
    transpose_codes<<<dim3(static_cast<unsigned>(a.npad / 128),
                           (a.m + 31) / 32),
                      256, 0, s>>>(
        static_cast<const uint8_t*>(codes), static_cast<uint8_t*>(codes_t),
        a.n_rows, a.m, a.npad);
    const long long total = static_cast<long long>((a.n_q + kQb - 1) / kQb) *
                            a.m * kCentroids * kQb;
    interleave_tables<<<1024, 256, 0, s>>>(static_cast<const float*>(tables),
                                           static_cast<float*>(tables_g),
                                           a.n_q, a.m, total);
    return launch_kernel<true, false, 16, kSelect>(a, smem, s);
  }
  // wide code loads need every row (and chunk: kLaneChunk is a multiple
  // of 16) to start on the load's width
  const uintptr_t base = reinterpret_cast<uintptr_t>(codes);
  const int vec = a.m % 16 == 0 && base % 16 == 0  ? 16
                  : a.m % 4 == 0 && base % 4 == 0 ? 4
                                                  : 1;
  if (a.cand != nullptr) {
    return vec == 16 ? launch_kernel<false, true, 16, kSelect>(a, smem, s)
           : vec == 4 ? launch_kernel<false, true, 4, kSelect>(a, smem, s)
                      : launch_kernel<false, true, 1, kSelect>(a, smem, s);
  }
  return vec == 16 ? launch_kernel<false, false, 16, kSelect>(a, smem, s)
         : vec == 4 ? launch_kernel<false, false, 4, kSelect>(a, smem, s)
                    : launch_kernel<false, false, 1, kSelect>(a, smem, s);
}

Args make_args(const void* codes, const void* tables, const void* valid,
               const void* cand, long long n_rows, long long n_cols,
               int n_q, int m, int chunk, int parts, long long span,
               long long npad) {
  Args a;
  a.codes = static_cast<const uint8_t*>(codes);
  a.tables = static_cast<const float*>(tables);
  a.valid = static_cast<const uint8_t*>(valid);
  a.cand = static_cast<const int32_t*>(cand);
  a.scores = nullptr;
  a.keys = nullptr;
  a.gthr = nullptr;
  a.n_rows = n_rows;
  a.n_cols = n_cols;
  a.span = span;
  a.npad = npad;
  a.n_q = n_q;
  a.m = m;
  a.k = 0;
  a.chunk = chunk;
  a.parts = parts;
  return a;
}

}  // namespace

// codes [n_rows, m] uint8, tables [n_q, m, 256] f32, valid [n_rows] bool,
// cand nullptr (the full scan, n_cols == n_rows) or [n_q, n_cols] int32
// row ids; all 16-byte aligned. The plan (ops/kernels._pq_adc_plan):
// `shared` layout or not, subspaces a chunk, parts (blocks a query or
// query group) of span columns. The shared layout takes scratch codes_t
// [m, npad] uint8 and tables_g [ceil(n_q / 8), m, 256, 8] f32, filled
// here. Scores mode: out [n_q, n_cols] f32. Returns the first CUDA error
// of the launches (cudaErrorInvalidValue for arguments it does not take).
extern "C" int neumann_pq_adc_scores(const void* codes, const void* tables,
                                     const void* valid, const void* cand,
                                     void* out, void* codes_t,
                                     void* tables_g, long long n_rows,
                                     long long n_cols, int n_q, int m,
                                     int shared, int chunk, int parts,
                                     long long span, long long npad,
                                     void* stream) {
  Args a = make_args(codes, tables, valid, cand, n_rows, n_cols, n_q, m,
                     chunk, parts, span, npad);
  a.scores = static_cast<float*>(out);
  return dispatch<false>(a, codes, tables, codes_t, tables_g, shared != 0,
                         static_cast<cudaStream_t>(stream));
}

// Select mode, 1 <= k <= 64: keys [n_q, parts, k] int64, each block's k
// greatest keys a query, descending, LLONG_MIN past its columns; gthr [n_q]
// int64 scratch (set here). Arguments otherwise as neumann_pq_adc_scores.
extern "C" int neumann_pq_adc_select(const void* codes, const void* tables,
                                     const void* valid, const void* cand,
                                     void* keys, void* gthr, void* codes_t,
                                     void* tables_g, long long n_rows,
                                     long long n_cols, int n_q, int m, int k,
                                     int shared, int chunk, int parts,
                                     long long span, long long npad,
                                     void* stream) {
  Args a = make_args(codes, tables, valid, cand, n_rows, n_cols, n_q, m,
                     chunk, parts, span, npad);
  a.keys = static_cast<long long*>(keys);
  a.gthr = static_cast<long long*>(gthr);
  a.k = k;
  return dispatch<true>(a, codes, tables, codes_t, tables_g, shared != 0,
                        static_cast<cudaStream_t>(stream));
}
