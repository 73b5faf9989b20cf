// Hamming top-k over packed sign bits, the top-k fused into the distance
// loop, the distances on the 1-bit tensor cores.
//
// Replaces `hamming_topk_pallas` (neumann_tpu/ops/pallas_kernels.py:90)
// around the Pallas TPU kernel `_hamming_kernel` (:40): that design
// writes the [Q, N] int32 distances of each row block to device memory
// and leaves the top-k to XLA (lax.top_k, :147). Here no distance reaches
// device memory. For each query the function is the k best rows by
// (distance ascending, row ascending), lax.top_k's order among equal
// distances. Each warp writes the k smallest keys distance << 32 | row of
// its rows; one torch.topk over [Q, groups * slices * k] keys
// (ops/kernels.py) finishes, as lax.top_k sits outside the Pallas kernel.
//
// What bounds it on an H100. One query reads the corpus once: 100.7 MB
// at D's 1,048,576 rows x 24 words, 0.030 ms at 3.35 TB/s. A batch is
// bound by its bit products: D's 1,024 queries are 1.6e15 operations, 0.16
// ms at the 1-bit mma.sync rate that chip_smoke.py measures with
// b1_rate_kernel below (1.025e16 ops/s; the data sheet gives none):
//   hamming(r, q) = popc(r) + popc(q) - 2 popc(r AND q).
//
// The design:
//   * queries on the M side of mma.sync.m16n8k256.b1.and.popc, corpus rows
//     on N: each consumer warp owns a tile of 16 queries (A, laid out once
//     a block in shared memory, one 16-byte load a K step a stage) and
//     runs it over its rows of each stage (B, n8 tiles, one 8-byte load a
//     product). A thread's accumulators hold queries g and g + 8 x rows
//     2 t and 2 t + 1 of each n8 tile, so it tests against two limits.
//     The K order inside a 256-bit step is any permutation shared by A
//     and B: a thread takes words 8 s + 2 t and 8 s + 2 t + 1;
//   * a query's candidates and best list belong to one warp, so appends
//     take warp-local counters and merges __syncwarp only: the pass loop
//     has no block barrier;
//   * rows stream through a ring of 3-16 stages in shared memory, filled
//     by a producer warp with cp.async.bulk (one copy a stage where the
//     rows are unpadded, else one a row into a stride padded to 8 mod 16
//     words; the mask bytes by cp.async), each stage with a full (bytes
//     and mask copies), a ready and an empty mbarrier. With several query
//     tiles four helper warps count each stage's row popcounts once as it
//     lands and arrive on ready; with one tile each row has one reader,
//     which counts it from its own B words. Dead and out-of-range rows get
//     a popcount no limit passes. A consumer warp arrives on empty once it
//     has read the stage, and the producer refills it: the producer waits
//     on empty alone and the helpers on full alone, so both run as far
//     ahead of the consumers as the ring;
//   * up to 8 query tiles a block (128 queries), so the corpus crosses
//     from L2 once per 128 queries; a block of fewer tiles gives its spare
//     warps the same tiles on other rows of each stage (row slices), each
//     slice writing its own k keys;
//   * thresholds shared across blocks: after a merge a warp publishes its
//     k-th key made global with a 64-bit atomicMin into gthr [Q] (set to
//     0x7F.. by the entry point before the launch), and reads it one stage
//     ahead of its use. A block's k-th key is at least the global k-th, so
//     a (row, query) of a larger distance cannot be in the result; equal
//     distances pass (a lower row may win the tie), and a stale read only
//     loosens the limit;
//   * keys inside a warp are 32 bits, distance << b | row in the group,
//     b = min(20, clz(32 W)) (distances reach 32 W; the wrapper's groups
//     span at most 2^b rows), so merges and compares are 32-bit. A warp
//     meets its rows in ascending order, so a row tied with its own k-th
//     loses.
// The wrapper (ops/kernels._hamming_groups) picks query tiles, slices,
// rows a warp a stage and stages so that everything fits 227 KB of
// shared memory.
//
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; scripts/torch_hamming_topk_ab.py
// and scripts/torch_hamming_topk_probe.py, k 10): D's batch 1.32-1.33 ms
// (the design this replaced: 1.75), of which the launch with nothing
// selected takes 0.89-0.93 ms, without the products 0.55 and the copy
// pipeline alone 0.39; its consumer warps wait 115 of 1,632 clocks a
// stage, so their own work a stage (products, compares, mbarrier
// round trips at 2 warps a scheduler) holds it, not the copies or the
// tensor cores (0.16 ms). One query on D: 0.059 ms (0.093), the pipeline
// alone 0.039 (2.6 TB/s). E's batch (256 x 262,144 x 96 words): 0.223 ms
// (0.94); one query on E: 0.042 ms (0.070).

#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstdint>

#include "mma_b1.cuh"

namespace {

using neumann::mma_b1;

constexpr int kConsumers = 8;        // warps that multiply and select
constexpr int kHelpers = 4;          // warps that count rows
constexpr int kThreads = 32 * (kConsumers + kHelpers + 1);   // + producer
constexpr int kTileQ = 16;           // queries a consumer warp (M)
constexpr int kMaxRowTiles = 8;      // n8 row tiles a warp a stage, most
constexpr int kMaxStageRows = 128;
constexpr int kMinStages = 3;
constexpr int kMaxStages = 16;
constexpr int kMaxK = 64;            // the wrapper's cap on k
constexpr int kBufBase = 64;         // a buffer merges once it holds more
constexpr int kPerLane = (kMaxK + kBufBase + 8 * kMaxRowTiles) / 32;
constexpr int kMaxWords = 1 << 16;
constexpr int kSmemMax = 232448;     // a block's shared memory on sm_90
constexpr unsigned kNone = 0xFFFFFFFFu;
constexpr int kDead = 1 << 28;       // a dead row's popcount
constexpr int kNever = -(1 << 28);   // a limit nothing passes
constexpr int kRateThreads = 256;

// words a ring row. With more than one query tile the B loads set the
// pace: the least >= W that is 8 mod 16, so the 8-byte loads of rows g =
// 0..3 (a half warp) fall in distinct banks, one bulk copy a row. One
// tile reads each B fragment once and is bound by the copies: W, the
// stage one bulk copy.
__host__ __device__ inline int stride_of(int w, int tiles) {
  return tiles > 1 ? w + (24 - w % 16) % 16 : w;
}

// byte offsets of the shared memory: mbarriers, the queries' A fragments
// [tiles][steps][32] uint4, the ring [stages][rows][stride] and the rows'
// popcounts [stages][rows], popc(q), per consumer warp and query the
// threshold, the candidate count, the best keys [k] and the buffer, and
// the rows' mask bytes [stages][rows]
struct Layout {
  int qf, ring, pr, pq, thr, cnt, best, buf, mk, bytes;
};

__host__ __device__ inline Layout layout(int w, int k, int tiles,
                                         int slices, int rw, int stages) {
  const int steps = (w + 7) / 8, rows = slices * rw;
  const int warps = tiles * slices;
  Layout l;
  l.qf = 3 * kMaxStages * 8;
  l.ring = l.qf + tiles * steps * 32 * 16;
  l.pr = l.ring + stages * rows * stride_of(w, tiles) * 4;
  l.pq = l.pr + stages * rows * 4;
  l.thr = l.pq + tiles * kTileQ * 4;
  l.cnt = l.thr + warps * kTileQ * 4;
  l.best = l.cnt + warps * kTileQ * 4;
  l.buf = l.best + warps * kTileQ * k * 4;
  l.mk = l.buf + warps * kTileQ * (kBufBase + rw) * 4;
  l.bytes = l.mk + stages * rows;
  return l;
}

struct Args {
  const int32_t* corpus;
  const int32_t* queries;
  const uint8_t* mask;   // nullptr: every row live
  long long* out;
  long long* gthr;
  long long n_rows, span;
  int n_q, words, k, groups, tiles, slices, rw, stages;
  bool select;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
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

__device__ __forceinline__ void bar_arrive_expect(uint64_t* b,
                                                  unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(b)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* b) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(b))
      : "memory");
}

// 4 mask bytes into shared memory by cp.async, zero past `got` (only
// `got` bytes are read)
__device__ __forceinline__ void copy4(void* dst, const void* src, int got) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(got)
               : "memory");
}

// an arrival on b once this thread's cp.async copies have landed; b's
// pending count rises by one now, so its phase waits for them
__device__ __forceinline__ void copies_arrive(uint64_t* b) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];" ::"r"(
                   smem_addr(b))
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

// One warp: the k smallest of the query's best keys and its buffered
// candidates become its best keys (sorted), the threshold its k-th.
__device__ __forceinline__ void merge(unsigned* best, unsigned* buf,
                                      unsigned* thr, int* cnt, int k) {
  const int lane = threadIdx.x % 32;
  const int total = k + *cnt;
  unsigned v[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int j = lane + 32 * i;
    v[i] = j < k ? best[j] : (j < total ? buf[j - k] : kNone);
  }
  __syncwarp();
  for (int o = 0; o < k; ++o) {
    unsigned m = v[0];
#pragma unroll
    for (int i = 1; i < kPerLane; ++i) m = min(m, v[i]);
    const unsigned w = __reduce_min_sync(0xffffffffu, m);
    if (w == kNone) {   // fewer than k keys: the rest stay empty
      for (int j = o + lane; j < k; j += 32) best[j] = kNone;
      break;
    }
    if (lane == 0) best[o] = w;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) v[i] = v[i] == w ? kNone : v[i];
  }
  __syncwarp();
  if (lane == 0) {
    *thr = best[k - 1];
    *cnt = 0;
  }
}

// One instantiation a count of n8 row tiles a warp a stage (kRowTiles =
// rw / 8: 1, 2, 4 or 8), so the products and compares carry no guards,
// and a switch kOwnCounts for blocks of one query tile: each row is then
// read by one consumer warp alone, which counts its popcount from the B
// words it loads (two POPC a product), and the helpers stay idle; with
// more tiles the helpers count each row once for all of them.
// With `select` false no (row, query) passes its limit: the launch
// copies, counts, multiplies and compares but never appends or merges,
// and writes only empty keys (chip_smoke.py times it to split the
// kernel's time).
template <int kRowTiles, bool kOwnCounts>
__global__ void __launch_bounds__(kThreads, 1)
    hamming_topk_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout l = layout(a.words, a.k, a.tiles, a.slices, a.rw, a.stages);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* ready = full + kMaxStages;
  uint64_t* empty = ready + kMaxStages;
  uint4* qf = reinterpret_cast<uint4*>(smem + l.qf);
  int32_t* ring = reinterpret_cast<int32_t*>(smem + l.ring);
  int* pr = reinterpret_cast<int*>(smem + l.pr);
  int* pq = reinterpret_cast<int*>(smem + l.pq);
  unsigned* thr = reinterpret_cast<unsigned*>(smem + l.thr);
  int* cnt = reinterpret_cast<int*>(smem + l.cnt);
  unsigned* best = reinterpret_cast<unsigned*>(smem + l.best);
  unsigned* buf = reinterpret_cast<unsigned*>(smem + l.buf);
  uint8_t* mk = smem + l.mk;

  const int w = a.words, steps = (w + 7) / 8;
  const int stride = stride_of(w, a.tiles);
  const int rows = a.slices * a.rw, warps = a.tiles * a.slices;
  const int kbuf = kBufBase + a.rw;
  const int row_bits = min(20, __clz(32 * w));
  const int group = blockIdx.x;
  const int q0 = blockIdx.y * a.tiles * kTileQ;
  const int nq = min(a.tiles * kTileQ, a.n_q - q0);
  const long long span0 = group * a.span;
  const long long span1 = min(span0 + a.span, a.n_rows);
  const int n_it = static_cast<int>((span1 - span0 + rows - 1) / rows);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;

  auto qword = [&](int qi, int wd) -> unsigned {
    return qi < nq && wd < w
               ? static_cast<unsigned>(
                     a.queries[static_cast<long long>(q0 + qi) * w + wd])
               : 0u;
  };
  for (int i = threadIdx.x; i < a.tiles * kTileQ; i += kThreads) pq[i] = 0;
  __syncthreads();
  // A fragments {a0, a1, a2, a3}: queries g, g + 8 at word 8 s + 2 t, then
  // the same at 8 s + 2 t + 1 (zero past W and past the queries); popc(q)
  // summed from them, all loads in flight at once
  for (int i = threadIdx.x; i < a.tiles * steps * 32; i += kThreads) {
    const int li = i % 32, s = (i / 32) % steps, tile = i / (32 * steps);
    const int qa = tile * kTileQ + li / 4, w0 = 8 * s + 2 * (li % 4);
    const uint4 f = make_uint4(qword(qa, w0), qword(qa + 8, w0),
                               qword(qa, w0 + 1), qword(qa + 8, w0 + 1));
    qf[i] = f;
    atomicAdd(pq + qa, __popc(f.x) + __popc(f.z));
    atomicAdd(pq + qa + 8, __popc(f.y) + __popc(f.w));
  }
  for (int i = threadIdx.x; i < warps * kTileQ; i += kThreads) {
    thr[i] = kNone;
    cnt[i] = 0;
  }
  for (int i = threadIdx.x; i < warps * kTileQ * a.k; i += kThreads) {
    best[i] = kNone;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      bar_init(full + s, 1);
      bar_init(ready + s, kHelpers);
      bar_init(empty + s, warps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers + kHelpers) {
    // the producer: a copy into each stage once every consumer warp has
    // read it; it waits on nothing else, so the ring stays full
    for (int it = 0; it < n_it; ++it) {
      const int st = it % a.stages;
      if (it >= a.stages) bar_wait(empty + st, (it / a.stages - 1) & 1);
      const long long r0 = span0 + static_cast<long long>(it) * rows;
      const int nr = static_cast<int>(min(static_cast<long long>(rows),
                                          span1 - r0));
      int32_t* dst = ring + st * rows * stride;
      const int32_t* src = a.corpus + r0 * w;
      // the stage's mask bytes, 4 rows a lane (zero past the group),
      // their arrival counted on the stage's full barrier before the
      // rows' bytes are expected
      if (a.mask != nullptr && 4 * lane < rows) {
        const int got = max(0, min(4, nr - 4 * lane));
        copy4(mk + st * rows + 4 * lane,
              a.mask + r0 + (got > 0 ? 4 * lane : 0), got);
        copies_arrive(full + st);
      }
      __syncwarp();
      if (lane == 0) bar_arrive_expect(full + st, nr * w * 4);
      __syncwarp();
      if (stride == w) {
        if (lane == 0) bulk_copy(dst, src, nr * w * 4, full + st);
      } else {
        for (int r = lane; r < nr; r += 32) {
          bulk_copy(dst + r * stride, src + static_cast<long long>(r) * w,
                    w * 4, full + st);
        }
      }
    }
    return;
  }
  if (warp >= kConsumers) {
    if (kOwnCounts) return;   // one tile: the consumers count their rows
    // helpers: each counts rows / 4 rows of every stage as it lands, as
    // far ahead of the consumers as the ring. Rows of 8 or more 16-byte
    // chunks take 8 lanes a row, 4 rows at a time (a quarter warp reads
    // 128 consecutive bytes, whatever the stride); narrower rows all of
    // the helper's rows at once, 32 / (rows / 4) lanes a row
    const int hw = warp - kConsumers, rh = rows / kHelpers;
    const int lpr = w / 4 >= 8 ? 8 : 32 / rh, per_pass = 32 / lpr;
    const int sub = lane / lpr, c0 = lane % lpr;
    for (int it = 0; it < n_it; ++it) {
      const int st = it % a.stages;
      bar_wait(full + st, (it / a.stages) & 1);
      for (int r4 = 0; r4 < rh; r4 += per_pass) {
        const int r = hw * rh + r4 + sub;
        const bool mine = r4 + sub < rh;
        int p = 0;
        if (mine) {
          const uint4* row =
              reinterpret_cast<const uint4*>(ring + (st * rows + r) * stride);
          for (int c = c0; c < w / 4; c += lpr) {
            const uint4 v = row[c];
            p += __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
          }
        }
        for (int o = 1; o < lpr; o <<= 1) {
          p += __shfl_xor_sync(0xffffffffu, p, o);
        }
        if (mine && c0 == 0) {
          const long long gr = span0 + static_cast<long long>(it) * rows + r;
          const bool live =
              gr < span1 && (a.mask == nullptr || mk[st * rows + r] != 0);
          pr[st * rows + r] = live ? p : kDead;
        }
      }
      __syncwarp();   // one arrival a warp (lanes arriving on one
      if (lane == 0) bar_arrive(ready + st);   // word serialize)
    }
    return;
  }
  if (warp >= warps) return;   // a block of fewer tiles x slices

  // consumers: tile `tile` of the block's queries over slice `slice` of
  // each stage's rows
  const int tile = warp % a.tiles, slice = warp / a.tiles;
  const int qb = tile * kTileQ;
  unsigned* my_thr = thr + warp * kTileQ;
  int* my_cnt = cnt + warp * kTileQ;
  unsigned* my_best = best + warp * kTileQ * a.k;
  unsigned* my_buf = buf + warp * kTileQ * kbuf;
  const uint4* af = qf + tile * steps * 32 + lane;
  bool has[2];
  int pqv[2];
  const long long* gq[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = qb + g + 8 * h;
    has[h] = a.select && qi < nq;
    pqv[h] = pq[qi];
    gq[h] = a.gthr + q0 + (has[h] ? qi : 0);
  }
  // the shared thresholds are read one stage ahead of their use, so the
  // L2 round trip hides behind a stage's products
  long long gv[2], gnext[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) gnext[h] = has[h] ? load_relaxed(gq[h]) : 0;
  for (int it = 0; it < n_it; ++it) {
    const int st = it % a.stages;
    const unsigned parity = (it / a.stages) & 1;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      gv[h] = gnext[h];
      gnext[h] = has[h] ? load_relaxed(gq[h]) : 0;
    }
    // after the helpers saw it full, or full itself with no helpers
    bar_wait(kOwnCounts ? full + st : ready + st, parity);
    int acc[kRowTiles][4];
#pragma unroll
    for (int j = 0; j < kRowTiles; ++j) {
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[j][v] = 0;
    }
    const int32_t* sr =
        ring + (st * rows + slice * a.rw + g) * stride + 2 * t;
    int own[kRowTiles] = {};   // kOwnCounts: this lane's words of row g
    for (int s = 0; s < steps; ++s) {
      const uint4 av = af[s * 32];
      const unsigned am[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
      for (int j = 0; j < kRowTiles; ++j) {
        const uint2 bv =
            *reinterpret_cast<const uint2*>(sr + 8 * j * stride + 8 * s);
        const unsigned bm[2] = {bv.x, bv.y};
        mma_b1(acc[j], am, bm);
        if (kOwnCounts && 8 * s + 2 * t < w) {   // not the next row's
          own[j] += __popc(bv.x) + __popc(bv.y);
        }
      }
    }
    int2 prs[kRowTiles];
#pragma unroll
    for (int j = 0; j < kRowTiles; ++j) {
      const int r0 = st * rows + slice * a.rw + 8 * j;
      if (kOwnCounts) {   // row g's count over its 4 lanes, then rows 2 t
        int p = own[j];   // and 2 t + 1 from the lanes that hold them
        p += __shfl_xor_sync(0xffffffffu, p, 1);
        p += __shfl_xor_sync(0xffffffffu, p, 2);
        int q[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          q[e] = __shfl_sync(0xffffffffu, p, 4 * (2 * t + e));
          const long long gr = span0 + static_cast<long long>(it) * rows +
                               slice * a.rw + 8 * j + 2 * t + e;
          const bool live = gr < span1 &&
                            (a.mask == nullptr || mk[r0 + 2 * t + e] != 0);
          q[e] = live ? q[e] : kDead;
        }
        prs[j] = make_int2(q[0], q[1]);
      } else {
        prs[j] = *reinterpret_cast<const int2*>(pr + r0 + 2 * t);
      }
    }
    __syncwarp();
    if (lane == 0) bar_arrive(empty + st);   // the warp has read the stage

    // (row, query) passes iff pr - 2 dot < lim = limit - popc(q), the
    // limit the least of the warp's own k-th distance (strict: its rows
    // come in ascending order) and the published one + 1 (ties pass)
    int lim[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (has[h]) {
        const long long own = my_thr[g + 8 * h] >> row_bits;
        lim[h] = static_cast<int>(min(own, (gv[h] >> 32) + 1)) - pqv[h];
      } else {
        lim[h] = kNever;
      }
    }
    int low[2] = {INT_MAX, INT_MAX};   // least pr - 2 dot a query
#pragma unroll
    for (int j = 0; j < kRowTiles; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        low[h] = min(low[h], min(prs[j].x - 2 * acc[j][2 * h],
                                 prs[j].y - 2 * acc[j][2 * h + 1]));
      }
    }
    if (low[0] < lim[0] || low[1] < lim[1]) {   // rare once settled
      const unsigned local0 = static_cast<unsigned>(
          static_cast<long long>(it) * rows + slice * a.rw + 2 * t);
#pragma unroll
      for (int j = 0; j < kRowTiles; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int p = e ? prs[j].y : prs[j].x;
            if (p - 2 * acc[j][2 * h + e] < lim[h]) {
              const int qi = g + 8 * h;
              const unsigned dist =
                  static_cast<unsigned>(p + pqv[h] - 2 * acc[j][2 * h + e]);
              my_buf[qi * kbuf + atomicAdd(my_cnt + qi, 1)] =
                  (dist << row_bits) | (local0 + 8 * j + e);
            }
          }
        }
      }
    }
    __syncwarp();
    const bool last = it + 1 == n_it;
    const int c = lane < kTileQ ? my_cnt[lane] : 0;
    unsigned need = __ballot_sync(0xffffffffu, c > kbuf - a.rw ||
                                                   (last && c > 0));
    while (need != 0) {
      const int qi = __ffs(need) - 1;
      need &= need - 1;
      merge(my_best + qi * a.k, my_buf + qi * kbuf, my_thr + qi, my_cnt + qi,
            a.k);
      const unsigned kth = my_best[qi * a.k + a.k - 1];
      if (lane == 0 && kth != kNone) {   // publish the k-th, made global
        atomicMin(reinterpret_cast<unsigned long long*>(a.gthr) + q0 + qb +
                      qi,
                  (static_cast<unsigned long long>(kth >> row_bits) << 32) |
                      static_cast<unsigned long long>(
                          span0 + (kth & ((1u << row_bits) - 1))));
      }
    }
    __syncwarp();
  }

  for (int i = lane; i < kTileQ * a.k; i += 32) {
    const int qi = i / a.k;
    if (qb + qi >= nq) break;
    const unsigned key = my_best[i];
    long long gk = LLONG_MAX;
    if (key != kNone) {
      gk = (static_cast<long long>(key >> row_bits) << 32) |
           (span0 + (key & ((1u << row_bits) - 1)));
    }
    a.out[((static_cast<long long>(q0 + qb + qi) * a.groups + group) *
               a.slices +
           slice) *
              a.k +
          i % a.k] = gk;
  }
}

bool pow2(int x) { return x > 0 && (x & (x - 1)) == 0; }

int dispatch(Args a, void* stream) {
  const int w = a.words, rows = a.slices * a.rw;
  if (w % 4 || w < 4 || w > kMaxWords || a.k < 1 || a.k > kMaxK ||
      a.span < 1 || a.n_q < 1 || a.n_rows < 1 || !pow2(a.tiles) ||
      a.tiles > 8 || !pow2(a.slices) || a.tiles * a.slices > kConsumers ||
      !pow2(a.rw) || a.rw < 8 || a.rw > 8 * kMaxRowTiles ||
      rows > kMaxStageRows || a.stages < kMinStages ||
      a.stages > kMaxStages || a.span % rows ||
      a.span > (1LL << std::min(20, __builtin_clz(32u * w))) ||
      a.groups * a.span < a.n_rows ||
      (a.groups - 1) * a.span >= a.n_rows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = layout(w, a.k, a.tiles, a.slices, a.rw, a.stages).bytes;
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  const int per_block = a.tiles * kTileQ;
  const long long qblocks = (a.n_q + per_block - 1) / per_block;
  if (qblocks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.select) {   // no threshold yet: 0x7F7F... is above every key
    const cudaError_t set = cudaMemsetAsync(
        a.gthr, 0x7F, static_cast<size_t>(a.n_q) * sizeof(long long), s);
    if (set != cudaSuccess) return static_cast<int>(set);
  }
  const bool own = a.tiles == 1;
  const auto kernel =
      a.rw == 8    ? (own ? hamming_topk_kernel<1, true>
                          : hamming_topk_kernel<1, false>)
      : a.rw == 16 ? (own ? hamming_topk_kernel<2, true>
                          : hamming_topk_kernel<2, false>)
      : a.rw == 32 ? (own ? hamming_topk_kernel<4, true>
                          : hamming_topk_kernel<4, false>)
                   : (own ? hamming_topk_kernel<8, true>
                          : hamming_topk_kernel<8, false>);
  const cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid(static_cast<unsigned>(a.groups),
                  static_cast<unsigned>(qblocks));
  kernel<<<grid, kThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

Args make_args(const void* corpus, const void* queries, const void* mask,
               void* out, void* gthr, long long n_rows, int n_q, int w, int k,
               long long span, int groups, int tiles, int slices, int rw,
               int stages, bool select) {
  Args a;
  a.corpus = static_cast<const int32_t*>(corpus);
  a.queries = static_cast<const int32_t*>(queries);
  a.mask = static_cast<const uint8_t*>(mask);
  a.out = static_cast<long long*>(out);
  a.gthr = static_cast<long long*>(gthr);
  a.n_rows = n_rows;
  a.span = span;
  a.n_q = n_q;
  a.words = w;
  a.k = k;
  a.groups = groups;
  a.tiles = tiles;
  a.slices = slices;
  a.rw = rw;
  a.stages = stages;
  a.select = select;
  return a;
}

// The card's rate of m16n8k256.b1.and.popc: each warp issues `iters`
// rounds of 8 independent products on register fragments, no memory in
// the loop. One int a thread is written so nothing is dropped.
__global__ void __launch_bounds__(kRateThreads) b1_rate_kernel(int iters,
                                                               int* out) {
  const unsigned x = threadIdx.x * 0x9E3779B9u + blockIdx.x;
  const unsigned a[4] = {x, x ^ 0x55555555u, ~x, x * 3u};
  const unsigned b[2] = {x ^ 0x0F0F0F0Fu, x * 5u};
  int c[8][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) mma_b1(c[j], a, b);
  }
  int s = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * kRateThreads + threadIdx.x] = s;
}

}  // namespace

// corpus [N, W] int32 bit patterns, queries [Q, W] int32, mask [N] bool
// (nullptr: every row live), gthr [Q] int64 scratch (set here) -> out
// [Q, groups, slices, k] int64 keys distance << 32 | row, ascending in
// each (group, slice), LLONG_MAX past its live rows. The plan (tiles of
// 16 queries a block, row slices, rows a warp a stage, stages, groups of
// span rows) is ops/kernels._hamming_groups's; W % 4 == 0, 1 <= k <= 64,
// pointers 16-byte aligned (the wrapper checks). Returns the first CUDA
// error of the memset, the attribute or the launch.
extern "C" int neumann_hamming_topk(const void* corpus, const void* queries,
                                    const void* mask, void* out, void* gthr,
                                    long long n_rows, int n_q, int w, int k,
                                    long long span, int groups, int tiles,
                                    int slices, int rw, int stages,
                                    void* stream) {
  return dispatch(make_args(corpus, queries, mask, out, gthr, n_rows, n_q, w,
                            k, span, groups, tiles, slices, rw, stages, true),
                  stream);
}

// For measurement only: the same launch with nothing selected (out gets
// only LLONG_MAX, gthr is neither set nor read), so its time is that of
// the copies, the row counts, the products and the compares, without the
// appends, merges and shared thresholds.
extern "C" int neumann_hamming_topk_unselected(
    const void* corpus, const void* queries, const void* mask, void* out,
    void* gthr, long long n_rows, int n_q, int w, int k, long long span,
    int groups, int tiles, int slices, int rw, int stages, void* stream) {
  return dispatch(make_args(corpus, queries, mask, out, gthr, n_rows, n_q, w,
                            k, span, groups, tiles, slices, rw, stages,
                            false),
                  stream);
}

// For measurement only: `blocks` x 256 threads of b1_rate_kernel into out
// [blocks * 256] int32; it does blocks * 8 * iters * 8 products of
// 16 x 8 x 256 bits.
extern "C" int neumann_b1_mma_rate(int blocks, int iters, void* out,
                                   void* stream) {
  b1_rate_kernel<<<blocks, kRateThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      iters, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
