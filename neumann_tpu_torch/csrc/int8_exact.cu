// Exact scan of an int8 plane with f32 queries on the bf16 tensor cores:
// f32 cosine scores and lax.top_k's selection in one launch, or the scores
// written.
//
// Replaces the jitted `int8_exact_topk` of the JAX package
// (neumann_tpu/ops/quant.py:402), the exact scan of DeviceIVFInt8's delta
// plane (called from neumann_tpu/ops/ivf.py:797-803): an int8 -> f32
// convert, a Precision.HIGHEST dot, the multiplier mask and lax.top_k
// under lax.scan, one XLA program. For query q and row n:
//   s[q, n] = (sum_k qf[q, k] * float(c[n, k])) * rm[n]   where rm[n] > 0
//           = -inf                                        elsewhere
// qf the unit-normalised f32 query (normalised by the wrapper).
//
// The arithmetic. An int8 value is exact in bf16, and the wrapper
// (ops/kernels._exact_split) splits each f32 query into three bf16 parts,
// hi = bf16(qf), mid = bf16(qf - hi), lo = bf16(qf - hi - mid), with
// hi + mid + lo == qf exactly (outside bf16's subnormal range). So three
// bf16 products with f32 accumulation hold every product of qf and the
// row exactly: the tensor cores' sums are the only roundings. A stage of
// 64 K is summed by 12 wgmma into a fresh accumulator, the parts in the
// order lo, mid, hi, 4 K steps of 16 each; the stage is then added to the
// running f32 sum by one rounded add. Folding a stage at a time keeps the
// tensor cores' accumulation (truncating, not rounded to nearest) to a
// stage's partial sums, a twelfth of the whole at d 768. The order is the
// same for every (query, row) in both kernels, both modes and wherever
// the row falls in a tile, so equal rows score bit-equal and their ties
// go by ascending row, as lax.top_k orders them.
//
// Two modes of each kernel:
//   * select (1 <= k <= 64): each block keeps, for each of its queries,
//     the k greatest int64 keys of ops/scan.stable_keys (the score's
//     order-preserving int32 image above the row's complement) over the
//     rows it walks, and writes them; one torch.topk over [Q, parts * k]
//     and a decode finish (ops/kernels.int8_exact_topk). No score reaches
//     device memory;
//   * scores: the masked [Q, N] scores (k above 64; the wrapper selects
//     over each block of rows with its carry).
//
// What bounds it on an H100, at cell A17's delta plane (419,430 filled
// slots x 768): at Q = 1,024 the three bf16 passes, 1.98e12 FLOP (2.0 ms
// at 989 TFLOP/s; an FFMA design's bound was 9.8 ms at 67 TFLOP/s)
// against 0.32 GB of rows (0.10 ms at 3.35 TB/s); at Q = 1 the row bytes.
//
// The design: rows on the wgmma's M side from registers, queries on N
// from shared memory. A block is two warpgroups over a tile of 128 rows
// (64 a warpgroup) x kNQ queries: 8 (Q <= 8) or 16 (two blocks a SM), or
// 128 (one block a SM). Its first thread loads each stage by TMA, the row
// tile [128 rows][64 bytes] and the three query parts [kNQ][64 bf16]
// (128-byte swizzle), into a ring of stages signalled by full / empty
// mbarriers. Up to 16 queries at d up to kResK, the block splits the f32
// queries into the parts of every K step itself at its start, and they
// stay in shared memory: a stage is its rows alone (staging the parts
// with every stage cost 0.025 ms of 0.185 at Q 1, their split on the host
// 0.13 ms a call). It refills a slot once both warpgroups are done with
// it (a producer warp of its own would cap the block's registers at 168:
// a 9-warp block puts 3 warps on some of a SM's 4 register files). A
// thread reads its 8 bytes of rows g and g + 8 of its warp's 16 for each
// 32 K and converts them in registers into its four bf16x2 A registers a
// K step (bf16x2_even: exact, 1.75 instructions a byte), for the next
// stage while this stage's products run. The query parts hold K permuted
// within each 32 (ops/kernels._exact_parts) so that the A fragment's K
// places are the bytes the thread converted.
// Blocks: the wrapper's plan gives `parts` spans of rows, each walked by
// one block per query block (neighbours in the grid, so they share the
// span's rows in L2), a flat sequence of (tile, stage) through the ring.
// Selection: after each tile a key passes if it beats its query's k-th
// key in the block as of the last merge (a score below that key's score
// is out with one compare); a passing key goes to the query's buffer in
// shared memory (atomicAdd a slot). Only a key that finds its buffer full
// makes the block merge (out of line): one warp a query puts the buffered
// keys into the query's list (by insertion, a place by two ballots, for a
// few keys; by rounds of a warp max for many), which lives in the block's
// slice of the keys output (global memory); the buffers left at the end
// are merged then. A list is read and written about once a buffer of
// passing keys, and past the first tiles few keys pass; shared memory
// holds the ring, the k-th keys and the buffers, the same at every k.
//
// Measured: see PERF.md row 9 (chip_smoke.py phase 2).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "hopper.cuh"
#include "pooled_bits.cuh"

namespace {

using neumann::gmma_desc;
using neumann::mbar_arrive;
using neumann::mbar_arrive_expect_tx;
using neumann::mbar_init;
using neumann::mbar_wait;
using neumann::smem_u32;
using neumann::tma_load_2d;
using neumann::wgmma_commit;
using neumann::wgmma_fence;
using neumann::wgmma_wait;

constexpr int kMaxK = 64;                 // the wrapper's cap on k
constexpr long long kEmpty = LLONG_MIN;   // below every real key
constexpr int kSmemMax = 232448;          // a block's shared memory
constexpr int kConsumers = 256;           // a block: two warpgroups
constexpr int kRows = 128;                // rows a tile
constexpr int kStageK = 64;               // K a stage (ldq divides by it)
constexpr int kRowBytes = kRows * kStageK;   // a stage's int8 row tile

// a block's geometry by its queries (8, 16 or 128) and whether the query
// parts stay in shared memory for the whole walk (kRes: up to 16 queries,
// d up to kResK; else they are staged with each stage's rows): stages of
// the ring, a query's candidate buffer, blocks a SM
template <int kNQ, bool kRes>
struct Geo {
  static constexpr int kPartBytes = kNQ * kStageK * 2;   // bf16 [kNQ][64]
  static constexpr int kStageBytes = kRowBytes + (kRes ? 0 : 3 * kPartBytes);
  static constexpr int kStages = kNQ == 8 || (kNQ == 16 && !kRes) ? 4 : 3;
  static constexpr int kCap = kNQ == 128 ? 32 : (kNQ == 16 && kRes ? 64 : 128);
  static constexpr int kPerSm = kNQ <= 16 ? 2 : 1;
};
constexpr int kResK = 768;   // the widest d whose few queries' parts stay

struct Args {
  const float* xf;         // kRes: the f32 queries [n_q, ldq]
  const float* row_mult;   // [n_rows]
  float* scores;           // scores mode: [n_q, n_rows]
  long long* keys;         // select mode: [n_q, parts, k]
  long long n_rows, span;
  int d, ldq, n_q, qp, k, parts;
};

// d += a (64 rows x 16 K, bf16, from registers: the warp's m16k16
// fragment) * b (16 K x 8 queries, bf16, K-major in shared memory, the
// 128-byte swizzle), f32 accumulators, asynchronous; scale_d 0 overwrites
// d. d[4 j + v]: row g + 8 (v >> 1) of the warp's 16, query 8 j + 2 t +
// (v & 1).
__device__ __forceinline__ void wgmma_n8(float (&d)[4],
                                          const unsigned (&a)[4],
                                          uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// d += a (64 rows x 16 K, bf16, from registers: the warp's m16k16
// fragment) * b (16 K x 16 queries, bf16, K-major in shared memory, the
// 128-byte swizzle), f32 accumulators, asynchronous; scale_d 0 overwrites
// d. d[4 j + v]: row g + 8 (v >> 1) of the warp's 16, query 8 j + 2 t +
// (v & 1).
__device__ __forceinline__ void wgmma_n16(float (&d)[8],
                                          const unsigned (&a)[4],
                                          uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// d += a (64 rows x 16 K, bf16, from registers: the warp's m16k16
// fragment) * b (16 K x 128 queries, bf16, K-major in shared memory, the
// 128-byte swizzle), f32 accumulators, asynchronous; scale_d 0 overwrites
// d. d[4 j + v]: row g + 8 (v >> 1) of the warp's 16, query 8 j + 2 t +
// (v & 1).
__device__ __forceinline__ void wgmma_n128(float (&d)[64],
                                          const unsigned (&a)[4],
                                          uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

template <int kNQ>
__device__ __forceinline__ void wgmma_bf16(float (&d)[kNQ / 2],
                                           const unsigned (&a)[4],
                                           uint64_t desc_b, int scale_d) {
  if constexpr (kNQ == 8) {
    wgmma_n8(d, a, desc_b, scale_d);
  } else if constexpr (kNQ == 16) {
    wgmma_n16(d, a, desc_b, scale_d);
  } else {
    wgmma_n128(d, a, desc_b, scale_d);
  }
}

// After a wgmma.wait_group: registers the products wrote (or read) are
// ready, and the compiler may move no use of them above this point.
template <int kN>
__device__ __forceinline__ void fence_regs(float (&r)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ void fence_regs(unsigned (&r)[4][4]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    asm volatile("" : "+r"(r[i / 4][i % 4])::"memory");
  }
}

// the block's barrier apart from __syncthreads (named barrier 1), and its
// OR of a predicate
__device__ __forceinline__ void block_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

__device__ __forceinline__ bool block_or(bool p) {
  unsigned r;
  asm volatile(
      "{\n"
      ".reg .pred a, b;\n"
      "setp.ne.u32 a, %1, 0;\n"
      "bar.red.or.pred b, 1, %2, a;\n"
      "selp.u32 %0, 1, 0, b;\n"
      "}\n"
      : "=r"(r)
      : "r"(static_cast<unsigned>(p)), "n"(kConsumers)
      : "memory");
  return r != 0;
}

// a block's selection, per query slot: the best keys (k, descending,
// kEmpty past those there are) at best + slot * stride in the keys
// output; in shared memory the k-th key, its score (-inf while there are
// fewer than k keys: a score below it cannot pass), the candidate buffer
// [cap] and its count
struct Sel {
  long long* best;
  long long stride;
  long long* thr;
  float* thr_score;
  long long* buf;
  int* cnt;
  int k;
};

// ops/scan.stable_keys's key of score v at row n (n < 2^32 - 1)
__device__ __forceinline__ long long make_key(float v, long long n) {
  int b = __float_as_int(v);
  b = b < 0 ? (b ^ 0x7FFFFFFF) : b;
  return static_cast<long long>(
      (static_cast<unsigned long long>(static_cast<unsigned>(b)) << 32) |
      static_cast<unsigned long long>(0xFFFFFFFFu -
                                      static_cast<unsigned>(n)));
}

// One warp: the keys of buf[0, n) that beat the k-th of best[0, k)
// (descending, kEmpty past the keys there are; k <= 64) inserted in
// place, the list's places j and j + 32 in lane j's registers: a key's
// place is the count of the list's keys above it (two ballots), and the
// keys below it move one place down. Keys are distinct (the row is in
// their low bits). Returns the new k-th key.
__device__ __forceinline__ long long merge_insert(long long* best,
                                                  const long long* buf,
                                                  int n, int k) {
  const int lane = threadIdx.x % 32;
  long long v0 = lane < k ? best[lane] : kEmpty;
  long long v1 = lane + 32 < k ? best[lane + 32] : kEmpty;
  auto kth = [&]() {
    return k <= 32 ? __shfl_sync(0xffffffffu, v0, k - 1)
                   : __shfl_sync(0xffffffffu, v1, k - 33);
  };
  long long last = kth();
  for (int i = 0; i < n; ++i) {
    const long long w = buf[i];
    if (!(w > last)) continue;   // the same for the whole warp
    const int pos = __popc(__ballot_sync(0xffffffffu, v0 > w)) +
                    __popc(__ballot_sync(0xffffffffu, v1 > w));
    const long long up0 = __shfl_up_sync(0xffffffffu, v0, 1);
    long long up1 = __shfl_up_sync(0xffffffffu, v1, 1);
    const long long end0 = __shfl_sync(0xffffffffu, v0, 31);
    if (lane == 0) up1 = end0;
    v0 = lane < pos ? v0 : (lane == pos ? w : up0);
    v1 = lane + 32 < pos ? v1 : (lane + 32 == pos ? w : up1);
    if (lane >= k) v0 = kEmpty;
    if (lane + 32 >= k) v1 = kEmpty;
    last = kth();
  }
  if (lane < k) best[lane] = v0;
  if (lane + 32 < k) best[lane + 32] = v1;
  return last;
}

// One warp: the k greatest of best[0, k) and buf[0, n) become best,
// sorted descending, kEmpty past the keys there are: k rounds of a warp
// max over all of them (the cheaper way when n is large against k).
template <int kPerLane>
__device__ __forceinline__ void merge_rounds(long long* best,
                                             const long long* buf, int n,
                                             int k) {
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

// the score of key k (make_key's inverse), -inf for kEmpty
__device__ __forceinline__ float key_score(long long k) {
  if (k == kEmpty) return -INFINITY;
  const int b = static_cast<int>(k >> 32);
  return __int_as_float(b < 0 ? (b ^ 0x7FFFFFFF) : b);
}

// Every thread of the block: each slot's buffered keys go into its list
// (one warp a slot: insertion for a few keys, rounds of a warp max for
// many; the same list either way), its k-th key and count are reset.
template <int kCap>
__device__ __forceinline__ void merge_all(const Sel& s, int slots) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  block_sync();   // the buffered keys are in
  for (int sl = warp; sl < slots; sl += kConsumers / 32) {
    const int n = min(s.cnt[sl], kCap);
    if (n == 0) continue;
    long long* best = s.best + sl * s.stride;
    long long kth;
    if (2 * n > s.k) {
      merge_rounds<(kMaxK + kCap + 31) / 32>(best, s.buf + sl * kCap, n,
                                             s.k);
      kth = best[s.k - 1];
    } else {
      kth = merge_insert(best, s.buf + sl * kCap, n, s.k);
    }
    if (lane == 0) {
      s.thr[sl] = kth;
      s.thr_score[sl] = key_score(kth);
      s.cnt[sl] = 0;
    }
  }
  block_sync();   // the lists, k-th keys and counts are in
}

// Every thread of the block, after a tile in which a passing key found
// its slot's buffer full: the thread's keys key_of(i) (i < kN, for query
// slot slot_of(i)) flagged in `pend`. The block merges every buffer, the
// keys still above their raised k-th go to the emptied buffers, and so
// on until each is in. The buffers left at the end of the walk are
// merged there (merge_all), so a list is read and written about once in
// kCap passing keys, not once a tile.
template <int kN, int kCap, class KeyOf, class SlotOf>
__device__ __forceinline__ void rounds(const Sel& s, int slots,
                                       unsigned long long pend, KeyOf key_of,
                                       SlotOf slot_of) {
  do {
    merge_all<kCap>(s, slots);
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      if (((pend >> i) & 1) && key_of(i) > s.thr[slot_of(i)]) {
        const int sl = slot_of(i);
        const int at = atomicAdd(s.cnt + sl, 1);
        if (at < kCap) {   // else kept for after the next merge
          s.buf[sl * kCap + at] = key_of(i);
          pend &= ~(1ull << i);
        }
      } else {
        pend &= ~(1ull << i);
      }
    }
  } while (block_or(pend != 0));
}

// a compile-time buffer index for the pipelined mainloop's lambdas
template <int B>
struct Buf {
  static constexpr int value = B;
};

// A tile's selection rounds after a buffer filled, out of line: sc the
// thread's masked scores (local memory, rarely), sc[4 j + v] of row n0 + 8
// (v >> 1) and query slot 8 j + 2 t + (v & 1).
template <int kNQ, int kCap>
__device__ __noinline__ void tile_rounds(const Sel s, const float* sc,
                                         unsigned long long pend,
                                         long long n0, long long r_end,
                                         int q0, int n_q) {
  const int t = threadIdx.x % 4;
  rounds<kNQ / 2, kCap>(
      s, kNQ, pend,
      [&](int i) {
        const long long n = n0 + 8 * ((i % 4) >> 1);
        const int ql = 8 * (i / 4) + 2 * t + (i & 1);
        return n < r_end && q0 + ql < n_q ? make_key(sc[i], n) : kEmpty;
      },
      [&](int i) { return 8 * (i / 4) + 2 * t + (i & 1); });
}

// bytes 0 and 2 of w (signed) as a bf16 pair, byte 0 in the low half,
// exactly: a byte's low 7 bits in the mantissa of 128 (bf16 0x4300, whose
// ulp is 1), less 128 or, for a negative byte, 256 (0x4380: the byte's
// sign bit on the same place): b >= 0 is (128 + b) - 128, b < 0 is (128 +
// b + 128) - 256; two logic ops and one bf16x2 subtraction for two bytes
__device__ __forceinline__ unsigned bf16x2_even(unsigned w) {
  const unsigned v = (w & 0x007F007Fu) | 0x43004300u;
  const unsigned m = (w & 0x00800080u) | 0x43004300u;
  unsigned d;
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(v), "r"(m));
  return d;
}

// Block (part, query block), part-major: rows [part * span, + span) in
// tiles of 128 against queries q0 .. q0 + kNQ - 1 of the padded qp. The
// query map is the [3 qp, ldq] bf16 parts (hi, mid, lo), each K-permuted.
template <int kNQ, bool kRes, bool kSelect>
__global__ void __launch_bounds__(kConsumers, Geo<kNQ, kRes>::kPerSm)
    exact_wgmma_kernel(const __grid_constant__ CUtensorMap row_map,
                       const __grid_constant__ CUtensorMap query_map,
                       const Args a) {
  using G = Geo<kNQ, kRes>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // the 128-byte swizzle is a function of the shared address: stages
  // start on 1,024-byte boundaries (the launch adds the slack)
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int k_steps = (a.d + kStageK - 1) / kStageK;
  // kRes: the query parts of every K step, [step][part][kNQ][64 bf16]
  uint8_t* qres = smem + G::kStages * G::kStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(
      qres + (kRes ? k_steps * 3 * G::kPartBytes : 0));
  uint64_t* empty = full + G::kStages;
  const int nqb = a.qp / kNQ;
  const int part = blockIdx.x / nqb;
  const int q0 = (blockIdx.x % nqb) * kNQ;
  Sel s;
  s.best = a.keys + (static_cast<long long>(q0) * a.parts + part) * a.k;
  s.stride = static_cast<long long>(a.parts) * a.k;
  s.thr = reinterpret_cast<long long*>(empty + G::kStages);
  s.buf = s.thr + kNQ;
  s.thr_score = reinterpret_cast<float*>(s.buf + kNQ * G::kCap);
  s.cnt = reinterpret_cast<int*>(s.thr_score + kNQ);
  s.k = a.k;
  const long long r_begin = static_cast<long long>(part) * a.span;
  const long long r_end = min(r_begin + a.span, a.n_rows);
  const int iters =
      static_cast<int>((r_end - r_begin + kRows - 1) / kRows) * k_steps;

  if (threadIdx.x == 0) {
    for (int i = 0; i < G::kStages; ++i) {
      mbar_init(&full[i], 1);
      // kRes: a stage's rows are free once every warp has read its
      // fragments (one arrival a warp); else once both warpgroups'
      // products, which read its query parts, are done
      mbar_init(&empty[i], kRes ? kConsumers / 32 : 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (kSelect) {
    for (int i = threadIdx.x; i < kNQ; i += kConsumers) {
      s.thr[i] = kEmpty;
      s.thr_score[i] = -INFINITY;
      s.cnt[i] = 0;
    }
    for (int i = threadIdx.x; i < kNQ * a.k; i += kConsumers) {
      if (q0 + i / a.k < a.n_q) s.best[(i / a.k) * s.stride + i % a.k] =
          kEmpty;
    }
  }
  __syncthreads();

  // thread 0 issues the loads: stage `it` into its ring slot by TMA, the
  // slot's full mbarrier counting the bytes
  auto load = [&](int it) {
    const int st = it % G::kStages;
    mbar_arrive_expect_tx(&full[st], G::kStageBytes);
    const int k0 = (it % k_steps) * kStageK;
    uint8_t* stage = smem + st * G::kStageBytes;
    tma_load_2d(stage, &row_map, k0,
                static_cast<int>(r_begin + (it / k_steps) * kRows),
                &full[st]);
    if constexpr (!kRes) {
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        tma_load_2d(stage + kRowBytes + p * G::kPartBytes, &query_map, k0,
                    p * a.qp + q0, &full[st]);
      }
    }
  };
  if (threadIdx.x == 0) {
    for (int it = 0; it < min(iters, G::kStages); ++it) load(it);
  }
  if constexpr (kRes) {
    // the parts of every K step, split here from the f32 queries as
    // ops/kernels._exact_split splits them, in the column order of
    // ops/kernels._exact_parts and the 128-byte swizzle wgmma reads:
    // column 16 c + 8 h + 2 t + e of each 32 holds query column 8 t + 4 c
    // + h + 2 e, and [row n][byte b] of a part's tile is at n * 128 + ((b
    // / 16) ^ (n % 8)) * 16 + b % 16
    const int cols = k_steps * kStageK;
    for (int i = threadIdx.x; i < kNQ * cols; i += kConsumers) {
      const int n = i / cols, l = i % cols, w = l % 32;
      const int col = l - w + 8 * ((w % 8) / 2) + 4 * (w / 16) +
                      (w / 8) % 2 + 2 * (w % 2);
      const float v = q0 + n < a.n_q && col < a.d
                          ? a.xf[static_cast<long long>(q0 + n) * a.ldq + col]
                          : 0.f;
      const __nv_bfloat16 hi = __float2bfloat16_rn(v);
      const float rest = v - __bfloat162float(hi);
      const __nv_bfloat16 mid = __float2bfloat16_rn(rest);
      const __nv_bfloat16 lo =
          __float2bfloat16_rn(rest - __bfloat162float(mid));
      const int b = 2 * (l % kStageK);
      __nv_bfloat16* at = reinterpret_cast<__nv_bfloat16*>(
          qres + (l / kStageK) * 3 * G::kPartBytes + n * 128 +
          (((b >> 4) ^ (n & 7)) << 4) + (b & 15));
      at[0] = hi;
      at[G::kPartBytes / 2] = mid;
      at[G::kPartBytes] = lo;
    }
    // the async proxy (wgmma) reads what these stores wrote
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
  }

  const int lane = threadIdx.x % 32;
  const int t = lane & 3;
  // the thread's rows of a tile: r and r + 8
  const int r = 64 * (threadIdx.x / 128) + 16 * ((threadIdx.x / 32) % 4) +
                (lane >> 2);
  float acc[kNQ / 2];
  unsigned fa[2][4][4];   // the A fragments of this stage and the next
  float rm[2];
  float sum[kNQ / 2];

  // stage `it`, once it has landed: its A fragments into fa[b]
  auto convert = [&](auto buf, int it) {
    constexpr int b = decltype(buf)::value;
    const int st = it % G::kStages;
    mbar_wait(&full[st], (it / G::kStages) & 1);
    const uint8_t* stage = smem + st * G::kStageBytes;
    // A: K step j (16 K) of rows r / r + 8 is bytes 8 t + 4 (j % 2) ..
    // + 3 of the stage's 32-byte block j / 2: bytes {0, 2} in registers
    // 0 / 1, {1, 3} in 2 / 3 (the query parts' K permutation matches)
#pragma unroll
    for (int blk = 0; blk < 2; ++blk) {
      const uint2 w0 = *reinterpret_cast<const uint2*>(
          stage + r * kStageK + 32 * blk + 8 * t);
      const uint2 w1 = *reinterpret_cast<const uint2*>(
          stage + (r + 8) * kStageK + 32 * blk + 8 * t);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const unsigned x0 = c ? w0.y : w0.x;
        const unsigned x1 = c ? w1.y : w1.x;
        fa[b][2 * blk + c][0] = bf16x2_even(x0);
        fa[b][2 * blk + c][1] = bf16x2_even(x1);
        fa[b][2 * blk + c][2] = bf16x2_even(x0 >> 8);
        fa[b][2 * blk + c][3] = bf16x2_even(x1 >> 8);
      }
    }
    if constexpr (kRes) {   // the warp's reads of the slot are done
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }
  };

  // thread 0: once the slot of stage `it` is free, stage it + kStages
  // into it
  auto refill = [&](int it) {
    if (threadIdx.x == 0 && it + G::kStages < iters) {
      mbar_wait(&empty[it % G::kStages], (it / G::kStages) & 1);
      load(it + G::kStages);
    }
  };

  // stage `it`'s 12 products from fa[b], asynchronous; at a tile's last
  // stage its row multipliers are read
  auto issue = [&](auto buf, int it) {
    constexpr int b = decltype(buf)::value;
    if (it % k_steps == k_steps - 1) {
      const long long n0 =
          r_begin + static_cast<long long>(it / k_steps) * kRows + r;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        rm[h] = n0 + 8 * h < r_end ? a.row_mult[n0 + 8 * h] : 0.f;
      }
    }
    const uint8_t* parts =
        kRes ? qres + (it % k_steps) * 3 * G::kPartBytes
             : smem + (it % G::kStages) * G::kStageBytes + kRowBytes;
    wgmma_fence();
#pragma unroll
    for (int p = 2; p >= 0; --p) {   // lo, mid, hi
      const uint64_t db = gmma_desc(parts + p * G::kPartBytes);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wgmma_bf16<kNQ>(acc, fa[b][j], db + 2 * j, p < 2 || j > 0);
      }
    }
    wgmma_commit();
  };

  // stage `it`'s products are done (from fa[b]): with staged query parts
  // its ring slot goes back; the stage is added to the sums, and at a
  // tile's last stage the epilogue: the masked scores, then the selection
  // or the stores
  auto retire = [&](auto buf, int it) {
    constexpr int b = decltype(buf)::value;
    fence_regs(acc);
    fence_regs(fa[b]);
    if constexpr (!kRes) {   // the products read the slot's query parts
      if (threadIdx.x % 128 == 0) mbar_arrive(&empty[it % G::kStages]);
      refill(it);   // once both warpgroups are done with it
    }
    const int kt = it % k_steps;
#pragma unroll
    for (int i = 0; i < kNQ / 2; ++i) {
      sum[i] = kt == 0 ? acc[i] : __fadd_rn(sum[i], acc[i]);
    }
    if (kt != k_steps - 1) return;
    const long long n0 =
        r_begin + static_cast<long long>(it / k_steps) * kRows + r;
#pragma unroll
    for (int i = 0; i < kNQ / 2; ++i) {
      const float m = rm[(i % 4) >> 1];
      sum[i] = m > 0.f ? __fmul_rn(sum[i], m) : -INFINITY;
    }
    if constexpr (kSelect) {
      // a key beating its slot's k-th (as of the last merge; a score
      // below the k-th's is out at once) goes to the slot's buffer; those
      // that find it full wait in `pend` for the block to merge
      unsigned long long pend = 0;
#pragma unroll
      for (int i = 0; i < kNQ / 2; ++i) {
        const long long n = n0 + 8 * ((i % 4) >> 1);
        const int ql = 8 * (i / 4) + 2 * t + (i & 1);
        if (n < r_end && q0 + ql < a.n_q && sum[i] >= s.thr_score[ql]) {
          const long long key = make_key(sum[i], n);
          if (key > s.thr[ql]) {
            const int at = atomicAdd(s.cnt + ql, 1);
            if (at < G::kCap) {
              s.buf[ql * G::kCap + at] = key;
            } else {
              pend |= 1ull << i;
            }
          }
        }
      }
      if (block_or(pend != 0)) {
        float sc[kNQ / 2];
#pragma unroll
        for (int i = 0; i < kNQ / 2; ++i) sc[i] = sum[i];
        tile_rounds<kNQ, G::kCap>(s, sc, pend, n0, r_end, q0, a.n_q);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kNQ / 2; ++i) {
        const long long n = n0 + 8 * ((i % 4) >> 1);
        const int q = q0 + 8 * (i / 4) + 2 * t + (i & 1);
        if (n < r_end && q < a.n_q) {
          a.scores[static_cast<long long>(q) * a.n_rows + n] = sum[i];
        }
      }
    }
  };

  // the next stage's A fragments are built while this stage's products
  // run (the two alternate between fa[0] and fa[1]); resident query
  // parts: a slot is refilled as soon as every warp has read its rows
  convert(Buf<0>{}, 0);
  for (int it = 0; it < iters; it += 2) {
    issue(Buf<0>{}, it);
    if (it + 1 < iters) convert(Buf<1>{}, it + 1);
    if constexpr (kRes) refill(it);
    wgmma_wait<0>();
    retire(Buf<0>{}, it);
    if (it + 1 == iters) break;
    issue(Buf<1>{}, it + 1);
    if (it + 2 < iters) convert(Buf<0>{}, it + 2);
    if constexpr (kRes) refill(it + 1);
    wgmma_wait<0>();
    retire(Buf<1>{}, it + 1);
  }
  if constexpr (kSelect) merge_all<G::kCap>(s, kNQ);   // the buffers left
}

template <int kNQ, bool kRes>
constexpr int smem_bytes(bool select, int k_steps) {
  using G = Geo<kNQ, kRes>;
  return 1024 + G::kStages * G::kStageBytes +
         (kRes ? k_steps * 3 * G::kPartBytes : 0) + 2 * G::kStages * 8 +
         (select ? kNQ * 8 + kNQ * G::kCap * 8 + kNQ * 8 : 0);
}
static_assert(smem_bytes<128, false>(true, 1) <= kSmemMax, "a 128-query "
              "block");
static_assert(2 * (smem_bytes<16, false>(true, 1) + 1024) <= 233472 &&
                  2 * (smem_bytes<16, true>(true, kResK / kStageK) + 1024) <=
                      233472,
              "two blocks of 8 or 16 queries a SM");

template <int kNQ, bool kRes, bool kSelect>
int launch(const void* c, const void* x, const Args& a, cudaStream_t s) {
  CUtensorMap row_map;
  CUtensorMap query_map;   // kRes: unused (the kernel reads a.xf)
  int err = neumann::encode_map_2d(&row_map, CU_TENSOR_MAP_DATA_TYPE_UINT8,
                                   c, a.d, a.n_rows, a.d, kStageK, kRows,
                                   CU_TENSOR_MAP_SWIZZLE_NONE);
  if (kRes) {
    query_map = row_map;
  } else if (err == 0) {
    err = neumann::encode_map_2d(
        &query_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, a.ldq,
        3LL * a.qp, 2LL * a.ldq, kStageK, kNQ, CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (err != 0) return err;
  const int smem = smem_bytes<kNQ, kRes>(kSelect, (a.d + kStageK - 1) /
                                                       kStageK);
  auto kernel = exact_wgmma_kernel<kNQ, kRes, kSelect>;
  const cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (set != cudaSuccess) return static_cast<int>(set);
  const unsigned blocks =
      static_cast<unsigned>(static_cast<long long>(a.qp / kNQ) * a.parts);
  kernel<<<blocks, kConsumers, smem, s>>>(row_map, query_map, a);
  return static_cast<int>(cudaGetLastError());
}

template <bool kSelect>
int dispatch(const void* c, const void* x, Args a, cudaStream_t s) {
  const int nq = a.n_q <= 8 ? 8 : (a.n_q <= 16 ? 16 : 128);
  const bool res = nq <= 16 && a.d <= kResK;
  a.qp = a.n_q < 1 ? 0 : (a.n_q + nq - 1) / nq * nq;
  a.xf = static_cast<const float*>(x);
  if (a.n_rows < 1 || a.n_rows >= (1LL << 31) || a.d < kStageK ||
      a.d % 16 || a.n_q < 1 || a.ldq < a.d ||
      (!res && a.ldq % kStageK) || reinterpret_cast<uintptr_t>(c) % 16 ||
      reinterpret_cast<uintptr_t>(x) % (res ? 4 : 16) || a.parts < 1 ||
      a.span < kRows || a.span % kRows ||
      static_cast<long long>(a.parts) * a.span < a.n_rows ||
      static_cast<long long>(a.parts - 1) * a.span >= a.n_rows ||
      static_cast<long long>(a.qp / nq) * a.parts > INT_MAX ||
      (kSelect && (a.k < 1 || a.k > kMaxK))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nq == 8) {
    return res ? launch<8, true, kSelect>(c, x, a, s)
               : launch<8, false, kSelect>(c, x, a, s);
  }
  if (nq == 16) {
    return res ? launch<16, true, kSelect>(c, x, a, s)
               : launch<16, false, kSelect>(c, x, a, s);
  }
  return launch<128, false, kSelect>(c, x, a, s);
}

Args make_args(const void* row_mult, long long n_rows, int d, int ldq,
               int n_q, int parts, long long span) {
  Args a;
  a.xf = nullptr;
  a.row_mult = static_cast<const float*>(row_mult);
  a.scores = nullptr;
  a.keys = nullptr;
  a.n_rows = n_rows;
  a.span = span;
  a.d = d;
  a.ldq = ldq;
  a.n_q = n_q;
  a.qp = 0;
  a.k = 0;
  a.parts = parts;
  return a;
}

}  // namespace

// c [n_rows, d] int8 rows (d % 16 == 0, d >= 64, 16-byte aligned: TMA's
// strides), row_mult [n_rows] f32 (<= 0: a dead row), x the n_q unit
// queries (ops/kernels._exact_queries): up to 16 queries at d <= kResK,
// [n_q, ldq] f32 (ldq >= d, zero past the query's width), which each
// block splits itself; else [3, qp, ldq] bf16, their parts hi, mid, lo
// (ops/kernels._exact_parts: K permuted within each 32, zero past d and
// past n_q; qp the least multiple of 8, 16 or 128 >= n_q by n_q, ldq a
// multiple of 64 >= d). The plan (ops/kernels._exact_plan): `parts`
// blocks along the rows (each query block's), each walking `span` rows, a
// multiple of 128. Select mode, 1 <= k <= 64: keys [n_q, parts, k] int64,
// each block's k greatest keys a query, descending, LLONG_MIN past its
// rows.
// Returns the launch's CUDA error code (cudaErrorInvalidValue for
// arguments it does not take).
extern "C" int neumann_int8_exact_select(const void* c, const void* row_mult,
                                         const void* x, void* keys,
                                         long long n_rows, int d, int ldq,
                                         int n_q, int k, int parts,
                                         long long span, void* stream) {
  Args a = make_args(row_mult, n_rows, d, ldq, n_q, parts, span);
  a.keys = static_cast<long long*>(keys);
  a.k = k;
  return dispatch<true>(c, x, a, static_cast<cudaStream_t>(stream));
}

// Scores mode: out [n_q, n_rows] f32, the masked scores. Arguments
// otherwise as neumann_int8_exact_select.
extern "C" int neumann_int8_exact_scores(const void* c, const void* row_mult,
                                         const void* x, void* out,
                                         long long n_rows, int d, int ldq,
                                         int n_q, int parts, long long span,
                                         void* stream) {
  Args a = make_args(row_mult, n_rows, d, ldq, n_q, parts, span);
  a.scores = static_cast<float*>(out);
  return dispatch<false>(c, x, a, static_cast<cudaStream_t>(stream));
}
