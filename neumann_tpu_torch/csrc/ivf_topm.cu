// The non-fast batched IVF first pass: each probed window's rows against
// the int8 queries of its table, exact int8 dots times the query scale and
// the row multiplier, and the top-m of every (window, slot) in
// lax.top_k's order, in one launch.
//
// Replaces `score_window` with `lax.approx_max_k` of the JAX package
// (neumann_tpu/ops/ivf.py:1307-1351, the selection at :1350) under the
// window scan of `_batched_core` (:1470-1509): XLA's dynamic slice, int8
// dot, multiply, mask and top-k of every probed window, one program on
// the TPU. For live window l (one that some query probed), filled table
// slot s (query q = tbl[l, s] >= 0) and window row w, with the window's
// rows starting at first[l] (starts clamped into the buffer, as
// lax.dynamic_slice clamps, or l's fixed-window row on the stream view):
//   dot  = int8 qq[q] . int8 buf[first[l] + w]              (int32, exact)
//   mult = qsc[q] * rmult[first[l] + w]                     (f32)
//   s    = float(dot) * mult   where rmult > 0, else -inf   (f32)
// and the slot's top m of s over w, in the IEEE total order, equal scores
// by ascending w (the int64 keys of ops/scan.stable_keys: the score's
// order-preserving int32 image above the offset's complement), scores and
// positions base[l] + w (base the unclamped start, as JAX reports it).
// Dead rows keep their real positions, in offset order. Every rounding is
// spelled out (__int2float_rn, two __fmul_rn), so the scores are the plain
// version's bits (ops/kernels.ivf_window_topm_plain).
//
// What bounds it on an H100, at cell A17's TOP 65 batch (4,096 windows of
// 1,024 x 768, 82,944 filled slots, m 152): bytes. The probed windows'
// rows are read once, 3.2 GB (1.0 ms at 3.35 TB/s); the filled slots'
// dots are 1.3e11 int8 operations (0.07 ms on the int8 tensor cores).
// The design:
//   * one block per (live window, group of kG slots); slots fill from 0,
//     so a block whose first slot is empty exits at once (the padded
//     slots of the query tables, about two thirds at A17); a window's
//     groups are neighbouring blocks, so its rows come from L2 after the
//     first; the plan (ops/kernels._topm_plan) fits two blocks a SM up to
//     d 4,096, so one block's selection runs beside the other's stream;
//   * the group's query rows are gathered through the table into shared
//     memory once by cp.async; a producer warp streams the window's rows
//     by TMA in 128-row x 64-byte tiles (64-byte swizzle) through a
//     kStages ring of full / empty mbarriers; eight consumer warps take
//     16 rows each on the M side of mma.sync.m16n8k32.s8, slots on N
//     (csrc/mma_s8.cuh);
//   * after a tile's last K stage each warp stores its rows' scores as
//     32-bit order-preserving images (the key's upper half, sign flipped
//     to unsigned), indexed by the row's offset: 4 bytes a (slot, row);
//   * once a chunk of rows is in, a warp a slot finds the k-th largest
//     image T by a radix select (8-bit digits from the top, a 256-count
//     histogram in shared memory with warp-aggregated increments, the
//     digit's bin by a prefix scan; it stops at the first digit whose bin
//     is taken whole), takes every image above T and the first k - count
//     (> T) equal to T by ascending offset (lax.top_k's tie rule: the
//     keys of distinct rows are distinct), and sorts only those k keys in
//     registers (a 256-key bitonic network, warp shuffles); above 256
//     kept keys (m near the window) the block sorts each slot's whole
//     chunk of keys in shared memory instead, one slot at a time;
//   * wider windows (one window a cluster can pass 1,024 rows) run in
//     chunks: the block writes each chunk's best min(m, chunk) keys, and
//     one torch.topk over a slot's chunks finishes (the wrapper). The
//     keys of distinct rows are distinct, so the cut is exact.
// The histograms and the kept keys use the ring, which is idle once a
// chunk's last tile is in.

#include <cuda.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "hopper.cuh"
#include "mma_s8.cuh"

namespace {

using neumann::cp_async16;
using neumann::cp_async_commit;
using neumann::cp_async_wait;
using neumann::ldsm_x2;
using neumann::ldsm_x4;
using neumann::mbar_arrive;
using neumann::mbar_arrive_expect_tx;
using neumann::mbar_init;
using neumann::mbar_wait;
using neumann::mma_s8;
using neumann::tma_load_2d;

constexpr int kConsumers = 8;                 // warps, 16 rows each
constexpr int kThreads = 32 * (kConsumers + 1);   // + the producer warp
constexpr int kTile = 128;                    // rows a tile
constexpr int kBK = 64;                       // K bytes a stage
constexpr int kStages = 4;
constexpr int kStageBytes = kTile * kBK;
constexpr int kHeader = 512;   // mbarriers, slot scales and queries, count
constexpr int kAlign = 1024;   // the ring's alignment (slack in the plan)
constexpr int kPad = 4;        // images past a slot's chunk (bank spread)
constexpr int kSortMax = 256;  // kept keys a warp sorts in registers
constexpr int kScratch = kSortMax * 8;   // a warp's share of the ring
constexpr long long kEmpty = LLONG_MIN;  // below every real key
constexpr unsigned kFull = 0xffffffffu;

static_assert(kConsumers * kScratch <= kStages * kStageBytes,
              "the warps' histograms and kept keys fit the ring");
static_assert(2 * kStages * 8 + 16 * 4 + 16 * 8 + 4 <= kHeader,
              "the mbarriers, slot scales and queries and the count");

// byte offset of 16-byte chunk c (0-3) of row r in a tile of 64-byte rows
// in TMA's 64-byte swizzle (the tile 512-byte aligned): the chunk is
// XORed with bits 1-2 of the row, so 8 consecutive rows at one logical
// chunk land in 8 different 16-byte bank groups
__device__ __forceinline__ int swz64(int r, int c) {
  return r * 64 + ((c ^ ((r >> 1) & 3)) << 4);
}

// the score's order-preserving image: the upper half of
// ops/scan.stable_keys's key, sign bit flipped so it orders as unsigned
__device__ __forceinline__ unsigned score_image(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// ops/scan.stable_keys's key of the score with image `img` at offset w
__device__ __forceinline__ long long image_key(unsigned img, int w) {
  return static_cast<long long>(
      (static_cast<unsigned long long>(img ^ 0x80000000u) << 32) |
      static_cast<unsigned long long>(0xFFFFFFFFu -
                                      static_cast<unsigned>(w)));
}

__device__ __forceinline__ float key_score(long long k) {
  const int b = static_cast<int>(k >> 32);
  return __int_as_float(b < 0 ? (b ^ 0x7FFFFFFF) : b);
}

__device__ __forceinline__ int key_offset(long long k) {
  return static_cast<int>(0xFFFFFFFFu - static_cast<unsigned>(k));
}

// the consumer warps alone (the producer warp does not wait)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kConsumers) : "memory");
}

struct Args {
  const int8_t* buf;
  const float* rmult;
  const long long* first;   // [L] row the window's rows start at
  const long long* base;    // [L] the reported start (unclamped)
  const long long* tbl;     // [L, q_cap] query of each slot, -1 empty
  const int8_t* qq;         // [Q, d]
  const float* qsc;         // [Q]
  float* out_s;             // [L, q_cap, m] (one chunk)
  int32_t* out_p;
  long long* out_k;         // [L, q_cap, chunks, mc] (chunks > 1)
  long long n;
  int d;
  int window;
  int m;
  int q_cap;
  int chunk;                // rows a slot's images hold: a power of two
};

// A warp's top k (k <= kSortMax) of the images im[0, rows) of rows w0 +
// 0 .. rows - 1, in lax.top_k's order: x[r] is the key of rank 32 r +
// lane, kEmpty past k. scratch: the warp's kScratch bytes (the histogram,
// then the kept keys).
__device__ __forceinline__ void warp_topk(const unsigned* im, int rows,
                                          int k, int w0, uint8_t* scratch,
                                          long long (&x)[8]) {
  const int lane = threadIdx.x % 32;
  const unsigned below = (1u << lane) - 1;
  unsigned* hist = reinterpret_cast<unsigned*>(scratch);
  long long* kept = reinterpret_cast<long long*>(scratch);

  // T's digits from the top: after each pass the images whose masked
  // bits equal `prefix` hold the kk-th largest; a bin taken whole ends it
  unsigned prefix = 0, mask = 0;
  int kk = k;
  for (int shift = 24; shift >= 0; shift -= 8) {
#pragma unroll
    for (int b = 0; b < 8; ++b) hist[lane + 32 * b] = 0;
    __syncwarp();
    for (int i = lane; i < rows; i += 32) {
      const unsigned v = im[i];
      const bool in = (v & mask) == prefix;
      const unsigned act = __ballot_sync(kFull, in);
      if (in) {
        const unsigned dig = (v >> shift) & 255u;
        const unsigned peers = __match_any_sync(act, dig);
        if ((peers & below) == 0) atomicAdd(&hist[dig], __popc(peers));
      }
    }
    __syncwarp();
    // lane l holds bins 255 - 8 l - j (j = 0..7): counts from the top
    int c[8];
    int sum = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      c[j] = static_cast<int>(hist[255 - 8 * lane - j]);
      sum += c[j];
    }
    int incl = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += y;
    }
    const int src =
        __ffs(__ballot_sync(kFull, incl - sum < kk && kk <= incl)) - 1;
    int above = incl - sum, bin = 0, inbin = 0;
    bool found = false;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (!found && above + c[j] >= kk) {
        found = true;
        bin = 255 - 8 * lane - j;
        inbin = c[j];
      } else if (!found) {
        above += c[j];
      }
    }
    bin = __shfl_sync(kFull, bin, src);
    above = __shfl_sync(kFull, above, src);
    inbin = __shfl_sync(kFull, inbin, src);
    kk -= above;
    prefix |= static_cast<unsigned>(bin) << shift;
    mask |= 255u << shift;
    __syncwarp();   // the histogram is read before it is cleared or reused
    if (inbin == kk) break;
  }

  // the kept keys: every image above the cut, then the first kk at it
  // by ascending offset
  const int n_above = k - kk;
  int above_seen = 0, at_seen = 0;
  for (int i = lane; i < rows; i += 32) {
    const unsigned v = im[i];
    const unsigned mv = v & mask;
    const bool gt = mv > prefix;
    const bool eq = mv == prefix;
    const unsigned bg = __ballot_sync(kFull, gt);
    const unsigned be = __ballot_sync(kFull, eq);
    if (gt) kept[above_seen + __popc(bg & below)] = image_key(v, w0 + i);
    if (eq) {
      const int p = at_seen + __popc(be & below);
      if (p < kk) kept[n_above + p] = image_key(v, w0 + i);
    }
    above_seen += __popc(bg);
    at_seen += __popc(be);
  }
  for (int j = k + lane; j < kSortMax; j += 32) kept[j] = kEmpty;
  __syncwarp();
#pragma unroll
  for (int r = 0; r < 8; ++r) x[r] = kept[32 * r + lane];
  __syncwarp();   // read before the scratch is reused

  // descending bitonic network over rank 32 r + lane
#pragma unroll
  for (int lk = 1; lk <= 8; ++lk) {   // runs of kb = 2^lk keys
    const int kb = 1 << lk;
#pragma unroll
    for (int lj = lk - 1; lj >= 0; --lj) {   // partners j = 2^lj apart
      const int j = 1 << lj;
      if (j >= 32) {
        const int rj = j / 32;
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          if (r & rj) continue;
          const bool desc = ((32 * r + lane) & kb) == 0;
          const long long a = x[r];
          const long long b = x[r | rj];
          const bool swap = desc ? a < b : a > b;
          x[r] = swap ? b : a;
          x[r | rj] = swap ? a : b;
        }
      } else {
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const long long y = __shfl_xor_sync(kFull, x[r], j);
          const bool desc = ((32 * r + lane) & kb) == 0;
          const bool lower = (lane & j) == 0;
          const bool keep_max = lower == desc;
          x[r] = keep_max ? (x[r] > y ? x[r] : y) : (x[r] < y ? x[r] : y);
        }
      }
    }
  }
}

template <int kG>
__global__ void __launch_bounds__(kThreads, 2)
    ivf_topm_kernel(const __grid_constant__ CUtensorMap row_map,
                    const Args a) {
  constexpr int kNT = kG / 8;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((kAlign - (neumann::smem_u32(smem_raw) &
                                         (kAlign - 1))) & (kAlign - 1));
  const int k_stages = (a.d + kBK - 1) / kBK;
  uint8_t* qtile = ring + kStages * kStageBytes;   // [k_stage][kG][64]
  const int img_stride = a.chunk + kPad;
  unsigned* img = reinterpret_cast<unsigned*>(qtile + k_stages * kG * kBK);
  uint64_t* full = reinterpret_cast<uint64_t*>(img + kG * img_stride);
  uint64_t* empty = full + kStages;
  float* sc_s = reinterpret_cast<float*>(empty + kStages);        // [kG]
  long long* qidx_s = reinterpret_cast<long long*>(sc_s + 16);    // [kG]
  int* count_s = reinterpret_cast<int*>(qidx_s + 16);

  const int groups = (a.q_cap + kG - 1) / kG;
  const long long l = blockIdx.x / groups;
  const int slot0 = static_cast<int>(blockIdx.x % groups) * kG;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int m_base = warp * 16;

  // the group's slots: one past the last filled one (slots fill from 0)
  if (warp == 0) {
    const int s = slot0 + lane;
    const long long qi =
        lane < kG && s < a.q_cap ? a.tbl[l * a.q_cap + s] : -1;
    const unsigned filled = __ballot_sync(kFull, qi >= 0);
    if (lane < kG) {
      qidx_s[lane] = qi;
      sc_s[lane] = qi >= 0 ? a.qsc[qi] : 0.f;
    }
    if (lane == 0) *count_s = filled ? 32 - __clz(filled) : 0;
  } else if (warp == kConsumers && lane == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumers);   // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int count = *count_s;
  if (count == 0) return;   // the whole block: padded slots

  const long long first = a.first[l];
  const long long base = a.base[l];
  const int n_chunks = (a.window + a.chunk - 1) / a.chunk;
  const int mc = min(a.m, a.chunk);
  const int n_nt = (count + 7) / 8;

  if (warp < kConsumers) {
    // the group's query rows, zero past d and in empty slots
    const int row_chunks = k_stages * (kBK / 16);
    for (int i = threadIdx.x; i < kG * row_chunks; i += 32 * kConsumers) {
      const int r = i / row_chunks;
      const int cc = i % row_chunks;
      const long long qi = qidx_s[r];
      const bool ok = r < count && qi >= 0 && cc * 16 < a.d;
      cp_async16(qtile + (cc >> 2) * kG * kBK + swz64(r, cc & 3),
                 ok ? a.qq + qi * a.d + cc * 16 : a.qq, ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
    consumers_sync();
  }

  int it0 = 0;   // ring stages of the earlier chunks (the phases' count)
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int w0 = ch * a.chunk;
    const int rows = min(a.chunk, a.window - w0);   // a multiple of kTile
    const int iters = (rows / kTile) * k_stages;

    if (warp == kConsumers) {
      // the producer: stage `it` (row tile it / k_stages, K stage it %
      // k_stages) into its ring slot once the consumers freed it
      if (lane == 0) {
        for (int it = 0; it < iters; ++it) {
          const int gi = it0 + it;
          const int st = gi % kStages;
          if (gi >= kStages) mbar_wait(&empty[st], (gi / kStages - 1) & 1);
          mbar_arrive_expect_tx(&full[st], kStageBytes);
          const long long r0 = first + w0 + (it / k_stages) * kTile;
          tma_load_2d(ring + st * kStageBytes, &row_map,
                      (it % k_stages) * kBK, static_cast<int>(r0),
                      &full[st]);
        }
      }
      __syncwarp();
    } else {
      int acc[kNT][4];
      float rm[2];
      for (int it = 0; it < iters; ++it) {
        const int gi = it0 + it;
        const int st = gi % kStages;
        const int tile = it / k_stages;
        const int kt = it % k_stages;
        if (kt == 0) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const long long row =
                first + w0 + tile * kTile + m_base + 8 * h + g;
            rm[h] = row >= 0 && row < a.n ? a.rmult[row] : 0.f;
          }
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
            for (int v = 0; v < 4; ++v) acc[nt][v] = 0;
          }
        }
        mbar_wait(&full[st], (gi / kStages) & 1);
        const uint8_t* sa = ring + st * kStageBytes;
        const uint8_t* sb = qtile + kt * kG * kBK;
        const int ksteps = min(kBK / 32, (a.d - kt * kBK + 31) / 32);
#pragma unroll
        for (int ks = 0; ks < kBK / 32; ++ks) {
          if (ks < ksteps) {
            unsigned af[4];
            ldsm_x4(af, sa + swz64(m_base + (lane & 7) +
                                       ((lane >> 3) & 1) * 8,
                                   2 * ks + (lane >> 4)));
            if (kG == 8) {
              unsigned bf[2];
              ldsm_x2(bf, sb + swz64(lane & 7, 2 * ks + ((lane >> 3) & 1)));
              mma_s8(acc[0], af, bf);
            } else {
#pragma unroll
              for (int np = 0; np < kNT / 2; ++np) {
                if (2 * np < n_nt) {
                  // two n8 tiles: (2 np, 2 np + 1) x the step's two chunks
                  unsigned bf[4];
                  ldsm_x4(bf, sb + swz64(np * 16 + (lane & 7) +
                                             (lane >> 4) * 8,
                                         2 * ks + ((lane >> 3) & 1)));
                  const unsigned b0[2] = {bf[0], bf[1]};
                  const unsigned b1[2] = {bf[2], bf[3]};
                  mma_s8(acc[2 * np], af, b0);
                  if (2 * np + 1 < n_nt) mma_s8(acc[2 * np + 1], af, b1);
                }
              }
            }
          }
        }
        __syncwarp();   // the warp's fragments of the stage are read
        if (lane == 0) mbar_arrive(&empty[st]);
        if (kt != k_stages - 1) continue;
        // tile done: its scores' images into the slots' arrays
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          if (nt >= n_nt) continue;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = tile * kTile + m_base + 8 * h + g;   // in chunk
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int sl = nt * 8 + 2 * t + e;
              if (sl >= count) continue;
              float s = __int_as_float(0xff800000);   // -inf: a dead row
              if (rm[h] > 0.f) {
                s = __fmul_rn(__int2float_rn(acc[nt][2 * h + e]),
                              __fmul_rn(sc_s[sl], rm[h]));
              }
              img[sl * img_stride + r] = score_image(s);
            }
          }
        }
      }
    }
    it0 += iters;
    __syncthreads();   // the chunk's images are in; the ring is idle

#ifndef NEUMANN_TOPM_STREAM_ONLY
    const int k = min(mc, rows);
    if (k <= kSortMax) {
      // a warp a slot: the radix select, then its kept keys out
      for (int sl = warp; sl < count && warp < kConsumers;
           sl += kConsumers) {
        if (qidx_s[sl] < 0) continue;
        long long x[8];
        warp_topk(img + sl * img_stride, rows, k, w0,
                  ring + warp * kScratch, x);
        const long long o = l * a.q_cap + slot0 + sl;
        if (n_chunks == 1) {
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            const int j = 32 * r + lane;
            if (j < a.m) {
              a.out_s[o * a.m + j] = key_score(x[r]);
              a.out_p[o * a.m + j] =
                  static_cast<int32_t>(base + key_offset(x[r]));
            }
          }
        } else {
          long long* dst = a.out_k + (o * n_chunks + ch) * mc;
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            if (32 * r + lane < mc) dst[32 * r + lane] = x[r];
          }
          for (int j = kSortMax + lane; j < mc; j += 32) dst[j] = kEmpty;
        }
      }
    } else {
      // m near the window: the block sorts each slot's chunk of keys in
      // the ring, one slot at a time (bitonic, descending)
      long long* keys = reinterpret_cast<long long*>(ring);
      const int p2 = 1 << (32 - __clz(rows - 1));   // <= chunk
      for (int sl = 0; sl < count; ++sl) {
        if (qidx_s[sl] < 0) continue;
        const unsigned* im = img + sl * img_stride;
        for (int i = threadIdx.x; i < p2; i += kThreads) {
          keys[i] = i < rows ? image_key(im[i], w0 + i) : kEmpty;
        }
        __syncthreads();
        for (int kb = 2; kb <= p2; kb <<= 1) {
          for (int j = kb >> 1; j > 0; j >>= 1) {
            for (int i = threadIdx.x; i < p2 / 2; i += kThreads) {
              const int lo = ((i & ~(j - 1)) << 1) | (i & (j - 1));
              const long long x = keys[lo];
              const long long y = keys[lo + j];
              if ((lo & kb) == 0 ? x < y : x > y) {
                keys[lo] = y;
                keys[lo + j] = x;
              }
            }
            __syncthreads();
          }
        }
        const long long o = l * a.q_cap + slot0 + sl;
        if (n_chunks == 1) {
          for (int j = threadIdx.x; j < a.m; j += kThreads) {
            a.out_s[o * a.m + j] = key_score(keys[j]);
            a.out_p[o * a.m + j] =
                static_cast<int32_t>(base + key_offset(keys[j]));
          }
        } else {
          long long* dst = a.out_k + (o * n_chunks + ch) * mc;
          for (int j = threadIdx.x; j < mc; j += kThreads) {
            dst[j] = j < p2 ? keys[j] : kEmpty;
          }
        }
        __syncthreads();   // the keys are out before the next slot's
      }
    }
#endif
    // the ring's next tiles (TMA, the async proxy) follow these stores
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();   // the ring is free for the next chunk's tiles
  }
}

template <int kG>
int launch(const CUtensorMap& row_map, const Args& a, int n_windows,
           int smem, cudaStream_t stream) {
  auto kernel = ivf_topm_kernel<kG>;
  const cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (set != cudaSuccess) return static_cast<int>(set);
  const long long blocks =
      static_cast<long long>(n_windows) * ((a.q_cap + kG - 1) / kG);
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(row_map,
                                                                   a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// buf [n, d] int8, rmult [n] f32, first / base [L] int64, tbl [L, q_cap]
// int64, qq [Q, d] int8, qsc [Q] f32 -> with out_k null (the window in one
// chunk) out_s [L, q_cap, m] f32 and out_p [L, q_cap, m] int32 for the
// filled slots; else out_k [L, q_cap, chunks, min(m, chunk)] int64, each
// chunk's best keys (descending). d % 16 == 0, window % 128 == 0,
// 1 <= m <= window, n < 2^31, chunk a power of two >= 128, `slots` 8 or
// 16 and `smem` the bytes of ops/kernels._topm_plan; buf and qq 16-byte
// aligned (the wrapper checks). Returns a CUDA error code, or
// cudaGetLastError() after the launch.
extern "C" int neumann_ivf_topm(const void* buf, const void* rmult,
                                const void* first, const void* base,
                                const void* tbl, const void* qq,
                                const void* qsc, void* out_s, void* out_p,
                                void* out_k, long long n, int d, int window,
                                int m, int n_windows, int q_cap, int slots,
                                int chunk, int smem, void* stream) {
  Args a;
  a.buf = static_cast<const int8_t*>(buf);
  a.rmult = static_cast<const float*>(rmult);
  a.first = static_cast<const long long*>(first);
  a.base = static_cast<const long long*>(base);
  a.tbl = static_cast<const long long*>(tbl);
  a.qq = static_cast<const int8_t*>(qq);
  a.qsc = static_cast<const float*>(qsc);
  a.out_s = static_cast<float*>(out_s);
  a.out_p = static_cast<int32_t*>(out_p);
  a.out_k = static_cast<long long*>(out_k);
  a.n = n;
  a.d = d;
  a.window = window;
  a.m = m;
  a.q_cap = q_cap;
  a.chunk = chunk;
  if (n < 1 || n >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // rows past n (a window clamped at the end) come as zeros; their
  // multipliers read 0, so they score -inf
  CUtensorMap row_map;
  const int err = neumann::encode_map_2d(
      &row_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, buf, d, n, d, kBK, kTile,
      CU_TENSOR_MAP_SWIZZLE_64B);
  if (err != 0) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return slots == 8 ? launch<8>(row_map, a, n_windows, smem, s)
                    : launch<16>(row_map, a, n_windows, smem, s);
}
