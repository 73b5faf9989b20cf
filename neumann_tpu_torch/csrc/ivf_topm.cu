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
// 1,024 x 768, 82,944 filled slots): bytes. The probed windows' rows are
// read once, 3.2 GB (1.0 ms at 3.35 TB/s); the filled slots' dots are
// 1.3e11 int8 operations (0.07 ms on the int8 tensor cores). The design:
//   * one block per (live window, group of kG slots); slots fill from 0,
//     so a block whose first slot is empty exits at once, and the padded
//     slots of the query tables (about two thirds at A17) cost nothing;
//     a window's groups are neighbouring blocks, so its rows come from L2
//     after the first;
//   * the group's query rows are gathered through the table into shared
//     memory once (128-byte swizzle); the window's rows stream through a
//     3-stage cp.async ring of 128 rows x 128 K bytes, rows on the M side
//     of mma.sync.m16n8k32.s8 (8 warps x 16 rows), slots on N (csrc/
//     mma_s8.cuh, as csrc/batched_probe.cu);
//   * after a 128-row tile's last K stage each warp turns its 16 rows x
//     kG slots into keys in the slots' key arrays in shared memory; once a
//     chunk of kChunk rows (the window up to 1,024, a power of two) is in,
//     each warp sorts its slots' keys descending (bitonic, in shared
//     memory, one warp a slot, no block barrier) and writes the first m
//     as scores and positions;
//   * wider windows (one window a cluster can pass 1,024 rows) run in
//     chunks: the block writes each chunk's best min(m, kChunk) keys, and
//     one torch.topk over a slot's chunks finishes (the wrapper). The
//     keys of distinct rows are distinct, so the cut is exact.
// A simple kernel: the sort (55 warp steps at 1,024 keys) runs while the
// ring is idle, and a 1,024-row window holds one block a SM.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "mma_s8.cuh"
#include "pooled_bits.cuh"

namespace {

using neumann::cp_async16;
using neumann::cp_async_commit;
using neumann::cp_async_wait;
using neumann::ldsm_x2;
using neumann::ldsm_x4;
using neumann::mma_s8;
using neumann::swz128;

constexpr int kThreads = 256;   // 8 warps x 16 rows
constexpr int kTile = 128;      // rows a tile
constexpr int kBK = 128;        // K bytes a stage
constexpr int kStages = 3;
constexpr int kStageBytes = kTile * kBK;
constexpr int kHeader = 256;    // slot scales, query rows, the live count
constexpr long long kEmpty = LLONG_MIN;   // below every real key

// ops/scan.stable_keys's key of score v at offset w
__device__ __forceinline__ long long make_key(float v, int w) {
  int b = __float_as_int(v);
  b = b < 0 ? (b ^ 0x7FFFFFFF) : b;
  return static_cast<long long>(
      (static_cast<unsigned long long>(static_cast<unsigned>(b)) << 32) |
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
  int chunk;                // keys a slot sorts at once: a power of two
};

template <int kG>
__global__ void __launch_bounds__(kThreads, 1) ivf_topm_kernel(Args a) {
  constexpr int kNT = kG / 8;
  extern __shared__ __align__(128) uint8_t smem[];
  float* sc_s = reinterpret_cast<float*>(smem);                  // [kG]
  long long* qidx_s = reinterpret_cast<long long*>(smem + 64);   // [kG]
  int* count_s = reinterpret_cast<int*>(smem + 192);
  uint8_t* ring = smem + kHeader;
  uint8_t* qtile = ring + kStages * kStageBytes;   // [k_stage][kG][128]
  const int k_stages = (a.d + kBK - 1) / kBK;
  long long* keys =
      reinterpret_cast<long long*>(qtile + k_stages * kG * kBK);

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
    const unsigned filled = __ballot_sync(0xffffffffu, qi >= 0);
    if (lane < kG) {
      qidx_s[lane] = qi;
      sc_s[lane] = qi >= 0 ? a.qsc[qi] : 0.f;
    }
    if (lane == 0) *count_s = filled ? 32 - __clz(filled) : 0;
  }
  __syncthreads();
  const int count = *count_s;
  if (count == 0) return;   // the whole block: padded slots

  // the group's query rows, zero past d and in empty slots
  const int row_chunks = k_stages * (kBK / 16);
  for (int i = threadIdx.x; i < kG * row_chunks; i += kThreads) {
    const int r = i / row_chunks;
    const int cc = i % row_chunks;
    const long long qi = qidx_s[r];
    const bool ok = r < count && qi >= 0 && cc * 16 < a.d;
    cp_async16(qtile + (cc >> 3) * kG * kBK + swz128(r, cc & 7),
               ok ? a.qq + qi * a.d + cc * 16 : a.qq, ok);
  }
  cp_async_commit();

  const long long first = a.first[l];
  const long long base = a.base[l];
  const int n_chunks = (a.window + a.chunk - 1) / a.chunk;
  const int mc = min(a.m, a.chunk);
  const int n_nt = (count + 7) / 8;

  for (int ch = 0; ch < n_chunks; ++ch) {
    const int w0 = ch * a.chunk;
    const int rows = min(a.chunk, a.window - w0);   // a multiple of kTile
    const int iters = (rows / kTile) * k_stages;
    __syncthreads();   // the last chunk's keys are written out; ring free

    // the flat (row tile, K stage) sequence of the chunk through the ring
    auto issue = [&](int it) {
      if (it < iters) {
        const int tile = it / k_stages;
        const int k0 = (it % k_stages) * kBK;
        uint8_t* dst = ring + (it % kStages) * kStageBytes;
        const long long r0 = first + w0 + tile * kTile;
        for (int i = threadIdx.x; i < kTile * (kBK / 16); i += kThreads) {
          const int r = i >> 3;
          const int c16 = i & 7;
          const long long row = r0 + r;
          const bool ok = row >= 0 && row < a.n && k0 + 16 * c16 < a.d;
          cp_async16(dst + swz128(r, c16),
                     ok ? a.buf + row * a.d + k0 + 16 * c16 : a.buf, ok);
        }
      }
      cp_async_commit();   // an empty group keeps the wait counts aligned
    };
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) issue(s);

    int acc[kNT][4];
    float rm[2];
    for (int it = 0; it < iters; ++it) {
      cp_async_wait<kStages - 2>();
      __syncthreads();   // stage `it` landed; stage it - 1 is free again
      issue(it + kStages - 1);
      const int tile = it / k_stages;
      const int kt = it % k_stages;
      if (kt == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long row = first + w0 + tile * kTile + m_base + 8 * h + g;
          rm[h] = row >= 0 && row < a.n ? a.rmult[row] : 0.f;
        }
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[nt][v] = 0;
        }
      }
      const uint8_t* sa = ring + (it % kStages) * kStageBytes;
      const uint8_t* sb = qtile + kt * kG * kBK;
      const int ksteps = min(kBK / 32, (a.d - kt * kBK + 31) / 32);
#pragma unroll
      for (int ks = 0; ks < kBK / 32; ++ks) {
        if (ks < ksteps) {
          unsigned af[4];
          neumann::load_a(af, sa, m_base, ks);
          if (kG == 8) {
            unsigned bf[2];
            ldsm_x2(bf, sb + swz128(lane & 7, 2 * ks + ((lane >> 3) & 1)));
            mma_s8(acc[0], af, bf);
          } else {
#pragma unroll
            for (int np = 0; np < kNT / 2; ++np) {
              if (2 * np < n_nt) {
                // two n8 tiles: (2 np, 2 np + 1) x (the step's two chunks)
                unsigned bf[4];
                ldsm_x4(bf, sb + swz128(np * 16 + (lane & 7) +
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
      if (kt != k_stages - 1) continue;
      // tile done: its keys into the slots' arrays
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        if (nt >= n_nt) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = tile * kTile + m_base + 8 * h + g;   // in the chunk
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int sl = nt * 8 + 2 * t + e;
            if (sl >= count) continue;
            float s = __int_as_float(0xff800000);   // -inf: a dead row
            if (rm[h] > 0.f) {
              s = __fmul_rn(__int2float_rn(acc[nt][2 * h + e]),
                            __fmul_rn(sc_s[sl], rm[h]));
            }
            keys[sl * a.chunk + r] = make_key(s, w0 + r);
          }
        }
      }
    }
    cp_async_wait<0>();
    // past the chunk's rows (a window that is not a power of two): keys
    // below every real key
    for (int i = threadIdx.x; i < count * (a.chunk - rows); i += kThreads) {
      keys[(i / (a.chunk - rows)) * a.chunk + rows + i % (a.chunk - rows)] =
          kEmpty;
    }
    __syncthreads();   // the chunk's keys are in

    // one warp a slot: a descending bitonic sort of its keys, then the
    // first m (one chunk) or mc (several) out
    for (int sl = warp; sl < count; sl += kThreads / 32) {
      if (qidx_s[sl] < 0) continue;
      long long* kk = keys + sl * a.chunk;
      for (int k = 2; k <= a.chunk; k <<= 1) {
        for (int j = k >> 1; j > 0; j >>= 1) {
          for (int i = lane; i < a.chunk / 2; i += 32) {
            const int lo = ((i & ~(j - 1)) << 1) | (i & (j - 1));
            const long long x = kk[lo];
            const long long y = kk[lo + j];
            if ((lo & k) == 0 ? x < y : x > y) {
              kk[lo] = y;
              kk[lo + j] = x;
            }
          }
          __syncwarp();
        }
      }
      const long long o = l * a.q_cap + slot0 + sl;
      if (n_chunks == 1) {
        for (int j = lane; j < a.m; j += 32) {
          const long long key = kk[j];
          a.out_s[o * a.m + j] = key_score(key);
          a.out_p[o * a.m + j] = static_cast<int32_t>(base + key_offset(key));
        }
      } else {
        long long* dst = a.out_k + (o * n_chunks + ch) * mc;
        for (int j = lane; j < mc; j += 32) dst[j] = kk[j];
      }
    }
  }
}

template <int kG>
int launch(const Args& a, int n_windows, int smem, cudaStream_t stream) {
  auto kernel = ivf_topm_kernel<kG>;
  const cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (set != cudaSuccess) return static_cast<int>(set);
  const long long blocks =
      static_cast<long long>(n_windows) * ((a.q_cap + kG - 1) / kG);
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// buf [n, d] int8, rmult [n] f32, first / base [L] int64, tbl [L, q_cap]
// int64, qq [Q, d] int8, qsc [Q] f32 -> with out_k null (the window in one
// chunk) out_s [L, q_cap, m] f32 and out_p [L, q_cap, m] int32 for the
// filled slots; else out_k [L, q_cap, chunks, min(m, chunk)] int64, each
// chunk's best keys (descending). d % 16 == 0, window % 128 == 0,
// 1 <= m <= window, chunk a power of two >= 128, `slots` 8 or 16 and
// `smem` the bytes of ops/kernels._topm_plan; buf and qq 16-byte aligned
// (the wrapper checks). Returns cudaGetLastError() after the launch.
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return slots == 8 ? launch<8>(a, n_windows, smem, s)
                    : launch<16>(a, n_windows, smem, s);
}
