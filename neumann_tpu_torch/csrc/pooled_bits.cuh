// Shared pieces of the pooled-bits scans (csrc/int8_scores.cu, kernel
// int8_pooled_bits; csrc/f32_pooled.cu): the tile geometry both dot
// loops use, and the pack / per-pool max epilogue.
//
// The epilogue is the XLA-fused step of neumann_tpu/ops/quant.py
// (int8_pooled_topk :371-385, f32_pooled_topk :525-539). For query q and
// corpus row n, with pools of `pool` CONSECUTIVE rows:
//   a    = float(dot[q, n]) * qmult[q]                  (one rounding)
//   s    = fma(a, rm[n], bias[n])                       (one rounding)
//   bits = (bitcast<int32>(s) & ~(pool - 1)) | (n & (pool - 1))
//   out[q, n / pool] = max over the pool of bits        (signed int32)
// bias is 2.0 on live rows and -1e30 on dead rows, so a live score
// lands in [1, 3) and bitcasts to a positive int whose order is the
// float order, while a dead row bitcasts negative and never beats a
// live one. Packing the row's index into the low log2(pool) mantissa
// bits makes one integer max carry both the score and its argmax.
// XLA on the CPU contracts `dots * qmult * rm + shift` into
// fma(dots * qmult, rm, shift) (bit-exact only with that single
// rounding, tests/test_torch_quant.py), so the kernels spell it out with
// __fmul_rn / __fmaf_rn and no compiler contraction choice can move a
// bit.
//
// Tile geometry: 256 threads = 16 (tx, corpus rows) x 16 (ty, queries).
// A block tile is kTQ * 16 queries x 128 rows; thread (tx, ty) owns rows
// tx + 16 j (j < 8) and queries ty + 16 i (i < kTQ). K is staged through
// shared memory 16 32-bit words at a time (64 int8 values or 16 floats),
// rows padded to 17 words so that the 16 tx lanes of a warp hit 16
// different banks.

#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace neumann {

constexpr int kThreads = 256;
constexpr int kTX = 16;                  // threads along corpus rows
constexpr int kTY = 16;                  // threads along queries
constexpr int kBN = 128;                 // corpus rows per tile
constexpr int kRowsPerThread = kBN / kTX;
constexpr int kWords = 16;               // 32-bit words of K per stage
constexpr int kPad = kWords + 1;
constexpr int kMinPool = 8;
constexpr int kMaxSlots = kBN / kMinPool;   // pools per tile when pool < 128

__device__ __forceinline__ int pack_pool_bits(float a, float rm, float bias,
                                              long long row, int pool) {
  const float s = __fmaf_rn(a, rm, bias);
  return (__float_as_int(s) & ~(pool - 1)) |
         static_cast<int>(row & (pool - 1));
}

// Per-block running maxima of the packed bits. A block owns a span of
// max(pool, 128) consecutive rows: either one pool walked in 128-row
// tiles (pool >= 128: one slot per query, the thread's running max is
// kept in registers and folded in once at the end), or 128 / pool whole
// pools of one tile (pool < 128: one slot per pool).
template <int kTQ>
struct PoolMax {
  int* best;                 // shared [kTQ * kTY][kMaxSlots]
  int pool;
  int reg[kTQ];

  __device__ void init(int* smem, int pool_) {
    best = smem;
    pool = pool_;
    for (int i = threadIdx.x; i < kTQ * kTY * kMaxSlots; i += kThreads) {
      best[i] = INT_MIN;
    }
#pragma unroll
    for (int i = 0; i < kTQ; ++i) reg[i] = INT_MIN;
  }

  // bits of (query slot i, row n_local within the span)
  __device__ __forceinline__ void add(int i, int n_local, int bits) {
    if (pool >= kBN) {
      reg[i] = max(reg[i], bits);
    } else {
      const int ty = threadIdx.x / kTX;
      atomicMax(&best[(ty + kTY * i) * kMaxSlots + n_local / pool], bits);
    }
  }

  // write the span's pools: out [Q, N / pool]
  __device__ void store(int32_t* out, int q0, int nq, long long span0,
                        long long n_pools) {
    const int ty = threadIdx.x / kTX;
    if (pool >= kBN) {
#pragma unroll
      for (int i = 0; i < kTQ; ++i) {
        atomicMax(&best[(ty + kTY * i) * kMaxSlots], reg[i]);
      }
    }
    __syncthreads();
    const int slots = pool >= kBN ? 1 : kBN / pool;
    const long long p0 = span0 / pool;
    for (int idx = threadIdx.x; idx < kTQ * kTY * slots; idx += kThreads) {
      const int qi = idx / slots;
      const int sl = idx % slots;
      if (qi < nq && p0 + sl < n_pools) {
        out[static_cast<long long>(q0 + qi) * n_pools + p0 + sl] =
            best[qi * kMaxSlots + sl];
      }
    }
  }
};

}  // namespace neumann
