// f32 pooled-bits scan: cosine winner bits of an f32 corpus.
//
// Replaces the XLA-fused pooled-bits step of `f32_pooled_topk`
// (neumann_tpu/ops/quant.py:525-539), which has no Pallas kernel on the
// TPU but would write the whole [Q, N] score matrix to device memory as
// a PyTorch matmul followed by a reduction. For query q and row n:
//   dot  = sum_k x[q, k] * c[n, k]      full f32: one FFMA per term, no
//                                       TF32, as the JAX package computes
//                                       it on the CPU (the sum runs in
//                                       another order, so dots may differ
//                                       in the last bits)
// then the pack / per-pool max epilogue of csrc/pooled_bits.cuh with
// a = dot * qmult[q], giving [Q, N / pool] int32 winner bits. Scores never
// reach device memory.
//
// What bounds it on an H100: f32 FMAs. At Q = 1,024 against 1,048,576 x
// 768 rows the scan is 8.1e11 FMAs over 3.2 GB of corpus (250 FLOP per
// byte), above the card's f32 balance point (67 TFLOP/s over 3.35 TB/s,
// 20 FLOP/byte), so the FMA pipe and the shared-memory loads that feed it
// are the limit. The design is the int8 kernel's tiling with floats: a
// (16 * kTQ) x 128 tile per block, a kTQ x 8 register tile per thread,
// 16 floats of K staged per step; each staged 64-byte slice of a row
// serves every query of the block. At Q = 8 the corpus read (3.2 GB) is
// the floor instead; small batches take kTQ = 1. No tensor cores (TF32
// would change the numbers), no TMA: a simple kernel that is right
// comes first.

#include <cuda_runtime.h>

#include <cstdint>

#include "pooled_bits.cuh"

namespace {

using neumann::kBN;
using neumann::kMaxSlots;
using neumann::kPad;
using neumann::kRowsPerThread;
using neumann::kThreads;
using neumann::kTX;
using neumann::kTY;
using neumann::kWords;

template <int kTQ>
__global__ void __launch_bounds__(kThreads) f32_pooled_bits_kernel(
    const float* __restrict__ x, const float* __restrict__ c,
    const float* __restrict__ q_mult, const float* __restrict__ row_mult,
    const float* __restrict__ bias, int32_t* __restrict__ out, int n_q,
    long long n_rows, int d, int pool) {
  __shared__ float a_s[kTQ * kTY][kPad];
  __shared__ float b_s[kBN][kPad];
  __shared__ int best_s[kTQ * kTY * kMaxSlots];
  const int q0 = blockIdx.y * kTQ * kTY;
  const int span = max(pool, kBN);
  const long long span0 = static_cast<long long>(blockIdx.x) * span;
  const long long span1 = min(span0 + span, n_rows);
  const int tx = threadIdx.x % kTX;
  const int ty = threadIdx.x / kTX;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  neumann::PoolMax<kTQ> pm;
  pm.init(best_s, pool);
  float qm[kTQ];
#pragma unroll
  for (int i = 0; i < kTQ; ++i) {
    const int q = q0 + ty + kTY * i;
    qm[i] = q < n_q ? q_mult[q] : 0.f;
  }
  for (long long n0 = span0; n0 < span1; n0 += kBN) {
    float acc[kTQ][kRowsPerThread];
#pragma unroll
    for (int i = 0; i < kTQ; ++i) {
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) acc[i][j] = 0.f;
    }
    for (int k0 = 0; k0 < d; k0 += kWords) {
      for (int idx = threadIdx.x; idx < kTQ * kTY * 4; idx += kThreads) {
        const int r = idx / 4;
        const int cc = idx % 4;
        const int q = q0 + r;
        const float4 v =
            q < n_q ? *reinterpret_cast<const float4*>(
                          x + static_cast<long long>(q) * d + k0 + 4 * cc)
                    : zero;
        a_s[r][4 * cc] = v.x;
        a_s[r][4 * cc + 1] = v.y;
        a_s[r][4 * cc + 2] = v.z;
        a_s[r][4 * cc + 3] = v.w;
      }
      for (int idx = threadIdx.x; idx < kBN * 4; idx += kThreads) {
        const int r = idx / 4;
        const int cc = idx % 4;
        const long long n = n0 + r;
        const float4 v = n < span1 ? *reinterpret_cast<const float4*>(
                                         c + n * d + k0 + 4 * cc)
                                   : zero;
        b_s[r][4 * cc] = v.x;
        b_s[r][4 * cc + 1] = v.y;
        b_s[r][4 * cc + 2] = v.z;
        b_s[r][4 * cc + 3] = v.w;
      }
      __syncthreads();
#pragma unroll
      for (int w = 0; w < kWords; ++w) {
        float a[kTQ];
        float b[kRowsPerThread];
#pragma unroll
        for (int i = 0; i < kTQ; ++i) a[i] = a_s[ty + kTY * i][w];
#pragma unroll
        for (int j = 0; j < kRowsPerThread; ++j) b[j] = b_s[tx + kTX * j][w];
#pragma unroll
        for (int i = 0; i < kTQ; ++i) {
#pragma unroll
          for (int j = 0; j < kRowsPerThread; ++j) {
            acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
          }
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      const long long n = n0 + tx + kTX * j;
      if (n >= span1) continue;
      const float rm = row_mult[n];
      const float bi = bias[n];
#pragma unroll
      for (int i = 0; i < kTQ; ++i) {
        pm.add(i, static_cast<int>(n - span0),
               neumann::pack_pool_bits(__fmul_rn(acc[i][j], qm[i]), rm, bi,
                                       n, pool));
      }
    }
  }
  const int nq = min(kTQ * kTY, n_q - q0);
  pm.store(out, q0, nq, span0, n_rows / pool);
}

template <int kTQ>
void launch(const void* x, const void* c, const void* q_mult,
            const void* row_mult, const void* bias, void* out, int n_q,
            long long n_rows, int d, int pool, cudaStream_t stream) {
  const long long span = pool > kBN ? pool : kBN;
  const dim3 grid(static_cast<unsigned>((n_rows + span - 1) / span),
                  static_cast<unsigned>((n_q + kTQ * kTY - 1) / (kTQ * kTY)));
  f32_pooled_bits_kernel<kTQ><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(c),
      static_cast<const float*>(q_mult), static_cast<const float*>(row_mult),
      static_cast<const float*>(bias), static_cast<int32_t*>(out), n_q,
      n_rows, d, pool);
}

}  // namespace

// x [Q, d] f32 queries, c [N, d] f32 corpus, q_mult [Q] f32, row_mult
// [N] f32, bias [N] f32 (2.0 live, -1e30 dead) -> out [Q, N / pool]
// int32 winner bits. pool a power of two in [8, 4096] dividing N,
// d % 16 == 0, pointers 16-byte aligned (the wrapper checks). Returns
// cudaGetLastError() after the launch.
extern "C" int neumann_f32_pooled_bits(const void* x, const void* c,
                                       const void* q_mult,
                                       const void* row_mult,
                                       const void* bias, void* out, int n_q,
                                       long long n_rows, int d, int pool,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_q <= 16) {
    launch<1>(x, c, q_mult, row_mult, bias, out, n_q, n_rows, d, pool, s);
  } else {
    launch<4>(x, c, q_mult, row_mult, bias, out, n_q, n_rows, d, pool, s);
  }
  return static_cast<int>(cudaGetLastError());
}
