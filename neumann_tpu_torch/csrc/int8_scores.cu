// int8 x int8 corpus scores, two epilogues on one tiled __dp4a loop.
//
// * neumann_int8_dot_scores replaces the Pallas TPU kernel `_int8_kernel`
//   (launched by `int8_dot_scores`, neumann_tpu/ops/pallas_kernels.py):
//     out[q, n] = (float(dot(qq[q], cq[n])) * q_mult[q]) * row_mult[n]
//   as [Q, N] f32, two roundings, as the Pallas kernel and XLA compute
//   it. It is the int8 scan's block scorer (`_int8_block_scores` of
//   neumann_tpu/ops/quant.py for cosine and dot; euclidean is an
//   epilogue on its output in ops/quant.py).
// * neumann_int8_pooled_bits replaces the XLA-fused pooled-bits step of
//   `int8_pooled_topk` (neumann_tpu/ops/quant.py:371-385): the same dots,
//   then the pack / per-pool max epilogue of csrc/pooled_bits.cuh, giving
//   [Q, N / pool] int32 winner bits. Scores never reach device memory.
//
// The dots are exact int32 sums (|dot| <= 127^2 d), so both outputs are
// bit-identical to the reference whatever the summation order.
//
// What bounds it on an H100: int8 multiply-adds. At Q = 1,024 against
// 1,048,576 x 768 rows the pooled scan is 8.1e11 MACs over 0.8 GB of
// corpus, about 1,000 operations per byte, far above what HBM limits; with
// __dp4a (4 MACs per lane per instruction, no tensor cores) the integer
// pipe is the limit. The design keeps that pipe fed: a block computes a
// (16 * kTQ) x 128 tile, each thread a kTQ x 8 register tile, so every
// 12 shared-memory loads (kTQ = 4) feed 32 __dp4a; one staged 64-byte slice
// of a corpus row serves all the block's queries. Small batches take
// kTQ = 1 (16-query tiles), so a single query does not pay for 64.
// No tensor cores (mma.sync s8 / wgmma), no TMA: a simple kernel that is
// right comes first.

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

// acc[i][j] = dot(qq[q0 + ty + 16 i], cq[n0 + tx + 16 j]) over all d;
// rows past n_rows and queries past n_q read as zero.
template <int kTQ>
__device__ __forceinline__ void int8_tile_dots(
    const int8_t* __restrict__ qq, const int8_t* __restrict__ cq, int n_q,
    long long n_rows, int d, int q0, long long n0, int (*a_s)[kPad],
    int (*b_s)[kPad], int acc[kTQ][kRowsPerThread]) {
  const int tx = threadIdx.x % kTX;
  const int ty = threadIdx.x / kTX;
#pragma unroll
  for (int i = 0; i < kTQ; ++i) {
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) acc[i][j] = 0;
  }
  const int4 zero = make_int4(0, 0, 0, 0);
  for (int k0 = 0; k0 < d; k0 += 4 * kWords) {
    // stage 64 bytes of each query and row, as 16-byte loads
    for (int idx = threadIdx.x; idx < kTQ * kTY * 4; idx += kThreads) {
      const int r = idx / 4;
      const int c = idx % 4;
      const int q = q0 + r;
      const int4 v = q < n_q ? *reinterpret_cast<const int4*>(
                                   qq + static_cast<long long>(q) * d + k0 +
                                   16 * c)
                             : zero;
      a_s[r][4 * c] = v.x;
      a_s[r][4 * c + 1] = v.y;
      a_s[r][4 * c + 2] = v.z;
      a_s[r][4 * c + 3] = v.w;
    }
    for (int idx = threadIdx.x; idx < kBN * 4; idx += kThreads) {
      const int r = idx / 4;
      const int c = idx % 4;
      const long long n = n0 + r;
      const int4 v = n < n_rows
                         ? *reinterpret_cast<const int4*>(cq + n * d + k0 +
                                                          16 * c)
                         : zero;
      b_s[r][4 * c] = v.x;
      b_s[r][4 * c + 1] = v.y;
      b_s[r][4 * c + 2] = v.z;
      b_s[r][4 * c + 3] = v.w;
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      int a[kTQ];
      int b[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kTQ; ++i) a[i] = a_s[ty + kTY * i][w];
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) b[j] = b_s[tx + kTX * j][w];
#pragma unroll
      for (int i = 0; i < kTQ; ++i) {
#pragma unroll
        for (int j = 0; j < kRowsPerThread; ++j) {
          acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
        }
      }
    }
    __syncthreads();
  }
}

template <int kTQ>
__global__ void __launch_bounds__(kThreads) int8_dot_scores_kernel(
    const int8_t* __restrict__ qq, const int8_t* __restrict__ cq,
    const float* __restrict__ q_mult, const float* __restrict__ row_mult,
    float* __restrict__ out, int n_q, long long n_rows, int d) {
  __shared__ int a_s[kTQ * kTY][kPad];
  __shared__ int b_s[kBN][kPad];
  const int q0 = blockIdx.y * kTQ * kTY;
  const long long n0 = static_cast<long long>(blockIdx.x) * kBN;
  int acc[kTQ][kRowsPerThread];
  int8_tile_dots<kTQ>(qq, cq, n_q, n_rows, d, q0, n0, a_s, b_s, acc);
  const int tx = threadIdx.x % kTX;
  const int ty = threadIdx.x / kTX;
#pragma unroll
  for (int i = 0; i < kTQ; ++i) {
    const int q = q0 + ty + kTY * i;
    if (q >= n_q) continue;
    const float qm = q_mult[q];
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      const long long n = n0 + tx + kTX * j;
      if (n < n_rows) {
        out[static_cast<long long>(q) * n_rows + n] =
            __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j]), qm), row_mult[n]);
      }
    }
  }
}

template <int kTQ>
__global__ void __launch_bounds__(kThreads) int8_pooled_bits_kernel(
    const int8_t* __restrict__ qq, const int8_t* __restrict__ cq,
    const float* __restrict__ q_mult, const float* __restrict__ row_mult,
    const float* __restrict__ bias, int32_t* __restrict__ out, int n_q,
    long long n_rows, int d, int pool) {
  __shared__ int a_s[kTQ * kTY][kPad];
  __shared__ int b_s[kBN][kPad];
  __shared__ int best_s[kTQ * kTY * kMaxSlots];
  const int q0 = blockIdx.y * kTQ * kTY;
  const int span = max(pool, kBN);
  const long long span0 = static_cast<long long>(blockIdx.x) * span;
  const long long span1 = min(span0 + span, n_rows);
  const int tx = threadIdx.x % kTX;
  const int ty = threadIdx.x / kTX;
  neumann::PoolMax<kTQ> pm;
  pm.init(best_s, pool);
  float qm[kTQ];
#pragma unroll
  for (int i = 0; i < kTQ; ++i) {
    const int q = q0 + ty + kTY * i;
    qm[i] = q < n_q ? q_mult[q] : 0.f;
  }
  for (long long n0 = span0; n0 < span1; n0 += kBN) {
    int acc[kTQ][kRowsPerThread];
    int8_tile_dots<kTQ>(qq, cq, n_q, span1, d, q0, n0, a_s, b_s, acc);
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      const long long n = n0 + tx + kTX * j;
      if (n >= span1) continue;
      const float rm = row_mult[n];
      const float bi = bias[n];
#pragma unroll
      for (int i = 0; i < kTQ; ++i) {
        const float a = __fmul_rn(__int2float_rn(acc[i][j]), qm[i]);
        pm.add(i, static_cast<int>(n - span0),
               neumann::pack_pool_bits(a, rm, bi, n, pool));
      }
    }
  }
  const int nq = min(kTQ * kTY, n_q - q0);
  pm.store(out, q0, nq, span0, n_rows / pool);
}

template <int kTQ>
void launch_dots(const void* qq, const void* cq, const void* q_mult,
                 const void* row_mult, void* out, int n_q, long long n_rows,
                 int d, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((n_rows + kBN - 1) / kBN),
                  static_cast<unsigned>((n_q + kTQ * kTY - 1) / (kTQ * kTY)));
  int8_dot_scores_kernel<kTQ><<<grid, kThreads, 0, stream>>>(
      static_cast<const int8_t*>(qq), static_cast<const int8_t*>(cq),
      static_cast<const float*>(q_mult), static_cast<const float*>(row_mult),
      static_cast<float*>(out), n_q, n_rows, d);
}

template <int kTQ>
void launch_pooled(const void* qq, const void* cq, const void* q_mult,
                   const void* row_mult, const void* bias, void* out, int n_q,
                   long long n_rows, int d, int pool, cudaStream_t stream) {
  const long long span = pool > kBN ? pool : kBN;
  const dim3 grid(static_cast<unsigned>((n_rows + span - 1) / span),
                  static_cast<unsigned>((n_q + kTQ * kTY - 1) / (kTQ * kTY)));
  int8_pooled_bits_kernel<kTQ><<<grid, kThreads, 0, stream>>>(
      static_cast<const int8_t*>(qq), static_cast<const int8_t*>(cq),
      static_cast<const float*>(q_mult), static_cast<const float*>(row_mult),
      static_cast<const float*>(bias), static_cast<int32_t*>(out), n_q,
      n_rows, d, pool);
}

}  // namespace

// qq [Q, d] int8, cq [N, d] int8, q_mult [Q] f32, row_mult [N] f32 ->
// out [Q, N] f32. d % 64 == 0, pointers 16-byte aligned, Q <= 65535 * 16
// (the wrapper checks). Returns cudaGetLastError() after the launch.
extern "C" int neumann_int8_dot_scores(const void* qq, const void* cq,
                                       const void* q_mult,
                                       const void* row_mult, void* out,
                                       int n_q, long long n_rows, int d,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_q <= 16) {
    launch_dots<1>(qq, cq, q_mult, row_mult, out, n_q, n_rows, d, s);
  } else {
    launch_dots<4>(qq, cq, q_mult, row_mult, out, n_q, n_rows, d, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// qq [Q, d] int8, cq [N, d] int8, q_mult [Q] f32, row_mult [N] f32,
// bias [N] f32 (2.0 live, -1e30 dead) -> out [Q, N / pool] int32 winner
// bits. pool a power of two in [8, 4096] dividing N, d % 64 == 0,
// pointers 16-byte aligned (the wrapper checks).
extern "C" int neumann_int8_pooled_bits(const void* qq, const void* cq,
                                        const void* q_mult,
                                        const void* row_mult,
                                        const void* bias, void* out, int n_q,
                                        long long n_rows, int d, int pool,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_q <= 16) {
    launch_pooled<1>(qq, cq, q_mult, row_mult, bias, out, n_q, n_rows, d,
                     pool, s);
  } else {
    launch_pooled<4>(qq, cq, q_mult, row_mult, bias, out, n_q, n_rows, d,
                     pool, s);
  }
  return static_cast<int>(cudaGetLastError());
}
