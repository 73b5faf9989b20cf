// IVF probe scoring: one query against its probed windows of an int8
// corpus.
//
// Replaces the Pallas TPU kernel `_ivf_probe_kernel`, launched through
// `_probe_scores_one` / `ivf_probe_scores_pallas` /
// `ivf_windowed_topk_pallas` in neumann_tpu/ops/pallas_kernels.py. Same
// function: for every probed 128-row block, bf16(query) . int8(row) with
// f32 accumulation, times the row's cosine multiplier `rm`, and -inf
// where rm <= 0. int8 values are exact in bf16, so the product is the
// f32 dot of the bf16-rounded query with the row.
//
// What bounds it on an H100: bytes. Each query reads nprobe x window x d
// int8 bytes (81 x 1024 x 768 ~= 64 MB at the 4M x 768 slice), and does
// one FMA per byte, far below the card's FLOP roof. The design streams
// the int8 rows once with 16-byte loads, and keeps everything else off
// device memory:
//   * one block per (query, probe, 128-row block) — the Pallas kernel
//     unrolled queries at trace time; here the query is a grid axis;
//   * the bf16-rounded query sits in shared memory, chunk-padded (17
//     floats per 16-byte chunk) so a warp's 32 lanes read 32 different
//     banks;
//   * each warp computes whole rows: lane l loads 16-byte chunks l,
//     l + 32, ... of the row (coalesced), accumulates 16 FMAs per chunk,
//     and a shuffle reduction finishes the dot;
//   * one multiply by rm, -inf where rm <= 0, one f32 store per row.
// No tensor cores, no TMA: a simple kernel that is right comes first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int kRows = 128;              // rows per block (the Pallas block)
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 16;              // int8 bytes per lane load
constexpr int kPad = kChunk + 1;        // floats per chunk in shared memory

__global__ void __launch_bounds__(kThreads) ivf_probe_kernel(
    const int8_t* __restrict__ buf, const float* __restrict__ rmult,
    const int32_t* __restrict__ start_blocks,
    const float* __restrict__ queries, float* __restrict__ out,
    long long n_rows, int d, int nprobe, int window) {
  extern __shared__ float q_s[];        // (d / 16) * 17 floats
  const int jb = blockIdx.x;            // 128-row block within the window
  const int p = blockIdx.y;             // probe rank
  const int qi = blockIdx.z;            // query
  const int nch = d / kChunk;

  const float* qrow = queries + static_cast<long long>(qi) * d;
  for (int e = threadIdx.x; e < d; e += kThreads) {
    q_s[(e / kChunk) * kPad + (e % kChunk)] =
        __bfloat162float(__float2bfloat16_rn(qrow[e]));
  }
  __syncthreads();

  const long long row0 =
      static_cast<long long>(
          start_blocks[static_cast<long long>(qi) * nprobe + p] + jb) *
      kRows;
  float* orow = out + (static_cast<long long>(qi) * nprobe + p) * window +
                static_cast<long long>(jb) * kRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  for (int r = warp; r < kRows; r += kWarps) {
    const long long row = row0 + r;
    const bool in_range = row >= 0 && row < n_rows;
    float acc = 0.f;
    if (in_range) {
      const int4* src = reinterpret_cast<const int4*>(buf + row * d);
      for (int c = lane; c < nch; c += 32) {
        const int4 v = src[c];
        const float* qc = q_s + c * kPad;
        const int words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            // sign-extend byte b of the word
            const int x = static_cast<int>(
                              static_cast<unsigned>(words[i]) << (24 - 8 * b)) >>
                          24;
            acc = fmaf(static_cast<float>(x), qc[i * 4 + b], acc);
          }
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    }
    if (lane == 0) {
      const float rm = in_range ? rmult[row] : 0.f;
      orow[r] = rm > 0.f ? acc * rm : -CUDART_INF_F;
    }
  }
}

}  // namespace

// buf [n_rows, d] int8, rmult [n_rows] f32, start_blocks [q, nprobe]
// int32 (window start / 128), queries [q, d] f32 -> out
// [q, nprobe * window] f32. d % 16 == 0, window % 128 == 0, all
// pointers 16-byte aligned (the wrapper checks). Returns
// cudaGetLastError() after the launch.
extern "C" int neumann_ivf_probe_scores(
    const void* buf, const void* rmult, const void* start_blocks,
    const void* queries, void* out, long long n_rows, int d, int q,
    int nprobe, int window, void* stream) {
  const dim3 grid(window / kRows, nprobe, q);
  const size_t smem = static_cast<size_t>(d / kChunk) * kPad * sizeof(float);
  ivf_probe_kernel<<<grid, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(buf), static_cast<const float*>(rmult),
      static_cast<const int32_t*>(start_blocks),
      static_cast<const float*>(queries), static_cast<float*>(out), n_rows,
      d, nprobe, window);
  return static_cast<int>(cudaGetLastError());
}
