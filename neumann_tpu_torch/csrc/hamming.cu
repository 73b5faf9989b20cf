// Hamming distances between packed sign bits.
//
// Replaces the Pallas TPU kernel `_hamming_kernel` (launched by
// `hamming_scores` and `hamming_topk_pallas`, neumann_tpu/ops/
// pallas_kernels.py): out[q, n] = sum_w popcount(corpus[n, w] ^
// queries[q, w]) as [Q, N] int32, exact.
//
// The TPU kernel needed the corpus transposed to word-major (one extra
// pass over it) because Mosaic rejects 1-wide column loads. Here the
// corpus is read row-major as it is stored: each thread owns one corpus
// row and loads it once, with 16-byte loads, into registers (up to 64
// words, d <= 2048); the block's queries are staged in shared memory and
// read as broadcasts (every lane of a warp reads the same word), and the
// 256 threads of a block write 256 consecutive distances of a query row.
//
// What bounds it on an H100: at Q = 1,024 against 131,072 rows of 24
// words, 3.2e9 XOR + popcount + add per word against 12.6 MB of corpus,
// the popcount pipe and the 0.54 GB [Q, N] int32 output write. The corpus
// is re-read by each of the Q / 64 query groups, from L2 (it fits).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;      // corpus rows per block
constexpr int kQStage = 32;        // queries staged per shared-memory pass
constexpr int kQBlock = 64;        // queries per block (two passes)
constexpr int kMaxChunks = 16;     // 16-byte chunks per row: W <= 64 words

__global__ void __launch_bounds__(kThreads) hamming_kernel(
    const int32_t* __restrict__ corpus, const int32_t* __restrict__ queries,
    int32_t* __restrict__ out, long long n_rows, int n_q, int w) {
  __shared__ int4 q_s[kQStage * kMaxChunks];
  const long long n = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  const int nch = w / 4;
  int4 r[kMaxChunks];
  const int4* src = reinterpret_cast<const int4*>(corpus + n * w);
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    r[c] = (c < nch && n < n_rows) ? src[c] : make_int4(0, 0, 0, 0);
  }
  const int qb = blockIdx.y * kQBlock;
  const int qe = min(qb + kQBlock, n_q);
  for (int s0 = qb; s0 < qe; s0 += kQStage) {
    const int ns = min(kQStage, qe - s0);
    __syncthreads();
    const int4* qsrc = reinterpret_cast<const int4*>(
        queries + static_cast<long long>(s0) * w);
    for (int i = threadIdx.x; i < ns * nch; i += kThreads) {
      q_s[(i / nch) * kMaxChunks + i % nch] = qsrc[i];
    }
    __syncthreads();
    if (n >= n_rows) continue;
    for (int qi = 0; qi < ns; ++qi) {
      const int4* qv = q_s + qi * kMaxChunks;
      int dist = 0;
#pragma unroll
      for (int c = 0; c < kMaxChunks; ++c) {
        if (c < nch) {
          const int4 b = qv[c];
          dist += __popc(r[c].x ^ b.x) + __popc(r[c].y ^ b.y) +
                  __popc(r[c].z ^ b.z) + __popc(r[c].w ^ b.w);
        }
      }
      out[static_cast<long long>(s0 + qi) * n_rows + n] = dist;
    }
  }
}

}  // namespace

// corpus [N, W] int32 bit patterns, queries [Q, W] int32 -> out [Q, N]
// int32 distances. W % 4 == 0 and W <= 64, pointers 16-byte aligned
// (the wrapper checks). Returns cudaGetLastError() after the launch.
extern "C" int neumann_hamming_scores(const void* corpus, const void* queries,
                                      void* out, long long n_rows, int n_q,
                                      int w, void* stream) {
  const dim3 grid(static_cast<unsigned>((n_rows + kThreads - 1) / kThreads),
                  static_cast<unsigned>((n_q + kQBlock - 1) / kQBlock));
  hamming_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(corpus),
      static_cast<const int32_t*>(queries), static_cast<int32_t*>(out),
      n_rows, n_q, w);
  return static_cast<int>(cudaGetLastError());
}
