// Product-quantization ADC scan: asymmetric distances from per-query
// lookup tables.
//
// Replaces the XLA-fused ADC scan of the JAX package (`_adc_search_fn`,
// neumann_tpu/ops/pq.py, and the `pq` storage of IVFIndex.search,
// neumann_tpu/ops/ivf.py): out[q, c] = -sum_m T[q, m, codes[row, m]] for
// the row of column c, -inf where the row is dead. Selection stays with
// the caller (ops/scan._topk), so the [Q, C] scores are in device memory.
//
// Two modes, one kernel:
//   * full scan: column c is row c of the [N, M] code matrix (pq_topk);
//   * gathered: column c of query q is row cand[q, c] (-1: no row), each
//     query scoring its own candidates (the probed lists of IVFIndex).
//
// The design is the simple one: a block scores one query against 2,048
// rows (or candidates), the query's table in shared memory, kChunk
// subspaces (48 KB) at a time, so any M runs (a 3,072-d codebook's M = 384
// is a 384 KB table); each thread owns kRowsPerThread rows (consecutive
// threads, consecutive rows) and carries their sums in registers across
// the chunks. Every sum is taken in subspace order m = 0 .. M-1 in f32 with
// no other arithmetic, so the kernel equals pq_adc_scores_plain
// (ops/kernels.py) bit for bit.
//
// Block order: the grid is one-dimensional and walks groups of kGroup
// queries, row block by row block, so the blocks in flight at once share
// a few row blocks' codes and a few queries' tables in L2 (query-major
// order would stream the whole code matrix from HBM once per query).
//
// Codes are read 16 bytes a load where M % 16 == 0 (M 96 and 384; 4 or 1
// bytes otherwise): a lane reads its own row, and narrow loads pulled a
// 32-byte sector through L1 for every 4 bytes used.
//
// What it leaves on the table (recorded, not fixed): each block still
// reads its rows' codes and its query's table itself (one pass over the
// codes for several queries a block would do), the table lookups hit
// random banks (3-4-way conflicts), and the scores go to device memory
// before selection.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 8;
constexpr int kChunk = 48;
constexpr int kCentroids = 256;
constexpr int kGroup = 16;

// a += the 4 table entries one code word selects (bytes in subspace order)
__device__ __forceinline__ float add_word(float a, const float* t,
                                          uint32_t w) {
  a += t[w & 0xFF];
  a += t[kCentroids + ((w >> 8) & 0xFF)];
  a += t[2 * kCentroids + ((w >> 16) & 0xFF)];
  a += t[3 * kCentroids + (w >> 24)];
  return a;
}

// kVec: bytes of codes a load (16, 4 or 1). A lane reads its own row, so
// lanes of a warp touch 32 rows at once: 16-byte loads use half of each
// 32-byte sector they pull through L1, byte loads 1/32 of it.
template <bool kGathered, int kVec>
__global__ void __launch_bounds__(kThreads)
    pq_adc_kernel(const uint8_t* __restrict__ codes,
                  const float* __restrict__ tables,
                  const uint8_t* __restrict__ valid,
                  const int32_t* __restrict__ cand, float* __restrict__ out,
                  long long n_rows, long long n_cols, int n_q, int m,
                  long long row_blocks) {
  __shared__ __align__(16) float tab[kChunk * kCentroids];
  // block -> (query, row block): kGroup queries at a time, row block by
  // row block within a group (the last group may hold fewer queries)
  const long long lin = blockIdx.x;
  const long long full = static_cast<long long>(kGroup) * row_blocks;
  const long long group = lin / full;
  const int q0 = static_cast<int>(group) * kGroup;
  const int gq = min(kGroup, n_q - q0);
  const long long within = lin - group * full;
  const int q = q0 + static_cast<int>(within % gq);
  const long long rb = within / gq;
  const long long c0 = rb * kThreads * kRowsPerThread + threadIdx.x;
  long long row[kRowsPerThread];
  bool live[kRowsPerThread];
  float acc[kRowsPerThread];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const long long c = c0 + static_cast<long long>(r) * kThreads;
    long long rr = -1;
    if (c < n_cols) {
      rr = kGathered ? static_cast<long long>(cand[q * n_cols + c]) : c;
    }
    live[r] = rr >= 0 && rr < n_rows && valid[rr] != 0;
    row[r] = live[r] ? rr : 0;
    acc[r] = 0.0f;
  }
  const float4* tq = reinterpret_cast<const float4*>(
      tables + static_cast<long long>(q) * m * kCentroids);
  for (int m0 = 0; m0 < m; m0 += kChunk) {
    const int mc = min(kChunk, m - m0);
    __syncthreads();
    float4* t4 = reinterpret_cast<float4*>(tab);
    for (int i = threadIdx.x; i < mc * kCentroids / 4; i += kThreads) {
      t4[i] = tq[m0 * kCentroids / 4 + i];
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      if (!live[r]) continue;
      const uint8_t* cr = codes + row[r] * m + m0;
      float a = acc[r];
      if (kVec == 16) {
        const uint4* cv = reinterpret_cast<const uint4*>(cr);
        for (int j = 0; j < mc / 16; ++j) {
          const uint4 v = __ldg(cv + j);
          const float* t = tab + 16 * j * kCentroids;
          a = add_word(a, t, v.x);
          a = add_word(a, t + 4 * kCentroids, v.y);
          a = add_word(a, t + 8 * kCentroids, v.z);
          a = add_word(a, t + 12 * kCentroids, v.w);
        }
      } else if (kVec == 4) {
        const uint32_t* cw = reinterpret_cast<const uint32_t*>(cr);
        for (int j = 0; j < mc / 4; ++j) {
          a = add_word(a, tab + 4 * j * kCentroids, __ldg(cw + j));
        }
      } else {
        for (int j = 0; j < mc; ++j) {
          a += tab[j * kCentroids + __ldg(cr + j)];
        }
      }
      acc[r] = a;
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const long long c = c0 + static_cast<long long>(r) * kThreads;
    if (c < n_cols) {
      out[q * n_cols + c] = live[r] ? -acc[r] : -INFINITY;
    }
  }
}

template <bool kGathered>
int launch(const void* codes, const void* tables, const void* valid,
           const void* cand, void* out, long long n_rows, long long n_cols,
           int n_q, int m, cudaStream_t s) {
  const long long per_block = static_cast<long long>(kThreads) *
                              kRowsPerThread;
  const long long row_blocks = (n_cols + per_block - 1) / per_block;
  const dim3 grid(static_cast<unsigned>(row_blocks * n_q));
  const auto* c = static_cast<const uint8_t*>(codes);
  const auto* t = static_cast<const float*>(tables);
  const auto* v = static_cast<const uint8_t*>(valid);
  const auto* k = static_cast<const int32_t*>(cand);
  auto* o = static_cast<float*>(out);
  // wide code loads need every row (and chunk: kChunk is a multiple of
  // 16) to start on the load's width
  const uintptr_t base = reinterpret_cast<uintptr_t>(codes);
  if (m % 16 == 0 && base % 16 == 0) {
    pq_adc_kernel<kGathered, 16>
        <<<grid, kThreads, 0, s>>>(c, t, v, k, o, n_rows, n_cols, n_q, m,
                                   row_blocks);
  } else if (m % 4 == 0 && base % 4 == 0) {
    pq_adc_kernel<kGathered, 4>
        <<<grid, kThreads, 0, s>>>(c, t, v, k, o, n_rows, n_cols, n_q, m,
                                   row_blocks);
  } else {
    pq_adc_kernel<kGathered, 1>
        <<<grid, kThreads, 0, s>>>(c, t, v, k, o, n_rows, n_cols, n_q, m,
                                   row_blocks);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// codes [n_rows, m] uint8, tables [n_q, m, 256] f32 (16-byte aligned),
// valid [n_rows] bool, out [n_q, n_cols] f32. cand == nullptr: the full
// scan (n_cols == n_rows); else cand [n_q, n_cols] int32 row ids.
extern "C" int neumann_pq_adc_scores(const void* codes, const void* tables,
                                     const void* valid, const void* cand,
                                     void* out, long long n_rows,
                                     long long n_cols, int n_q, int m,
                                     void* stream) {
  const long long per_block = static_cast<long long>(kThreads) *
                              kRowsPerThread;
  if (n_q < 1 || n_q > 65535 || m < 1 || n_cols < 1 ||
      (cand == nullptr && n_cols != n_rows) ||
      (n_cols + per_block - 1) / per_block * n_q > 0x7FFFFFFFLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return cand == nullptr
             ? launch<false>(codes, tables, valid, cand, out, n_rows, n_cols,
                             n_q, m, s)
             : launch<true>(codes, tables, valid, cand, out, n_rows, n_cols,
                            n_q, m, s);
}
