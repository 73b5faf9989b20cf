// Hamming distances between packed sign bits, on the 1-bit tensor cores.
//
// Replaces the Pallas TPU kernel `_hamming_kernel` (launched by
// `hamming_scores`, neumann_tpu/ops/pallas_kernels.py): out[q, n] =
// sum_w popcount(corpus[n, w] ^ queries[q, w]) as [Q, N] int32, exact, for
// any W % 4 == 0. The TPU kernel needed the corpus transposed to
// word-major (Mosaic rejects 1-wide column loads); here rows are read as
// stored.
//
// What bounds it on an H100: the output. At Q = 1,024 against 131,072
// rows of 24 words it writes 0.54 GB of int32, 0.164 ms at 3.35 TB/s; its
// 2 Q N d bit products take about 0.02 ms at the card's 1-bit tensor-core
// rate (chip_smoke.b1_ops_per_s), where an XOR + POPC loop is held at 0.77
// ms by the POPC issue rate. One query is bound by the corpus read (12.6
// MB, 3.8 us).
//
// The design:
//   * products on mma.sync.m16n8k256.b1.and.popc (csrc/mma_b1.cuh),
//     hamming = popc(r) + popc(q) - 2 popc(r AND q); words past W are zero
//     and add 0 to all three terms;
//   * a dispatch on Q, as the int8 kernels have. Up to 8 queries (one n8
//     tile, the route's single query) the corpus read is the bound: each
//     warp loads its own 32 rows straight into A fragments (8-byte loads,
//     3 K steps at a time) with no ring and no block barrier, so at
//     131,072 rows every load of the launch is in flight at once; the
//     warp stages its distances through its own shared rows and writes
//     each query's 128-byte line. Above 8 queries the batch kernel:
//   * corpus rows on M (8 warps x 16 rows = 128 rows a tile), the block's
//     up to 64 queries on N (only the n8 tiles holding a query run). A
//     block owns one query block and a span of row tiles and streams
//     (row tile, K chunk of up to 4 steps) through a 3-stage cp.async ring
//     that carries the chunk's corpus rows and query words (the queries
//     only once when one chunk is all of W, as at 24 words), so any W
//     runs in the same shared memory and the next tile's rows are in
//     flight during this tile's products and stores;
//   * shared memory holds each 256-bit step as [row][8 words], so the
//     8-byte fragment loads (words 8 s + 2 t.. of rows g and g + 8, or of
//     query g) fall in distinct banks; popc(r) is summed from the A
//     fragments themselves (the few-query kernel sums popc(q) from its B
//     fragments likewise), popc(q) once a block;
//   * the epilogue stages each tile's distances in shared memory
//     ([query][128 rows + 4]: the pad spreads a fragment's writes over all
//     banks) and writes each query's 512 bytes with 16-byte streaming
//     stores of consecutive lanes, full 128-byte lines (4-byte stores of
//     consecutive lanes when N % 4 != 0 leaves the rows unaligned).

#include <cuda_runtime.h>

#include <cstdint>

#include "mma_b1.cuh"
#include "pooled_bits.cuh"

namespace {

using neumann::cp_async16;
using neumann::cp_async_commit;
using neumann::cp_async_wait;
using neumann::mma_b1;

constexpr int kThreads = 256;     // 8 warps
constexpr int kMaxDevices = 64;
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ int popc4(const int4 v) {
  return __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
}

// ---------------------------------------------------------------------------
// up to 8 queries: one n8 tile; each warp loads its own groups of rows
// straight into fragments, with no shared-memory ring and no block barrier
// ---------------------------------------------------------------------------

constexpr int kFewQ = 8;
constexpr int kMT = 2;            // m16 tiles a warp's group of rows
constexpr int kGroup = 16 * kMT;  // rows a group: a 128-byte line a query
constexpr int kFewRound = 3;      // K steps of loads in flight at a time
constexpr int kFewBlocksPerSM = 4;

__global__ void __launch_bounds__(kThreads, kFewBlocksPerSM)
    hamming_few_kernel(const int32_t* __restrict__ corpus,
                       const int32_t* __restrict__ queries,
                       int32_t* __restrict__ out, long long n_rows, int n_q,
                       int words, int groups_per_warp) {
  constexpr int kStride = kGroup + 4;      // staged distances a query
  __shared__ __align__(16) int staged[kThreads / 32][kFewQ * kStride];
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int steps = (words + 7) / 8;
  int* stg = staged[threadIdx.x / 32];
  const long long n_groups = (n_rows + kGroup - 1) / kGroup;
  long long grp = (static_cast<long long>(blockIdx.x) * (kThreads / 32) +
                   threadIdx.x / 32) * groups_per_warp;
  const long long grp_end = min(grp + groups_per_warp, n_groups);
  const int32_t* qrow = queries + static_cast<long long>(g) * words;

  for (; grp < grp_end; ++grp) {
    const long long base = grp * kGroup;
    int acc[kMT][4] = {};
    int pa[kMT][2] = {};   // popc of rows g, g + 8 of each m tile
    int pq = 0;            // popc of query g (the B fragments' words)
    for (int s0 = 0; s0 < steps; s0 += kFewRound) {
      uint2 x[kMT][2][kFewRound];   // rows g, g + 8: words 8 s + 2 t..
#pragma unroll
      for (int s = 0; s < kFewRound; ++s) {
        const int w0 = 8 * (s0 + s) + 2 * t;   // past W: zero
#pragma unroll
        for (int i = 0; i < kMT; ++i) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const long long r = base + 16 * i + 8 * h + g;
            x[i][h][s] = r < n_rows && w0 < words
                             ? __ldg(reinterpret_cast<const uint2*>(
                                   corpus + r * words + w0))
                             : make_uint2(0u, 0u);
          }
        }
      }
#pragma unroll
      for (int s = 0; s < kFewRound; ++s) {
        if (s0 + s >= steps) break;
        const int w0 = 8 * (s0 + s) + 2 * t;
        const uint2 bq = g < n_q && w0 < words
                             ? __ldg(reinterpret_cast<const uint2*>(qrow + w0))
                             : make_uint2(0u, 0u);
        const unsigned b[2] = {bq.x, bq.y};
        pq += __popc(bq.x) + __popc(bq.y);
#pragma unroll
        for (int i = 0; i < kMT; ++i) {
          const unsigned a[4] = {x[i][0][s].x, x[i][1][s].x, x[i][0][s].y,
                                 x[i][1][s].y};
          pa[i][0] += __popc(a[0]) + __popc(a[2]);
          pa[i][1] += __popc(a[1]) + __popc(a[3]);
          mma_b1(acc[i], a, b);
        }
      }
    }
    // the group's distances through the warp's staging rows, then out;
    // popc of this lane's columns 2 t + e from the lanes of query 2 t + e
    pq += __shfl_xor_sync(kAll, pq, 1);
    pq += __shfl_xor_sync(kAll, pq, 2);
    const int pq_e[2] = {__shfl_sync(kAll, pq, 8 * t),
                         __shfl_sync(kAll, pq, 8 * t + 4)};
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        pa[i][h] += __shfl_xor_sync(kAll, pa[i][h], 1);
        pa[i][h] += __shfl_xor_sync(kAll, pa[i][h], 2);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          stg[(2 * t + e) * kStride + 16 * i + 8 * h + g] =
              pa[i][h] + pq_e[e] - 2 * acc[i][2 * h + e];
        }
      }
    }
    __syncwarp();
    int32_t* o = out + base;
    if ((n_rows & 3) == 0) {
      for (int i = lane; i < n_q * (kGroup / 4); i += 32) {
        const int qi = i / (kGroup / 4);
        const int v = 4 * (i % (kGroup / 4));
        if (base + v < n_rows) {
          __stcs(reinterpret_cast<int4*>(o + qi * n_rows + v),
                 *reinterpret_cast<const int4*>(stg + qi * kStride + v));
        }
      }
    } else {
      for (int i = lane; i < n_q * kGroup; i += 32) {
        const int qi = i / kGroup;
        const int v = i % kGroup;
        if (base + v < n_rows) __stcs(o + qi * n_rows + v, stg[qi * kStride + v]);
      }
    }
    __syncwarp();
  }
}

int launch_few(const void* corpus, const void* queries, void* out,
               long long n_rows, int n_q, int w, int sms,
               cudaStream_t stream) {
  // consecutive groups a warp, as few as keep kFewBlocksPerSM blocks a SM
  // busy: at 131,072 rows one group a warp, every load in flight at once
  constexpr int kWarps = kThreads / 32;
  const long long n_groups = (n_rows + kGroup - 1) / kGroup;
  const long long warps = 1LL * kFewBlocksPerSM * sms * kWarps;
  const long long per_warp = (n_groups + warps - 1) / warps;
  const long long blocks =
      (n_groups + per_warp * kWarps - 1) / (per_warp * kWarps);
  if (per_warp > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  hamming_few_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const int32_t*>(corpus),
      static_cast<const int32_t*>(queries), static_cast<int32_t*>(out),
      n_rows, n_q, w, static_cast<int>(per_warp));
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// more queries: 64 a block, the corpus through a shared-memory ring
// ---------------------------------------------------------------------------

constexpr int kRows = 128;        // corpus rows a tile: 8 warps x 16
constexpr int kNT = 8;            // n8 query tiles
constexpr int kQBlock = 8 * kNT;  // queries a block
constexpr int kChunk = 4;         // 256-bit K steps a ring stage
constexpr int kStages = 3;
constexpr int kStep = 32;         // bytes of one row in one step
constexpr int kOutStride = kRows + 4;   // staged distances a query
constexpr int kMaxSpan = 16;      // row tiles a block

// query rows of the ring and the staging tile: the launch's widest block
__host__ __device__ inline int query_rows(int n_q) {
  return n_q >= kQBlock ? kQBlock : (n_q + 7) / 8 * 8;
}

// a ring stage: the chunk's rows, then its query words unless one stage
// holds all of W (then the queries load once, after the ring)
__host__ __device__ inline int stage_bytes(int chunk, int qrows,
                                           bool q_once) {
  return chunk * kStep * (kRows + (q_once ? 0 : qrows));
}

__host__ __device__ inline int batch_smem_bytes(int chunk, int qrows,
                                                bool q_once) {
  return kStages * stage_bytes(chunk, qrows, q_once) +
         (q_once ? chunk * kStep * qrows : 0) + qrows * kOutStride * 4 +
         kQBlock * 4;
}

__global__ void __launch_bounds__(kThreads, 2) hamming_batch_kernel(
    const int32_t* __restrict__ corpus, const int32_t* __restrict__ queries,
    int32_t* __restrict__ out, long long n_rows, int n_q, int words,
    int span, int n_qblocks) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int steps = (words + 7) / 8;
  const int chunk = min(steps, kChunk);
  const int chunks = (steps + chunk - 1) / chunk;
  const bool q_once = chunks == 1;
  const int qrows = query_rows(n_q);
  const int st_bytes = stage_bytes(chunk, qrows, q_once);
  uint8_t* ring = smem;
  uint8_t* q_fixed = ring + kStages * st_bytes;   // [chunk][qrows][8 words]
  int* staged = reinterpret_cast<int*>(
      q_fixed + (q_once ? chunk * kStep * qrows : 0));
  int* pq = staged + qrows * kOutStride;   // [kQBlock] popc of the queries

  const int q0 = (blockIdx.x % n_qblocks) * kQBlock;
  const int nq = min(kQBlock, n_q - q0);
  const int n_nt = (nq + 7) / 8;
  const long long tiles = (n_rows + kRows - 1) / kRows;
  const long long tile0 = blockIdx.x / n_qblocks * static_cast<long long>(span);
  const int n_tiles = static_cast<int>(min(static_cast<long long>(span),
                                           tiles - tile0));
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int m_base = threadIdx.x / 32 * 16;

  // the flat (row tile, K chunk) sequence through the ring: the chunk's
  // corpus rows [chunk][kRows][8 words], its query words [chunk][qrows]
  // [8 words] (with the first stage only, into q_fixed, when one chunk is
  // all of W), zero past W, past N and past the block's queries
  const int iters = n_tiles * chunks;
  auto issue = [&](int it) {
    if (it < iters) {
      uint8_t* dst = ring + (it % kStages) * st_bytes;
      uint8_t* q_dst = q_once ? q_fixed : dst + chunk * kRows * kStep;
      const long long r0 = (tile0 + it / chunks) * kRows;
      const int w0 = (it % chunks) * chunk * 8;
      const int n_load = kRows + (!q_once || it == 0 ? qrows : 0);
      // 16-byte piece i & 7 of row i >> 3: step (i >> 1) & 3, half i & 1
      for (int i = threadIdx.x; i < n_load * 8; i += kThreads) {
        const int r = i >> 3;
        const int s = (i >> 1) & 3;
        if (s >= chunk) continue;
        const int w = w0 + 8 * s + 4 * (i & 1);
        const int32_t* src;
        bool ok;
        uint8_t* d;
        if (r < kRows) {
          ok = r0 + r < n_rows && w < words;
          src = corpus + (r0 + r) * words + w;
          d = dst + (s * kRows + r) * kStep;
        } else {
          const int qi = r - kRows;
          ok = qi < nq && w < words;
          src = queries + static_cast<long long>(q0 + qi) * words + w;
          d = q_dst + (s * qrows + qi) * kStep;
        }
        cp_async16(d + 16 * (i & 1), ok ? src : corpus, ok);
      }
    }
    cp_async_commit();   // an empty group keeps the wait counts aligned
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);

  // popc(q) while the first stages load: 4 lanes a query, 16-byte loads
  {
    const int qi = threadIdx.x / 4;
    int c = 0;
    if (qi < nq) {
      const int4* src = reinterpret_cast<const int4*>(
          queries + static_cast<long long>(q0 + qi) * words);
      for (int j = threadIdx.x % 4; j < words / 4; j += 4) c += popc4(src[j]);
    }
    c += __shfl_xor_sync(kAll, c, 1);
    c += __shfl_xor_sync(kAll, c, 2);
    if (threadIdx.x % 4 == 0) pq[qi] = c;
  }

  int acc[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[j][v] = 0;
  }
  int pa[2] = {0, 0};   // popc of rows g, g + 8 (this lane's words)
  for (int it = 0; it < iters; ++it) {
    const int c = it % chunks;
    const int tile = it / chunks;
    cp_async_wait<kStages - 2>();
    __syncthreads();   // stage `it` landed; stage it - 1 is free again
    issue(it + kStages - 1);
    const uint8_t* st = ring + (it % kStages) * st_bytes;
    const uint2* rows = reinterpret_cast<const uint2*>(st);
    const uint2* qs = reinterpret_cast<const uint2*>(
        q_once ? q_fixed : st + chunk * kRows * kStep);
    const int n_steps = min(chunk, steps - c * chunk);
#pragma unroll
    for (int s = 0; s < kChunk; ++s) {
      if (s < n_steps) {
        const uint2 x0 = rows[(s * kRows + m_base + g) * 4 + t];
        const uint2 x1 = rows[(s * kRows + m_base + g + 8) * 4 + t];
        const unsigned a[4] = {x0.x, x1.x, x0.y, x1.y};
        pa[0] += __popc(x0.x) + __popc(x0.y);
        pa[1] += __popc(x1.x) + __popc(x1.y);
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          if (j < n_nt) {
            const uint2 bb = qs[(s * qrows + 8 * j + g) * 4 + t];
            const unsigned b[2] = {bb.x, bb.y};
            mma_b1(acc[j], a, b);
          }
        }
      }
    }
    if (c != chunks - 1) continue;

    // row tile done: distances into the staging tile, then out
#pragma unroll
    for (int h = 0; h < 2; ++h) {   // over the 4 lanes t that share a row
      pa[h] += __shfl_xor_sync(kAll, pa[h], 1);
      pa[h] += __shfl_xor_sync(kAll, pa[h], 2);
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      if (j >= n_nt) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qi = 8 * j + 2 * t + e;
        const int pqi = pq[qi];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          staged[qi * kOutStride + m_base + 8 * h + g] =
              pa[h] + pqi - 2 * acc[j][2 * h + e];
          acc[j][2 * h + e] = 0;
        }
      }
    }
    pa[0] = pa[1] = 0;
    const long long r0 = (tile0 + tile) * kRows;
    int32_t* o = out + static_cast<long long>(q0) * n_rows + r0;
    __syncthreads();
    if ((n_rows & 3) == 0) {
      for (int i = threadIdx.x; i < nq * (kRows / 4); i += kThreads) {
        const int qi = i / (kRows / 4);
        const int v = 4 * (i % (kRows / 4));
        if (r0 + v < n_rows) {
          __stcs(reinterpret_cast<int4*>(o + qi * n_rows + v),
                 *reinterpret_cast<const int4*>(staged + qi * kOutStride + v));
        }
      }
    } else {
      for (int i = threadIdx.x; i < nq * kRows; i += kThreads) {
        const int qi = i / kRows;
        const int v = i % kRows;
        if (r0 + v < n_rows) {
          __stcs(o + qi * n_rows + v, staged[qi * kOutStride + v]);
        }
      }
    }
  }
  cp_async_wait<0>();
}

int launch_batch(const void* corpus, const void* queries, void* out,
                 long long n_rows, int n_q, int w, int sms,
                 cudaStream_t stream) {
  const int steps = (w + 7) / 8;
  const int chunk = steps < kChunk ? steps : kChunk;
  // spans of row tiles: about 4 blocks a SM in all, at most kMaxSpan tiles
  const long long tiles = (n_rows + kRows - 1) / kRows;
  const int n_qblocks = (n_q + kQBlock - 1) / kQBlock;
  long long span = (tiles * n_qblocks + 4LL * sms - 1) / (4LL * sms);
  span = span < 1 ? 1 : (span > kMaxSpan ? kMaxSpan : span);
  const long long blocks = (tiles + span - 1) / span * n_qblocks;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  hamming_batch_kernel<<<static_cast<unsigned>(blocks), kThreads,
                         batch_smem_bytes(chunk, query_rows(n_q),
                                          steps <= kChunk),
                         stream>>>(
      static_cast<const int32_t*>(corpus),
      static_cast<const int32_t*>(queries), static_cast<int32_t*>(out),
      n_rows, n_q, w, static_cast<int>(span), n_qblocks);
  return static_cast<int>(cudaGetLastError());
}

// per device, once: the SM count, and the batch kernel's shared-memory
// limit (its widest configuration), off the launch path
int device_sms(int* sms) {
  static int cached[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (cached[dev] == 0) {
    err = cudaFuncSetAttribute(hamming_batch_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               batch_smem_bytes(kChunk, kQBlock, false));
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&cached[dev],
                                   cudaDevAttrMultiProcessorCount, dev);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  *sms = cached[dev];
  return 0;
}

}  // namespace

// corpus [N, W] int32 bit patterns, queries [Q, W] int32 -> out [Q, N]
// int32 distances. W % 4 == 0, pointers 16-byte aligned (the wrapper
// checks). Up to 8 queries take the few-query kernel, more the batch
// kernel. Returns cudaGetLastError() after the launch.
extern "C" int neumann_hamming_scores(const void* corpus, const void* queries,
                                      void* out, long long n_rows, int n_q,
                                      int w, void* stream) {
  if (w % 4 || w < 4 || n_q < 1 || n_rows < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int sms = 0;
  const int err = device_sms(&sms);
  if (err != 0) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return n_q <= kFewQ
             ? launch_few(corpus, queries, out, n_rows, n_q, w, sms, s)
             : launch_batch(corpus, queries, out, n_rows, n_q, w, sms, s);
}
