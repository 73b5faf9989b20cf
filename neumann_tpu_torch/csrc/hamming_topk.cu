// Hamming top-k over packed sign bits, the top-k fused into the distance
// loop, the distances on the 1-bit tensor cores.
//
// Replaces `hamming_topk_pallas` (neumann_tpu/ops/pallas_kernels.py)
// around the Pallas TPU kernel `_hamming_kernel`: that design writes the
// [Q, N] int32 distances of each row block to device memory and leaves
// the top-k to XLA. Here no distance reaches device memory. For each
// query the function is the k best rows by (distance ascending, row
// ascending) — lax.top_k's order among equal distances. Each block
// writes the k smallest keys distance << 32 | row of its row group; one
// torch.topk over [Q, groups * k] keys (ops/kernels.py) finishes, as
// lax.top_k sits outside the Pallas kernel.
//
// What bounds it on an H100. D's batch, 1,024 queries x 1,048,576 rows x
// 24 words, is 8e11 bit products against 0.1 GB of corpus. As XOR +
// POPC (csrc/hamming.cu's loop) it is 2.6e10 POPC, 6.2 ms at 16 a SM a
// clock; as the same product in +-1 int8 on the tensor cores, 0.83 ms at
// 1,979 TOP/s. The 1-bit mma.sync.m16n8k256.b1.and.popc computes it
// exactly from the packed words themselves, at a rate the data sheet
// does not give (chip_smoke.py measures it with b1_rate_kernel below):
//   hamming(r, q) = popc(r) + popc(q) - 2 popc(r AND q).
// One query is bound by the corpus bytes (0.03 ms).
//
// The design:
//   * corpus rows on the M side (8 warps x 16 rows = 128 rows a pass),
//     the block's 64 queries on N (8 n8 tiles, only those holding a
//     query run). Each 256-bit K step takes two words of a row a thread,
//     read as one 8-byte load straight into the A fragment (the K order
//     inside a step is any permutation shared by A and B, so a thread
//     takes words 8 s + 2 t and 8 s + 2 t + 1); the queries' B fragments
//     are laid out once per block in shared memory (one 8-byte load a
//     product). The next pass's rows are loaded while this pass's
//     distances are selected;
//   * selection in shared memory, per query: the current k best keys
//     (sorted), their k-th as a threshold, and a candidate buffer. A
//     (row, query) whose key is below the threshold is appended with a
//     shared atomic; after a pass, any buffer that a further pass could
//     overflow is merged by one warp (k rounds of a warp-wide minimum,
//     __reduce_min_sync) and the threshold falls. The top k of a million
//     rows lie far in the tail, so after the first passes almost nothing
//     is appended. The selection, not the products, set the kernel's
//     time, so a pass reads its thresholds into registers once and tests
//     each distance with one multiply-add and one compare into a hit
//     mask; only a thread with a hit takes the append path;
//   * keys inside a block are 32 bits, distance << b | row in the group,
//     b = 20 row bits up to W 64 and clz(32 W) above (18 at W 256:
//     distances reach 32 W; the wrapper's groups span at most 2^b rows),
//     so merges and compares are 32-bit;
//   * up to 8 K steps (W <= 64, D's 768-d rows) one instantiation a step
//     count keeps a pass's rows in registers and the queries' fragments
//     in shared memory; wider rows take one instantiation that loops the
//     steps at run time, 4 at a time, both operands read by 8-byte loads
//     (the queries' from L1), so no W is too wide for shared memory.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "mma_b1.cuh"

namespace {

using neumann::mma_b1;

constexpr int kThreads = 256;        // 8 warps x 16 rows
constexpr int kRows = 128;           // rows a pass
constexpr int kNT = 8;               // n8 query tiles
constexpr int kQBlock = 8 * kNT;     // queries a block
constexpr int kMaxK = 64;            // the wrapper's cap on k
constexpr int kBuf = 256;            // candidates buffered a query
constexpr int kMergeAbove = kBuf - kRows;   // a pass adds <= kRows
constexpr unsigned kNone = 0xFFFFFFFFu;
constexpr int kPerLane = (kMaxK + kBuf) / 32;
constexpr int kLoopSteps = 4;        // K steps a round of the looped variant
constexpr int kStepsRowBits = 20;    // W <= 64: distances <= 2,048

// One warp: the k smallest of the query's best keys and its buffered
// candidates become its best keys (sorted), the threshold its k-th.
__device__ __forceinline__ void merge(unsigned* best, unsigned* buf,
                                      unsigned* thr, int* cnt, int k) {
  const int lane = threadIdx.x % 32;
  const int total = k + *cnt;
  unsigned v[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int j = lane + 32 * i;
    v[i] = j < k ? best[j] : (j < total ? buf[j - k] : kNone);
  }
  __syncwarp();
  for (int o = 0; o < k; ++o) {
    unsigned m = v[0];
#pragma unroll
    for (int i = 1; i < kPerLane; ++i) m = min(m, v[i]);
    const unsigned w = __reduce_min_sync(0xffffffffu, m);
    if (w == kNone) {   // fewer than k keys: the rest stay empty
      for (int j = o + lane; j < k; j += 32) best[j] = kNone;
      break;
    }
    if (lane == 0) best[o] = w;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) v[i] = v[i] == w ? kNone : v[i];
  }
  __syncwarp();
  if (lane == 0) {
    *thr = best[k - 1];
    *cnt = 0;
  }
}

// A thread's rows of one pass: rows g and g + 8 of its warp's 16, the
// words 8 s + 2 t, 8 s + 2 t + 1 of each K step s (zero past W and past
// the group). The words do not wait for the mask: a masked row is loaded
// and then never selected. kSteps 0 (rows wider than 8 steps) holds only
// the rows' positions; the product loop loads their words.
template <int kSteps>
struct PassRows {
  uint2 x[2][kSteps > 0 ? kSteps : 1];
  long long row[2];
  bool live[2];

  __device__ __forceinline__ void load(const int32_t* __restrict__ corpus,
                                       const uint8_t* __restrict__ mask,
                                       long long base, long long span1,
                                       int words) {
    const int lane = threadIdx.x % 32;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      row[h] = base + threadIdx.x / 32 * 16 + 8 * h + (lane >> 2);
      const bool in = row[h] < span1;
      live[h] = in && (mask == nullptr || mask[row[h]] != 0);
      const int32_t* src = corpus + row[h] * words;
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        const int w0 = 8 * s + 2 * (lane & 3);   // only the last step
        x[h][s] = in && (s + 1 < kSteps || w0 < words)   // may pass W
                      ? *reinterpret_cast<const uint2*>(src + w0)
                      : make_uint2(0u, 0u);
      }
    }
  }
};

// one instantiation a 256-bit K step count up to 8, the word count at run
// time, and kSteps 0 for any wider row; three blocks a SM where the rows'
// registers allow (W <= 32). With `select` false no (row, query) passes
// its threshold: the launch loads, multiplies and compares but never
// appends or merges, and writes only empty keys (chip_smoke.py times it to
// split the kernel's time).
template <int kSteps>
__global__ void __launch_bounds__(kThreads,
                                  kSteps >= 1 && kSteps <= 4 ? 3 : 2)
    hamming_topk_kernel(
    const int32_t* __restrict__ corpus, const int32_t* __restrict__ queries,
    const uint8_t* __restrict__ mask, long long* __restrict__ out,
    long long n_rows, int n_q, int words, int k, long long span, int groups,
    bool select) {
  extern __shared__ uint2 smem[];
  uint2* qf = smem;                          // [kSteps][kNT][32] B fragments
  // row bits of a block key: distances reach 32 W (20 bits of row up
  // to 8 steps, as the wrapper's span allows)
  const int row_bits = kSteps > 0 ? kStepsRowBits : __clz(32 * words);
  int* pq = reinterpret_cast<int*>(qf + kSteps * kNT * 32);   // popc(q)
  unsigned* thr = reinterpret_cast<unsigned*>(pq + kQBlock);
  int* cnt = reinterpret_cast<int*>(thr + kQBlock);
  unsigned* best = reinterpret_cast<unsigned*>(cnt + kQBlock);  // [64][k]
  unsigned* buf = best + kQBlock * k;                          // [64][kBuf]

  const int group = blockIdx.x;
  const int q0 = blockIdx.y * kQBlock;
  const int nq = min(kQBlock, n_q - q0);
  const int n_nt = (nq + 7) / 8;
  const long long span0 = group * span;
  const long long span1 = min(span0 + span, n_rows);
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int t = lane & 3;

  auto qword = [&](int qi, int w) -> unsigned {
    return qi < nq && w < words
               ? static_cast<unsigned>(
                     queries[static_cast<long long>(q0 + qi) * words + w])
               : 0u;
  };
  for (int i = threadIdx.x; i < kSteps * kNT * 32; i += kThreads) {
    const int l = i % 32;
    const int qi = 8 * ((i / 32) % kNT) + l / 4;
    const int w0 = 8 * (i / (32 * kNT)) + 2 * (l % 4);
    qf[i] = make_uint2(qword(qi, w0), qword(qi, w0 + 1));
  }
  for (int i = threadIdx.x; i < kQBlock; i += kThreads) {
    int p = 0;
    for (int w = 0; w < words; ++w) p += __popc(qword(i, w));
    pq[i] = p;
    thr[i] = kNone;
    cnt[i] = 0;
  }
  for (int i = threadIdx.x; i < kQBlock * k; i += kThreads) best[i] = kNone;
  __syncthreads();

  PassRows<kSteps> rows;
  rows.load(corpus, mask, span0, span1, words);
  for (long long base = span0; base < span1; base += kRows) {
    // the pass selects (row, q) iff its distance is below the threshold's:
    // every row of this pass follows the rows of the best keys, so a tie
    // loses. As pa - 2 dot < lim = thr distance - popc(q), 32-bit: no
    // query (past nq) never, the threshold of an empty list always
    // (unless `select` is false).
    int lim[kNT][2];
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qi = 8 * j + 2 * t + e;
        lim[j][e] = select && qi < nq
                        ? static_cast<int>(thr[qi] >> row_bits) - pq[qi]
                        : INT_MIN;
      }
    }
    int acc[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[j][v] = 0;
    }
    int pa[2] = {0, 0};   // popc of the rows
    if constexpr (kSteps > 0) {
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        const unsigned a[4] = {rows.x[0][s].x, rows.x[1][s].x,
                               rows.x[0][s].y, rows.x[1][s].y};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          pa[h] += __popc(rows.x[h][s].x) + __popc(rows.x[h][s].y);
        }
        const uint2* f = qf + s * kNT * 32 + lane;
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          if (j < n_nt) {
            const uint2 bb = f[j * 32];
            const unsigned b[2] = {bb.x, bb.y};
            mma_b1(acc[j], a, b);
          }
        }
      }
    } else {   // any W: the steps at run time, kLoopSteps loads at a time
      const int steps = (words + 7) / 8;
      const int g = lane >> 2;
      for (int s0 = 0; s0 < steps; s0 += kLoopSteps) {
        uint2 x[2][kLoopSteps];
#pragma unroll
        for (int s = 0; s < kLoopSteps; ++s) {
          const int w0 = 8 * (s0 + s) + 2 * t;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            x[h][s] = rows.row[h] < span1 && w0 < words
                          ? *reinterpret_cast<const uint2*>(
                                corpus + rows.row[h] * words + w0)
                          : make_uint2(0u, 0u);
          }
        }
#pragma unroll
        for (int s = 0; s < kLoopSteps; ++s) {
          const int w0 = 8 * (s0 + s) + 2 * t;
          if (s0 + s >= steps) break;
          const unsigned a[4] = {x[0][s].x, x[1][s].x, x[0][s].y, x[1][s].y};
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            pa[h] += __popc(x[h][s].x) + __popc(x[h][s].y);
          }
#pragma unroll
          for (int j = 0; j < kNT; ++j) {
            const int qi = 8 * j + g;
            if (j < n_nt) {
              const uint2 bb =
                  qi < nq && w0 < words
                      ? __ldg(reinterpret_cast<const uint2*>(
                            queries + static_cast<long long>(q0 + qi) * words +
                            w0))
                      : make_uint2(0u, 0u);
              const unsigned b[2] = {bb.x, bb.y};
              mma_b1(acc[j], a, b);
            }
          }
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {   // over the 4 lanes t that share a row
      pa[h] += __shfl_xor_sync(0xffffffffu, pa[h], 1);
      pa[h] += __shfl_xor_sync(0xffffffffu, pa[h], 2);
    }
    const unsigned local[2] = {static_cast<unsigned>(rows.row[0] - span0),
                               static_cast<unsigned>(rows.row[1] - span0)};
#pragma unroll
    for (int h = 0; h < 2; ++h) {   // a masked row is never selected
      if (!rows.live[h]) pa[h] = 1 << 30;
    }
    if (base + kRows < span1) {   // the next pass's rows, during selection
      rows.load(corpus, mask, base + kRows, span1, words);
    }
    unsigned hits = 0;   // bit 4 j + 2 h + e: (row h, query 8 j + 2 t + e)
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      if (j >= n_nt) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          hits |= static_cast<unsigned>(pa[h] - 2 * acc[j][2 * h + e] <
                                        lim[j][e])
                  << (4 * j + 2 * h + e);
        }
      }
    }
    if (hits != 0) {   // rare once the thresholds have settled
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (hits & (1u << (4 * j + 2 * h + e))) {
              const int qi = 8 * j + 2 * t + e;
              const int dist = pa[h] + pq[qi] - 2 * acc[j][2 * h + e];
              buf[qi * kBuf + atomicAdd(&cnt[qi], 1)] =
                  (static_cast<unsigned>(dist) << row_bits) | local[h];
            }
          }
        }
      }
    }
    __syncthreads();
    const bool last = base + kRows >= span1;
    for (int qi = warp; qi < nq; qi += kThreads / 32) {
      const int c = cnt[qi];
      if (c > kMergeAbove || (last && c > 0)) {
        merge(best + qi * k, buf + qi * kBuf, thr + qi, cnt + qi, k);
      }
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < nq * k; i += kThreads) {
    const int qi = i / k;
    const unsigned key = best[i];
    long long g = LLONG_MAX;
    if (key != kNone) {
      g = (static_cast<long long>(key >> row_bits) << 32) |
          (span0 + (key & ((1u << row_bits) - 1)));
    }
    out[(static_cast<long long>(q0 + qi) * groups + group) * k + i % k] = g;
  }
}

template <int kSteps>
int launch(const void* corpus, const void* queries, const void* mask,
           void* out, long long n_rows, int n_q, int words, int k,
           long long span, int groups, bool select, cudaStream_t stream) {
  const int smem = kSteps * kNT * 32 * 8 + 3 * kQBlock * 4 +
                   kQBlock * (k + kBuf) * 4;
  auto kernel = hamming_topk_kernel<kSteps>;
  const cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid(static_cast<unsigned>(groups),
                  static_cast<unsigned>((n_q + kQBlock - 1) / kQBlock));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const int32_t*>(corpus), static_cast<const int32_t*>(queries),
      static_cast<const uint8_t*>(mask), static_cast<long long*>(out), n_rows,
      n_q, words, k, span, groups, select);
  return static_cast<int>(cudaGetLastError());
}

using Launch = int (*)(const void*, const void*, const void*, void*,
                       long long, int, int, int, long long, int, bool,
                       cudaStream_t);
constexpr Launch kLaunch[] = {launch<0>, launch<1>, launch<2>,
                              launch<3>, launch<4>, launch<5>,
                              launch<6>, launch<7>, launch<8>};

int dispatch(const void* corpus, const void* queries, const void* mask,
             void* out, long long n_rows, int n_q, int w, int k,
             long long span, int groups, bool select, void* stream) {
  if (w % 4 || w < 4 || w > (1 << 20) || k < 1 || k > kMaxK || span < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // a group's rows must fit the keys' row bits
  const int row_bits = w <= 8 * 8 ? kStepsRowBits
                                  : __builtin_clz(32u * static_cast<unsigned>(w));
  if (span > (1LL << row_bits)) return static_cast<int>(cudaErrorInvalidValue);
  const int steps = (w + 7) / 8;
  return kLaunch[steps <= 8 ? steps : 0](
      corpus, queries, mask, out, n_rows, n_q, w, k, span, groups, select,
      static_cast<cudaStream_t>(stream));
}

// The card's rate of m16n8k256.b1.and.popc: each warp issues `iters`
// rounds of 8 independent products on register fragments, no memory in
// the loop. One int a thread is written so nothing is dropped.
__global__ void __launch_bounds__(kThreads) b1_rate_kernel(int iters,
                                                           int* out) {
  const unsigned x = threadIdx.x * 0x9E3779B9u + blockIdx.x;
  const unsigned a[4] = {x, x ^ 0x55555555u, ~x, x * 3u};
  const unsigned b[2] = {x ^ 0x0F0F0F0Fu, x * 5u};
  int c[8][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) mma_b1(c[j], a, b);
  }
  int s = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * kThreads + threadIdx.x] = s;
}

}  // namespace

// corpus [N, W] int32 bit patterns, queries [Q, W] int32, mask [N] bool
// (nullptr: every row live) -> out [Q, groups, k] int64 keys
// distance << 32 | row, ascending in each group, LLONG_MAX past the
// group's live rows. W % 4 == 0, 1 <= k <= 64, span a multiple of 128
// and at most 2^20 (W <= 64) or 2^clz(32 W) with groups * span >= N,
// pointers
// 16-byte aligned (the wrapper checks). Returns cudaGetLastError() after
// the launch.
extern "C" int neumann_hamming_topk(const void* corpus, const void* queries,
                                    const void* mask, void* out,
                                    long long n_rows, int n_q, int w, int k,
                                    long long span, int groups,
                                    void* stream) {
  return dispatch(corpus, queries, mask, out, n_rows, n_q, w, k, span, groups,
                  true, stream);
}

// For measurement only: the same launch with nothing selected (out gets
// only LLONG_MAX), so its time is that of the loads, the products and
// the per-distance compare, without the appends and merges.
extern "C" int neumann_hamming_topk_unselected(
    const void* corpus, const void* queries, const void* mask, void* out,
    long long n_rows, int n_q, int w, int k, long long span, int groups,
    void* stream) {
  return dispatch(corpus, queries, mask, out, n_rows, n_q, w, k, span, groups,
                  false, stream);
}

// For measurement only: `blocks` x 256 threads of b1_rate_kernel into out
// [blocks * 256] int32; it does blocks * 8 * iters * 8 products of
// 16 x 8 x 256 bits.
extern "C" int neumann_b1_mma_rate(int blocks, int iters, void* out,
                                   void* stream) {
  b1_rate_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      iters, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
