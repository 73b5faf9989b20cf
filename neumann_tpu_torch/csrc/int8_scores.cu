// int8 x int8 corpus scores on the tensor cores (mma.sync for a few
// queries, wgmma for batches), each with two epilogues.
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
// What bounds it on an H100. The pooled scan at Q = 1,024 against
// 1,048,576 x 768 rows is 1.65e12 int8 operations over 0.8 GB of corpus,
// about 2,000 per byte: the int8 tensor cores (1,979 TOP/s) are the
// limit, 0.83 ms. At a few queries (Q <= 64) the corpus read is the limit
// (0.24 ms at 3.35 TB/s), and the scores kernel also writes Q x N floats.
//
// The design. Corpus rows go on the M side of the tensor-core product
// and queries on N, so one query pads nothing past 8 and a large batch
// reuses each staged corpus tile across 128 queries. Both operands are
// K-major in device memory ([N, d] and [Q, d]), the only layout the s8
// products take.
// * Q <= 8 (`int8_kernel`): 8 warps over a 128-row x 8-query tile,
//   mma.sync.m16n8k32.s8 fed by ldmatrix, K staged 128 bytes at a time
//   through a 4-stage cp.async ring, one __syncthreads a stage (the corpus
//   read is the limit here, and 128-byte stages kept more of it in
//   flight than 64-byte ones). Tiles sit in shared memory in the 128-byte
//   swizzle (16-byte chunks XORed with the row's low bits), so the
//   ldmatrix reads and cp.async writes of 8 rows hit 8 different bank
//   groups.
// * Q > 8 (`int8_tma_kernel`): warp-specialized, 128 rows x 128 queries
//   a block. One producer thread loads each stage's corpus and query
//   tiles with TMA (128 K bytes, 128-byte swizzle, zero fill past the
//   ends) into a 3-stage ring signalled by mbarriers; two consumer
//   warpgroups run wgmma.m64n128k32.s8 on 64 rows each straight from
//   shared memory, keep one stage's products in flight and hand stages
//   back through `empty` mbarriers. No block-wide wait in the loop; two
//   blocks a SM, so one block's epilogue overlaps the other's products.
// The pooled kernels walk their span (pool rows when pool > 128) as one
// flat sequence of stages, so the ring does not drain between tiles.
//
// What held the pooled scan back after the move to wgmma was its
// epilogue, not the products: a build without it ran several times as
// fast. Each lane reduced every (query, pool) across its 8 row lanes on
// its own (96 shuffles or 32 partial-mask reductions a tile) and the
// table slot took a 64-bit division. The wgmma epilogue now folds the
// 16 values of half the queries at once with a 3-step butterfly (14
// shuffles), after which every lane updates the table at distinct
// queries, and the slot is a shift.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "hopper.cuh"
#include "mma_s8.cuh"
#include "pooled_bits.cuh"

namespace {

using neumann::cp_async16;
using neumann::cp_async_commit;
using neumann::cp_async_wait;
using neumann::gmma_desc;
using neumann::kThreads;
using neumann::ldsm_x2;
using neumann::ldsm_x4;
using neumann::mbar_arrive;
using neumann::mbar_arrive_expect_tx;
using neumann::mbar_init;
using neumann::mbar_wait;
using neumann::mma_s8;
using neumann::smem_u32;
using neumann::tma_load_2d;
using neumann::wgmma_commit;
using neumann::wgmma_fence;
using neumann::wgmma_wait;

// The mma.sync tile: 8 warps, each on 16 corpus rows x one 8-query
// fragment; K staged 128 bytes at a time through a 4-stage ring
struct Tile {
  static constexpr int kBM = 128;   // corpus rows, 16 a warp
  static constexpr int kBN = 8;     // queries
  static constexpr int kBK = 128;
  static constexpr int kStages = 4;
  static constexpr int kStageBytes = (kBM + kBN) * kBK;
  static constexpr int kMaxSlots = kBM / neumann::kMinPool;

  // byte offset of 16-byte chunk c of row r in a [rows][128] tile, the
  // 128-byte swizzle (mma_s8.cuh)
  static __device__ __forceinline__ int swz(int r, int c) {
    return neumann::swz128(r, c);
  }
};

// c += a (64 x 32 s8, K-major, shared) * b (32 x 128 s8, K-major,
// shared) for the 4 warps of a warpgroup, asynchronous; `accumulate` 0
// overwrites c. d[j][v] is the mma.sync m16n8 fragment of query block j
// (rows 16 (warp % 4) + g (+ 8), queries 8 j + 2 t (+ 1)).
__device__ __forceinline__ void wgmma_m64n128k32(int (&d)[16][4],
                                                 uint64_t desc_a,
                                                 uint64_t desc_b,
                                                 int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p;\n"
      "}\n"
      : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]),
        "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]),
        "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]),
        "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3]),
        "+r"(d[4][0]), "+r"(d[4][1]), "+r"(d[4][2]), "+r"(d[4][3]),
        "+r"(d[5][0]), "+r"(d[5][1]), "+r"(d[5][2]), "+r"(d[5][3]),
        "+r"(d[6][0]), "+r"(d[6][1]), "+r"(d[6][2]), "+r"(d[6][3]),
        "+r"(d[7][0]), "+r"(d[7][1]), "+r"(d[7][2]), "+r"(d[7][3]),
        "+r"(d[8][0]), "+r"(d[8][1]), "+r"(d[8][2]), "+r"(d[8][3]),
        "+r"(d[9][0]), "+r"(d[9][1]), "+r"(d[9][2]), "+r"(d[9][3]),
        "+r"(d[10][0]), "+r"(d[10][1]), "+r"(d[10][2]), "+r"(d[10][3]),
        "+r"(d[11][0]), "+r"(d[11][1]), "+r"(d[11][2]), "+r"(d[11][3]),
        "+r"(d[12][0]), "+r"(d[12][1]), "+r"(d[12][2]), "+r"(d[12][3]),
        "+r"(d[13][0]), "+r"(d[13][1]), "+r"(d[13][2]), "+r"(d[13][3]),
        "+r"(d[14][0]), "+r"(d[14][1]), "+r"(d[14][2]), "+r"(d[14][3]),
        "+r"(d[15][0]), "+r"(d[15][1]), "+r"(d[15][2]), "+r"(d[15][3])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// One stage of the block's flat (tile, k) sequence: kBM corpus rows from
// row0 and kBN queries from q0, K bytes k0 .. k0 + kBK - 1. Rows past
// row_end, queries past n_q and K past d read as zero.
__device__ __forceinline__ void load_stage(uint8_t* sa, const int8_t* cq,
                                           const int8_t* qq, long long row0,
                                           long long row_end, int q0,
                                           int n_q, int d, int k0) {
  using T = Tile;
  constexpr int kChunks = T::kBK / 16;
  uint8_t* sb = sa + T::kBM * T::kBK;
  for (int idx = threadIdx.x; idx < T::kBM * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = idx % kChunks;
    const long long n = row0 + r;
    const bool ok = n < row_end && k0 + 16 * c < d;
    cp_async16(sa + T::swz(r, c), ok ? cq + n * d + k0 + 16 * c : cq, ok);
  }
  for (int idx = threadIdx.x; idx < T::kBN * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = idx % kChunks;
    const int q = q0 + r;
    const bool ok = q < n_q && k0 + 16 * c < d;
    cp_async16(sb + T::swz(r, c),
               ok ? qq + static_cast<long long>(q) * d + k0 + 16 * c : qq,
               ok);
  }
}

// The rows a thread holds in its warp's 16-row tile: row0 + 8 h + g.
struct TileRows {
  long long row0;
  float rm[2];     // row multipliers, 0 past the span
  float bias[2];   // 2.0 live, -1e30 dead, 0 past the span
};

// Read at a tile's first stage, so the loads land before its epilogue.
__device__ __forceinline__ TileRows tile_rows(
    long long row0, long long span1, const float* __restrict__ row_mult,
    const float* __restrict__ bias) {
  const int g = (threadIdx.x % 32) >> 2;
  TileRows r;
  r.row0 = row0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long n = row0 + 8 * h + g;
    const bool live = n < span1;
    r.rm[h] = live ? row_mult[n] : 0.f;
    r.bias[h] = live && bias != nullptr ? bias[n] : 0.f;
  }
  return r;
}

// The epilogue of one warp's tile. acc[nt][2 h + e] is the dot of corpus
// row rows.row0 + 8 h + g and the block's query nt * 8 + 2 t + e (the
// mma.sync m16n8 fragment, which is also wgmma's accumulator layout);
// qm_s holds the block's query multipliers in shared memory. Scores go to
// out [Q, N]. Pooled winner bits (the mma.sync kernel's few queries; the
// wgmma kernel has wg_pooled_epilogue) fold into the block's table: a
// thread folds the rows it holds of one pool, the 8 lanes g that share a
// query fold with 3 shuffles, and one of them folds into the table.
template <int NT, bool kPooled>
__device__ __forceinline__ void tile_epilogue(
    const int (&acc)[NT][4], const TileRows& rows, long long span1, int q0,
    const float* qm_s, void* __restrict__ out, int n_q, long long n_rows,
    int pool, neumann::PoolTable& table) {
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  if constexpr (!kPooled) {
    float* o = static_cast<float*>(out);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long n = rows.row0 + 8 * h + g;
      if (n >= span1) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ql = nt * 8 + 2 * t + e;
          if (q0 + ql < n_q) {
            o[static_cast<long long>(q0 + ql) * n_rows + n] = __fmul_rn(
                __fmul_rn(__int2float_rn(acc[nt][2 * h + e]), qm_s[ql]),
                rows.rm[h]);
          }
        }
      }
    }
  } else {
    // pools are >= 8 rows and aligned: a lane's rows g and 8 + g share a
    // pool unless pools are 8 rows
    const int groups = pool == 8 ? 2 : 1;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ql = nt * 8 + 2 * t + e;
        const float qm = qm_s[ql];
        for (int grp = 0; grp < groups; ++grp) {
          int folded = INT_MIN;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (groups == 2 && h != grp) continue;
            const long long n = rows.row0 + 8 * h + g;
            const float a =
                __fmul_rn(__int2float_rn(acc[nt][2 * h + e]), qm);
            const int bits = neumann::pack_pool_bits(a, rows.rm[h],
                                                     rows.bias[h], n, pool);
            folded = max(folded, n < span1 ? bits : INT_MIN);
          }
          for (int off = 4; off < 32; off <<= 1) {   // lane bits of g
            folded = max(folded, __shfl_xor_sync(0xffffffffu, folded, off));
          }
          if (g == 0) table.add(ql, rows.row0 + 8 * grp, folded);
        }
      }
    }
  }
}

// One block: corpus rows [span0, span1) in kBM-row tiles x queries
// q0 .. q0 + kBN - 1. kPooled: winner bits of pools of `pool` rows into
// out [Q, N / pool]; else scores into out [Q, N] (span = kBM).
template <bool kPooled>
__global__ void __launch_bounds__(kThreads, 1) int8_kernel(
    const int8_t* __restrict__ qq, const int8_t* __restrict__ cq,
    const float* __restrict__ q_mult, const float* __restrict__ row_mult,
    const float* __restrict__ bias, void* __restrict__ out, int n_q,
    long long n_rows, int d, int pool, int n_qblocks) {
  using T = Tile;
  constexpr int kStages = T::kStages;
  constexpr int kAhead = kStages - 1;   // stages loaded ahead
  extern __shared__ __align__(128) uint8_t smem[];
  const long long span = kPooled ? max(pool, T::kBM) : T::kBM;
  const neumann::BlockPos bp =
      neumann::block_pos(n_qblocks, T::kBN, span, n_rows);
  const int lane = threadIdx.x % 32;
  const int m_base = threadIdx.x / 32 * 16;   // the warp's rows

  float* qm_s = reinterpret_cast<float*>(smem + kStages * T::kStageBytes);
  for (int i = threadIdx.x; i < T::kBN; i += kThreads) {
    qm_s[i] = bp.q0 + i < n_q ? q_mult[bp.q0 + i] : 0.f;
  }
  neumann::PoolTable table;
  if (kPooled) {
    table.init(reinterpret_cast<int*>(qm_s + T::kBN), T::kBN,
               static_cast<int>(span), bp.span0, pool);
  }

  const int k_steps = (d + T::kBK - 1) / T::kBK;
  const int n_tiles =
      static_cast<int>((bp.span1 - bp.span0 + T::kBM - 1) / T::kBM);
  const int iters = n_tiles * k_steps;
  auto issue = [&](int it) {
    if (it < iters) {
      const int tile = it / k_steps;
      load_stage(smem + (it % kStages) * T::kStageBytes, cq, qq,
                 bp.span0 + static_cast<long long>(tile) * T::kBM, bp.span1,
                 bp.q0, n_q, d, (it % k_steps) * T::kBK);
    }
    cp_async_commit();   // an empty group keeps the wait counts aligned
  };
#pragma unroll
  for (int s = 0; s < kAhead; ++s) issue(s);

  int acc[1][4];
  TileRows rows;
  for (int it = 0; it < iters; ++it) {
    cp_async_wait<kAhead - 1>();
    __syncthreads();   // stage `it` landed; stage it - 1 is free again
    issue(it + kAhead);
    const int kt = it % k_steps;
    if (kt == 0) {
      rows = tile_rows(
          bp.span0 + static_cast<long long>(it / k_steps) * T::kBM + m_base,
          bp.span1, row_mult, bias);
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[0][v] = 0;
    }
    const uint8_t* sa = smem + (it % kStages) * T::kStageBytes;
    const uint8_t* sb = sa + T::kBM * T::kBK;
#pragma unroll
    for (int ks = 0; ks < T::kBK / 32; ++ks) {
      unsigned a[4];
      unsigned b[2];
      ldsm_x4(a, sa + T::swz(m_base + (lane & 7) + ((lane >> 3) & 1) * 8,
                             2 * ks + (lane >> 4)));
      ldsm_x2(b, sb + T::swz(lane & 7, 2 * ks + ((lane >> 3) & 1)));
      mma_s8(acc[0], a, b);
    }
    if (kt != k_steps - 1) continue;
    tile_epilogue<1, kPooled>(acc, rows, bp.span1, bp.q0, qm_s, out, n_q,
                               n_rows, pool, table);
  }
  cp_async_wait<0>();
  if (kPooled) {
    __syncthreads();
    table.store(static_cast<int32_t*>(out), bp.q0,
                min(T::kBN, n_q - bp.q0), n_rows / pool);
  }
}

// One step of a butterfly max over lanes `kLane` apart: the lane keeps
// one half of its kN values and sends the other to its partner, so after
// the step v[0 .. kN / 2 - 1] hold maxima of the half the lane keeps.
template <int kN, int kLane, int kSize>
__device__ __forceinline__ void butterfly_step(int (&v)[kSize]) {
  const bool upper = threadIdx.x & kLane;
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) {
    const int send = upper ? v[i] : v[i + kN / 2];
    const int keep = upper ? v[i + kN / 2] : v[i];
    v[i] = max(keep, __shfl_xor_sync(0xffffffffu, send, kLane));
  }
}

// The pooled epilogue of one warp's 16 rows x 128 queries of the wgmma
// accumulator (d[nt][2 h + e]: row rows.row0 + 8 h + g, query 8 nt + 2 t +
// e). A lane first packs and folds its rows of one pool, a quarter of the
// queries (4 nt) at a time, giving 8 values (nt, e); the 8 lanes g that
// share them then fold with a 3-step butterfly (xor 16, 8, 4: 7 shuffles
// instead of 24), after which each lane holds the maximum of one of the 8
// and folds it into the table: all 32 lanes at once, at distinct
// queries. Pools of 8 rows split the lane's rows in two (h), and take one
// butterfly each.
__device__ __forceinline__ void wg_pooled_epilogue(
    const int (&d)[16][4], const TileRows& rows, long long span1,
    const float* qm_s, int pool, neumann::PoolTable& table) {
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int keep_low = ~(pool - 1);
  int low[2];
  bool live[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long n = rows.row0 + 8 * h + g;
    low[h] = static_cast<int>(n & (pool - 1));
    live[h] = n < span1;
  }
  // the value a lane ends with: (nt, e) = (4 quarter + idx / 2, idx % 2)
  // for idx from the lane's bits 4, 3, 2
  const int idx = ((lane >> 4) & 1) * 4 + ((lane >> 3) & 1) * 2 +
                  ((lane >> 2) & 1);
  const int groups = pool == 8 ? 2 : 1;
  for (int grp = 0; grp < groups; ++grp) {
#pragma unroll
    for (int quarter = 0; quarter < 4; ++quarter) {
      int v[8];
#pragma unroll
      for (int n4 = 0; n4 < 4; ++n4) {
        const int nt = 4 * quarter + n4;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float qm = qm_s[nt * 8 + 2 * t + e];
          int folded = INT_MIN;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (groups == 2 && h != grp) continue;
            const float a = __fmul_rn(__int2float_rn(d[nt][2 * h + e]), qm);
            const float sc = __fmaf_rn(a, rows.rm[h], rows.bias[h]);
            const int bits = (__float_as_int(sc) & keep_low) | low[h];
            folded = max(folded, live[h] ? bits : INT_MIN);
          }
          v[n4 * 2 + e] = folded;
        }
      }
      butterfly_step<8, 16>(v);
      butterfly_step<4, 8>(v);
      butterfly_step<2, 4>(v);
      table.add((4 * quarter + (idx >> 1)) * 8 + 2 * t + (idx & 1),
                rows.row0 + 8 * grp, v[0]);
    }
  }
}

// Batches above 16 queries: a block of two consumer warpgroups and one
// producer warp over 128 corpus rows x 128 queries. The producer warp's
// first thread loads each stage's corpus tile and query tile with TMA
// (the tensor maps zero-fill rows, queries and K past the end, and write
// the 128-byte swizzle wgmma reads) into a ring of kTmaStages, signalled
// by a `full` mbarrier per stage. Each consumer warpgroup runs
// wgmma.m64n128k32 on 64 of the rows straight from shared memory, keeps
// one stage's products in flight, and hands a stage back through its
// `empty` mbarrier. No __syncthreads in the loop: loads and products
// overlap across stages.
constexpr int kTmaStages = 3;   // 3 x 32 KB: two blocks a SM
constexpr int kTmaBK = 128;                       // K bytes a stage
constexpr int kTmaTile = 128 * kTmaBK;            // one 128-row tile
constexpr int kTmaThreads = 288;   // 8 consumer warps + 1 producer warp
constexpr int kTmaConsumers = 256;

template <bool kPooled>
__global__ void __launch_bounds__(kTmaThreads, 2) int8_tma_kernel(
    const __grid_constant__ CUtensorMap corpus_map,
    const __grid_constant__ CUtensorMap query_map,
    const float* __restrict__ q_mult, const float* __restrict__ row_mult,
    const float* __restrict__ bias, void* __restrict__ out, int n_q,
    long long n_rows, int d, int pool, int n_qblocks) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // the swizzle is a function of the shared address: stages start on
  // 1,024-byte boundaries (the launch adds the slack)
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      smem + kTmaStages * 2 * kTmaTile);
  uint64_t* empty = full + kTmaStages;
  float* qm_s = reinterpret_cast<float*>(empty + kTmaStages);
  int* table_s = reinterpret_cast<int*>(qm_s + 128);
  const long long span = kPooled ? max(pool, 128) : 128;
  const neumann::BlockPos bp = neumann::block_pos(n_qblocks, 128, span,
                                                  n_rows);
  for (int i = threadIdx.x; i < 128; i += kTmaThreads) {
    qm_s[i] = bp.q0 + i < n_q ? q_mult[bp.q0 + i] : 0.f;
  }
  neumann::PoolTable table;
  if (kPooled) table.init(table_s, 128, static_cast<int>(span), bp.span0, pool);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kTmaStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);    // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int k_steps = (d + kTmaBK - 1) / kTmaBK;
  const int iters =
      static_cast<int>((bp.span1 - bp.span0 + 127) / 128) * k_steps;

  if (threadIdx.x >= kTmaConsumers) {   // producer warp: one thread issues
    if (threadIdx.x == kTmaConsumers) {
      for (int it = 0; it < iters; ++it) {
        const int s = it % kTmaStages;
        mbar_wait(&empty[s], ((it / kTmaStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * kTmaTile);
        const int k0 = (it % k_steps) * kTmaBK;
        uint8_t* stage = smem + s * 2 * kTmaTile;
        tma_load_2d(stage, &corpus_map, k0,
                    static_cast<int>(bp.span0 + (it / k_steps) * 128),
                    &full[s]);
        tma_load_2d(stage + kTmaTile, &query_map, k0, bp.q0, &full[s]);
      }
    }
    return;
  }

  const int wg = threadIdx.x / 128;              // consumer 0 or 1
  const int warp = threadIdx.x / 32;             // 0..7: rows 16 warp ..
  int acc[16][4];
  TileRows rows;
  int held = -1;   // stage whose products may still be running
  for (int it = 0; it < iters; ++it) {
    const int s = it % kTmaStages;
    const int kt = it % k_steps;
    if (kt == 0) {
      rows = tile_rows(
          bp.span0 + static_cast<long long>(it / k_steps) * 128 + warp * 16,
          bp.span1, row_mult, bias);
      // the first product overwrites acc; zeroing it here ends the last
      // tile's values at the epilogue, so they hold no registers past it
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) {
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[nt][v] = 0;
      }
    }
    mbar_wait(&full[s], (it / kTmaStages) & 1);
    const uint8_t* stage = smem + s * 2 * kTmaTile;
    const uint64_t da = gmma_desc(stage + wg * 64 * kTmaBK);
    const uint64_t db = gmma_desc(stage + kTmaTile);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kTmaBK / 32; ++ks) {
      // 32 K bytes a step: the descriptors advance by 2 x 16 bytes
      wgmma_m64n128k32(acc, da + 2 * ks, db + 2 * ks, kt > 0 || ks > 0);
    }
    wgmma_commit();
    const bool last = kt == k_steps - 1;
    if (last) {
      wgmma_wait<0>();   // the epilogue reads acc
    } else {
      wgmma_wait<1>();   // the previous stage's products are done
    }
    if (threadIdx.x % 128 == 0) {
      if (held >= 0) mbar_arrive(&empty[held]);
      if (last) mbar_arrive(&empty[s]);
    }
    held = last ? -1 : s;
    if (last) {
      if constexpr (kPooled) {
        wg_pooled_epilogue(acc, rows, bp.span1, qm_s, pool, table);
      } else {
        tile_epilogue<16, false>(acc, rows, bp.span1, bp.q0, qm_s, out, n_q,
                                 n_rows, pool, table);
      }
    }
  }
  if (kPooled) {
    // the consumers' table is complete: named barrier 1 over 256 threads
    asm volatile("bar.sync 1, %0;\n" ::"n"(kTmaConsumers) : "memory");
    table.store(static_cast<int32_t*>(out), bp.q0, min(128, n_q - bp.q0),
                n_rows / pool, 0, kTmaConsumers);
  }
}

// a 2-D tensor map of an [rows, d] int8 matrix, boxes of 128 K bytes x
// 128 rows, 128-byte swizzle, zero fill past the ends
int make_map(CUtensorMap* map, const void* base, long long rows, int d) {
  return neumann::encode_map_2d(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, base, d,
                                rows, d, kTmaBK, 128,
                                CU_TENSOR_MAP_SWIZZLE_128B);
}

template <bool kPooled>
int launch_tma(const void* qq, const void* cq, const void* q_mult,
               const void* row_mult, const void* bias, void* out, int n_q,
               long long n_rows, int d, int pool, cudaStream_t stream) {
  CUtensorMap corpus_map;
  CUtensorMap query_map;
  int err = make_map(&corpus_map, cq, n_rows, d);
  if (err == 0) err = make_map(&query_map, qq, n_q, d);
  if (err != 0) return err;
  const long long span = kPooled ? (pool > 128 ? pool : 128) : 128;
  const int smem = 1024 + kTmaStages * 2 * kTmaTile +
                   2 * kTmaStages * 8 + 128 * 4 +
                   (kPooled ? 128 * (128 / neumann::kMinPool) * 4 : 0);
  auto kernel = int8_tma_kernel<kPooled>;
  const cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (set != cudaSuccess) return static_cast<int>(set);
  kernel<<<neumann::grid_blocks(n_rows, span, n_q, 128), kTmaThreads, smem,
           stream>>>(corpus_map, query_map,
                     static_cast<const float*>(q_mult),
                     static_cast<const float*>(row_mult),
                     static_cast<const float*>(bias), out, n_q, n_rows, d,
                     pool, (n_q + 127) / 128);
  return static_cast<int>(cudaGetLastError());
}

template <bool kPooled>
int launch(const void* qq, const void* cq, const void* q_mult,
           const void* row_mult, const void* bias, void* out, int n_q,
           long long n_rows, int d, int pool, cudaStream_t stream) {
  using T = Tile;
  const long long span = kPooled ? (pool > T::kBM ? pool : T::kBM) : T::kBM;
  const int smem = T::kStages * T::kStageBytes + T::kBN * 4 +
                   (kPooled ? T::kBN * T::kMaxSlots * 4 : 0);
  auto kernel = int8_kernel<kPooled>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qblocks = (n_q + T::kBN - 1) / T::kBN;
  kernel<<<neumann::grid_blocks(n_rows, span, n_q, T::kBN), kThreads, smem,
           stream>>>(static_cast<const int8_t*>(qq),
                     static_cast<const int8_t*>(cq),
                     static_cast<const float*>(q_mult),
                     static_cast<const float*>(row_mult),
                     static_cast<const float*>(bias), out, n_q, n_rows, d,
                     pool, n_qblocks);
  return static_cast<int>(cudaGetLastError());
}

// the block's query width follows the batch: 8 on mma.sync (the single
// queries of the search routes), else 128 on wgmma
template <bool kPooled>
int dispatch(const void* qq, const void* cq, const void* q_mult,
             const void* row_mult, const void* bias, void* out, int n_q,
             long long n_rows, int d, int pool, cudaStream_t s) {
  if (n_q <= 8) {
    return launch<kPooled>(qq, cq, q_mult, row_mult, bias, out, n_q, n_rows,
                           d, pool, s);
  }
  return launch_tma<kPooled>(qq, cq, q_mult, row_mult, bias, out, n_q,
                             n_rows, d, pool, s);
}

}  // namespace

// qq [Q, d] int8, cq [N, d] int8, q_mult [Q] f32, row_mult [N] f32 ->
// out [Q, N] f32. d % 64 == 0, pointers 16-byte aligned (the wrapper
// checks). Returns the launch's CUDA error code (0 on success).
extern "C" int neumann_int8_dot_scores(const void* qq, const void* cq,
                                       const void* q_mult,
                                       const void* row_mult, void* out,
                                       int n_q, long long n_rows, int d,
                                       void* stream) {
  return dispatch<false>(qq, cq, q_mult, row_mult, nullptr, out, n_q, n_rows,
                         d, 0, static_cast<cudaStream_t>(stream));
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
  return dispatch<true>(qq, cq, q_mult, row_mult, bias, out, n_q, n_rows, d,
                        pool, static_cast<cudaStream_t>(stream));
}
