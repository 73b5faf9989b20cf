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
// Why not the tensor cores: TF32 keeps 10 mantissa bits and the packed
// bits at pool 512 keep 14, so TF32 would move winners; 3xTF32 would
// change the numbers too and needs its own tolerance.
//
// What bounds it on an H100. At Q = 1,024 against 1,048,576 x 768 rows
// the scan is 1.65e12 FLOP over 3.2 GB of corpus (500 FLOP per byte), far
// above the card's f32 balance point (67 TFLOP/s over 3.35 TB/s, 20
// FLOP/byte): the FFMA pipe is the limit, 24.6 ms. At a few queries
// (Q <= 16) the 3.2 GB corpus read is the limit (0.96 ms).
//
// The designs, by batch:
// * Q > 16 (`batch_kernel`): 128 corpus rows x 128 queries a block, an
//   8 x 8 register tile a thread. Tiles are stored transposed, K-major
//   ([k][row], [k][query]), so one k of a thread's 8 rows and 8 queries is
//   4 float4 reads (LDS.128) feeding 64 FMA. The transpose happens on the
//   way in: the next step's tiles are read from device memory into
//   registers while this step computes, then stored transposed into the
//   other of two buffers. What held the FFMAs back here was the
//   block-wide wait between steps, not the shared-memory reads: a step
//   is 32 K floats (two 16-float parts through registers), one
//   __syncthreads for 2,048 FMA a thread; 8- and 16-float steps and an
//   8 x 16 tile at one block a SM ran slower.
// * Q <= 16 (`stream_kernel`): the corpus read is the limit, so a block
//   streams 256 rows through a 3-stage cp.async ring (32 K floats a
//   stage, one __syncthreads each) with 16-byte asynchronous loads, each
//   thread one row against every query (8 or 16 accumulators). Tiles stay
//   K-contiguous as they lie in device memory; a thread reads 4
//   consecutive K of its row as one float4, and the 16-byte chunks of a
//   row are XOR-swizzled by the row, so 8 consecutive rows at one K hit 8
//   different bank groups; the queries' float4 loads are broadcasts.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "pooled_bits.cuh"

namespace {

using neumann::cp_async16;
using neumann::cp_async_commit;
using neumann::cp_async_wait;
using neumann::kThreads;

constexpr int kBK = 32;      // floats of K per stage (8 chunks of 16 bytes)
constexpr int kStages = 3;

// float offset of 16-byte chunk c (0..7) of row r in a [rows][32] float
// tile: the chunk is XORed with the row's low bits, so 8 consecutive rows
// at one logical chunk land in 8 different 16-byte bank groups
__device__ __forceinline__ int swz(int r, int c) {
  return r * kBK + ((c ^ (r & 7)) << 2);
}

// rows [row0, row_end) x K floats k0 .. k0 + kBK - 1 of a [*, d] matrix
// into a [n][kBK] tile; rows past row_end and K past d read as zero
template <int kRows>
__device__ __forceinline__ void load_tile(float* s, const float* m,
                                          long long row0, long long row_end,
                                          int d, int k0) {
  for (int idx = threadIdx.x; idx < kRows * 8; idx += kThreads) {
    const int r = idx >> 3;
    const int c = idx & 7;
    const long long n = row0 + r;
    const bool ok = n < row_end && k0 + 4 * c < d;
    cp_async16(s + swz(r, c), ok ? m + n * d + k0 + 4 * c : m, ok);
  }
}

// the ring over the block's flat (tile, k) sequence; stage(it, smem) loads
// iteration `it`, compute(it, smem) consumes it
template <int kStageFloats, class Load, class Compute>
__device__ __forceinline__ void pipeline(float* smem, int iters, Load load,
                                         Compute compute) {
  auto issue = [&](int it) {
    if (it < iters) load(it, smem + (it % kStages) * kStageFloats);
    cp_async_commit();   // an empty group keeps the wait counts aligned
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  for (int it = 0; it < iters; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // stage `it` landed; stage it - 1 is free again
    issue(it + kStages - 1);
    compute(it, smem + (it % kStages) * kStageFloats);
  }
  cp_async_wait<0>();
}

// 256 rows x kNQ queries a block; thread t owns row t against every query
template <int kNQ>
__global__ void __launch_bounds__(kThreads, 2) stream_kernel(
    const float* __restrict__ x, const float* __restrict__ c,
    const float* __restrict__ q_mult, const float* __restrict__ row_mult,
    const float* __restrict__ bias, int32_t* __restrict__ out, int n_q,
    long long n_rows, int d, int pool, int n_qblocks) {
  constexpr int kBM = kThreads;
  constexpr int kStageFloats = (kBM + kNQ) * kBK;
  extern __shared__ __align__(128) float smem[];
  const long long span = max(pool, kBM);
  const neumann::BlockPos bp = neumann::block_pos(n_qblocks, kNQ, span,
                                                  n_rows);
  neumann::PoolTable table;
  table.init(reinterpret_cast<int*>(smem + kStages * kStageFloats), kNQ,
             static_cast<int>(span), bp.span0, pool);
  const int k_steps = (d + kBK - 1) / kBK;
  const int n_tiles = static_cast<int>((bp.span1 - bp.span0 + kBM - 1) / kBM);
  const int width = min(pool, 32);
  const int lane = threadIdx.x % 32;
  float acc[kNQ];

  auto load = [&](int it, float* s) {
    const long long row0 =
        bp.span0 + static_cast<long long>(it / k_steps) * kBM;
    const int k0 = (it % k_steps) * kBK;
    load_tile<kBM>(s, c, row0, bp.span1, d, k0);
    load_tile<kNQ>(s + kBM * kBK, x, bp.q0, n_q, d, k0);
  };
  auto compute = [&](int it, const float* s) {
    const int kt = it % k_steps;
    if (kt == 0) {
#pragma unroll
      for (int j = 0; j < kNQ; ++j) acc[j] = 0.f;
    }
    const float* sb = s + kBM * kBK;
#pragma unroll
    for (int ch = 0; ch < kBK / 4; ++ch) {
      const float4 a =
          *reinterpret_cast<const float4*>(s + swz(threadIdx.x, ch));
#pragma unroll
      for (int j = 0; j < kNQ; ++j) {
        const float4 b = *reinterpret_cast<const float4*>(sb + swz(j, ch));
        acc[j] = __fmaf_rn(a.x, b.x, acc[j]);
        acc[j] = __fmaf_rn(a.y, b.y, acc[j]);
        acc[j] = __fmaf_rn(a.z, b.z, acc[j]);
        acc[j] = __fmaf_rn(a.w, b.w, acc[j]);
      }
    }
    if (kt != k_steps - 1) return;
    const long long n =
        bp.span0 + static_cast<long long>(it / k_steps) * kBM + threadIdx.x;
    const bool live = n < bp.span1;
    const float rm = live ? row_mult[n] : 0.f;
    const float bi = live ? bias[n] : 0.f;
#pragma unroll
    for (int j = 0; j < kNQ; ++j) {
      const int q = bp.q0 + j;
      int bits = live ? neumann::pack_pool_bits(
                            __fmul_rn(acc[j], q < n_q ? q_mult[q] : 0.f), rm,
                            bi, n, pool)
                      : INT_MIN;
      bits = neumann::group_max(bits, width);
      if (lane % width == 0 && live) table.add(j, n, bits);
    }
  };
  pipeline<kStageFloats>(smem, n_tiles * k_steps, load, compute);
  __syncthreads();
  table.store(out, bp.q0, min(kNQ, n_q - bp.q0), n_rows / pool);
}

// Batches above 16 queries (`batch_kernel`): 128 rows x 128 queries a
// block, K kOBK floats a step. Tiles are stored transposed ([k][row],
// [k][query]), so a thread reads its 8 rows and 8 queries at one k as 4
// float4 (LDS.128) and does 64 FMA. Each 16-float part of the next step's
// tiles is read from device memory into registers while the matching
// part of this step computes, then stored transposed into the other of
// two buffers: one __syncthreads a step. Thread (tx, ty) = (t % 16,
// t / 16) owns rows 4 ty + {0..3} and 64 + 4 ty + {0..3}, queries
// 4 tx + {0..3} and 64 + 4 tx + {0..3}.
constexpr int kOBK = 32;              // K floats a step
constexpr int kOPart = 16;            // K floats staged through registers
constexpr int kOPad = 128 + 4;        // a transposed row: the stores of k
                                      // and k + 4 land 16 banks apart
constexpr int kOTile = kOBK * kOPad;  // floats of one transposed tile

__global__ void __launch_bounds__(kThreads, 2) batch_kernel(
    const float* __restrict__ x, const float* __restrict__ c,
    const float* __restrict__ q_mult, const float* __restrict__ row_mult,
    const float* __restrict__ bias, int32_t* __restrict__ out, int n_q,
    long long n_rows, int d, int pool, int n_qblocks) {
  constexpr int kB = 128;   // rows and queries a block
  extern __shared__ __align__(128) float smem[];   // [2 buffers][sa, sb]
  const long long span = max(pool, kB);
  const neumann::BlockPos bp = neumann::block_pos(n_qblocks, kB, span,
                                                  n_rows);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  neumann::PoolTable table;
  table.init(reinterpret_cast<int*>(smem + 4 * kOTile), kB,
             static_cast<int>(span), bp.span0, pool);

  // the loader: thread t copies K floats 4 (t % 2) + 8 u .. + 3 (u < 2)
  // of a part, of row t / 2 and of query t / 2
  const int lr = threadIdx.x >> 1;
  const int lk = (threadIdx.x & 1) * 4;
  const bool q_ok = bp.q0 + lr < n_q;
  const float* q_src =
      x + static_cast<long long>(q_ok ? bp.q0 + lr : 0) * d + lk;
  const int k_steps = (d + kOBK - 1) / kOBK;
  const int n_tiles = static_cast<int>((bp.span1 - bp.span0 + kB - 1) / kB);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 va[2];
  float4 vb[2];
  const float* c_src = nullptr;   // row lr of the tile being fetched
  auto aim = [&](int tile) {
    const long long n = bp.span0 + static_cast<long long>(tile) * kB + lr;
    c_src = n < bp.span1 ? c + n * d + lk : nullptr;
  };
  auto fetch = [&](int k0) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      // d is a multiple of 16, so only steps wider than 16 pass its end
      const bool in_d = kOBK == kOPart || k0 + 8 * u + lk < d;
      va[u] = c_src != nullptr && in_d
                  ? __ldcg(reinterpret_cast<const float4*>(c_src + k0 + 8 * u))
                  : zero;
      vb[u] = q_ok && in_d
                  ? __ldcg(reinterpret_cast<const float4*>(q_src + k0 + 8 * u))
                  : zero;
    }
  };
  auto put = [&](int buf, int kp) {
    float* sa = smem + 2 * buf * kOTile;
    float* sb = sa + kOTile;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int k = kp + 8 * u + lk;
      sa[(k + 0) * kOPad + lr] = va[u].x;
      sa[(k + 1) * kOPad + lr] = va[u].y;
      sa[(k + 2) * kOPad + lr] = va[u].z;
      sa[(k + 3) * kOPad + lr] = va[u].w;
      sb[(k + 0) * kOPad + lr] = vb[u].x;
      sb[(k + 1) * kOPad + lr] = vb[u].y;
      sb[(k + 2) * kOPad + lr] = vb[u].z;
      sb[(k + 3) * kOPad + lr] = vb[u].w;
    }
  };

  aim(0);
#pragma unroll
  for (int kp = 0; kp < kOBK; kp += kOPart) {
    fetch(kp);
    put(0, kp);
  }
  __syncthreads();
  float acc[8][8];
  int buf = 0;
  for (int tile = 0; tile < n_tiles; ++tile) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    }
    for (int kt = 0; kt < k_steps; ++kt) {
      const bool last_k = kt == k_steps - 1;
      const bool more = !last_k || tile + 1 < n_tiles;
      if (last_k && more) aim(tile + 1);
      const int k_next = last_k ? 0 : (kt + 1) * kOBK;
      const float* sa = smem + 2 * buf * kOTile;
      const float* sb = sa + kOTile;
#pragma unroll
      for (int kp = 0; kp < kOBK; kp += kOPart) {
        if (more) fetch(k_next + kp);
#pragma unroll
        for (int k = kp; k < kp + kOPart; ++k) {
          const float4 a0 =
              *reinterpret_cast<const float4*>(sa + k * kOPad + 4 * ty);
          const float4 a1 =
              *reinterpret_cast<const float4*>(sa + k * kOPad + 64 + 4 * ty);
          const float4 b0 =
              *reinterpret_cast<const float4*>(sb + k * kOPad + 4 * tx);
          const float4 b1 =
              *reinterpret_cast<const float4*>(sb + k * kOPad + 64 + 4 * tx);
          const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
          const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int i = 0; i < 8; ++i) {
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
            }
          }
        }
        if (more) put(buf ^ 1, kp);
      }
      __syncthreads();   // this step's reads done, the next step's stores seen
      buf ^= 1;
    }
    // epilogue: a thread's 4 consecutive rows lie in one pool (pools are
    // >= 8 rows and aligned); lanes ty and ty ^ 1 (lane ^ 16) hold the 8
    // rows of an aligned group, also in one pool
    const long long tile0 = bp.span0 + static_cast<long long>(tile) * kB;
    float rm[8];
    float bi[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const long long n = tile0 + (i / 4) * 64 + 4 * ty + i % 4;
      rm[i] = n < bp.span1 ? row_mult[n] : 0.f;
      bi[i] = n < bp.span1 ? bias[n] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int ql = (j / 4) * 64 + 4 * tx + j % 4;
      const float qm = bp.q0 + ql < n_q ? q_mult[bp.q0 + ql] : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int folded = INT_MIN;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 4 * h + r;
          const long long n = tile0 + h * 64 + 4 * ty + r;
          if (n < bp.span1) {
            folded = max(folded, neumann::pack_pool_bits(
                                     __fmul_rn(acc[i][j], qm), rm[i], bi[i],
                                     n, pool));
          }
        }
        folded = max(folded, __shfl_xor_sync(0xffffffffu, folded, 16));
        if (ty % 2 == 0) table.add(ql, tile0 + h * 64 + 8 * (ty / 2), folded);
      }
    }
  }
  __syncthreads();
  table.store(out, bp.q0, min(kB, n_q - bp.q0), n_rows / pool);
}

// dynamic shared memory of a block of bm rows x bn queries: its tiles
// (`tile_floats`), then its table of pool maxima
constexpr int block_smem(int bm, int bn, int tile_floats) {
  return tile_floats * 4 + bn * (bm / neumann::kMinPool) * 4;
}

template <class Kernel>
int launch(Kernel kernel, int bm, int bn, int smem, const void* x,
           const void* c, const void* q_mult, const void* row_mult,
           const void* bias, void* out, int n_q, long long n_rows, int d,
           int pool, cudaStream_t stream) {
  const long long span = pool > bm ? pool : bm;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<neumann::grid_blocks(n_rows, span, n_q, bn), kThreads, smem,
           stream>>>(static_cast<const float*>(x),
                     static_cast<const float*>(c),
                     static_cast<const float*>(q_mult),
                     static_cast<const float*>(row_mult),
                     static_cast<const float*>(bias),
                     static_cast<int32_t*>(out), n_q, n_rows, d, pool,
                     (n_q + bn - 1) / bn);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [Q, d] f32 queries, c [N, d] f32 corpus, q_mult [Q] f32, row_mult
// [N] f32, bias [N] f32 (2.0 live, -1e30 dead) -> out [Q, N / pool]
// int32 winner bits. pool a power of two in [8, 4096] dividing N,
// d % 16 == 0, pointers 16-byte aligned (the wrapper checks). Returns the
// launch's CUDA error code (0 on success).
extern "C" int neumann_f32_pooled_bits(const void* x, const void* c,
                                       const void* q_mult,
                                       const void* row_mult,
                                       const void* bias, void* out, int n_q,
                                       long long n_rows, int d, int pool,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the stream kernel holds kStages stages of 256 rows + kNQ queries of kBK
  // floats; the batch kernel two buffers of a transposed corpus and query
  // tile
  if (n_q <= 8) {
    return launch(stream_kernel<8>, kThreads, 8,
                  block_smem(kThreads, 8, kStages * (kThreads + 8) * kBK), x,
                  c, q_mult, row_mult, bias, out, n_q, n_rows, d, pool, s);
  }
  if (n_q <= 16) {
    return launch(stream_kernel<16>, kThreads, 16,
                  block_smem(kThreads, 16, kStages * (kThreads + 16) * kBK),
                  x, c, q_mult, row_mult, bias, out, n_q, n_rows, d, pool, s);
  }
  return launch(batch_kernel, 128, 128, block_smem(128, 128, 4 * kOTile), x,
                c, q_mult, row_mult, bias, out, n_q, n_rows, d, pool, s);
}
