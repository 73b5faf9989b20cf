// f32 pooled-bits scan: cosine winner bits of an f32 corpus.
//
// Replaces the XLA-fused pooled-bits step of `f32_pooled_topk`
// (neumann_tpu/ops/quant.py:525-539), which has no Pallas kernel on the
// TPU but would write the whole [Q, N] score matrix to device memory as
// a PyTorch matmul followed by a reduction. For query q and row n:
//   dot  = sum_k x[q, k] * c[n, k]      an f32 dot, summed in another
//                                       order than the JAX package's (so
//                                       dots differ in the last bits)
// then the pack / per-pool max epilogue of csrc/pooled_bits.cuh with
// a = dot * qmult[q], giving [Q, N / pool] int32 winner bits. Scores never
// reach device memory.
//
// The arithmetic, by batch.
// * Q <= 16 (`stream_kernel`): one FFMA per term, in K order.
// * Q > 16 (`tf32_kernel`): split TF32 products on the tensor cores
//   (3xTF32). Each f32 operand is split into two TF32 values, big =
//   rna(a) (round to nearest, ties away, to TF32's 10 mantissa bits) and
//   small = rna(a - big), the difference exact in f32; the tensor core
//   reads only a TF32's top 19 bits, so both must be rounded, and small
//   taken from the rounded big. Then
//     dot ~= small_c * big_x + big_c * small_x + big_c * big_x
//   (small_c * small_x, about 2^-22 of the product, is dropped); each
//   operand's residual is at most 2^-22 of it, so the products are within
//   3 * 2^-22 of sum |x_k c_k| of the f32 ones. Summation: a stage of 32 K
//   is summed by 12 wgmma (the small rows against big queries, then big
//   rows against small queries, then big against big, 4 K steps of 8
//   each) into a fresh accumulator; the stage is then added to the
//   running f32 sum by one rounded add. The tensor cores truncate as they
//   accumulate, so folding a stage at a time keeps that to a stage's
//   partial sums. The bound the note states and tests/test_torch_f32_split.py
//   holds: |dot - exact| <= 2^-18 * sum_k |x_k c_k|, about 3.8e-6 of a
//   cosine; B's recipe sees 2.8e-7 in the CPU emulation, one f32 pass
//   6.6e-7, one TF32 pass 7.8e-5 (scripts/torch_f32_split_error.py).
//   The order is the same for every (query, row), wherever the row falls
//   in a tile, a warp or a block and at every block width: equal rows
//   score bit-equal. Six bf16 products (hi, mid and lo of each operand)
//   would have the same 10.0 ms bound at twice the rate and twice the
//   products; the CPU emulation put both within the tolerance (bf16x6
//   1.7e-7), and 3xTF32 was taken for half the wgmma and half the split
//   work a stage.
//   The split needs no TF32 setting: torch.backends.cuda.matmul.allow_tf32
//   governs torch.matmul alone and stays False (neumann_tpu_torch/__init__).
//   Non-finite entries: an inf or NaN entry keeps its small part 0, so a
//   row holding one gives +-inf or NaN dots, as the FFMA kernel does, but
//   NaN also where an inf meets a query entry that TF32 holds exactly (a
//   small part 0: 0 * inf). Packed, +inf and NaN (positive, as the card
//   makes it) beat every finite score and -inf loses to every live one,
//   as in the plain version. Entries below 2^-126 (subnormal) may be
//   flushed by the tensor cores.
//
// What bounds it on an H100. At Q = 1,024 against 1,048,576 x 768 rows
// the scan is 3 x 1.65e12 FLOP on the TF32 tensor cores (10.0 ms at 495
// TFLOP/s; one FFMA pass was 24.6 ms at 67 TFLOP/s) against 3.2 GB of
// corpus (0.97 ms at 3.35 TB/s). At a few queries (Q <= 16) the corpus read
// is the limit (0.96 ms).
//
// The designs, by batch:
// * Q > 16 (`tf32_kernel`): rows on the wgmma's M side from registers,
//   queries on N from shared memory. A block is two warpgroups over tiles
//   of 128 rows (64 a warpgroup) x kNQ queries (32, 64 or 128 by Q,
//   _f32_block_queries in ops/kernels.py), walking a span of max(pool,
//   512) rows. Its first thread loads each stage by TMA, the row tile
//   [128][32 f32] and the query parts big and small [kNQ][32 f32] (the
//   wrapper's split, ops/kernels._f32_parts), all in the 128-byte swizzle,
//   into a ring of 4 stages signalled by full / empty mbarriers; it
//   refills a slot once both warpgroups' products on it are done. A
//   thread reads floats 8 t .. 8 t + 7 of its rows g and g + 8 (two
//   16-byte loads each, conflict-free in the swizzle) while the previous
//   stage's products run, and splits them into its big and small A
//   fragments once those products are done; the query parts hold K
//   permuted within each 32 so that the fragment's K places are the floats
//   the thread read. Epilogue: per (row, query) the pack, then the max
//   over a pool's rows in the thread's registers (rows g, g + 8), across
//   lanes (xor 4, 8, 16) and in the block's table (atomicMax).
// * Q <= 16 (`stream_kernel`): the corpus read is the limit, so a block
//   streams 256 rows through a 3-stage cp.async ring (32 K floats a
//   stage, one __syncthreads each) with 16-byte asynchronous loads, each
//   thread one row against every query (8 or 16 accumulators). Tiles stay
//   K-contiguous as they lie in device memory; a thread reads 4
//   consecutive K of its row as one float4, and the 16-byte chunks of a
//   row are XOR-swizzled by the row, so 8 consecutive rows at one K hit 8
//   different bank groups; the queries' float4 loads are broadcasts. Rows
//   narrower than 32 floats take it at any Q.
//
// Measured: see PERF.md row 6 (chip_smoke.py phase 2,
// scripts/torch_f32_pooled_ab.py).

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "hopper.cuh"
#include "pooled_bits.cuh"

namespace {

using neumann::cp_async16;
using neumann::cp_async_commit;
using neumann::cp_async_wait;
using neumann::gmma_desc;
using neumann::kThreads;
using neumann::mbar_arrive;
using neumann::mbar_arrive_expect_tx;
using neumann::mbar_init;
using neumann::mbar_wait;
using neumann::smem_u32;
using neumann::tma_load_2d;
using neumann::wgmma_commit;
using neumann::wgmma_fence;
using neumann::wgmma_wait;

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

// Batches above 16 queries (`tf32_kernel`): split TF32 products on wgmma.
constexpr int kWK = 32;                      // K floats a stage (128 bytes)
constexpr int kWRows = 128;                  // rows a tile, 64 a warpgroup
constexpr int kWStages = 4;                  // the ring
constexpr int kWSpan = 512;                  // rows a block walks, at least
constexpr int kWRowBytes = kWRows * kWK * 4;   // a stage's row tile
constexpr int kSmemMax = 232448;             // a block's shared memory

template <int kNQ>
struct WGeo {
  static constexpr int kPartBytes = kNQ * kWK * 4;   // one query part
  static constexpr int kStageBytes = kWRowBytes + 2 * kPartBytes;
  // the stages, their mbarriers, then the pool table (the most slots:
  // span / pool at pool 8); 1,024 bytes of slack align the stages
  static constexpr int kSmem = 1024 + kWStages * kStageBytes +
                               2 * kWStages * 8 +
                               kNQ * (kWSpan / neumann::kMinPool) * 4;
};
static_assert(WGeo<128>::kSmem <= kSmemMax, "a 128-query block");

// d (+)= a (64 rows x 8 K, TF32 from registers: the warp's m16k8 fragment,
// a0 row g K t, a1 row g + 8 K t, a2 row g K t + 4, a3 row g + 8 K t + 4)
// * b (8 K x N queries, TF32, K-major in shared memory, the 128-byte
// swizzle), f32 accumulators, asynchronous; scale_d 0 overwrites d.
// d[4 j + v]: row g + 8 (v >> 1) of the warp's 16, query 8 j + 2 t +
// (v & 1).
__device__ __forceinline__ void wgmma_tf32_n32(float (&d)[16],
                                               const unsigned (&a)[4],
                                               uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// as wgmma_tf32_n32, 64 queries
__device__ __forceinline__ void wgmma_tf32_n64(float (&d)[32],
                                               const unsigned (&a)[4],
                                               uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// as wgmma_tf32_n32, 128 queries
__device__ __forceinline__ void wgmma_tf32_n128(float (&d)[64],
                                                const unsigned (&a)[4],
                                                uint64_t desc_b,
                                                int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

template <int kNQ>
__device__ __forceinline__ void wgmma_tf32(float (&d)[kNQ / 2],
                                           const unsigned (&a)[4],
                                           uint64_t desc_b, int scale_d) {
  if constexpr (kNQ == 32) {
    wgmma_tf32_n32(d, a, desc_b, scale_d);
  } else if constexpr (kNQ == 64) {
    wgmma_tf32_n64(d, a, desc_b, scale_d);
  } else {
    wgmma_tf32_n128(d, a, desc_b, scale_d);
  }
}

// After a wgmma.wait_group: registers the products wrote (or read) are
// ready, and the compiler may move no use of them above this point.
template <int kN>
__device__ __forceinline__ void fence_regs(float (&r)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ void fence_regs(unsigned (&r)[4][4]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    asm volatile("" : "+r"(r[i / 4][i % 4])::"memory");
  }
}

// x as TF32 parts, as ops/kernels._tf32_split makes them: big = rna(x)
// (its low 13 bits zero), small = rna(x - big); an inf or NaN x keeps
// small 0, so its products follow IEEE rules through big alone
__device__ __forceinline__ void tf32_split(float x, unsigned& big,
                                           unsigned& small) {
  unsigned b;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(b) : "f"(x));
  big = b & 0xFFFFE000u;
  float rest = __fsub_rn(x, __uint_as_float(big));   // exact
  rest = rest == rest ? rest : 0.f;
  unsigned s;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(s) : "f"(rest));
  small = s & 0xFFFFE000u;
}

// Block (span, query block), the query block fastest: rows [span0, span1)
// in tiles of 128 against queries q0 .. q0 + kNQ - 1 of the padded qp. The
// part map is the [2 qp, ldq] f32 query parts (big, then small), each
// K-permuted (ops/kernels._f32_parts).
template <int kNQ>
__global__ void __launch_bounds__(kThreads, 1) tf32_kernel(
    const __grid_constant__ CUtensorMap row_map,
    const __grid_constant__ CUtensorMap part_map,
    const float* __restrict__ q_mult, const float* __restrict__ row_mult,
    const float* __restrict__ bias, int32_t* __restrict__ out, int n_q,
    int qp, long long n_rows, int d, int pool, int n_qblocks) {
  using G = WGeo<kNQ>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // the 128-byte swizzle is a function of the shared address: stages
  // start on 1,024-byte boundaries (the launch adds the slack)
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kWStages *
                                               G::kStageBytes);
  uint64_t* empty = full + kWStages;
  const long long span = max(pool, kWSpan);
  const neumann::BlockPos bp = neumann::block_pos(n_qblocks, kNQ, span,
                                                  n_rows);
  neumann::PoolTable table;
  table.init(reinterpret_cast<int*>(empty + kWStages), kNQ,
             static_cast<int>(span), bp.span0, pool);
  const int k_steps = (d + kWK - 1) / kWK;
  const int iters =
      static_cast<int>((bp.span1 - bp.span0 + kWRows - 1) / kWRows) *
      k_steps;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kWStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 2);   // one arrival a warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();   // the mbarriers and the table are in

  // thread 0 issues the loads: stage `it` into its ring slot by TMA, the
  // slot's full mbarrier counting the bytes (TMA fills zeros past d and
  // past the last row, and counts them)
  auto load = [&](int it) {
    const int st = it % kWStages;
    mbar_arrive_expect_tx(&full[st], G::kStageBytes);
    const int k0 = (it % k_steps) * kWK;
    uint8_t* stage = smem + st * G::kStageBytes;
    tma_load_2d(stage, &row_map, k0,
                static_cast<int>(bp.span0 + (it / k_steps) * kWRows),
                &full[st]);
    tma_load_2d(stage + kWRowBytes, &part_map, k0, bp.q0, &full[st]);
    tma_load_2d(stage + kWRowBytes + G::kPartBytes, &part_map, k0,
                qp + bp.q0, &full[st]);
  };
  if (threadIdx.x == 0) {
    for (int it = 0; it < min(iters, kWStages); ++it) load(it);
  }

  const int lane = threadIdx.x % 32;
  const int t = lane & 3;
  const int g = lane >> 2;
  // the thread's rows of a tile: r and r + 8 (r % 8 == g)
  const int r = 64 * (threadIdx.x / 128) + 16 * ((threadIdx.x / 32) % 4) + g;
  float acc[kNQ / 2];
  float sum[kNQ / 2];
  unsigned fb[4][4];   // the A fragments of a stage's 4 K steps: big
  unsigned fs[4][4];   // and small
  float raw[2][8];     // floats 8 t .. 8 t + 7 of rows r, r + 8

  // stage `it`, once it has landed: the thread's floats of its rows
  auto fetch = [&](int it) {
    const int st = it % kWStages;
    mbar_wait(&full[st], (it / kWStages) & 1);
    const uint8_t* rows = smem + st * G::kStageBytes;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        // [row][16-byte chunk] of a 128-byte row, the chunk XORed with
        // the row's low 3 bits (g) by the swizzle
        const float4 v = *reinterpret_cast<const float4*>(
            rows + (r + 8 * h) * 128 + (((2 * t + c) ^ g) << 4));
        raw[h][4 * c + 0] = v.x;
        raw[h][4 * c + 1] = v.y;
        raw[h][4 * c + 2] = v.z;
        raw[h][4 * c + 3] = v.w;
      }
    }
  };
  // the fetched floats as A fragments: K step j's K place t is float 2 j
  // of the thread's 8 and place t + 4 float 2 j + 1 (the query parts'
  // K permutation matches)
  auto split = [&]() {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        tf32_split(raw[v & 1][2 * j + (v >> 1)], fb[j][v], fs[j][v]);
      }
    }
  };
  // stage `it`'s 12 products, asynchronous, into a fresh accumulator
  auto issue = [&](int it) {
    const uint8_t* parts =
        smem + (it % kWStages) * G::kStageBytes + kWRowBytes;
    const uint64_t db = gmma_desc(parts);
    const uint64_t ds = gmma_desc(parts + G::kPartBytes);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wgmma_tf32<kNQ>(acc, fs[j], db + 2 * j, j);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wgmma_tf32<kNQ>(acc, fb[j], ds + 2 * j, 1);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wgmma_tf32<kNQ>(acc, fb[j], db + 2 * j, 1);
    }
    wgmma_commit();
  };
  // the stage added to the sums; at a tile's last stage the epilogue
  auto retire = [&](int it) {
    const int kt = it % k_steps;
#pragma unroll
    for (int i = 0; i < kNQ / 2; ++i) {
      sum[i] = kt == 0 ? acc[i] : __fadd_rn(sum[i], acc[i]);
    }
    if (kt != k_steps - 1) return;
    const long long n0 =
        bp.span0 + static_cast<long long>(it / k_steps) * kWRows + r;
    float rm[2];
    float bi[2];
    bool live[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      live[h] = n0 + 8 * h < bp.span1;
      rm[h] = live[h] ? row_mult[n0 + 8 * h] : 0.f;
      bi[h] = live[h] ? bias[n0 + 8 * h] : 0.f;
    }
    // rows g and g + 8 of a warp's 16 are 8 apart: one pool from 16 rows
    // up; the 8 lanes of one t hold rows 0-7 (and 8-15) of the 16
#pragma unroll
    for (int i = 0; i < kNQ / 4; ++i) {
      const int ql = 8 * (i / 2) + 2 * t + (i & 1);
      const float qm = bp.q0 + ql < n_q ? q_mult[bp.q0 + ql] : 0.f;
      int b[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        b[h] = live[h] ? neumann::pack_pool_bits(
                             __fmul_rn(sum[4 * (i / 2) + 2 * h + (i & 1)],
                                       qm),
                             rm[h], bi[h], n0 + 8 * h, pool)
                       : INT_MIN;
      }
      if (pool > 8) b[0] = max(b[0], b[1]);
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        b[0] = max(b[0], __shfl_xor_sync(0xffffffffu, b[0], off));
        if (pool == 8) {
          b[1] = max(b[1], __shfl_xor_sync(0xffffffffu, b[1], off));
        }
      }
      if (g == 0) {
        table.add(ql, n0, b[0]);
        if (pool == 8) table.add(ql, n0 + 8, b[1]);
      }
    }
  };

  // the next stage's floats are read while this stage's products run;
  // they are split once the products (which read the fragments) are done
  // (split into a second set of fragments while they run, the 128-query
  // kernel spilled and ran slower)
  fetch(0);
  split();
  for (int it = 0; it < iters; ++it) {
    issue(it);
    if (it + 1 < iters) fetch(it + 1);
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(fb);
    fence_regs(fs);
    // the products read the slot's query parts (and the rows were read
    // before they were issued): the slot goes back, and thread 0 refills
    // it once both warpgroups are done with it
    if (threadIdx.x % 128 == 0) mbar_arrive(&empty[it % kWStages]);
    if (threadIdx.x == 0 && it + kWStages < iters) {
      mbar_wait(&empty[it % kWStages], (it / kWStages) & 1);
      load(it + kWStages);
    }
    retire(it);
    if (it + 1 < iters) split();
  }
  __syncthreads();
  table.store(out, bp.q0, min(kNQ, n_q - bp.q0), n_rows / pool);
}

// dynamic shared memory of a stream block of 256 rows x bn queries: its
// ring, then its table of pool maxima
constexpr int stream_smem(int bn) {
  return kStages * (kThreads + bn) * kBK * 4 +
         bn * (kThreads / neumann::kMinPool) * 4;
}

template <int kNQ>
int launch_stream(const void* x, const void* c, const void* q_mult,
                  const void* row_mult, const void* bias, void* out, int n_q,
                  long long n_rows, int d, int pool, cudaStream_t stream) {
  const long long span = pool > kThreads ? pool : kThreads;
  auto kernel = stream_kernel<kNQ>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, stream_smem(kNQ));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<neumann::grid_blocks(n_rows, span, n_q, kNQ), kThreads,
           stream_smem(kNQ), stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(c),
      static_cast<const float*>(q_mult), static_cast<const float*>(row_mult),
      static_cast<const float*>(bias), static_cast<int32_t*>(out), n_q,
      n_rows, d, pool, (n_q + kNQ - 1) / kNQ);
  return static_cast<int>(cudaGetLastError());
}

template <int kNQ>
int launch_tf32(const void* parts, const void* c, const void* q_mult,
                const void* row_mult, const void* bias, void* out, int n_q,
                long long n_rows, int d, int ldq, int pool,
                cudaStream_t stream) {
  using G = WGeo<kNQ>;
  const int qp = (n_q + kNQ - 1) / kNQ * kNQ;
  CUtensorMap row_map;
  CUtensorMap part_map;
  int err = neumann::encode_map_2d(
      &row_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, c, d, n_rows, 4LL * d, kWK,
      kWRows, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == 0) {
    err = neumann::encode_map_2d(
        &part_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, parts, ldq, 2LL * qp,
        4LL * ldq, kWK, kNQ, CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (err != 0) return err;
  auto kernel = tf32_kernel<kNQ>;
  const cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
  if (set != cudaSuccess) return static_cast<int>(set);
  const long long span = pool > kWSpan ? pool : kWSpan;
  kernel<<<neumann::grid_blocks(n_rows, span, n_q, kNQ), kThreads, G::kSmem,
           stream>>>(row_map, part_map, static_cast<const float*>(q_mult),
                     static_cast<const float*>(row_mult),
                     static_cast<const float*>(bias),
                     static_cast<int32_t*>(out), n_q, qp, n_rows, d, pool,
                     qp / kNQ);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// c [N, d] f32 corpus, q_mult [Q] f32, row_mult [N] f32, bias [N] f32
// (2.0 live, -1e30 dead) -> out [Q, N / pool] int32 winner bits. pool a
// power of two in [8, 4096] dividing N, d % 16 == 0, N < 2^31, pointers
// 16-byte aligned (the wrapper checks). x, by Q and d (ops/kernels.py,
// _f32_block_queries): up to 16 queries, or rows narrower than 32 floats,
// the f32 queries [Q, d] (ldq == d), for the stream kernels; else the
// query parts [2, qp, ldq] f32 of ops/kernels._f32_parts (big, small; K
// permuted within each 32; zero past d and past Q), qp the least multiple
// of the block's queries (32 up to 32, 64 up to 64, else 128) >= Q, ldq
// the least multiple of 32 >= d. Returns the launch's CUDA error code
// (cudaErrorInvalidValue for arguments it does not take).
extern "C" int neumann_f32_pooled_bits(const void* x, const void* c,
                                       const void* q_mult,
                                       const void* row_mult,
                                       const void* bias, void* out, int n_q,
                                       long long n_rows, int d, int ldq,
                                       int pool, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool stream_route = n_q <= 16 || d < kWK;
  if (n_q < 1 || n_rows < 1 || n_rows >= (1LL << 31) || d < 16 || d % 16 ||
      pool < neumann::kMinPool || pool > 4096 || (pool & (pool - 1)) ||
      n_rows % pool || (stream_route ? ldq != d : ldq % kWK || ldq < d)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_q <= 8) {
    return launch_stream<8>(x, c, q_mult, row_mult, bias, out, n_q, n_rows,
                            d, pool, s);
  }
  if (stream_route) {
    return launch_stream<16>(x, c, q_mult, row_mult, bias, out, n_q, n_rows,
                             d, pool, s);
  }
  if (n_q <= 32) {
    return launch_tf32<32>(x, c, q_mult, row_mult, bias, out, n_q, n_rows, d,
                           ldq, pool, s);
  }
  if (n_q <= 64) {
    return launch_tf32<64>(x, c, q_mult, row_mult, bias, out, n_q, n_rows, d,
                           ldq, pool, s);
  }
  return launch_tf32<128>(x, c, q_mult, row_mult, bias, out, n_q, n_rows, d,
                          ldq, pool, s);
}
