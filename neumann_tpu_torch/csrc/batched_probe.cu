// Batched IVF first pass: every window of the corpus against the int8
// queries that probed it, reduced to packed pool winners in registers.
//
// Replaces the Pallas TPU kernel `_batched_probe_kernel(pool, top2)`,
// launched through `batched_probe_pallas` in
// neumann_tpu/ops/pallas_kernels.py. Same function, bit for bit: per
// window c and query slot q, for every window row w = a * 128 + b
// (member a of strided pool b),
//   dots = int8 qsel[c, q] . int8 buf[c * window + w]         (int32)
//   m    = scmult[c, q] * rm[c, w]                           (f32)
//   s    = fma(float(dots), m, 2.0)                          (f32)
//   s    = 0 where rm <= 0 (dead row)
//   bits = (bitcast<int32>(s) & ~(pool - 1)) | a
// and out[c, q, b] = max over a of bits; with top2 the pool's
// runner-up goes to out[c, q, 128 + b] (streaming top-2:
// m2 = max(m2, min(m1, x)); m1 = max(m1, x)).
//
// Rounding: the JAX kernel writes `dots * (mult * rm) + 2.0`, and XLA
// contracts the multiply-add into one fused multiply-add (measured on
// the CPU reference: bit-exact only with a single rounding). The
// kernel spells every step out — __fmul_rn for m, __fmaf_rn for s —
// so neither nvcc's contraction choice nor a compiler flag can change
// the packed bits.
//
// What bounds it on an H100: int8 operations. The corpus is read once
// per batch (3.2 GB at 4M x 768), but the dots are q_cap x window x d
// multiply-adds per window (~2e11 at a 1,024-query batch), which
// __dp4a (4 MACs per instruction, no tensor cores) turns into the
// kernel's cost. The design:
//   * one block per (window, tile of 16 query slots); its 128 threads
//     are the 128 strided pools, so each thread owns one pool and keeps
//     its running winners in registers — nothing but the packed winners
//     ever reaches device memory (the Pallas kernel's VMEM fusion);
//   * the tile's int8 queries are staged in shared memory and read as
//     broadcasts (every thread of a warp reads the same word);
//   * a tile whose 16 slots are all empty (scale 0) skips the dots: an
//     empty slot scores exactly 2.0 on every live row whatever its
//     dot, so the packed bits are unchanged;
//   * tiles of one window are adjacent in the grid, so the window's rows
//     are re-read from L2 rather than device memory.
// No tensor cores, no TMA: a simple kernel that is right comes first.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLanes = 128;    // strided pools per window = threads per block
constexpr int kTile = 16;      // query slots per block

__global__ void __launch_bounds__(kLanes) batched_probe_kernel(
    const int8_t* __restrict__ qsel, const int8_t* __restrict__ buf,
    const float* __restrict__ scmult, const float* __restrict__ rmult,
    int32_t* __restrict__ out, int q_cap, int d, int window, int top2) {
  extern __shared__ int4 q_s[];         // kTile * d int8 bytes
  __shared__ float sc_s[kTile];

  const int n_tiles = (q_cap + kTile - 1) / kTile;
  const long long c = blockIdx.x / n_tiles;
  const int s0 = (blockIdx.x % n_tiles) * kTile;
  const int nslot = min(kTile, q_cap - s0);
  const int b = threadIdx.x;            // the strided pool this thread owns
  const int nch = d / 16;
  const int pool = window / kLanes;
  const int low_mask = ~(pool - 1);
  const int lanes = top2 ? 2 * kLanes : kLanes;

  const int4* qsrc = reinterpret_cast<const int4*>(
      qsel + (c * q_cap + s0) * static_cast<long long>(d));
  for (int i = threadIdx.x; i < nslot * nch; i += kLanes) q_s[i] = qsrc[i];
  if (threadIdx.x < kTile) {
    sc_s[threadIdx.x] =
        threadIdx.x < nslot ? scmult[c * q_cap + s0 + threadIdx.x] : 0.f;
  }
  __syncthreads();
  bool live = false;
  for (int i = 0; i < nslot; ++i) live |= sc_s[i] != 0.f;

  int w1[kTile];
  int w2[kTile];
#pragma unroll
  for (int i = 0; i < kTile; ++i) {
    w1[i] = 0;
    w2[i] = 0;
  }

  for (int a = 0; a < pool; ++a) {
    const long long row = c * window + static_cast<long long>(a) * kLanes + b;
    const float rm = rmult[row];
    int acc[kTile];
#pragma unroll
    for (int i = 0; i < kTile; ++i) acc[i] = 0;
    if (live) {
      const int4* src = reinterpret_cast<const int4*>(buf + row * d);
      for (int ch = 0; ch < nch; ++ch) {
        const int4 v = src[ch];
#pragma unroll
        for (int i = 0; i < kTile; ++i) {
          const int4 qv = q_s[i * nch + ch];
          acc[i] = __dp4a(v.x, qv.x, acc[i]);
          acc[i] = __dp4a(v.y, qv.y, acc[i]);
          acc[i] = __dp4a(v.z, qv.z, acc[i]);
          acc[i] = __dp4a(v.w, qv.w, acc[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kTile; ++i) {
      float s = 0.f;
      if (rm > 0.f) {
        s = __fmaf_rn(__int2float_rn(acc[i]), __fmul_rn(sc_s[i], rm), 2.0f);
      }
      const int bits = (__float_as_int(s) & low_mask) | a;
      if (top2) w2[i] = max(w2[i], min(w1[i], bits));
      w1[i] = max(w1[i], bits);
    }
  }

  int32_t* o = out + (c * q_cap + s0) * static_cast<long long>(lanes);
#pragma unroll
  for (int i = 0; i < kTile; ++i) {
    if (i < nslot) {
      o[i * lanes + b] = w1[i];
      if (top2) o[i * lanes + kLanes + b] = w2[i];
    }
  }
}

}  // namespace

// qsel [C, q_cap, d] int8, buf [C * window, d] int8, scmult [C, q_cap]
// f32, rmult [C, window] f32 -> out [C, q_cap, top2 ? 256 : 128] int32.
// d % 16 == 0, d <= 3072, window a power-of-two multiple of 128, all
// pointers 16-byte aligned (the wrapper checks). Returns
// cudaGetLastError() after the launch.
extern "C" int neumann_batched_probe(
    const void* qsel, const void* buf, const void* scmult, const void* rmult,
    void* out, int n_windows, int q_cap, int d, int window, int top2,
    void* stream) {
  const int n_tiles = (q_cap + kTile - 1) / kTile;
  const long long blocks = static_cast<long long>(n_windows) * n_tiles;
  const size_t smem = static_cast<size_t>(kTile) * d;
  batched_probe_kernel<<<static_cast<unsigned>(blocks), kLanes, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(qsel), static_cast<const int8_t*>(buf),
      static_cast<const float*>(scmult), static_cast<const float*>(rmult),
      static_cast<int32_t*>(out), q_cap, d, window, top2);
  return static_cast<int>(cudaGetLastError());
}
