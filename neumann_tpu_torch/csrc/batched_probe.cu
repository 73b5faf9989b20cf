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
// What bounds it on an H100: bytes. The corpus is read once per batch
// (3.2 GB at 4,096 windows of 1,024 x 768), and the dots of the filled
// slots (about 20 of 64 a window) are ~1e11 int8 multiply-adds, 0.07 ms
// on the int8 tensor cores against ~1 ms for the bytes. The design:
//   * one block per window, owning all of its live query slots, so the
//     window's rows leave device memory once;
//   * the window is `pool` member tiles of 128 consecutive rows: rows go
//     on the M side of mma.sync.m16n8k32.s8 (8 warps x 16 rows) and
//     slots on N. Member tile a's accumulator holds member a of every
//     pool b at (row b, slot q), so the pool reduction is an elementwise
//     running max / top-2 across member tiles, in the accumulator's own
//     registers, with no shuffles;
//   * corpus rows stream through a 3-stage cp.async ring of 128 rows x
//     128 K bytes (128-byte swizzle, ldmatrix); up to d 3,072 the live
//     slots' queries are staged in shared memory once per window, zero
//     past d (64 slots a pass, 32 above d 1,536). Wider rows would not fit
//     there: above d 3,072 each ring stage also carries its K stage of the
//     pass's 64 queries, re-read from L2 for every member tile, so any d
//     runs in 72 KB;
//   * only live slots are computed: the query tables fill slots
//     0 .. count - 1 in order, so the block finds count from scmult and
//     runs ceil(count / 8) n8 tiles (64 slots a pass; q_cap beyond 64
//     takes more passes). An empty slot (scale 0) scores exactly 2.0 on
//     every live row whatever its dot, so slots from count on get those
//     bits without any product, and a window with no live slot runs no
//     MMA;
//   * the winners leave through shared memory, each slot row written as
//     consecutive 16-byte stores.

#include <cuda_runtime.h>

#include <cstdint>

#include "mma_s8.cuh"
#include "pooled_bits.cuh"

namespace {

using neumann::cp_async16;
using neumann::cp_async_commit;
using neumann::cp_async_wait;
using neumann::ldsm_x4;
using neumann::mma_s8;
using neumann::swz128;

constexpr int kLanes = 128;     // strided pools a window = rows a member tile
constexpr int kThreads = 256;   // 8 warps x 16 rows
constexpr int kBK = 128;        // K bytes a stage
constexpr int kStages = 3;
constexpr int kStageBytes = kLanes * kBK;
constexpr int kMaxSlots = 64;   // slots a pass: 8 n8 tiles
constexpr int kNT = kMaxSlots / 8;
constexpr int kHeader = 512;    // slot scales and the live count
constexpr int kMaxResidentDim = 3072;   // widest d with resident queries

template <bool kTop2>
__global__ void __launch_bounds__(kThreads, 2) batched_probe_kernel(
    const int8_t* __restrict__ qsel, const int8_t* __restrict__ buf,
    const float* __restrict__ scmult, const float* __restrict__ rmult,
    int32_t* __restrict__ out, int q_cap, int d, int window, int pass_slots,
    bool stream_q) {
  constexpr int kOut = kTop2 ? 2 * kLanes : kLanes;
  constexpr int kOutStride = kOut + 4;   // staged rows: 4 t lanes apart in bank
  extern __shared__ __align__(128) uint8_t smem[];
  float* sc_s = reinterpret_cast<float*>(smem);          // [kMaxSlots]
  int* count_s = reinterpret_cast<int*>(sc_s + kMaxSlots);
  // a ring stage: 128 corpus rows, then (stream_q) the pass's queries
  const int stage_bytes = kStageBytes + (stream_q ? pass_slots * kBK : 0);
  uint8_t* ring = smem + kHeader;
  uint8_t* qtile = ring + kStages * stage_bytes;   // [k_stage][slot][128]
  int* stage_out = reinterpret_cast<int*>(ring);    // after the last stage

  const long long c = blockIdx.x;
  const int pool = window / kLanes;
  const int low_mask = ~(pool - 1);
  const int k_stages = (d + kBK - 1) / kBK;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int m_base = threadIdx.x / 32 * 16;
  const float* sc = scmult + c * q_cap;
  const float* rm_c = rmult + c * window;

  // live count: one past the last slot with a non-zero scale
  if (threadIdx.x == 0) *count_s = 0;
  __syncthreads();
  int last = 0;
  for (int i = threadIdx.x; i < q_cap; i += kThreads) {
    if (sc[i] != 0.f) last = i + 1;
  }
  last = __reduce_max_sync(0xffffffffu, last);
  if (lane == 0 && last > 0) atomicMax(count_s, last);
  __syncthreads();
  const int count = *count_s;

  // slots from count on: the bits of a zero scale, 2.0 on live rows
  if (count < q_cap && threadIdx.x < kLanes) {
    const int b = threadIdx.x;
    int e1 = 0;
    int e2 = 0;
    for (int a = 0; a < pool; ++a) {
      const float s = rm_c[a * kLanes + b] > 0.f ? 2.0f : 0.f;
      const int bits = (__float_as_int(s) & low_mask) | a;
      if (kTop2) e2 = max(e2, min(e1, bits));
      e1 = max(e1, bits);
    }
    int32_t* o = out + (c * q_cap + count) * kOut;
    for (int q = count; q < q_cap; ++q, o += kOut) {
      o[b] = e1;
      if (kTop2) o[kLanes + b] = e2;
    }
  }

  const int iters = pool * k_stages;
  for (int s0 = 0; s0 < count; s0 += pass_slots) {
    const int ns = min(pass_slots, count - s0);
    const int n_nt = (ns + 7) / 8;
    const int q_rows = min(n_nt * 8, q_cap - s0);
    __syncthreads();   // the last pass's shared memory is free
    // the pass's queries, zero past d and past q_cap
    const int8_t* qb = qsel + (c * q_cap + s0) * static_cast<long long>(d);
    if (!stream_q) {
      const int row_chunks = k_stages * (kBK / 16);
      for (int i = threadIdx.x; i < n_nt * 8 * row_chunks; i += kThreads) {
        const int r = i / row_chunks;
        const int cc = i % row_chunks;
        const bool ok = r < q_rows && cc * 16 < d;
        cp_async16(qtile + (cc >> 3) * pass_slots * kBK + swz128(r, cc & 7),
                   ok ? qb + static_cast<long long>(r) * d + cc * 16 : qb, ok);
      }
      cp_async_commit();
    }
    for (int i = threadIdx.x; i < n_nt * 8; i += kThreads) {
      sc_s[i] = s0 + i < q_cap ? sc[s0 + i] : 0.f;
    }

    // the flat (member tile, K stage) sequence through the ring
    auto issue = [&](int it) {
      if (it < iters) {
        const int a = it / k_stages;
        const int k0 = (it % k_stages) * kBK;
        uint8_t* dst = ring + (it % kStages) * stage_bytes;
        const int8_t* src = buf + (c * window + a * kLanes) * d;
        for (int i = threadIdx.x; i < kLanes * (kBK / 16); i += kThreads) {
          const int r = i >> 3;
          const int ch = i & 7;
          const bool ok = k0 + 16 * ch < d;
          cp_async16(dst + swz128(r, ch),
                     ok ? src + static_cast<long long>(r) * d + k0 + 16 * ch
                        : src,
                     ok);
        }
        if (stream_q) {   // this K stage of the pass's queries
          for (int i = threadIdx.x; i < n_nt * 8 * (kBK / 16);
               i += kThreads) {
            const int r = i >> 3;
            const int ch = i & 7;
            const bool ok = r < q_rows && k0 + 16 * ch < d;
            cp_async16(dst + kStageBytes + swz128(r, ch),
                       ok ? qb + static_cast<long long>(r) * d + k0 + 16 * ch
                          : qb,
                       ok);
          }
        }
      }
      cp_async_commit();   // an empty group keeps the wait counts aligned
    };
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) issue(s);

    int acc[kNT][4];
    int w1[kNT][4];
    int w2[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        w1[nt][v] = 0;
        w2[nt][v] = 0;
      }
    }
    float rm[2];
    for (int it = 0; it < iters; ++it) {
      cp_async_wait<kStages - 2>();
      __syncthreads();   // stage `it` landed; stage it - 1 is free again
      issue(it + kStages - 1);
      const int a = it / k_stages;
      const int kt = it % k_stages;
      if (kt == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          rm[h] = rm_c[a * kLanes + m_base + 8 * h + g];
        }
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[nt][v] = 0;
        }
      }
      const uint8_t* sa = ring + (it % kStages) * stage_bytes;
      const uint8_t* sb =
          stream_q ? sa + kStageBytes : qtile + kt * pass_slots * kBK;
      const int ksteps = min(kBK / 32, (d - kt * kBK + 31) / 32);
#pragma unroll
      for (int ks = 0; ks < kBK / 32; ++ks) {
        if (ks < ksteps) {
          unsigned af[4];
          neumann::load_a(af, sa, m_base, ks);
#pragma unroll
          for (int np = 0; np < kNT / 2; ++np) {
            if (2 * np < n_nt) {
              // two n8 tiles: (2 np, 2 np + 1) x (the step's two chunks)
              unsigned bf[4];
              ldsm_x4(bf, sb + swz128(np * 16 + (lane & 7) + (lane >> 4) * 8,
                                      2 * ks + ((lane >> 3) & 1)));
              const unsigned b0[2] = {bf[0], bf[1]};
              const unsigned b1[2] = {bf[2], bf[3]};
              mma_s8(acc[2 * np], af, b0);
              if (2 * np + 1 < n_nt) mma_s8(acc[2 * np + 1], af, b1);
            }
          }
        }
      }
      if (kt != k_stages - 1) continue;
      // member tile a done: fold it into the running winners
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        if (nt >= n_nt) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float scq = sc_s[nt * 8 + 2 * t + e];
            float s = 0.f;
            if (rm[h] > 0.f) {
              s = __fmaf_rn(__int2float_rn(acc[nt][2 * h + e]),
                            __fmul_rn(scq, rm[h]), 2.0f);
            }
            const int bits = (__float_as_int(s) & low_mask) | a;
            int& x1 = w1[nt][2 * h + e];
            if (kTop2) {
              int& x2 = w2[nt][2 * h + e];
              x2 = max(x2, min(x1, bits));
            }
            x1 = max(x1, bits);
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();   // the ring and query tile are free: stage the winners
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      if (nt >= n_nt) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          int* row = stage_out + (nt * 8 + 2 * t + e) * kOutStride;
          row[m_base + 8 * h + g] = w1[nt][2 * h + e];
          if (kTop2) row[kLanes + m_base + 8 * h + g] = w2[nt][2 * h + e];
        }
      }
    }
    __syncthreads();
    constexpr int kVecs = kOut / 4;
    int4* o = reinterpret_cast<int4*>(out + (c * q_cap + s0) * kOut);
    for (int i = threadIdx.x; i < ns * kVecs; i += kThreads) {
      const int r = i / kVecs;
      const int v = i % kVecs;
      o[r * kVecs + v] =
          *reinterpret_cast<const int4*>(stage_out + r * kOutStride + 4 * v);
    }
  }
}

template <bool kTop2>
int launch(const void* qsel, const void* buf, const void* scmult,
           const void* rmult, void* out, int n_windows, int q_cap, int d,
           int window, cudaStream_t stream) {
  const int k_stages = (d + kBK - 1) / kBK;
  // resident queries: 64 slots a pass while they fit 96 KB of shared
  // memory, else 32 (d above 1,536); streamed: 64 slots in every stage
  const bool stream_q = d > kMaxResidentDim;
  int pass_slots = kMaxSlots;
  while (!stream_q && k_stages * pass_slots * kBK > 96 * 1024) {
    pass_slots /= 2;
  }
  const int body =
      stream_q ? kStages * (kStageBytes + pass_slots * kBK)
               : kStages * kStageBytes + k_stages * pass_slots * kBK;
  const int staged = pass_slots * ((kTop2 ? 2 : 1) * kLanes + 4) * 4;
  const int smem = kHeader + (body > staged ? body : staged);
  auto kernel = batched_probe_kernel<kTop2>;
  const cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (set != cudaSuccess) return static_cast<int>(set);
  kernel<<<static_cast<unsigned>(n_windows), kThreads, smem, stream>>>(
      static_cast<const int8_t*>(qsel), static_cast<const int8_t*>(buf),
      static_cast<const float*>(scmult), static_cast<const float*>(rmult),
      static_cast<int32_t*>(out), q_cap, d, window, pass_slots, stream_q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// qsel [C, q_cap, d] int8, buf [C * window, d] int8, scmult [C, q_cap]
// f32, rmult [C, window] f32 -> out [C, q_cap, top2 ? 256 : 128] int32.
// d % 16 == 0, window a power-of-two multiple of 128, all
// pointers 16-byte aligned (the wrapper checks). Returns
// cudaGetLastError() after the launch.
extern "C" int neumann_batched_probe(
    const void* qsel, const void* buf, const void* scmult, const void* rmult,
    void* out, int n_windows, int q_cap, int d, int window, int top2,
    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return top2 ? launch<true>(qsel, buf, scmult, rmult, out, n_windows, q_cap,
                             d, window, s)
              : launch<false>(qsel, buf, scmult, rmult, out, n_windows, q_cap,
                              d, window, s);
}
