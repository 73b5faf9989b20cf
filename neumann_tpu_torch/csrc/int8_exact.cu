// Exact scan of an int8 plane with f32 queries: f32 cosine scores and
// lax.top_k's selection in one launch, or the scores written.
//
// Replaces the jitted `int8_exact_topk` of the JAX package
// (neumann_tpu/ops/quant.py:402), the exact scan of DeviceIVFInt8's delta
// plane (called from neumann_tpu/ops/ivf.py:797-803): an int8 -> f32
// convert, a Precision.HIGHEST dot, the multiplier mask and lax.top_k
// under lax.scan, one XLA program. For query q and row n:
//   s[q, n] = (sum_k qf[q, k] * float(c[n, k])) * rm[n]   where rm[n] > 0
//           = -inf                                        elsewhere
// qf the unit-normalised f32 query (normalised by the wrapper). Each sum
// is one chain of FFMA over k = 0, 1, ... (the query zero-padded past d),
// in the same order for every (q, n) whatever tile or block n falls in,
// so equal rows score bit-equal and their ties go by ascending row, as
// lax.top_k orders them. Full f32: no TF32, as the JAX package multiplies
// at HIGHEST (csrc/f32_pooled.cu:16-18 says why the tensor cores are out).
// Two modes of each kernel:
//   * select (1 <= k <= 64): each block keeps, for each of its queries,
//     the k greatest int64 keys of ops/scan.stable_keys (the score's
//     order-preserving int32 image above the row's complement) over the
//     rows it walks, and writes them; one torch.topk over [Q, parts * k]
//     and a decode finish (ops/kernels.int8_exact_topk). No score reaches
//     device memory;
//   * scores: the masked [Q, N] scores (k above 64; the wrapper selects
//     over each block of rows with its carry).
//
// What bounds it on an H100, at cell A17's delta plane (419,430 filled
// slots x 768): at Q = 1,024 the FFMA, 6.6e11 FLOP (9.8 ms at 67 TFLOP/s)
// against 0.32 GB of rows (0.10 ms at 3.35 TB/s); at Q = 1 the row bytes
// (0.10 ms) against 6.4e8 FLOP (0.01 ms).
//
// The designs, by batch (csrc/f32_pooled.cu's two, with int8 rows):
// * Q <= 16 (`exact_stream_kernel`, 1, 4 or 16 query slots): the row
//   bytes are the limit. A block streams 256 rows through a 3-stage
//   cp.async ring of 64 K-bytes a stage (16-byte loads; byte loads where
//   d % 16 != 0), each thread one row against every query. A thread reads
//   16 int8 of its row as one 16-byte word, converts them in registers
//   (a byte permute into a float's mantissa and one subtraction, exact),
//   and takes 16 FFMA a query, the query's floats read as broadcasts.
//   Rows' 16-byte chunks are XOR-swizzled, so 8 consecutive rows at one K
//   read 8 different bank groups.
// * Q > 16 (`exact_batch_kernel`): the FFMA are the limit. Row 6's
//   tiling (csrc/f32_pooled.cu `batch_kernel`): 128 rows x 128 queries a
//   block, an 8 x 8 register tile a thread, K-major double-buffered shared
//   tiles, the next step's tiles read into registers while this one
//   computes. The row tile is read as int8, a quarter of row 6's bytes,
//   and converted to f32 on its way into shared memory.
// Blocks: the wrapper's plan gives `parts` blocks along the rows, each
// walking `span` rows (whole tiles); in the batch kernel a part's query
// blocks are neighbours in the grid, so they share its rows in L2.
// Selection (both kernels): after each tile a key passes if it beats its
// query's k-th key in the block; passing keys go to a shared buffer
// (atomicAdd a key), and one warp a query merges the buffer into the
// query's best list (k rounds of a warp max, as csrc/pq_adc.cu), in
// rounds until every passing key is in. Past a block's first tile few
// keys pass. The batch kernel runs the rounds out of line: its 64 sums
// keep the thread's registers.
//
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py phase 2, at
// A17's delta shapes, two runs): Q 1,024, k 10, 19.27-19.44 ms of kernel
// (50 % of the FFMA bound; the scores mode's scan alone 16.87-17.00);
// Q 1, 0.174-0.176 ms (55-56 % of the bytes bound); k 64, 41.3 ms: its
// keys fill the shared memory of a SM, one batch block a SM. A
// tensor-core design waits (ROADMAP tuning item 13).

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "pooled_bits.cuh"

namespace {

using neumann::cp_async16;
using neumann::cp_async_commit;
using neumann::cp_async_wait;
using neumann::kThreads;

constexpr int kMaxK = 64;                 // the wrapper's cap on k
constexpr long long kEmpty = LLONG_MIN;   // below every real key
constexpr int kSmemMax = 232448;          // a block's shared memory
constexpr int kLdq = 64;                  // the queries' row stride divides
// the stream kernel: rows a tile (a thread each), K bytes a stage, stages,
// a query's candidate buffer
constexpr int kSRows = kThreads;
constexpr int kSK = 64;
constexpr int kSStages = 3;
constexpr int kSCap = 128;
// the batch kernel: rows and queries a tile, K a step, K staged through
// registers, a transposed row (the stores of k and k + 4 land 16 banks
// apart), floats of one transposed tile, a query's candidate buffer
constexpr int kB = 128;
constexpr int kBK = 32;
constexpr int kBPart = 16;
constexpr int kBPad = kB + 4;
constexpr int kBTile = kBK * kBPad;
constexpr int kBCap = 32;

struct Args {
  const int8_t* c;         // [n_rows, d]
  const float* row_mult;   // [n_rows]
  const float* x;          // [n_q, ldq], zero past d
  float* scores;           // scores mode: [n_q, n_rows]
  long long* keys;         // select mode: [n_q, parts, k]
  long long n_rows, span;
  int d, ldq, n_q, k, parts;
  bool vec;                // rows read in 16 (stream) / 4 (batch) bytes
};

// a block's selection in shared memory, per query slot: the best keys
// [k], descending, kEmpty past those there are; the candidate buffer
// [cap]; the k-th key; the buffer's count
struct Sel {
  long long* best;
  long long* buf;
  long long* thr;
  int* cnt;
  int k;
};

__host__ __device__ constexpr int sel_bytes(int slots, int k, int cap) {
  return slots * ((k + cap + 1) * 8 + 4);
}

__device__ __forceinline__ Sel sel_at(unsigned char* p, int slots, int k,
                                      int cap) {
  Sel s;
  s.best = reinterpret_cast<long long*>(p);
  s.buf = s.best + slots * k;
  s.thr = s.buf + slots * cap;
  s.cnt = reinterpret_cast<int*>(s.thr + slots);
  s.k = k;
  return s;
}

// every thread of the block; read after the next block barrier
__device__ __forceinline__ void sel_init(const Sel& s, int slots) {
  for (int i = threadIdx.x; i < slots * s.k; i += blockDim.x) {
    s.best[i] = kEmpty;
  }
  for (int i = threadIdx.x; i < slots; i += blockDim.x) {
    s.thr[i] = kEmpty;
    s.cnt[i] = 0;
  }
}

// ops/scan.stable_keys's key of score v at row n (n < 2^32 - 1)
__device__ __forceinline__ long long make_key(float v, long long n) {
  int b = __float_as_int(v);
  b = b < 0 ? (b ^ 0x7FFFFFFF) : b;
  return static_cast<long long>(
      (static_cast<unsigned long long>(static_cast<unsigned>(b)) << 32) |
      static_cast<unsigned long long>(0xFFFFFFFFu -
                                      static_cast<unsigned>(n)));
}

// One warp: the k greatest of best[0, k) and buf[0, n) become best,
// sorted descending, kEmpty past the keys there are.
template <int kPerLane>
__device__ __forceinline__ void merge(long long* best, const long long* buf,
                                      int n, int k) {
  const int lane = threadIdx.x % 32;
  const int total = k + n;
  long long v[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int j = lane + 32 * i;
    v[i] = j < k ? best[j] : (j < total ? buf[j - k] : kEmpty);
  }
  __syncwarp();
  for (int o = 0; o < k; ++o) {
    long long mx = v[0];
#pragma unroll
    for (int i = 1; i < kPerLane; ++i) mx = max(mx, v[i]);
    const int hi = static_cast<int>(mx >> 32);
    const int hmax = __reduce_max_sync(0xffffffffu, hi);
    const unsigned lo = hi == hmax ? static_cast<unsigned>(mx) : 0u;
    const unsigned lmax = __reduce_max_sync(0xffffffffu, lo);
    const long long w = static_cast<long long>(
        (static_cast<unsigned long long>(static_cast<unsigned>(hmax))
         << 32) |
        lmax);
    if (w == kEmpty) {   // fewer than k keys: the rest stay empty
      for (int j = o + lane; j < k; j += 32) best[j] = kEmpty;
      break;
    }
    if (lane == 0) best[o] = w;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) v[i] = v[i] == w ? kEmpty : v[i];
  }
  __syncwarp();
}

// The rounds of a block's selection after a tile: the thread's keys
// key_of(i) (i < kN, for query slot slot_of(i)) flagged in `pend` beat
// their slot's k-th key. Each round buffers what fits, one warp a slot
// merges, and the flags of keys no longer above the raised k-th drop.
// Called by every thread of the block.
template <int kN, int kCap, class KeyOf, class SlotOf>
__device__ __forceinline__ void rounds(const Sel& s, int slots,
                                       unsigned long long pend, KeyOf key_of,
                                       SlotOf slot_of) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int warps = blockDim.x / 32;
  while (__syncthreads_or(pend != 0)) {
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      if ((pend >> i) & 1) {
        const int sl = slot_of(i);
        const int at = atomicAdd(s.cnt + sl, 1);
        if (at < kCap) {   // else kept for the next round
          s.buf[sl * kCap + at] = key_of(i);
          pend &= ~(1ull << i);
        }
      }
    }
    __syncthreads();
    for (int sl = warp; sl < slots; sl += warps) {
      const int n = s.cnt[sl];
      if (n == 0) continue;
      merge<(kMaxK + kCap) / 32>(s.best + sl * s.k, s.buf + sl * kCap,
                                 min(n, kCap), s.k);
      if (lane == 0) {
        s.thr[sl] = s.best[sl * s.k + s.k - 1];
        s.cnt[sl] = 0;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      if (((pend >> i) & 1) && !(key_of(i) > s.thr[slot_of(i)])) {
        pend &= ~(1ull << i);
      }
    }
  }
}

// byte b (0..3) of w as a float, exactly: the byte, offset by 128, put in
// the low mantissa bits of 2^23, then 2^23 + 128 taken away
__device__ __forceinline__ float byte_f32(unsigned w, int b) {
  const unsigned m = __byte_perm(w ^ 0x80808080u, 0x4B000000u, 0x7440 | b);
  return __int_as_float(static_cast<int>(m)) - 8388736.0f;
}

// byte offset of 16-byte chunk ch (0..3) of row r in a [rows][64]-byte
// tile: the chunk XORed with bits 1-2 of the row, so rows r .. r + 7 at
// one chunk land in 8 different 16-byte bank groups
__device__ __forceinline__ int swz(int r, int ch) {
  return r * kSK + ((ch ^ ((r >> 1) & 3)) << 4);
}

template <int kNQ>
__host__ __device__ constexpr int stream_stage_bytes() {
  return kSRows * kSK + kNQ * kSK * 4;
}

// Block `part` walks rows [part * span, + span) in tiles of 256, thread
// t row t of the tile, against queries 0 .. kNQ - 1 (n_q <= kNQ).
template <int kNQ, bool kSelect>
__global__ void __launch_bounds__(kThreads, 2)
    exact_stream_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kStage = stream_stage_bytes<kNQ>();
  const long long r_begin = static_cast<long long>(blockIdx.x) * a.span;
  const long long r_end = min(r_begin + a.span, a.n_rows);
  const int k_steps = (a.d + kSK - 1) / kSK;
  const int n_tiles = static_cast<int>((r_end - r_begin + kSRows - 1) /
                                       kSRows);
  const int iters = n_tiles * k_steps;
  const Sel s = sel_at(smem + kSStages * kStage, kNQ, a.k, kSCap);
  if constexpr (kSelect) sel_init(s, kNQ);
  float acc[kNQ];

  auto load = [&](int it, unsigned char* st) {
    const long long row0 =
        r_begin + static_cast<long long>(it / k_steps) * kSRows;
    const int k0 = (it % k_steps) * kSK;
    if (a.vec) {
      for (int idx = threadIdx.x; idx < kSRows * 4; idx += kThreads) {
        const int r = idx >> 2, ch = idx & 3;
        const long long n = row0 + r;
        const bool ok = n < r_end && k0 + 16 * ch < a.d;
        cp_async16(st + swz(r, ch), ok ? a.c + n * a.d + k0 + 16 * ch : a.c,
                   ok);
      }
    } else {   // rows not 16-byte aligned: bytes, stored in place
      for (int idx = threadIdx.x; idx < kSRows * kSK; idx += kThreads) {
        const int r = idx / kSK, b = idx % kSK;
        const long long n = row0 + r;
        st[swz(r, b >> 4) + (b & 15)] =
            n < r_end && k0 + b < a.d
                ? static_cast<unsigned char>(a.c[n * a.d + k0 + b])
                : 0;
      }
    }
    float* sq = reinterpret_cast<float*>(st + kSRows * kSK);
    for (int idx = threadIdx.x; idx < kNQ * (kSK / 4); idx += kThreads) {
      const int j = idx / (kSK / 4), ch = idx % (kSK / 4);
      const bool ok = j < a.n_q;
      cp_async16(sq + j * kSK + 4 * ch,
                 ok ? a.x + static_cast<long long>(j) * a.ldq + k0 + 4 * ch
                    : a.x,
                 ok);
    }
  };
  auto issue = [&](int it) {
    if (it < iters) load(it, smem + (it % kSStages) * kStage);
    cp_async_commit();   // an empty group keeps the wait counts aligned
  };
#pragma unroll
  for (int i = 0; i < kSStages - 1; ++i) issue(i);
  for (int it = 0; it < iters; ++it) {
    cp_async_wait<kSStages - 2>();
    __syncthreads();   // stage `it` landed; stage it - 1 is free again
    issue(it + kSStages - 1);
    const unsigned char* st = smem + (it % kSStages) * kStage;
    const int kt = it % k_steps;
    if (kt == 0) {
#pragma unroll
      for (int j = 0; j < kNQ; ++j) acc[j] = 0.f;
    }
    const float* sq = reinterpret_cast<const float*>(st + kSRows * kSK);
#pragma unroll
    for (int ch = 0; ch < kSK / 16; ++ch) {
      const uint4 w =
          *reinterpret_cast<const uint4*>(st + swz(threadIdx.x, ch));
      const unsigned ws[4] = {w.x, w.y, w.z, w.w};
      float v[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) v[i] = byte_f32(ws[i / 4], i % 4);
#pragma unroll
      for (int j = 0; j < kNQ; ++j) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float4 b = *reinterpret_cast<const float4*>(
              sq + j * kSK + ch * 16 + 4 * u);
          acc[j] = __fmaf_rn(b.x, v[4 * u], acc[j]);
          acc[j] = __fmaf_rn(b.y, v[4 * u + 1], acc[j]);
          acc[j] = __fmaf_rn(b.z, v[4 * u + 2], acc[j]);
          acc[j] = __fmaf_rn(b.w, v[4 * u + 3], acc[j]);
        }
      }
    }
    if (kt != k_steps - 1) continue;
    const long long n = r_begin +
                        static_cast<long long>(it / k_steps) * kSRows +
                        threadIdx.x;
    const bool in = n < r_end;
    const float rm = in ? a.row_mult[n] : 0.f;
#pragma unroll
    for (int j = 0; j < kNQ; ++j) {
      acc[j] = rm > 0.f ? __fmul_rn(acc[j], rm) : -INFINITY;
    }
    if constexpr (kSelect) {
      auto key_of = [&](int j) {
        return in && j < a.n_q ? make_key(acc[j], n) : kEmpty;
      };
      unsigned long long pend = 0;
#pragma unroll
      for (int j = 0; j < kNQ; ++j) {
        if (key_of(j) > s.thr[j]) pend |= 1ull << j;
      }
      rounds<kNQ, kSCap>(s, kNQ, pend, key_of, [](int j) { return j; });
    } else if (in) {
#pragma unroll
      for (int j = 0; j < kNQ; ++j) {
        if (j < a.n_q) {
          a.scores[static_cast<long long>(j) * a.n_rows + n] = acc[j];
        }
      }
    }
  }
  cp_async_wait<0>();
  if constexpr (kSelect) {
    __syncthreads();
    for (int i = threadIdx.x; i < kNQ * a.k; i += kThreads) {
      const int q = i / a.k;
      if (q < a.n_q) {
        a.keys[(static_cast<long long>(q) * a.parts + blockIdx.x) * a.k +
               i % a.k] = s.best[i];
      }
    }
  }
}

// The batch kernel's selection rounds, out of line: sc [8 rows][8
// queries] the thread's masked scores (local memory, once a tile), rows
// tile0 + (i / 4) * 64 + 4 ty + i % 4, query slots (j / 4) * 64 + 4 tx +
// j % 4.
__device__ __noinline__ void batch_rounds(const Sel s, const float* sc,
                                          unsigned long long pend,
                                          long long tile0, long long r_end,
                                          int q0, int n_q) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  rounds<64, kBCap>(
      s, kB, pend,
      [&](int e) {
        const int i = e / 8, j = e % 8;
        const long long n = tile0 + (i / 4) * 64 + 4 * ty + i % 4;
        const int ql = (j / 4) * 64 + 4 * tx + j % 4;
        return n < r_end && q0 + ql < n_q ? make_key(sc[e], n) : kEmpty;
      },
      [&](int e) {
        const int j = e % 8;
        return (j / 4) * 64 + 4 * tx + j % 4;
      });
}

// Block (part, query block), part-major: rows [part * span, + span) in
// tiles of 128 against queries q0 .. q0 + 127, K kBK floats a step.
// Thread (tx, ty) = (t % 16, t / 16) owns rows 4 ty + {0..3} and 64 +
// 4 ty + {0..3} of a tile, queries 4 tx + {0..3} and 64 + 4 tx + {0..3}.
// Each 16-K part of the next step's tiles is read into registers while
// the matching part of this step computes, then stored transposed (the
// rows converted to f32) into the other of two buffers: one
// __syncthreads a step.
template <bool kSelect>
__global__ void __launch_bounds__(kThreads, 2)
    exact_batch_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);   // [2 buffers][sa, sb]
  const int nqb = (a.n_q + kB - 1) / kB;
  const int part = blockIdx.x / nqb;
  const int q0 = (blockIdx.x % nqb) * kB;
  const long long r_begin = static_cast<long long>(part) * a.span;
  const long long r_end = min(r_begin + a.span, a.n_rows);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  // the selection's pointers, taken afresh where needed: held across the
  // mainloop they cost the 64 sums registers
  auto sel = [&]() { return sel_at(smem_raw + 4 * kBTile * 4, kB, a.k,
                                   kBCap); };
  if constexpr (kSelect) sel_init(sel(), kB);

  // the loader: thread t copies K 4 (t % 2) + 8 u .. + 3 (u < 2) of a
  // part, of row t / 2 and of query t / 2
  const int lr = threadIdx.x >> 1;
  const int lk = (threadIdx.x & 1) * 4;
  const bool q_ok = q0 + lr < a.n_q;
  const float* q_src =
      a.x + static_cast<long long>(q_ok ? q0 + lr : 0) * a.ldq + lk;
  const int k_steps = (a.d + kBK - 1) / kBK;
  const int n_tiles = static_cast<int>((r_end - r_begin + kB - 1) / kB);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  unsigned va[2];
  float4 vb[2];
  const int8_t* c_src = nullptr;   // row lr of the tile being fetched
  auto aim = [&](int tile) {
    const long long n = r_begin + static_cast<long long>(tile) * kB + lr;
    c_src = n < r_end ? a.c + n * a.d : nullptr;
  };
  auto fetch = [&](int k0) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int k = k0 + 8 * u + lk;
      unsigned w = 0;
      if (c_src != nullptr && k < a.d) {
        if (a.vec) {   // d % 4 == 0: the 4 bytes lie in the row
          w = __ldg(reinterpret_cast<const unsigned*>(c_src + k));
        } else {
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            if (k + b < a.d) {
              w |= static_cast<unsigned>(
                       static_cast<unsigned char>(c_src[k + b]))
                   << (8 * b);
            }
          }
        }
      }
      va[u] = w;
      // the queries are zero-padded to a multiple of kLdq >= every step
      vb[u] = q_ok ? __ldcg(reinterpret_cast<const float4*>(q_src + k0 +
                                                            8 * u))
                   : zero;
    }
  };
  auto put = [&](int buf, int kp) {
    float* sa = smem + 2 * buf * kBTile;
    float* sb = sa + kBTile;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int k = kp + 8 * u + lk;
#pragma unroll
      for (int b = 0; b < 4; ++b) sa[(k + b) * kBPad + lr] = byte_f32(va[u], b);
      sb[(k + 0) * kBPad + lr] = vb[u].x;
      sb[(k + 1) * kBPad + lr] = vb[u].y;
      sb[(k + 2) * kBPad + lr] = vb[u].z;
      sb[(k + 3) * kBPad + lr] = vb[u].w;
    }
  };

  aim(0);
#pragma unroll
  for (int kp = 0; kp < kBK; kp += kBPart) {
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
      const int k_next = last_k ? 0 : (kt + 1) * kBK;
      const float* sa = smem + 2 * buf * kBTile;
      const float* sb = sa + kBTile;
#pragma unroll
      for (int kp = 0; kp < kBK; kp += kBPart) {
        if (more) fetch(k_next + kp);
#pragma unroll
        for (int k = kp; k < kp + kBPart; ++k) {
          const float4 a0 =
              *reinterpret_cast<const float4*>(sa + k * kBPad + 4 * ty);
          const float4 a1 =
              *reinterpret_cast<const float4*>(sa + k * kBPad + 64 + 4 * ty);
          const float4 b0 =
              *reinterpret_cast<const float4*>(sb + k * kBPad + 4 * tx);
          const float4 b1 =
              *reinterpret_cast<const float4*>(sb + k * kBPad + 64 + 4 * tx);
          const float ra[8] = {a0.x, a0.y, a0.z, a0.w,
                               a1.x, a1.y, a1.z, a1.w};
          const float rb[8] = {b0.x, b0.y, b0.z, b0.w,
                               b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int i = 0; i < 8; ++i) {
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              acc[i][j] = __fmaf_rn(rb[j], ra[i], acc[i][j]);
            }
          }
        }
        if (more) put(buf ^ 1, kp);
      }
      __syncthreads();   // this step's reads done, the next step's stores seen
      buf ^= 1;
    }
    // epilogue: the masked scores, then the selection or the stores
    const long long tile0 = r_begin + static_cast<long long>(tile) * kB;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const long long n = tile0 + (i / 4) * 64 + 4 * ty + i % 4;
      const float rm = n < r_end ? a.row_mult[n] : 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[i][j] = rm > 0.f ? __fmul_rn(acc[i][j], rm) : -INFINITY;
      }
    }
    if constexpr (kSelect) {
      const Sel s = sel();
      unsigned long long pend = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const long long n = tile0 + (i / 4) * 64 + 4 * ty + i % 4;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int ql = (j / 4) * 64 + 4 * tx + j % 4;
          if (n < r_end && q0 + ql < a.n_q &&
              make_key(acc[i][j], n) > s.thr[ql]) {
            pend |= 1ull << (i * 8 + j);
          }
        }
      }
      if (__syncthreads_or(pend != 0)) {
        float sc[64];
#pragma unroll
        for (int e = 0; e < 64; ++e) sc[e] = acc[e / 8][e % 8];
        batch_rounds(s, sc, pend, tile0, r_end, q0, a.n_q);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int q = q0 + (j / 4) * 64 + 4 * tx + j % 4;
        if (q >= a.n_q) continue;
        float* o = a.scores + static_cast<long long>(q) * a.n_rows;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const long long n = tile0 + (i / 4) * 64 + 4 * ty + i % 4;
          if (n < r_end) o[n] = acc[i][j];
        }
      }
    }
  }
  if constexpr (kSelect) {
    __syncthreads();
    const Sel s = sel();
    for (int i = threadIdx.x; i < kB * a.k; i += kThreads) {
      const int q = q0 + i / a.k;
      if (q < a.n_q) {
        a.keys[(static_cast<long long>(q) * a.parts + part) * a.k + i % a.k] =
            s.best[i];
      }
    }
  }
}

// dynamic shared memory of a launch: the stream kernel's ring or the
// batch kernel's two buffers of a transposed row and query tile, then in
// select mode the selection
int smem_bytes(int n_q, int k, bool select) {
  if (n_q > 16) {
    return 4 * kBTile * 4 + (select ? sel_bytes(kB, k, kBCap) : 0);
  }
  const int nq = n_q <= 1 ? 1 : (n_q <= 4 ? 4 : 16);
  const int stage = kSRows * kSK + nq * kSK * 4;
  return kSStages * stage + (select ? sel_bytes(nq, k, kSCap) : 0);
}

template <class Kernel>
int launch(Kernel kernel, unsigned blocks, int smem, const Args& a,
           cudaStream_t s) {
  const cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (set != cudaSuccess) return static_cast<int>(set);
  kernel<<<blocks, kThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool kSelect>
int dispatch(Args a, cudaStream_t s) {
  const bool stream = a.n_q <= 16;
  const long long tile = stream ? kSRows : kB;
  const long long nqb = stream ? 1 : (a.n_q + kB - 1) / kB;
  const uintptr_t base = reinterpret_cast<uintptr_t>(a.c);
  if (a.n_rows < 1 || a.n_rows >= 0xFFFFFFFFLL || a.d < 1 || a.n_q < 1 ||
      a.ldq < a.d || a.ldq % kLdq ||
      reinterpret_cast<uintptr_t>(a.x) % 16 || a.parts < 1 ||
      a.span < tile || a.span % tile ||
      static_cast<long long>(a.parts) * a.span < a.n_rows ||
      static_cast<long long>(a.parts - 1) * a.span >= a.n_rows ||
      nqb * a.parts > INT_MAX || (kSelect && (a.k < 1 || a.k > kMaxK))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = smem_bytes(a.n_q, a.k, kSelect);
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>(nqb * a.parts);
  if (stream) {
    a.vec = a.d % 16 == 0 && base % 16 == 0;
    if (a.n_q <= 1) {
      return launch(exact_stream_kernel<1, kSelect>, blocks, smem, a, s);
    }
    if (a.n_q <= 4) {
      return launch(exact_stream_kernel<4, kSelect>, blocks, smem, a, s);
    }
    return launch(exact_stream_kernel<16, kSelect>, blocks, smem, a, s);
  }
  a.vec = a.d % 4 == 0 && base % 4 == 0;
  return launch(exact_batch_kernel<kSelect>, blocks, smem, a, s);
}

Args make_args(const void* c, const void* row_mult, const void* x,
               long long n_rows, int d, int ldq, int n_q, int parts,
               long long span) {
  Args a;
  a.c = static_cast<const int8_t*>(c);
  a.row_mult = static_cast<const float*>(row_mult);
  a.x = static_cast<const float*>(x);
  a.scores = nullptr;
  a.keys = nullptr;
  a.n_rows = n_rows;
  a.span = span;
  a.d = d;
  a.ldq = ldq;
  a.n_q = n_q;
  a.k = 0;
  a.parts = parts;
  a.vec = false;
  return a;
}

}  // namespace

// c [n_rows, d] int8 rows, row_mult [n_rows] f32 (<= 0: a dead row), x
// [n_q, ldq] f32 unit queries, zero past d, ldq a multiple of 64, x
// 16-byte aligned. The plan (ops/kernels._exact_plan): `parts` blocks
// along the rows (each query block's), each walking `span` rows, a
// multiple of the tile (256 rows at n_q <= 16, else 128). Select mode,
// 1 <= k <= 64: keys [n_q, parts, k] int64, each block's k greatest keys
// a query, descending, LLONG_MIN past its rows. Returns the launch's CUDA
// error code (cudaErrorInvalidValue for arguments it does not take).
extern "C" int neumann_int8_exact_select(const void* c, const void* row_mult,
                                         const void* x, void* keys,
                                         long long n_rows, int d, int ldq,
                                         int n_q, int k, int parts,
                                         long long span, void* stream) {
  Args a = make_args(c, row_mult, x, n_rows, d, ldq, n_q, parts, span);
  a.keys = static_cast<long long*>(keys);
  a.k = k;
  return dispatch<true>(a, static_cast<cudaStream_t>(stream));
}

// Scores mode: out [n_q, n_rows] f32, the masked scores. Arguments
// otherwise as neumann_int8_exact_select.
extern "C" int neumann_int8_exact_scores(const void* c, const void* row_mult,
                                         const void* x, void* out,
                                         long long n_rows, int d, int ldq,
                                         int n_q, int parts, long long span,
                                         void* stream) {
  Args a = make_args(c, row_mult, x, n_rows, d, ldq, n_q, parts, span);
  a.scores = static_cast<float*>(out);
  return dispatch<false>(a, static_cast<cudaStream_t>(stream));
}
