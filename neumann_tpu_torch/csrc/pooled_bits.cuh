// Shared pieces of the pooled-bits scans (csrc/int8_scores.cu, kernel
// int8_pooled_bits; csrc/f32_pooled.cu): the pack epilogue, the per-block
// table of pool maxima, and the cp.async helpers both mainloops stage
// their tiles with.
//
// The epilogue is the XLA-fused step of neumann_tpu/ops/quant.py
// (int8_pooled_topk :371-385, f32_pooled_topk :525-539). For query q and
// corpus row n, with pools of `pool` CONSECUTIVE rows:
//   a    = float(dot[q, n]) * qmult[q]                  (one rounding)
//   s    = fma(a, rm[n], bias[n])                       (one rounding)
//   bits = (bitcast<int32>(s) & ~(pool - 1)) | (n & (pool - 1))
//   out[q, n / pool] = max over the pool of bits        (signed int32)
// bias is 2.0 on live rows and -1e30 on dead rows, so a live score
// lands in [1, 3) and bitcasts to a positive int whose order is the
// float order, while a dead row bitcasts negative and never beats a
// live one. Packing the row's index into the low log2(pool) mantissa
// bits makes one integer max carry both the score and its argmax.
// XLA on the CPU contracts `dots * qmult * rm + shift` into
// fma(dots * qmult, rm, shift) (bit-exact only with that single
// rounding, tests/test_torch_quant.py), so the kernels spell it out with
// __fmul_rn / __fmaf_rn and no compiler contraction choice can move a
// bit.
//
// Pools never cross blocks: a block owns a span of max(pool, BM)
// consecutive rows (BM the block's corpus tile) and all its queries' maxima
// over that span, in a shared [BN queries][span / pool] table
// (`PoolTable`). A thread first folds the rows it holds of one pool, then
// the lanes that hold one pool's rows fold with __shfl_xor, and one lane
// per pool and query folds into the table with a shared atomicMax.

#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace neumann {

constexpr int kThreads = 256;
constexpr int kMinPool = 8;

__device__ __forceinline__ int pack_pool_bits(float a, float rm, float bias,
                                              long long row, int pool) {
  const float s = __fmaf_rn(a, rm, bias);
  return (__float_as_int(s) & ~(pool - 1)) |
         static_cast<int>(row & (pool - 1));
}

// max over the `width` lanes (a power of two <= 32) of an aligned lane
// group; every lane of the warp must call it
__device__ __forceinline__ int group_max(int v, int width) {
  for (int off = 1; off < width; off <<= 1) {
    v = max(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

// Per-block maxima of the packed bits: best[q_local][slot] with
// slot = (row - span0) / pool, signed int32 (dead rows bitcast negative).
struct PoolTable {
  int* best;
  int slots;
  long long span0;
  int pool;
  int shift;   // log2(pool): the slot of a row is a shift, not a division

  __device__ void init(int* smem, int bn, int span, long long span0_,
                       int pool_) {
    best = smem;
    slots = span / pool_;
    span0 = span0_;
    pool = pool_;
    shift = __ffs(pool_) - 1;
    for (int i = threadIdx.x; i < bn * slots; i += blockDim.x) {
      best[i] = INT_MIN;
    }
  }

  __device__ __forceinline__ void add(int q_local, long long row, int bits) {
    atomicMax(&best[q_local * slots +
                    (static_cast<int>(row - span0) >> shift)],
              bits);
  }

  // out [Q, n_pools]: the table's pools of queries q0 .. q0 + nq - 1,
  // written by threads first .. first + count - 1 (by default the block).
  // Call after a barrier over them that follows the last add.
  __device__ void store(int32_t* out, int q0, int nq, long long n_pools,
                        int first = 0, int count = 0) const {
    const long long p0 = span0 / pool;
    const int step = count > 0 ? count : blockDim.x;
    for (int idx = threadIdx.x - first; idx < nq * slots; idx += step) {
      const int qi = idx / slots;
      const int sl = idx % slots;
      if (p0 + sl < n_pools) {
        out[static_cast<long long>(q0 + qi) * n_pools + p0 + sl] =
            best[qi * slots + sl];
      }
    }
  }
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy past L1; `valid` false writes 16 zero
// bytes and reads nothing (gmem must still be a mapped address)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Blocks walk (corpus span, query block) pairs with the query block
// fastest, so the blocks that share a corpus span run together and
// re-read it from L2 instead of device memory.
struct BlockPos {
  int q0;
  long long span0;
  long long span1;
};

__device__ __forceinline__ BlockPos block_pos(int n_qblocks, int bn,
                                              long long span,
                                              long long n_rows) {
  const long long sb = blockIdx.x / n_qblocks;
  BlockPos p;
  p.q0 = static_cast<int>(blockIdx.x % n_qblocks) * bn;
  p.span0 = sb * span;
  p.span1 = min(p.span0 + span, n_rows);
  return p;
}

inline unsigned grid_blocks(long long n_rows, long long span, int n_q,
                            int bn) {
  return static_cast<unsigned>(((n_rows + span - 1) / span) *
                               ((n_q + bn - 1) / bn));
}

}  // namespace neumann
