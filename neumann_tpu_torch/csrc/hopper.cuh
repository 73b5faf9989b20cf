// Hopper pieces shared by the warp-specialized tensor-core kernels
// (csrc/int8_scores.cu `int8_tma_kernel`, csrc/int8_exact.cu): the wgmma
// fences, mbarriers that count arrivals and TMA bytes, 2-D TMA tile
// loads, the shared-memory descriptor of a K-major tile in the 128-byte
// swizzle, and the host's tensor-map encoder.

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "pooled_bits.cuh"

namespace neumann {

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most kPending committed wgmma groups are still running
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// mbarrier helpers (shared-memory barriers that count arrivals and the
// bytes a TMA load delivers)
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// spin until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// TMA: the box at (x = element along a row, y = row) of a 2-D tensor map
// into shared memory, completing its bytes on the mbarrier
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(x),
      "r"(y)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile of 128-byte rows in
// the 128-byte swizzle that TMA writes (8-row groups 1,024 bytes apart,
// the tile 1,024-byte aligned): start address, leading offset 16 bytes
// (unused), stride offset 1,024 bytes, all in 16-byte units, and the
// layout (1: 128-byte swizzle). A K step of 32 bytes adds 2.
__device__ __forceinline__ uint64_t gmma_desc(const void* p) {
  return ((smem_u32(p) & 0x3FFFFull) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 / 16) << 32) | (1ull << 62);
}

// A 2-D tensor map of a row-major [rows, cols] matrix of `type` (row
// stride row_bytes, a multiple of 16), boxes of box_cols x box_rows, zero
// fill past the ends. Returns 0 or a CUDA error code.
inline int encode_map_2d(CUtensorMap* map, CUtensorMapDataType type,
                         const void* base, long long cols, long long rows,
                         long long row_bytes, int box_cols, int box_rows,
                         CUtensorMapSwizzle swizzle) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode),
        cudaEnableDefault, &found);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (found != cudaDriverEntryPointSuccess || encode == nullptr) {
      return static_cast<int>(cudaErrorSymbolNotFound);
    }
  }
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(row_bytes)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(
      map, type, 2, const_cast<void*>(base), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace neumann
