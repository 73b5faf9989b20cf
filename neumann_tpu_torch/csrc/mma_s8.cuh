// int8 tensor-core pieces shared by the mma.sync kernels
// (csrc/int8_scores.cu, csrc/batched_probe.cu): the 128-byte swizzle of
// K-major tiles in shared memory, ldmatrix loads of the fragments, and
// mma.sync.m16n8k32.s8.
//
// Fragments of m16n8k32 (lane = 4 g + t): A (16 rows x 32 K bytes) a[0]
// row g bytes 4t..4t+3, a[1] row g + 8 the same bytes, a[2] / a[3] the
// same rows at bytes 16 + 4t..; B (32 K bytes x 8 columns) b[0] column g
// bytes 4t..4t+3, b[1] bytes 16 + 4t..; the int32 accumulator c[2 h + e]
// row g + 8 h, column 2 t + e.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "pooled_bits.cuh"

namespace neumann {

// byte offset of 16-byte chunk c of row r in a tile of 128-byte rows, the
// 128-byte swizzle: the chunk is XORed with the row's low bits, so 8
// consecutive rows at one logical chunk land in 8 different 16-byte bank
// groups (ldmatrix reads and cp.async writes of 8 rows do not conflict)
__device__ __forceinline__ int swz128(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2(unsigned (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// c += a (16 x 32 s8, row) * b (32 x 8 s8, col), exact int32
__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The A fragment of K step ks (32 bytes) of a 16-row slice from row m0 of
// a swizzled [rows][128] tile: ldmatrix x4 over (rows 0-7, 8-15) x (the
// step's two 16-byte chunks).
__device__ __forceinline__ void load_a(unsigned (&a)[4], const uint8_t* tile,
                                       int m0, int ks) {
  const int lane = threadIdx.x % 32;
  ldsm_x4(a, tile + swz128(m0 + (lane & 7) + ((lane >> 3) & 1) * 8,
                           2 * ks + (lane >> 4)));
}

}  // namespace neumann
