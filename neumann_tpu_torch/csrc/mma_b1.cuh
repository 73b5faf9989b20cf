// 1-bit tensor-core product shared by the hamming kernels
// (csrc/hamming.cu, csrc/hamming_topk.cu): mma.sync.m16n8k256.b1.and.popc,
// native BMMA on Hopper, exact on the packed words as they are stored.
//
//   hamming(r, q) = popc(r) + popc(q) - 2 popc(r AND q)
//
// Fragments of m16n8k256.b1 (lane = 4 g + t): A (16 rows x 256 K bits)
// a[0] / a[1] rows g / g + 8 at K bits 32 t.., a[2] / a[3] the same rows
// at 128 + 32 t..; B (256 K bits x 8 columns) b[0] column g at 32 t..,
// b[1] at 128 + 32 t..; the int32 accumulator c[2 h + e] row g + 8 h,
// column 2 t + e. Any permutation of K shared by A and B gives the same
// popcount, so both kernels hand a thread words 8 s + 2 t and
// 8 s + 2 t + 1 of 256-bit step s (one 8-byte load each for a row and a
// column): a[0] / a[2] = row g's pair, a[1] / a[3] = row g + 8's, b =
// column g's.

#pragma once

namespace neumann {

// c += popc(a AND b) over 256 bits: a 16 rows x 256 (row), b 256 x 8 (col)
__device__ __forceinline__ void mma_b1(int (&c)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

}  // namespace neumann
