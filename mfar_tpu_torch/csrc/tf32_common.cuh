// The 3xTF32 building blocks that K2's f32 forward (flash_attention_tf32.cu)
// and its f32 backward (flash_attention_tf32_bwd.cu) share on Hopper
// (sm_90a): the 128-byte swizzle of a [64][32] f32 slab, the split of an f32
// value into two TF32 parts, mma.sync.m16n8k8 on TF32 operands, and the
// warpgroup's wgmma.m64n64k8 on TF32 operands (wgmma_3xtf32, below).
//
// f32 accuracy on TF32 tensor cores.  Each f32 operand x is split into
// hi = cvt.rna.tf32(x) and lo = cvt.rna.tf32(x - hi) (x - hi is exact in
// f32), and each product is formed as hi*hi' + hi*lo' + lo*hi' with f32
// accumulation; lo*lo' (below 2^-22 of the product) is dropped.
//
// Fragment layouts of m16n8k8 (per warp; g = lane / 4, t4 = lane % 4):
//   A (16 x 8, rows x k):  a0 (g, t4)  a1 (g+8, t4)  a2 (g, t4+4)  a3 (g+8, t4+4)
//   B (8 x 8, k x n):      b0 (t4, g)  b1 (t4+4, g)
//   C (16 x 8):            c0 c1 (g, 2t4..+1)  c2 c3 (g+8, 2t4..+1)

#pragma once

#include <cstdint>

namespace {

// Element (r, c) of a [64][32] f32 slab as TMA writes it under the 128-byte
// swizzle: the 16-byte chunk c/4 of row r sits at chunk (c/4) ^ (r%8).
__device__ __forceinline__ int swz32(int r, int c) {
  return r * 32 + ((((c >> 2) ^ (r & 7)) << 2) | (c & 3));
}

// x rounded to tf32 (10 bits of mantissa, to nearest, ties away from
// zero): the bits of cvt.rna.tf32.f32 for every finite x, in two integer
// operations, where the instruction compiles to four (it also keeps inf and
// NaN, which no operand here is).
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x as hi + lo, both tf32; x - hi is exact in f32.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// d += a b on one m16n8k8 tile (A 16 x 8 row-major, B 8 x 8 column-major),
// f32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in 3xTF32: the two cross terms first, then hi hi.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4], const uint32_t (&b_hi)[2],
                                           const uint32_t (&b_lo)[2]) {
  mma_tf32(d, a_lo, b_hi[0], b_hi[1]);
  mma_tf32(d, a_hi, b_lo[0], b_lo[1]);
  mma_tf32(d, a_hi, b_hi[0], b_hi[1]);
}

// ---- wgmma on TF32 operands ------------------------------------------------
//
// wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32: a warpgroup's 64 x
// 64 product over 8 k, A (64 x 8) from registers, B (64 rows of 8 k:
// K-major, 32 bytes of a row) from a tile in shared memory through a
// descriptor
// (hopper_common.cuh's tile_desc: 128-byte swizzle, 8-row groups 1024 bytes
// apart; k step j of a 128-byte row starts 32 bytes further, desc + 2j).
// TF32 wgmma takes no transpose: both operands are K-major, so a product
// whose k runs over a tile's rows reads that tile as A, from registers (any
// layout in shared memory loads), or its B as a copy laid out K-major.  Per
// warp w (rows 16w..16w+15 of the 64; g = lane / 4, t4 = lane % 4) A is
// mma.sync.m16n8k8's fragment above (a0 (g, t4) a1 (g+8, t4) a2 (g, t4+4)
// a3 (g+8, t4+4)), and the accumulator d[n] of 8-column slice n holds
// (g, 8n+2t4..+1) and (g+8, 8n+2t4..+1).  Asynchronous: the caller fences
// (wgmma_fence) after writing A or d, commits, and waits before it reads d
// or reuses A's registers (hopper_common.cuh).

#define MFAR_TF32_ACC8(d)                                                                     \
  "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),   \
      "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), \
      "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]),              \
      "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]),              \
      "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]),              \
      "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])

// d = A B (zero: d's old value dropped) or d += A B on one k step of 8, N
// = 64, A from registers.
__device__ __forceinline__ void wgmma_tf32(float (&d)[8][4], const uint32_t (&a)[4], uint64_t b,
                                           bool zero = false) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
               "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
               "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
               "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
               : MFAR_TF32_ACC8(d)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(zero ? 0 : 1));
}

// d += A B in 3xTF32 on one k step (with zero, d = A B), each operand's hi
// and lo parts split once, A in registers, B two K-major tiles: in
// mma_3xtf32's order, the two cross terms first, then hi hi, each summed
// into d by the tensor cores in f32.
__device__ __forceinline__ void wgmma_3xtf32(float (&d)[8][4], const uint32_t (&a_hi)[4],
                                             const uint32_t (&a_lo)[4], uint64_t b_hi,
                                             uint64_t b_lo, bool zero = false) {
  wgmma_tf32(d, a_lo, b_hi, zero);
  wgmma_tf32(d, a_hi, b_lo);
  wgmma_tf32(d, a_hi, b_hi);
}

}  // namespace
