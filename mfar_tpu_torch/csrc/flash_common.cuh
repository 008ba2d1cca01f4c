// Building blocks shared by kernel K2 (flash_attention.cu) and its backward
// (flash_attention_bwd.cu), written for Hopper (sm_90a): 64 x 64 bf16 tiles
// staged in shared memory with cp.async, XOR-swizzled so ldmatrix reads hit
// 8 bank groups, and mma.sync.m16n8k16 (bf16 in, f32 accumulate) on them.
//
// Fragment layouts of mma.m16n8k16 (g = lane / 4, t4 = lane % 4):
//   A (16 x 16, rows x k):  a0 (g, 2t4..+1)  a1 (g+8, 2t4..+1)
//                           a2 (g, 2t4+8..+9) a3 (g+8, 2t4+8..+9)
//   B (16 x 8, k x cols):   b0 (k 2t4..+1, col g)  b1 (k 2t4+8..+9, col g)
//   C (16 x 8):             c0 c1 (g, 2t4..+1)  c2 c3 (g+8, 2t4..+1)

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

namespace {

constexpr int kHeadDim = 64;
constexpr int kBlockM = 64;  // query rows per block (forward, dQ)
constexpr int kBlockN = 64;  // keys per tile
constexpr int kWarps = 4;    // 16 rows each
constexpr int kThreads = kWarps * 32;
constexpr float kMaskValue = -0.7f * FLT_MAX;  // JAX's DEFAULT_MASK_VALUE
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Offset of element (r, c) of a [rows][64] bf16 tile in shared memory: the
// 16-byte chunk c/8 of row r sits at chunk (c/8) ^ (r%8).
__device__ __forceinline__ int swz(int r, int c) {
  return r * kHeadDim + ((((c >> 3) ^ (r & 7)) << 3) | (c & 7));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a * b on one m16n8k16 tile: bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as a bf16 pair, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Start the copy of a 64 x 64 bf16 tile whose rows lie `ld` elements apart
// into swizzled shared memory: 512 chunks of 16 bytes, 4 per thread.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long ld, int tid) {
#pragma unroll
  for (int i = 0; i < kBlockN * kHeadDim / 8 / kThreads; ++i) {
    const int idx = tid + i * kThreads;
    const int r = idx >> 3, ch = idx & 7;
    cp_async16(dst + swz(r, ch * 8), src + r * ld + ch * 8);
  }
}

// Start the copy of 64 contiguous 4-byte values (a tile's segment ids, row
// sums or row dots): 16 chunks of 16 bytes.
__device__ __forceinline__ void load_row_values(void* dst, const void* src, int tid) {
  if (tid < 16) {
    cp_async16(static_cast<char*>(dst) + tid * 16, static_cast<const char*>(src) + tid * 16);
  }
}

// A fragments of the warp's 16 rows of a swizzled [64][64] tile, one per
// 16-wide slice `kc` of the 64 columns.
__device__ __forceinline__ void load_a_fragment(uint32_t (&a)[4], const __nv_bfloat16* tile,
                                                int warp, int lane, int kc) {
  const int r = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  ldmatrix_x4(a, tile + swz(r, kc * 16 + (lane >> 4) * 8));
}

// B fragments for rows n*8..n*8+7 of a [64][64] tile taken as the columns
// of B (B = tile^T): b[0], b[1] cover tile columns half*32 + 0..15, b[2],
// b[3] columns half*32 + 16..31.
__device__ __forceinline__ void load_b_rows(uint32_t (&b)[4], const __nv_bfloat16* tile,
                                            int lane, int n, int half) {
  ldmatrix_x4(b, tile + swz(n * 8 + (lane & 7), half * 32 + (lane >> 3) * 8));
}

// B fragments for rows kc*16..kc*16+15 of a [64][64] tile taken as B's k
// rows (B = tile): b[0], b[1] cover tile columns dp*16 + 0..7, b[2], b[3]
// columns dp*16 + 8..15.
__device__ __forceinline__ void load_b_cols(uint32_t (&b)[4], const __nv_bfloat16* tile,
                                            int lane, int kc, int dp) {
  const int r = kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  ldmatrix_x4_trans(b, tile + swz(r, dp * 16 + (lane >> 4) * 8));
}

// Store the warp's 16 x 64 f32 accumulators (C layout, one per 8-wide
// column slice) as bf16: staged in the warp's own rows of a swizzled tile
// in shared memory, then written in 16-byte chunks to rows that lie `ld`
// elements apart from `dst` (the block's first row).
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, long long ld,
                                           __nv_bfloat16* stage, const float (&acc)[8][4],
                                           float scale0, float scale1, int warp, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = warp * 16 + g;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int c = n * 8 + 2 * t4;
    *reinterpret_cast<uint32_t*>(stage + swz(r0, c)) =
        pack_bf16(acc[n][0] * scale0, acc[n][1] * scale0);
    *reinterpret_cast<uint32_t*>(stage + swz(r0 + 8, c)) =
        pack_bf16(acc[n][2] * scale1, acc[n][3] * scale1);
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int idx = lane + i * 32;  // 16 rows x 8 chunks
    const int r = warp * 16 + (idx >> 3), ch = idx & 7;
    *reinterpret_cast<uint4*>(dst + r * ld + ch * 8) =
        *reinterpret_cast<const uint4*>(stage + swz(r, ch * 8));
  }
}

}  // namespace
