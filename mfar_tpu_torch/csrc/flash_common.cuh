// Tile helpers shared by kernel K2 (flash_attention.cu) and its backward K2b
// (flash_attention_bwd.cu), written for Hopper (sm_90a): the swizzled layout
// of a 64 x 64 bf16 tile in shared memory, the A fragments that wgmma takes
// from registers (loaded from such a tile with ldmatrix), and the store of a
// 64-row f32 accumulator as bf16 rows through such a tile.
//
// Fragment layouts (the m16n8k16 ones that wgmma's register operands and
// accumulators follow, per warp of 16 rows; g = lane / 4, t4 = lane % 4):
//   A (16 x 16, rows x k):  a0 (g, 2t4..+1)  a1 (g+8, 2t4..+1)
//                           a2 (g, 2t4+8..+9) a3 (g+8, 2t4+8..+9)
//   C (16 x 8):             c0 c1 (g, 2t4..+1)  c2 c3 (g+8, 2t4..+1)

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kHeadDim = 64;
constexpr int kBlockN = 64;  // rows of a tile (keys or queries)
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

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// Two floats as a bf16 pair, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A fragments of the warp's 16 rows of a swizzled [64][64] tile, one per
// 16-wide slice `kc` of the 64 columns.
__device__ __forceinline__ void load_a_fragment(uint32_t (&a)[4], const __nv_bfloat16* tile,
                                                int warp, int lane, int kc) {
  const int r = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  ldmatrix_x4(a, tile + swz(r, kc * 16 + (lane >> 4) * 8));
}

// Store the warp's 16 x 64 f32 accumulators (C layout, one per 8-wide
// column slice) as bf16: staged in the warp's own rows of a swizzled tile
// in shared memory, then written in 16-byte chunks to rows that lie `ld`
// elements apart from `dst` (the block's first row), the first `cols`
// columns only (a multiple of 8).
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, long long ld,
                                           __nv_bfloat16* stage, const float (&acc)[8][4],
                                           float scale0, float scale1, int warp, int lane,
                                           int cols = kHeadDim) {
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
    if (ch * 8 < cols) {
      *reinterpret_cast<uint4*>(dst + r * ld + ch * 8) =
          *reinterpret_cast<const uint4*>(stage + swz(r, ch * 8));
    }
  }
}

}  // namespace
