// Tile helpers shared by kernel K2 (flash_attention.cu) and its backward K2b
// (flash_attention_bwd.cu), written for Hopper (sm_90a): the swizzled layout
// of a 64 x 64 bf16 tile in shared memory, the A fragments that wgmma takes
// from registers (loaded from such a tile with ldmatrix), the store of a
// 64-row f32 accumulator as bf16 rows through such a tile, and the shift of
// a tile's columns (bf16, or f32 in 3xTF32's [64][32] slabs, which swizzle
// their 16-byte chunks alike) that puts a head's first column at column 0.
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

// Stage the warp's 16 x 64 f32 accumulators (C layout, one per 8-wide
// column slice) as bf16, times each row's scale, in the warp's own rows of a
// swizzled tile in shared memory.
__device__ __forceinline__ void stage_rows(__nv_bfloat16* stage, const float (&acc)[8][4],
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
}

// Store the warp's 16 x 64 f32 accumulators as bf16: staged (stage_rows),
// then written in 16-byte chunks to rows that lie `ld` elements apart from
// `dst` (the block's first row), the first `cols` columns only (a multiple
// of 8).
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, long long ld,
                                           __nv_bfloat16* stage, const float (&acc)[8][4],
                                           float scale0, float scale1, int warp, int lane,
                                           int cols = kHeadDim) {
  stage_rows(stage, acc, scale0, scale1, warp, lane);
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

// store_rows for rows that start off a 16-byte boundary (a head of D
// columns at h * D of a row, D not a multiple of 8): the staged columns
// lo..hi-1 written to dst + lo..hi-1, `vec` elements a store: vec 2 (4
// bytes: lo, hi, `ld` and dst's offset even) or 1.
__device__ __forceinline__ void store_rows_narrow(__nv_bfloat16* dst, long long ld,
                                                  __nv_bfloat16* stage, const float (&acc)[8][4],
                                                  float scale0, float scale1, int warp, int lane,
                                                  int lo, int hi, int vec) {
  stage_rows(stage, acc, scale0, scale1, warp, lane);
  const int per_row = (hi - lo) / vec;
  for (int idx = lane; idx < 16 * per_row; idx += 32) {
    const int r = warp * 16 + idx / per_row, c = lo + (idx % per_row) * vec;
    if (vec == 2) {
      *reinterpret_cast<uint32_t*>(dst + r * ld + c) =
          *reinterpret_cast<const uint32_t*>(stage + swz(r, c));
    } else {
      dst[r * ld + c] = stage[swz(r, c)];
    }
  }
}

// The 16 bytes that start OFF 2-byte units into the 32 of chunks a, b (a
// first): words picked at compile time, a funnel shift for an odd OFF.
template <int OFF>
__device__ __forceinline__ uint4 shift_chunk(const uint4& a, const uint4& b) {
  const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  uint32_t o[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    o[k] = OFF & 1 ? __funnelshift_r(w[k + OFF / 2], w[k + OFF / 2 + 1], 16) : w[k + OFF / 2];
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// shift_rows at a shift known at compile time, by NWARPS warps: each lane
// reads its chunks of a slab in all its rows, the warp syncs, then the
// lane writes them; at OFF 0 only the chunks that reach `zero_from` are
// written.
template <int NS, int OFF, int NWARPS>
__device__ __forceinline__ void shift_rows_by(__nv_bfloat16* base, int slab_stride, int zero_from,
                                              int w, int lane) {
  constexpr int kRounds = 64 / (4 * NWARPS);  // rows a lane takes in a slab
  const int j = lane & 7;                     // the chunk of the slab this lane writes
  const int r0 = w * 4 + (lane >> 3);         // its rows: r0 + 4 * NWARPS * n
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const int keep = zero_from - (64 * s + 8 * j);  // leading 2-byte units kept
    if (OFF == 0 && keep >= 8) continue;
    uint4 out[kRounds];
#pragma unroll
    for (int n = 0; n < kRounds; ++n) {
      const int r = r0 + 4 * NWARPS * n;  // r % 8 == r0 % 8
      const __nv_bfloat16* row = base + s * slab_stride + r * kHeadDim;
      out[n] = *reinterpret_cast<const uint4*>(row + ((j ^ (r0 & 7)) << 3));
      if (OFF != 0) {
        uint4 b = make_uint4(0, 0, 0, 0);
        if (j < 7) {
          b = *reinterpret_cast<const uint4*>(row + (((j + 1) ^ (r0 & 7)) << 3));
        } else if (s + 1 < NS) {  // the next slab's first chunk
          b = *reinterpret_cast<const uint4*>(row + slab_stride + ((r0 & 7) << 3));
        }
        out[n] = shift_chunk<OFF>(out[n], b);
      }
      if (keep < 8) {
        uint32_t* ow = reinterpret_cast<uint32_t*>(&out[n]);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          ow[k] = 2 * k >= keep ? 0u : 2 * k + 1 >= keep ? ow[k] & 0xffffu : ow[k];
        }
      }
    }
    if (OFF != 0) __syncwarp();  // the warp's rows read before any chunk of them is written
#pragma unroll
    for (int n = 0; n < kRounds; ++n) {
      const int r = r0 + 4 * NWARPS * n;
      *reinterpret_cast<uint4*>(base + s * slab_stride + r * kHeadDim + ((j ^ (r0 & 7)) << 3)) =
          out[n];
    }
    if (OFF != 0) __syncwarp();
  }
}

// Move every row of NS swizzled slabs of 128 bytes a row (64 rows; slab s at
// base + s * slab_stride, in 2-byte units: 64 bf16 or 32 f32 a row) `off`
// (0..7) 2-byte units to the left, in place: unit c takes unit c + off, 0
// past the last; then set the units from `zero_from` on to 0.  By NWARPS
// warps (`w` this warp's index among them; 4 or 8), 8 lanes a row, one
// 16-byte chunk a lane: each warp reads its rows' chunks of a slab, then
// writes them, slab by slab in order, so no chunk is written before it is
// read.  The caller makes the writes visible (a barrier; for wgmma's and
// TMA's async proxy first fence_proxy_async).
template <int NS, int NWARPS>
__device__ __forceinline__ void shift_rows(__nv_bfloat16* base, int slab_stride, int off,
                                           int zero_from, int w, int lane) {
  switch (off) {
    case 0: return shift_rows_by<NS, 0, NWARPS>(base, slab_stride, zero_from, w, lane);
    case 1: return shift_rows_by<NS, 1, NWARPS>(base, slab_stride, zero_from, w, lane);
    case 2: return shift_rows_by<NS, 2, NWARPS>(base, slab_stride, zero_from, w, lane);
    case 3: return shift_rows_by<NS, 3, NWARPS>(base, slab_stride, zero_from, w, lane);
    case 4: return shift_rows_by<NS, 4, NWARPS>(base, slab_stride, zero_from, w, lane);
    case 5: return shift_rows_by<NS, 5, NWARPS>(base, slab_stride, zero_from, w, lane);
    case 6: return shift_rows_by<NS, 6, NWARPS>(base, slab_stride, zero_from, w, lane);
    default: return shift_rows_by<NS, 7, NWARPS>(base, slab_stride, zero_from, w, lane);
  }
}

}  // namespace
