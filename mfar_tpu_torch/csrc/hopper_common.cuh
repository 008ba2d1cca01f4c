// Hopper (sm_90a) building blocks of K2 (flash_attention.cu) and K2b
// (flash_attention_bwd.cu): wgmma on 64 x 64 bf16 tiles in shared memory,
// mbarriers, and TMA loads.
//
// Tiles.  A tile is 64 rows of 64 bf16 (128 bytes a row) on a 1024-byte
// boundary, its 16-byte chunk c/8 of row r at chunk (c/8) ^ (r%8): the
// layout of flash_common.cuh's swz(), which is the one TMA writes under
// CU_TENSOR_MAP_SWIZZLE_128B and the one wgmma reads through a B128
// descriptor.
//
// wgmma.m64n64k16 (bf16 in, f32 accumulate, A from registers, B from a
// tile in shared memory).  A warpgroup is four warps;
// warp w of it holds rows 16w..16w+15 of the 64-row accumulator in
// mma.sync's C layout, one [4] per 8-wide column slice n (g = lane / 4,
// t4 = lane % 4):  d[n][0..1] = (16w+g, 8n+2t4..+1), d[n][2..3] = (16w+g+8,
// 8n+2t4..+1).  A from registers takes mma.sync's A layout per 16-wide k
// slice kc: a0 = (g, 16kc+2t4..), a1 = (g+8, ..), a2 = (g, 16kc+8+2t4..),
// a3 = (g+8, ..).  So an accumulator packed to bf16 as
//   a[kc] = {pack(d[2kc][0..1]), pack(d[2kc][2..3]), pack(d[2kc+1][0..1]),
//            pack(d[2kc+1][2..3])}
// is the A operand of the next product, with its columns as that product's k.
//
// Descriptors of B (the bits of CUTLASS's cute/arch/mma_sm90_desc.hpp):
// start address >> 4 in bits 0-13, leading byte offset >> 4 in 16-29, stride
// byte offset >> 4 in 32-45, layout 1 (128-byte swizzle) in 62-63.  One
// tile serves both ways:
//   K-major (the tile's rows are N, its 64 columns are k): 8-row groups
//     1024 bytes apart (SBO = 64); the leading offset is unused under the
//     swizzle (1).  k slice kk starts 32 bytes further: desc + 2 * kk.  An
//     A tile in shared memory (rows M, columns k) takes the same form.
//   MN-major (the tile's rows are k, its 64 columns are N; wgmma's
//     transpose-B immediate): 8-row groups of k 1024 bytes apart (SBO = 64);
//     the leading offset would step to the next 64 columns of N, which a
//     64-wide N does not have.  k slice kk starts 16 rows further:
//     desc + 128 * kk.

#pragma once

#include <cuda.h>  // CUtensorMap (a type only: the driver entry is fetched at run time)
#include <cuda_runtime.h>

#include <cstdint>

#include "flash_common.cuh"

namespace {

constexpr int kTileElems = kBlockN * kHeadDim;
constexpr int kTileBytes = kTileElems * 2;

__device__ __forceinline__ uint64_t tile_desc(const void* tile) {
  return static_cast<uint64_t>((smem_u32(tile) & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

#define MFAR_ACC32(d)                                                                         \
  "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),   \
      "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]),              \
      "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),              \
      "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]),              \
      "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]),              \
      "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])

#define MFAR_D32                                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d += A B, A from registers, B a tile in shared memory: K-major
// (kMnMajor = 0) or MN-major (1: wgmma's transpose-B immediate).
template <int kMnMajor>
__device__ __forceinline__ void wgmma_rs(float (&d)[8][4], const uint32_t (&a)[4], uint64_t b) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MFAR_D32
               ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
               : MFAR_ACC32(d)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(kMnMajor));
}

// A 64 x 64 x 64 product: four k slices of 16, which start 32 bytes (K-major
// B) or 16 rows (MN-major B) further into B's tile.
template <int kMnMajor>
__device__ __forceinline__ void gemm_rs(float (&d)[8][4], const uint32_t (&a)[4][4], uint64_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs<kMnMajor>(d, a[kk], b + (kMnMajor ? 128 : 2) * kk);
}

// d = A B (the accumulator's old value is dropped; with kAccumulate, d +=
// A B), A a K-major tile and B a K-major tile, both in shared memory: four
// k slices of 16, each 32 bytes further into both tiles.
template <bool kAccumulate = false>
__device__ __forceinline__ void gemm_ss_new(float (&d)[8][4], uint64_t a, uint64_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MFAR_D32
                 ", %32, %33, p, 1, 1, 0, 0;\n}\n"
                 : MFAR_ACC32(d)
                 : "l"(a + 2 * kk), "l"(b + 2 * kk), "r"(kAccumulate ? 1 : kk));
  }
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin registers that an in-flight wgmma reads or writes: the compiler may
// neither read an accumulator before the wait that ends its product nor
// reuse an A register before the product that reads it has ended.
__device__ __forceinline__ void pin(float (&d)[8][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+f"(d[n][i])::"memory");
  }
}
__device__ __forceinline__ void pin(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int n = 0; n < 4; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[n][i])::"memory");
  }
}

// 2^x by the special-function unit alone (ex2.approx, flushing subnormal
// results to 0): P is rounded to bf16 next, and exp2f's exact path for
// subnormal results costs the kernels a sixth of their time.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void zero(float (&d)[8][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n) d[n][0] = d[n][1] = d[n][2] = d[n][3] = 0.f;
}

// Barrier `id` (1..15) over `n` threads, e.g. one warpgroup.
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Make this thread's generic-proxy writes to shared memory visible to the
// async proxy (wgmma's and TMA's reads); then a barrier hands them on.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- mbarriers and TMA -----------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One box (64 rows of 128 bytes) of a 4-D tensor map (D, H, S, B) at
// (col, h, s0, b): columns past D arrive as zeros.
__device__ __forceinline__ void tma_load_tile(void* dst, const CUtensorMap* map, uint64_t* bar,
                                              int h, int s0, int b, int col = 0) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col), "r"(h), "r"(s0),
      "r"(b)
      : "memory");
}

// `bytes` contiguous bytes (a multiple of 16, both ends 16-byte aligned).
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

}  // namespace
