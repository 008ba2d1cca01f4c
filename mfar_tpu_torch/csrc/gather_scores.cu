// Kernel K1: the stage-2 rerank gather, written for Hopper (sm_90a), in two
// schedules that compute one function:
//
//   out[b, c, f] = sum_e q[b, e] * D[ids[b, c], f*E + e]      (f32 accumulation)
//
// Replaces the TPU kernel mfar_tpu/ops/pallas_kernels.py::
// gather_per_field_scores_pallas (body _gather_score_kernel).  Like it, both
// schedules read each candidate's row of the flat [N, F*E] corpus in place and
// never materialise the [B, C, F*E] gather in device memory.  What the TPU
// kernel needed and these do not: the unit/pair row-DMA views, TILE_C=8,
// scalar prefetch and the megacore split exist for Mosaic's (8, 128) tiling
// and the TPU's two cores.  On the card the flat corpus is read where it
// lies, so no second corpus copy exists and C need not be a multiple of
// anything.  What the TPU kernel's cross-row prefetch does has a counterpart
// here: K1x below.
//
// K1, the row-local schedule (the TPU kernel's default, pallas_kernels.py:
// 108-120; simple and right first):
//   grid  = (ceil(C / WARPS), B); block = WARPS warps; one warp per candidate.
//   The block stages q[b] (E floats) in shared memory.  Each warp reads its
//   candidate's contiguous row with 16-byte vector loads (8 bf16 or 4 f32 per
//   lane), multiplies in f32, reduces each field's segment across the warp
//   with __shfl_xor_sync, and lane 0 writes out[b, c, f].
//   An id outside [0, N) scores NaN instead of reading out of bounds.
//   No copy overlaps a reduction and no row is fetched ahead: within a field
//   a lane has one or two loads in flight, then the shuffle tree runs.
//
// K1x, the cross-row schedule: replaces pallas_kernels.py:92-107
// (cross_row_prefetch=True, megacore=False), where the double buffer's slot
// follows the global tile index g = b*n_tiles + tile, so the last tile of
// query row b prefetches (b+1, tile 0) and one sequential walk covers the
// whole grid.  Here:
//   grid  = persistent: SMs x the blocks an SM holds; each warp owns one
//   contiguous span of the flat candidate index g = b*C + c (64-bit) and
//   walks it in order, across query rows.  A warp with an empty span exits.
//   Each warp has two slots of F*E corpus values and an E-float q buffer in
//   dynamic shared memory; a block has as many warps (up to 8) as 227 KB
//   holds, and the wrapper refuses a row whose two slots do not fit.  At step i, lane l starts cp.async (16-byte,
//   .cg: L2 only) copies of the vectors of row g+1 that it will read itself
//   into slot (i+1)&1 and commits the group (an empty one at the span's
//   end, or for an id outside [0, N), which issues no copy and scores NaN),
//   then waits for all but that group (cp.async.wait_group 1) and scores
//   slot i&1.  When the walk crosses into a new query row the warp restages
//   q[b] in its buffer between two __syncwarp()s.  Scoring keeps K1's lane
//   assignment, fmaf order and shuffle tree, so K1x is bit-equal to K1.
//
// What bounds both: bytes.  Every distinct candidate row is read once:
//   rows*F*E*sizeof(corpus dtype) + B*C*8 (ids) + B*E*4 (q) + B*C*F*4 (out)
// at 3.35 TB/s (H100 SXM).  At the serving shapes (B=64, C=512, F=5, E=768,
// bf16) that is ~223 MB on serving ids (~29,100 distinct rows), ~67 us.  Its
// arithmetic (2 flops per element read) is far below the card's ridge point.
// K1 leaves the memory system idle while a warp reduces; K1x keeps a whole
// row (7,680 bytes in bf16 at serving width) in flight per warp while the
// previous row is reduced, across query-row boundaries.  K1x reads a row
// again for each candidate that repeats it, as K1 does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;  // candidates per block
constexpr int kLanes = 32;

// Multiply one 16-byte vector of corpus values with the matching q values
// from shared memory and add to acc.
__device__ __forceinline__ float dot_vec(const uint4& v, const float* qs, float acc, float) {
  const float4* q4 = reinterpret_cast<const float4*>(qs);
  float4 a = q4[0];
  acc = fmaf(__uint_as_float(v.x), a.x, acc);
  acc = fmaf(__uint_as_float(v.y), a.y, acc);
  acc = fmaf(__uint_as_float(v.z), a.z, acc);
  acc = fmaf(__uint_as_float(v.w), a.w, acc);
  return acc;
}

__device__ __forceinline__ float dot_vec(const uint4& v, const float* qs, float acc, __nv_bfloat16) {
  const float4* q4 = reinterpret_cast<const float4*>(qs);
  float4 a = q4[0];
  float4 b = q4[1];
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
  float2 x0 = __bfloat1622float2(h[0]);
  float2 x1 = __bfloat1622float2(h[1]);
  float2 x2 = __bfloat1622float2(h[2]);
  float2 x3 = __bfloat1622float2(h[3]);
  acc = fmaf(x0.x, a.x, acc);
  acc = fmaf(x0.y, a.y, acc);
  acc = fmaf(x1.x, a.z, acc);
  acc = fmaf(x1.y, a.w, acc);
  acc = fmaf(x2.x, b.x, acc);
  acc = fmaf(x2.y, b.y, acc);
  acc = fmaf(x3.x, b.z, acc);
  acc = fmaf(x3.y, b.w, acc);
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(kWarps * kLanes)
gather_scores_kernel(const float* __restrict__ q,        // [B, E]
                     const T* __restrict__ docs,         // [N, F*E]
                     const int64_t* __restrict__ ids,    // [B, C]
                     float* __restrict__ out,            // [B, C, F]
                     int C, long long N, int F, int E) {
  constexpr int kVec = 16 / sizeof(T);  // corpus values per 16-byte load
  extern __shared__ __align__(16) float q_s[];  // [E]

  const int b = blockIdx.y;
  const float* qb = q + static_cast<long long>(b) * E;
  for (int e = threadIdx.x * 4; e < E; e += blockDim.x * 4) {
    // E % kVec == 0 and kVec >= 4, so E is a multiple of 4 floats
    *reinterpret_cast<float4*>(q_s + e) = *reinterpret_cast<const float4*>(qb + e);
  }
  __syncthreads();

  const int warp = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int c = blockIdx.x * kWarps + warp;
  if (c >= C) return;

  const long long slot = static_cast<long long>(b) * C + c;
  float* o = out + slot * F;
  const int64_t id = ids[slot];
  if (id < 0 || id >= N) {
    for (int f = lane; f < F; f += kLanes) o[f] = __int_as_float(0x7fc00000);  // NaN
    return;
  }

  const long long fe = static_cast<long long>(F) * E;
  const uint4* row = reinterpret_cast<const uint4*>(docs + id * fe);
  const int vec_per_field = E / kVec;
  for (int f = 0; f < F; ++f) {
    const uint4* seg = row + static_cast<long long>(f) * vec_per_field;
    float acc = 0.f;
#pragma unroll 4
    for (int v = lane; v < vec_per_field; v += kLanes) {
      const uint4 x = __ldg(seg + v);
      acc = dot_vec(x, q_s + v * kVec, acc, T());
    }
#pragma unroll
    for (int off = kLanes / 2; off > 0; off /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) o[f] = acc;
  }
}

// ---- K1x: the cross-row schedule --------------------------------------------

// Warps a block at most.  At serving width the block takes 8 warps in bf16
// (147 KB, one block an SM) and 6 in f32 (the 227 KB a block may use); more
// warps an SM, or three or four row slots a warp, ran no faster on an H100.
constexpr int kMaxCrossRowWarps = 8;

__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most this thread's latest group is in flight.
__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Bytes of dynamic shared memory one warp of K1x uses: two row slots and q.
__host__ __device__ __forceinline__ long long cross_row_warp_bytes(int F, int E, int elem) {
  return 2LL * F * E * elem + 4LL * E;
}

template <typename T>
__global__ void __launch_bounds__(kMaxCrossRowWarps * kLanes)
gather_scores_cross_row_kernel(const float* __restrict__ q,        // [B, E]
                               const T* __restrict__ docs,         // [N, F*E]
                               const int64_t* __restrict__ ids,    // [B, C]
                               float* __restrict__ out,            // [B, C, F]
                               long long total, int C, long long N, int F, int E) {
  constexpr int kVec = 16 / sizeof(T);  // corpus values per 16-byte copy
  extern __shared__ __align__(16) unsigned char smem[];

  const int warps = blockDim.x / kLanes;
  const int warp = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const long long n_warps = static_cast<long long>(gridDim.x) * warps;
  const long long w = static_cast<long long>(blockIdx.x) * warps + warp;
  const long long begin = total * w / n_warps;
  const long long end = total * (w + 1) / n_warps;
  if (begin >= end) return;

  const long long fe = static_cast<long long>(F) * E;
  const long long slot_bytes = fe * static_cast<long long>(sizeof(T));
  unsigned char* mine = smem + warp * cross_row_warp_bytes(F, E, sizeof(T));  // slots 0, 1, q
  float* q_s = reinterpret_cast<float*>(mine + 2 * slot_bytes);  // [E]
  const int vec_per_field = E / kVec;

  // Start the copies of candidate g's row into slot s: each lane the
  // vectors it reads back when scoring (field by field, vectors lane,
  // lane + 32, ...), so a lane's own wait_group orders its reads.  One
  // group is committed whatever the id (an empty one past the span's end or
  // for an id outside [0, N)), so wait_group 1 always leaves row g landed.
  auto fetch = [&](long long g, int s) {
    const int64_t id = g < end ? ids[g] : -1;
    if (id >= 0 && id < N) {
      const uint4* row = reinterpret_cast<const uint4*>(docs + id * fe);
      uint4* dst = reinterpret_cast<uint4*>(mine + s * slot_bytes);
      for (int f = 0; f < F; ++f) {
        const int base = f * vec_per_field;
        for (int v = lane; v < vec_per_field; v += kLanes) {
          cp_async_16(dst + base + v, row + base + v);
        }
      }
    }
    cp_async_commit();
  };

  fetch(begin, 0);
  long long staged_b = -1;
  for (long long g = begin; g < end; ++g) {
    const int s = static_cast<int>((g - begin) & 1);  // the slot of row g
    fetch(g + 1, s ^ 1);  // in flight while row g is scored
    cp_async_wait_all_but_one();  // row g has landed (this lane's vectors)
    __syncwarp();

    const long long b = g / C;
    if (b != staged_b) {  // the walk crossed into query row b: restage q[b]
      const float* qb = q + b * E;
      for (int e = lane * 4; e < E; e += kLanes * 4) {
        *reinterpret_cast<float4*>(q_s + e) = __ldg(reinterpret_cast<const float4*>(qb + e));
      }
      __syncwarp();
      staged_b = b;
    }

    float* o = out + g * F;
    const int64_t id = ids[g];
    if (id < 0 || id >= N) {
      for (int f = lane; f < F; f += kLanes) o[f] = __int_as_float(0x7fc00000);  // NaN
    } else {
      const uint4* row = reinterpret_cast<const uint4*>(mine + s * slot_bytes);
      for (int f = 0; f < F; ++f) {
        const uint4* seg = row + f * vec_per_field;
        float acc = 0.f;
#pragma unroll 4
        for (int v = lane; v < vec_per_field; v += kLanes) {
          const uint4 x = seg[v];
          acc = dot_vec(x, q_s + v * kVec, acc, T());
        }
#pragma unroll
        for (int off = kLanes / 2; off > 0; off /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, off);
        if (lane == 0) o[f] = acc;
      }
    }
    __syncwarp();  // every lane has read q_s before a restage overwrites it
  }
}

template <typename T>
int launch_cross_row(const float* q, const T* docs, const int64_t* ids, float* out, int B, int C,
                     long long N, int F, int E, cudaStream_t stream) {
  int dev = 0, sms = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long per_warp = cross_row_warp_bytes(F, E, sizeof(T));
  const long long total = static_cast<long long>(B) * C;
  long long warps = smem_max / per_warp;
  if (warps > kMaxCrossRowWarps) warps = kMaxCrossRowWarps;
  if (warps > total) warps = total;
  if (warps < 1) return static_cast<int>(cudaErrorInvalidValue);  // the wrapper checked this
  const int threads = static_cast<int>(warps) * kLanes;
  const size_t smem = static_cast<size_t>(warps * per_warp);
  err = cudaFuncSetAttribute(gather_scores_cross_row_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gather_scores_cross_row_kernel<T>,
                                                      threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long blocks = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const long long needed = (total + warps - 1) / warps;  // no warp without a candidate
  if (blocks > needed) blocks = needed;
  gather_scores_cross_row_kernel<T><<<static_cast<unsigned>(blocks), threads, smem, stream>>>(
      q, docs, ids, out, total, C, N, F, E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32 corpus, 1 = bfloat16 corpus.  Returns cudaGetLastError()
// after the launch (0 = launched).  The caller has checked shapes, types,
// contiguity and 16-byte alignment (E % (16 / sizeof(dtype)) == 0).
extern "C" int mfar_gather_per_field_scores(const float* q, const void* docs, const int64_t* ids,
                                            float* out, int B, int C, long long N, int F, int E,
                                            int dtype, cudaStream_t stream) {
  if (B == 0 || C == 0 || F == 0) return 0;
  const dim3 grid((C + kWarps - 1) / kWarps, B);
  const dim3 block(kWarps * kLanes);
  const size_t smem = static_cast<size_t>(E) * sizeof(float);
  if (dtype == 0) {
    gather_scores_kernel<float><<<grid, block, smem, stream>>>(
        q, static_cast<const float*>(docs), ids, out, C, N, F, E);
  } else if (dtype == 1) {
    gather_scores_kernel<__nv_bfloat16><<<grid, block, smem, stream>>>(
        q, static_cast<const __nv_bfloat16*>(docs), ids, out, C, N, F, E);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// K1x: the cross-row schedule, same arguments and contract as
// mfar_gather_per_field_scores.  One warp's two row slots and q must fit a
// block's shared memory (mfar_gather_cross_row_smem_limit); the launch
// returns cudaErrorInvalidValue where they do not.
extern "C" int mfar_gather_per_field_scores_cross_row(const float* q, const void* docs,
                                                      const int64_t* ids, float* out, int B,
                                                      int C, long long N, int F, int E,
                                                      int dtype, cudaStream_t stream) {
  if (B == 0 || C == 0 || F == 0) return 0;
  if (dtype == 0) {
    return launch_cross_row(q, static_cast<const float*>(docs), ids, out, B, C, N, F, E, stream);
  }
  if (dtype == 1) {
    return launch_cross_row(q, static_cast<const __nv_bfloat16*>(docs), ids, out, B, C, N, F, E,
                            stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The dynamic shared memory a block of the current device may opt into
// (227 KB on an H100), or -1 where the device cannot be read.
extern "C" long long mfar_gather_cross_row_smem_limit() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess) {
    return -1;
  }
  return bytes;
}
