// The block structure and load pipeline that kernel K2 (flash_attention.cu)
// and its backward K2b (flash_attention_bwd.cu) share on Hopper (sm_90a).
//
// A block is kGroups consumer warpgroups of 64 rows each (kRows rows in
// all; S % 128 == 0) and, in the bf16 K2b, one producer warpgroup whose
// first thread issues every load (K2's and the f32 K2b's consumers issue
// their loads themselves: start_loads and release_and_load below).  Each consumer warpgroup's own
// tiles (the rows it owns: Q in K2; K, V in dkv; Q, dO, O in dq) arrive
// once by TMA on one mbarrier; the
// tiles it streams past them (K, V in K2 and dq; Q, dO in dkv), with their
// 64 row values each (segment ids, lse, di), go through a ring of kStages
// stages, each with a full mbarrier and, to hand a stage back, an empty
// mbarrier that the producer waits on (K2b) or a count of the warpgroups
// done with it (K2).
//
// Skipping.  find_live_tiles takes the min and max segment id of every
// 64-row tile of the batch row and lists the streamed tiles whose
// [min, max] meets that of the block's own rows; a consumer warpgroup skips
// the products of a listed tile that misses its own 64 rows.  A tile outside
// a range shares no id with the rows in it, so every P entry of the pair is
// 0 and the skip is exact for any int32 ids.  Pads attend pads, so pad x pad
// tiles stay live, and a block's diagonal tiles always are: they come first
// in the list, so their loads start before the list is known.
//
// A block's size and its tiles are template parameters with K2b's values
// as defaults: kG consumer warpgroups (kGroups), kPer streamed tiles a
// stage (2: one each of two operands).  K2 and K2b stream a head dim past
// one tile as several 128-byte-wide slabs of each operand a stage, and K2's
// f32 forward takes one warpgroup a block where two would not fit in shared
// memory (flash_attention.cu, flash_attention_bwd.cu, the 3xTF32 kernels).
//
// Tensor maps are 4-D (D, H, S, B) over bf16 or f32 [B, H, S, D] views with
// any (b, h, s) strides that are multiples of 16 bytes, encoded on the host
// each call; a box is 64 rows of 128 bytes, and columns past D read as 0.

#pragma once

#include <cudaTypedefs.h>  // PFN_cuTensorMapEncodeTiled_v12000

#include "hopper_common.cuh"

namespace {

constexpr int kGroups = 2;                    // consumer warpgroups a block, 64 rows each
constexpr int kRows = 64 * kGroups;           // rows a block owns
constexpr int kBlockThreads = 128 * kGroups;  // consumer threads; a producer warpgroup follows
// registers a thread: the producer warpgroup gives back all but 24, the
// consumers take the rest of the register file (one block an SM)
constexpr int kProducerRegs = 24, kConsumerRegs = 240;

// Shared memory (see Smem below): 1024 bytes of slack to put the tiles on a
// 1024-byte boundary; n_own x kG own tiles and kPer x kStages streamed
// tiles; 16 barrier slots; 3 x kStages x 64 row values; 3 ints a tile plus
// one, and one a stage.
template <int kStages, int kG = kGroups, int kPer = 2>
constexpr int smem_bytes(int S, int n_own) {
  return 1024 + (n_own * kG + kPer * kStages) * kTileBytes + 16 * 8 + 3 * kStages * 64 * 4 +
         (3 * (S / 64) + 1 + kStages) * 4;
}

__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// The min and max segment id of each 64-row tile of the batch row, and the
// list of the streamed tiles whose [min, max] meets the block's own rows'
// (the kG tiles from `own`).  The list starts with the own tiles.
// Ends with the block synchronised.
template <int kG = kGroups>
__device__ void find_live_tiles(const int32_t* segb, int n_tiles, int own, int* tmin, int* tmax,
                                int* live, int* n_live) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int t = warp; t < n_tiles; t += blockDim.x >> 5) {
    const int a = segb[t * 64 + lane], c = segb[t * 64 + 32 + lane];
    const int lo = __reduce_min_sync(0xffffffffu, min(a, c));
    const int hi = __reduce_max_sync(0xffffffffu, max(a, c));
    if (lane == 0) tmin[t] = lo, tmax[t] = hi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int lo = tmin[own], hi = tmax[own];
    for (int i = 1; i < kG; ++i) lo = min(lo, tmin[own + i]), hi = max(hi, tmax[own + i]);
    int n = 0;
    for (int i = 0; i < kG; ++i) live[n++] = own + i;
    for (int t = 0; t < n_tiles; ++t) {
      if ((t < own || t >= own + kG) && tmin[t] <= hi && lo <= tmax[t]) live[n++] = t;
    }
    *n_live = n;
  }
  __syncthreads();
}

// The block's shared memory: each consumer warpgroup's own tiles, the ring
// of streamed tiles with their row values, the barriers, and each tile's min
// and max segment id with the live list.  Position i of the live list takes
// stage i % kStages.
template <int kStages, int kG = kGroups, int kPer = 2>
struct Smem {
  static_assert(kStages >= kG, "the diagonal tiles' loads take the first stages");
  __nv_bfloat16* own;     // [n_own][kG] tiles
  __nv_bfloat16* stream;  // [kStages][kPer] tiles
  uint64_t* full;         // [kStages]: a stage's loads have landed
  uint64_t* empty;        // [kStages]: the consumers are done with a stage
  uint64_t* own_full;     // the own tiles have landed
  float* rows;            // [3][kStages][64]
  int* tmin;
  int* tmax;
  int* live;
  int* n_live;
  int* done;  // [kStages]: warpgroups done with a stage (when no producer loads)

  __device__ __forceinline__ __nv_bfloat16* own_tile(int which, int group) const {
    return own + (which * kG + group) * kTileElems;
  }
  __device__ __forceinline__ __nv_bfloat16* stream_tile(int stage, int which) const {
    return stream + (stage * kPer + which) * kTileElems;
  }
  __device__ __forceinline__ float* row_values(int which, int stage) const {
    return rows + (which * kStages + stage) * 64;
  }
  // the consumers' side of the ring, by position i of the live list
  __device__ __forceinline__ void wait_full(int i) const {
    mbar_wait(&full[i % kStages], (i / kStages) & 1);
  }
  __device__ __forceinline__ void release(int i) const { mbar_arrive(&empty[i % kStages]); }
  // does tile t meet the rows whose segment ids lie in [lo, hi]?
  __device__ __forceinline__ bool meets(int t, int lo, int hi) const {
    return tmin[t] <= hi && lo <= tmax[t];
  }
};

template <int kStages, int kG = kGroups, int kPer = 2>
__device__ __forceinline__ Smem<kStages, kG, kPer> carve(unsigned char* raw, int n_tiles,
                                                         int n_own) {
  Smem<kStages, kG, kPer> m;
  m.own = reinterpret_cast<__nv_bfloat16*>(align_1024(raw));
  m.stream = m.own + n_own * kG * kTileElems;
  uint64_t* bars = reinterpret_cast<uint64_t*>(m.stream + kPer * kStages * kTileElems);
  m.full = bars;
  m.empty = bars + kStages;
  m.own_full = bars + 2 * kStages;
  m.rows = reinterpret_cast<float*>(bars + 16);
  m.tmin = reinterpret_cast<int*>(m.rows + 3 * kStages * 64);
  m.tmax = m.tmin + n_tiles;
  m.live = m.tmax + n_tiles;
  m.n_live = m.live + n_tiles;
  m.done = m.n_live + 1;
  return m;
}

// Set-up, by all threads.  The `loader` thread (by default the producer's
// first) sets up the barriers and starts the loads of the own tiles
// (`load_own`, on own_full, `own_bytes` in all) and of the block's diagonal
// tiles into the first stages (`load(t, stage)`, `bytes` each); then every
// thread helps find the live tiles.  Ends with the block synchronised.
template <int kStages, int kG, int kPer, typename LoadOwn, typename Load>
__device__ __forceinline__ void set_up(const Smem<kStages, kG, kPer>& m, const int32_t* segb,
                                       int n_tiles, int blk, uint32_t own_bytes,
                                       LoadOwn load_own, uint32_t bytes, Load load,
                                       int loader = 128 * kG) {
  if (threadIdx.x == loader) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&m.full[i], 1);
      mbar_init(&m.empty[i], 128 * kG);
      m.done[i] = 0;
    }
    mbar_init(m.own_full, 1);
    mbar_fence_init();
    mbar_expect_tx(m.own_full, own_bytes);
    load_own();
    for (int i = 0; i < kG; ++i) {
      mbar_expect_tx(&m.full[i], bytes);
      load(kG * blk + i, i);
    }
  }
  find_live_tiles<kG>(segb, n_tiles, kG * blk, m.tmin, m.tmax, m.live, m.n_live);
}

// The producer's loop (one thread), after set_up's first loads: for each
// further live tile, wait until the consumers have left its stage, then
// start its loads (`load(t, stage)`, `bytes` in all) on the stage's full
// barrier.
template <int kStages, int kG, int kPer, typename Load>
__device__ __forceinline__ void produce(const Smem<kStages, kG, kPer>& m, uint32_t bytes,
                                        Load load) {
  const int n_live = *m.n_live;
  for (int i = kG; i < n_live; ++i) {
    const int stage = i % kStages;
    if (i >= kStages) mbar_wait(&m.empty[stage], (i / kStages - 1) & 1);
    mbar_expect_tx(&m.full[stage], bytes);
    load(m.live[i], stage);
  }
}

// Loading without a producer: the consumers' side of the ring when the
// consumer warpgroups issue the loads themselves.  start_loads (one
// thread, after set_up) loads the live positions after the diagonal tiles
// into the stages still free; release_and_load (a whole warpgroup, done
// with position i)
// syncs the warpgroup's 128 threads, and the last warpgroup to be done
// with the stage loads position i + kStages into it.
template <int kStages, int kG, int kPer, typename Load>
__device__ __forceinline__ void start_loads(const Smem<kStages, kG, kPer>& m, uint32_t bytes,
                                            Load load) {
  const int n = min(kStages, *m.n_live);
  for (int i = kG; i < n; ++i) {
    mbar_expect_tx(&m.full[i], bytes);
    load(m.live[i], i);
  }
}
template <int kStages, int kG, int kPer, typename Load>
__device__ __forceinline__ void release_and_load(const Smem<kStages, kG, kPer>& m, int i, int wg,
                                                 uint32_t bytes, Load load) {
  named_sync(1 + wg, 128);
  const int stage = i % kStages;
  if ((threadIdx.x & 127) == 0 && atomicAdd(&m.done[stage], 1) == kG - 1) {
    m.done[stage] = 0;
    if (i + kStages < *m.n_live) {
      mbar_expect_tx(&m.full[stage], bytes);
      load(m.live[i + kStages], stage);
    }
  }
}

// A consumer warpgroup's loop, one tile at a time: for each live tile, wait
// for its stage, run `tile(stage)` if the tile meets the warpgroup's own
// rows (segment ids in [lo, hi]), and release the stage.
template <int kStages, int kG, int kPer, typename Tile>
__device__ __forceinline__ void consume(const Smem<kStages, kG, kPer>& m, int lo, int hi,
                                        Tile tile) {
  const int n_live = *m.n_live;
  for (int i = 0; i < n_live; ++i) {
    m.wait_full(i);
    if (m.meets(m.live[i], lo, hi)) tile(i % kStages);
    m.release(i);
  }
}

// cuTensorMapEncodeTiled, fetched from the driver through the runtime (the
// libraries link nothing but the runtime nvcc links by default).  Its
// signature is CUDA 12.0's (PFN_cuTensorMapEncodeTiled_v12000); from
// CUDA 12.5 the runtime asks for it by that version.
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static const PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) ptr = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(ptr);
  }();
  return fn;
}

// A 4-D tensor map (D, H, S, B) over a bf16 (or, with f32, an f32)
// [B, H, S, D] view with these element strides, its box 64 rows of one
// (b, h) by 128 bytes of columns (64 bf16 or 32 f32: a slab), swizzled by
// 128 bytes as wgmma's descriptors read it; a box that reaches past D reads
// zeros there.  The encoder needs the device's context current in the
// calling thread: make a runtime call first (autograd runs the backward,
// and remat's recompute of the forward, on a thread of its own).
int encode_tile_map(CUtensorMap* map, const void* base, int B, int H, int S, long long sb,
                    long long sh, long long ss, int D = kHeadDim, bool f32 = false) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t elem = f32 ? 4 : 2;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * elem,
                                 static_cast<cuuint64_t>(ss) * elem,
                                 static_cast<cuuint64_t>(sb) * elem};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(128 / elem), 1, 64, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                            4, const_cast<void*>(base),
                            dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// One tile's online-softmax step for this thread's two rows (g and g + 8 of
// its warp's 16; S in mma.sync's C layout, as wgmma's accumulator and
// mma.sync's m16n8 products give it), in place: S (raw Q . K^T of 64 keys)
// becomes P = exp2(S * scale_log2 - m_new * scale_log2) on the row's
// segment, exactly 0 off it; the running max m (raw units) and this thread's
// share l of each row's sum move on, and alpha is the rescale of the row's
// earlier output.  Masking: a cross-segment entry of P is exactly 0 (its
// logit is taken as -inf); a row whose running max is still -inf (it has
// met none of its keys yet) subtracts 0, so no exp2(-inf - -inf) = NaN
// arises and its sum, output and rescale stay 0.  kExact: exp2f (the f32
// forward, whose logsumexp is held within 1e-5), else the special-function
// unit's ex2.approx alone (P is rounded to bf16 next).
template <bool kExact>
__device__ __forceinline__ float exp2_of(float x) {
  return kExact ? exp2f(x) : exp2_approx(x);
}

template <bool kExact = false>
__device__ __forceinline__ void softmax_step(float (&s)[8][4], const int32_t* seg_t, int seg_lo,
                                             int seg_hi, int seg_q0, int seg_q1, int t4,
                                             float scale_log2, float (&m)[2], float (&l)[2],
                                             float (&alpha)[2]) {
  const float neg_inf = __int_as_float(0xff800000);
  if (seg_lo == seg_hi) {  // the tile's keys are of one segment: a row takes all or none
    if (seg_q0 != seg_lo) {
#pragma unroll
      for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = neg_inf;
    }
    if (seg_q1 != seg_lo) {
#pragma unroll
      for (int n = 0; n < 8; ++n) s[n][2] = s[n][3] = neg_inf;
    }
  } else {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int c = n * 8 + 2 * t4;  // the tile's keys c and c + 1
      const int sk0 = seg_t[c], sk1 = seg_t[c + 1];
      s[n][0] = sk0 == seg_q0 ? s[n][0] : neg_inf;
      s[n][1] = sk1 == seg_q0 ? s[n][1] : neg_inf;
      s[n][2] = sk0 == seg_q1 ? s[n][2] : neg_inf;
      s[n][3] = sk1 == seg_q1 ? s[n][3] : neg_inf;
    }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
  }
  float ms[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {  // a row's 64 keys lie across the 4 lanes of a quad
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    // a row with no key of its own yet: subtract 0, never -inf
    ms[i] = mx[i] == neg_inf ? 0.f : mx[i] * scale_log2;
    alpha[i] = exp2_of<kExact>(m[i] * scale_log2 - ms[i]);  // 0 while m was -inf
    m[i] = mx[i];
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    s[n][0] = exp2_of<kExact>(fmaf(s[n][0], scale_log2, -ms[0]));  // -inf -> 0
    s[n][1] = exp2_of<kExact>(fmaf(s[n][1], scale_log2, -ms[0]));
    s[n][2] = exp2_of<kExact>(fmaf(s[n][2], scale_log2, -ms[1]));
    s[n][3] = exp2_of<kExact>(fmaf(s[n][3], scale_log2, -ms[1]));
    rs[0] += s[n][0] + s[n][1];
    rs[1] += s[n][2] + s[n][3];
  }
  l[0] = l[0] * alpha[0] + rs[0];
  l[1] = l[1] * alpha[1] + rs[1];
}

// An accumulator's rows times their rescale: this thread's entries of row g
// (d[n][0..1]) by alpha[0], of row g + 8 (d[n][2..3]) by alpha[1].
template <int N>
__device__ __forceinline__ void scale_rows(float (&d)[N][4], const float (&alpha)[2]) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
    d[n][0] *= alpha[0];
    d[n][1] *= alpha[0];
    d[n][2] *= alpha[1];
    d[n][3] *= alpha[1];
  }
}

}  // namespace
