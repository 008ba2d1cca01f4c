// Kernel K2 in f32: the encoder's flash-attention forward with segment
// masking for f32 inputs, on Hopper's tensor cores (sm_90a) in 3xTF32.
//
//   O[b,h,i] = softmax_j(Q[b,h,i] . K[b,h,j] * sm_scale, over the keys j with
//                        seg[b,j] == seg[b,i]) . V[b,h]
//
// q/k/v/o are f32 [B, H, S, D], D a multiple of 4 up to 256, read and
// written through their strides (D contiguous; the others multiples of 16
// bytes), seg is int32 [B, S], S is a multiple of 128.  Under training the
// kernel also writes each row's logsumexp of the scaled, masked logits
// (natural log, f32 [B, H, S]), which the backward kernels read
// (flash_attention_tf32_bwd.cu).  f32 inputs that neither mode below reads
// reach this kernel as zero-padded copies at D rounded up to 4 (the
// "tf32_pad" route of ops/flash_attention.py).
//
// Rows mode (mfar_flash_attention_fwd_tf32_rows, kRowMap; built from this
// source as a library of its own, flash_attention_tf32_rows.cu, so that the
// two modes' instances build in parallel): at a D that is not a multiple of
// 4 (TinyBERT-4L-312D's 26), q, k and v are views whose heads lie side by
// side in rows (the H stride D), each head's rows starting on any 4-byte
// boundary.  The kernel reads every operand from global memory itself (no
// tensor map), so the rows mode differs only in its loads: four 4-byte
// loads where the per-head mode takes one 16-byte load, each column from
// D on read as 0.  The split pass writes a head's column c at column c of
// its tiles whatever its place in the row, so no pass moves a head's
// columns in shared memory: the load's address does.  S, P, O and the
// logsumexp are bit-equal to the per-head kernel on copies zero-padded to
// D rounded up to 4 (both take the same instance, the same k steps and the
// same halves of a cluster).  O is stored 8 bytes a store at even D, else 4.
//
// Replaces the forward of JAX's library Pallas flash_attention at f32:
// _flash_attention_kernel (jax/experimental/pallas/ops/tpu/flash_attention.py
// :331, pl.pallas_call at :758, jax 0.9.0), called at
// mfar_tpu/models/encoder.py:170 (an f32 model: EncoderConfig.tiny, the
// synthetic models, --precision 32).
//
// f32 accuracy on TF32 tensor cores (tf32_common.cuh): each f32 operand
// split into two TF32 parts, hi rounded to nearest (to_tf32) and lo = x - hi
// rounded so, each product taken as three TF32 products summed in f32 (lo
// lo', below 2^-22 of the product, dropped).  Both products are done so:
// S = Q K^T, and O += P V with P split the same way.  The order of the sums:
// O k step by k step of 8 keys, lo hi', then hi lo', then hi hi'
// (mma_3xtf32's order, tf32_common.cuh); S the cross terms of every k step
// first (lo hi', hi lo' a k step), then hi hi' of every k step, so that the
// small terms are summed while the sum is small and the sum of the whole S
// meets ceil(D / 8) additions at its full size instead of three times as
// many (the tensor cores add each k step's products to the f32 sum).  The
// result keeps f32 accuracy (held to the f32 gates: output 2e-5, logsumexp
// 1e-5), which one TF32 product (10 bits of mantissa) would not.
//
// What bounds it: operations.  f32-accurate products cost three TF32
// products at 495 TFLOP/s: at the f32 index build's [256, 12, 512, 64] the
// 140.3 GFLOP over chip_smoke's same-segment pairs take 0.85 ms against
// 0.48 ms for q, k, v and o; with the logsumexp at [96, 12, 512, 64] 0.32
// ms against 0.18 ms of bytes; at D = 256 four times the operations.
//
// Design.  Both products on wgmma.m64nNk8.f32.tf32.tf32, every operand
// split once:
//   block = two consumer warpgroups of 64 query rows (128 rows share every
//        split tile) and a producer warpgroup, 384 threads, one block an SM
//        (setmaxnreg: the consumers take 184 registers, the producer 136).
//        The grid is (b, h)-major, so the blocks of one head run together
//        and find its K and V in L2.
//   Q: split once at the block's start by all 384 threads, from global
//        memory into hi and lo tiles in shared memory (K-major, 128-byte
//        swizzle, [64][32] f32 slabs), which S = Q K^T reads as its A
//        through descriptors (wgmma's ss form: no register holds Q).
//   K, V: the producer warpgroup reads a step's kKeys keys from global
//        memory (16-byte loads, issued before it waits for the stage) and
//        splits each value once into a ring stage: K's hi and lo at their
//        columns (S's B, N = kKeys), V transposed (V^T's hi and lo, [32
//        NS][32 keys] slabs, O's B, N = the block's columns rounded up to
//        32), the keys of each group of 8 permuted (key 2i at k index i, 2i
//        + 1 at i + 4), so that a thread's P entries of keys 2t4 and 2t4 + 1
//        (the accumulator's layout) serve as its A entries of k = t4 and t4
//        + 4: P goes from the S accumulator to O's A registers with no
//        shuffle.  K and V have rings of their own (full: 128 producer
//        arrivals after fence.proxy.async; empty: 256 consumer arrivals), so
//        the producer refills K while the consumers take O, and V while they
//        take S.
//   products, per step and consumer warpgroup: S (64 x kKeys) over the k
//        steps of 8 columns before the block's D only; the online softmax
//        over the step (softmax_step, exp2f); P split once in registers;
//        O += P V over kKeys / 8 k steps, N = 32 NS.  Each product is one
//        commit group.  kKeys is 64 up to D = 64 and 32 past it, where a
//        64-key stage of K or V^T would not fit beside Q.
//   head dims past 128: a cluster of two blocks, each over half the head
//        dim's columns (ceil(D / 2) rounded up to 8, and the rest: 96 each
//        at D = 192, 128 at 256), each summing S over its columns; each
//        warpgroup writes its partial S (16 floats a thread, 16-byte stores)
//        into the other block's exchange tile (st.shared::cluster), arrives
//        on its barrier and adds what the other wrote (f32 addition
//        commutes: both blocks get the same bits and so the same P); each
//        block then takes O for its columns, the first block writes the
//        logsumexp.
//   Budget (shared memory, of 227 KB; a K stage holds K's hi and lo, a V
//        stage V^T's):
//        NS = 1 (D <= 32):   64-key steps, Q 32 KB, 3 + 3 stages of 16 KB:
//                            128 KB
//        NS = 2 (D <= 64):   64-key steps, Q 64 KB, 2 + 2 stages of 32 KB:
//                            192 KB
//        NS = 3 (D <= 96):   32-key steps, Q 96 KB, 2 + 2 stages of 24 KB:
//                            192 KB; at D 132-192 a cluster, each block 3
//                            slabs and a 16 KB exchange: 208 KB
//        NS = 4 (D <= 128):  32-key steps, Q 128 KB, 2 + 1 stages of 32 KB:
//                            224 KB; at D 196-256 a cluster, 1 + 1 stages and
//                            the exchange: 208 KB
//        (and 12 bytes a 64-row tile of S for the segment-id bounds and the
//        live list).  Registers of a consumer thread: O's 16 NS, S's kKeys
//        / 2, P's hi and lo kKeys (all of a step's k steps split before the
//        product is issued).
//   Choices.  Past D = 128 the block's 128 rows of Q split alone would be
//        256 KB: the head dim is split over two blocks (32-key steps or O's
//        columns over a cluster keep the whole of Q in each block).
//        64-key steps in the cluster at D 132-192 ran 7% faster but spill
//        at 184 registers (flash_variants.py --kernel k2_tf32 cluster64).
//        This design replaces the mma.sync one at every D: in turns it is
//        faster at every D timed (64, 128, 192, 256; flash_variants.py
//        --kernel k2_tf32 --against).  O = P V takes P as A from registers
//        and V^T as B, so that alpha rescales O's rows in the accumulator
//        each thread holds; the transposed form (O^T = V^T P^T, P split into
//        a K-major tile in shared memory: 32 KB a warpgroup) would need that
//        tile beside Q and the stages, which the budget does not have past
//        NS = 1, and each row's alpha at the accumulator's columns.
//   skipping: key tiles (64 keys) whose segment-id [min, max] misses the
//        block's rows are never loaded, and a warpgroup skips the products
//        of a loaded step whose tile misses its own 64 rows (exact for any
//        int32 ids).
//   No work past D: S's k steps of 8 stop at the block's columns; O's N is
//        the block's columns rounded up to 32 (in a cluster at D 132-159
//        the second block's N is 96 for its 60-76 columns).
//
// Masking: a cross-segment entry of P is exactly 0 (its logit is taken as
// -inf), where JAX adds its finite -0.7 * FLT_MAX and relies on exp
// underflowing; a row that has met none of its keys yet takes its running
// max as 0 for the subtraction (hopper_pipeline.cuh, softmax_step), so no
// NaN arises and its sum, output and rescale stay 0.  Every row has at
// least its own key, so the end sum is at least 1 and lse is finite.

#include <climits>

#include "hopper_pipeline.cuh"
#include "tf32_common.cuh"

namespace {

struct Tf32Params {
  const float* q;
  const float* k;
  const float* v;
  const int32_t* seg;
  float* o;
  float* lse;  // [B, H, S] row logsumexp in natural units, or null
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss;
  int H, S, D;
  float scale_log2;  // sm_scale * log2(e)
  bool pairs;        // O stored two columns a store (8-byte aligned rows), else one
};

constexpr int kThreads = 384;  // two consumer warpgroups, then the producer
constexpr int kConsumerRegsF32 = 184, kProducerRegsF32 = 136;

// The block by NS slabs of 32 head-dim columns it holds (1-4) and kCTAs
// blocks a cluster (2: the head dim split between them, past D = 128):
// kKeys keys a step (S's N, O's k, the online softmax's step: 64, or 32
// from NS = 3 on), the stages of K's and of V's ring, and shared memory in
// floats: Q's hi and lo for each warpgroup, a K stage (hi and lo of NS
// [kKeys][32] slabs), a V stage (hi and lo of kKeys / 32 [32 NS][32] slabs
// of V^T), each warpgroup's exchange tile (a cluster: a step's partial S).
template <int NS, int kCTAs>
struct FwdShape {
  static constexpr int kKeys = NS <= 2 ? 64 : 32;
  static constexpr int kStagesK = NS == 1 ? 3 : NS == 4 && kCTAs == 2 ? 1 : 2;
  static constexpr int kStagesV = NS == 1 ? 3 : NS == 4 ? 1 : 2;
  static constexpr int kSlabQ = 64 * 32, kSlabK = kKeys * 32, kSlabV = 32 * NS * 32;
  static constexpr int kSlabsV = kKeys / 32;
  static constexpr int kQ = 2 * 2 * NS * kSlabQ;
  static constexpr int kK = 2 * NS * kSlabK;
  static constexpr int kV = 2 * kSlabsV * kSlabV;
  static constexpr int kX = kCTAs > 1 ? 2 * 128 * (kKeys / 2) : 0;
  static constexpr int kFloats = kQ + kStagesK * kK + kStagesV * kV + kX;
  static constexpr int kBars = 2 * kStagesK + 2 * kStagesV + 4;
};

// Bytes of shared memory: 1024 of slack for the tiles' 1024-byte boundary,
// the tiles, the barriers, each K stage's segment ids, each 64-row tile's
// min and max id and the live list with its length.
template <int NS, int kCTAs>
constexpr int fwd_smem_bytes(int S) {
  using Sh = FwdShape<NS, kCTAs>;
  return 1024 + Sh::kFloats * 4 + Sh::kBars * 8 + Sh::kStagesK * Sh::kKeys * 4 +
         (3 * (S / 64) + 1) * 4;
}

template <int NS, int kCTAs>
struct FwdSmem {
  using Sh = FwdShape<NS, kCTAs>;
  float* base;
  uint64_t* bar;
  int32_t* kseg;  // [kStagesK][kKeys]: the segment ids of a K stage's keys
  int* tmin;
  int* tmax;
  int* live;
  int* n_live;

  __device__ FwdSmem(unsigned char* raw, int n_tiles) {
    base = reinterpret_cast<float*>(align_1024(raw));
    bar = reinterpret_cast<uint64_t*>(base + Sh::kFloats);
    kseg = reinterpret_cast<int32_t*>(bar + Sh::kBars);
    tmin = kseg + Sh::kStagesK * Sh::kKeys;
    tmax = tmin + n_tiles;
    live = tmax + n_tiles;
    n_live = live + n_tiles;
  }
  // hl 0: hi, 1: lo.  Warpgroup wg's Q slab c; stage st's K slab c; stage
  // st's V^T slab of keys 32j..32j+31; warpgroup wg's exchange tile.
  __device__ __forceinline__ float* q(int wg, int hl, int c) const {
    return base + ((2 * wg + hl) * NS + c) * Sh::kSlabQ;
  }
  __device__ __forceinline__ float* k(int st, int hl, int c) const {
    return base + Sh::kQ + st * Sh::kK + (hl * NS + c) * Sh::kSlabK;
  }
  __device__ __forceinline__ float* v(int st, int hl, int j) const {
    return base + Sh::kQ + Sh::kStagesK * Sh::kK + st * Sh::kV + (hl * Sh::kSlabsV + j) * Sh::kSlabV;
  }
  __device__ __forceinline__ float* x(int wg) const {
    return base + Sh::kQ + Sh::kStagesK * Sh::kK + Sh::kStagesV * Sh::kV +
           wg * 128 * (Sh::kKeys / 2);
  }
  __device__ __forceinline__ uint64_t* k_full(int st) const { return bar + st; }
  __device__ __forceinline__ uint64_t* k_empty(int st) const { return bar + Sh::kStagesK + st; }
  __device__ __forceinline__ uint64_t* v_full(int st) const { return bar + 2 * Sh::kStagesK + st; }
  __device__ __forceinline__ uint64_t* v_empty(int st) const {
    return bar + 2 * Sh::kStagesK + Sh::kStagesV + st;
  }
  // the exchange (a cluster): full (128 arrivals: the other block's partial
  // S has landed in this block's tile), free (one: the other block's tile
  // may take the next)
  __device__ __forceinline__ uint64_t* x_full(int wg) const {
    return bar + 2 * Sh::kStagesK + 2 * Sh::kStagesV + wg;
  }
  __device__ __forceinline__ uint64_t* x_free(int wg) const { return x_full(wg) + 2; }
  // does 64-key tile t meet the rows whose segment ids lie in [lo, hi]?
  __device__ __forceinline__ bool meets(int t, int lo, int hi) const {
    return tmin[t] <= hi && lo <= tmax[t];
  }
};

// Columns c..c+3 of a row (c a multiple of 4), 0 from column Dl on: one
// 16-byte load per head (rows on 16-byte boundaries, Dl a multiple of 4),
// four 4-byte ones on rows of heads side by side (kRowMap).
template <bool kRowMap>
__device__ __forceinline__ float4 load4(const float* row, int c, int Dl) {
  if constexpr (!kRowMap) {
    return c < Dl ? __ldg(reinterpret_cast<const float4*>(row + c)) : make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    float x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = c + i < Dl ? __ldg(row + c + i) : 0.f;
    return make_float4(x[0], x[1], x[2], x[3]);
  }
}

__device__ __forceinline__ void split4(const float4& x, uint4& hi, uint4& lo) {
  split(x.x, hi.x, lo.x);
  split(x.y, hi.y, lo.y);
  split(x.z, hi.z, lo.z);
  split(x.w, hi.w, lo.w);
}

template <int N>
__device__ __forceinline__ void pin_acc(float (&d)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+f"(d[n][i])::"memory");
  }
}
template <int N>
__device__ __forceinline__ void pin_frag(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[n][i])::"memory");
  }
}

// ---- the cluster's exchange (past D = 128) ---------------------------------

// Barrier over both blocks of a cluster (release / acquire).
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n"
               ::: "memory");
}

// The address of the same shared-memory place in the other block.
__device__ __forceinline__ uint32_t peer_addr(const void* local, int rank) {
  uint32_t peer;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(peer) : "r"(smem_u32(local)),
               "r"(rank ^ 1));
  return peer;
}

// Wait for phase `parity` of a barrier that the other block arrives on.
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive_remote(uint32_t peer_bar) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(peer_bar)
               : "memory");
}

// S summed over the cluster's two halves of the head dim: each thread
// writes its partial sums into the other block's tile of its warpgroup
// (once that block has freed it: its `free` here; 16 bytes a store, slice j
// of thread tid at (j * 128 + tid) * 4), arrives on that block's `full`,
// waits for its own and adds what the other block wrote; then the
// warpgroup frees its tile for the other block's next sums.  `n` counts the
// exchanges done.
template <int NJ>
__device__ __forceinline__ void exchange_s(float (&s)[NJ][4], float* tile, uint64_t* full,
                                           uint64_t* free_, int rank, int wg, int& n) {
  const int tid = threadIdx.x & 127;
  if (n > 0) mbar_wait_cluster(free_, (n - 1) & 1);
  const uint32_t peer = peer_addr(tile, rank);
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                     peer + 16 * (j * 128 + tid)),
                 "f"(s[j][0]), "f"(s[j][1]), "f"(s[j][2]), "f"(s[j][3])
                 : "memory");
  }
  mbar_arrive_remote(peer_addr(full, rank));
  mbar_wait_cluster(full, n & 1);
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const float4 x = reinterpret_cast<const float4*>(tile)[j * 128 + tid];
    s[j][0] += x.x, s[j][1] += x.y, s[j][2] += x.z, s[j][3] += x.w;
  }
  ++n;
  named_sync(1 + wg, 128);  // every thread has read the tile
  if (tid == 0) mbar_arrive_remote(peer_addr(free_, rank));
}

// ---- the kernel ------------------------------------------------------------

template <int NS, bool kRowMap, int kCTAs>
__global__ void __launch_bounds__(kThreads, 1) flash_tf32_fwd_kernel(const Tf32Params p) {
  using Sh = FwdShape<NS, kCTAs>;
  constexpr int kKeys = Sh::kKeys, kNJ = kKeys / 8, kSubs = 64 / kKeys;
  constexpr int kChunks = 8 * NS;                // 16-byte groups of a row's 32 NS columns
  constexpr int kPer = kKeys * kChunks / 128;    // of a K or V step, a producer thread's
  extern __shared__ unsigned char smem_raw[];
  const int n_tiles = p.S / 64;
  const FwdSmem<NS, kCTAs> m(smem_raw, n_tiles);
  const int unit = blockIdx.x / kCTAs;  // the cluster's 128 query rows
  const int blocks = p.S / 128;
  const int blk = unit % blocks, bh = unit / blocks;
  const int h = bh % p.H, b = bh / p.H;
  const int tid = threadIdx.x, wg = tid >> 7, wtid = tid & 127;
  const int32_t* segb = p.seg + static_cast<long long>(b) * p.S;
  // the block's head-dim columns: col0.., Dl of them (in a cluster the
  // first block ceil(D / 2) rounded up to 8, the second the rest)
  int rank = 0, col0 = 0, Dl = p.D;
  if constexpr (kCTAs > 1) {
    asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
    const int half = ((p.D + 1) / 2 + 7) / 8 * 8;
    col0 = rank * half;
    Dl = rank == 0 ? half : p.D - half;
  }
  const float* qg = p.q + b * p.q_sb + h * p.q_sh + col0;
  const float* kg = p.k + b * p.k_sb + h * p.k_sh + col0;
  const float* vg = p.v + b * p.v_sb + h * p.v_sh + col0;

  if (tid == 0) {
    for (int st = 0; st < Sh::kStagesK; ++st) {
      mbar_init(m.k_full(st), 128);
      mbar_init(m.k_empty(st), 256);
    }
    for (int st = 0; st < Sh::kStagesV; ++st) {
      mbar_init(m.v_full(st), 128);
      mbar_init(m.v_empty(st), 256);
    }
    for (int w = 0; w < 2; ++w) {
      mbar_init(m.x_full(w), 128);
      mbar_init(m.x_free(w), 1);
    }
    mbar_fence_init();
  }
  // Q's 128 rows split once, by every thread: hi and lo at their columns
  {
    const float* q0 = qg + static_cast<long long>(blk) * 128 * p.q_ss;
    for (int idx = tid; idx < 128 * kChunks; idx += kThreads) {
      const int r = idx / kChunks, c = 4 * (idx % kChunks);
      uint4 hi, lo;
      split4(load4<kRowMap>(q0 + r * p.q_ss, c, Dl), hi, lo);
      const int at = swz32(r & 63, c & 31);
      *reinterpret_cast<uint4*>(m.q(r >> 6, 0, c >> 5) + at) = hi;
      *reinterpret_cast<uint4*>(m.q(r >> 6, 1, c >> 5) + at) = lo;
    }
  }
  fence_proxy_async();  // the Q tiles, before wgmma reads them
  find_live_tiles<2>(segb, n_tiles, 2 * blk, m.tmin, m.tmax, m.live, m.n_live);
  if constexpr (kCTAs > 1) cluster_sync();  // both blocks' barriers are set up
  const int n_steps = *m.n_live * kSubs;

  if (wg == 2) {  // the producer: K and V split into the rings, step by step
    setmaxnreg_dec<kProducerRegsF32>();
    const int pw = wtid >> 5, lane = tid & 31;
    for (int u = 0; u < n_steps; ++u) {
      const int key0 = m.live[u / kSubs] * 64 + (u % kSubs) * kKeys;
      const int ks = u % Sh::kStagesK, vs = u % Sh::kStagesV;
      // K: chunk idx = wtid + 128 i of the step's kKeys x kChunks, one row's
      // chunks by neighbouring threads, loaded before the stage is waited for
      float4 x[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int idx = wtid + 128 * i, r = idx / kChunks;
        x[i] = load4<kRowMap>(kg + (key0 + r) * p.k_ss, 4 * (idx % kChunks), Dl);
      }
      if (u >= Sh::kStagesK) mbar_wait(m.k_empty(ks), (u / Sh::kStagesK - 1) & 1);
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int idx = wtid + 128 * i, r = idx / kChunks, c = 4 * (idx % kChunks);
        uint4 hi, lo;
        split4(x[i], hi, lo);
        const int at = swz32(r, c & 31);
        *reinterpret_cast<uint4*>(m.k(ks, 0, c >> 5) + at) = hi;
        *reinterpret_cast<uint4*>(m.k(ks, 1, c >> 5) + at) = lo;
      }
      if (wtid < kKeys) m.kseg[ks * kKeys + wtid] = segb[key0 + wtid];
      fence_proxy_async();
      mbar_arrive(m.k_full(ks));
      // V: a warp takes 8 keys x 4 chunks at a time (lanes 4 apart: keys),
      // each value to row c + e of V^T at its key's permuted place
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int gi = pw + 4 * i, r = 8 * (gi % (kKeys / 8)) + (lane >> 2);
        const int c = 4 * (4 * (gi / (kKeys / 8)) + (lane & 3));
        x[i] = load4<kRowMap>(vg + (key0 + r) * p.v_ss, c, Dl);
      }
      if (u >= Sh::kStagesV) mbar_wait(m.v_empty(vs), (u / Sh::kStagesV - 1) & 1);
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int gi = pw + 4 * i, r = 8 * (gi % (kKeys / 8)) + (lane >> 2);
        const int c = 4 * (4 * (gi / (kKeys / 8)) + (lane & 3));
        const int e = r & 7, pos = (r & 24) | (e >> 1) | ((e & 1) << 2);
        uint4 hi, lo;
        split4(x[i], hi, lo);
        uint32_t* vh = reinterpret_cast<uint32_t*>(m.v(vs, 0, r >> 5));
        uint32_t* vl = reinterpret_cast<uint32_t*>(m.v(vs, 1, r >> 5));
        vh[swz32(c, pos)] = hi.x, vl[swz32(c, pos)] = lo.x;
        vh[swz32(c + 1, pos)] = hi.y, vl[swz32(c + 1, pos)] = lo.y;
        vh[swz32(c + 2, pos)] = hi.z, vl[swz32(c + 2, pos)] = lo.z;
        vh[swz32(c + 3, pos)] = hi.w, vl[swz32(c + 3, pos)] = lo.w;
      }
      fence_proxy_async();
      mbar_arrive(m.v_full(vs));
    }
  } else {  // the consumers: 64 queries each, 16 a warp
    setmaxnreg_inc<kConsumerRegsF32>();
    const int warp = wtid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
    const int row0 = blk * 128 + wg * 64;  // the warpgroup's first query
    const int r0 = warp * 16 + g;          // this thread's rows: r0 and r0 + 8
    const int seg_q0 = segb[row0 + r0], seg_q1 = segb[row0 + r0 + 8];
    const int lo = m.tmin[2 * blk + wg], hi = m.tmax[2 * blk + wg];
    const int n_k = (Dl + 7) / 8;  // S's k steps: the block's columns only
    const float neg_inf = __int_as_float(0xff800000);
    float o[4 * NS][4];  // the warp's 16 x (32 NS) output, C layout by 8-column slice
    float mrow[2] = {neg_inf, neg_inf}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < 4 * NS; ++e) o[e][0] = o[e][1] = o[e][2] = o[e][3] = 0.f;
    int exchanged = 0;
    for (int u = 0; u < n_steps; ++u) {
      const int t = m.live[u / kSubs], ks = u % Sh::kStagesK, vs = u % Sh::kStagesV;
      const bool take = m.meets(t, lo, hi);
      float s[kNJ][4];
      float alpha[2] = {1.f, 1.f};
      mbar_wait(m.k_full(ks), (u / Sh::kStagesK) & 1);
      if (take) {
        // S = Q K^T: k step kk takes columns 8kk..8kk+7 (before the
        // block's D only), the cross terms of every k step first, then hi
        // hi (the small terms summed while the sum is small)
        pin_acc(s);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4 * NS; ++kk) {
          if (kk >= n_k) break;
          const int c = kk >> 2, j = 2 * (kk & 3);
          WgmmaTf32<kKeys>::ss(s, tile_desc(m.q(wg, 1, c)) + j, tile_desc(m.k(ks, 0, c)) + j,
                               kk == 0 ? 0 : 1);
          WgmmaTf32<kKeys>::ss(s, tile_desc(m.q(wg, 0, c)) + j, tile_desc(m.k(ks, 1, c)) + j, 1);
        }
#pragma unroll
        for (int kk = 0; kk < 4 * NS; ++kk) {
          if (kk >= n_k) break;
          const int c = kk >> 2, j = 2 * (kk & 3);
          WgmmaTf32<kKeys>::ss(s, tile_desc(m.q(wg, 0, c)) + j, tile_desc(m.k(ks, 0, c)) + j, 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        pin_acc(s);
        if constexpr (kCTAs > 1) {
          exchange_s(s, m.x(wg), m.x_full(wg), m.x_free(wg), rank, wg, exchanged);
        }
        softmax_step<true>(s, m.kseg + ks * kKeys, m.tmin[t], m.tmax[t], seg_q0, seg_q1, t4,
                           p.scale_log2, mrow, l, alpha);
      }
      mbar_arrive(m.k_empty(ks));
      mbar_wait(m.v_full(vs), (u / Sh::kStagesV) & 1);
      if (take) {
        if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) scale_rows(o, alpha);
        // O += P V: k step j takes keys 8j..8j+7, this thread's A entries of
        // k = t4 and t4 + 4 being its P entries of keys 8j + 2t4 and + 1
        uint32_t a_hi[kNJ][4], a_lo[kNJ][4];
#pragma unroll
        for (int j = 0; j < kNJ; ++j) {
          split(s[j][0], a_hi[j][0], a_lo[j][0]);
          split(s[j][2], a_hi[j][1], a_lo[j][1]);
          split(s[j][1], a_hi[j][2], a_lo[j][2]);
          split(s[j][3], a_hi[j][3], a_lo[j][3]);
        }
        pin_acc(o);
        pin_frag(a_hi);
        pin_frag(a_lo);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < kNJ; ++j) {
          const int at = 2 * (j & 3);
          wgmma_3xtf32(o, a_hi[j], a_lo[j], tile_desc(m.v(vs, 0, j >> 2)) + at,
                          tile_desc(m.v(vs, 1, j >> 2)) + at);
        }
        wgmma_commit();
        wgmma_wait<0>();
        pin_acc(o);
        pin_frag(a_hi);
        pin_frag(a_lo);
      }
      mbar_arrive(m.v_empty(vs));
    }

    // whole-row sums
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    }
    if (p.lse != nullptr && t4 == 0 && rank == 0) {
      // logsumexp of the scaled logits: m * scale_log2 + log2 l in log2
      // units, to natural
      float* lse = p.lse + static_cast<long long>(bh) * p.S + row0 + r0;
      lse[0] = (mrow[0] * p.scale_log2 + log2f(l[0])) * kLn2;
      lse[8] = (mrow[1] * p.scale_log2 + log2f(l[1])) * kLn2;
    }
    // O / l: the block's columns before Dl, two neighbours a store (one
    // where rows start off an 8-byte boundary)
    const float inv0 = 1.f / l[0], inv1 = 1.f / l[1];
    float* dst = p.o + b * p.o_sb + h * p.o_sh + (row0 + r0) * p.o_ss + col0;
#pragma unroll
    for (int e = 0; e < 4 * NS; ++e) {
      const int c = 8 * e + 2 * t4;
      if (p.pairs) {  // c, Dl and col0 even
        if (c < Dl) {
          *reinterpret_cast<float2*>(dst + c) = make_float2(o[e][0] * inv0, o[e][1] * inv0);
          *reinterpret_cast<float2*>(dst + 8 * p.o_ss + c) =
              make_float2(o[e][2] * inv1, o[e][3] * inv1);
        }
      } else {
        if (c < Dl) {
          dst[c] = o[e][0] * inv0;
          dst[8 * p.o_ss + c] = o[e][2] * inv1;
        }
        if (c + 1 < Dl) {
          dst[c + 1] = o[e][1] * inv0;
          dst[8 * p.o_ss + c + 1] = o[e][3] * inv1;
        }
      }
    }
  }
  if constexpr (kCTAs > 1) cluster_sync();  // the other block's last arrivals have landed
}

template <int NS, bool kRowMap, int kCTAs>
int launch_tf32(const Tf32Params& p, int B, cudaStream_t stream) {
  const long long blocks = static_cast<long long>(B) * p.H * (p.S / 128) * kCTAs;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  auto kernel = flash_tf32_fwd_kernel<NS, kRowMap, kCTAs>;
  const int bytes = fwd_smem_bytes<NS, kCTAs>(p.S);
  int err = static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
  if (err != 0) return err;
  if (kCTAs == 1) {
    kernel<<<static_cast<unsigned>(blocks), kThreads, bytes, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCTAs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, p));
}

template <bool kRowMap>
int launch(const void* q, const void* k, const void* v, const int32_t* seg, void* o, float* lse,
           int B, int H, int S, int D, const long long* strides, float sm_scale,
           cudaStream_t stream) {
  if (B == 0 || H == 0) return 0;
  if (S <= 0 || S % 128 || D < 1 || D > 256 || (!kRowMap && D % 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Tf32Params p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.seg = seg;
  p.o = static_cast<float*>(o);
  p.lse = lse;
  p.q_sb = strides[0], p.q_sh = strides[1], p.q_ss = strides[2];
  p.k_sb = strides[3], p.k_sh = strides[4], p.k_ss = strides[5];
  p.v_sb = strides[6], p.v_sh = strides[7], p.v_ss = strides[8];
  p.o_sb = strides[9], p.o_sh = strides[10], p.o_ss = strides[11];
  p.H = H;
  p.S = S;
  p.D = D;
  p.scale_log2 = sm_scale * kLog2e;
  // float2 stores where every O row of every head starts on an 8-byte boundary
  p.pairs = reinterpret_cast<uintptr_t>(o) % 8 == 0 && ((D | p.o_sb | p.o_sh | p.o_ss) & 1) == 0;
  // slabs of 32 columns; past 128 columns a cluster of two blocks, each
  // with 3 (D up to 192) or 4 slabs
  switch ((D + 31) / 32) {
    case 1: return launch_tf32<1, kRowMap, 1>(p, B, stream);
    case 2: return launch_tf32<2, kRowMap, 1>(p, B, stream);
    case 3: return launch_tf32<3, kRowMap, 1>(p, B, stream);
    case 4: return launch_tf32<4, kRowMap, 1>(p, B, stream);
    case 5:
    case 6: return launch_tf32<3, kRowMap, 2>(p, B, stream);
    default: return launch_tf32<4, kRowMap, 2>(p, B, stream);
  }
}

}  // namespace

// strides: 12 values, (b, h, s) strides in elements of q, k, v and o in that
// order.  lse: null, or a contiguous f32 [B, H, S] that receives each row's
// logsumexp of the scaled, masked logits (natural log), which the backward
// kernels read.  Returns the first CUDA error of setting the kernel's shared
// memory size and launching it (0 = launched).  The caller has checked
// shapes, dtypes (f32, int32 seg), a contiguous D, strides that are
// multiples of 4 elements and 16-byte aligned pointers; D must be a
// multiple of 4 up to 256 and S a multiple of 128.
#ifndef MFAR_TF32_ROWS_ONLY
extern "C" int mfar_flash_attention_fwd_tf32(const void* q, const void* k, const void* v,
                                             const int32_t* seg, void* o, float* lse, int B,
                                             int H, int S, int D, const long long* strides,
                                             float sm_scale, cudaStream_t stream) {
  return launch<false>(q, k, v, seg, o, lse, B, H, S, D, strides, sm_scale, stream);
}
#else  // flash_attention_tf32_rows.cu: the rows mode's instances alone

// The same kernel on rows of heads side by side, at any D from 1 to 256,
// each operand read 4 bytes a load.  The caller has checked, besides, that
// each of q, k and v has the H stride D; o's strides are any.
extern "C" int mfar_flash_attention_fwd_tf32_rows(const void* q, const void* k, const void* v,
                                                  const int32_t* seg, void* o, float* lse, int B,
                                                  int H, int S, int D, const long long* strides,
                                                  float sm_scale, cudaStream_t stream) {
  return launch<true>(q, k, v, seg, o, lse, B, H, S, D, strides, sm_scale, stream);
}
#endif
