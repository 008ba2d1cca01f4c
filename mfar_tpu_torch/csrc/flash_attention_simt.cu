// Kernels K2 and K2b at every dtype and head dim that JAX's flash attention
// takes: f32 or bf16, any D up to 256, on the CUDA cores (sm_90a).
//
//   forward: O[b,h,i] = softmax_j(Q[b,h,i] . K[b,h,j] * sm_scale, over the
//            keys j with seg[b,j] == seg[b,i]) . V[b,h], and optionally each
//            row's logsumexp of the scaled, masked logits (natural log, f32)
//   bwd_dq:  di = sum_d O * dO (f32), written out,   dQ = dS K
//   bwd_dkv: dV = P^T dO,  dK = dS^T Q               (reads bwd_dq's di)
//
// with P = exp(Q K^T * sm_scale - lse) on same-segment pairs, 0 elsewhere,
// and dS = P * (dO V^T - di) * sm_scale.  q/k/v/o/dO are [B, H, S, D] in f32
// or bf16, read through their (b, h, s) strides (D contiguous), seg is
// int32 [B, S], lse and di are contiguous f32 [B, H, S]; outputs and
// gradients go to [B, H, S, D] views with their own strides, in the input
// dtype.  S is a multiple of 128.
//
// Replaces the three pallas_calls of JAX's library flash_attention
// (jax/experimental/pallas/ops/tpu/flash_attention.py, jax 0.9.0: the
// forward _flash_attention_kernel, pallas_call at :758; the VJP's
// _flash_attention_bwd_dkv at :1121 and _flash_attention_bwd_dq at :1456),
// called at mfar_tpu/models/encoder.py:170, where the tensor-core kernels
// do not (ops/flash_attention.py::forward_route, backward_route): for the
// forward, inputs TMA cannot read (bf16 at a D that is not a multiple of 8,
// f32 at one that is not a multiple of 4, strides that are not multiples of
// 16 bytes: e.g. TinyBERT-4L-312D's D = 26); for the backward, f32 that TMA
// cannot read and the head dims past the tensor-core pairs' caps (bf16 past
// D = 128, f32 past D = 64): bf16 up to D = 128 that TMA cannot read goes,
// as zero-padded copies, to flash_attention_bwd.cu.
// flash_attention.cu and flash_attention_bwd.cu take bf16 at every other
// head dim, flash_attention_tf32.cu and flash_attention_tf32_bwd.cu f32.
//
// What bounds it: bytes for bf16 (at TinyBERT's [96, 12, 512, 26] the
// backward pair's bound is 0.056 ms a kernel), operations for f32 (three
// TF32 products a product at 495 TFLOP/s, the least an f32-accurate product
// costs on the card); this kernel takes one f32 FMA a product on the CUDA
// cores (67 TFLOP/s) and approaches neither: it is a first, untuned design,
// right before it is fast, kept for the inputs the tensor-core kernels
// cannot read.

// Design: the flash recurrence, one block a (b, h, run of BR rows); the
// rows' own operands stay in registers and 64-row tiles of the operands
// they walk are staged in shared memory as f32.
//   lanes: a group of G = DB / 16 neighbouring lanes owns a row (DB the
//        head-dim bucket, 16 to 256, D <= DB, dims past D held as 0); lane
//        g of the group holds the row's float4 chunks g, g + G, g + 2G and
//        g + 3G (16 dims), so the G lanes of a group read G neighbouring
//        16-byte chunks of a staged row and the groups of a warp read the
//        same row (a broadcast): no bank conflicts.
//   dots: each lane's partial dot over its 16 dims, summed over the group
//        by an xor butterfly (every lane ends with the same bits, so the
//        group's lanes agree on every softmax weight).
//   forward / bwd_dq: a lane group owns R = 2 query rows (Q, O and dO
//        in registers), and 64-key tiles of K, V and their segment ids
//        stream through shared memory.  The forward scores 16 keys at a
//        time, then takes one online-softmax step for them (max, rescale,
//        exp2, sum) and adds P V.
//   bwd_dkv: a lane group owns one key row (K, V, dK, dV in registers),
//        and 64-query tiles of Q, dO, lse, di and segment ids stream.
//   No tile is skipped and no load is overlapped with the products: each
//   tile is loaded by the whole block between two barriers, and the other
//   blocks on the SM cover the wait.
//
// Masking: a cross-segment entry of P is exactly 0 (its logit is taken as
// -inf), where JAX adds its finite -0.7 * FLT_MAX and relies on exp
// underflowing.  While a row has met none of its keys its running max is
// -inf; it is taken as 0 for the subtraction, so no exp2(-inf - -inf) = NaN
// arises and its sum, output and rescale stay 0.  Every row has at least
// its own key, so the end sum is at least 1 and lse is finite.  Exponentials
// are exp2f (not the fast ex2.approx alone) of logits in log2 units.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kTile = 64;   // rows of a streamed tile (keys, or queries in dkv)
constexpr int kChunk = 16;  // keys the forward scores before one online-softmax step

// operands by index into SimtArgs::st
enum { kQ = 0, kK, kV, kO, kDO, kX0, kX1, kNumOps };

struct SimtArgs {
  const void* op[kNumOps];  // q, k, v, o, dO, then the outputs x0 (o, dq or dk), x1 (dv)
  const int32_t* seg;
  const float* lse_in;  // bwd: the forward's row logsumexp
  const float* di_in;   // dkv: dq's row dots
  float* lse_out;       // forward: the row logsumexp, or null
  float* di_out;        // dq: the row dots
  long long st[kNumOps][3];  // (b, h, s) strides in elements
  int H, S, D;
  float scale;  // sm_scale
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__device__ __forceinline__ const T* row_ptr(const SimtArgs& a, int op, int b, int h, int s) {
  return static_cast<const T*>(a.op[op]) + b * a.st[op][0] + h * a.st[op][1] + s * a.st[op][2];
}

// Dim of element e (0..15) of lane g's share of a row.
template <int G>
__device__ __forceinline__ int dim_of(int g, int e) {
  return 4 * (g + G * (e >> 2)) + (e & 3);
}

// Lane g's 16 dims of a row, times `mul`, as f32 (0 past D).
template <typename T, int G>
__device__ __forceinline__ void load_share(float (&x)[16], const T* row, int D, int g,
                                           float mul) {
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    const int d = dim_of<G>(g, e);
    x[e] = d < D ? to_f(row[d]) * mul : 0.f;
  }
}

template <typename T, int G>
__device__ __forceinline__ void store_share(T* row, const float (&x)[16], int D, int g,
                                            float mul) {
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    const int d = dim_of<G>(g, e);
    if (d < D) row[d] = from_f<T>(x[e] * mul);
  }
}

// Lane g's 16 dims of a staged row of shared memory, as four float4s.
template <int G>
__device__ __forceinline__ void read_share(float4 (&x)[4], const float* row, int g) {
#pragma unroll
  for (int i = 0; i < 4; ++i) x[i] = *reinterpret_cast<const float4*>(row + 4 * (g + G * i));
}

__device__ __forceinline__ float dot_share(const float (&a)[16], const float4 (&b)[4]) {
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc = fmaf(a[4 * i], b[i].x, acc);
    acc = fmaf(a[4 * i + 1], b[i].y, acc);
    acc = fmaf(a[4 * i + 2], b[i].z, acc);
    acc = fmaf(a[4 * i + 3], b[i].w, acc);
  }
  return acc;
}

__device__ __forceinline__ void axpy_share(float (&y)[16], float a, const float4 (&x)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    y[4 * i] = fmaf(a, x[i].x, y[4 * i]);
    y[4 * i + 1] = fmaf(a, x[i].y, y[4 * i + 1]);
    y[4 * i + 2] = fmaf(a, x[i].z, y[4 * i + 2]);
    y[4 * i + 3] = fmaf(a, x[i].w, y[4 * i + 3]);
  }
}

// Sum over the G lanes of a group: an xor butterfly, so every lane of the
// group adds the same two values at each step and ends with the same bits.
template <int G>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = 1; off < G; off <<= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Stage rows [s0, s0 + kTile) of operand `op` of (b, h) as f32 [kTile][DB]
// (0 past D), by the whole block.
template <typename T, int DB>
__device__ __forceinline__ void stage_tile(float* dst, const SimtArgs& a, int op, int b, int h,
                                           int s0) {
  const T* base = row_ptr<T>(a, op, b, h, s0);
  const long long ld = a.st[op][2];
  for (int idx = threadIdx.x; idx < kTile * DB; idx += blockDim.x) {
    const int r = idx / DB, d = idx % DB;
    dst[idx] = d < a.D ? to_f(base[r * ld + d]) : 0.f;
  }
}

// f32 values of a contiguous [B, H, S] (or [B, S]) row vector, times `mul`.
template <typename V>
__device__ __forceinline__ void stage_values(V* dst, const V* src, V mul) {
  for (int i = threadIdx.x; i < kTile; i += blockDim.x) dst[i] = src[i] * mul;
}

// Rows a block owns (BR) and its threads, by kernel and head-dim bucket:
// at most 256 threads a block.
template <int DB, int R>
struct Shape {
  static constexpr int G = DB / 16;                  // lanes a row
  static constexpr int BR = 64 * G / R > 256 ? 256 * R / G : 64;
  static constexpr int kThreads = BR * G / R;
};

template <typename T, int DB>
__global__ void __launch_bounds__(Shape<DB, 2>::kThreads)
    flash_simt_fwd_kernel(const SimtArgs a) {
  constexpr int R = 2, G = Shape<DB, R>::G, BR = Shape<DB, R>::BR;
  constexpr int kRowStep = BR / R;  // a group's rows lie kRowStep apart
  extern __shared__ float smem[];
  float* ks = smem;                                      // [kTile][DB]
  float* vs = ks + kTile * DB;                           // [kTile][DB]
  int* segs = reinterpret_cast<int*>(vs + kTile * DB);  // [kTile]
  const int blocks = a.S / BR;
  const int blk = blockIdx.x % blocks, bh = blockIdx.x / blocks;
  const int h = bh % a.H, b = bh / a.H;
  const int g = threadIdx.x % G, grp = threadIdx.x / G;
  const int32_t* segb = a.seg + static_cast<long long>(b) * a.S;
  const float neg_inf = __int_as_float(0xff800000);

  float q[R][16], o[R][16], m[R], l[R];
  int sq[R], row[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    row[r] = blk * BR + grp + r * kRowStep;
    // logits in log2 units: q carries sm_scale * log2(e)
    load_share<T, G>(q[r], row_ptr<T>(a, kQ, b, h, row[r]), a.D, g, a.scale * kLog2e);
    sq[r] = segb[row[r]];
    m[r] = neg_inf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < 16; ++e) o[r][e] = 0.f;
  }

  for (int t0 = 0; t0 < a.S; t0 += kTile) {
    __syncthreads();  // the tile before is done with
    stage_tile<T, DB>(ks, a, kK, b, h, t0);
    stage_tile<T, DB>(vs, a, kV, b, h, t0);
    stage_values(segs, segb + t0, 1);
    __syncthreads();
    for (int c = 0; c < kTile; c += kChunk) {
      float s[R][kChunk];
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        float4 kr[4];
        read_share<G>(kr, ks + (c + jj) * DB, g);
        const int sk = segs[c + jj];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float x = group_sum<G>(dot_share(q[r], kr));
          s[r][jj] = sk == sq[r] ? x : neg_inf;
        }
      }
      // one online-softmax step for the chunk's keys
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float mx = m[r];
#pragma unroll
        for (int jj = 0; jj < kChunk; ++jj) mx = fmaxf(mx, s[r][jj]);
        const float ms = mx == neg_inf ? 0.f : mx;  // no key of its own yet: subtract 0
        const float alpha = exp2f(m[r] - ms);       // 0 while m was -inf
        m[r] = mx;
        float sum = 0.f;
#pragma unroll
        for (int jj = 0; jj < kChunk; ++jj) {
          s[r][jj] = exp2f(s[r][jj] - ms);  // -inf -> 0
          sum += s[r][jj];
        }
        l[r] = l[r] * alpha + sum;
        if (alpha != 1.f) {
#pragma unroll
          for (int e = 0; e < 16; ++e) o[r][e] *= alpha;
        }
      }
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        float4 vr[4];
        read_share<G>(vr, vs + (c + jj) * DB, g);
#pragma unroll
        for (int r = 0; r < R; ++r) axpy_share(o[r], s[r][jj], vr);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (a.lse_out != nullptr && g == 0) {
      a.lse_out[static_cast<long long>(bh) * a.S + row[r]] = (m[r] + log2f(l[r])) * kLn2;
    }
    T* out = const_cast<T*>(row_ptr<T>(a, kX0, b, h, row[r]));
    store_share<T, G>(out, o[r], a.D, g, 1.f / l[r]);
  }
}

template <typename T, int DB>
__global__ void __launch_bounds__(Shape<DB, 2>::kThreads)
    flash_simt_bwd_dq_kernel(const SimtArgs a) {
  constexpr int R = 2, G = Shape<DB, R>::G, BR = Shape<DB, R>::BR;
  constexpr int kRowStep = BR / R;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + kTile * DB;
  int* segs = reinterpret_cast<int*>(vs + kTile * DB);
  const int blocks = a.S / BR;
  const int blk = blockIdx.x % blocks, bh = blockIdx.x / blocks;
  const int h = bh % a.H, b = bh / a.H;
  const int g = threadIdx.x % G, grp = threadIdx.x / G;
  const int32_t* segb = a.seg + static_cast<long long>(b) * a.S;

  float q[R][16], dout[R][16], dq[R][16], lse[R], di[R];
  int sq[R], row[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    row[r] = blk * BR + grp + r * kRowStep;
    load_share<T, G>(dout[r], row_ptr<T>(a, kDO, b, h, row[r]), a.D, g, 1.f);
    load_share<T, G>(q[r], row_ptr<T>(a, kO, b, h, row[r]), a.D, g, 1.f);  // O, for di
    float part = 0.f;
#pragma unroll
    for (int e = 0; e < 16; ++e) part = fmaf(q[r][e], dout[r][e], part);
    di[r] = group_sum<G>(part);
    const long long at = static_cast<long long>(bh) * a.S + row[r];
    if (g == 0) a.di_out[at] = di[r];
    load_share<T, G>(q[r], row_ptr<T>(a, kQ, b, h, row[r]), a.D, g, a.scale * kLog2e);
    lse[r] = a.lse_in[at] * kLog2e;
    sq[r] = segb[row[r]];
#pragma unroll
    for (int e = 0; e < 16; ++e) dq[r][e] = 0.f;
  }

  for (int t0 = 0; t0 < a.S; t0 += kTile) {
    __syncthreads();
    stage_tile<T, DB>(ks, a, kK, b, h, t0);
    stage_tile<T, DB>(vs, a, kV, b, h, t0);
    stage_values(segs, segb + t0, 1);
    __syncthreads();
    for (int j = 0; j < kTile; ++j) {
      float4 kr[4], vr[4];
      read_share<G>(kr, ks + j * DB, g);
      read_share<G>(vr, vs + j * DB, g);
      const int sk = segs[j];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float s = group_sum<G>(dot_share(q[r], kr));
        const float dp = group_sum<G>(dot_share(dout[r], vr));
        const float p = sk == sq[r] ? exp2f(s - lse[r]) : 0.f;
        axpy_share(dq[r], p * (dp - di[r]), kr);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    T* out = const_cast<T*>(row_ptr<T>(a, kX0, b, h, row[r]));
    store_share<T, G>(out, dq[r], a.D, g, a.scale);
  }
}

template <typename T, int DB>
__global__ void __launch_bounds__(Shape<DB, 1>::kThreads)
    flash_simt_bwd_dkv_kernel(const SimtArgs a) {
  constexpr int G = Shape<DB, 1>::G, BR = Shape<DB, 1>::BR;
  extern __shared__ float smem[];
  float* qs = smem;                        // [kTile][DB]
  float* dos = qs + kTile * DB;            // [kTile][DB]
  float* lses = dos + kTile * DB;          // [kTile], log2 units
  float* dis = lses + kTile;               // [kTile]
  int* segs = reinterpret_cast<int*>(dis + kTile);  // [kTile]
  const int blocks = a.S / BR;
  const int blk = blockIdx.x % blocks, bh = blockIdx.x / blocks;
  const int h = bh % a.H, b = bh / a.H;
  const int g = threadIdx.x % G, key = blk * BR + threadIdx.x / G;
  const int32_t* segb = a.seg + static_cast<long long>(b) * a.S;
  const long long rows = static_cast<long long>(bh) * a.S;

  float k[16], v[16], dk[16], dv[16];
  load_share<T, G>(k, row_ptr<T>(a, kK, b, h, key), a.D, g, a.scale * kLog2e);
  load_share<T, G>(v, row_ptr<T>(a, kV, b, h, key), a.D, g, 1.f);
  const int sk = segb[key];
#pragma unroll
  for (int e = 0; e < 16; ++e) dk[e] = dv[e] = 0.f;

  for (int t0 = 0; t0 < a.S; t0 += kTile) {
    __syncthreads();
    stage_tile<T, DB>(qs, a, kQ, b, h, t0);
    stage_tile<T, DB>(dos, a, kDO, b, h, t0);
    stage_values(lses, a.lse_in + rows + t0, kLog2e);
    stage_values(dis, a.di_in + rows + t0, 1.f);
    stage_values(segs, segb + t0, 1);
    __syncthreads();
    for (int i = 0; i < kTile; ++i) {
      float4 qr[4], dor[4];
      read_share<G>(qr, qs + i * DB, g);
      read_share<G>(dor, dos + i * DB, g);
      const float s = group_sum<G>(dot_share(k, qr));
      const float dp = group_sum<G>(dot_share(v, dor));
      const float p = segs[i] == sk ? exp2f(s - lses[i]) : 0.f;
      axpy_share(dv, p, dor);
      axpy_share(dk, p * (dp - dis[i]), qr);
    }
  }
  store_share<T, G>(const_cast<T*>(row_ptr<T>(a, kX0, b, h, key)), dk, a.D, g, a.scale);
  store_share<T, G>(const_cast<T*>(row_ptr<T>(a, kX1, b, h, key)), dv, a.D, g, 1.f);
}

enum Kind { kFwd = 0, kDq, kDkv };

template <Kind kind, typename T, int DB>
int launch(const SimtArgs& a, int B, cudaStream_t stream) {
  constexpr int R = kind == kDkv ? 1 : 2;
  using Sh = Shape<DB, R>;
  const int smem = 2 * kTile * DB * 4 + (kind == kDkv ? 3 : 1) * kTile * 4;
  void (*fn)(SimtArgs);
  if constexpr (kind == kFwd) {
    fn = flash_simt_fwd_kernel<T, DB>;
  } else if constexpr (kind == kDq) {
    fn = flash_simt_bwd_dq_kernel<T, DB>;
  } else {
    fn = flash_simt_bwd_dkv_kernel<T, DB>;
  }
  // a runtime call first: it also makes the device's context current in
  // this thread (autograd's thread runs the backward)
  int err = static_cast<int>(
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  if (err != 0) return err;
  const long long blocks = static_cast<long long>(B) * a.H * (a.S / Sh::BR);
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  void* args[] = {const_cast<SimtArgs*>(&a)};
  err = static_cast<int>(cudaLaunchKernel(fn, dim3(static_cast<unsigned>(blocks)),
                                          dim3(Sh::kThreads), args, smem, stream));
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}

// The head-dim bucket: the least of 16, 32, 64, 128, 256 that holds D.
template <Kind kind, typename T>
int launch_by_dim(const SimtArgs& a, int B, cudaStream_t stream) {
  if (a.D <= 16) return launch<kind, T, 16>(a, B, stream);
  if (a.D <= 32) return launch<kind, T, 32>(a, B, stream);
  if (a.D <= 64) return launch<kind, T, 64>(a, B, stream);
  if (a.D <= 128) return launch<kind, T, 128>(a, B, stream);
  return launch<kind, T, 256>(a, B, stream);
}

template <Kind kind>
int run(int bf16, SimtArgs& a, int B, int H, int S, int D, const long long* strides, int n_ops,
        const int* ops, float sm_scale, cudaStream_t stream) {
  if (B == 0 || H == 0) return 0;
  if (S <= 0 || S % 128 || D < 1 || D > 256) return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < n_ops; ++i) {
    for (int j = 0; j < 3; ++j) a.st[ops[i]][j] = strides[3 * i + j];
  }
  a.H = H, a.S = S, a.D = D, a.scale = sm_scale;
  return bf16 ? launch_by_dim<kind, __nv_bfloat16>(a, B, stream)
              : launch_by_dim<kind, float>(a, B, stream);
}

}  // namespace

// Each entry returns the first CUDA error of setting the kernel's shared
// memory size and launching it (0 = launched).  bf16: 1 for bf16 tensors,
// 0 for f32.  The caller has checked shapes, dtypes, int32 seg, 1 <= D <=
// 256, S % 128 == 0 and a contiguous D.

// strides: 12 values, the (b, h, s) strides in elements of q, k, v and o.
// lse: null, or a contiguous f32 [B, H, S] that receives each row's
// logsumexp.
extern "C" int mfar_flash_simt_fwd(int bf16, const void* q, const void* k, const void* v,
                                   const int32_t* seg, void* o, float* lse, int B, int H, int S,
                                   int D, const long long* strides, float sm_scale,
                                   cudaStream_t stream) {
  SimtArgs a = {};
  a.op[kQ] = q, a.op[kK] = k, a.op[kV] = v, a.op[kX0] = o;
  a.seg = seg, a.lse_out = lse;
  const int ops[] = {kQ, kK, kV, kX0};
  return run<kFwd>(bf16, a, B, H, S, D, strides, 4, ops, sm_scale, stream);
}

// strides: 18 values, those of q, k, v, o, dout and dq.  di: a contiguous
// f32 [B, H, S] that receives sum_d o * dO.
extern "C" int mfar_flash_simt_bwd_dq(int bf16, const void* q, const void* k, const void* v,
                                      const void* o, const void* dout, const int32_t* seg,
                                      const float* lse, void* dq, float* di, int B, int H, int S,
                                      int D, const long long* strides, float sm_scale,
                                      cudaStream_t stream) {
  SimtArgs a = {};
  a.op[kQ] = q, a.op[kK] = k, a.op[kV] = v, a.op[kO] = o, a.op[kDO] = dout, a.op[kX0] = dq;
  a.seg = seg, a.lse_in = lse, a.di_out = di;
  const int ops[] = {kQ, kK, kV, kO, kDO, kX0};
  return run<kDq>(bf16, a, B, H, S, D, strides, 6, ops, sm_scale, stream);
}

// strides: 18 values, those of q, k, v, dout, dk and dv.  di: dq's row dots.
extern "C" int mfar_flash_simt_bwd_dkv(int bf16, const void* q, const void* k, const void* v,
                                       const void* dout, const int32_t* seg, const float* lse,
                                       const float* di, void* dk, void* dv, int B, int H, int S,
                                       int D, const long long* strides, float sm_scale,
                                       cudaStream_t stream) {
  SimtArgs a = {};
  a.op[kQ] = q, a.op[kK] = k, a.op[kV] = v, a.op[kDO] = dout, a.op[kX0] = dk, a.op[kX1] = dv;
  a.seg = seg, a.lse_in = lse, a.di_in = di;
  const int ops[] = {kQ, kK, kV, kDO, kX0, kX1};
  return run<kDkv>(bf16, a, B, H, S, D, strides, 6, ops, sm_scale, stream);
}
