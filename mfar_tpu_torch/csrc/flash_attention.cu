// Kernel K2: the encoder's flash-attention forward with segment masking,
// written for Hopper (sm_90a).
//
//   O[b,h,i] = softmax_j(Q[b,h,i] . K[b,h,j] * sm_scale
//                        + (seg[b,i] == seg[b,j] ? 0 : -0.7 * FLT_MAX)) . V[b,h]
//
// q/k/v/o are bf16 [B, H, S, 64] read and written through their strides
// (D contiguous), seg is int32 [B, S], S is a multiple of 128.  Replaces the
// flash branch of mfar_tpu/models/encoder.py::TransformerLayer.__call__: the
// call at encoder.py:170 of JAX's library Pallas kernel
// (jax/experimental/pallas/ops/tpu/flash_attention.py:758, jax 0.9.0).  It
// computes what that kernel computes, not its block structure: the TPU
// kernel walks a sequential (block_q, block_k_major) grid and carries m, l
// and the output sum in scratch memory from one grid step to the next.
// Here blocks run in parallel, so each block loops over the keys itself.
//
// Design (FlashAttention-2 style; simple and right first):
//   grid  = B * H * S/64 blocks, flattened into x (24,576 at the index
//           build's [256, 12, 512, 64], beyond the y/z limits of 65,535);
//           neighbouring blocks share (b, h), so K/V tiles hit in L2.
//   block = 4 warps, 64 query rows, 16 rows per warp.
//   Q (64 x 64) and double-buffered K and V tiles (64 keys x 64) plus the
//   keys' segment ids are staged in shared memory with cp.async, each
//   16-byte chunk XOR-swizzled by row so ldmatrix reads hit 8 bank groups.
//   S = Q K^T and O += P V run on the tensor cores through
//   mma.sync.m16n8k16 (bf16 in, f32 accumulate), operands from ldmatrix
//   (V through ldmatrix.trans).  The online softmax keeps each row's
//   running max and sum in f32 registers, in log2 units (exp2f of logits
//   pre-scaled by sm_scale * log2 e).  P goes to bf16 for the P V product,
//   as in the TPU kernel; the output is scaled by 1/l, rounded to bf16 and
//   stored through shared memory in 16-byte chunks.  Under training the
//   kernel also writes each row's logsumexp m + log l (natural units, f32),
//   which the backward kernels (flash_attention_bwd.cu) read in place of
//   the TPU kernel's saved l and m; without that pointer it writes nothing
//   more.
//
// Masking follows JAX: a masked logit takes the finite value -0.7*FLT_MAX
// (set, not added, in log2 units, where adding would overflow).  A pad row
// whose first key tiles are all valid tokens (all masked for it) starts
// with the running max at that value and every masked entry at weight 1;
// the first tile holding one of its own keys raises the max to a real
// logit, and the rescale exp2(m_old - m_new) = 0 washes the masked weights
// out of l and O.  Every row holds at least its own key, so the end sum is
// at least 1.  Not yet: wgmma, TMA, warp specialisation, skipping tiles
// that are wholly masked.
//
// What bounds it: bytes, just.  At [256, 12, 512, 64] bf16 q/k/v/o are
// 805 MB, 0.240 ms at 3.35 TB/s; the two products are 4*B*H*S*S*D = 206
// GFLOP, 0.208 ms at 989 TFLOP/s (bf16 dense).  At D = 64 the intensity is
// S/2 = 256 flop/byte, just on the bytes side of the H100's ridge (~295).

#include <climits>

#include "flash_common.cuh"

namespace {

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const int32_t* seg;
  __nv_bfloat16* o;
  float* lse;  // [B, H, S] row logsumexp in natural units, or null
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss;
  int H, S;
  float scale_log2;  // sm_scale * log2(e)
};

__global__ void __launch_bounds__(kThreads) flash_attention_fwd_kernel(const Params p) {
  __shared__ __align__(128) __nv_bfloat16 q_s[kBlockM * kHeadDim];
  __shared__ __align__(128) __nv_bfloat16 k_s[2][kBlockN * kHeadDim];
  __shared__ __align__(128) __nv_bfloat16 v_s[2][kBlockN * kHeadDim];
  __shared__ __align__(16) int32_t seg_s[2][kBlockN];

  const int tiles_m = p.S / kBlockM;
  const int m_tile = blockIdx.x % tiles_m;
  const int bh = blockIdx.x / tiles_m;
  const int h = bh % p.H, b = bh / p.H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;  // mma fragment row group, column pair
  const int row0 = m_tile * kBlockM;

  const __nv_bfloat16* qg = p.q + b * p.q_sb + h * p.q_sh + row0 * p.q_ss;
  const __nv_bfloat16* kg = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vg = p.v + b * p.v_sb + h * p.v_sh;
  const int32_t* segb = p.seg + static_cast<long long>(b) * p.S;
  const int n_tiles = p.S / kBlockN;

  auto load_kv = [&](int t, int buf) {
    load_tile(k_s[buf], kg + static_cast<long long>(t) * kBlockN * p.k_ss, p.k_ss, tid);
    load_tile(v_s[buf], vg + static_cast<long long>(t) * kBlockN * p.v_ss, p.v_ss, tid);
    load_row_values(seg_s[buf], segb + t * kBlockN, tid);
  };

  load_tile(q_s, qg, p.q_ss, tid);
  load_kv(0, 0);
  cp_async_commit();

  // this thread's two query rows: g and g + 8 of the warp's 16
  const int qrow = row0 + warp * 16 + g;
  const int seg_q0 = segb[qrow], seg_q1 = segb[qrow + 8];

  uint32_t qf[4][4];  // Q as A fragments, one per 16-wide slice of D
  float o[8][4];      // O accumulators, one per 8-wide slice of D
#pragma unroll
  for (int n = 0; n < 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  const float neg_inf = __int_as_float(0xff800000);
  float m[2] = {neg_inf, neg_inf};  // running max; the first rescale exp2f(-inf) = 0
  float l[2] = {0.f, 0.f};  // this thread's share of each row's sum

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) {
      load_kv(t + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) load_a_fragment(qf[kc], q_s, warp, lane, kc);
    }

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t kf[4];  // keys n*8..n*8+7, D slices of 8 from half*32
        load_b_rows(kf, k_s[buf], lane, n, half);
        mma_bf16(s[n], qf[half * 2], kf[0], kf[1]);
        mma_bf16(s[n], qf[half * 2 + 1], kf[2], kf[3]);
      }
    }

    // scale to log2 units, mask across segments, new running max per row
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int c = n * 8 + 2 * t4;
      const int sk0 = seg_s[buf][c], sk1 = seg_s[buf][c + 1];
      s[n][0] = sk0 == seg_q0 ? s[n][0] * p.scale_log2 : kMaskValue;
      s[n][1] = sk1 == seg_q0 ? s[n][1] * p.scale_log2 : kMaskValue;
      s[n][2] = sk0 == seg_q1 ? s[n][2] * p.scale_log2 : kMaskValue;
      s[n][3] = sk1 == seg_q1 ? s[n][3] * p.scale_log2 : kMaskValue;
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // a row's 64 keys lie across the 4 lanes of a quad
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    }
    const float alpha0 = exp2f(m[0] - mx[0]), alpha1 = exp2f(m[1] - mx[1]);
    m[0] = mx[0];
    m[1] = mx[1];

    // P = exp2(S - m) in f32 for the sums, in bf16 A fragments for P V
    uint32_t pf[4][4];
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float p0 = exp2f(s[n][0] - mx[0]), p1 = exp2f(s[n][1] - mx[0]);
      const float p2 = exp2f(s[n][2] - mx[1]), p3 = exp2f(s[n][3] - mx[1]);
      rs0 += p0 + p1;
      rs1 += p2 + p3;
      pf[n >> 1][(n & 1) * 2] = pack_bf16(p0, p1);
      pf[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
    l[0] = l[0] * alpha0 + rs0;
    l[1] = l[1] * alpha1 + rs1;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      o[n][0] *= alpha0;
      o[n][1] *= alpha0;
      o[n][2] *= alpha1;
      o[n][3] *= alpha1;
    }

    // O += P V: 16-key slices of the tile against pairs of 8-wide D slices
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {
        uint32_t vf[4];
        load_b_cols(vf, v_s[buf], lane, kc, dp);
        mma_bf16(o[dp * 2], pf[kc], vf[0], vf[1]);
        mma_bf16(o[dp * 2 + 1], pf[kc], vf[2], vf[3]);
      }
    }
    __syncthreads();  // the next iteration's prefetch overwrites this buffer
  }

  // whole-row sums
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  if (p.lse != nullptr && t4 == 0) {
    // logsumexp of the scaled logits: (m + log2 l) in log2 units, to natural
    float* lse = p.lse + static_cast<long long>(bh) * p.S + row0 + warp * 16 + g;
    lse[0] = (m[0] + log2f(l[0])) * kLn2;
    lse[8] = (m[1] + log2f(l[1])) * kLn2;
  }
  // 1/l, bf16; staged in the warp's own rows of q_s (each warp read only its
  // own rows of Q), then 16-byte stores
  store_rows(p.o + b * p.o_sb + h * p.o_sh + row0 * p.o_ss, p.o_ss, q_s, o, 1.f / l[0],
             1.f / l[1], warp, lane);
}

}  // namespace

// strides: 12 values, (b, h, s) strides in elements of q, k, v and o in that
// order.  lse: null, or a contiguous f32 [B, H, S] that receives each row's
// logsumexp of the scaled, masked logits (natural log), which the backward
// kernels read.  Returns cudaGetLastError() after the launch (0 = launched).  The
// caller has checked shapes, dtypes (bf16, int32 seg), D == 64,
// S % 128 == 0, a contiguous D, strides that are multiples of 8 elements and
// 16-byte aligned pointers.
extern "C" int mfar_flash_attention_fwd(const void* q, const void* k, const void* v,
                                        const int32_t* seg, void* o, float* lse, int B, int H,
                                        int S,
                                        const long long* strides, float sm_scale,
                                        cudaStream_t stream) {
  if (B == 0 || H == 0) return 0;
  if (S <= 0 || S % kBlockM || S % kBlockN) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = static_cast<long long>(B) * H * (S / kBlockM);
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.seg = seg;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = lse;
  p.q_sb = strides[0], p.q_sh = strides[1], p.q_ss = strides[2];
  p.k_sb = strides[3], p.k_sh = strides[4], p.k_ss = strides[5];
  p.v_sb = strides[6], p.v_sh = strides[7], p.v_ss = strides[8];
  p.o_sb = strides[9], p.o_sh = strides[10], p.o_ss = strides[11];
  p.H = H;
  p.S = S;
  p.scale_log2 = sm_scale * kLog2e;
  flash_attention_fwd_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}
