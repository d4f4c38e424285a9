// Device code shared by the probability-factored decode kernels:
// decode_tail.cu (B3), i2t_probs.cu (B7) and t2i_probs.cu (B8). Their
// per-tile products run on the tensor cores (decode_tc.cuh); this header
// holds the widths, the warp reductions and the token-side pieces on the
// FMA units. B6 (mask_head.cu) rebuilds its branch by wgmma.
//
// The JAX package shares the same pieces between its TPU kernels:
// revisit_anything_tpu/ops/decode_probs.py `_head_softmax_rows` (:79),
// ops/decode_fused.py `_dense_rows` (:85) and `_ln_rows` (:73).
//
// One CTA of 256 threads works on one prompt's tiles of BM = 32 image
// positions. Thread mappings:
//   - scores and softmax give warp w the head h = w and lane l the
//     position l of the tile, so a head's 7 token rows sit in one warp;
//   - token-side rows give thread tid an output column, row LayerNorms one
//     warp a row.
// Rounding points follow the JAX bodies: token-side dense layers round the
// f32 product to bf16 before the bias add, token-side LayerNorms run in
// f32 (two-pass) and round to bf16; on an f32 SAM's f32 weights nothing
// rounds (round_tok).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace rat_decode {

constexpr int D = 256;        // branch channels
constexpr int DA = 128;       // attention width
constexpr int H = 8;          // heads
constexpr int HD = DA / H;    // 16
constexpr int T = 7;          // tokens: iou, 4 mask, point, pad point
constexpr int HT = H * T;     // 56 probability rows per prompt
constexpr int BM = 32;        // positions per tile
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
static_assert(THREADS == D, "token-side rows give each thread one channel");
static_assert(WARPS == H, "the scores give each warp one head");
static_assert(BM == 32, "the scores give each lane one position");

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// The token side's rounding on weights of type WT: a bf16 SAM's values
// round to bf16, an f32 SAM's stay f32 (the JAX bodies at f32 round
// nothing).
template <typename WT>
__device__ __forceinline__ float round_tok(float x) {
  if constexpr (std::is_same_v<WT, float>)
    return x;
  else
    return bf16_round(x);
}

// One weight as f32: bf16 (a plain load) or f32 (through the read-only
// cache).
__device__ __forceinline__ float ldw(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float ldw(const float* p) { return __ldg(p); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ void unpack8(const uint4& v, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// n bf16 values -> f32 shared memory.
__device__ __forceinline__ void load_f32(float* dst, const __nv_bfloat16* src, int n) {
  for (int i = threadIdx.x; i < n; i += THREADS) dst[i] = __bfloat162float(src[i]);
}

// n f32 values -> f32 shared memory.
__device__ __forceinline__ void load_f32(float* dst, const float* src, int n) {
  for (int i = threadIdx.x; i < n; i += THREADS) dst[i] = src[i];
}

// Softmax over the T tokens of one head (the JAX `_head_softmax_rows`).
__device__ __forceinline__ void softmax_tokens(float s[T]) {
  float mx = s[0];
#pragma unroll
  for (int t = 1; t < T; ++t) mx = fmaxf(mx, s[t]);
  float z = 0.f;
#pragma unroll
  for (int t = 0; t < T; ++t) {
    s[t] = expf(s[t] - mx);
    z += s[t];
  }
#pragma unroll
  for (int t = 0; t < T; ++t) s[t] = s[t] / z;
}

// o[t][c] = sum_d ctx[h(c)*T + t][d] * Wv[d][c] + vb[c], c < DA: the value
// projection applied after the softmax (rows of p sum to 1, so the v bias
// moves out exactly). Rounded to bf16 (the JAX `astype(dtype)`), into
// o [T][DA] f32 (shared).
__device__ __forceinline__ void attn_out(float* so, const float* sCtx,
                                         const __nv_bfloat16* Wv, const __nv_bfloat16* vb) {
  for (int i = threadIdx.x; i < T * DA; i += THREADS) {
    const int t = i / DA, c = i % DA, h = c / HD;
    const float* crow = sCtx + (h * T + t) * D;
    float a = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) a = fmaf(crow[d], __bfloat162float(Wv[(size_t)d * DA + c]), a);
    so[i] = bf16_round(a + __bfloat162float(vb[c]));
  }
}

__device__ __forceinline__ void add_rows(float* out, const float* a, const float* b, int n) {
  for (int i = threadIdx.x; i < n; i += THREADS) out[i] = bf16_round(a[i] + b[i]);
}

// Token-side LayerNorm of T rows of D on WT (bf16 or f32) scale and bias:
// f32, two-pass variance, rounded as the token side rounds (round_tok).
// One warp a row; x and out may alias.
template <typename WT>
__device__ __forceinline__ void ln_rows(float* out, const float* x, const WT* sc, const WT* bi,
                                        float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int t = warp; t < T; t += WARPS) {
    float v[D / 32];
    float s = 0.f;
#pragma unroll
    for (int e = 0; e < D / 32; ++e) {
      v[e] = x[t * D + lane + 32 * e];
      s += v[e];
    }
    const float mu = warp_sum(s) / D;
    float q = 0.f;
#pragma unroll
    for (int e = 0; e < D / 32; ++e) q += (v[e] - mu) * (v[e] - mu);
    const float rs = rsqrtf(warp_sum(q) / D + eps);
#pragma unroll
    for (int e = 0; e < D / 32; ++e) {
      const int c = lane + 32 * e;
      out[t * D + c] = round_tok<WT>((v[e] - mu) * rs * ldw(sc + c) + ldw(bi + c));
    }
  }
}

}  // namespace rat_decode
