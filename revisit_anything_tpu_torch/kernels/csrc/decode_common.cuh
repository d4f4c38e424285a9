// Device code shared by the probability-factored decode kernels on the
// FMA units: i2t_probs.cu (B7) and t2i_probs.cu (B8); decode_tail.cu
// (B3) takes its token-side pieces and runs its per-tile products on the
// tensor cores (decode_tc.cuh). B6 (mask_head.cu) rebuilds its branch by
// wgmma.
//
// The JAX package shares the same pieces between its TPU kernels:
// revisit_anything_tpu/ops/decode_probs.py `_recon_t` (:51) and
// `_head_softmax_rows` (:79), ops/decode_fused.py `_recon_step` (:94),
// `_bd_attend_q` (:108), `_dense_rows` (:85) and `_ln_rows` (:73).
//
// One CTA of 256 threads works on a tile of BM = 32 image positions of
// one prompt. The branch tile lives in shared memory as f32 [BM][ld]
// (position-major). Thread mappings:
//   - the reconstruction gives thread tid the channel column d = tid;
//   - scores and softmax give warp w the head h = w and lane l the
//     position l of the tile, so a head's 7 token rows sit in one warp;
//   - row LayerNorms give one warp a row.
// Rounding points follow the JAX bodies: P is bf16 and read as bf16, the
// branch stays f32 with the one-pass variance max(E[y^2] - mu^2, 0),
// token-side dense layers round the f32 product to bf16 before the bias
// add, token-side LayerNorms run in f32 (two-pass) and round to bf16.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

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
constexpr int LDY = D + 4;    // f32 tile stride: float4 rows conflict-free
static_assert(THREADS == D, "the reconstruction gives each thread one channel");
static_assert(WARPS == H, "the scores give each warp one head");
static_assert(BM == 32, "the scores give each lane one position");

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

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

// Branch tile <- img0 rows m0..m0+BM-1 ([M, D] bf16), rows at or past
// `valid` zero.
__device__ __forceinline__ void load_rows_tile(float* sY, int ld, const __nv_bfloat16* img0,
                                               int m0, int valid) {
  constexpr int VPR = D / 8;
  for (int i = threadIdx.x; i < BM * VPR; i += THREADS) {
    const int r = i / VPR, c = i % VPR;
    float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (r < valid)
      unpack8(reinterpret_cast<const uint4*>(img0 + (size_t)(m0 + r) * D)[c], f);
#pragma unroll
    for (int e = 0; e < 8; ++e) sY[r * ld + c * 8 + e] = f[e];
  }
}

// P tile [HT][BM] bf16 <- columns m0..m0+BM-1 of one prompt's P^T
// [HT, M]; columns at or past `valid` zero.
__device__ __forceinline__ void load_p_tile(__nv_bfloat16* sP, const __nv_bfloat16* p, int m,
                                            int m0, int valid) {
  if (valid == BM) {
    for (int i = threadIdx.x; i < HT * (BM / 8); i += THREADS) {
      const int k = i / (BM / 8), q = i % (BM / 8);
      reinterpret_cast<uint4*>(sP + k * BM)[q] =
          *reinterpret_cast<const uint4*>(p + (size_t)k * m + m0 + q * 8);
    }
  } else {
    for (int i = threadIdx.x; i < HT * BM; i += THREADS) {
      const int k = i / BM, c = i % BM;
      sP[i] = c < valid ? p[(size_t)k * m + m0 + c] : __float2bfloat16(0.f);
    }
  }
}

// One branch update on the tile: y <- LN(y + P^T C + b) per position, f32,
// with the one-pass variance. sP [HT][BM] bf16 (shared), C [HT][D] bf16
// (one prompt's; global or shared), vec = {b, ln scale, ln bias} [3][D]
// f32 (shared). Ends with the tile complete (synchronised).
__device__ __forceinline__ void recon_layer(float* sY, int ld, const __nv_bfloat16* sP,
                                            const __nv_bfloat16* C, const float* vec,
                                            float eps) {
  const int d = threadIdx.x;
  float acc[BM];
#pragma unroll
  for (int r = 0; r < BM; ++r) acc[r] = 0.f;
#pragma unroll 2
  for (int k = 0; k < HT; ++k) {
    const float c = __bfloat162float(C[k * D + d]);
    const uint4* prow = reinterpret_cast<const uint4*>(sP + k * BM);
#pragma unroll
    for (int q = 0; q < BM / 8; ++q) {
      float p[8];
      unpack8(prow[q], p);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[q * 8 + e] = fmaf(p[e], c, acc[q * 8 + e]);
    }
  }
#pragma unroll
  for (int r = 0; r < BM; ++r) sY[r * ld + d] += acc[r];
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < BM; r += WARPS) {
    float v[D / 32];
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int e = 0; e < D / 32; ++e) {
      const int c = lane + 32 * e;
      v[e] = sY[r * ld + c] + vec[c];
      s += v[e];
      ss += v[e] * v[e];
    }
    s = warp_sum(s);
    ss = warp_sum(ss);
    const float mu = s / D;
    const float rs = rsqrtf(fmaxf(ss / D - mu * mu, 0.f) + eps);
#pragma unroll
    for (int e = 0; e < D / 32; ++e) {
      const int c = lane + 32 * e;
      sY[r * ld + c] = (v[e] - mu) * rs * vec[D + c] + vec[2 * D + c];
    }
  }
  __syncthreads();
}

// Token-side matrix pushed through a projection: Q[h*T + t][d] =
// sum_j q[t][h*HD + j] * W[d][h*HD + j], q [T][DA] f32 (shared), W [D][DA]
// bf16 (global), Q [HT][D] f32 (shared). The query side of
// (q_h W_h^T) . keys = q_h . (keys W_h): the big per-position product
// shrinks to HT rows.
__device__ __forceinline__ void project_rows(float* sQ, const float* sq,
                                             const __nv_bfloat16* W) {
  const int d = threadIdx.x;
#pragma unroll 1
  for (int h = 0; h < H; ++h) {
    float w[HD];
    const uint4* wrow = reinterpret_cast<const uint4*>(W + (size_t)d * DA + h * HD);
    unpack8(wrow[0], w);
    unpack8(wrow[1], w + 8);
#pragma unroll
    for (int t = 0; t < T; ++t) {
      float a = 0.f;
#pragma unroll
      for (int j = 0; j < HD; ++j) a = fmaf(sq[t * DA + h * HD + j], w[j], a);
      sQ[(h * T + t) * D + d] = a;
    }
  }
}

// s[t] = sum_d Q[h*T + t][d] * Y[pos][d] for the calling thread's head h
// (its warp) and position pos (its lane).
__device__ __forceinline__ void head_scores(float s[T], const float* sQ, const float* sY,
                                            int ld, int h, int pos) {
#pragma unroll
  for (int t = 0; t < T; ++t) s[t] = 0.f;
  const float4* y4 = reinterpret_cast<const float4*>(sY + pos * ld);
#pragma unroll 4
  for (int c = 0; c < D / 4; ++c) {
    const float4 y = y4[c];
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const float4 q = reinterpret_cast<const float4*>(sQ + (h * T + t) * D)[c];
      s[t] = fmaf(q.x, y.x, fmaf(q.y, y.y, fmaf(q.z, y.z, fmaf(q.w, y.w, s[t]))));
    }
  }
}

// s[t] += sum_j q[t][h*HD + j] * pet[h*HD + j][col]: a token-side
// vector against a transposed positional term pet [DA, M] (global).
__device__ __forceinline__ void add_pe_term(float s[T], const float* sq,
                                            const __nv_bfloat16* pet, int m, int h,
                                            int col) {
  float pe[HD];
#pragma unroll
  for (int j = 0; j < HD; ++j) pe[j] = __bfloat162float(pet[(size_t)(h * HD + j) * m + col]);
#pragma unroll
  for (int t = 0; t < T; ++t) {
    float a = 0.f;
#pragma unroll
    for (int j = 0; j < HD; ++j) a = fmaf(sq[t * DA + h * HD + j], pe[j], a);
    s[t] += a;
  }
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

// Online-softmax state of one head's T token rows attending over the
// positions: the running max (the same in every lane), each lane's share
// of the running sum, and ctx[t][e] = sum_pos p * keys[pos][lane + 32e].
struct AttnState {
  float m[T];
  float l[T];
  float ctx[T][D / 32];
};

__device__ __forceinline__ void attn_init(AttnState& st) {
#pragma unroll
  for (int t = 0; t < T; ++t) {
    st.m[t] = -INFINITY;
    st.l[t] = 0.f;
#pragma unroll
    for (int e = 0; e < D / 32; ++e) st.ctx[t][e] = 0.f;
  }
}

// Fold one tile into the state: s[t] the calling lane's scaled score for
// its position (lanes past `valid` hold -inf), sY the branch tile.
__device__ __forceinline__ void attn_tile(AttnState& st, const float s[T], const float* sY,
                                          int ld) {
  const int lane = threadIdx.x % 32;
  float p[T];
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const float m_new = fmaxf(st.m[t], warp_max(s[t]));
    const float a = (st.m[t] == -INFINITY) ? 0.f : expf(st.m[t] - m_new);
    p[t] = (s[t] == -INFINITY) ? 0.f : expf(s[t] - m_new);
    st.l[t] = st.l[t] * a + p[t];
#pragma unroll
    for (int e = 0; e < D / 32; ++e) st.ctx[t][e] *= a;
    st.m[t] = m_new;
  }
#pragma unroll 4
  for (int src = 0; src < BM; ++src) {
    float y[D / 32];
#pragma unroll
    for (int e = 0; e < D / 32; ++e) y[e] = sY[src * ld + lane + 32 * e];
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const float pt = __shfl_sync(0xffffffffu, p[t], src);
#pragma unroll
      for (int e = 0; e < D / 32; ++e) st.ctx[t][e] = fmaf(pt, y[e], st.ctx[t][e]);
    }
  }
}

// ctx / sum -> sCtx [HT][D] f32 (shared), rows h*T + t of the warp's head.
__device__ __forceinline__ void attn_store(const AttnState& st, float* sCtx, int h) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const float inv = 1.f / warp_sum(st.l[t]);
#pragma unroll
    for (int e = 0; e < D / 32; ++e)
      sCtx[(h * T + t) * D + lane + 32 * e] = st.ctx[t][e] * inv;
  }
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

// Token-side LayerNorm of T rows of D: f32, two-pass variance, rounded to
// bf16. One warp a row; x and out may alias.
__device__ __forceinline__ void ln_rows(float* out, const float* x, const __nv_bfloat16* sc,
                                        const __nv_bfloat16* bi, float eps) {
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
      out[t * D + c] = bf16_round((v[e] - mu) * rs * __bfloat162float(sc[c]) +
                                  __bfloat162float(bi[c]));
    }
  }
}

}  // namespace rat_decode
