// The mask head's 32-position WMMA tile of the decode tail's logits mode
// (decode_tail.cu, entry rat_decode_tail_logits), its only user: the JAX
// package runs the same `mask_head_body`
// (revisit_anything_tpu/ops/maskhead.py:138) in the tail's emit_logits
// branch (ops/decode_fused.py:304-341). K3 and B6 (mask_head.cu, entries
// rat_mask_head and rat_mask_head_probs) share their own TMA + wgmma
// design and do not include this header.
//
// One CTA of 256 threads holds up1_w (128 KB) and up2_w (16 KB) in shared
// memory and runs a tile of BLK = 32 positions of one prompt's final
// branch keys[p, 0:256] (bf16) through
//   y1 = bf16(x · up1_w) + up1_b                 (ConvT k=s=2 256 -> 4x64)
//   h1 = bf16(gelu(groupLN_64(y1)))              (4 groups of 64, f32 stats)
//   y2[q] = bf16(h1[q] · up2_w) + up2_b          (ConvT 64 -> 4x32 per block q)
//   h2 = bf16(gelu(y2))
//   out[n, p, 4q + r, m] = bf16(sum_c h2[q, r, c] · hyper[n, m, c])
// into the block layout [Np, content, 16, M], (q, r) = (2a1+b1, 2a2+b2).
// Both products run on WMMA bf16 fragments with f32 accumulation; the
// accumulators pass through a small f32 staging tile where the JAX
// rounding points apply (y1 and y2 rounded before their bias add, h1/h2
// stored as bf16). GELU is erff, not the TPU's polynomial.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <math.h>
#include <stdint.h>

namespace rat_mask {

constexpr int D = 256;     // prompt dim (keys channels, conv1 in/out)
constexpr int C1 = 64;     // conv1 channels per 2x2 block
constexpr int C2 = 32;     // conv2 channels per 2x2 block
constexpr int N2 = 4 * C2; // conv2 outputs per conv1 block (128)
constexpr int BLK = 32;    // positions per tile
constexpr int THREADS = 256;
constexpr int MAXM = 4;    // mask tokens

// Shared-memory layout, in this order from the start of the block's
// dynamic shared memory.
constexpr int SMEM_W1 = D * D * 2;           // 131072
constexpr int SMEM_W2 = C1 * N2 * 2;         // 16384
constexpr int SMEM_X = BLK * D * 2;          // 16384
constexpr int SMEM_H1 = BLK * D * 2;         // 16384
constexpr int SMEM_Y = BLK * N2 * 4;         // 16384
constexpr int SMEM_VEC = (3 * C1 + C2 + MAXM * C2) * 4;
constexpr int OFF_X = SMEM_W1 + SMEM_W2;
constexpr int OFF_H1 = OFF_X + SMEM_X;
constexpr int OFF_Y = OFF_H1 + SMEM_H1;
constexpr int OFF_VEC = OFF_Y + SMEM_Y;
constexpr int SMEM_TOTAL = OFF_VEC + SMEM_VEC;
static_assert(SMEM_H1 + SMEM_Y == BLK * D * 4, "h1 and y span one f32 [BLK][D] tile");

struct Smem {
  __nv_bfloat16 *w1, *w2, *x, *h1;
  float *y, *b1, *ls, *lb, *b2, *hyp;
};

__device__ __forceinline__ Smem layout(unsigned char* smem) {
  Smem s;
  s.w1 = reinterpret_cast<__nv_bfloat16*>(smem);
  s.w2 = reinterpret_cast<__nv_bfloat16*>(smem + SMEM_W1);
  s.x = reinterpret_cast<__nv_bfloat16*>(smem + OFF_X);
  s.h1 = reinterpret_cast<__nv_bfloat16*>(smem + OFF_H1);
  s.y = reinterpret_cast<float*>(smem + OFF_Y);
  s.b1 = reinterpret_cast<float*>(smem + OFF_VEC);   // up1_b [C1]
  s.ls = s.b1 + C1;                                  // ln scale [C1]
  s.lb = s.ls + C1;                                  // ln bias [C1]
  s.b2 = s.lb + C1;                                  // up2_b [C2]
  s.hyp = s.b2 + C2;                                 // hyper [MAXM][C2]
  return s;
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float gelu(float x) {
  return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
}

// The resident weights and vectors (all of Smem but x, h1, y and hyp).
__device__ __forceinline__ void load_weights(const Smem& s, const __nv_bfloat16* up1_w,
                                             const __nv_bfloat16* up1_b,
                                             const __nv_bfloat16* ln_s,
                                             const __nv_bfloat16* ln_b,
                                             const __nv_bfloat16* up2_w,
                                             const __nv_bfloat16* up2_b) {
  const uint4* w1 = reinterpret_cast<const uint4*>(up1_w);
  const uint4* w2 = reinterpret_cast<const uint4*>(up2_w);
  for (int i = threadIdx.x; i < SMEM_W1 / 16; i += THREADS) reinterpret_cast<uint4*>(s.w1)[i] = w1[i];
  for (int i = threadIdx.x; i < SMEM_W2 / 16; i += THREADS) reinterpret_cast<uint4*>(s.w2)[i] = w2[i];
  for (int i = threadIdx.x; i < C1; i += THREADS) {
    s.b1[i] = __bfloat162float(up1_b[i]);
    s.ls[i] = __bfloat162float(ln_s[i]);
    s.lb[i] = __bfloat162float(ln_b[i]);
  }
  for (int i = threadIdx.x; i < C2; i += THREADS) s.b2[i] = __bfloat162float(up2_b[i]);
}

// One tile: s.x holds positions p0..p0+BLK-1 of prompt n (rows past
// `content` zero) and s.hyp its n_masks hypernetwork rows, both visible to
// the block. Writes out[n, p0.., :, :] for positions below `content`;
// leaves x and hyp untouched and ends synchronised.
__device__ __forceinline__ void tile(const Smem& s, __nv_bfloat16* __restrict__ out, int n,
                                     int content, int p0, int n_masks, float eps) {
  using namespace nvcuda;
  const int tid = threadIdx.x;
  const int warp = tid / 32;

  // conv1 + group LayerNorm + GELU, one 64-channel group at a time.
  for (int g = 0; g < 4; ++g) {
    {
      const int rt = warp / 4, ct = warp % 4;     // 2 x 4 tiles of 16x16
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll 4
      for (int kk = 0; kk < D; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(a, s.x + rt * 16 * D + kk, D);
        wmma::load_matrix_sync(b, s.w1 + kk * D + g * C1 + ct * 16, D);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(s.y + rt * 16 * C1 + ct * 16, acc, C1, wmma::mem_row_major);
    }
    __syncthreads();
    {
      // 8 threads per position, 8 channels each.
      const int pos = tid / 8, sub = tid % 8;
      float y[8];
      float sum = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int c = sub * 8 + e;
        y[e] = bf16_round(bf16_round(s.y[pos * C1 + c]) + s.b1[c]);
        sum += y[e];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      const float mu = sum / C1;
      float v = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) v += (y[e] - mu) * (y[e] - mu);
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      const float rs = rsqrtf(v / C1 + eps);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int c = sub * 8 + e;
        const float yn = (y[e] - mu) * rs * s.ls[c] + s.lb[c];
        s.h1[pos * D + g * C1 + c] = __float2bfloat16(gelu(yn));
      }
    }
    __syncthreads();
  }

  // conv2 per 2x2 block q, GELU, hypernetwork.
  for (int q = 0; q < 4; ++q) {
    {
      const int rt = warp / 4, ct0 = (warp % 4) * 2;   // 2 x 8 tiles
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int ct = ct0 + u;
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::fill_fragment(acc, 0.f);
#pragma unroll
        for (int kk = 0; kk < C1; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
          wmma::load_matrix_sync(a, s.h1 + rt * 16 * D + q * C1 + kk, D);
          wmma::load_matrix_sync(b, s.w2 + kk * N2 + ct * 16, N2);
          wmma::mma_sync(acc, a, b, acc);
        }
        wmma::store_matrix_sync(s.y + rt * 16 * N2 + ct * 16, acc, N2, wmma::mem_row_major);
      }
    }
    __syncthreads();
    for (int i = tid; i < BLK * N2; i += THREADS) {
      const int c = i % C2;
      const float y = bf16_round(bf16_round(s.y[i]) + s.b2[c]);
      s.y[i] = bf16_round(gelu(y));
    }
    __syncthreads();
    for (int o = tid; o < BLK * 4 * n_masks; o += THREADS) {
      const int pos = o / (4 * n_masks);
      const int rem = o % (4 * n_masks);
      const int r = rem / n_masks, m = rem % n_masks;
      if (p0 + pos >= content) continue;
      const float* hrow = s.y + pos * N2 + r * C2;
      const float* wrow = s.hyp + m * C2;
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < C2; ++c) acc = fmaf(hrow[c], wrow[c], acc);
      out[(((size_t)n * content + p0 + pos) * 16 + q * 4 + r) * n_masks + m] =
          __float2bfloat16(acc);
    }
    __syncthreads();
  }
}

}  // namespace rat_mask
