// Fused SAM mask head: upscaler + hypernetwork in one pass.
//
// Replaces: revisit_anything_tpu/ops/maskhead.py `_mask_head_call` /
// `_mask_head_kernel` -> `mask_head_body` (pallas_call at :299, body
// :138), reached through `fused_mask_head` (:345). Per image position of
// one prompt's final branch keys[n, p, 0:256]:
//   y1 = bf16(x · up1_w) + up1_b                 (ConvT k=s=2 256 -> 4x64)
//   h1 = bf16(gelu(groupLN_64(y1)))              (4 groups of 64, f32 stats)
//   y2[q] = bf16(h1[q] · up2_w) + up2_b          (ConvT 64 -> 4x32 per block q)
//   h2 = bf16(gelu(y2))
//   out[n, p, 4q + r, m] = bf16(sum_c h2[q, r, c] · hyper[n, m, c])
// giving [Np, content, 16, M] in the (q, r) = (2a1+b1, 2a2+b2) order.
//
// What bounds it on the H100: tensor-core math. At 1024 prompts x 3136
// positions the two convolutions are ~630 GFLOP per decode; inputs
// (1.6 GB keys) and outputs (0.3 GB) are small next to that. The TPU
// kernel's block-diagonal conv2 [256, 512] and hypernetwork [512, 48]
// (3/4 and 15/16 zeros, shaped for the 128x128 MXU) are NOT carried:
// conv2 runs as four [64 -> 128] products per position and the
// hypernetwork as a 32-wide dot per output, and GELU uses erff instead of
// the TPU's polynomial.
//
// Design: persistent CTAs (one per SM, 8 warps) keep up1_w (128 KB) and
// up2_w (16 KB) in shared memory for their whole life and walk 32-position
// tiles of all prompts. Both products use WMMA bf16 fragments with f32
// accumulation; accumulators pass through a small f32 staging tile where
// the bf16 rounding points of the JAX kernel are applied (y1 and y2
// rounded before their bias add, h1/h2 stored as bf16).
//
// The same kernel with RECON (entry rat_mask_head_probs) replaces
// revisit_anything_tpu/ops/maskhead.py `_mask_head_call_probs`
// (pallas_call at :257, body :90-126 with recon=True), reached through
// `fused_mask_head_probs` (:409): the keys tile is not read but rebuilt
// per position from the shared img0 and the two image -> token updates,
//   x = bf16(LN(LN(img0 + P1^T C1 + b1) + P2^T C2 + b2))     (f32, one-pass var)
// by decode_common.cuh `recon_layer`, writing the tile the conv1 product
// reads. That adds 2 x 56 x 256 multiply-adds a position on the FMA units
// (~0.18 TFLOP at 1024 prompts x 3136 positions) and reads P1, P2 (2 x 470
// MB) in place of keys (2.1 GB). The f32 rebuild tile [32, 256] reuses the
// h1 and y staging tiles (32 KB, free until conv1); the P tile and the
// branch vectors add 9.5 KB beside the resident weights, 207 KB in all.
// C1 and C2 (28 KB a prompt each) do not fit beside them and are read
// from L1/L2.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <math.h>
#include <stdint.h>

#include "decode_common.cuh"

using namespace nvcuda;

namespace {

constexpr int D = 256;     // prompt dim (keys channels, conv1 in/out)
constexpr int C1 = 64;     // conv1 channels per 2x2 block
constexpr int C2 = 32;     // conv2 channels per 2x2 block
constexpr int N2 = 4 * C2; // conv2 outputs per conv1 block (128)
constexpr int BLK = 32;    // positions per tile
constexpr int THREADS = 256;
constexpr int MAXM = 4;    // mask tokens

constexpr int SMEM_W1 = D * D * 2;           // 131072
constexpr int SMEM_W2 = C1 * N2 * 2;         // 16384
constexpr int SMEM_X = BLK * D * 2;          // 16384
constexpr int SMEM_H1 = BLK * D * 2;         // 16384
constexpr int SMEM_Y = BLK * N2 * 4;         // 16384
constexpr int SMEM_VEC = (3 * C1 + C2 + MAXM * C2) * 4;
constexpr int SMEM_TOTAL = SMEM_W1 + SMEM_W2 + SMEM_X + SMEM_H1 + SMEM_Y + SMEM_VEC;
constexpr int SMEM_RP = rat_decode::HT * BLK * 2;   // P tile (recon)
constexpr int SMEM_RV = 6 * D * 4;                  // branch rows 0-5 (recon)
constexpr int SMEM_RECON = SMEM_TOTAL + SMEM_RP + SMEM_RV;
static_assert(SMEM_H1 + SMEM_Y == BLK * D * 4, "the f32 rebuild tile spans h1 and y");
static_assert(BLK == rat_decode::BM && THREADS == rat_decode::THREADS, "recon tile shape");

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float gelu(float x) {
  return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
}

__device__ __forceinline__ void copy_vec(void* dst, const void* src, int bytes) {
  const uint4* s = static_cast<const uint4*>(src);
  uint4* t = static_cast<uint4*>(dst);
  for (int i = threadIdx.x; i < bytes / 16; i += THREADS) t[i] = s[i];
}

// RECON: keys is the shared img0 [gg, D]; the per-prompt tile is rebuilt
// from p1/c1m/p2/c2m [Np, HT, gg | D] and the branch rows [8, D].
template <bool RECON>
__global__ void __launch_bounds__(THREADS, 1)
mask_head_kernel(const __nv_bfloat16* __restrict__ keys,   // [Np, gg, D]
                 const __nv_bfloat16* __restrict__ up1_w,  // [D, D]
                 const __nv_bfloat16* __restrict__ up1_b,  // [C1]
                 const __nv_bfloat16* __restrict__ ln_s,   // [C1]
                 const __nv_bfloat16* __restrict__ ln_b,   // [C1]
                 const __nv_bfloat16* __restrict__ up2_w,  // [C1, N2]
                 const __nv_bfloat16* __restrict__ up2_b,  // [C2]
                 const __nv_bfloat16* __restrict__ hyper,  // [Np, M, C2]
                 __nv_bfloat16* __restrict__ out,          // [Np, content, 16, M]
                 int np_, int gg, int content, int n_masks, float eps,
                 const __nv_bfloat16* __restrict__ p1, const __nv_bfloat16* __restrict__ c1m,
                 const __nv_bfloat16* __restrict__ p2, const __nv_bfloat16* __restrict__ c2m,
                 const __nv_bfloat16* __restrict__ rows, float ln_eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sW1 = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sW2 = reinterpret_cast<__nv_bfloat16*>(smem + SMEM_W1);
  __nv_bfloat16* sX = reinterpret_cast<__nv_bfloat16*>(smem + SMEM_W1 + SMEM_W2);
  __nv_bfloat16* sH1 = reinterpret_cast<__nv_bfloat16*>(smem + SMEM_W1 + SMEM_W2 + SMEM_X);
  float* sY = reinterpret_cast<float*>(smem + SMEM_W1 + SMEM_W2 + SMEM_X + SMEM_H1);
  float* sB1 = sY + BLK * N2;       // up1_b [C1]
  float* sLs = sB1 + C1;            // ln scale [C1]
  float* sLb = sLs + C1;            // ln bias [C1]
  float* sB2 = sLb + C1;            // up2_b [C2]
  float* sHyp = sB2 + C2;           // [MAXM][C2]
  __nv_bfloat16* sRP = reinterpret_cast<__nv_bfloat16*>(smem + SMEM_TOTAL);
  float* sRV = reinterpret_cast<float*>(smem + SMEM_TOTAL + SMEM_RP);
  float* sR = reinterpret_cast<float*>(sH1);   // f32 rebuild tile [BLK][D]

  const int tid = threadIdx.x;
  const int warp = tid / 32;

  copy_vec(sW1, up1_w, SMEM_W1);
  copy_vec(sW2, up2_w, SMEM_W2);
  for (int i = tid; i < C1; i += THREADS) {
    sB1[i] = __bfloat162float(up1_b[i]);
    sLs[i] = __bfloat162float(ln_s[i]);
    sLb[i] = __bfloat162float(ln_b[i]);
  }
  for (int i = tid; i < C2; i += THREADS) sB2[i] = __bfloat162float(up2_b[i]);
  if (RECON) rat_decode::load_f32(sRV, rows, 6 * D);

  const int tiles = (content + BLK - 1) / BLK;
  const long long total = (long long)np_ * tiles;
  for (long long t = blockIdx.x; t < total; t += gridDim.x) {
    const int n = (int)(t / tiles);
    const int p0 = (int)(t % tiles) * BLK;
    __syncthreads();                       // previous tile fully consumed

    // Load (or rebuild) the keys tile, zero rows past content, and this
    // prompt's hyper.
    constexpr int VPR = D / 8;
    if (RECON) {
      const int valid = min(BLK, content - p0);
      const size_t off = (size_t)n * rat_decode::HT;
      rat_decode::load_rows_tile(sR, D, keys, p0, valid);
      rat_decode::load_p_tile(sRP, p1 + off * gg, gg, p0, valid);
      __syncthreads();
      rat_decode::recon_layer(sR, D, sRP, c1m + off * D, sRV, ln_eps);
      rat_decode::load_p_tile(sRP, p2 + off * gg, gg, p0, valid);
      __syncthreads();
      rat_decode::recon_layer(sR, D, sRP, c2m + off * D, sRV + 3 * D, ln_eps);
      for (int i = tid; i < BLK * D; i += THREADS)
        sX[i] = __float2bfloat16(i / D < valid ? sR[i] : 0.f);
    } else {
      for (int i = tid; i < BLK * VPR; i += THREADS) {
        const int r = i / VPR, c = i % VPR;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (p0 + r < content)
          val = reinterpret_cast<const uint4*>(keys + ((size_t)n * gg + p0 + r) * D)[c];
        reinterpret_cast<uint4*>(sX + r * D)[c] = val;
      }
    }
    for (int i = tid; i < n_masks * C2; i += THREADS)
      sHyp[i] = __bfloat162float(hyper[(size_t)n * n_masks * C2 + i]);
    __syncthreads();

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
          wmma::load_matrix_sync(a, sX + rt * 16 * D + kk, D);
          wmma::load_matrix_sync(b, sW1 + kk * D + g * C1 + ct * 16, D);
          wmma::mma_sync(acc, a, b, acc);
        }
        wmma::store_matrix_sync(sY + rt * 16 * C1 + ct * 16, acc, C1,
                                wmma::mem_row_major);
      }
      __syncthreads();
      {
        // 8 threads per position, 8 channels each.
        const int pos = tid / 8, sub = tid % 8;
        float y[8];
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int c = sub * 8 + e;
          y[e] = bf16_round(bf16_round(sY[pos * C1 + c]) + sB1[c]);
          s += y[e];
        }
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        s += __shfl_xor_sync(0xffffffffu, s, 4);
        const float mu = s / C1;
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
          const float yn = (y[e] - mu) * rs * sLs[c] + sLb[c];
          sH1[pos * D + g * C1 + c] = __float2bfloat16(gelu(yn));
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
            wmma::load_matrix_sync(a, sH1 + rt * 16 * D + q * C1 + kk, D);
            wmma::load_matrix_sync(b, sW2 + kk * N2 + ct * 16, N2);
            wmma::mma_sync(acc, a, b, acc);
          }
          wmma::store_matrix_sync(sY + rt * 16 * N2 + ct * 16, acc, N2,
                                  wmma::mem_row_major);
        }
      }
      __syncthreads();
      for (int i = tid; i < BLK * N2; i += THREADS) {
        const int c = i % C2;
        const float y = bf16_round(bf16_round(sY[i]) + sB2[c]);
        sY[i] = bf16_round(gelu(y));
      }
      __syncthreads();
      for (int o = tid; o < BLK * 4 * n_masks; o += THREADS) {
        const int pos = o / (4 * n_masks);
        const int rem = o % (4 * n_masks);
        const int r = rem / n_masks, m = rem % n_masks;
        if (p0 + pos >= content) continue;
        const float* hrow = sY + pos * N2 + r * C2;
        const float* wrow = sHyp + m * C2;
        float acc = 0.f;
#pragma unroll
        for (int c = 0; c < C2; ++c) acc = fmaf(hrow[c], wrow[c], acc);
        out[(((size_t)n * content + p0 + pos) * 16 + q * 4 + r) * n_masks + m] =
            __float2bfloat16(acc);
      }
      __syncthreads();
    }
  }
}

template <bool RECON>
int launch(const void* keys, const void* up1_w, const void* up1_b, const void* ln_s,
           const void* ln_b, const void* up2_w, const void* up2_b, const void* hyper,
           void* out, int np_, int gg, int content, int n_masks, float eps, int n_ctas,
           const void* p1, const void* c1m, const void* p2, const void* c2m,
           const void* rows, float ln_eps, void* stream) {
  if (n_masks < 1 || n_masks > MAXM || content > gg || n_ctas < 1)
    return (int)cudaErrorInvalidValue;
  const int smem = RECON ? SMEM_RECON : SMEM_TOTAL;
  cudaError_t err = cudaFuncSetAttribute(
      mask_head_kernel<RECON>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  typedef const __nv_bfloat16* P;
  mask_head_kernel<RECON><<<n_ctas, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<P>(keys), static_cast<P>(up1_w), static_cast<P>(up1_b),
      static_cast<P>(ln_s), static_cast<P>(ln_b), static_cast<P>(up2_w),
      static_cast<P>(up2_b), static_cast<P>(hyper), static_cast<__nv_bfloat16*>(out), np_,
      gg, content, n_masks, eps, static_cast<P>(p1), static_cast<P>(c1m),
      static_cast<P>(p2), static_cast<P>(c2m), static_cast<P>(rows), ln_eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rat_mask_head(const void* keys, const void* up1_w, const void* up1_b,
                             const void* ln_s, const void* ln_b, const void* up2_w,
                             const void* up2_b, const void* hyper, void* out,
                             int np_, int gg, int content, int n_masks, float eps,
                             int n_ctas, void* stream) {
  return launch<false>(keys, up1_w, up1_b, ln_s, ln_b, up2_w, up2_b, hyper, out, np_, gg,
                       content, n_masks, eps, n_ctas, nullptr, nullptr, nullptr, nullptr,
                       nullptr, 0.f, stream);
}

extern "C" int rat_mask_head_probs(const void* img0, const void* p1, const void* c1m,
                                   const void* p2, const void* c2m, const void* rows,
                                   const void* up1_w, const void* up1_b, const void* ln_s,
                                   const void* ln_b, const void* up2_w, const void* up2_b,
                                   const void* hyper, void* out, int np_, int gg,
                                   int content, int n_masks, float eps, float ln_eps,
                                   int n_ctas, void* stream) {
  if (gg % 8 != 0) return (int)cudaErrorInvalidValue;   // 16-byte P rows
  return launch<true>(img0, up1_w, up1_b, ln_s, ln_b, up2_w, up2_b, hyper, out, np_, gg,
                      content, n_masks, eps, n_ctas, p1, c1m, p2, c2m, rows, ln_eps,
                      stream);
}
