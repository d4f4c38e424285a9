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
// rounded before their bias add, h1/h2 stored as bf16). The per-tile
// code lives in mask_head_tile.cuh, shared with the decode tail's logits
// mode (decode_tail.cu).
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

#include "decode_common.cuh"
#include "mask_head_tile.cuh"

namespace {

using namespace rat_mask;

constexpr int SMEM_RP = rat_decode::HT * BLK * 2;   // P tile (recon)
constexpr int SMEM_RV = 6 * D * 4;                  // branch rows 0-5 (recon)
constexpr int SMEM_RECON = SMEM_TOTAL + SMEM_RP + SMEM_RV;
static_assert(BLK == rat_decode::BM && THREADS == rat_decode::THREADS, "recon tile shape");

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
  const Smem sm = layout(smem);
  __nv_bfloat16* sRP = reinterpret_cast<__nv_bfloat16*>(smem + SMEM_TOTAL);
  float* sRV = reinterpret_cast<float*>(smem + SMEM_TOTAL + SMEM_RP);
  float* sR = reinterpret_cast<float*>(sm.h1);   // f32 rebuild tile [BLK][D]

  const int tid = threadIdx.x;
  load_weights(sm, up1_w, up1_b, ln_s, ln_b, up2_w, up2_b);
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
        sm.x[i] = __float2bfloat16(i / D < valid ? sR[i] : 0.f);
    } else {
      for (int i = tid; i < BLK * VPR; i += THREADS) {
        const int r = i / VPR, c = i % VPR;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (p0 + r < content)
          val = reinterpret_cast<const uint4*>(keys + ((size_t)n * gg + p0 + r) * D)[c];
        reinterpret_cast<uint4*>(sm.x + r * D)[c] = val;
      }
    }
    for (int i = tid; i < n_masks * C2; i += THREADS)
      sm.hyp[i] = __bfloat162float(hyper[(size_t)n * n_masks * C2 + i]);
    __syncthreads();
    tile(sm, out, n, content, p0, n_masks, eps);
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
