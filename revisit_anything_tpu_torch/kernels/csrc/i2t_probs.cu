// Image -> token attention probabilities of the probability-factored SAM
// decode, transposed: P^T [B, H*T, M] bf16.
//
// Replaces: revisit_anything_tpu/ops/decode_probs.py `_probs_call` /
// `_probs_kernel` (pallas_call at :179), reached through `i2t_probs`
// (:335). Per prompt b, head h, position m:
//   layer 1: s_t = k[b, t, h] . q1s[h, m] / 4          (q1s shared by all prompts)
//   layer 2: keys1 = LN(img0 + P1^T C1 + b1)            (rebuilt here, f32)
//            s_t = k[b, t, h] . (keys1[m] Wq2 + peq2[m])[h] / 4
//   P[b, h*7 + t, m] = bf16(softmax over the 7 tokens t of s)
//
// What bounds it on the H100: layer 1 is bound by its output, 470 MB of P
// at 1024 prompts x 4096 positions (0.14 ms at 3.35 TB/s); its 7 GFLOP of
// scores are small. Layer 2 is bound by the FMA units: per position the
// rebuild is 56 x 256 multiply-adds and the scores another 56 x 256, about
// 240 GFLOP at 1024 prompts, all f32 (keys1 is f32 in the JAX kernel).
//
// Design: one CTA of 8 warps per (prompt, 512 positions), walking 32-
// position tiles: warp = head, lane = position, so a head's 7 scores and
// their softmax stay in one thread's registers and the stores of P are
// coalesced along M. Layer 2 pushes Wq2 to the token side once per CTA
// (K2[h*7 + t] = k[t, h] Wq2[:, h]^T, [56, 256]; the JAX fused tail's
// reassociation), so a position costs 56 x 256 for the scores instead of
// 256 x 128 for its queries; the branch tile is rebuilt in shared memory
// by decode_common.cuh `recon_layer`, C1 read from L1/L2. The TPU kernel's
// block-diagonal token matrices are not carried: heads are warps.

#include "decode_common.cuh"

namespace {

using namespace rat_decode;

constexpr int TILES_PER_CTA = 16;

constexpr int SMEM_K = T * DA * 4;                  // token keys f32
constexpr int SMEM_Y = BM * LDY * 4;                // branch tile
constexpr int SMEM_Q = HT * D * 4;                  // K2 = k Wq2^T
constexpr int SMEM_P = HT * BM * 2;                 // P1 tile
constexpr int SMEM_V = 3 * D * 4;                   // b1, ln1 scale / bias
constexpr int SMEM_L2 = SMEM_K + SMEM_Y + SMEM_Q + SMEM_P + SMEM_V;

template <int LAYER>
__global__ void __launch_bounds__(THREADS)
i2t_probs_kernel(const __nv_bfloat16* __restrict__ q1st,   // [DA, M] (layer 1)
                 const __nv_bfloat16* __restrict__ tok_k,  // [B, T, DA]
                 const __nv_bfloat16* __restrict__ img0,   // [M, D] (layer 2)
                 const __nv_bfloat16* __restrict__ p1,     // [B, HT, M]
                 const __nv_bfloat16* __restrict__ c1,     // [B, HT, D]
                 const __nv_bfloat16* __restrict__ peq2t,  // [DA, M]
                 const __nv_bfloat16* __restrict__ w_q,    // [D, DA]
                 const __nv_bfloat16* __restrict__ rows,   // [8, D]
                 __nv_bfloat16* __restrict__ out,          // [B, HT, M]
                 int m, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sK = reinterpret_cast<float*>(smem);
  float* sY = reinterpret_cast<float*>(smem + SMEM_K);
  float* sQ = reinterpret_cast<float*>(smem + SMEM_K + SMEM_Y);
  __nv_bfloat16* sP = reinterpret_cast<__nv_bfloat16*>(smem + SMEM_K + SMEM_Y + SMEM_Q);
  float* sV = reinterpret_cast<float*>(smem + SMEM_K + SMEM_Y + SMEM_Q + SMEM_P);

  const int b = blockIdx.y;
  const int h = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float scale = rsqrtf((float)HD);
  load_f32(sK, tok_k + (size_t)b * T * DA, T * DA);
  if (LAYER == 2) load_f32(sV, rows, 3 * D);
  __syncthreads();
  if (LAYER == 2) project_rows(sQ, sK, w_q);     // read after the next barrier

  const int tiles = m / BM;
  const int t_end = min(tiles, (int)(blockIdx.x + 1) * TILES_PER_CTA);
  for (int tile = blockIdx.x * TILES_PER_CTA; tile < t_end; ++tile) {
    const int m0 = tile * BM;
    float s[T];
    if (LAYER == 1) {
#pragma unroll
      for (int t = 0; t < T; ++t) s[t] = 0.f;
      add_pe_term(s, sK, q1st, m, h, m0 + lane);
    } else {
      load_rows_tile(sY, LDY, img0, m0, BM);
      load_p_tile(sP, p1 + (size_t)b * HT * m, m, m0, BM);
      __syncthreads();
      recon_layer(sY, LDY, sP, c1 + (size_t)b * HT * D, sV, eps);
      head_scores(s, sQ, sY, LDY, h, lane);
      add_pe_term(s, sK, peq2t, m, h, m0 + lane);
    }
#pragma unroll
    for (int t = 0; t < T; ++t) s[t] *= scale;
    softmax_tokens(s);
#pragma unroll
    for (int t = 0; t < T; ++t)
      out[((size_t)b * HT + h * T + t) * m + m0 + lane] = __float2bfloat16(s[t]);
    if (LAYER == 2) __syncthreads();             // the tile is reloaded
  }
}

}  // namespace

extern "C" int rat_i2t_probs(const void* q1st, const void* tok_k, const void* img0,
                             const void* p1, const void* c1, const void* peq2t,
                             const void* w_q, const void* rows, void* out, int b, int m,
                             int layer, float eps, void* stream) {
  if (b < 1 || b > 65535 || m < BM || m % BM != 0 || (layer != 1 && layer != 2))
    return (int)cudaErrorInvalidValue;
  typedef const __nv_bfloat16* P;
  const dim3 grid((m / BM + TILES_PER_CTA - 1) / TILES_PER_CTA, b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (layer == 1) {
    i2t_probs_kernel<1><<<grid, THREADS, SMEM_K, s>>>(
        static_cast<P>(q1st), static_cast<P>(tok_k), nullptr, nullptr, nullptr, nullptr,
        nullptr, nullptr, static_cast<__nv_bfloat16*>(out), m, eps);
  } else {
    cudaError_t err = cudaFuncSetAttribute(
        i2t_probs_kernel<2>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_L2);
    if (err != cudaSuccess) return (int)err;
    i2t_probs_kernel<2><<<grid, THREADS, SMEM_L2, s>>>(
        nullptr, static_cast<P>(tok_k), static_cast<P>(img0), static_cast<P>(p1),
        static_cast<P>(c1), static_cast<P>(peq2t), static_cast<P>(w_q), static_cast<P>(rows),
        static_cast<__nv_bfloat16*>(out), m, eps);
  }
  return (int)cudaGetLastError();
}
