// Token -> image attention against the SAM image branch rebuilt from the
// image -> token probabilities (depth 1: the layer-2 token -> image
// attention; depth 2: the final attention).
//
// Replaces: revisit_anything_tpu/ops/decode_probs.py `_t2i_probs_call` /
// `_t2i_probs_kernel` (pallas_call at :290), reached through
// `t2i_from_probs` (:370). Per prompt b:
//   keys = LN(img0 + P1^T C1 + b1) [-> LN(keys + P2^T C2 + b2)]   f32 [M, D]
//   out[t, h] = softmax_m(q[t, h] . (keys Wk + pe_k)[m, h] / 4) . (keys Wv + bv)[:, h]
// with 7 token queries and 8 heads of 16 over M = 4096 positions.
//
// What bounds it on the H100: the FMA units. Per position the rebuild
// costs 56 x 256 multiply-adds a layer, the scores 56 x 256 and the
// context 56 x 256: about 0.36 (depth 1) or 0.48 (depth 2) TFLOP at 1024
// prompts, in f32 as in the JAX kernel (its keys are f32). Bytes are
// small: P (470 MB a layer at 1024 prompts) is read once.
//
// Design: one CTA of 8 warps per prompt walks the M positions in 32-
// position tiles with an online softmax, as token_cross.cu does over
// keys. The projections move to the query side (the JAX fused tail's
// `_bd_attend_q`): s = (q_h Wk_h^T) . keys + q_h . pe_k and
// out = (p . keys) Wv + bv, so no [M, 2*DA] k|v is ever formed; the same
// function up to f32 reassociation. Warp = head, lane = position: each
// warp keeps its head's 7 x 256 context in registers (56 a thread) and
// takes the softmax weights of the other lanes by shuffles. C1, C2 are
// read from L1/L2 (28 KB a prompt each); shared memory holds the f32
// branch tile (33 KB) and the [56, 256] query-side matrix (57 KB), 104 KB
// in all, so two CTAs share an SM.

#include "decode_common.cuh"

namespace {

using namespace rat_decode;

constexpr int SMEM_Y = BM * LDY * 4;
constexpr int SMEM_Q = HT * D * 4;     // q Wk^T, then the context
constexpr int SMEM_P = HT * BM * 2;
constexpr int SMEM_V = 6 * D * 4;      // branch rows 0-5
constexpr int SMEM_q = T * DA * 4;     // token queries
constexpr int SMEM_O = T * DA * 4;     // attention output
constexpr int SMEM_TOTAL = SMEM_Y + SMEM_Q + SMEM_P + SMEM_V + SMEM_q + SMEM_O;

__global__ void __launch_bounds__(THREADS)
t2i_probs_kernel(const __nv_bfloat16* __restrict__ q,      // [B, T, DA]
                 const __nv_bfloat16* __restrict__ img0,   // [M, D]
                 const __nv_bfloat16* __restrict__ p1,     // [B, HT, M]
                 const __nv_bfloat16* __restrict__ c1,     // [B, HT, D]
                 const __nv_bfloat16* __restrict__ p2,     // [B, HT, M] (depth 2)
                 const __nv_bfloat16* __restrict__ c2,     // [B, HT, D] (depth 2)
                 const __nv_bfloat16* __restrict__ w_k,    // [D, DA]
                 const __nv_bfloat16* __restrict__ w_v,    // [D, DA]
                 const __nv_bfloat16* __restrict__ pekt,   // [DA, M]
                 const __nv_bfloat16* __restrict__ rows,   // [8, D]
                 const __nv_bfloat16* __restrict__ v_bias, // [DA]
                 __nv_bfloat16* __restrict__ out,          // [B, T, DA]
                 int m, int depth, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sY = reinterpret_cast<float*>(smem);
  float* sQ = reinterpret_cast<float*>(smem + SMEM_Y);
  __nv_bfloat16* sP = reinterpret_cast<__nv_bfloat16*>(smem + SMEM_Y + SMEM_Q);
  float* sV = reinterpret_cast<float*>(smem + SMEM_Y + SMEM_Q + SMEM_P);
  float* sq = reinterpret_cast<float*>(smem + SMEM_Y + SMEM_Q + SMEM_P + SMEM_V);
  float* so = sq + T * DA;

  const int b = blockIdx.x;
  const int h = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float scale = rsqrtf((float)HD);
  load_f32(sq, q + (size_t)b * T * DA, T * DA);
  load_f32(sV, rows, 3 * depth * D);
  __syncthreads();
  project_rows(sQ, sq, w_k);                      // read after the next barrier

  AttnState st;
  attn_init(st);
  for (int m0 = 0; m0 < m; m0 += BM) {
    load_rows_tile(sY, LDY, img0, m0, BM);
    load_p_tile(sP, p1 + (size_t)b * HT * m, m, m0, BM);
    __syncthreads();
    recon_layer(sY, LDY, sP, c1 + (size_t)b * HT * D, sV, eps);
    if (depth == 2) {
      load_p_tile(sP, p2 + (size_t)b * HT * m, m, m0, BM);
      __syncthreads();
      recon_layer(sY, LDY, sP, c2 + (size_t)b * HT * D, sV + 3 * D, eps);
    }
    float s[T];
    head_scores(s, sQ, sY, LDY, h, lane);
    add_pe_term(s, sq, pekt, m, h, m0 + lane);
#pragma unroll
    for (int t = 0; t < T; ++t) s[t] *= scale;
    attn_tile(st, s, sY, LDY);
    __syncthreads();                              // the tile is reloaded
  }
  attn_store(st, sQ, h);                          // sQ is free: all scores done
  __syncthreads();
  attn_out(so, sQ, w_v, v_bias);
  __syncthreads();
  for (int i = threadIdx.x; i < T * DA; i += THREADS)
    out[(size_t)b * T * DA + i] = __float2bfloat16(so[i]);
}

}  // namespace

extern "C" int rat_t2i_probs(const void* q, const void* img0, const void* p1, const void* c1,
                             const void* p2, const void* c2, const void* w_k, const void* w_v,
                             const void* pekt, const void* rows, const void* v_bias, void* out,
                             int b, int m, int depth, float eps, void* stream) {
  if (b < 1 || m < BM || m % BM != 0 || (depth != 1 && depth != 2) ||
      (depth == 2 && (p2 == nullptr || c2 == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      t2i_probs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_TOTAL);
  if (err != cudaSuccess) return (int)err;
  typedef const __nv_bfloat16* P;
  t2i_probs_kernel<<<b, THREADS, SMEM_TOTAL, static_cast<cudaStream_t>(stream)>>>(
      static_cast<P>(q), static_cast<P>(img0), static_cast<P>(p1), static_cast<P>(c1),
      static_cast<P>(p2), static_cast<P>(c2), static_cast<P>(w_k), static_cast<P>(w_v),
      static_cast<P>(pekt), static_cast<P>(rows), static_cast<P>(v_bias),
      static_cast<__nv_bfloat16*>(out), m, depth, eps);
  return (int)cudaGetLastError();
}
