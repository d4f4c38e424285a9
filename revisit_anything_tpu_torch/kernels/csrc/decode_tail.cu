// The fused SAM decode tail: one prompt's image -> token probabilities,
// layer-2 token -> image attention, token MLP, layer-2 image -> token
// update and final attention in one kernel, with the per-prompt image
// branch rebuilt tile by tile and never stored, except as the emission.
//
// Replaces: revisit_anything_tpu/ops/decode_fused.py `_tail_call` /
// `_tail_kernel` (pallas_call at :417, body :166-341 without the logits
// branch), reached through `decode_tail_fused` (:429) with emit_keys
// True (keys mode) or False (probability mode). Per prompt:
//   P1 = softmax_t(k1 . q1s / 4); keys1 = LN(img0 + P1^T C1 + b1)
//   q = queries + attn(t2i-2 over keys1); LN; MLP 256 -> 2048 -> 256; LN
//   k2, v2 = token projections; C2[h*7+t] = v2[t, h] Wout2[h]
//   P2 = softmax_t(k2 . (keys1 Wq2 + peq2) / 4); keys2 = LN(keys1 + P2^T C2 + b2)
//   q = LN_final(q + attn(final over keys2))
// keys mode writes keys2 [M, D] bf16; probability mode writes P1, P2
// [HT, M] bf16 and C2 [HT, D]; both write the token state [7, D].
//
// What bounds it on the H100: the FMA units. A prompt needs about
// 1.0 GFLOP (P1 59 MFLOP as the TPU counts it with its block-diagonal
// keys, the 7.3 MFLOP of real head products here; two rebuilds of keys1
// and one of keys2 at 117 MFLOP each; P2 117 + 7 MFLOP; two attentions
// of 2 x 117 MFLOP each, at 56 token rows), about 1 TFLOP at 1024
// prompts, all f32 as in the JAX kernel (keys1 and keys2 are f32 there
// and are multiplied as f32 here: no tensor cores, no bf16 rounding of
// the branch). Keys mode must also write 2.15 GB (0.64 ms at 3.35 TB/s).
//
// Design: the TPU holds one prompt's whole f32 branch [256, 4096] (4 MB)
// in VMEM; a CTA has 227 KB. So one CTA of 8 warps per prompt walks M in
// 32-position tiles twice:
//   pass A: P1 -> keys1 tile -> layer-2 t2i online-softmax partials;
//   mid-ops on the [7, 256] token state (out-projection, LN, MLP, LN,
//           k2, v2, C2 written to device memory, the query-side matrices);
//   pass B: P1 -> keys1 again (recomputed, bit-identical) -> P2 ->
//           keys2 -> emission -> final-attention partials;
//   then the final out-projection and LayerNorm.
// Scores and attention follow t2i_probs.cu (warp = head, lane =
// position, projections on the query side). Shared memory holds the f32
// tile (33 KB), two [56, 256] f32 query-side matrices (115 KB: pass B
// needs K2 Wq2^T and qf Wk^T at once) and the token state; C1 and C2
// (28 KB a prompt each) are read from L1/L2, the MLP weights (2 x 1 MB
// bf16) from L2 once per prompt. 183 KB: one CTA an SM, 1024 CTAs.

#include "decode_common.cuh"

namespace {

using namespace rat_decode;

constexpr int MAX_MLP = 2048;

struct TailParams {
  const __nv_bfloat16 *img0, *q1st, *peq2t, *pek2t, *pekft, *tok_k1, *c1m, *qin, *tok;
  const __nv_bfloat16 *wq_t2, *bq_t2, *wk_t2, *wv_t2, *vb_t2, *wout_t2, *bout_t2;
  const __nv_bfloat16 *n2_s, *n2_b, *lin1_w, *lin1_b, *lin2_w, *lin2_b, *n3_s, *n3_b;
  const __nv_bfloat16 *wq_i2, *wk_i2, *bk_i2, *wv_i2, *bv_i2, *wout_i2;
  const __nv_bfloat16 *wq_fa, *bq_fa, *wk_fa, *wv_fa, *vb_fa, *wout_fa, *bout_fa;
  const __nv_bfloat16 *nf_s, *nf_b, *rows;
  __nv_bfloat16 *keys2, *p1, *p2, *c2m, *qout;
  int b, m, mlp;
  float eps;
};

constexpr int SMEM_Y = BM * LDY * 4;            // branch tile / token scratch
constexpr int SMEM_Q = HT * D * 4;              // each query-side matrix
constexpr int SMEM_P = HT * BM * 2;
constexpr int SMEM_V = 6 * D * 4;
constexpr int SMEM_ROWS = T * D * 4;            // queries, tokens
constexpr int SMEM_TK = T * DA * 4;             // k1, k2, q (pe-term vector)
constexpr int SMEM_TOTAL =
    SMEM_Y + 2 * SMEM_Q + SMEM_P + SMEM_V + 2 * SMEM_ROWS + 3 * SMEM_TK;
static_assert(T * MAX_MLP * 4 <= SMEM_Q, "the MLP hidden rows fit a matrix slot");
static_assert(3 * T * D + 2 * T * DA <= BM * LDY, "token scratch fits the tile");

// P1 of the calling thread's (head, position) into the P tile (and the
// emission), from k1 (shared) and q1s (global).
__device__ __forceinline__ void p1_tile(__nv_bfloat16* sP, const float* sK1,
                                        const TailParams& pr, int b, int m0, bool emit) {
  const int h = threadIdx.x / 32, lane = threadIdx.x % 32;
  float s[T];
#pragma unroll
  for (int t = 0; t < T; ++t) s[t] = 0.f;
  add_pe_term(s, sK1, pr.q1st, pr.m, h, m0 + lane);
  const float scale = rsqrtf((float)HD);
#pragma unroll
  for (int t = 0; t < T; ++t) s[t] *= scale;
  softmax_tokens(s);
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const __nv_bfloat16 v = __float2bfloat16(s[t]);
    sP[(h * T + t) * BM + lane] = v;
    if (emit) pr.p1[((size_t)b * HT + h * T + t) * pr.m + m0 + lane] = v;
  }
}

// keys1 of tile m0 into sY: img0 + P1 (recomputed) -> one update.
__device__ __forceinline__ void keys1_tile(float* sY, __nv_bfloat16* sP, const float* sK1,
                                           const float* sV, const TailParams& pr, int b,
                                           int m0, bool emit_p1) {
  load_rows_tile(sY, LDY, pr.img0, m0, BM);
  p1_tile(sP, sK1, pr, b, m0, emit_p1);
  __syncthreads();
  recon_layer(sY, LDY, sP, pr.c1m + (size_t)b * HT * D, sV, pr.eps);
}

// Scores of the tile against a query-side matrix plus a pe term, scaled.
__device__ __forceinline__ void tile_scores(float s[T], const float* sQ, const float* sY,
                                            const float* sq, const __nv_bfloat16* pet,
                                            int m, int m0) {
  const int h = threadIdx.x / 32, lane = threadIdx.x % 32;
  head_scores(s, sQ, sY, LDY, h, lane);
  add_pe_term(s, sq, pet, m, h, m0 + lane);
  const float scale = rsqrtf((float)HD);
#pragma unroll
  for (int t = 0; t < T; ++t) s[t] *= scale;
}

__global__ void __launch_bounds__(THREADS, 1) decode_tail_kernel(const TailParams pr) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sY = reinterpret_cast<float*>(smem);
  float* sQa = reinterpret_cast<float*>(smem + SMEM_Y);
  float* sQb = reinterpret_cast<float*>(smem + SMEM_Y + SMEM_Q);
  __nv_bfloat16* sP = reinterpret_cast<__nv_bfloat16*>(smem + SMEM_Y + 2 * SMEM_Q);
  float* sV = reinterpret_cast<float*>(smem + SMEM_Y + 2 * SMEM_Q + SMEM_P);
  float* sQin = sV + 6 * D;       // token state [T][D]
  float* sTok = sQin + T * D;     // prompt tokens [T][D]
  float* sK1 = sTok + T * D;      // layer-1 i2t token keys [T][DA]
  float* sK2 = sK1 + T * DA;      // layer-2 i2t token keys [T][DA]
  float* sq = sK2 + T * DA;       // the current attention's token queries
  // token scratch inside the (then idle) branch tile
  float* xa = sY;                 // [T][D]
  float* xb = xa + T * D;         // [T][D]
  float* xc = xb + T * D;         // [T][D]
  float* xo = xc + T * D;         // [T][DA]
  float* xv = xo + T * DA;        // [T][DA]

  const int b = blockIdx.x;
  const int h = threadIdx.x / 32;
  const int m = pr.m;
  const bool keys_mode = pr.keys2 != nullptr;

  load_f32(sV, pr.rows, 6 * D);
  load_f32(sQin, pr.qin + (size_t)b * T * D, T * D);
  load_f32(sTok, pr.tok + (size_t)b * T * D, T * D);
  load_f32(sK1, pr.tok_k1 + (size_t)b * T * DA, T * DA);
  __syncthreads();

  // layer-2 t2i queries and their query-side matrix
  add_rows(xa, sQin, sTok, T * D);
  __syncthreads();
  dense_rows(sq, xa, D, pr.wq_t2, pr.bq_t2, DA, false);
  __syncthreads();
  project_rows(sQa, sq, pr.wk_t2);
  __syncthreads();

  // ---- pass A: P1 -> keys1 -> layer-2 t2i partials ----
  AttnState st;
  attn_init(st);
  for (int m0 = 0; m0 < m; m0 += BM) {
    keys1_tile(sY, sP, sK1, sV, pr, b, m0, false);
    float s[T];
    tile_scores(s, sQa, sY, sq, pr.pek2t, m, m0);
    attn_tile(st, s, sY, LDY);
    __syncthreads();
  }
  attn_store(st, sQa, h);
  __syncthreads();

  // ---- token mid-ops ----
  attn_out(xo, sQa, pr.wv_t2, pr.vb_t2);                       // attn [T][DA]
  __syncthreads();
  dense_rows(xb, xo, DA, pr.wout_t2, pr.bout_t2, D, false);
  __syncthreads();
  add_rows(xa, sQin, xb, T * D);
  __syncthreads();
  ln_rows(sQin, xa, pr.n2_s, pr.n2_b, pr.eps);                 // queries
  __syncthreads();
  dense_rows(sQb, sQin, D, pr.lin1_w, pr.lin1_b, pr.mlp, true); // hidden
  __syncthreads();
  dense_rows(xb, sQb, pr.mlp, pr.lin2_w, pr.lin2_b, D, false);
  __syncthreads();
  add_rows(xa, sQin, xb, T * D);
  __syncthreads();
  ln_rows(sQin, xa, pr.n3_s, pr.n3_b, pr.eps);
  __syncthreads();
  add_rows(xa, sQin, sTok, T * D);                             // queries + tokens
  __syncthreads();
  dense_rows(sK2, xa, D, pr.wk_i2, pr.bk_i2, DA, false);       // k2
  dense_rows(xv, sQin, D, pr.wv_i2, pr.bv_i2, DA, false);      // v2
  dense_rows(sq, xa, D, pr.wq_fa, pr.bq_fa, DA, false);        // final queries
  __syncthreads();
  project_rows(sQa, sK2, pr.wq_i2);                            // k2 Wq2^T
  project_rows(sQb, sq, pr.wk_fa);                             // qf Wk^T
  // C2[h*T + t][d] = bf16(v2[t, h] . Wout2[h rows, d])
  {
    const int d = threadIdx.x;
    for (int hh = 0; hh < H; ++hh) {
      float w[HD];
#pragma unroll
      for (int j = 0; j < HD; ++j)
        w[j] = __bfloat162float(pr.wout_i2[(size_t)(hh * HD + j) * D + d]);
#pragma unroll
      for (int t = 0; t < T; ++t) {
        float a = 0.f;
#pragma unroll
        for (int j = 0; j < HD; ++j) a = fmaf(xv[t * DA + hh * HD + j], w[j], a);
        pr.c2m[((size_t)b * HT + hh * T + t) * D + d] = __float2bfloat16(a);
      }
    }
  }
  __syncthreads();                     // C2 (device memory) visible to the CTA

  // ---- pass B: P1 -> keys1 -> P2 -> keys2 -> emission, final partials ----
  attn_init(st);
  const __nv_bfloat16* c2 = pr.c2m + (size_t)b * HT * D;
  for (int m0 = 0; m0 < m; m0 += BM) {
    keys1_tile(sY, sP, sK1, sV, pr, b, m0, !keys_mode);
    {
      float s[T];
      tile_scores(s, sQa, sY, sK2, pr.peq2t, m, m0);
      softmax_tokens(s);
      const int lane = threadIdx.x % 32;
#pragma unroll
      for (int t = 0; t < T; ++t) {
        const __nv_bfloat16 v = __float2bfloat16(s[t]);
        sP[(h * T + t) * BM + lane] = v;
        if (!keys_mode) pr.p2[((size_t)b * HT + h * T + t) * m + m0 + lane] = v;
      }
    }
    __syncthreads();
    recon_layer(sY, LDY, sP, c2, sV + 3 * D, pr.eps);          // keys2
    if (keys_mode) {
      for (int i = threadIdx.x; i < BM * D; i += THREADS) {
        const int r = i / D, c = i % D;
        pr.keys2[((size_t)b * m + m0 + r) * D + c] = __float2bfloat16(sY[r * LDY + c]);
      }
    }
    float s[T];
    tile_scores(s, sQb, sY, sq, pr.pekft, m, m0);
    attn_tile(st, s, sY, LDY);
    __syncthreads();
  }
  attn_store(st, sQa, h);
  __syncthreads();

  // ---- final out-projection and LayerNorm ----
  attn_out(xo, sQa, pr.wv_fa, pr.vb_fa);
  __syncthreads();
  dense_rows(xb, xo, DA, pr.wout_fa, pr.bout_fa, D, false);
  __syncthreads();
  add_rows(xa, sQin, xb, T * D);
  __syncthreads();
  ln_rows(xc, xa, pr.nf_s, pr.nf_b, pr.eps);
  __syncthreads();
  for (int i = threadIdx.x; i < T * D; i += THREADS)
    pr.qout[(size_t)b * T * D + i] = __float2bfloat16(xc[i]);
}

}  // namespace

extern "C" int rat_decode_tail(const void* params, void* stream) {
  const TailParams& pr = *static_cast<const TailParams*>(params);
  const bool keys_mode = pr.keys2 != nullptr;
  if (pr.b < 1 || pr.m < BM || pr.m % BM != 0 || pr.mlp < 1 || pr.mlp > MAX_MLP ||
      pr.c2m == nullptr || pr.qout == nullptr ||
      (!keys_mode && (pr.p1 == nullptr || pr.p2 == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      decode_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_TOTAL);
  if (err != cudaSuccess) return (int)err;
  decode_tail_kernel<<<pr.b, THREADS, SMEM_TOTAL, static_cast<cudaStream_t>(stream)>>>(pr);
  return (int)cudaGetLastError();
}
