// The fused SAM decode tail: one prompt's image -> token probabilities,
// layer-2 token -> image attention, token MLP, layer-2 image -> token
// update and final attention in one kernel, with the per-prompt image
// branch rebuilt tile by tile and never stored, except as the emission.
//
// Replaces: revisit_anything_tpu/ops/decode_fused.py `_tail_call` /
// `_tail_kernel` (pallas_call at :417, body :166-341), reached through
// `decode_tail_fused` (:429) with emit_keys True (keys mode), False
// (probability mode) or with `mask_head` (logits mode, entry
// rat_decode_tail_logits). Per prompt:
//   P1 = softmax_t(k1 . q1s / 4); keys1 = LN(img0 + P1^T C1 + b1)
//   q = queries + attn(t2i-2 over keys1); LN; MLP 256 -> 2048 -> 256; LN
//   k2, v2 = token projections; C2[h*7+t] = v2[t, h] Wout2[h]
//   P2 = softmax_t(k2 . (keys1 Wq2 + peq2) / 4); keys2 = LN(keys1 + P2^T C2 + b2)
//   q = LN_final(q + attn(final over keys2))
// keys mode writes keys2 [M, D] bf16; probability mode writes P1, P2
// [HT, M] bf16 and C2 [HT, D]; logits mode writes the mask logits
// [content, 16, 3] bf16 in the block layout of mask_head.cu; all three
// write the token state [7, D].
//
// This note is the bf16 form's; the f32 form (an f32 SAM: the three
// modes, entries rat_decode_tail_f32 (keys and probability modes) /
// rat_decode_tail_logits_f32) is a sequence of walks and token kernels,
// described where it starts below.
//
// One kernel, decode_tail_kernel<E>, serves the three modes; E picks what
// it emits (KEYS keys2, PROBS P1 / P2 / C2, ROWS keys2's first rows and
// the hypernetwork rows for K3). What bounds it: a prompt needs about 1.0
// GFLOP (two rebuilds of keys1 and one of keys2, the P2 scores and two
// attentions over the f32 branch, 117 MFLOP each at 56 token rows), about
// 1 TFLOP at 1024 prompts; keys mode must also write 2.15 GB (0.64 ms at
// 3.35 TB/s).
//
// Design: the TPU holds one prompt's whole f32 branch [256, 4096] (4 MB)
// in VMEM; a CTA has 227 KB. So one CTA of 8 warps per prompt walks M in
// 32-position tiles twice:
//   pass A: P1 -> keys1 tile -> layer-2 t2i online-softmax partials;
//   mid-ops on the [7, 256] token state (out-projection, LN, MLP, LN,
//           k2, v2, C2, the query-side matrices);
//   pass B: P1 -> keys1 again (recomputed, bit-identical) -> P2 ->
//           keys2 -> emission -> final-attention partials;
//   then the final out-projection and LayerNorm.
// The three families of per-tile products run on the tensor cores by
// mma.sync (decode_tc.cuh): the rebuilds in bf16 (exact products, the f32
// branch kept in registers as their residual), the scores Q^ . Y^T and
// the online-softmax context p . Y as three fp16 products of hi/lo planes
// of their f32 operands times a power of two (22 bits of each). P1, P2,
// the pe terms, the softmaxes, the branch LayerNorms (on the
// accumulators) and every token-side op stay on the FMA units; keys2
// leaves from registers by 16-byte stores, P1 and P2 from the values the
// P tile holds.
// Precision: at 1024 prompts x M 4096 (H100, chip_smoke.py) the keys
// mode's max relative error against decode_tail_reference is 5.9e-3 for
// the token state and 5.3e-3 for keys2 (tolerance 2e-2). Against the
// plain f32 version it moves 4.9% of the token state's bf16 elements and
// 6.3% of keys2's, the FMA design it replaced 5.9% and 7.5%, the plain
// version with TF32 matmuls 31% and 34% (kernels/tail_variants.py
// [precision]). TF32 and bf16 planes were tried first; both, with the
// context summed over the tiles inside the mma accumulators (decode_tc.cuh:
// those additions do not round to nearest), moved ~20% and one of a
// served query's 128 kept masks; this kernel serves the plain version's
// cut exactly (chip_smoke.py [witness]). The probability mode's P1 is the
// plain version's bit for bit (no branch product in it); P2 moves 4.0%
// and C2 3.3% of their bf16 elements.
// What bounds it: not a peak. A tile of pass B takes 21.0k cycles an SM
// (kernels/tail_variants.py [phases], H100 at 1980 MHz): the two rebuilds
// 6.6k (their LayerNorm epilogues and keys2's copy-out more than their
// 32 mma.sync a warp), the two score products 4.7k, the context 1.7k,
// the FMA phases (P1, P2, the pe terms, the softmaxes) 6.0k, loads 1.1k;
// each phase is short of independent work for 8 warps between 21 CTA
// barriers a tile pair.
// Shared memory: the branch planes (hi, lo: 32 KB, also the token
// scratch), the two query-side matrices (hi, lo: 112 KB; the MLP's hidden
// rows, the contexts and the hypernetwork's hidden rows borrow them), C1
// and C2 staged once a prompt (56 KB), S / p (7 KB), P, the token state,
// vectors, branch constants and the planes' scales: 231,488 B, one CTA an
// SM.
//
// Logits mode (entry rat_decode_tail_logits): the mask head needs keys2
// and the hypernetwork rows, and the latter come from the token state
// after the FINAL attention, which exists only once pass B has walked all
// of M; a prompt's keys2 (2 MB bf16) fits no CTA. So the ROWS emission
// stores keys2 for every tile below `content` (rounded to bf16 exactly
// where the keys mode rounds its emission; the JAX logits mode rounds
// there too, decode_fused.py:336) into rows [B, content rounded up to 32,
// D], and after the final LayerNorm runs the three hypernetwork MLPs of
// mask tokens 1..3 on the FMA units from the f32 token state into hyper
// [B, 3, D/8]. The entry then launches K3 (mask_head.cu rat_mask_head, TMA
// + wgmma) on rows and hyper on the same stream. Fusing K3 into the tail
// would save no bytes (keys2's rows go through device memory either way:
// a slot a CTA, 132 x 1.6 MB, exceeds the 50 MB L2) and would tie K3's
// TMA ring to the tail's shared-memory layout. Rows cost 1.64 GB written
// and read at 1024 prompts x content 3136.

#include "decode_common.cuh"
#include "decode_tc.cuh"

// mask_head.cu (K3, K3 f32)
extern "C" int rat_mask_head(const void* keys, const void* up1_w, const void* up1_b,
                             const void* ln_s, const void* ln_b, const void* up2_w,
                             const void* up2_b, const void* hyper, void* out, int np_, int gg,
                             int content, int n_masks, float eps, int n_ctas, void* stream);
extern "C" int rat_mask_head_f32(const void* keys, const void* up1_w, const void* up1_b,
                                 const void* ln_s, const void* ln_b, const void* up2_w,
                                 const void* up2_b, const void* hyper, void* out, void* scratch,
                                 int np_, int gg, int content, int n_masks, float eps,
                                 void* stream);
// i2t_probs.cu (B7 f32) and t2i_probs.cu (B8 f32): the f32 form's walks
extern "C" int rat_i2t_probs_f32(const void* q1st, const void* tok_k, const void* img0,
                                 const void* p1, const void* c1, const void* peq2t,
                                 const void* w_q, const void* rows, void* out, int b, int m,
                                 int layer, float eps, void* stream);
extern "C" int rat_t2i_probs_f32(const void* q, const void* img0, const void* p1,
                                 const void* c1, const void* p2, const void* c2, const void* w_k,
                                 const void* w_v, const void* pekt, const void* rows,
                                 const void* v_bias, void* out, int b, int m, int depth,
                                 float eps, void* stream);
extern "C" int rat_t2i_probs_f32_keys(const void* q, const void* img0, const void* p1,
                                      const void* c1, const void* p2, const void* c2,
                                      const void* w_k, const void* w_v, const void* pekt,
                                      const void* rows, const void* v_bias, void* out, void* keys,
                                      int b, int m, int klimit, float eps, void* stream);

namespace {

using namespace rat_decode;
using namespace rat_decode_tc;

constexpr int MAX_MLP = 2048;

struct TailParams {
  const __nv_bfloat16 *img0, *q1st, *peq2t, *pek2t, *pekft, *tok_k1, *c1m, *qin, *tok;
  const __nv_bfloat16 *wq_t2, *bq_t2, *wk_t2, *wv_t2, *vb_t2, *wout_t2, *bout_t2;
  const __nv_bfloat16 *n2_s, *n2_b, *lin1_w, *lin1_b, *lin2_w, *lin2_b, *n3_s, *n3_b;
  const __nv_bfloat16 *wq_i2, *wk_i2, *bk_i2, *wv_i2, *bv_i2, *wout_i2;
  const __nv_bfloat16 *wq_fa, *bq_fa, *wk_fa, *wv_fa, *vb_fa, *wout_fa, *bout_fa;
  const __nv_bfloat16 *nf_s, *nf_b, *rows;
  __nv_bfloat16 *keys2, *p1, *p2, *c2m, *qout;
  // logits mode: the mask head's weights, the three hypernetwork MLPs of
  // mask tokens 1..3 stacked ([3, D, D], [3, D], [3, D, D], [3, D],
  // [3, D, HYPER], [3, HYPER]), keys2's rows [b, content rounded up to 32,
  // D], the hypernetwork rows [b, 3, HYPER] and the logits [b, content,
  // 16, 3]; K3 runs on `ctas` CTAs
  const __nv_bfloat16 *up1_w, *up1_b, *ln_s, *ln_b, *up2_w, *up2_b;
  const __nv_bfloat16 *hw1, *hb1, *hw2, *hb2, *hw3, *hb3;
  __nv_bfloat16 *krows, *hyper, *logits;
  // the f32 form's scratch: `work` (the token rows between its walks,
  // and P1, P2 and C2 but in probability mode, which writes them to the
  // outputs: rat_decode_tail_f32_scratch(m) / _probs_scratch() bytes a
  // prompt) and, in logits mode, K3 f32's weight planes
  // (rat_mask_head_f32_scratch() floats); the bf16 kernel reads neither
  void *work, *mh_scratch;
  int b, m, mlp, content, ctas;
  float eps;
};

// The emissions of decode_tail_kernel<E>.
constexpr int KEYS = 0;    // keys2 [b, M, D]
constexpr int PROBS = 1;   // P1, P2 [b, HT, M], C2 [b, HT, D]
constexpr int ROWS = 2;    // keys2's rows below content, hypernetwork rows

constexpr int N_MASKS = 3;          // multimask tokens 1..3
constexpr int HYPER = D / 8;        // hypernetwork output width

// Shared memory (bytes). The token vectors k1, k2 and q and the branch
// constants are bf16 values and are kept as bf16; the prompt tokens are
// read again where they are added. The f32 branch itself lives in
// registers (decode_tc.cuh Frag).
constexpr int OFF_Y = 0;                           // branch planes hi, lo / token scratch
constexpr int OFF_QA = OFF_Y + BM * D * 4;         // query-side matrices' planes hi, lo
constexpr int OFF_QB = OFF_QA + HT * D * 4;
constexpr int OFF_C1 = OFF_QB + HT * D * 4;        // C1, C2 bf16
constexpr int OFF_C2 = OFF_C1 + HT * D * 2;
constexpr int OFF_S = OFF_C2 + HT * D * 2;         // S / p hi, lo; the LN's row sums
constexpr int OFF_P = OFF_S + HT * BM * 4;         // P1 / P2 bf16
constexpr int OFF_QIN = OFF_P + HT * BM * 2;       // token state [T][D] f32
constexpr int OFF_V = OFF_QIN + T * D * 4;         // branch constants [6][D] bf16
constexpr int OFF_K1 = OFF_V + 6 * D * 2;          // k1, k2, q [T][DA] bf16
constexpr int OFF_K2 = OFF_K1 + T * DA * 2;
constexpr int OFF_Q = OFF_K2 + T * DA * 2;
constexpr int OFF_ALPHA = OFF_Q + T * DA * 2;      // rescale / 1 / sum [HT]
constexpr int OFF_SC = OFF_ALPHA + 64 * 4;         // planes' s: Y1, Y2, QA, QB; scratch [8]
constexpr int SMEM = OFF_SC + 16 * 4;
static_assert(SMEM == 231488 && SMEM <= 232448, "one CTA an SM");
static_assert(T * MAX_MLP * 4 <= HT * D * 4, "the MLP hidden rows fit a matrix slot");
static_assert(3 * T * D + 2 * T * DA <= BM * D, "token scratch fits the tile");
static_assert(BM * WARPS * 8 <= HT * BM * 4, "the LN's row sums fit S");
static_assert(2 * N_MASKS * D * 4 <= HT * D * 4, "the hypernetwork's hidden rows fit a matrix slot");

__device__ __forceinline__ void copy_bf16(__nv_bfloat16* dst, const __nv_bfloat16* src, int n) {
  for (int i = threadIdx.x; i < n / 8; i += THREADS)
    reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
}

__device__ __forceinline__ void to_bf16(__nv_bfloat16* dst, const float* src, int n) {
  for (int i = threadIdx.x; i < n; i += THREADS) dst[i] = __float2bfloat16(src[i]);
}

// P1 of the calling thread's (head, position) into the P tile, from its
// column of q1st^T; also to out ([HT][m] bf16, the tile's first column)
// when it is given.
__device__ __forceinline__ void p1_tile(__nv_bfloat16* sP, const __nv_bfloat16* sK1,
                                        const PeCol& q1s, __nv_bfloat16* out, int m) {
  float s[T];
#pragma unroll
  for (int t = 0; t < T; ++t) s[t] = 0.f;
  add_pe_term_bf(s, sK1, q1s);
  const float scale = rsqrtf((float)HD);
#pragma unroll
  for (int t = 0; t < T; ++t) s[t] *= scale;
  softmax_tokens(s);
  store_p(sP, s);
  if (out) emit_p(out, m, s);
}

// One layer of the three hypernetwork MLPs: out[i][n] = bf16(bf16(x[i] .
// W[i][:, n]) + b[i][n]) for mask token i, relu'd but for the last layer
// (the JAX `_dense_rows` rounding; on an f32 SAM's f32 W and b nothing
// rounds). x rows have stride ldx, out rows stride N; W [3][K][N], b
// [3][N] bf16 or f32 (global).
template <typename WT>
__device__ __forceinline__ void hyper_layer(float* out, const float* x, int ldx, int K,
                                            const WT* W, const WT* bias, int N, bool relu) {
  for (int o = threadIdx.x; o < N_MASKS * N; o += THREADS) {
    const int i = o / N, n = o % N;
    const WT* w = W + (size_t)i * K * N + n;
    float acc = 0.f;
#pragma unroll 8
    for (int k = 0; k < K; ++k) acc = fmaf(x[i * ldx + k], ldw(w + (size_t)k * N), acc);
    out[o] = dense_out(acc, bias + i * N, n, relu);
  }
}

template <int E>
__global__ void __launch_bounds__(THREADS, 1) decode_tail_kernel(const TailParams pr) {
  extern __shared__ __align__(128) unsigned char smem[];
  __half* sYh = reinterpret_cast<__half*>(smem + OFF_Y);
  __half* sYl = sYh + BM * D;
  __half* sQah = reinterpret_cast<__half*>(smem + OFF_QA);
  __half* sQal = sQah + HT * D;
  __half* sQbh = reinterpret_cast<__half*>(smem + OFF_QB);
  __half* sQbl = sQbh + HT * D;
  float* sQa = reinterpret_cast<float*>(smem + OFF_QA);   // the context [HT][D]
  float* sQb = reinterpret_cast<float*>(smem + OFF_QB);   // the MLP's hidden rows
  __nv_bfloat16* sC1 = reinterpret_cast<__nv_bfloat16*>(smem + OFF_C1);
  __nv_bfloat16* sC2 = reinterpret_cast<__nv_bfloat16*>(smem + OFF_C2);
  float* sS = reinterpret_cast<float*>(smem + OFF_S);
  __half* sPh = reinterpret_cast<__half*>(smem + OFF_S);
  __half* sPl = sPh + HT * BM;
  float2* red = reinterpret_cast<float2*>(smem + OFF_S);
  __nv_bfloat16* sP = reinterpret_cast<__nv_bfloat16*>(smem + OFF_P);
  float* sQin = reinterpret_cast<float*>(smem + OFF_QIN);
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(smem + OFF_V);
  __nv_bfloat16* sK1 = reinterpret_cast<__nv_bfloat16*>(smem + OFF_K1);
  __nv_bfloat16* sK2 = reinterpret_cast<__nv_bfloat16*>(smem + OFF_K2);
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem + OFF_Q);
  float* alpha = reinterpret_cast<float*>(smem + OFF_ALPHA);
  float* sSc = reinterpret_cast<float*>(smem + OFF_SC);    // Y1, Y2, QA, QB s
  float* scratch = sSc + 8;
  // token scratch inside the (then idle) branch tile
  float* xa = reinterpret_cast<float*>(smem + OFF_Y);   // [T][D]
  float* xb = xa + T * D;         // [T][D]
  float* xc = xb + T * D;         // [T][D]
  float* xo = xc + T * D;         // [T][DA]
  float* xv = xo + T * DA;        // [T][DA]

  const int b = blockIdx.x;
  const int m = pr.m;
  const int lane = threadIdx.x % 32;
  const __nv_bfloat16* tok = pr.tok + (size_t)b * T * D;
  // keys2's rows leave to kout below klimit; P1 and P2 to p1out, p2out
  const int klimit = E == KEYS ? m : E == ROWS ? pr.content : 0;
  __nv_bfloat16* kout = E == KEYS   ? pr.keys2 + (size_t)b * m * D
                        : E == ROWS ? pr.krows + (size_t)b * ((pr.content + BM - 1) / BM * BM) * D
                                    : nullptr;
  __nv_bfloat16* p1out = E == PROBS ? pr.p1 + (size_t)b * HT * m : nullptr;
  __nv_bfloat16* p2out = E == PROBS ? pr.p2 + (size_t)b * HT * m : nullptr;

  copy_bf16(sV, pr.rows, 6 * D);
  copy_bf16(sK1, pr.tok_k1 + (size_t)b * T * DA, T * DA);
  stage_c(sC1, pr.c1m + (size_t)b * HT * D);
  load_f32(sQin, pr.qin + (size_t)b * T * D, T * D);
  load_f32(xb, tok, T * D);
  __syncthreads();
  branch_scales(sSc, scratch, sV);

  // layer-2 t2i queries and their query-side matrix
  add_rows(xa, sQin, xb, T * D);
  __syncthreads();
  dense_rows_k4(xo, xa, D, pr.wq_t2, pr.bq_t2, DA, false);
  __syncthreads();
  to_bf16(sq, xo, T * DA);
  project_rows_tc(sQah, sQal, sSc + 2, scratch, xo, pr.wk_t2);
  __syncthreads();

  // ---- pass A: P1 -> keys1 -> layer-2 t2i partials ----
  Online st;
  Ctx ctx;
  Frag y;                                      // the f32 branch tile
  online_init(st);
  context_init(ctx);
  const float ys1 = sSc[0], ys2 = sSc[1];       // the planes' s
  const float unscale_t2 = 1.f / (sSc[2] * ys1);
  for (int m0 = 0; m0 < m; m0 += BM) {
    PeCol pe;                                  // each asked for a phase ahead
    ImgFrag img;
    load_pe(pe, pr.q1st, m, m0 + lane);
    load_img0(img, pr.img0, m0);
    p1_tile(sP, sK1, pe, nullptr, m);
    __syncthreads();
    load_pe(pe, pr.pek2t, m, m0 + lane);
    rebuild_tc<true>(y, img, sYh, sYl, sP, sC1, sV, red, pr.eps, ys1, nullptr);  // keys1
    scores_tc(sS, sQah, sQal, sYh, sYl);
    __syncthreads();
    float s[T];
    head_scores_tc(s, sS, sq, pe, unscale_t2);
    __syncthreads();                                           // S read: p replaces it
    online_tile(st, s, sPh, sPl, alpha);
    __syncthreads();
    context_tc(ctx, sPh, sPl, alpha, sYh, sYl);
    __syncthreads();
  }
  online_finish(st, alpha);
  __syncthreads();
  context_store(ctx, alpha, 1.f / (P_SCALE * ys1), sQa);
  __syncthreads();

  // ---- token mid-ops ----
  attn_out(xo, sQa, pr.wv_t2, pr.vb_t2);                       // attn [T][DA]
  __syncthreads();
  dense_rows_k4(xb, xo, DA, pr.wout_t2, pr.bout_t2, D, false);
  __syncthreads();
  add_rows(xa, sQin, xb, T * D);
  __syncthreads();
  ln_rows(sQin, xa, pr.n2_s, pr.n2_b, pr.eps);                 // queries
  __syncthreads();
  dense_rows_n8(sQb, sQin, D, pr.lin1_w, pr.lin1_b, pr.mlp, true); // hidden
  __syncthreads();
  dense_rows_k4(xb, sQb, pr.mlp, pr.lin2_w, pr.lin2_b, D, false);
  __syncthreads();
  add_rows(xa, sQin, xb, T * D);
  __syncthreads();
  ln_rows(sQin, xa, pr.n3_s, pr.n3_b, pr.eps);
  load_f32(xc, tok, T * D);
  __syncthreads();
  add_rows(xa, sQin, xc, T * D);                               // queries + tokens
  __syncthreads();
  dense_rows_k4(xo, xa, D, pr.wk_i2, pr.bk_i2, DA, false);        // k2
  dense_rows_k4(xv, sQin, D, pr.wv_i2, pr.bv_i2, DA, false);      // v2
  dense_rows_k4(xb, xa, D, pr.wq_fa, pr.bq_fa, DA, false);        // final queries
  __syncthreads();
  to_bf16(sK2, xo, T * DA);
  to_bf16(sq, xb, T * DA);
  project_rows_tc(sQah, sQal, sSc + 2, scratch, xo, pr.wq_i2);  // k2 Wq2^T
  project_rows_tc(sQbh, sQbl, sSc + 3, scratch, xb, pr.wk_fa);  // qf Wk^T
  // C2[h*T + t][d] = bf16(v2[t, h] . Wout2[h rows, d]), into C's layout
  // (and, in probability mode, to c2m in row layout)
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
        sC2[wide_idx(hh * T + t, d)] = __float2bfloat16(a);
        if (E == PROBS) pr.c2m[((size_t)b * HT + hh * T + t) * D + d] = __float2bfloat16(a);
      }
    }
  }
  __syncthreads();

  // ---- pass B: P1 -> keys1 -> P2 -> keys2 -> emission, final partials ----
  online_init(st);
  context_init(ctx);
  const float unscale_p2 = 1.f / (sSc[2] * ys1), unscale_fa = 1.f / (sSc[3] * ys2);
  for (int m0 = 0; m0 < m; m0 += BM) {
    PeCol pe;
    ImgFrag img;
    load_pe(pe, pr.q1st, m, m0 + lane);
    load_img0(img, pr.img0, m0);
    p1_tile(sP, sK1, pe, p1out ? p1out + m0 : nullptr, m);   // P1, emitted in probability mode
    __syncthreads();
    load_pe(pe, pr.peq2t, m, m0 + lane);
    rebuild_tc<true>(y, img, sYh, sYl, sP, sC1, sV, red, pr.eps, ys1, nullptr);  // keys1 again
    scores_tc(sS, sQah, sQal, sYh, sYl);
    __syncthreads();
    {
      float s[T];
      head_scores_tc(s, sS, sK2, pe, unscale_p2);
      softmax_tokens(s);
      store_p(sP, s);                                          // P2
      if (p2out) emit_p(p2out + m0, m, s);
    }
    __syncthreads();
    load_pe(pe, pr.pekft, m, m0 + lane);
    rebuild_tc<false>(y, img, sYh, sYl, sP, sC2, sV + 3 * D, red, pr.eps, ys2,
                      m0 < klimit ? kout + (size_t)m0 * D : nullptr);  // keys2, emitted
    scores_tc(sS, sQbh, sQbl, sYh, sYl);
    __syncthreads();
    float s[T];
    head_scores_tc(s, sS, sq, pe, unscale_fa);
    __syncthreads();                                           // S read: p replaces it
    online_tile(st, s, sPh, sPl, alpha);
    __syncthreads();
    context_tc(ctx, sPh, sPl, alpha, sYh, sYl);
    __syncthreads();
  }
  online_finish(st, alpha);
  __syncthreads();
  context_store(ctx, alpha, 1.f / (P_SCALE * ys2), sQa);
  __syncthreads();

  // ---- final out-projection and LayerNorm ----
  attn_out(xo, sQa, pr.wv_fa, pr.vb_fa);
  __syncthreads();
  dense_rows_k4(xb, xo, DA, pr.wout_fa, pr.bout_fa, D, false);
  __syncthreads();
  add_rows(xa, sQin, xb, T * D);
  __syncthreads();
  ln_rows(xc, xa, pr.nf_s, pr.nf_b, pr.eps);
  __syncthreads();
  for (int i = threadIdx.x; i < T * D; i += THREADS)
    pr.qout[(size_t)b * T * D + i] = __float2bfloat16(xc[i]);

  if (E == ROWS) {
    // hypernetwork rows of mask tokens 1..3 from the f32 token state
    // (token rows 2..4: row 0 is the IoU token, row 1 mask token 0); the
    // hidden rows in the first query-side matrix, free after the final
    // attention
    float* h1 = sQa;
    float* h2 = h1 + N_MASKS * D;
    hyper_layer(h1, xc + 2 * D, D, D, pr.hw1, pr.hb1, D, true);
    __syncthreads();
    hyper_layer(h2, h1, D, D, pr.hw2, pr.hb2, D, true);
    __syncthreads();
    hyper_layer(h1, h2, D, D, pr.hw3, pr.hb3, HYPER, false);
    __syncthreads();
    for (int i = threadIdx.x; i < N_MASKS * HYPER; i += THREADS)
      pr.hyper[(size_t)b * N_MASKS * HYPER + i] = __float2bfloat16(h1[i]);
  }
}

// Checks every mode shares: the dense layers' widths (the token MLP's
// hidden width a multiple of 8: dense_rows_n8's 16-byte loads).
bool tail_ok(const TailParams& pr) {
  return pr.b >= 1 && pr.m >= BM && pr.m % BM == 0 && pr.mlp >= 1 && pr.mlp <= MAX_MLP &&
         pr.mlp % 8 == 0 && pr.qout != nullptr;
}

template <int E>
int launch_tail(const TailParams& pr, cudaStream_t st) {
  cudaError_t err =
      cudaFuncSetAttribute(decode_tail_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  decode_tail_kernel<E><<<pr.b, THREADS, SMEM, st>>>(pr);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rat_decode_tail(const void* params, void* stream) {
  const TailParams& pr = *static_cast<const TailParams*>(params);
  const bool keys_mode = pr.keys2 != nullptr;
  if (!tail_ok(pr) || keys_mode == (pr.p1 != nullptr) || (pr.p1 == nullptr) != (pr.p2 == nullptr) ||
      (!keys_mode && pr.c2m == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return keys_mode ? launch_tail<KEYS>(pr, st) : launch_tail<PROBS>(pr, st);
}

// Dynamic shared memory of a tail CTA in bytes (a report, no launch).
extern "C" int rat_decode_tail_smem() { return SMEM; }

// The tail with the ROWS emission, then K3 on its rows and hypernetwork
// rows (content positions, gg = content rounded up to 32, 3 mask tokens),
// on the same stream.
extern "C" int rat_decode_tail_logits(const void* params, void* stream) {
  const TailParams& pr = *static_cast<const TailParams*>(params);
  if (!tail_ok(pr) || pr.keys2 != nullptr || pr.p1 != nullptr || pr.p2 != nullptr ||
      pr.krows == nullptr || pr.hyper == nullptr || pr.logits == nullptr || pr.content < 1 ||
      pr.content > pr.m || pr.ctas < 1)
    return (int)cudaErrorInvalidValue;
  const int err = launch_tail<ROWS>(pr, static_cast<cudaStream_t>(stream));
  if (err != 0) return err;
  const int gg = (pr.content + BM - 1) / BM * BM;
  return rat_mask_head(pr.krows, pr.up1_w, pr.up1_b, pr.ln_s, pr.ln_b, pr.up2_w, pr.up2_b,
                       pr.hyper, pr.logits, pr.b, gg, pr.content, N_MASKS, pr.eps, pr.ctas,
                       stream);
}

// ---------------------------------------------------------------------
// The f32 form (entries rat_decode_tail_f32, keys and probability modes,
// and rat_decode_tail_logits_f32, logits mode; an f32 SAM, the JAX
// package's dtype): the same TPU kernel on f32 inputs. Everything is f32 (img0, the
// pe terms, C1, the token rows, the weights and the branch rows) but P1
// and P2, which the JAX kernel rounds to bf16 at every dtype
// (decode_fused.py :216, :270); nothing else rounds: the token-side dense
// layers, LayerNorms and C2 stay f32 (:85-91, :277 at f32), and keys2
// leaves as f32 (:289). The outputs are f32 but P1 and P2: the token
// state [b, T, D], keys2 [b, M, D] (keys mode), P1, P2 [b, HT, M] bf16 and
// C2 [b, HT, D] f32 (probability mode, :410-415) or keys2's rows below
// content [b, content rounded up to 32, D], the hypernetwork rows [b, 3,
// D/8] and K3 f32's logits [b, content, 16, 3] (logits mode).
//
// Why not one kernel, as in bf16: shared memory. Pass B needs C1, C2 and
// the two query-side matrices in every tile; in f32, C1 and C2 are each
// two fp16 planes (C s = hi + lo, the f32 rebuild of decode_tc.cuh), and
// the four [56, 256] matrices as planes take 229,376 B, 262,144 with the
// branch planes, over the 232,448 B a CTA may have (the bf16 layout's
// 231,488 B grows to 297,280). So the f32 form splits pass B into two
// walks over M, the schedule of the probability-factored decode, each
// B7 f32's or B8 f32's kernel (walk_f32.cuh: two warpgroups on alternate
// 16-position tiles, the branch tile in registers), with the
// token state and P1, P2 and C2 waiting in device memory between them
// (the entry's `work`, rat_decode_tail_f32_scratch(M) bytes a prompt; in
// probability mode P1, P2 and C2 wait in the outputs, and the work holds
// the token rows alone, rat_decode_tail_f32_probs_scratch() bytes):
//
//   launch                          CTA           shared memory (B)
//   token queries (q + tok) Wq_t2   a prompt      7,168 static
//   P1 (B7 f32 layer 1)             16 tiles      3,584 static
//   keys1 -> layer-2 t2i (B8 f32 d1) a prompt     167,424
//   token mid-ops: out-projection,  a prompt      93,184 at MLP 2048
//     LN, MLP, LN, k2, v2, C2, the final queries
//   keys1 -> P2 (B7 f32 layer 2)    a prompt      158,720
//   keys1 -> keys2, stored, ->      a prompt      229,376
//     final attention (B8 f32 d2 with the keys store; probability
//     mode: B8 f32 d2 as it is, keys2 not stored)
//   final out-projection, LN        a prompt      31,232 static
//     (logits mode: the hypernetwork MLPs)
//   logits mode: K3 f32 on keys2's rows (mask_head.cu)
//
// The walks rebuild keys1 three times and keys2 once (bf16 B3: keys1
// twice, keys2 once), each rebuild two fp16 passes (P exact times 2^15
// against C's two planes), each score and context product three (both
// operands two planes), as walk_f32.cuh does; the error bound of the
// rebuild is there. P1 goes through device memory (0.47 GB at 1024
// prompts x M 4096, written once, read three times) as P2 does (written
// once, read once); bf16 B3 recomputes P1 in each pass. The token side
// runs on the FMA units, a prompt a CTA, its weights (5.8 MB in f32) read
// from the L2 by every CTA. What bounds the form: the walks' products at
// the fp16 rate and, in keys mode, keys2's 4.29 GB of f32 stores (1.28 ms
// at 3.35 TB/s at 1024 prompts x M 4096; the probability mode writes P1
// and P2 once instead, 0.94 GB). The whole runs as one counted
// launch on the caller's stream, as the logits entry's tail and K3 do.

namespace {

__host__ __device__ __forceinline__ const float* fp(const void* p) {
  return static_cast<const float*>(p);
}

// The f32 form's work: the layer-2 token -> image queries and attention,
// k2, the final queries and attention [b][T][DA] and the token state
// [b][T][D], f32, then (keys and logits modes) P1, P2 [b][HT][M] bf16 and
// C2 [b][HT][D] f32, one region after another (every region starts at a
// multiple of 16 bytes). The probability mode's P1, P2 and C2 are its
// outputs.
struct Work {
  __nv_bfloat16 *p1, *p2;
  float *c2, *q2, *attn2, *k2, *qf, *attnf, *qs;
};

__host__ __device__ constexpr size_t rows_bytes() {
  return (size_t)5 * T * DA * 4 + (size_t)T * D * 4;
}

__host__ __device__ constexpr size_t work_bytes(int m) {
  return rows_bytes() + (size_t)2 * HT * m * 2 + (size_t)HT * D * 4;
}

Work carve(const TailParams& pr, bool probs) {
  char* p = static_cast<char*>(pr.work);
  auto take = [&](size_t bytes) {
    char* r = p;
    p += (size_t)pr.b * bytes;
    return r;
  };
  Work w;
  w.q2 = reinterpret_cast<float*>(take(T * DA * 4));
  w.attn2 = reinterpret_cast<float*>(take(T * DA * 4));
  w.k2 = reinterpret_cast<float*>(take(T * DA * 4));
  w.qf = reinterpret_cast<float*>(take(T * DA * 4));
  w.attnf = reinterpret_cast<float*>(take(T * DA * 4));
  w.qs = reinterpret_cast<float*>(take(T * D * 4));
  if (probs) {
    w.p1 = pr.p1;
    w.p2 = pr.p2;
    // TailParams declares c2m bf16 (the bf16 form's emission); the f32
    // form's C2 is f32, [b][HT][D], as the JAX kernel's at f32
    w.c2 = reinterpret_cast<float*>(pr.c2m);
  } else {
    w.p1 = reinterpret_cast<__nv_bfloat16*>(take((size_t)HT * pr.m * 2));
    w.p2 = reinterpret_cast<__nv_bfloat16*>(take((size_t)HT * pr.m * 2));
    w.c2 = reinterpret_cast<float*>(take(HT * D * 4));
  }
  return w;
}

// The layer-2 token -> image queries of each prompt: (queries + tokens)
// Wq_t2 + bq_t2 -> q2 [b][T][DA].
__global__ void __launch_bounds__(THREADS) tail_queries_f32_kernel(const TailParams pr, float* q2) {
  __shared__ __align__(16) float x[T * D];
  const size_t o = (size_t)blockIdx.x * T * D;
  const float *qin = fp(pr.qin) + o, *tok = fp(pr.tok) + o;
  for (int i = threadIdx.x; i < T * D; i += THREADS) x[i] = qin[i] + tok[i];
  __syncthreads();
  dense_rows_k4(q2 + (size_t)blockIdx.x * T * DA, x, D, fp(pr.wq_t2), fp(pr.bq_t2), DA, false);
}

// Shared memory of tail_mid_f32_kernel (bytes): the token state, its sum
// with the tokens, a dense layer's output and the tokens [T][D]; the
// attention and v2 [T][DA]; the MLP's hidden rows [T][mlp]; f32.
__host__ __device__ constexpr int mid_smem(int mlp) {
  return (4 * T * D + 2 * T * DA + T * mlp) * 4;
}
static_assert(mid_smem(MAX_MLP) == 93184 && mid_smem(MAX_MLP) <= 232448, "the byte count above");

// The token side between the two walks, for each prompt: the layer-2
// token -> image out-projection, LN, MLP, LN (the token state, to qs),
// then k2 = (q + tok) Wk_i2 + bk_i2, v2 = q Wv_i2 + bv_i2 and the final
// queries (q + tok) Wq_fa + bq_fa, and C2[h*T + t][d] = v2[t, h] .
// Wout_i2[h rows, d]; all f32, unrounded.
__global__ void __launch_bounds__(THREADS) tail_mid_f32_kernel(const TailParams pr,
                                                               const float* attn, float* qs,
                                                               float* k2, float* qf, float* c2) {
  extern __shared__ __align__(16) float sm[];
  float* q = sm;                 // the token state [T][D]
  float* xa = q + T * D;         // [T][D]
  float* xb = xa + T * D;        // [T][D]
  float* tk = xb + T * D;        // the tokens [T][D]
  float* sa = tk + T * D;        // the attention [T][DA]
  float* v2 = sa + T * DA;       // [T][DA]
  float* hid = v2 + T * DA;      // the MLP's hidden rows [T][mlp]
  const int b = blockIdx.x;
  const size_t ot = (size_t)b * T * D, oa = (size_t)b * T * DA;
  load_f32(q, fp(pr.qin) + ot, T * D);
  load_f32(tk, fp(pr.tok) + ot, T * D);
  load_f32(sa, attn + oa, T * DA);
  __syncthreads();
  dense_rows_k4(xb, sa, DA, fp(pr.wout_t2), fp(pr.bout_t2), D, false);
  __syncthreads();
  for (int i = threadIdx.x; i < T * D; i += THREADS) xa[i] = q[i] + xb[i];
  __syncthreads();
  ln_rows(q, xa, fp(pr.n2_s), fp(pr.n2_b), pr.eps);
  __syncthreads();
  dense_rows_k4(hid, q, D, fp(pr.lin1_w), fp(pr.lin1_b), pr.mlp, true);
  __syncthreads();
  dense_rows_k4(xb, hid, pr.mlp, fp(pr.lin2_w), fp(pr.lin2_b), D, false);
  __syncthreads();
  for (int i = threadIdx.x; i < T * D; i += THREADS) xa[i] = q[i] + xb[i];
  __syncthreads();
  ln_rows(q, xa, fp(pr.n3_s), fp(pr.n3_b), pr.eps);
  __syncthreads();
  for (int i = threadIdx.x; i < T * D; i += THREADS) {
    qs[ot + i] = q[i];
    xa[i] = q[i] + tk[i];
  }
  __syncthreads();
  dense_rows_k4(k2 + oa, xa, D, fp(pr.wk_i2), fp(pr.bk_i2), DA, false);
  dense_rows_k4(v2, q, D, fp(pr.wv_i2), fp(pr.bv_i2), DA, false);
  dense_rows_k4(qf + oa, xa, D, fp(pr.wq_fa), fp(pr.bq_fa), DA, false);
  __syncthreads();
  const int d = threadIdx.x;
  const float* wo = fp(pr.wout_i2);
  float* cb = c2 + (size_t)b * HT * D;
  for (int hh = 0; hh < H; ++hh) {
    float w[HD];
#pragma unroll
    for (int j = 0; j < HD; ++j) w[j] = wo[(size_t)(hh * HD + j) * D + d];
#pragma unroll
    for (int t = 0; t < T; ++t) {
      float a = 0.f;
#pragma unroll
      for (int j = 0; j < HD; ++j) a = fmaf(v2[t * DA + hh * HD + j], w[j], a);
      cb[(hh * T + t) * D + d] = a;
    }
  }
}

// After the final attention, for each prompt: its out-projection, the
// residual and the final LayerNorm -> qout [b][T][D] f32; with WITH_HYPER (the
// logits mode) also the hypernetwork rows of mask tokens 1..3 from token
// rows 2..4 (as the bf16 ROWS emission) -> hyper [b][3][D/8] f32.
template <bool WITH_HYPER>
__global__ void __launch_bounds__(THREADS) tail_final_f32_kernel(const TailParams pr,
                                                                 const float* attn,
                                                                 const float* qs) {
  __shared__ __align__(16) float sa[T * DA];
  __shared__ __align__(16) float q[T * D];
  __shared__ __align__(16) float xa[T * D];
  __shared__ __align__(16) float xb[T * D];
  __shared__ __align__(16) float h1[N_MASKS * D];
  __shared__ __align__(16) float h2[N_MASKS * D];
  const int b = blockIdx.x;
  const size_t ot = (size_t)b * T * D;
  load_f32(sa, attn + (size_t)b * T * DA, T * DA);
  load_f32(q, qs + ot, T * D);
  __syncthreads();
  dense_rows_k4(xb, sa, DA, fp(pr.wout_fa), fp(pr.bout_fa), D, false);
  __syncthreads();
  for (int i = threadIdx.x; i < T * D; i += THREADS) xa[i] = q[i] + xb[i];
  __syncthreads();
  ln_rows(q, xa, fp(pr.nf_s), fp(pr.nf_b), pr.eps);
  __syncthreads();
  float* qout = reinterpret_cast<float*>(pr.qout) + ot;
  for (int i = threadIdx.x; i < T * D; i += THREADS) qout[i] = q[i];
  if constexpr (WITH_HYPER) {
    hyper_layer(h1, q + 2 * D, D, D, fp(pr.hw1), fp(pr.hb1), D, true);
    __syncthreads();
    hyper_layer(h2, h1, D, D, fp(pr.hw2), fp(pr.hb2), D, true);
    __syncthreads();
    hyper_layer(h1, h2, D, D, fp(pr.hw3), fp(pr.hb3), HYPER, false);
    __syncthreads();
    float* out = reinterpret_cast<float*>(pr.hyper) + (size_t)b * N_MASKS * HYPER;
    for (int i = threadIdx.x; i < N_MASKS * HYPER; i += THREADS) out[i] = h1[i];
  }
}

#define RAT_TRY(call)              \
  do {                             \
    const int e_ = (int)(call);    \
    if (e_ != 0) return e_;        \
  } while (0)

// The f32 form's launches on st (see the note above) in emission E:
// KEYS keys2 to keys2 [b][M][D]; PROBS P1, P2 and C2 to p1, p2 and c2m,
// keys2 not stored; ROWS keys2's tiles below content to krows [b][content
// rounded up to 32][D] and the hypernetwork rows to hyper.
template <int E>
int tail_f32(const TailParams& pr, cudaStream_t st) {
  const int b = pr.b, m = pr.m;
  const float eps = pr.eps;
  void* s = st;
  const Work w = carve(pr, E == PROBS);
  tail_queries_f32_kernel<<<b, THREADS, 0, st>>>(pr, w.q2);
  RAT_TRY(cudaGetLastError());
  RAT_TRY(rat_i2t_probs_f32(pr.q1st, pr.tok_k1, nullptr, nullptr, nullptr, nullptr, nullptr,
                            nullptr, w.p1, b, m, 1, eps, s));
  RAT_TRY(rat_t2i_probs_f32(w.q2, pr.img0, w.p1, pr.c1m, nullptr, nullptr, pr.wk_t2, pr.wv_t2,
                            pr.pek2t, pr.rows, pr.vb_t2, w.attn2, b, m, 1, eps, s));
  const int mid = mid_smem(pr.mlp);
  RAT_TRY(cudaFuncSetAttribute(tail_mid_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               mid));
  tail_mid_f32_kernel<<<b, THREADS, mid, st>>>(pr, w.attn2, w.qs, w.k2, w.qf, w.c2);
  RAT_TRY(cudaGetLastError());
  RAT_TRY(rat_i2t_probs_f32(nullptr, w.k2, pr.img0, w.p1, pr.c1m, pr.peq2t, pr.wq_i2, pr.rows,
                            w.p2, b, m, 2, eps, s));
  if constexpr (E == PROBS) {
    RAT_TRY(rat_t2i_probs_f32(w.qf, pr.img0, w.p1, pr.c1m, w.p2, w.c2, pr.wk_fa, pr.wv_fa,
                              pr.pekft, pr.rows, pr.vb_fa, w.attnf, b, m, 2, eps, s));
  } else {
    const int klimit = E == ROWS ? (pr.content + BM - 1) / BM * BM : m;
    RAT_TRY(rat_t2i_probs_f32_keys(w.qf, pr.img0, w.p1, pr.c1m, w.p2, w.c2, pr.wk_fa, pr.wv_fa,
                                   pr.pekft, pr.rows, pr.vb_fa, w.attnf,
                                   E == ROWS ? (void*)pr.krows : (void*)pr.keys2, b, m, klimit,
                                   eps, s));
  }
  tail_final_f32_kernel<E == ROWS><<<b, THREADS, 0, st>>>(pr, w.attnf, w.qs);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of the f32 form's work a prompt at m positions in keys and
// logits modes (a report, no launch); the caller passes b times this as
// TailParams.work.
extern "C" int rat_decode_tail_f32_scratch(int m) { return (int)work_bytes(m); }

// The same in probability mode, at any m: the token rows alone.
extern "C" int rat_decode_tail_f32_probs_scratch() { return (int)rows_bytes(); }

// Dynamic shared memory of the f32 form's token mid-ops CTA in bytes at
// MLP width mlp (a report, no launch).
extern "C" int rat_decode_tail_f32_smem(int mlp) { return mid_smem(mlp); }

// The f32 form in keys mode (keys2 set) or probability mode (p1, p2 and
// c2m set, keys2 not), as the bf16 entry picks: every TailParams pointer
// f32 but the unused ones and p1, p2 (bf16), work set. Any other mix of
// outputs is refused before a launch.
extern "C" int rat_decode_tail_f32(const void* params, void* stream) {
  const TailParams& pr = *static_cast<const TailParams*>(params);
  const bool keys_mode = pr.keys2 != nullptr;
  const bool probs_mode = pr.p1 != nullptr && pr.p2 != nullptr && pr.c2m != nullptr;
  const bool any_probs = pr.p1 != nullptr || pr.p2 != nullptr || pr.c2m != nullptr;
  if (!tail_ok(pr) || (keys_mode ? any_probs : !probs_mode) || pr.work == nullptr ||
      pr.b > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return keys_mode ? tail_f32<KEYS>(pr, st) : tail_f32<PROBS>(pr, st);
}

// The f32 form in logits mode: the tail with keys2's rows and the
// hypernetwork rows, then K3 f32 on them (its weight planes in
// mh_scratch), on the same stream.
extern "C" int rat_decode_tail_logits_f32(const void* params, void* stream) {
  const TailParams& pr = *static_cast<const TailParams*>(params);
  if (!tail_ok(pr) || pr.keys2 != nullptr || pr.p1 != nullptr || pr.p2 != nullptr ||
      pr.krows == nullptr || pr.hyper == nullptr || pr.logits == nullptr || pr.content < 1 ||
      pr.content > pr.m || pr.work == nullptr || pr.mh_scratch == nullptr || pr.b > 65535)
    return (int)cudaErrorInvalidValue;
  RAT_TRY(tail_f32<ROWS>(pr, static_cast<cudaStream_t>(stream)));
  const int gg = (pr.content + BM - 1) / BM * BM;
  return rat_mask_head_f32(pr.krows, pr.up1_w, pr.up1_b, pr.ln_s, pr.ln_b, pr.up2_w, pr.up2_b,
                           pr.hyper, pr.logits, pr.mh_scratch, pr.b, gg, pr.content, N_MASKS,
                           pr.eps, stream);
}
