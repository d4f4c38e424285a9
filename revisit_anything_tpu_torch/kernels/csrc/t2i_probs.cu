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
// What bounds it on the H100: operations. Per position the rebuild costs
// 56 x 256 multiply-adds a layer (bf16 operands, exact products), the
// scores 56 x 256 and the context 56 x 256 against the f32 branch: about
// 0.36 (depth 1) or 0.48 (depth 2) TFLOP at 1024 prompts. Bytes are small:
// P (470 MB a layer at 1024 prompts) is read once.
//
// Design: B3's pass A (decode_tail.cu) with P1 (and P2) read from device
// memory instead of computed. One CTA of 8 warps per prompt walks the M
// positions in 32-position tiles with an online softmax; the projections
// move to the query side (the JAX fused tail's `_bd_attend_q`): s = (q_h
// Wk_h^T) . keys + q_h . pe_k and out = (p . keys) Wv + bv, so no [M,
// 2*DA] k|v is ever formed. Per tile, the products run on the tensor cores
// by mma.sync (decode_tc.cuh): the rebuilds in bf16 onto the f32 branch
// held in registers, the scores and the online-softmax context as three
// fp16 products of hi/lo planes of their f32 operands times a power of two
// (22 bits), each from a fresh accumulator joined in f32 by fmaf. The P
// tiles arrive by cp.async one tile ahead, into the layout the rebuild
// reads; the img0 and pe operands are asked for a phase ahead. The value
// projection runs once, on the [56, 256] context, on the FMA units.
// Shared memory: the branch planes (32 KB; the token rows before and after
// the walk), the query-side matrix's planes (56 KB; then the context), C1
// (and C2) staged once a prompt, S / p, two P tiles a layer, vectors and
// scales: 138,304 B at depth 1, 174,144 B at depth 2, one CTA an SM.
//
// The f32 form (rat_t2i_probs_f32, an f32 SAM) replaces the same TPU
// kernel on f32 inputs: q, img0, C1, C2, pe_k, W_k, W_v, v_bias and the
// branch rows f32, P1 and P2 bf16; the output f32 [B, T, DA], unrounded,
// as the JAX kernel's softmax and products are f32. It is its own kernel,
// walk_f32.cuh (two warpgroups on alternate 16-position tiles, P by TMA,
// the branch tile in registers, named barriers; the design and its
// reasons are there). At depth 2 it also comes with a keys store
// (rat_t2i_probs_f32_keys; no Python entry): the decode tail's f32 form
// (decode_tail.cu) runs its final attention with it, and each tile's
// keys2 leaves as f32 from the rebuild's registers on the way.

#include "decode_common.cuh"
#include "decode_tc.cuh"
#include "walk_f32.cuh"

namespace {

using namespace rat_decode;
using namespace rat_decode_tc;

constexpr int PT = HT * BM;   // elements of one P tile

// Shared memory (bytes) of a CTA at depth DEPTH.
template <typename E, int DEPTH>
struct Smem {
  static constexpr int E2 = (int)sizeof(E);
  static constexpr int Y = 0;                            // branch planes hi, lo / token rows
  static constexpr int Q = Y + BM * D * 4;               // q Wk^T planes hi, lo / the context
  static constexpr int C = Q + HT * D * 4;               // C1 (, C2)
  static constexpr int S = C + DEPTH * HT * D * E2;      // S / p hi, lo; the LN's row sums
  static constexpr int P = S + HT * BM * 4;              // P tiles [2][DEPTH][HT][BM] bf16
  static constexpr int V = P + 2 * DEPTH * PT * 2;       // branch rows 0-5
  static constexpr int QT = V + 6 * D * E2;              // token queries [T][DA]
  static constexpr int ALPHA = QT + T * DA * E2;         // rescale / 1 / sum [HT]
  static constexpr int SC = ALPHA + 64 * 4;              // planes' s: Y1, Y2, Q; scratch [8]
  static constexpr int TOTAL = SC + 16 * 4;
};
static_assert(Smem<__nv_bfloat16, 1>::TOTAL == 138304 && Smem<__nv_bfloat16, 2>::TOTAL == 174144,
              "the byte counts above");
static_assert(BM * WARPS * 8 <= HT * BM * 4, "the LN's row sums fit S");

template <typename E, int DEPTH>
__global__ void __launch_bounds__(THREADS, 1)
t2i_probs_kernel(const E* __restrict__ q,                  // [B, T, DA]
                 const E* __restrict__ img0,               // [M, D]
                 const __nv_bfloat16* __restrict__ p1,     // [B, HT, M]
                 const E* __restrict__ c1,                 // [B, HT, D]
                 const __nv_bfloat16* __restrict__ p2,     // [B, HT, M] (depth 2)
                 const E* __restrict__ c2,                 // [B, HT, D] (depth 2)
                 const E* __restrict__ w_k,                // [D, DA]
                 const E* __restrict__ w_v,                // [D, DA]
                 const E* __restrict__ pekt,               // [DA, M]
                 const E* __restrict__ rows,               // [8, D]
                 const E* __restrict__ v_bias,             // [DA]
                 E* __restrict__ out,                      // [B, T, DA]
                 int m, float eps) {
  using L = Smem<E, DEPTH>;
  extern __shared__ __align__(128) unsigned char smem[];
  __half* sYh = reinterpret_cast<__half*>(smem + L::Y);
  __half* sYl = sYh + BM * D;
  __half* sQh = reinterpret_cast<__half*>(smem + L::Q);
  __half* sQl = sQh + HT * D;
  float* sS = reinterpret_cast<float*>(smem + L::S);
  __half* sPh = reinterpret_cast<__half*>(smem + L::S);
  __half* sPl = sPh + HT * BM;
  float2* red = reinterpret_cast<float2*>(smem + L::S);
  __nv_bfloat16* sP = reinterpret_cast<__nv_bfloat16*>(smem + L::P);
  E* sV = reinterpret_cast<E*>(smem + L::V);
  E* sq = reinterpret_cast<E*>(smem + L::QT);
  float* alpha = reinterpret_cast<float*>(smem + L::ALPHA);
  float* sSc = reinterpret_cast<float*>(smem + L::SC);
  float* scratch = sSc + 8;
  float* xq = reinterpret_cast<float*>(smem + L::Y);     // q in f32, then the output rows
  float* sCtx = reinterpret_cast<float*>(smem + L::Q);   // the context [HT][D] f32

  const int b = blockIdx.x, lane = threadIdx.x % 32;
  const int tiles = m / BM;
  const __nv_bfloat16* pb[2] = {p1 + (size_t)b * HT * m,
                                DEPTH == 2 ? p2 + (size_t)b * HT * m : nullptr};
  const E* cb[2] = {c1 + (size_t)b * HT * D, DEPTH == 2 ? c2 + (size_t)b * HT * D : nullptr};
  // the P tiles of tile i into set i % 2, one commit group a tile
  auto load_p = [&](int i) {
#pragma unroll
    for (int l = 0; l < DEPTH; ++l) load_p_async(sP + ((i % 2) * DEPTH + l) * PT, pb[l], m, i * BM);
  };
  load_p(0);
  cp_async_commit();
  const E* qb = q + (size_t)b * T * DA;
  copy16(sV, rows, 6 * D);
  copy16(sq, qb, T * DA);
  load_f32(xq, qb, T * DA);
  const E* c[DEPTH];
#pragma unroll
  for (int l = 0; l < DEPTH; ++l) {
    E* sC = reinterpret_cast<E*>(smem + L::C + l * HT * D * L::E2);
    stage_c(sC, cb[l]);
    c[l] = sC;
  }
  __syncthreads();
  branch_scales(sSc, scratch, sV);
  project_rows_tc(sQh, sQl, sSc + 2, scratch, xq, w_k);
  __syncthreads();

  Online st;
  Ctx ctx;
  Frag y;                                        // the f32 branch tile
  online_init(st);
  context_init(ctx);
  const float ys1 = sSc[0], ys2 = sSc[1];        // the planes' s
  const float ys = DEPTH == 2 ? ys2 : ys1;       // the attended layer's
  const float unscale = 1.f / (sSc[2] * ys);
  for (int i = 0; i < tiles; ++i) {
    const int m0 = i * BM;
    PeCol pe;                                    // each asked for a phase ahead
    ImgFrag img;
    load_pe(pe, pekt, m, m0 + lane);
    load_img0(img, img0, m0);
    if (i + 1 < tiles) load_p(i + 1);
    cp_async_commit();
    cp_async_wait1();                            // tile i's P
    __syncthreads();
    const __nv_bfloat16* tp = sP + (i % 2) * DEPTH * PT;
    rebuild_tc<true>(y, img, sYh, sYl, tp, c[0], sV, red, eps, ys1);           // keys1
    if (DEPTH == 2)                                                              // keys2
      rebuild_tc<false>(y, img, sYh, sYl, tp + PT, c[DEPTH - 1], sV + 3 * D, red, eps, ys2);
    scores_tc(sS, sQh, sQl, sYh, sYl);
    __syncthreads();
    float s[T];
    head_scores_tc(s, sS, sq, pe, unscale);
    __syncthreads();                             // S read: p replaces it
    online_tile(st, s, sPh, sPl, alpha);
    __syncthreads();
    context_tc(ctx, sPh, sPl, alpha, sYh, sYl);
    __syncthreads();
  }
  online_finish(st, alpha);
  __syncthreads();
  context_store(ctx, alpha, 1.f / (P_SCALE * ys), sCtx);
  __syncthreads();
  attn_out(xq, sCtx, w_v, v_bias);
  __syncthreads();
  for (int i = threadIdx.x; i < T * DA; i += THREADS)
    out[(size_t)b * T * DA + i] = __float2bfloat16(xq[i]);
}

template <typename E, int DEPTH>
int launch(const void* const* ptrs, void* out, int b, int m, float eps, cudaStream_t s) {
  constexpr int smem = Smem<E, DEPTH>::TOTAL;
  cudaError_t err = cudaFuncSetAttribute(t2i_probs_kernel<E, DEPTH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  typedef const E* A;
  typedef const __nv_bfloat16* P;
  t2i_probs_kernel<E, DEPTH><<<b, THREADS, smem, s>>>(
      static_cast<A>(ptrs[0]), static_cast<A>(ptrs[1]), static_cast<P>(ptrs[2]),
      static_cast<A>(ptrs[3]), static_cast<P>(ptrs[4]), static_cast<A>(ptrs[5]),
      static_cast<A>(ptrs[6]), static_cast<A>(ptrs[7]), static_cast<A>(ptrs[8]),
      static_cast<A>(ptrs[9]), static_cast<A>(ptrs[10]), static_cast<E*>(out), m, eps);
  return (int)cudaGetLastError();
}

bool bad_shape(int b, int m) { return b < 1 || m < BM || m % BM != 0; }

// The f32 walk (walk_f32.cuh) at depth DEPTH, KIND ATTEND or ATTEND_KEYS.
template <int DEPTH, int KIND>
int launch_f32(const void* const* ptrs, void* out, float* keys, int b, int m, float eps,
               int klimit, cudaStream_t s) {
  typedef const float* A;
  return rat_walk_f32::launch<DEPTH, KIND>(
      static_cast<A>(ptrs[0]), static_cast<A>(ptrs[1]), ptrs[2], static_cast<A>(ptrs[3]),
      ptrs[4], static_cast<A>(ptrs[5]), static_cast<A>(ptrs[6]), static_cast<A>(ptrs[7]),
      static_cast<A>(ptrs[8]), static_cast<A>(ptrs[9]), static_cast<A>(ptrs[10]), out, keys, b,
      m, eps, klimit, s);
}

}  // namespace

extern "C" int rat_t2i_probs(const void* q, const void* img0, const void* p1, const void* c1,
                             const void* p2, const void* c2, const void* w_k, const void* w_v,
                             const void* pekt, const void* rows, const void* v_bias, void* out,
                             int b, int m, int depth, float eps, void* stream) {
  const void* ptrs[11] = {q, img0, p1, c1, p2, c2, w_k, w_v, pekt, rows, v_bias};
  if (bad_shape(b, m) || (depth != 1 && depth != 2) ||
      (depth == 2 && (p2 == nullptr || c2 == nullptr)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  typedef __nv_bfloat16 E;
  return depth == 2 ? launch<E, 2>(ptrs, out, b, m, eps, s) : launch<E, 1>(ptrs, out, b, m, eps, s);
}

// Dynamic shared memory of a CTA at `depth` in bytes (a report, no launch).
extern "C" int rat_t2i_probs_smem(int depth) {
  return depth == 2 ? Smem<__nv_bfloat16, 2>::TOTAL : Smem<__nv_bfloat16, 1>::TOTAL;
}

// The f32 form (an f32 SAM): the same arguments with q, img0, c1, c2, w_k,
// w_v, pekt, rows, v_bias and out f32; p1 and p2 stay bf16.
extern "C" int rat_t2i_probs_f32(const void* q, const void* img0, const void* p1,
                                 const void* c1, const void* p2, const void* c2, const void* w_k,
                                 const void* w_v, const void* pekt, const void* rows,
                                 const void* v_bias, void* out, int b, int m, int depth,
                                 float eps, void* stream) {
  const void* ptrs[11] = {q, img0, p1, c1, p2, c2, w_k, w_v, pekt, rows, v_bias};
  if (bad_shape(b, m) || (depth != 1 && depth != 2) ||
      (depth == 2 && (p2 == nullptr || c2 == nullptr)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  using rat_walk_f32::ATTEND;
  return depth == 2 ? launch_f32<2, ATTEND>(ptrs, out, nullptr, b, m, eps, 0, s)
                    : launch_f32<1, ATTEND>(ptrs, out, nullptr, b, m, eps, 0, s);
}

extern "C" int rat_t2i_probs_f32_smem(int depth) {
  using rat_walk_f32::ATTEND;
  return depth == 2 ? rat_walk_f32::Smem<2, ATTEND>::TOTAL : rat_walk_f32::Smem<1, ATTEND>::TOTAL;
}

// The f32 form at depth 2 that also stores keys2 (the rebuilt branch,
// f32) to keys [b, klimit, D] for every 32-position tile below klimit
// (a multiple of 32): the final attention of the
// decode tail's f32 form (decode_tail.cu), which emits keys2 on the way.
extern "C" int rat_t2i_probs_f32_keys(const void* q, const void* img0, const void* p1,
                                      const void* c1, const void* p2, const void* c2,
                                      const void* w_k, const void* w_v, const void* pekt,
                                      const void* rows, const void* v_bias, void* out, void* keys,
                                      int b, int m, int klimit, float eps, void* stream) {
  const void* ptrs[11] = {q, img0, p1, c1, p2, c2, w_k, w_v, pekt, rows, v_bias};
  if (bad_shape(b, m) || p2 == nullptr || c2 == nullptr || keys == nullptr || klimit < 1 ||
      klimit > m || klimit % BM != 0)
    return (int)cudaErrorInvalidValue;
  return launch_f32<2, rat_walk_f32::ATTEND_KEYS>(ptrs, out, static_cast<float*>(keys), b, m,
                                                  eps, klimit, static_cast<cudaStream_t>(stream));
}
