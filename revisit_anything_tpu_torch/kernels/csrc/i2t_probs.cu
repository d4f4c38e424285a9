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
// scores are small. Layer 2 is bound by operations: per position the
// rebuild is 56 x 256 multiply-adds (bf16 operands) and the scores another
// 56 x 256 against the f32 branch, about 240 GFLOP at 1024 prompts.
//
// Design: one CTA of 8 warps per (prompt, run of 32-position tiles); in
// the scores and the softmax warp = head and lane = position, so a head's
// 7 scores and their softmax stay in one thread's registers and the
// stores of P are 64-byte row pieces along M. Layer 1 is B3's P1
// (decode_tail.cu `p1_tile`) on runs of 16 tiles, with the token keys
// held as f32 (add_pe_term_f32): the layer is bound by its instructions,
// and with the keys as bf16, converted every tile, it took 0.74 ms
// against 0.54 on an H100. Layer 2 is the first half of B3's pass B on
// the tensor cores (decode_tc.cuh), one CTA a prompt (runs of 128 tiles):
// Wq2 pushed to the token side once per CTA (K2[h*7 + t] = k[t, h]
// Wq2[:, h]^T, [56, 256]; the JAX fused tail's reassociation), the branch
// tile rebuilt from P1 (by cp.async, one tile ahead) and C1 (staged once a
// CTA) as bf16 mma.sync onto img0 in registers, and the scores K2 .
// keys1^T as three fp16 products of hi/lo planes (22 bits), then the pe
// term, the softmax and the stores on the FMA units. Runs of 16 tiles
// (8192 CTAs at 1024 prompts, an even last wave) took 6.2 ms against 5.2
// for whole prompts on an H100 (kernels/probs_compare.py [grid]): each
// run repeats K2's projection and C1's staging. The TPU kernel's
// block-diagonal token matrices are not carried: heads are warps.
// Layer 2's shared memory: the branch planes (32 KB; the token keys in f32
// before the walk), K2's planes (56 KB), C1, S, two P tiles, vectors and
// scales: 138,048 B, one CTA an SM.
//
// The f32 form (rat_i2t_probs_f32, an f32 SAM) replaces the same TPU
// kernel on f32 inputs: q1st, the token keys, img0, C1, peq2, W_q and the
// branch rows f32; P1 and the output P stay bf16, as the JAX kernel
// rounds P for every dtype. Layer 1 is the same kernel template on f32
// loads (the token keys and q1st f32). Layer 2 is the f32 walk of
// walk_f32.cuh (B8 f32's, with the softmax over the 7 tokens and the P2
// stores in place of the context; two warpgroups on alternate 16-position
// tiles, P1 by TMA, the branch tile in registers, named barriers), one
// CTA a prompt.

#include "decode_common.cuh"
#include "decode_tc.cuh"
#include "walk_f32.cuh"

namespace {

using namespace rat_decode;
using namespace rat_decode_tc;

constexpr int L1_TILES = 16;   // 32-position tiles a CTA takes, layer 1
constexpr int L2_TILES = 128;  // and layer 2: a whole prompt at M 4096

// Layer 2's shared memory (bytes).
struct Smem {
  static constexpr int Y = 0;                              // branch planes hi, lo / token keys f32
  static constexpr int Q = Y + BM * D * 4;                 // K2 planes hi, lo
  static constexpr int C = Q + HT * D * 4;                 // C1
  static constexpr int S = C + HT * D * 2;                 // S; the LN's row sums
  static constexpr int P = S + HT * BM * 4;                // P1 tiles [2][HT][BM] bf16
  static constexpr int V = P + 2 * HT * BM * 2;            // branch rows 0-5
  static constexpr int K = V + 6 * D * 2;                  // token keys [T][DA]
  static constexpr int SC = K + T * DA * 2;                // planes' s: Y1, Y2, K2; scratch [8]
  static constexpr int TOTAL = SC + 16 * 4;
};
static_assert(Smem::TOTAL == 138048, "one CTA an SM");
static_assert(BM * WARPS * 8 <= HT * BM * 4, "the LN's row sums fit S");

template <typename E>
__global__ void __launch_bounds__(THREADS)
i2t_probs_l1_kernel(const E* __restrict__ q1st,               // [DA, M]
                    const E* __restrict__ tok_k,              // [B, T, DA]
                    __nv_bfloat16* __restrict__ out,          // [B, HT, M]
                    int m) {
  __shared__ __align__(16) float sK[T * DA];
  const int b = blockIdx.y, lane = threadIdx.x % 32;
  load_f32(sK, tok_k + (size_t)b * T * DA, T * DA);
  __syncthreads();
  const int t0 = blockIdx.x * L1_TILES, t_end = min(m / BM, t0 + L1_TILES);
  __nv_bfloat16* ob = out + (size_t)b * HT * m;
  const float scale = rsqrtf((float)HD);
  for (int i = t0; i < t_end; ++i) {
    float s[T];
#pragma unroll
    for (int t = 0; t < T; ++t) s[t] = 0.f;
    if constexpr (std::is_same_v<E, float>) {
      rat_walk_f32::PeColF pe;
      rat_walk_f32::load_pe(pe, q1st, m, threadIdx.x / 32, i * BM + lane);
      rat_walk_f32::add_pe_term_f32(s, sK, pe, threadIdx.x / 32);
    } else {
      PeCol pe;
      load_pe(pe, q1st, m, i * BM + lane);
      add_pe_term_f32(s, sK, pe);
    }
#pragma unroll
    for (int t = 0; t < T; ++t) s[t] *= scale;
    softmax_tokens(s);
    emit_p(ob + i * BM, m, s);
  }
}

// (E is bf16: the f32 form's layer 2 is walk_f32.cuh's walk)
template <typename E>
__global__ void __launch_bounds__(THREADS, 1)
i2t_probs_l2_kernel(const E* __restrict__ tok_k,              // [B, T, DA]
                    const E* __restrict__ img0,               // [M, D]
                    const __nv_bfloat16* __restrict__ p1,     // [B, HT, M]
                    const E* __restrict__ c1,                 // [B, HT, D]
                    const E* __restrict__ peq2t,              // [DA, M]
                    const E* __restrict__ w_q,                // [D, DA]
                    const E* __restrict__ rows,               // [8, D]
                    __nv_bfloat16* __restrict__ out,          // [B, HT, M]
                    int m, float eps) {
  static_assert(std::is_same_v<E, __nv_bfloat16>, "bf16 operands");
  using L = Smem;
  extern __shared__ __align__(128) unsigned char smem[];
  __half* sYh = reinterpret_cast<__half*>(smem + L::Y);
  __half* sYl = sYh + BM * D;
  __half* sQh = reinterpret_cast<__half*>(smem + L::Q);
  __half* sQl = sQh + HT * D;
  float* sS = reinterpret_cast<float*>(smem + L::S);
  float2* red = reinterpret_cast<float2*>(smem + L::S);
  __nv_bfloat16* sP = reinterpret_cast<__nv_bfloat16*>(smem + L::P);
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(smem + L::V);
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem + L::K);
  float* sSc = reinterpret_cast<float*>(smem + L::SC);
  float* scratch = sSc + 8;
  float* xk = reinterpret_cast<float*>(smem + L::Y);      // token keys f32, before the walk

  const int b = blockIdx.y, lane = threadIdx.x % 32;
  const int t0 = blockIdx.x * L2_TILES, t_end = min(m / BM, t0 + L2_TILES);
  const __nv_bfloat16* pb = p1 + (size_t)b * HT * m;
  __nv_bfloat16* ob = out + (size_t)b * HT * m;
  // tile i's P1 into set (i - t0) % 2, one commit group a tile
  auto load_p = [&](int i) { load_p_async(sP + ((i - t0) % 2) * HT * BM, pb, m, i * BM); };
  load_p(t0);
  cp_async_commit();
  const __nv_bfloat16* kb = tok_k + (size_t)b * T * DA;
  copy16(sV, rows, 6 * D);
  copy16(sK, kb, T * DA);
  load_f32(xk, kb, T * DA);
  __nv_bfloat16* c = reinterpret_cast<__nv_bfloat16*>(smem + L::C);
  stage_c(c, c1 + (size_t)b * HT * D);
  __syncthreads();
  branch_scales(sSc, scratch, sV);
  project_rows_tc(sQh, sQl, sSc + 2, scratch, xk, w_q);   // K2 = k Wq2^T
  __syncthreads();

  const float ys1 = sSc[0];                               // the planes' s
  const float unscale = 1.f / (sSc[2] * ys1);
  Frag y;                                                 // the f32 branch tile
  for (int i = t0; i < t_end; ++i) {
    const int m0 = i * BM;
    PeCol pe;                                             // each asked for a phase ahead
    ImgFrag img;
    load_pe(pe, peq2t, m, m0 + lane);
    load_img0(img, img0, m0);
    if (i + 1 < t_end) load_p(i + 1);
    cp_async_commit();
    cp_async_wait1();                                     // tile i's P1
    __syncthreads();
    rebuild_tc<true>(y, img, sYh, sYl, sP + ((i - t0) % 2) * HT * BM, c, sV, red, eps,
                     ys1);                                // keys1
    scores_tc(sS, sQh, sQl, sYh, sYl);
    __syncthreads();
    float s[T];
    head_scores_tc(s, sS, sK, pe, unscale);
    softmax_tokens(s);
    emit_p(ob + m0, m, s);                                // P2
  }
}

template <typename E>
int dispatch(const void* q1st, const void* tok_k, const void* img0, const void* p1,
             const void* c1, const void* peq2t, const void* w_q, const void* rows, void* out,
             int b, int m, int layer, float eps, void* stream) {
  if (b < 1 || b > 65535 || m < BM || m % BM != 0 || (layer != 1 && layer != 2))
    return (int)cudaErrorInvalidValue;
  typedef const E* A;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = m / BM;
  if (layer == 1) {
    i2t_probs_l1_kernel<E><<<dim3((tiles + L1_TILES - 1) / L1_TILES, b), THREADS, 0, s>>>(
        static_cast<A>(q1st), static_cast<A>(tok_k), static_cast<__nv_bfloat16*>(out), m);
  } else if constexpr (std::is_same_v<E, float>) {
    // the f32 walk (walk_f32.cuh), one CTA a prompt
    return rat_walk_f32::launch<1, rat_walk_f32::PROBS>(
        static_cast<A>(tok_k), static_cast<A>(img0), p1, static_cast<A>(c1), nullptr, nullptr,
        static_cast<A>(w_q), nullptr, static_cast<A>(peq2t), static_cast<A>(rows), nullptr, out,
        nullptr, b, m, eps, 0, s);
  } else {
    cudaError_t err = cudaFuncSetAttribute(
        i2t_probs_l2_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem::TOTAL);
    if (err != cudaSuccess) return (int)err;
    i2t_probs_l2_kernel<E><<<dim3((tiles + L2_TILES - 1) / L2_TILES, b), THREADS, Smem::TOTAL, s>>>(
        static_cast<A>(tok_k), static_cast<A>(img0), static_cast<const __nv_bfloat16*>(p1),
        static_cast<A>(c1), static_cast<A>(peq2t), static_cast<A>(w_q), static_cast<A>(rows),
        static_cast<__nv_bfloat16*>(out), m, eps);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rat_i2t_probs(const void* q1st, const void* tok_k, const void* img0,
                             const void* p1, const void* c1, const void* peq2t,
                             const void* w_q, const void* rows, void* out, int b, int m,
                             int layer, float eps, void* stream) {
  return dispatch<__nv_bfloat16>(q1st, tok_k, img0, p1, c1, peq2t, w_q, rows, out, b, m, layer,
                                 eps, stream);
}

// Dynamic shared memory of a CTA of `layer` in bytes (a report, no launch).
extern "C" int rat_i2t_probs_smem(int layer) { return layer == 2 ? Smem::TOTAL : 0; }

// The f32 form (an f32 SAM): the same arguments with q1st, tok_k, img0,
// c1, peq2t, w_q and rows f32; p1 and out stay bf16.
extern "C" int rat_i2t_probs_f32(const void* q1st, const void* tok_k, const void* img0,
                                 const void* p1, const void* c1, const void* peq2t,
                                 const void* w_q, const void* rows, void* out, int b, int m,
                                 int layer, float eps, void* stream) {
  return dispatch<float>(q1st, tok_k, img0, p1, c1, peq2t, w_q, rows, out, b, m, layer, eps,
                         stream);
}

extern "C" int rat_i2t_probs_f32_smem(int layer) {
  return layer == 2 ? rat_walk_f32::Smem<1, rat_walk_f32::PROBS>::TOTAL : 0;
}
