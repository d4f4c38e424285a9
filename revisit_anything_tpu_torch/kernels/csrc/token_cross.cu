// Token -> image cross attention with k|v from one transposed projection.
//
// Replaces: revisit_anything_tpu/ops/attention.py `_token_cross_kv` /
// `_token_attn_kv_kernel` (pallas_call at :442), reached through
// `token_cross_attend_kv` (:467). Per prompt b and head h:
//   k = kvt[b, h·hd:(h+1)·hd, :] + pe_kt[h·hd:(h+1)·hd, :]   (bf16 add)
//   v = kvt[b, D + h·hd:..., :] + v_bias[h·hd:...]            (bf16 add)
//   out[b, :, h·hd:(h+1)·hd] = softmax(q_h·k / sqrt(hd)) · vᵀ
// with 7 token queries over M = 4096 image keys (hd = 16, 8 heads).
//
// The same device code without pe and v bias, on separate transposed k
// and v (entry rat_token_cross), replaces revisit_anything_tpu/ops/
// attention.py `_token_cross` / `_token_attn_kernel` (pallas_call at
// :178), reached through `token_cross_attend` (:200): k = kt[b, h rows],
// v = vt[b, h rows], nothing added.
//
// What bounds it on the H100 (NVIDIA H100 80GB HBM3, 700 W):
//  - per-prompt k|v (kvt [1024, 256, 4096]): device-memory bytes, 2.15 GB
//    a call, 0.64 ms at 3.35 TB/s;
//  - shared k|v (layer 1, kvt [1, 256, 4096]): 5 MB and 15 GFLOP, so no
//    rate of the card binds it, but its 235 M exponentials do: at the
//    SFU's 16 a clock an SM they take ~0.06 ms.
//
// Design: both products run on the tensor cores through mma.sync
// m16n8k16 (bf16 in, f32 out) with the FA2 register layout — Q·Kᵀ's
// accumulator fragment is rounded to bf16 and reused as the A operand of
// P·V — and the online softmax runs in registers over a 64-key tile: one
// exp2 a score (log2 e folded into the scale), one rescale of the
// accumulators a tile, row max and sum reduced by quad shuffles. No
// accumulator is rescaled per key. mma.sync, not wgmma: a prompt has 7
// query rows and wgmma's 64-row M would waste 89% of it, and neither case
// is bound by the tensor-core rate.
// kᵀ, peᵀ and vᵀ arrive as [16, M] rows; their [16 × 64] tiles stream
// through a 3-stage cp.async ring in shared memory (rows padded by 16
// bytes, so ldmatrix reads are free of bank conflicts); K is read as the
// B operand of Q·Kᵀ by ldmatrix.trans, V as the B operand of P·V by
// ldmatrix. k + pe and v + bias are formed once per tile in place, by
// the thread that copied each chunk, rounded to bf16 as the TPU kernel's
// bf16 adds round.
//
// Two schedules, chosen by the prompt stride of k|v:
//  - shared k|v: every prompt's queries stack into one [B·n, 16] matrix
//    per head; a CTA takes (128 rows, head), 8 warps of 16 rows share one
//    ring (one barrier a tile), and the head's k, pe and v stream once
//    per CTA. Rows past B·n are zero and not stored; a prompt's rows may
//    cross a warp's or a CTA's boundary.
//  - per-prompt k|v: a CTA takes a prompt, a warp a head with its own
//    ring (3 tiles of k, pe and v, 20 KB, in flight a warp). The n <= 8
//    queries fill rows 0..7 of the 16-row fragment: rows 8..15 are never
//    exponentiated, their probabilities are 0 and they are not stored.
// M must be a multiple of 8 (16-byte rows); the last tile's keys past M
// load as zeros and score -inf.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int HD = 16;                       // head dim (one k16 step)
constexpr int TK = 64;                       // keys a tile
constexpr int LD = TK + 8;                   // padded row of a tile
constexpr int STAGES = 3;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a · b for one 16x8x16 bf16 tile, f32 accumulation.
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p, bool valid) {
  return valid ? *reinterpret_cast<const uint32_t*>(p) : 0u;
}

// 8 bf16 sums a + b, each rounded to bf16.
__device__ __forceinline__ uint4 add8(uint4 a, uint4 b) {
  __nv_bfloat162* x = reinterpret_cast<__nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 fx = __bfloat1622float2(x[i]), fy = __bfloat1622float2(y[i]);
    x[i] = __floats2bfloat162_rn(fx.x + fy.x, fx.y + fy.y);
  }
  return a;
}

// SHARED: the CTA's 8 warps share one ring (group of 256 threads);
// otherwise each warp is its own group with its own ring.
template <bool SHARED>
__device__ __forceinline__ void group_sync() {
  if (SHARED) __syncthreads(); else __syncwarp();
}

// Shared k|v: 448 CTAs at the serving shape; at most 80 registers a
// thread let 3 CTAs share an SM.
template <bool PE, bool SHARED>
__global__ void __launch_bounds__(THREADS, SHARED ? 3 : 1)
token_cross_kernel(const __nv_bfloat16* __restrict__ q,    // [B·n, D]
                   const __nv_bfloat16* __restrict__ kt,   // prompt 0's [D, M] keys
                   const __nv_bfloat16* __restrict__ vt,   // prompt 0's [D, M] values
                   size_t kv_stride,                       // elements a prompt
                   const __nv_bfloat16* __restrict__ pe,   // [D, M] (PE only)
                   const __nv_bfloat16* __restrict__ vb,   // [D] (PE only)
                   __nv_bfloat16* __restrict__ out,        // [B·n, D]
                   int rows, int n, int d, int m, int heads, float scale_log2) {
  constexpr int NMAT = PE ? 3 : 2;                         // k, v (, pe) tiles
  constexpr int MAT = HD * LD;
  constexpr int STAGE = NMAT * MAT;
  constexpr int GTHREADS = SHARED ? THREADS : 32;
  constexpr bool HALF = !SHARED;                           // rows 8..15 are padding
  extern __shared__ __align__(16) __nv_bfloat16 smem[];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  int h, r0, nrows, gtid;
  const __nv_bfloat16 *kb, *vbase;
  __nv_bfloat16* ring;
  if (SHARED) {
    h = blockIdx.y;
    r0 = blockIdx.x * (WARPS * 16) + warp * 16;
    nrows = rows - r0;                                     // may be <= 0: load only
    kb = kt + (size_t)h * HD * m;
    vbase = vt + (size_t)h * HD * m;
    ring = smem;
    gtid = threadIdx.x;
  } else {
    h = blockIdx.y * WARPS + warp;
    if (h >= heads) return;                                // no CTA-wide sync below
    r0 = blockIdx.x * n;
    nrows = n;
    kb = kt + blockIdx.x * kv_stride + (size_t)h * HD * m;
    vbase = vt + blockIdx.x * kv_stride + (size_t)h * HD * m;
    ring = smem + warp * STAGES * STAGE;
    gtid = lane;
  }
  const __nv_bfloat16* pb = PE ? pe + (size_t)h * HD * m : nullptr;
  const int ntiles = (m + TK - 1) / TK;

  // A stage holds the tile's rows stacked as [k 0..15 | v 0..15 | pe 0..15]
  // x TK keys. Each thread copies the same 16-byte chunks of every tile:
  // column ch of stacked rows rbase, rbase + G8, ..., so its source
  // pointers are set once and move by TK keys a tile, and it forms k + pe
  // and v + bias on exactly the chunks it copied (no barrier between).
  constexpr int G8 = GTHREADS / (TK / 8);                  // stacked rows a pass
  constexpr int PASSES = (NMAT * HD + G8 - 1) / G8;
  const int ch = gtid % (TK / 8), rbase = gtid / (TK / 8);
  const __nv_bfloat16* src[PASSES];
  uint32_t vbias[PASSES];                                  // bf16x2 of v's bias row
#pragma unroll
  for (int p = 0; p < PASSES; ++p) {
    const int rowlin = rbase + p * G8, mat = rowlin / HD, row = rowlin % HD;
    src[p] = rowlin < NMAT * HD
                 ? (mat == 0 ? kb : (mat == 1 ? vbase : pb)) + (size_t)row * m + ch * 8
                 : nullptr;
    vbias[p] = 0u;
    if (PE && mat == 1) {
      const __nv_bfloat162 b2 = __bfloat162bfloat162(vb[h * HD + row]);
      vbias[p] = *reinterpret_cast<const uint32_t*>(&b2);
    }
  }

  auto load_tile = [&](int t) {
    if (t < ntiles) {
      __nv_bfloat16* st = ring + (t % STAGES) * STAGE + rbase * LD + ch * 8;
      const bool valid = t * TK + ch * 8 < m;
#pragma unroll
      for (int p = 0; p < PASSES; ++p)
        if (src[p] != nullptr)
          cp_async16(st + p * G8 * LD, src[p] + (valid ? t * TK : 0), valid);
    }
    cp_async_commit();                                      // empty groups keep the count
  };

  // Q fragment (A of Q·Kᵀ): rows g and g+8 of the warp's 16, cols 2c.. and 2c+8..
  uint32_t qa[4];
  {
    const __nv_bfloat16* qr = q + (size_t)(r0 + g) * d + h * HD + 2 * c;
    qa[0] = ld_u32(qr, g < nrows);
    qa[1] = ld_u32(qr + 8 * (size_t)d, g + 8 < nrows);
    qa[2] = ld_u32(qr + 8, g < nrows);
    qa[3] = ld_u32(qr + 8 * (size_t)d + 8, g + 8 < nrows);
  }

  float acc[2][4] = {};                                     // O: hd 0-7, 8-15
  float mrow[2] = {-INFINITY, -INFINITY}, lrow[2] = {0.f, 0.f};

#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) load_tile(t);

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait();                                        // own chunks of tile t landed
    __nv_bfloat16* sk = ring + (t % STAGES) * STAGE;
    __nv_bfloat16* sv = sk + MAT;
    if (PE) {
      // k += pe and v += bias in place on the own chunks, rounded to bf16.
      __nv_bfloat16* own = sk + rbase * LD + ch * 8;
#pragma unroll
      for (int p = 0; p < PASSES; ++p) {
        const int rowlin = rbase + p * G8;
        uint4* x = reinterpret_cast<uint4*>(own + p * G8 * LD);
        if (rowlin < HD)
          *x = add8(*x, *reinterpret_cast<const uint4*>(own + (p * G8 + 2 * HD) * LD));
        else if (rowlin < 2 * HD)
          *x = add8(*x, make_uint4(vbias[p], vbias[p], vbias[p], vbias[p]));
      }
    }
    group_sync<SHARED>();                                   // tile t formed; t-1 consumed
    load_tile(t + STAGES - 1);

    // S = Q·Kᵀ: 8 chunks of 8 keys; ldmatrix.trans of K's [16 hd, 8 keys] blocks.
    float s[TK / 8][4];
    const int mi = lane / 8, rr = lane % 8;
#pragma unroll
    for (int jj = 0; jj < TK / 16; ++jj) {
      uint32_t b[4];
      ldsm_x4_trans(b, sk + ((mi & 1) * 8 + rr) * LD + (2 * jj + (mi >> 1)) * 8);
#pragma unroll
      for (int e = 0; e < 4; ++e) s[2 * jj][e] = s[2 * jj + 1][e] = 0.f;
      mma16816(s[2 * jj], qa, b[0], b[1]);
      mma16816(s[2 * jj + 1], qa, b[2], b[3]);
    }

    // Online softmax over the tile in the log2 domain: the max is
    // taken on the raw scores (the scale is positive), and each
    // probability is one FFMA and one exp2 of its raw score. Keys past M
    // (last tile only) score -inf.
    if (t * TK + TK > m) {
#pragma unroll
      for (int j = 0; j < TK / 8; ++j)
        if (t * TK + j * 8 >= m)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = -INFINITY;
    }
    float alpha[2], m_neg[2];
#pragma unroll
    for (int r = 0; r < (HALF ? 1 : 2); ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < TK / 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(mrow[r], mx * scale_log2);
      alpha[r] = ex2(mrow[r] - m_new);                    // 0 on the first tile
      mrow[r] = m_new;
      m_neg[r] = -m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < TK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (HALF && e >= 2) {
          s[j][e] = 0.f;
        } else {
          s[j][e] = ex2(fmaf(s[j][e], scale_log2, m_neg[e / 2]));
          sum[e / 2] += s[j][e];
        }
      }
    }
#pragma unroll
    for (int r = 0; r < (HALF ? 1 : 2); ++r) {
      lrow[r] = lrow[r] * alpha[r] + sum[r];
#pragma unroll
      for (int nc = 0; nc < 2; ++nc) {
        acc[nc][2 * r] *= alpha[r];
        acc[nc][2 * r + 1] *= alpha[r];
      }
    }

    // O += P·V: P from the S fragments; V's [8 hd, 8 keys] blocks by ldmatrix.
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      uint32_t b[4];
      ldsm_x4(b, sv + ((mi >> 1) * 8 + rr) * LD + kk * 16 + (mi & 1) * 8);
      mma16816(acc[0], pa, b[0], b[1]);
      mma16816(acc[1], pa, b[2], b[3]);
    }
  }

  // Finish the row sums across the quad and store rows < nrows.
#pragma unroll
  for (int r = 0; r < (HALF ? 1 : 2); ++r) {
    lrow[r] += __shfl_xor_sync(0xffffffffu, lrow[r], 1);
    lrow[r] += __shfl_xor_sync(0xffffffffu, lrow[r], 2);
    const int row = g + 8 * r;
    if (row < nrows) {
      const float inv = 1.f / lrow[r];
      __nv_bfloat16* o = out + (size_t)(r0 + row) * d + h * HD + 2 * c;
#pragma unroll
      for (int nc = 0; nc < 2; ++nc)
        *reinterpret_cast<uint32_t*>(o + nc * 8) =
            pack_bf16(acc[nc][2 * r] * inv, acc[nc][2 * r + 1] * inv);
    }
  }
}

template <bool PE, bool SHARED>
constexpr int smem_bytes() {
  return (SHARED ? 1 : WARPS) * STAGES * (PE ? 3 : 2) * HD * LD * 2;
}

template <bool PE, bool SHARED>
int launch(const void* q, const void* kt, const void* vt, size_t kv_stride, const void* pe,
           const void* vb, void* out, int b, int n, int d, int m, int heads,
           cudaStream_t stream) {
  constexpr int smem = smem_bytes<PE, SHARED>();
  auto kernel = token_cross_kernel<PE, SHARED>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = b * n;
  const dim3 grid = SHARED ? dim3((rows + WARPS * 16 - 1) / (WARPS * 16), heads)
                           : dim3(b, (heads + WARPS - 1) / WARPS);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(kt),
      static_cast<const __nv_bfloat16*>(vt), kv_stride, static_cast<const __nv_bfloat16*>(pe),
      static_cast<const __nv_bfloat16*>(vb), static_cast<__nv_bfloat16*>(out), rows, n, d, m,
      heads, LOG2E / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

template <bool PE>
int dispatch(const void* q, const void* kt, const void* vt, size_t kv_stride, const void* pe,
             const void* vb, void* out, int b, int n, int d, int m, int heads,
             cudaStream_t s) {
  if (heads <= 0 || d != heads * HD || (n != 7 && n != 8) || m <= 0 || m % 8)
    return (int)cudaErrorInvalidValue;
  if (kv_stride == 0)
    return launch<PE, true>(q, kt, vt, 0, pe, vb, out, b, n, d, m, heads, s);
  return launch<PE, false>(q, kt, vt, kv_stride, pe, vb, out, b, n, d, m, heads, s);
}

}  // namespace

extern "C" int rat_token_cross_kv(const void* q, const void* kvt, const void* pe,
                                  const void* vb, void* out, int b, int n, int d,
                                  int m, int heads, int kv_shared, void* stream) {
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(kvt);
  return dispatch<true>(q, k, k + (size_t)d * m, kv_shared ? 0 : (size_t)2 * d * m, pe, vb,
                        out, b, n, d, m, heads, static_cast<cudaStream_t>(stream));
}

extern "C" int rat_token_cross(const void* q, const void* kt, const void* vt, void* out,
                               int b, int n, int d, int m, int heads, int kv_shared,
                               void* stream) {
  return dispatch<false>(q, kt, vt, kv_shared ? 0 : (size_t)d * m, nullptr, nullptr, out, b,
                         n, d, m, heads, static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory a CTA of each schedule takes (for reports).
extern "C" int rat_token_cross_smem(int pe, int shared) {
  if (pe) return shared ? smem_bytes<true, true>() : smem_bytes<true, false>();
  return shared ? smem_bytes<false, true>() : smem_bytes<false, false>();
}

// ---------------------------------------------------------------------------
// K2 in f32 (entry rat_token_cross_kv_f32): the same function on f32 q,
// kvt, pe_kt, v_bias and out, for an f32 SAM. The TPU kernel computes in
// its inputs' dtype, so k + pe and v + bias are f32 adds and the
// probabilities stay f32.
//
// What bounds it on the H100: bytes where k|v is per prompt (kvt [1024,
// 256, 4096] f32, 4.3 GB a call, 1.3 ms at 3.35 TB/s); where it is shared
// (layer 1) its 15 GFLOP, as three TF32 passes 0.09 ms, and its 235 M
// exponentials (~0.06 ms on the SFU).
//
// Precision: split TF32, as K1's f32 form: an f32 operand x is cut into hi
// = tf32_rna(x) and lo = tf32_rna(x − hi), and each product is lo·hi +
// hi·lo + hi·hi, in that order, on the tensor cores. S = Q·Kᵀ takes an
// 8-key block's three passes over the head's 16 channels into a fresh
// accumulator; P·V takes each 8-key block's three passes in turn into a
// tile's fresh accumulator, joined to the running O by an FMA (mma.sync
// accumulates without rounding to nearest).
//
// Design: bf16 K2's two schedules and FA2 register layout on mma.sync
// m16n8k8 in TF32. The products run on the tensor cores, not as
// register-blocked FMAs: the three passes' 45 GFLOP take 0.09 ms at 495
// TFLOP/s, the 15 GFLOP as FMAs 0.22 ms at 67 TFLOP/s, and the FMAs would
// also wait on a shared-memory load for every few of them. wgmma's 64-row
// M would waste most of a prompt's 7 rows in the per-prompt schedule, and
// the shared one is not bound by the tensor-core rate.
//  - A stage holds a tile's rows stacked as [k 0..15 | v 0..15 | pe 0..15 |
//    v lo 0..15] x TK keys (rows padded to TK + 8 floats: conflict-free
//    fragment loads), copied by cp.async. Each thread forms the chunks it
//    copied: k + pe, split, hi over k and lo over pe; v + bias, split, hi
//    over v and lo into the fourth plane. So a tile is formed and split
//    once, and every warp reads its hi and lo fragments from shared memory.
//  - Q's hi and lo fragments are split once, in registers. S's accumulator
//    gives a thread keys 2c and 2c + 1 of each 8, the A operand of P·V wants
//    keys c and c + 4: V's B fragment reads keys 2c and 2c + 1 (one 8-byte
//    load), so S's registers are P's fragments as they lie.
//  - The online softmax runs in base 2 in registers (log2 e folded into the
//    scale, one exponential a score, row max and sum by quad shuffles).
//  - Shared k|v (layer 1): every prompt's queries stack into one [B·n, 16]
//    matrix a head; a CTA takes (128 rows, head), 8 warps of 16 rows share
//    one ring of 3 stages of 64 keys (one barrier a tile), so the head's k,
//    pe and v are formed once a CTA. Rows past B·n are zero and not stored;
//    a prompt's rows may cross a warp's or a CTA's boundary.
//  - Per-prompt k|v (layers 2-3): a CTA takes a prompt, a warp a head with
//    its own ring of 2 stages of 32 keys (20 KB), so a warp keeps its next
//    tile's k, v and pe (6 KB) in flight while it computes. The n
//    <= 8 queries fill rows 0..7 of the 16-row fragment: rows 8..15 are
//    never exponentiated, their probabilities are 0 and they are not
//    stored.
// M must be a multiple of 8; the last tile's keys past M load as zeros and
// score -inf.
//
// B10 in f32 (entry rat_token_cross_f32) is the same kernel with PE false:
// separate f32 kᵀ and vᵀ [B or 1, D, M] (a prompt's stride D·M), no pe and
// no v bias, under the same two schedules; a stage copies k and v only and
// splits them into the same four planes. It replaces revisit_anything_tpu/
// ops/attention.py `_token_cross` (pallas_call at :178) on f32 inputs; the
// TPU kernel rounds p to vt's dtype, f32 here, so the probabilities stay
// f32.
namespace rat_k2f {

constexpr int HD = 16, WARPS = 8, THREADS = WARPS * 32;

template <bool SHARED>
struct Cfg {
  static constexpr int TK = SHARED ? 64 : 32;          // keys a tile
  static constexpr int LD = TK + 8;                    // padded row (floats)
  static constexpr int STAGES = SHARED ? 3 : 2;
  static constexpr int MAT = HD * LD;                  // a plane (floats)
  static constexpr int STAGE = 4 * MAT;                // k|v|pe|v lo
  static constexpr int SMEM = (SHARED ? 1 : WARPS) * STAGES * STAGE * 4;
};

template <int N>
__device__ __forceinline__ void cp_async_wait_n() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 4 sums x + y (y4 = nullptr: x + bias), split: hi over x, lo over lo.
__device__ __forceinline__ void form4(float* x, const float* y, float bias, float* lo) {
  float4 v = *reinterpret_cast<float4*>(x);
  if (y != nullptr) {
    const float4 w = *reinterpret_cast<const float4*>(y);
    v = make_float4(v.x + w.x, v.y + w.y, v.z + w.z, v.w + w.w);
  } else {
    v = make_float4(v.x + bias, v.y + bias, v.z + bias, v.w + bias);
  }
  uint32_t h[4], l[4];
  rat_hopper::split_tf32_bits(v.x, h[0], l[0]);
  rat_hopper::split_tf32_bits(v.y, h[1], l[1]);
  rat_hopper::split_tf32_bits(v.z, h[2], l[2]);
  rat_hopper::split_tf32_bits(v.w, h[3], l[3]);
  *reinterpret_cast<uint4*>(x) = make_uint4(h[0], h[1], h[2], h[3]);
  *reinterpret_cast<uint4*>(lo) = make_uint4(l[0], l[1], l[2], l[3]);
}

template <bool SHARED>
__device__ __forceinline__ void group_sync_f32() {
  if (SHARED) __syncthreads(); else __syncwarp();
}

template <bool PE, bool SHARED>
__global__ void __launch_bounds__(THREADS, SHARED ? 2 : 1)
token_cross_kv_tf32x3_kernel(const float* __restrict__ q,    // [B·n, D]
                             const float* __restrict__ kt,   // prompt 0's [D, M] keys
                             const float* __restrict__ vt,   // prompt 0's [D, M] values
                             size_t kv_stride,               // floats a prompt
                             const float* __restrict__ pe,   // [D, M] (PE only)
                             const float* __restrict__ vb,   // [D] (PE only)
                             float* __restrict__ out,        // [B·n, D]
                             int rows, int n, int d, int m, int heads, float scale_log2) {
  using C = Cfg<SHARED>;
  constexpr int TK = C::TK, LD = C::LD, STAGES = C::STAGES, MAT = C::MAT, STAGE = C::STAGE;
  constexpr int GTHREADS = SHARED ? THREADS : 32;
  constexpr bool HALF = !SHARED;                             // rows 8..15 are padding
  extern __shared__ __align__(16) float smf[];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  int h, r0, nrows, gtid;
  const float *kb, *vbase;
  float* ring;
  if (SHARED) {
    h = blockIdx.y;
    r0 = blockIdx.x * (WARPS * 16) + warp * 16;
    nrows = rows - r0;                                       // may be <= 0: load only
    kb = kt + (size_t)h * HD * m;
    vbase = vt + (size_t)h * HD * m;
    ring = smf;
    gtid = threadIdx.x;
  } else {
    h = blockIdx.y * WARPS + warp;
    if (h >= heads) return;                                  // no CTA-wide sync below
    r0 = blockIdx.x * n;
    nrows = n;
    kb = kt + blockIdx.x * kv_stride + (size_t)h * HD * m;
    vbase = vt + blockIdx.x * kv_stride + (size_t)h * HD * m;
    ring = smf + warp * STAGES * STAGE;
    gtid = lane;
  }
  const float* pb = PE ? pe + (size_t)h * HD * m : nullptr;
  const int ntiles = (m + TK - 1) / TK;

  // Each thread copies the same 16-byte chunks of every tile: column ch of
  // stacked rows rbase, rbase + G4, ... (k, then v, then pe), so it forms k
  // + pe and v + bias on exactly the chunks it copied (no barrier between).
  constexpr int CPR = TK / 4;                                // chunks a row
  constexpr int G4 = GTHREADS / CPR;                         // stacked rows a pass
  constexpr int PASSES = (PE ? 3 : 2) * HD / G4;
  constexpr int KPASSES = HD / G4;                           // passes of k (then of v)
  const int ch = gtid % CPR, rbase = gtid / CPR;
  const float* src[PASSES];
#pragma unroll
  for (int p = 0; p < PASSES; ++p) {
    const int rowlin = rbase + p * G4, mat = rowlin / HD, row = rowlin % HD;
    src[p] = (mat == 0 ? kb : (mat == 1 ? vbase : pb)) + (size_t)row * m + ch * 4;
  }
  float vbias[KPASSES];
#pragma unroll
  for (int p = 0; p < KPASSES; ++p) vbias[p] = PE ? vb[h * HD + rbase + p * G4] : 0.f;

  auto load_tile = [&](int t) {
    if (t < ntiles) {
      float* st = ring + (t % STAGES) * STAGE + rbase * LD + ch * 4;
      const bool valid = t * TK + ch * 4 < m;
#pragma unroll
      for (int p = 0; p < PASSES; ++p)
        cp_async16(st + p * G4 * LD, src[p] + (valid ? t * TK : 0), valid);
    }
    cp_async_commit();                                       // empty groups keep the count
  };

  // Q's fragments (A of Q·Kᵀ) for channels 8ks..8ks+7, split: rows g and
  // g + 8 of the warp's 16, channels c and c + 4.
  uint32_t qh[2][4], ql[2][4];
  {
    const float* qr = q + (size_t)(r0 + g) * d + h * HD + c;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const float x[4] = {g < nrows ? qr[8 * ks] : 0.f,
                          g + 8 < nrows ? qr[8 * (size_t)d + 8 * ks] : 0.f,
                          g < nrows ? qr[8 * ks + 4] : 0.f,
                          g + 8 < nrows ? qr[8 * (size_t)d + 8 * ks + 4] : 0.f};
#pragma unroll
      for (int e = 0; e < 4; ++e) rat_hopper::split_tf32_bits(x[e], qh[ks][e], ql[ks][e]);
    }
  }

  float o[2][4] = {};                                        // O: channels 0-7, 8-15
  float mrow[2] = {-INFINITY, -INFINITY}, lrow[2] = {0.f, 0.f};

#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) load_tile(t);

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait_n<STAGES - 2>();                           // own chunks of tile t landed
    float* sk = ring + (t % STAGES) * STAGE;                 // k hi; v hi at + MAT
    {
      float* own = sk + rbase * LD + ch * 4;
#pragma unroll
      for (int p = 0; p < 2 * KPASSES; ++p) {
        float* x = own + p * G4 * LD;
        if (p < KPASSES) form4(x, PE ? x + 2 * HD * LD : nullptr, 0.f, x + 2 * HD * LD);
        else form4(x, nullptr, vbias[p - KPASSES], x + 2 * HD * LD);
      }
    }
    group_sync_f32<SHARED>();                                // tile t formed; t-1 consumed
    load_tile(t + STAGES - 1);
    const float* skh = sk;
    const float* svh = sk + MAT;
    const float* skl = sk + 2 * MAT;
    const float* svl = sk + 3 * MAT;

    // S = Q·Kᵀ an 8-key block at a time: B = K [8 channels, 8 keys],
    // b0 = (channel c, key g), b1 = (channel c + 4, key g).
    float s[TK / 8][4];
#pragma unroll
    for (int j = 0; j < TK / 8; ++j) {
      uint32_t bh[2][2], bl[2][2];
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int at = (8 * ks + c + 4 * i) * LD + 8 * j + g;
          bh[ks][i] = __float_as_uint(skh[at]);
          bl[ks][i] = __float_as_uint(skl[at]);
        }
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      using rat_hopper::mma_m16n8k8_tf32;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) mma_m16n8k8_tf32(s[j], ql[ks], bh[ks][0], bh[ks][1]);
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) mma_m16n8k8_tf32(s[j], qh[ks], bl[ks][0], bl[ks][1]);
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) mma_m16n8k8_tf32(s[j], qh[ks], bh[ks][0], bh[ks][1]);
    }

    // Online softmax over the tile in base 2; keys past M (last tile
    // only, whole 8-key blocks as M % 8 == 0) score -inf.
    if (t * TK + TK > m) {
#pragma unroll
      for (int j = 0; j < TK / 8; ++j)
        if (t * TK + j * 8 >= m)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = -INFINITY;
    }
    float alpha[2] = {1.f, 1.f}, m_neg[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < (HALF ? 1 : 2); ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < TK / 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(mrow[r], mx * scale_log2);
      alpha[r] = ex2(mrow[r] - m_new);                       // 0 on the first tile
      mrow[r] = m_new;
      m_neg[r] = -m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < TK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (HALF && e >= 2) {
          s[j][e] = 0.f;
        } else {
          s[j][e] = ex2(fmaf(s[j][e], scale_log2, m_neg[e / 2]));
          sum[e / 2] += s[j][e];
        }
      }
#pragma unroll
    for (int r = 0; r < (HALF ? 1 : 2); ++r) lrow[r] = lrow[r] * alpha[r] + sum[r];

    // This tile's P·V into a fresh accumulator, an 8-key block at a time
    // (lo·hi, hi·lo, hi·hi): A = P (a0 = key 2c of row g, a1 = of row g +
    // 8, a2 = key 2c + 1 of row g, a3 = of row g + 8), B = V [8 keys, 8
    // channels] with b0 = (key 2c, channel g), b1 = (key 2c + 1, channel g).
    float ot[2][4] = {};
#pragma unroll
    for (int j = 0; j < TK / 8; ++j) {
      uint32_t ph[4], pl[4];
      rat_hopper::split_tf32_bits(s[j][0], ph[0], pl[0]);
      rat_hopper::split_tf32_bits(s[j][2], ph[1], pl[1]);
      rat_hopper::split_tf32_bits(s[j][1], ph[2], pl[2]);
      rat_hopper::split_tf32_bits(s[j][3], ph[3], pl[3]);
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        const int at = (8 * nb + g) * LD + 8 * j + 2 * c;
        const float2 vh = *reinterpret_cast<const float2*>(svh + at);
        const float2 vl = *reinterpret_cast<const float2*>(svl + at);
        rat_hopper::mma_m16n8k8_tf32(ot[nb], pl, __float_as_uint(vh.x), __float_as_uint(vh.y));
        rat_hopper::mma_m16n8k8_tf32(ot[nb], ph, __float_as_uint(vl.x), __float_as_uint(vl.y));
        rat_hopper::mma_m16n8k8_tf32(ot[nb], ph, __float_as_uint(vh.x), __float_as_uint(vh.y));
      }
    }
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nb][e] = fmaf(o[nb][e], alpha[e / 2], ot[nb][e]);
  }

  // Finish the row sums across the quad and store rows < nrows.
#pragma unroll
  for (int r = 0; r < (HALF ? 1 : 2); ++r) {
    lrow[r] += __shfl_xor_sync(0xffffffffu, lrow[r], 1);
    lrow[r] += __shfl_xor_sync(0xffffffffu, lrow[r], 2);
    const int row = g + 8 * r;
    if (row < nrows) {
      float* dst = out + (size_t)(r0 + row) * d + h * HD + 2 * c;
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
        *reinterpret_cast<float2*>(dst + 8 * nb) =
            make_float2(o[nb][2 * r] / lrow[r], o[nb][2 * r + 1] / lrow[r]);
    }
  }
}

template <bool PE, bool SHARED>
int launch(const void* q, const float* kt, const float* vt, size_t kv_stride, const void* pe,
           const void* vb, void* out, int b, int n, int d, int m, int heads,
           cudaStream_t stream) {
  constexpr int smem = Cfg<SHARED>::SMEM;
  auto kernel = token_cross_kv_tf32x3_kernel<PE, SHARED>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = b * n;
  const dim3 grid = SHARED ? dim3((rows + WARPS * 16 - 1) / (WARPS * 16), heads)
                           : dim3(b, (heads + WARPS - 1) / WARPS);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), kt, vt, SHARED ? 0 : kv_stride,
      static_cast<const float*>(pe), static_cast<const float*>(vb), static_cast<float*>(out),
      rows, n, d, m, heads, LOG2E / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

template <bool PE>
int dispatch(const void* q, const float* kt, const float* vt, size_t kv_stride, const void* pe,
             const void* vb, void* out, int b, int n, int d, int m, int heads, int kv_shared,
             void* stream) {
  if (b < 1 || heads <= 0 || d != heads * HD || (n != 7 && n != 8) || m <= 0 || m % 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return kv_shared ? launch<PE, true>(q, kt, vt, 0, pe, vb, out, b, n, d, m, heads, s)
                   : launch<PE, false>(q, kt, vt, kv_stride, pe, vb, out, b, n, d, m, heads, s);
}

}  // namespace rat_k2f

// K2 in f32: the same arguments as rat_token_cross_kv, every tensor f32.
extern "C" int rat_token_cross_kv_f32(const void* q, const void* kvt, const void* pe,
                                      const void* vb, void* out, int b, int n, int d, int m,
                                      int heads, int kv_shared, void* stream) {
  const float* k = static_cast<const float*>(kvt);
  return rat_k2f::dispatch<true>(q, k, k + (size_t)d * m, (size_t)2 * d * m, pe, vb, out, b,
                                 n, d, m, heads, kv_shared, stream);
}

// B10 in f32: the same arguments as rat_token_cross, every tensor f32.
extern "C" int rat_token_cross_f32(const void* q, const void* kt, const void* vt, void* out,
                                   int b, int n, int d, int m, int heads, int kv_shared,
                                   void* stream) {
  return rat_k2f::dispatch<false>(q, static_cast<const float*>(kt),
                                  static_cast<const float*>(vt), (size_t)d * m, nullptr,
                                  nullptr, out, b, n, d, m, heads, kv_shared, stream);
}

// Dynamic shared memory a CTA of K2 f32's (and B10 f32's) shared (1) or
// per-prompt (0) schedule takes (for reports).
extern "C" int rat_token_cross_f32_smem(int shared) {
  return shared ? rat_k2f::Cfg<true>::SMEM : rat_k2f::Cfg<false>::SMEM;
}
