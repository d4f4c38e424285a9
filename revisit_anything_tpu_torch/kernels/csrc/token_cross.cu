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
// v = vt[b, h rows], nothing added. It reads the same bytes a key as the
// k|v form and is bound the same way.
//
// What bounds it on the H100: device-memory bytes. Each (prompt, head)
// reads 2·hd·M bf16 of k|v (256 KB) for ~0.9 MFLOP: per-prompt k|v at
// 1024 prompts is 2 GB a call, about 0.7 ms at 3.35 TB/s; the layer-1
// call shares one k|v (leading dim 1) and runs out of L2.
//
// Design: one CTA of 256 threads per (prompt, head). Each thread walks
// keys tid, tid+256, ... — neighbouring threads read neighbouring keys of
// the transposed [hd, M] rows, so every load is coalesced — and keeps an
// online-softmax state (max, sum, hd accumulators) per query in
// registers. States merge by warp shuffles, then across the 8 warps in
// shared memory. The 7 queries are taken unpadded (the TPU's pad to 8 was
// a sublane rule). pe and the v bias are added in the kernel, rounded to
// bf16 as the TPU kernel's bf16 adds round.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Merge online-softmax state (m_b, l_b, acc_b) into (m, l, acc).
template <int HD>
__device__ __forceinline__ void merge(float& m, float& l, float* acc,
                                      float m_b, float l_b, const float* acc_b) {
  const float m_new = fmaxf(m, m_b);
  const float a = (m == -INFINITY) ? 0.f : expf(m - m_new);
  const float b = (m_b == -INFINITY) ? 0.f : expf(m_b - m_new);
  l = l * a + l_b * b;
#pragma unroll
  for (int j = 0; j < HD; ++j) acc[j] = acc[j] * a + acc_b[j] * b;
  m = m_new;
}

// PE: k and v arrive as the halves of one projection with pe and the v
// bias added here; otherwise as separate tensors, used as they are.
template <int HD, int NQ, bool PE>
__global__ void __launch_bounds__(THREADS)
token_cross_kernel(const __nv_bfloat16* __restrict__ q,    // [B, NQ, D]
                   const __nv_bfloat16* __restrict__ kt,   // prompt 0's [D, M] keys
                   const __nv_bfloat16* __restrict__ vt,   // prompt 0's [D, M] values
                   size_t kv_stride,                       // elements a prompt; 0 = shared
                   const __nv_bfloat16* __restrict__ pe,   // [D, M] (PE only)
                   const __nv_bfloat16* __restrict__ vb,   // [D] (PE only)
                   __nv_bfloat16* __restrict__ out,        // [B, NQ, D]
                   int d, int m, float scale) {
  __shared__ float sq[NQ][HD];
  __shared__ float sm[WARPS][NQ];
  __shared__ float sl[WARPS][NQ];
  __shared__ float sacc[WARPS][NQ][HD];

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;

  for (int i = threadIdx.x; i < NQ * HD; i += THREADS)
    sq[i / HD][i % HD] =
        __bfloat162float(q[((size_t)b * NQ + i / HD) * d + h * HD + i % HD]);
  __syncthreads();

  const __nv_bfloat16* kb = kt + b * kv_stride + (size_t)h * HD * m;
  const __nv_bfloat16* vbp = vt + b * kv_stride + (size_t)h * HD * m;
  const __nv_bfloat16* pb = PE ? pe + (size_t)h * HD * m : nullptr;
  float vbias[HD];
#pragma unroll
  for (int j = 0; j < HD; ++j) vbias[j] = PE ? __bfloat162float(vb[h * HD + j]) : 0.f;

  float mrun[NQ], lrun[NQ], acc[NQ][HD];
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    mrun[i] = -INFINITY;
    lrun[i] = 0.f;
#pragma unroll
    for (int j = 0; j < HD; ++j) acc[i][j] = 0.f;
  }

  for (int key = threadIdx.x; key < m; key += THREADS) {
    float kf[HD];
#pragma unroll
    for (int j = 0; j < HD; ++j)
      kf[j] = PE ? bf16_round(__bfloat162float(kb[(size_t)j * m + key]) +
                              __bfloat162float(pb[(size_t)j * m + key]))
                 : __bfloat162float(kb[(size_t)j * m + key]);
    float p[NQ];
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < HD; ++j) s = fmaf(sq[i][j], kf[j], s);
      s *= scale;
      const float m_new = fmaxf(mrun[i], s);
      const float a = (mrun[i] == -INFINITY) ? 0.f : expf(mrun[i] - m_new);
      p[i] = expf(s - m_new);
      lrun[i] = lrun[i] * a + p[i];
#pragma unroll
      for (int j = 0; j < HD; ++j) acc[i][j] *= a;
      mrun[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < HD; ++j) {
      const float vf = PE ? bf16_round(__bfloat162float(vbp[(size_t)j * m + key]) + vbias[j])
                          : __bfloat162float(vbp[(size_t)j * m + key]);
#pragma unroll
      for (int i = 0; i < NQ; ++i) acc[i][j] = fmaf(p[i], vf, acc[i][j]);
    }
  }

  // Merge the 32 lanes' states by shuffles.
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      const float m_b = __shfl_xor_sync(0xffffffffu, mrun[i], off);
      const float l_b = __shfl_xor_sync(0xffffffffu, lrun[i], off);
      float acc_b[HD];
#pragma unroll
      for (int j = 0; j < HD; ++j)
        acc_b[j] = __shfl_xor_sync(0xffffffffu, acc[i][j], off);
      merge<HD>(mrun[i], lrun[i], acc[i], m_b, l_b, acc_b);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      sm[warp][i] = mrun[i];
      sl[warp][i] = lrun[i];
#pragma unroll
      for (int j = 0; j < HD; ++j) sacc[warp][i][j] = acc[i][j];
    }
  }
  __syncthreads();

  // Merge the warps: one thread per (query, channel).
  if (threadIdx.x < NQ * HD) {
    const int i = threadIdx.x / HD, j = threadIdx.x % HD;
    float mx = -INFINITY;
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, sm[w][i]);
    float l = 0.f, a = 0.f;
    for (int w = 0; w < WARPS; ++w) {
      const float e = (sm[w][i] == -INFINITY) ? 0.f : expf(sm[w][i] - mx);
      l += sl[w][i] * e;
      a += sacc[w][i][j] * e;
    }
    out[((size_t)b * NQ + i) * d + h * HD + j] = __float2bfloat16(a / l);
  }
}

template <int HD, int NQ, bool PE>
int launch(const void* q, const void* kt, const void* vt, size_t kv_stride, const void* pe,
           const void* vb, void* out, int b, int d, int m, int heads, cudaStream_t stream) {
  dim3 grid(b, heads);
  token_cross_kernel<HD, NQ, PE><<<grid, THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(kt),
      static_cast<const __nv_bfloat16*>(vt), kv_stride, static_cast<const __nv_bfloat16*>(pe),
      static_cast<const __nv_bfloat16*>(vb), static_cast<__nv_bfloat16*>(out), d, m,
      1.f / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

template <bool PE>
int dispatch(const void* q, const void* kt, const void* vt, size_t kv_stride, const void* pe,
             const void* vb, void* out, int b, int n, int d, int m, int heads,
             cudaStream_t s) {
  if (heads <= 0 || d % heads != 0 || d / heads != 16) return (int)cudaErrorInvalidValue;
  if (n == 7) return launch<16, 7, PE>(q, kt, vt, kv_stride, pe, vb, out, b, d, m, heads, s);
  if (n == 8) return launch<16, 8, PE>(q, kt, vt, kv_stride, pe, vb, out, b, d, m, heads, s);
  return (int)cudaErrorInvalidValue;
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
