// Flash attention with SAM's decomposed relative-position bias.
//
// Replaces: revisit_anything_tpu/ops/attention.py `_flash_attention` /
// `_attn_kernel` (pallas_call at :116), reached through `attend` (:561).
// softmax(q·kᵀ·scale + bias)·v over [B·H, N, Dh]; keys >= N are masked;
// the optional bias is bias[q, k] = bias_h[q, k / side] + bias_w[q, k % side].
//
// What bounds it on the H100: SAM ViT-H's global layers (N = 4096,
// Dh = 80, 16 heads) and DINOv2-g's blocks (N = 1531, Dh = 64, 24 heads)
// are compute-bound once the [N, N] scores stay off device memory: q·kᵀ
// and p·v are 2 · 2 · H · N² · Dh = 2 · 2 · 16 · 4096² · 80 = 86 GFLOP per
// SAM global layer. The TPU kernel held a whole [bq, N] score row in VMEM,
// which 227 KB of shared memory cannot.
//
// Design: one CTA per (batch·head, 64-query tile), four warps of 16 query
// rows each. K/V stream through shared memory in 64-key tiles with an
// online softmax in f32 (running max / sum per row in shared memory), so
// no score row is ever held whole. Both products run on the tensor cores
// through WMMA bf16 16x16x16 fragments with f32 accumulation. The bias is
// gathered by index from the q row's bias_h/bias_w rows (no 0/1 expansion
// matmuls), head dims 64 and 80 are native (no pad to 128), and the
// ragged key edge (N = 1531) is masked in the kernel. A simple correct
// kernel: wgmma/TMA pipelining is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <math.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;

template <int HD>
constexpr int smem_bytes() {
  return 3 * BQ * HD * 2      // Q, K, V tiles (bf16)
         + BQ * BK * 4        // scores (f32)
         + BQ * BK * 2        // probabilities (bf16)
         + BQ * HD * 4        // output accumulator (f32)
         + 2 * BQ * 4;        // running max / sum
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int HD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          int row0, int n) {
  constexpr int VPR = HD / 8;               // 16-byte vectors per row
  for (int i = threadIdx.x; i < BQ * VPR; i += THREADS) {
    const int r = i / VPR, c = i % VPR;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n)
      val = reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * HD)[c];
    reinterpret_cast<uint4*>(dst + r * HD)[c] = val;
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const __nv_bfloat16* __restrict__ bias_h,
                       const __nv_bfloat16* __restrict__ bias_w,
                       __nv_bfloat16* __restrict__ out,
                       int n, int side, int has_bias, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK = sQ + BQ * HD;
  __nv_bfloat16* sV = sK + BK * HD;
  float* sS = reinterpret_cast<float*>(sV + BK * HD);
  __nv_bfloat16* sP = reinterpret_cast<__nv_bfloat16*>(sS + BQ * BK);
  float* sO = reinterpret_cast<float*>(sP + BQ * BK);
  float* sM = sO + BQ * HD;
  float* sL = sM + BQ;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t base = (size_t)bh * n * HD;
  const size_t bbase = (size_t)bh * n * side;

  load_tile<HD>(sQ, q + base, q0, n);
  for (int i = threadIdx.x; i < BQ * HD; i += THREADS) sO[i] = 0.f;
  for (int i = threadIdx.x; i < BQ; i += THREADS) {
    sM[i] = -INFINITY;
    sL[i] = 0.f;
  }

  const int wr = warp * 16;                 // this warp's first query row
  for (int k0 = 0; k0 < n; k0 += BK) {
    __syncthreads();                        // previous tile fully consumed
    load_tile<HD>(sK, k + base, k0, n);
    load_tile<HD>(sV, v + base, k0, n);
    __syncthreads();

    // S = Q Kᵀ for this warp's 16 rows x 64 keys.
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BK / 16];
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
    for (int kk = 0; kk < HD; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a;
      wmma::load_matrix_sync(a, sQ + wr * HD + kk, HD);
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> b;
        wmma::load_matrix_sync(b, sK + j * 16 * HD + kk, HD);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < BK / 16; ++j)
      wmma::store_matrix_sync(sS + wr * BK + j * 16, acc[j], BK,
                              wmma::mem_row_major);
    __syncwarp();

    // Online softmax over the tile, one row at a time, two keys per lane.
    for (int r = 0; r < 16; ++r) {
      const int row = wr + r;
      const int qi = q0 + row;
      float s[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = lane + 32 * h;
        const int key = k0 + col;
        float val = sS[row * BK + col] * scale;
        if (key >= n) {
          val = -INFINITY;
        } else if (has_bias && qi < n) {
          val += __bfloat162float(bias_h[bbase + (size_t)qi * side + key / side]) +
                 __bfloat162float(bias_w[bbase + (size_t)qi * side + key % side]);
        }
        s[h] = val;
      }
      const float m_old = sM[row];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s[0], s[1])));
      const float p0 = expf(s[0] - m_new);
      const float p1 = expf(s[1] - m_new);
      const float psum = warp_sum(p0 + p1);
      const float alpha = (m_old == -INFINITY) ? 0.f : expf(m_old - m_new);
      sP[row * BK + lane] = __float2bfloat16(p0);
      sP[row * BK + lane + 32] = __float2bfloat16(p1);
      for (int c = lane; c < HD; c += 32) sO[row * HD + c] *= alpha;
      __syncwarp();
      if (lane == 0) {
        sM[row] = m_new;
        sL[row] = sL[row] * alpha + psum;
      }
    }
    __syncwarp();

    // O += P V for this warp's rows.
#pragma unroll
    for (int jj = 0; jj < HD / 16; ++jj) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> o;
      wmma::load_matrix_sync(o, sO + wr * HD + jj * 16, HD, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> b;
        wmma::load_matrix_sync(a, sP + wr * BK + kk, BK);
        wmma::load_matrix_sync(b, sV + kk * HD + jj * 16, HD);
        wmma::mma_sync(o, a, b, o);
      }
      wmma::store_matrix_sync(sO + wr * HD + jj * 16, o, HD, wmma::mem_row_major);
    }
  }
  __syncwarp();

  for (int r = 0; r < 16; ++r) {
    const int row = wr + r;
    const int qi = q0 + row;
    if (qi >= n) break;
    const float inv = 1.f / sL[row];
    for (int c = lane; c < HD; c += 32)
      out[base + (size_t)qi * HD + c] = __float2bfloat16(sO[row * HD + c] * inv);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* bh_,
           const void* bw_, void* out, int bh, int n, int side, int has_bias,
           float scale, cudaStream_t stream) {
  constexpr int smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + BQ - 1) / BQ, bh);
  flash_attention_kernel<HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(bh_),
      static_cast<const __nv_bfloat16*>(bw_), static_cast<__nv_bfloat16*>(out),
      n, side, has_bias, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rat_flash_attention(const void* q, const void* k, const void* v,
                                   const void* bias_h, const void* bias_w,
                                   void* out, int bh, int n, int side,
                                   int has_bias, float scale, int hd,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64:
      return launch<64>(q, k, v, bias_h, bias_w, out, bh, n, side, has_bias, scale, s);
    case 80:
      return launch<80>(q, k, v, bias_h, bias_w, out, bh, n, side, has_bias, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
