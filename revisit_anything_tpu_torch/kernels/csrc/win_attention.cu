// Windowed multi-head attention with SAM's decomposed relative-position
// bias, one ViTDet window per grid row.
//
// Replaces: revisit_anything_tpu/ops/winattn.py `_win_attn_call` /
// `_win_attn_kernel` (pallas_call at :90, body :45), reached through
// `windowed_attend` (:112). For window b and head h, over N = side² tokens:
//   s[n, k] = q_h[n] . k_h[k] / sqrt(hd) + bh[n, h·side + k / side]
//                                        + bw[n, h·side + k % side]
//   out[b, n, h·hd:(h+1)·hd] = bf16(softmax_k(s)) . v_h
// with q, k, v read in place from the raw qkv projection [B, N, 3·D]
// (head h at channels h·hd, D + h·hd, 2·D + h·hd) and the bias components
// [B, N, heads·side] in head-major channels. Scores, bias sum and softmax
// are f32; the normalized probabilities are rounded to bf16 before the
// value product, as the TPU kernel rounds them.
//
// What bounds it on the H100: device-memory bytes. SAM ViT-H's 28
// windowed layers at 1024² run 25 windows x 16 heads of N = 196, hd = 80:
// 4.9 GFLOP a layer (5 us at the bf16 tensor-core rate) against 55 MB of
// qkv, bias and output (16 us at 3.35 TB/s). The TPU kernel held a whole
// window (all heads) in VMEM and expanded the bias with 0/1 matmuls.
//
// Design: one CTA per (query chunk, head, window). The window's keys and
// values for the head (N padded to a multiple of 16, padded rows zero)
// stay in shared memory; each warp owns 16 query rows and holds their
// whole score row block [16, Npad] in f32 shared memory, so the softmax
// is exact in one pass (no online rescaling): a full [196, 196] f32 tile
// (154 KB) does not fit beside K and V, so the query rows are split into
// as few chunks as shared memory allows (N = 196: two chunks of 7 warps,
// 800 CTAs at B = 25). q.kT and P.v run on WMMA bf16 16x16x16 fragments
// with f32 accumulation; the bias is gathered by index from the chunk's
// bias rows staged in shared memory (no expansion matmuls); keys past N
// are masked. The bf16 probabilities overwrite their own score row.
// Simple and correct first: wgmma/TMA are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <math.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int MAX_NPAD = 256;       // N <= 256 (side <= 16)
constexpr int MAX_SIDE = 16;
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory of one H100 CTA

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

// f32 score stride: a multiple of 4 floats (WMMA), wide enough for the
// [16, HD] output staging too.
__host__ __device__ __forceinline__ int score_ld(int npad, int hd) {
  return (npad > hd ? npad : hd) + 4;
}

__host__ __device__ __forceinline__ size_t smem_bytes(int warps, int npad, int hd, int side) {
  const int bq = 16 * warps;
  return (size_t)2 * npad * hd * 2         // K, V (bf16)
         + (size_t)bq * hd * 2             // Q (bf16)
         + (size_t)bq * score_ld(npad, hd) * 4   // scores / probabilities / output
         + (size_t)2 * bq * side * 4;      // bias rows (f32)
}

// rows [row0, row0 + rows) of one head's q, k or v slice of qkv ([N, 3D]
// row-major) -> dst [rows][HD] bf16; rows at or past n zero.
template <int HD>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int ld, int row0, int rows, int n) {
  constexpr int VPR = HD / 8;                  // 16-byte vectors a row
  for (int i = threadIdx.x; i < rows * VPR; i += blockDim.x) {
    const int r = i / VPR, c = i % VPR;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n) val = reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * ld)[c];
    reinterpret_cast<uint4*>(dst + r * HD)[c] = val;
  }
}

template <int HD>
__global__ void __launch_bounds__(32 * 16)
win_attention_kernel(const __nv_bfloat16* __restrict__ qkv,     // [B, N, 3D]
                     const __nv_bfloat16* __restrict__ bias_h,  // [B, N, heads·side]
                     const __nv_bfloat16* __restrict__ bias_w,
                     __nv_bfloat16* __restrict__ out,           // [B, N, D]
                     int n, int npad, int side, int heads, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warps = blockDim.x / 32;
  const int bq = 16 * warps;
  const int lds = score_ld(npad, HD);
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sV = sK + npad * HD;
  __nv_bfloat16* sQ = sV + npad * HD;
  float* sS = reinterpret_cast<float*>(sQ + bq * HD);
  float* sBh = sS + bq * lds;
  float* sBw = sBh + bq * side;

  const int q0 = blockIdx.x * bq;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int d = heads * HD;
  const __nv_bfloat16* base = qkv + (size_t)b * n * 3 * d + h * HD;

  load_rows<HD>(sK, base + d, 3 * d, 0, npad, n);
  load_rows<HD>(sV, base + 2 * d, 3 * d, 0, npad, n);
  load_rows<HD>(sQ, base, 3 * d, q0, bq, n);
  const size_t bstride = (size_t)heads * side;
  for (int i = threadIdx.x; i < bq * side; i += blockDim.x) {
    const int r = i / side, c = i % side;
    float vh = 0.f, vw = 0.f;
    if (q0 + r < n) {
      const size_t off = ((size_t)b * n + q0 + r) * bstride + h * side + c;
      vh = __bfloat162float(bias_h[off]);
      vw = __bfloat162float(bias_w[off]);
    }
    sBh[i] = vh;
    sBw[i] = vw;
  }
  __syncthreads();

  const int wr = warp * 16;                    // this warp's first query row
  float* sSw = sS + wr * lds;

  // S = Q K^T for the warp's 16 rows, every key tile.
  {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[HD / 16];
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wmma::load_matrix_sync(a[kk], sQ + wr * HD + kk * 16, HD);
    for (int j = 0; j < npad / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> kb;
        wmma::load_matrix_sync(kb, sK + j * 16 * HD + kk * 16, HD);
        wmma::mma_sync(acc, a[kk], kb, acc);
      }
      wmma::store_matrix_sync(sSw + j * 16, acc, lds, wmma::mem_row_major);
    }
  }
  __syncwarp();

  // Softmax row by row, exact over all keys; P (bf16) overwrites the
  // row's own f32 scores (ld 2·lds in bf16 elements).
  constexpr int MAXC = MAX_NPAD / 32;
  __nv_bfloat16* sPw = reinterpret_cast<__nv_bfloat16*>(sSw);
  for (int r = 0; r < 16; ++r) {
    const int row = wr + r;
    float s[MAXC];
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < MAXC; ++i) {
      const int c = lane + 32 * i;
      float val = -INFINITY;
      if (c < n)
        val = sSw[r * lds + c] * scale + sBh[row * side + c / side] + sBw[row * side + c % side];
      s[i] = val;
      mx = fmaxf(mx, val);
    }
    mx = warp_max(mx);
    float z = 0.f;
#pragma unroll
    for (int i = 0; i < MAXC; ++i) {
      s[i] = (lane + 32 * i < n) ? expf(s[i] - mx) : 0.f;
      z += s[i];
    }
    z = warp_sum(z);
    __syncwarp();                              // the row is read before it is overwritten
#pragma unroll
    for (int i = 0; i < MAXC; ++i) {
      const int c = lane + 32 * i;
      if (c < npad) sPw[r * 2 * lds + c] = __float2bfloat16(s[i] / z);
    }
  }
  __syncwarp();

  // O = P V for the warp's rows: all accumulators first, then the staging
  // store over the (consumed) probabilities.
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> o[HD / 16];
#pragma unroll
  for (int jj = 0; jj < HD / 16; ++jj) wmma::fill_fragment(o[jj], 0.f);
  for (int kk = 0; kk < npad; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> pa;
    wmma::load_matrix_sync(pa, sPw + kk, 2 * lds);
#pragma unroll
    for (int jj = 0; jj < HD / 16; ++jj) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> vb;
      wmma::load_matrix_sync(vb, sV + kk * HD + jj * 16, HD);
      wmma::mma_sync(o[jj], pa, vb, o[jj]);
    }
  }
  __syncwarp();
#pragma unroll
  for (int jj = 0; jj < HD / 16; ++jj)
    wmma::store_matrix_sync(sSw + jj * 16, o[jj], lds, wmma::mem_row_major);
  __syncwarp();

  for (int r = 0; r < 16; ++r) {
    const int qi = q0 + wr + r;
    if (qi >= n) break;
    __nv_bfloat16* orow = out + ((size_t)b * n + qi) * d + h * HD;
    for (int c = lane; c < HD; c += 32) orow[c] = __float2bfloat16(sSw[r * lds + c]);
  }
}

template <int HD>
int launch(const void* qkv, const void* bh, const void* bw, void* out, int b, int n,
           int side, int heads, float scale, cudaStream_t stream) {
  const int npad = (n + 15) / 16 * 16;
  const int tiles = npad / 16;
  // as many warps (16 query rows each) as fit, then the fewest chunks
  int wmax = 16;
  while (wmax > 1 && smem_bytes(wmax, npad, HD, side) > SMEM_LIMIT) --wmax;
  const int chunks = (tiles + wmax - 1) / wmax;
  const int warps = (tiles + chunks - 1) / chunks;
  const size_t smem = smem_bytes(warps, npad, HD, side);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      win_attention_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(chunks, heads, b);
  win_attention_kernel<HD><<<grid, 32 * warps, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<const __nv_bfloat16*>(bh),
      static_cast<const __nv_bfloat16*>(bw), static_cast<__nv_bfloat16*>(out), n, npad, side,
      heads, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rat_win_attention(const void* qkv, const void* bias_h, const void* bias_w,
                                 void* out, int b, int n, int side, int heads, int hd,
                                 float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b < 1 || heads < 1 || side < 1 || side > MAX_SIDE || n != side * side || n > MAX_NPAD)
    return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 64:
      return launch<64>(qkv, bias_h, bias_w, out, b, n, side, heads, scale, s);
    case 80:
      return launch<80>(qkv, bias_h, bias_w, out, b, n, side, heads, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
