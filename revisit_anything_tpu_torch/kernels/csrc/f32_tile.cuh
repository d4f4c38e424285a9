// Pieces of the f32 form of K3 (mask_head.cu): a 64-row tile times a
// weight matrix in plain f32 FMAs on the CUDA cores, and the exact GELU.
//
// A CTA of 256 threads holds a tile A [64, K] in shared memory (row pitch
// lda floats) and computes A · W for W [K, N] row-major, N = 128 or 256.
// Thread t keeps acc[i][j] for row 8·(t / 32) + i and column t % 32 + 32·j
// in registers: a step over k reads 8 values of A (the same for the 32
// lanes of a warp: one broadcast each) and N / 32 of W (32 consecutive
// floats a warp: no bank conflict) for 8·N / 32 FMAs. Sums run over k in
// order, one fmaf a product, as true f32 (no TF32, no operand rounded).

#pragma once

#include <cuda_runtime.h>

namespace rat_f32 {

constexpr int TILE_THREADS = 256;
constexpr int TILE_ROWS = 64;
constexpr int WCHUNK = 32;               // W rows a chunk streamed through shared memory

// acc += A[:, k0:k0 + kc] · W[0:kc, :], W in shared memory with row pitch ldw.
template <int N>
__device__ __forceinline__ void tile_fma(float (&acc)[8][N / 32], const float* sa, int lda,
                                         int k0, int kc, const float* sw, int ldw) {
  const int tc = threadIdx.x % 32, r0 = 8 * (threadIdx.x / 32);
#pragma unroll 4
  for (int k = 0; k < kc; ++k) {
    float a[8], b[N / 32];
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] = sa[(r0 + i) * lda + k0 + k];
#pragma unroll
    for (int j = 0; j < N / 32; ++j) b[j] = sw[k * ldw + tc + 32 * j];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < N / 32; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc = A · W for W [K, N] in device memory (L2-resident: every CTA reads
// it), streamed through sw [WCHUNK, N] a chunk of rows at a time. Starts
// and ends with a barrier: A may be written just before the call and
// overwritten just after it.
template <int K, int N>
__device__ __forceinline__ void tile_gemm(float (&acc)[8][N / 32], const float* sa, int lda,
                                          const float* __restrict__ w, float* sw) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < N / 32; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += WCHUNK) {
    __syncthreads();
    for (int e = 4 * threadIdx.x; e < WCHUNK * N; e += 4 * TILE_THREADS)
      *reinterpret_cast<float4*>(sw + e) =
          *reinterpret_cast<const float4*>(w + (size_t)k0 * N + e);
    __syncthreads();
    tile_fma<N>(acc, sa, lda, k0, WCHUNK, sw, N);
  }
  __syncthreads();
}

// GELU in its exact form, x·Φ(x) = x/2·(1 + erf(x/√2)), as torch's gelu.
__device__ __forceinline__ float gelu_erf(float x) {
  return x * 0.5f * (1.f + erff(x * 0.70710678118654752f));
}

}  // namespace rat_f32
