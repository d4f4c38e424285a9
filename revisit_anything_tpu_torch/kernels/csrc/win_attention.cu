// Windowed multi-head attention with SAM's decomposed relative-position
// bias, one ViTDet window per grid row.
//
// Replaces: revisit_anything_tpu/ops/winattn.py `_win_attn_call` /
// `_win_attn_kernel` (pallas_call at :90, body :45), reached through
// `windowed_attend` (:112). For window b and head h, over N = side² tokens:
//   s[n, k] = q_h[n] . k_h[k] / sqrt(hd) + bh[n, h·side + k / side]
//                                        + bw[n, h·side + k % side]
//   out[b, n, h·hd:(h+1)·hd] = softmax_k(s) . v_h
// with q, k, v read in place from the raw qkv projection [B, N, 3·D]
// (head h at channels h·hd, D + h·hd, 2·D + h·hd) and the bias components
// [B, N, heads·side] in head-major channels. Scores, bias sum and softmax
// are f32, both products bf16 on the tensor cores with f32 accumulation.
//
// What bounds it on the H100: device-memory bytes. SAM ViT-H's 28
// windowed layers at 1024² run 25 windows x 16 heads of N = 196, hd = 80:
// 4.9 GFLOP a layer (5 us at the bf16 tensor-core rate) against 55 MB of
// qkv, bias and output (16 us at 3.35 TB/s); 31 M exponentials a layer
// (~8 us at the SFUs' 16 a clock an SM). Nothing of it is large, so what
// a design must avoid is latency: idle SMs while a window loads. As
// built it is latency-bound (NVIDIA H100 80GB HBM3, 700.00 W, measured
// with kernels/winattn_variants.py): 0.062 ms at that shape, of which the
// second round of row tiles takes ~21 us and the round-start fragment
// loads ~9 us; one (window, head) alone takes ~22 us.
//
// Design: one CTA per (window, head), up to 7 warps; a warp owns 16
// query rows at a time and takes the window's row tiles in rounds (N =
// 196: 13 row tiles, 7 warps, 2 rounds). The head's K and V (N rounded
// up to 16 keys, padded rows zero) are copied once into shared memory by
// cp.async, one commit group per 32-key tile, so the first tile's
// products start while the later tiles are in flight; rows padded by 16
// bytes keep ldmatrix free of bank conflicts. Two CTAs share an SM (89.9
// KB of shared memory at N = 196, hd 80; 128 registers a thread), so one
// CTA's loads also run under the other's products. Every
// later round reads the resident K and V: each is read from device
// memory once per (window, head). Only when K|V exceed shared memory
// (side >= 22 at hd 80, side >= 25 at hd 64: global grids of small
// encoders, never SAM ViT-H's windows) does the CTA stream them in key
// blocks, once per round, through L2.
// Both products run on mma.sync m16n8k16 (bf16 in, f32 out) with the FA2
// register layout: Q (its A fragments straight from device memory), S,
// P and O stay in registers; K is the B operand of Q·Kᵀ by ldmatrix, V
// of P·V by ldmatrix.trans. No score tile goes through shared memory.
// The bias is a third product on the tensor cores, as the TPU kernel
// makes it: the row's [bh | bw] (2·side bf16 columns, A fragments from
// device memory) times a 0/1 expansion matrix E [key, 2·side] built once
// in shared memory, which sums bh[row, key / side] + bw[row, key % side]
// exactly in f32, in place of a per-score gather from shared memory.
// Keys past N score -inf; query rows past N load as zeros and are not
// stored.
//
// Softmax: form (a), online over 32-key tiles in the log2 domain (one
// exp2 a score, one rescale of O a tile). P is rounded to bf16 as
// bf16(exp(s - m_running)) before the value product, and the f32 row sum
// (of the unrounded exponentials) divides O at the end: the TPU kernel
// rounds bf16(exp(s - m) / z) instead, a difference within the port's
// 2e-2 relative tolerance.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int MAX_SIDE = 31;                 // N = side² <= 961 < 1024
constexpr int MAX_WARPS = 7;                // 2 CTAs an SM at 128 registers
constexpr int TK = 32;                       // keys a tile
constexpr int SMEM_LIMIT = 232448;           // dynamic shared memory of one H100 CTA
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes, zero-filled when !valid (the bias rows: 4-byte aligned only)
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `pending` of this thread's groups are in flight (more
// than 7 waits for 7: stricter, still right).
__device__ __forceinline__ void cp_async_wait_upto(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
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

// How a launch cuts the work: warps a CTA (each takes the window's row
// tiles in rounds), keys a resident K|V|E block (the whole padded window
// when it fits), shared bytes.
struct Plan {
  int warps, kblk;
  size_t smem;
};

// k16 steps of the bias product: its depth is 2·side (bh | bw columns).
__host__ __device__ constexpr int bias_steps(int side) { return (2 * side + 15) / 16; }

template <int HD>
Plan plan(int n, int side) {
  const int npad = (n + 15) / 16 * 16;
  const int tiles = npad / 16;
  Plan p;
  const int rounds = (tiles + MAX_WARPS - 1) / MAX_WARPS;
  p.warps = (tiles + rounds - 1) / rounds;
  const size_t per_key = (size_t)(2 * (HD + 8) + bias_steps(side) * 16 + 8) * 2;
  const int fit = (int)(SMEM_LIMIT / per_key) / TK * TK;
  p.kblk = npad <= fit ? npad : fit;
  p.smem = per_key * p.kblk;
  return p;
}

template <int HD, int EK>
__global__ void __launch_bounds__(MAX_WARPS * 32, 2)
win_attention_kernel(const __nv_bfloat16* __restrict__ qkv,     // [B, N, 3D]
                     const __nv_bfloat16* __restrict__ bias_h,  // [B, N, heads·side]
                     const __nv_bfloat16* __restrict__ bias_w,
                     __nv_bfloat16* __restrict__ out,           // [B, N, D]
                     int n, int side, int heads, int kblk, float scale_log2) {
  constexpr int LDS = HD + 8;                // padded smem row of K, V (elements)
  constexpr int LDE = EK * 16 + 8;           // padded smem row of E
  constexpr int KS = HD / 16;                // k16 steps of Q·Kᵀ; n16 groups of P·V
  constexpr int VPR = HD / 8;                // 16-byte chunks a K or V row
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sV = sK + (size_t)kblk * LDS;
  __nv_bfloat16* sE = sV + (size_t)kblk * LDS;

  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4, mi = lane / 8, rr = lane % 8;
  const int h = blockIdx.x % heads, b = blockIdx.x / heads;
  const int d = heads * HD;
  const size_t ld = (size_t)3 * d;
  const __nv_bfloat16* base = qkv + (size_t)b * n * ld + h * HD;
  const int npad = (n + 15) / 16 * 16;
  const int nblk = (npad + kblk - 1) / kblk;
  const int rounds = (npad / 16 + warps - 1) / warps;
  const size_t bstride = (size_t)heads * side;

  for (int round = 0; round < rounds; ++round) {
    const int row0 = (round * warps + warp) * 16;
    const bool active = row0 < npad;         // warp-uniform
    uint32_t qa[KS][4], ab[EK][4];
    float o[2 * KS][4];
#pragma unroll
    for (int j = 0; j < 2 * KS; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
    float mrow[2] = {-INFINITY, -INFINITY}, lrow[2] = {0.f, 0.f};
    if (active) {
      // A fragments of Q and of the bias rows [bh | bw] (2·side columns,
      // zero past them and on rows past N): rows g and g+8, cols 2c.. and
      // 2c+8.. of each k16 step, straight from device memory.
      const bool v0 = row0 + g < n, v1 = row0 + g + 8 < n;
      const __nv_bfloat16* q0 = base + (size_t)(row0 + g) * ld + 2 * c;
      const __nv_bfloat16* q1 = q0 + 8 * ld;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        qa[kk][0] = ld_u32(q0 + kk * 16, v0);
        qa[kk][1] = ld_u32(q1 + kk * 16, v1);
        qa[kk][2] = ld_u32(q0 + kk * 16 + 8, v0);
        qa[kk][3] = ld_u32(q1 + kk * 16 + 8, v1);
      }
      auto bias_at = [&](int row, int col) -> uint32_t {
        if (row >= n || col >= 2 * side) return 0u;
        const __nv_bfloat16* src = col < side ? bias_h : bias_w;
        const int cc = col < side ? col : col - side;
        return __bfloat16_as_ushort(src[((size_t)b * n + row) * bstride + h * side + cc]);
      };
#pragma unroll
      for (int ke = 0; ke < EK; ++ke) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int row = row0 + g + 8 * (q & 1), col = ke * 16 + 2 * c + 8 * (q >> 1);
          ab[ke][q] = bias_at(row, col) | (bias_at(row, col + 1) << 16);
        }
      }
    }

    for (int blk = 0; blk < nblk; ++blk) {
      const int k0 = blk * kblk;
      const int nk = min(kblk, npad - k0);
      const int ntile = (nk + TK - 1) / TK;
      const bool fresh = nblk > 1 || round == 0;
      if (fresh) {
        __syncthreads();                     // the buffers' last readers are done
        for (int t = 0; t < ntile; ++t) {
          const int rows = min(TK, nk - t * TK);
          for (int i = threadIdx.x; i < rows * 2 * VPR; i += blockDim.x) {
            const int r = i / (2 * VPR), rem = i - r * 2 * VPR;
            const int mat = rem / VPR, ch = rem - mat * VPR;
            const int key = k0 + t * TK + r;
            const bool valid = key < n;      // padded rows: zero fill
            const __nv_bfloat16* src =
                base + (size_t)(mat + 1) * d + (size_t)(valid ? key : 0) * ld + ch * 8;
            cp_async16((mat ? sV : sK) + (t * TK + r) * LDS + ch * 8, src, valid);
          }
          cp_async_commit();
        }
        // E [key, 2·side]: the 0/1 expansion of the bias, e[k, k / side] =
        // e[k, side + k % side] = 1, so [bh | bw]·Eᵀ = bh[·, k / side] +
        // bw[·, k % side] exactly (two bf16 terms summed in f32). Written
        // while the copies fly; the first tile's barrier publishes it.
        for (int i = threadIdx.x; i < nk * 2 * EK; i += blockDim.x) {
          const int r = i / (2 * EK), ch = i - r * 2 * EK;
          const int key = k0 + r, kh = key / side, kw = key - kh * side;
          uint32_t w[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            uint32_t pair = 0u;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = ch * 8 + 2 * q + e;
              if (col == kh || col == side + kw) pair |= 0x3F80u << (16 * e);
            }
            w[q] = pair;
          }
          *reinterpret_cast<uint4*>(sE + r * LDE + ch * 8) = make_uint4(w[0], w[1], w[2], w[3]);
        }
      }
      for (int t = 0; t < ntile; ++t) {
        if (fresh) {
          cp_async_wait_upto(ntile - 1 - t); // own copies of tiles 0..t landed
          __syncthreads();                   // everyone's
        }
        if (!active) continue;
        const int key0 = k0 + t * TK;
        const int nch = min(TK / 16, (k0 + nk - key0) / 16);   // 16-key chunks here
        const __nv_bfloat16* tK = sK + (size_t)t * TK * LDS;
        const __nv_bfloat16* tV = sV + (size_t)t * TK * LDS;
        const __nv_bfloat16* tE = sE + (size_t)t * TK * LDE;

        // x = (Q·Kᵀ·scale + [bh | bw]·Eᵀ)·log2 e over the tile's chunks; K's
        // and E's [8 keys, 8 columns] blocks by ldmatrix.
        float s[TK / 8][4];
#pragma unroll
        for (int jj = 0; jj < TK / 16; ++jj) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[2 * jj][e] = s[2 * jj + 1][e] = 0.f;
          if (jj < nch) {
#pragma unroll
            for (int kk = 0; kk < KS; ++kk) {
              uint32_t bk[4];
              ldsm_x4(bk, tK + (jj * 16 + (mi >> 1) * 8 + rr) * LDS + kk * 16 + (mi & 1) * 8);
              mma16816(s[2 * jj], qa[kk], bk[0], bk[1]);
              mma16816(s[2 * jj + 1], qa[kk], bk[2], bk[3]);
            }
            float sb[2][4] = {};
#pragma unroll
            for (int ke = 0; ke < EK; ++ke) {
              uint32_t be[4];
              ldsm_x4(be, tE + (jj * 16 + (mi >> 1) * 8 + rr) * LDE + ke * 16 + (mi & 1) * 8);
              mma16816(sb[0], ab[ke], be[0], be[1]);
              mma16816(sb[1], ab[ke], be[2], be[3]);
            }
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                s[2 * jj + i][e] = fmaf(s[2 * jj + i][e], scale_log2, sb[i][e] * LOG2E);
          }
        }
        if (key0 + TK > n) {                 // keys past N (and skipped chunks): -inf
#pragma unroll
          for (int j = 0; j < TK / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (key0 + j * 8 + 2 * c + (e & 1) >= n) s[j][e] = -INFINITY;
        }

        // Online softmax over the tile: rows g (r = 0) and g + 8 (r = 1).
        float alpha[2], m_new[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mx = -INFINITY;
#pragma unroll
          for (int j = 0; j < TK / 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          m_new[r] = fmaxf(mrow[r], mx);     // finite: every tile holds a key < N
          alpha[r] = ex2(mrow[r] - m_new[r]);  // 0 on the first tile
          mrow[r] = m_new[r];
        }
        float sum[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < TK / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[j][e] = ex2(s[j][e] - m_new[e / 2]);
            sum[e / 2] += s[j][e];
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          lrow[r] = lrow[r] * alpha[r] + sum[r];
#pragma unroll
          for (int j = 0; j < 2 * KS; ++j) {
            o[j][2 * r] *= alpha[r];
            o[j][2 * r + 1] *= alpha[r];
          }
        }

        // O += bf16(P)·V; V's [8 keys, 8 hd] blocks by ldmatrix.trans.
#pragma unroll
        for (int kk = 0; kk < TK / 16; ++kk) {
          if (kk < nch) {
            const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                    pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                    pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                    pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
            for (int jj = 0; jj < KS; ++jj) {
              uint32_t bv[4];
              ldsm_x4_trans(bv, tV + (kk * 16 + (mi & 1) * 8 + rr) * LDS + jj * 16 + (mi >> 1) * 8);
              mma16816(o[2 * jj], pa, bv[0], bv[1]);
              mma16816(o[2 * jj + 1], pa, bv[2], bv[3]);
            }
          }
        }
      }
    }

    if (active) {
      // Finish the row sums across the quad; store rows < N.
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        lrow[r] += __shfl_xor_sync(0xffffffffu, lrow[r], 1);
        lrow[r] += __shfl_xor_sync(0xffffffffu, lrow[r], 2);
        const int row = row0 + g + 8 * r;
        if (row < n) {
          const float inv = 1.f / lrow[r];
          __nv_bfloat16* orow = out + ((size_t)b * n + row) * d + h * HD + 2 * c;
#pragma unroll
          for (int j = 0; j < 2 * KS; ++j)
            *reinterpret_cast<uint32_t*>(orow + j * 8) =
                pack_bf16(o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
        }
      }
    }
  }
}

template <int HD, int EK>
int launch_ek(const void* qkv, const void* bh, const void* bw, void* out, int b, int n,
              int side, int heads, float scale, cudaStream_t stream) {
  const Plan p = plan<HD>(n, side);
  auto kernel = win_attention_kernel<HD, EK>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<b * heads, 32 * p.warps, p.smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<const __nv_bfloat16*>(bh),
      static_cast<const __nv_bfloat16*>(bw), static_cast<__nv_bfloat16*>(out), n, side, heads,
      p.kblk, scale * LOG2E);
  return (int)cudaGetLastError();
}

template <int HD>
int launch(const void* qkv, const void* bh, const void* bw, void* out, int b, int n,
           int side, int heads, float scale, cudaStream_t s) {
  switch (bias_steps(side)) {
    case 1: return launch_ek<HD, 1>(qkv, bh, bw, out, b, n, side, heads, scale, s);
    case 2: return launch_ek<HD, 2>(qkv, bh, bw, out, b, n, side, heads, scale, s);
    case 3: return launch_ek<HD, 3>(qkv, bh, bw, out, b, n, side, heads, scale, s);
    default: return launch_ek<HD, 4>(qkv, bh, bw, out, b, n, side, heads, scale, s);
  }
}

bool takes(int n, int side, int hd) {
  return side >= 1 && side <= MAX_SIDE && n == side * side && (hd == 64 || hd == 80);
}

}  // namespace

extern "C" int rat_win_attention(const void* qkv, const void* bias_h, const void* bias_w,
                                 void* out, int b, int n, int side, int heads, int hd,
                                 float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b < 1 || heads < 1 || !takes(n, side, hd)) return (int)cudaErrorInvalidValue;
  if (hd == 64) return launch<64>(qkv, bias_h, bias_w, out, b, n, side, heads, scale, s);
  return launch<80>(qkv, bias_h, bias_w, out, b, n, side, heads, scale, s);
}

// Dynamic shared memory a CTA takes at window side `side` and head dim
// `hd` (for reports); -1 for a shape the kernel does not take.
extern "C" int rat_win_attention_smem(int side, int hd) {
  if (!takes(side * side, side, hd)) return -1;
  return (int)(hd == 64 ? plan<64>(side * side, side) : plan<80>(side * side, side)).smem;
}

// ---------------------------------------------------------------------------
// B11 in f32 (entry rat_win_attention_f32): the same function on f32 qkv,
// bias_h, bias_w and out, for an f32 SAM with window_attention="kernel".
// The TPU kernel computes in its inputs' dtype: the probabilities stay f32
// (it rounds p to qkv.dtype), and so do the scores, the bias and the
// softmax.
//
// What bounds it on the H100: device-memory bytes. SAM ViT-H's windowed
// layer (25 windows x 16 heads of N = 196, hd 80) moves 109 MB a call
// (qkv 75 MB, bias 8.8 MB, out 25 MB; 0.033 ms at 3.35 TB/s) against 4.9
// GFLOP, as three TF32 passes 14.7 GFLOP (0.030 ms at 495 TFLOP/s). Both
// are small, and mma.sync does not reach the tensor cores' wgmma rate, so
// what the design must keep low is what each warp reads from shared
// memory and the work a warp repeats. As built it is latency-bound
// (NVIDIA H100 80GB HBM3, 700.00 W, kernels/winattn_variants.py --f32):
// 0.238 ms at that shape, where one (window, head) alone takes 0.033 ms,
// about a CTA's time in each of the ~7 waves of 2 CTAs an SM; without the
// tile split it takes 20% less, without Q·Kᵀ's products 14%, without the
// bias 10%.
//
// Precision: split TF32, as K2 f32 (token_cross.cu rat_k2f): an f32
// operand x is cut into hi = tf32_rna(x) and lo = tf32_rna(x - hi), and a
// product is lo·hi + hi·lo + hi·hi on the tensor cores. S = Q·Kᵀ keeps
// hi·hi and the two cross passes in two fresh accumulators a tile (an
// 8-key block each), added in f32 at the end (mma.sync accumulates
// without rounding to nearest, so the large hi·hi sum never takes the
// small terms). P·V takes each tile's three passes into fresh
// accumulators (an 8-channel block each), joined to the running O by an
// FMA (P·V straight into O was 1.1e-5 off at side 31). The
// bias is added on the FMA units in f32: a single TF32 pass of bf16 B11's
// 0/1 expansion product would round bh and bw to 10 mantissa bits.
//
// Design: bf16 B11's register layout (FA2 on mma.sync, now m16n8k8 in
// TF32: a warp owns 16 query rows, Q's hi and lo fragments are split once
// in registers, S, P and O stay in registers) with K and V streamed.
// Resident f32 K|V of a window (N 196, hd 80: 133 KB) would hold one CTA
// an SM, and their hi and lo planes (266 KB) do not fit at all. So:
//  - 32-key tiles of K and V stream through a 2-stage cp.async ring, and
//    each tile is split once into hi and lo planes by the threads that
//    copied it (K2 f32's way), so every warp reads ready TF32 fragments.
//    Any side streams: there is no separate path for wide windows.
//  - A CTA takes one row group of a (window, head): up to 4 warps of 16
//    rows, one round (N = 196: 13 row tiles in groups of 4, 4, 4 and 1).
//    Two CTAs share an SM: 8 warps may hold up to 255 registers a thread
//    (Q's hi and lo planes are 80 at hd 80, O and P·V's accumulators 80
//    more; 240 in all, no spills), where 10 warps would cap them at 168
//    and spill (5-warp CTAs: 0.255 ms). Each group streams the head's K
//    and V once; the groups of one (window, head) run side by side, so
//    the later ones read them from L2.
//  - Q·Kᵀ's channels are taken in the order 0, 2, 4, 6, 1, 3, 5, 7 of each
//    8 (the same for A and B, so the sum is unchanged): a thread's A
//    fragment and K's B fragment are then 8-byte loads. K rows are padded
//    to hd + 8 floats and V rows to hd + 4, so K's 8-byte and V's 4-byte
//    fragment loads are free of bank conflicts. S's accumulator is P's A
//    fragment as it lies (keys 2c and 2c + 1 of each 8, K2 f32's trick);
//    P·V runs an 8-key block at a time over all channel blocks, so its
//    hd / 8 accumulators are independent chains.
//  - The bias: each warp stages its 16 rows of [bh | bw] in shared
//    memory once (4-byte cp.async beside tile 0), and a table gives each
//    key its two columns (key / side, side + key % side), so a score takes
//    two shared loads, an add, a multiply and an FMA.
//  - The online softmax runs in base 2 in registers (log2 e folded into
//    the scale; one exponential a score, one rescale of O a tile). Keys
//    past N score -inf (their rows load as zeros); 8-key blocks wholly
//    past N are skipped; query rows past N load as zeros and are not
//    stored.
namespace rat_b11f {

constexpr int TK = 32;                       // keys a ring tile
constexpr int STAGES = 2;
constexpr int MAX_WARPS = 4;                 // 2 CTAs an SM: 8 warps, <= 255 registers

template <int HD>
struct Cfg {
  static constexpr int LDK = HD + 8;         // LDK % 32 in {8, 24}: 8-byte K loads
  static constexpr int LDV = HD + 4;         // LDV % 16 == 4: 4-byte V loads
  static constexpr int STAGE = 2 * TK * (LDK + LDV);   // floats: K hi, K lo, V hi, V lo
  static constexpr int CPR = HD / 4;         // 16-byte chunks a K or V row
};

// How a launch cuts the work: row groups a (window, head), warps a CTA,
// the bias rows' pitch (floats), shared bytes.
struct Plan {
  int groups, warps, bpitch;
  size_t smem;
};

template <int HD>
Plan plan(int n, int side) {
  const int tiles = (n + 15) / 16;
  Plan p;
  p.groups = (tiles + MAX_WARPS - 1) / MAX_WARPS;
  p.warps = (tiles + p.groups - 1) / p.groups;
  p.bpitch = 2 * side + 1;
  const int npad = (n + TK - 1) / TK * TK;
  p.smem = ((size_t)STAGES * Cfg<HD>::STAGE + (size_t)p.warps * 16 * p.bpitch + npad) * 4;
  return p;
}

template <int HD>
__global__ void __launch_bounds__(MAX_WARPS * 32, 2)
win_attention_tf32x3_kernel(const float* __restrict__ qkv,     // [B, N, 3D]
                            const float* __restrict__ bias_h,  // [B, N, heads·side]
                            const float* __restrict__ bias_w,
                            float* __restrict__ out,           // [B, N, D]
                            int n, int side, int heads, int groups, int bpitch,
                            float scale_log2) {
  using C = Cfg<HD>;
  constexpr int LDK = C::LDK, LDV = C::LDV, STAGE = C::STAGE, CPR = C::CPR;
  constexpr int KS = HD / 8;                 // k8 steps of Q·Kᵀ; n8 blocks of P·V
  using rat_hopper::mma_m16n8k8_tf32;
  using rat_hopper::split_tf32_bits;
  extern __shared__ __align__(16) float smw[];

  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int grp = blockIdx.x % groups, wh = blockIdx.x / groups;
  const int h = wh % heads, b = wh / heads;
  const int d = heads * HD;
  const size_t ld = (size_t)3 * d;
  const float* base = qkv + (size_t)b * n * ld + h * HD;
  const int row0 = (grp * warps + warp) * 16;
  const bool active = row0 < n;              // warp-uniform
  const int ntiles = (n + TK - 1) / TK;
  float* ring = smw;
  float* sbias = ring + STAGES * STAGE;      // [warps·16, bpitch]: bh | bw
  uint32_t* kidx = reinterpret_cast<uint32_t*>(sbias + warps * 16 * bpitch);

  // A thread copies, and then splits, the same chunks of every tile: chunk
  // i = (matrix, key row, 16-byte column) for i = threadIdx.x, + blockDim.x,
  // ...; its place in the stage of tile t (the hi plane of K or V).
  auto chunk = [&](int t, int i) -> float* {
    const int r = (i / CPR) % TK, ch = i % CPR;
    float* st = ring + (t % STAGES) * STAGE;
    return i < TK * CPR ? st + r * LDK + ch * 4 : st + 2 * TK * LDK + r * LDV + ch * 4;
  };
  auto load_tile = [&](int t) {                // keys past N load as zeros
    if (t < ntiles) {
      for (int i = threadIdx.x; i < 2 * TK * CPR; i += blockDim.x) {
        const int mat = i / (TK * CPR), key = t * TK + (i / CPR) % TK;
        const bool valid = key < n;
        cp_async16(chunk(t, i),
                   base + (size_t)(mat + 1) * d + (size_t)(valid ? key : 0) * ld + (i % CPR) * 4,
                   valid);
      }
    }
    cp_async_commit();
  };
  // hi in place, lo one plane further (TK rows of the same pitch)
  auto split_tile = [&](int t) {
    for (int i = threadIdx.x; i < 2 * TK * CPR; i += blockDim.x) {
      float* x = chunk(t, i);
      float* lo = x + TK * (i < TK * CPR ? LDK : LDV);
      const float4 v = *reinterpret_cast<const float4*>(x);
      uint32_t hi4[4], lo4[4];
      split_tf32_bits(v.x, hi4[0], lo4[0]);
      split_tf32_bits(v.y, hi4[1], lo4[1]);
      split_tf32_bits(v.z, hi4[2], lo4[2]);
      split_tf32_bits(v.w, hi4[3], lo4[3]);
      *reinterpret_cast<uint4*>(x) = make_uint4(hi4[0], hi4[1], hi4[2], hi4[3]);
      *reinterpret_cast<uint4*>(lo) = make_uint4(lo4[0], lo4[1], lo4[2], lo4[3]);
    }
  };

  // The warp's 16 bias rows [bh | bw] (zero past N) by 4-byte cp.async, in
  // tile 0's group; each key's two bias columns while they fly. The first
  // barrier publishes both.
  {
    const size_t bstride = (size_t)heads * side;
    float* mine = sbias + warp * 16 * bpitch;
    for (int i = lane; i < 16 * 2 * side; i += 32) {
      const int r = i / (2 * side), col = i - r * 2 * side;
      const int row = row0 + r;
      const bool valid = row < n;
      const float* src = (col < side ? bias_h + col : bias_w + col - side) +
                         ((size_t)b * n + (valid ? row : 0)) * bstride + h * side;
      cp_async4(mine + r * bpitch + col, src, valid);
    }
  }
  load_tile(0);
  for (int key = threadIdx.x; key < ntiles * TK; key += blockDim.x) {
    const int kh = key / side, kw = key - kh * side;
    kidx[key] = key < n ? (uint32_t)kh | ((uint32_t)(side + kw) << 16) : 0u;
  }

  // Q's fragments (A of Q·Kᵀ), split once: rows g and g + 8 of the warp's
  // 16, channels 8ks + 2c (a0, a1) and 8ks + 2c + 1 (a2, a3).
  uint32_t qh[KS][4], ql[KS][4];
  {
    const bool v0 = row0 + g < n, v1 = row0 + g + 8 < n;
    const float* q0 = base + (size_t)(row0 + g) * ld + 2 * c;
    const float* q1 = q0 + 8 * ld;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const float2 x0 = v0 ? *reinterpret_cast<const float2*>(q0 + 8 * ks) : make_float2(0.f, 0.f);
      const float2 x1 = v1 ? *reinterpret_cast<const float2*>(q1 + 8 * ks) : make_float2(0.f, 0.f);
      split_tf32_bits(x0.x, qh[ks][0], ql[ks][0]);
      split_tf32_bits(x1.x, qh[ks][1], ql[ks][1]);
      split_tf32_bits(x0.y, qh[ks][2], ql[ks][2]);
      split_tf32_bits(x1.y, qh[ks][3], ql[ks][3]);
    }
  }

  float o[KS][4];                            // O: channels 8nb + 2c, + 1 of rows g, g + 8
#pragma unroll
  for (int nb = 0; nb < KS; ++nb) o[nb][0] = o[nb][1] = o[nb][2] = o[nb][3] = 0.f;
  float mrow[2] = {-INFINITY, -INFINITY}, lrow[2] = {0.f, 0.f};
  const float* brow[2] = {sbias + (warp * 16 + g) * bpitch, sbias + (warp * 16 + g + 8) * bpitch};

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait_upto(0);                   // own chunks of tile t landed
    split_tile(t);
    __syncthreads();                         // tile t split; tile t - 1 consumed
    load_tile(t + 1);
    if (!active) continue;
    const float* skh = ring + (t % STAGES) * STAGE;
    const float* skl = skh + TK * LDK;
    const float* svh = skh + 2 * TK * LDK;
    const float* svl = svh + TK * LDV;
    const int key0 = t * TK;
    const int nb8 = min(TK / 8, (n - key0 + 7) / 8);      // 8-key blocks holding a key < N

    // S = Q·Kᵀ an 8-key block at a time: B = K [8 channels, 8 keys], b0 =
    // (channel 2c, key g), b1 = (channel 2c + 1, key g), one 8-byte load.
    float sm[TK / 8][4], sc[TK / 8][4];
#pragma unroll
    for (int j = 0; j < TK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sm[j][e] = sc[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int j = 0; j < TK / 8; ++j) {
        if (j < nb8) {
          const int at = (8 * j + g) * LDK + 8 * ks + 2 * c;
          const float2 kh2 = *reinterpret_cast<const float2*>(skh + at);
          const float2 kl2 = *reinterpret_cast<const float2*>(skl + at);
          mma_m16n8k8_tf32(sc[j], ql[ks], __float_as_uint(kh2.x), __float_as_uint(kh2.y));
          mma_m16n8k8_tf32(sc[j], qh[ks], __float_as_uint(kl2.x), __float_as_uint(kl2.y));
          mma_m16n8k8_tf32(sm[j], qh[ks], __float_as_uint(kh2.x), __float_as_uint(kh2.y));
        }
      }
    }

    // x = q·k·scale·log2 e + (bh[key / side] + bw[key % side])·log2 e;
    // keys past N score -inf.
    float s[TK / 8][4];
#pragma unroll
    for (int j = 0; j < TK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = key0 + 8 * j + 2 * c + e;
        if (key < n) {
          const uint32_t u = kidx[key];
          const int ch = (int)(u & 0xFFFFu), cw = (int)(u >> 16);
#pragma unroll
          for (int r = 0; r < 2; ++r)
            s[j][2 * r + e] = fmaf(sm[j][2 * r + e] + sc[j][2 * r + e], scale_log2,
                                   (brow[r][ch] + brow[r][cw]) * LOG2E);
        } else {
          s[j][e] = s[j][2 + e] = -INFINITY;
        }
      }
    }

    // Online softmax over the tile: rows g (r = 0) and g + 8 (r = 1); every
    // tile holds a key < N, so the new max is finite.
    float alpha[2], m_neg[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < TK / 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(mrow[r], mx);
      alpha[r] = ex2(mrow[r] - m_new);       // 0 on the first tile
      mrow[r] = m_new;
      m_neg[r] = -m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < TK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = ex2(s[j][e] + m_neg[e / 2]);
        sum[e / 2] += s[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) lrow[r] = lrow[r] * alpha[r] + sum[r];

    // This tile's P·V into a fresh accumulator, an 8-key block at a time
    // (its channel blocks independent, so the products overlap): A = P as
    // it lies in S's accumulator (a0 = key 2c of row g, a1 = of row g + 8,
    // a2 = key 2c + 1 of row g, a3 = of row g + 8), split; B = V [8 keys, 8
    // channels], b0 = (key 2c, channel g), b1 = (key 2c + 1, channel g).
    float ot[KS][4];
#pragma unroll
    for (int nb = 0; nb < KS; ++nb) ot[nb][0] = ot[nb][1] = ot[nb][2] = ot[nb][3] = 0.f;
#pragma unroll
    for (int j = 0; j < TK / 8; ++j) {
      if (j < nb8) {
        uint32_t ph[4], pl[4];
        split_tf32_bits(s[j][0], ph[0], pl[0]);
        split_tf32_bits(s[j][2], ph[1], pl[1]);
        split_tf32_bits(s[j][1], ph[2], pl[2]);
        split_tf32_bits(s[j][3], ph[3], pl[3]);
#pragma unroll
        for (int nb = 0; nb < KS; ++nb) {
          const int at = (8 * j + 2 * c) * LDV + 8 * nb + g;
          const uint32_t vh0 = __float_as_uint(svh[at]), vh1 = __float_as_uint(svh[at + LDV]);
          const uint32_t vl0 = __float_as_uint(svl[at]), vl1 = __float_as_uint(svl[at + LDV]);
          mma_m16n8k8_tf32(ot[nb], pl, vh0, vh1);
          mma_m16n8k8_tf32(ot[nb], ph, vl0, vl1);
          mma_m16n8k8_tf32(ot[nb], ph, vh0, vh1);
        }
      }
    }
#pragma unroll
    for (int nb = 0; nb < KS; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nb][e] = fmaf(o[nb][e], alpha[e / 2], ot[nb][e]);
  }

  if (active) {
    // Finish the row sums across the quad; store rows < N.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lrow[r] += __shfl_xor_sync(0xffffffffu, lrow[r], 1);
      lrow[r] += __shfl_xor_sync(0xffffffffu, lrow[r], 2);
      const int row = row0 + g + 8 * r;
      if (row < n) {
        float* dst = out + ((size_t)b * n + row) * d + h * HD + 2 * c;
#pragma unroll
        for (int nb = 0; nb < KS; ++nb)
          *reinterpret_cast<float2*>(dst + 8 * nb) =
              make_float2(o[nb][2 * r] / lrow[r], o[nb][2 * r + 1] / lrow[r]);
      }
    }
  }
}

template <int HD>
int launch(const void* qkv, const void* bh, const void* bw, void* out, int b, int n, int side,
           int heads, float scale, cudaStream_t stream) {
  const Plan p = plan<HD>(n, side);
  auto kernel = win_attention_tf32x3_kernel<HD>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<b * heads * p.groups, 32 * p.warps, p.smem, stream>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(bh),
      static_cast<const float*>(bw), static_cast<float*>(out), n, side, heads, p.groups,
      p.bpitch, scale * LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace rat_b11f

// B11 in f32: the same arguments as rat_win_attention, every tensor f32.
extern "C" int rat_win_attention_f32(const void* qkv, const void* bias_h, const void* bias_w,
                                     void* out, int b, int n, int side, int heads, int hd,
                                     float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b < 1 || heads < 1 || !takes(n, side, hd)) return (int)cudaErrorInvalidValue;
  if (hd == 64) return rat_b11f::launch<64>(qkv, bias_h, bias_w, out, b, n, side, heads, scale, s);
  return rat_b11f::launch<80>(qkv, bias_h, bias_w, out, b, n, side, heads, scale, s);
}

// Dynamic shared memory a CTA of B11 f32 takes at window side `side` and
// head dim `hd` (for reports); -1 for a shape the kernel does not take.
extern "C" int rat_win_attention_f32_smem(int side, int hd) {
  if (!takes(side * side, side, hd)) return -1;
  return (int)(hd == 64 ? rat_b11f::plan<64>(side * side, side)
                        : rat_b11f::plan<80>(side * side, side)).smem;
}
