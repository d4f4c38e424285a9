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
