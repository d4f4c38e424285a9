// Flash attention with SAM's decomposed relative-position bias.
//
// Replaces: revisit_anything_tpu/ops/attention.py `_flash_attention` /
// `_attn_kernel` (pallas_call at :116), reached through `attend` (:561).
// softmax(q·kᵀ·scale + bias)·v over [B·H, N, Dh]; keys >= N are masked;
// the optional bias is bias[q, k] = bias_h[q, k / side] + bias_w[q, k % side].
//
// What bounds it on the H100 (NVIDIA H100 80GB HBM3, 700 W): the tensor
// cores. SAM ViT-H's global layers (N = 4096, Dh = 80, 16 heads) are
// 4 · 16 · 4096² · 80 = 86 GFLOP (0.087 ms at 989 TFLOP/s) against 50 MB
// of q, k, v and bias; DINOv2-g's blocks (N = 1531, Dh = 64, 24 heads)
// 14 GFLOP (0.015 ms). Next come the exponentials: N² a head, 268 M a SAM
// layer, ~0.07 ms at the SFU's 16 a clock an SM.
//
// Design (Hopper, sm_90a): one CTA of three warpgroups takes 128 query
// rows of one (batch, head).
//  - WG2 is the producer (setmaxnreg down to 24 registers): one thread
//    loads Q once and then streams 128-key tiles of K and of V by TMA
//    into two 2-stage rings, each stage guarded by a full and an empty
//    mbarrier; K(t) and V(t-1) are issued in the order they are used.
//  - WG0 and WG1 are the consumers (setmaxnreg up to 240), 64 query rows
//    each. S = Q·Kᵀ runs by wgmma m64n128k16 from shared memory into
//    registers; the online softmax runs in registers (exp2 with log2 e
//    folded into the scale, one rescale of O a tile, row max and sum by
//    quad shuffles); P is rounded to bf16 and fed as the register A
//    operand of wgmma m64n{Dh}k16 against V. The f32 output accumulator
//    stays in registers for the whole key loop.
//  - Products overlap the softmax two ways: a warpgroup issues S(t) and
//    then P(t-1)·V(t-1) before it waits for S(t) alone, so P·V runs
//    under tile t's softmax; and the two warpgroups take turns to issue
//    (named barriers), so one's softmax runs under the other's products.
//  - Dh = 80 is not a swizzle width (a 128-byte swizzle row holds 64
//    bf16). Each row of Q, K and V is loaded as two 64-column TMA boxes,
//    the second zero-filled past column 80 by the TMA's bounds check, so
//    every tile has the one 128B-swizzled layout: Q·Kᵀ takes 4 K-steps
//    from the first box and a 5th from the second; P·V reads V
//    MN-major as one n80 operand whose second 64-column atom is the
//    second box (the descriptor's leading byte offset).
//  - Keys past N (N = 1531) arrive as zeros from the TMA and score -inf
//    in the last tile; query rows past N are not stored.
//  - The bias: each consumer warp stages its 16 rows of bias_h and bias_w
//    ([rows, side] bf16, side <= 64) in shared memory once, before the key
//    loop. With side = 64 and 128-key tiles a thread's bias_w columns are
//    the same on every tile and stay in registers (f32, times log2 e);
//    bias_h takes one shared-memory read a row a tile. Other sides look
//    both up from shared memory per score. Sums are taken in f32, as the
//    JAX kernel's 0/1 expansion products sum them.
// Q/K/V reach the TMA through 3-D tensor maps [B·H, N, Dh] built per call
// (cuTensorMapEncodeTiled through the runtime's driver entry point, so
// the library needs no -lcuda), passed as __grid_constant__ parameters.

#include <math.h>

#include "hopper.cuh"

namespace {

using namespace rat_hopper;

constexpr int BQ = 128;                 // query rows a CTA (2 warpgroups x 64)
constexpr int BK = 128;                 // keys a tile
constexpr int STAGES = 2;
constexpr int THREADS = 384;            // WG0, WG1 consumers; WG2 producer
constexpr int BOX = 64;                 // columns a TMA box: one 128-byte row
constexpr int BOX_BYTES = 128 * BOX * 2;  // a [128 rows, 64 cols] box, Q or K/V
constexpr int MAX_SIDE = 64;
constexpr float LOG2E = 1.4426950408889634f;

template <int HD>
struct Cfg {
  static constexpr int NB = (HD + BOX - 1) / BOX;          // boxes a row
  static constexpr int KSTEPS = HD / 16;                   // of Q·Kᵀ
  static constexpr int TILE = NB * BOX_BYTES;              // Q, or K or V of a stage
  static constexpr int BIAS = 2 * BQ * MAX_SIDE * 2;       // bias_h and bias_w rows
  static constexpr int BARS = 128;
  static constexpr int SMEM = 1024 + TILE * (1 + 2 * STAGES) + BIAS + BARS;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// d (+)= A·B: A [64 x 16] and B [128 x 16], both K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A·B: A [64 x 16] bf16 in registers, B [16 x 80] MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n80(float (&d)[40], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39 "
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A·B: A [64 x 16] bf16 in registers, B [16 x 64] MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&o)[HD / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (HD == 80) wgmma_rs_n80(o, a, db);
  else wgmma_rs_n64(o, a, db);
}

// BIAS: 0 none; 1 any side <= 64, looked up per score; 2 side = 64.
template <int HD, int BIAS>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __nv_bfloat16* __restrict__ bias_h,   // [B·H, N, side]
                       const __nv_bfloat16* __restrict__ bias_w,   // [B·H, N, side]
                       __nv_bfloat16* __restrict__ out,            // [B·H, N, Dh]
                       int n, int side, float scale_log2) {
  using C = Cfg<HD>;
  extern __shared__ uint8_t smem_raw[];
  // 128B-swizzled tiles want 1024-byte alignment.
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sK = sQ + C::TILE;                         // stage s at + s·TILE
  const uint32_t sV = sK + STAGES * C::TILE;
  const uint32_t bias_off = base - raw + C::TILE * (1 + 2 * STAGES);
  __nv_bfloat16* sBh = reinterpret_cast<__nv_bfloat16*>(smem_raw + bias_off);
  __nv_bfloat16* sBw = sBh + BQ * MAX_SIDE;
  // K and V have rings of their own: a K stage frees as soon as its
  // Q·Kᵀ is done, a V stage after its P·V.
  const uint32_t bars = base + C::TILE * (1 + 2 * STAGES) + C::BIAS;
  auto full_k = [&](int s) { return bars + 8 * s; };
  auto full_v = [&](int s) { return bars + 8 * (STAGES + s); };
  auto empty_k = [&](int s) { return bars + 8 * (2 * STAGES + s); };
  auto empty_v = [&](int s) { return bars + 8 * (3 * STAGES + s); };
  const uint32_t qfull = bars + 8 * (4 * STAGES);

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int ntiles = (n + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), 256);
      mbar_init(empty_v(s), 256);
    }
    mbar_init(qfull, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: Q, then K(t) and V(t-1) in the order they are used ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      mbar_expect_tx(qfull, C::TILE);
      for (int b = 0; b < C::NB; ++b) tma_load_3d(sQ + b * BOX_BYTES, &tq, b * BOX, q0, bh, qfull);
      for (int t = 0; t <= ntiles; ++t) {
        if (t < ntiles) {
          const int s = t % STAGES;
          mbar_wait(empty_k(s), ((t / STAGES) + 1) & 1);    // passes at once for t < STAGES
          mbar_expect_tx(full_k(s), C::TILE);
          for (int b = 0; b < C::NB; ++b)
            tma_load_3d(sK + s * C::TILE + b * BOX_BYTES, &tk, b * BOX, t * BK, bh, full_k(s));
        }
        if (t > 0) {
          const int u = t - 1, s = u % STAGES;
          mbar_wait(empty_v(s), ((u / STAGES) + 1) & 1);
          mbar_expect_tx(full_v(s), C::TILE);
          for (int b = 0; b < C::NB; ++b)
            tma_load_3d(sV + s * C::TILE + b * BOX_BYTES, &tv, b * BOX, u * BK, bh, full_v(s));
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int ctid = threadIdx.x % 128;
    const int warp = ctid / 32, lane = ctid % 32, g = lane / 4, c = lane % 4;
    const int wrow0 = wg * 64 + warp * 16;                  // the warp's first CTA row
    const int rl[2] = {wrow0 + g, wrow0 + g + 8};           // this thread's two rows

    float bw_r[2][8][2];                                    // BIAS == 2: bias_w · log2 e
    if (BIAS) {
      for (int i = lane; i < 16 * side; i += 32) {
        const int r = i / side, col = i % side, qi = q0 + wrow0 + r;
        const size_t src = ((size_t)bh * n + qi) * side + col;
        const __nv_bfloat16 zero = __float2bfloat16(0.f);
        sBh[(wrow0 + r) * MAX_SIDE + col] = qi < n ? bias_h[src] : zero;
        sBw[(wrow0 + r) * MAX_SIDE + col] = qi < n ? bias_w[src] : zero;
      }
      __syncwarp();
      if (BIAS == 2) {
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              bw_r[r][i][e] =
                  LOG2E * __bfloat162float(sBw[rl[r] * MAX_SIDE + 8 * i + 2 * c + e]);
      }
    }

    float o[HD / 2];
#pragma unroll
    for (int j = 0; j < HD / 2; ++j) o[j] = 0.f;
    float sc[BK / 2];
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) sc[j] = 0.f;
    uint32_t pa[BK / 16][4];                                // P of the previous tile, bf16
    float mrow[2] = {-INFINITY, -INFINITY}, lrow[2] = {0.f, 0.f};

    // O += P·V for tile u: P (bf16) as the register A operand, V MN-major;
    // a K-step is 16 keys = two 1024-byte swizzle atoms, the second 64
    // columns of V lie one box (BOX_BYTES) further.
    auto issue_pv = [&](int u) {
      const uint32_t vb = sV + (u % STAGES) * C::TILE;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_pv<HD>(o, pa[kk], gmma_desc(vb + kk * 2048, BOX_BYTES, 1024));
    };

    // The two warpgroups take turns to issue their products (named
    // barriers 1 and 2), so one's softmax overlaps the other's wgmma.
    const int my_bar = 1 + wg, other_bar = 2 - wg;
    if (wg == 1) named_arrive(1, 256);                      // WG0 issues first

    mbar_wait(qfull, 0);
    for (int t = 0; t < ntiles; ++t) {
      const int s = t % STAGES;
      const int k0 = t * BK;
      mbar_wait(full_k(s), (t / STAGES) & 1);
      if (t > 0) mbar_wait(full_v((t - 1) % STAGES), ((t - 1) / STAGES) & 1);

      // Issue S(t) = Q·Kᵀ (K-major A and B; a K-step advances 32 bytes in
      // the swizzled row), then P(t-1)·V(t-1) behind it.
      named_sync(my_bar, 256);
      fence_regs(sc);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < C::KSTEPS; ++k) {
        const uint32_t qa = sQ + (k / 4) * BOX_BYTES + wg * 64 * 128 + (k % 4) * 32;
        const uint32_t kb = sK + s * C::TILE + (k / 4) * BOX_BYTES + (k % 4) * 32;
        wgmma_ss_n128(sc, gmma_desc(qa, 16, 1024), gmma_desc(kb, 16, 1024), k > 0);
      }
      wgmma_commit();
      if (t > 0) {
        issue_pv(t - 1);
        wgmma_commit();
      }
      if (!(wg == 1 && t == ntiles - 1)) named_arrive(other_bar, 256);
      if (t > 0) wgmma_wait<1>(); else wgmma_wait<0>();     // S(t) done
      fence_regs(sc);
      mbar_arrive(empty_k(s));

      // Scores to the log2 domain: with a bias, v = s·scale·log2 e + bias·log2
      // e is formed here; without one the raw score stays and the scale
      // folds into the max and the exponent's FFMA (it is positive). Keys
      // past N (last tile only) score -inf.
      // sc[4i + 2r + e]: row rl[r], key k0 + 8i + 2c + e.
      if (BIAS) {
        float bh_r[2][2];
        if (BIAS == 2) {
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
              bh_r[r][hh] =
                  LOG2E * __bfloat162float(sBh[rl[r] * MAX_SIDE + k0 / MAX_SIDE + hh]);
        }
#pragma unroll
        for (int i = 0; i < BK / 8; ++i) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = k0 + 8 * i + 2 * c + e;
            int kh = 0, kw = 0;
            if (BIAS == 1) {
              kh = min(key, n - 1) / side;
              kw = min(key, n - 1) - kh * side;
            }
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const float b =
                  BIAS == 2 ? bh_r[r][i / 8] + bw_r[r][i % 8][e]
                            : LOG2E * (__bfloat162float(sBh[rl[r] * MAX_SIDE + kh]) +
                                       __bfloat162float(sBw[rl[r] * MAX_SIDE + kw]));
              sc[4 * i + 2 * r + e] = fmaf(sc[4 * i + 2 * r + e], scale_log2, b);
            }
          }
        }
      }
      if (k0 + BK > n) {
#pragma unroll
        for (int i = 0; i < BK / 8; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (k0 + 8 * i + 2 * c + e >= n) {
              sc[4 * i + e] = -INFINITY;
              sc[4 * i + 2 + e] = -INFINITY;
            }
      }

      // Online softmax: one FFMA and one exp2 a score, one rescale of O a tile.
      const float sl = BIAS ? 1.f : scale_log2;
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int i = 0; i < BK / 8; ++i)
          mx = fmaxf(mx, fmaxf(sc[4 * i + 2 * r], sc[4 * i + 2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(mrow[r], mx * sl);
        alpha[r] = ex2(mrow[r] - m_new);                    // 0 on the first tile
        mrow[r] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < BK / 8; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = ex2(fmaf(sc[4 * i + 2 * r + e], sl, -m_new));
            sc[4 * i + 2 * r + e] = p;
            sum += p;
          }
        lrow[r] = lrow[r] * alpha[r] + sum;
      }

      // P(t-1)·V(t-1) done: free its V stage, rescale O, and round P(t).
      if (t > 0) {
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(pa);
        mbar_arrive(empty_v((t - 1) % STAGES));
      }
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          o[4 * j + 2 * r] *= alpha[r];
          o[4 * j + 2 * r + 1] *= alpha[r];
        }
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
        pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
    }

    // The last tile's P·V.
    {
      const int u = ntiles - 1;
      mbar_wait(full_v(u % STAGES), (u / STAGES) & 1);
      fence_regs(o);
      wgmma_fence();
      issue_pv(u);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      mbar_arrive(empty_v(u % STAGES));
    }

    // Normalize and store the rows below N.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = lrow[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int qi = q0 + rl[r];
      if (qi < n) {
        const float inv = 1.f / l;
        __nv_bfloat16* dst = out + ((size_t)bh * n + qi) * HD + 2 * c;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
          *reinterpret_cast<uint32_t*>(dst + 8 * j) =
              pack_bf16(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
      }
    }
  }
}

// [bh, n, hd] bf16 as a 3-D tensor map of [128 rows, 64 cols] boxes,
// 128B-swizzled; reads past n or hd fill zeros.
bool tensor_map(CUtensorMap* map, const void* ptr, int bh, int n, int hd) {
  const cuuint64_t dims[3] = {(cuuint64_t)hd, (cuuint64_t)n, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)hd * 2, (cuuint64_t)n * hd * 2};
  const cuuint32_t box[3] = {BOX, 128, 1};
  return tensor_map_bf16(map, ptr, 3, dims, strides, box);
}

template <int HD, int BIAS>
int launch(const void* q, const void* k, const void* v, const void* bias_h,
           const void* bias_w, void* out, int bh, int n, int side, float scale,
           cudaStream_t stream) {
  using C = Cfg<HD>;
  auto kernel = flash_attention_kernel<HD, BIAS>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, q, bh, n, HD) || !tensor_map(&tk, k, bh, n, HD) ||
      !tensor_map(&tv, v, bh, n, HD))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((n + BQ - 1) / BQ, bh);
  kernel<<<grid, THREADS, C::SMEM, stream>>>(
      tq, tk, tv, static_cast<const __nv_bfloat16*>(bias_h),
      static_cast<const __nv_bfloat16*>(bias_w), static_cast<__nv_bfloat16*>(out), n, side,
      scale * LOG2E);
  return (int)cudaGetLastError();
}

template <int HD>
int dispatch(const void* q, const void* k, const void* v, const void* bias_h,
             const void* bias_w, void* out, int bh, int n, int side, int has_bias,
             float scale, cudaStream_t s) {
  if (!has_bias) return launch<HD, 0>(q, k, v, nullptr, nullptr, out, bh, n, 1, scale, s);
  if (side < 1 || side > MAX_SIDE || side * side != n) return (int)cudaErrorInvalidValue;
  if (side == MAX_SIDE)
    return launch<HD, 2>(q, k, v, bias_h, bias_w, out, bh, n, side, scale, s);
  return launch<HD, 1>(q, k, v, bias_h, bias_w, out, bh, n, side, scale, s);
}

// ---------------------------------------------------------------------------
// K1 in f32 (entry rat_flash_attention_f32): the same function on f32 q, k,
// v, out and bias, for the f32 DINO forwards (DINOv1's extraction at
// AnyLoc's settings: N = 4016, 6 heads of 64; an f32 DINOv2 at N >= 1024)
// and an f32 SAM's global layers (N = 4096, 16 heads of 80, the decomposed
// bias at side 64). The TPU kernel computes in its inputs' dtype (scores
// f32, p rounded to v's dtype), so f32 inputs give f32 attention.
//
// The bias (BIAS > 0): each score becomes s·scale·log2 e + bias_h[q, k /
// side]·log2 e + bias_w[q, k % side]·log2 e as soon as S leaves the tensor
// cores, before the row max, so the online softmax below runs unchanged on
// it (at a scale of 1). At side 64 (BIAS = 2, SAM's global layers) a
// 32-key tile lies inside one row of the key grid, so a tile needs one
// bias_h term a row, and a thread's bias_w columns repeat every two tiles:
// the consumers stage their 128 rows of bias_h (times log2 e, rows padded
// to 65 floats against bank conflicts: 33,280 B) in shared memory before
// the key loop, and each thread keeps its two rows' 16 bias_w columns
// (times log2 e) in 32 registers; the key loop reads no bias from device
// memory. Other sides (BIAS = 1, no served query) read both terms per
// score from device memory, stepping the key's column across the key
// grid's rows from the tile's first key.
//
// Precision: both products run on the tensor cores in split TF32. An f32
// operand x is cut into hi = tf32_rna(x) and lo = tf32_rna(x - hi) (11 and
// 11 more significant bits: x = hi + lo + a rest below 2^-22 |x|), and a
// product A·B is taken as lo·hi + hi·lo + hi·hi, the small passes first so
// that the accumulator is still small while they are added. The dropped
// lo·lo term and the rests are ~2^-21 of each product, against one TF32
// pass's 2^-11: on random inputs (a CPU emulation, tests/
// test_torch_attention.py) the output is as close to f64 as true f32 is.
// Each tile's P·V starts from zero and joins the running O by an FMA
// (wgmma accumulates without rounding to nearest, so a sum carried over
// ~60 tiles would drift); exponentials by ex2.approx, log2 e folded into
// the scale.
//
// What bounds it: the tensor cores, three TF32 passes of 4·N²·Dh FLOP a
// head at 495 TFLOP/s (DINOv1 ViT-S/8, batch 8: 3 x 198 GFLOP, 1.20 ms),
// against 16·N·Dh bytes a head of q, k, v and out (197 MB, 0.06 ms) and
// N² exponentials a head on the SFU (774 M, ~0.2 ms), which run beside them.
//
// Design (Hopper, sm_90a), two kernels on the caller's stream:
//  - split_kv_kernel (the pre-pass) writes K's hi and lo planes as
//    [2, B·H, N, Dh] and V's transposed, Vᵀ [2, B·H, Dh, n_pad] (TF32 wgmma
//    takes B only K-major, and the K dimension of P·V is the keys), into
//    scratch the wrapper allocates; n_pad = N rounded up to 64 (16-byte TMA
//    strides), keys past N written as zeros (a NaN of unwritten scratch
//    times p = 0 would still be NaN). Within each group of 8 keys, Vᵀ holds
//    them in the order 0,2,4,6,1,3,5,7: S's accumulator gives a thread keys
//    2t and 2t+1 of each 8, the register A operand wants keys t and t+4, so
//    with the keys permuted S's registers serve as P's fragments as they
//    are (no shuffles).
//  - flash_attention_tf32x3_kernel: one CTA of three warpgroups takes 128
//    query rows of one (batch, head), as bf16 K1 does. WG2 is the producer
//    (setmaxnreg down to 24): one thread loads Q once and streams the K and
//    Vᵀ planes of each key tile by TMA through a 2-stage ring (full and
//    empty mbarriers). WG0 and WG1 (setmaxnreg up to 240) take 64 rows each.
//    Q's split is made in shared memory by the consumers: each splits its
//    own rows in place into the hi plane and beside it the lo plane (no
//    scratch, no second pass over Q). S = Q·Kᵀ is three passes of
//    wgmma m64n{BK}k8 from shared memory; the online softmax runs in
//    registers (row max and sum by quad shuffles, one rescale of O a tile);
//    P is split in registers, hi in S's own registers, and fed as the
//    register A operand of three passes of m64n{Dh}k8 against the Vᵀ
//    planes. The two consumer warpgroups take turns to issue (named
//    barriers 1 and 2: S(t) of WG0, S(t) of WG1, P·V(t) of WG0, P·V(t) of
//    WG1, ...), so one's softmax runs under the other's products.
//  - Tiles (128B-swizzled boxes of 32 floats): Dh 64 takes 64-key tiles,
//    Q hi + lo 64 KB and 2 stages of K hi + lo (32 KB) and Vᵀ hi + lo
//    (32 KB): 192 KB. Dh 80 pads Q's and K's rows to 96 columns (three
//    boxes, the last zero-filled past column 80 by the TMA), which at
//    64-key tiles would take 272 KB; it takes 32-key tiles (96 + 2 x 44 =
//    184 KB). Keys past N arrive as zeros (K) or are zeros (Vᵀ) and score
//    -inf in the last tile; query rows past N are not stored.
constexpr int F32_BQ = 128;             // query rows a CTA (2 warpgroups x 64)
constexpr int F32_BOX = 32;             // floats a TMA box row: 128 bytes
constexpr int F32_KEY_PAD = 64;         // Vᵀ rows rounded up to this many keys
constexpr int SPLIT_THREADS = 256;

template <int HD>
struct F32Cfg {
  static constexpr int BK = HD == 64 ? 64 : 32;           // keys a tile
  static constexpr int QB = (HD + F32_BOX - 1) / F32_BOX; // boxes a Q or K row
  static constexpr int VB = BK / F32_BOX;                 // boxes a Vᵀ row
  static constexpr int KSTEPS = HD / 8;                   // of Q·Kᵀ
  static constexpr int Q_BOX = F32_BQ * 128;              // bytes
  static constexpr int K_BOX = BK * 128;
  static constexpr int V_BOX = HD * 128;
  static constexpr int Q_PLANE = QB * Q_BOX;              // hi; lo right after
  static constexpr int K_PLANE = QB * K_BOX;
  static constexpr int V_PLANE = VB * V_BOX;
  static constexpr int STAGE = 2 * (K_PLANE + V_PLANE);   // K hi, K lo, Vᵀ hi, Vᵀ lo
  static constexpr int BARS = 64;
  static constexpr int SMEM = 1024 + 2 * Q_PLANE + STAGES * STAGE + BARS;
  static constexpr int SPLIT_SMEM = F32_KEY_PAD * (HD + 1) * 4;
  // BIAS = 2: bias_h of the CTA's rows [128][65] (f32 · log2 e) after the
  // barriers
  static constexpr int BH_PITCH = MAX_SIDE + 1;
  static constexpr int BIAS_SMEM = SMEM + F32_BQ * BH_PITCH * 4;
  static_assert(BIAS_SMEM <= 232448, "one CTA an SM");
};

// x = hi + lo + a rest below 2^-22 |x|, hi and lo TF32.
__device__ __forceinline__ void split_tf32(float x, float& hi, float& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - hi);
}

__device__ __forceinline__ void split_tf32(float4 x, float4& hi, float4& lo) {
  split_tf32(x.x, hi.x, lo.x);
  split_tf32(x.y, hi.y, lo.y);
  split_tf32(x.z, hi.z, lo.z);
  split_tf32(x.w, hi.w, lo.w);
}

// The pre-pass: one CTA a (64-key tile, batch·head). kp [2][bh][n][HD],
// vt [2][bh][HD][n_pad] (hi planes first).
template <int HD>
__global__ void __launch_bounds__(SPLIT_THREADS)
split_kv_kernel(const float* __restrict__ k, const float* __restrict__ v,
                float* __restrict__ kp, float* __restrict__ vt, int bh_total, int n,
                int n_pad) {
  extern __shared__ float vs[];                           // [64][HD + 1]
  constexpr int V4 = HD / 4;
  const int bh = blockIdx.y, k0 = blockIdx.x * F32_KEY_PAD;
  const size_t kplane = (size_t)bh_total * n * HD;
  const size_t vplane = (size_t)bh_total * HD * n_pad;
  for (int i = threadIdx.x; i < F32_KEY_PAD * V4; i += SPLIT_THREADS) {
    const int r = i / V4, c = 4 * (i % V4), key = k0 + r;
    float4 vx = make_float4(0.f, 0.f, 0.f, 0.f);
    if (key < n) {
      const size_t at = ((size_t)bh * n + key) * HD + c;
      vx = *reinterpret_cast<const float4*>(v + at);
      float4 h, l;
      split_tf32(*reinterpret_cast<const float4*>(k + at), h, l);
      *reinterpret_cast<float4*>(kp + at) = h;
      *reinterpret_cast<float4*>(kp + kplane + at) = l;
    }
    float* row = vs + r * (HD + 1) + c;
    row[0] = vx.x; row[1] = vx.y; row[2] = vx.z; row[3] = vx.w;
  }
  __syncthreads();
  // Vᵀ position p of a group of 8 holds key 2p (p < 4) or 2p - 7 (p >= 4).
  for (int i = threadIdx.x; i < HD * F32_KEY_PAD; i += SPLIT_THREADS) {
    const int d = i / F32_KEY_PAD, pos = i % F32_KEY_PAD, j = pos & 7;
    const int r = (pos & ~7) + (j < 4 ? 2 * j : 2 * j - 7);
    const size_t at = ((size_t)bh * HD + d) * n_pad + k0 + pos;
    split_tf32(vs[r * (HD + 1) + d], vt[at], vt[vplane + at]);
  }
}

template <int HD>
__device__ __forceinline__ void wgmma_s_tf32(float (&d)[F32Cfg<HD>::BK / 2], uint64_t da,
                                             uint64_t db, int accumulate) {
  if constexpr (F32Cfg<HD>::BK == 64) wgmma_ss_tf32_n64(d, da, db, accumulate);
  else wgmma_ss_tf32_n32(d, da, db, accumulate);
}

template <int HD>
__device__ __forceinline__ void wgmma_pv_tf32(float (&d)[HD / 2], const uint32_t (&a)[4],
                                              uint64_t db, int accumulate) {
  if constexpr (HD == 80) wgmma_rs_tf32_n80(d, a, db, accumulate);
  else wgmma_rs_tf32_n64(d, a, db, accumulate);
}

// BIAS: 0 none; 1 any side <= 64, read per score; 2 side 64, from shared
// memory and registers.
template <int HD, int BIAS>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_tf32x3_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const float* __restrict__ bias_h,  // [B·H, N, side]
                              const float* __restrict__ bias_w,  // [B·H, N, side]
                              float* __restrict__ out,           // [B·H, N, Dh]
                              int n, int side, int bh_total, float scale_log2) {
  using C = F32Cfg<HD>;
  constexpr int BK = C::BK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t sQ = base;                               // hi plane, then lo
  const uint32_t sS = sQ + 2 * C::Q_PLANE;                // stage s at + s·STAGE
  const uint32_t bars = sS + STAGES * C::STAGE;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };
  const uint32_t qfull = bars + 8 * (2 * STAGES);
  float* sbh = reinterpret_cast<float*>(smem_raw + (bars - raw) + C::BARS);

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * F32_BQ;
  const int ntiles = (n + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 256);
    }
    mbar_init(qfull, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: Q, then each tile's K hi, K lo, Vᵀ hi, Vᵀ lo ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      mbar_expect_tx(qfull, C::Q_PLANE);
      for (int b = 0; b < C::QB; ++b)
        tma_load_3d(sQ + b * C::Q_BOX, &tq, b * F32_BOX, q0, bh, qfull);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % STAGES;
        const uint32_t st = sS + s * C::STAGE;
        mbar_wait(empty(s), ((t / STAGES) + 1) & 1);      // passes at once for t < STAGES
        mbar_expect_tx(full(s), C::STAGE);
        for (int pl = 0; pl < 2; ++pl) {
          for (int b = 0; b < C::QB; ++b)
            tma_load_3d(st + pl * C::K_PLANE + b * C::K_BOX, &tk, b * F32_BOX, t * BK,
                        bh + pl * bh_total, full(s));
          for (int b = 0; b < C::VB; ++b)
            tma_load_3d(st + 2 * C::K_PLANE + pl * C::V_PLANE + b * C::V_BOX, &tv,
                        t * BK + b * F32_BOX, 0, bh + pl * bh_total, full(s));
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int ctid = threadIdx.x % 128;
    const int warp = ctid / 32, lane = ctid % 32, g = lane / 4, c = lane % 4;
    const int rl[2] = {wg * 64 + warp * 16 + g, wg * 64 + warp * 16 + g + 8};

    // Split this warpgroup's 64 rows of Q in place: hi over the raw
    // values, lo at the same offset in the lo plane (the swizzle is the
    // same in both). Then make the writes visible to wgmma.
    mbar_wait(qfull, 0);
    for (int b = 0; b < C::QB; ++b) {
      float4* hi = reinterpret_cast<float4*>(smem_raw + (base - raw) + b * C::Q_BOX +
                                             wg * 64 * 128);
      float4* lo = hi + C::Q_PLANE / 16;
      for (int i = ctid; i < 64 * 128 / 16; i += 128) {
        float4 h, l;
        split_tf32(hi[i], h, l);
        hi[i] = h;
        lo[i] = l;
      }
    }
    // BIAS = 2: this warpgroup's 64 rows of bias_h into shared memory, and
    // each thread's bias_w columns 32hf + 8i + 2c + e of its two rows into
    // bw[r][4hf + i][e] (rows past N read row N - 1 and are not stored)
    float bw[2][8][2];
    if constexpr (BIAS == 2) {
      for (int i = ctid; i < 64 * MAX_SIDE / 4; i += 128) {
        const int r = wg * 64 + i / (MAX_SIDE / 4), col = 4 * (i % (MAX_SIDE / 4));
        const float4 v = __ldg(reinterpret_cast<const float4*>(
            bias_h + ((size_t)bh * n + min(q0 + r, n - 1)) * MAX_SIDE + col));
        float* dst = sbh + r * C::BH_PITCH + col;
        dst[0] = v.x * LOG2E;
        dst[1] = v.y * LOG2E;
        dst[2] = v.z * LOG2E;
        dst[3] = v.w * LOG2E;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float* row = bias_w + ((size_t)bh * n + min(q0 + rl[r], n - 1)) * MAX_SIDE + 2 * c;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float2 v = __ldg(reinterpret_cast<const float2*>(row + 8 * i));
          bw[r][i][0] = v.x * LOG2E;
          bw[r][i][1] = v.y * LOG2E;
        }
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    named_sync(3 + wg, 128);

    float o[HD / 2], acc[HD / 2];
#pragma unroll
    for (int j = 0; j < HD / 2; ++j) o[j] = acc[j] = 0.f;
    float sc[BK / 2];                                       // S, then P's hi
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) sc[j] = 0.f;
    uint32_t plo[BK / 8][4];                                // P's lo, as A fragments
    float mrow[2] = {-INFINITY, -INFINITY}, lrow[2] = {0.f, 0.f};
    // with a bias, the scores arrive in the log2 domain already scaled
    const float sl = BIAS ? 1.f : scale_log2;

    const int my_bar = 1 + wg, other_bar = 2 - wg;
    if (wg == 1) named_arrive(1, 256);                      // WG0 issues first

    for (int t = 0; t < ntiles; ++t) {
      const int s = t % STAGES;
      const int k0 = t * BK;
      const uint32_t st = sS + s * C::STAGE;
      mbar_wait(full(s), (t / STAGES) & 1);

      // S = Q·Kᵀ: lo·hi, hi·lo, then hi·hi (K-major A and B; a K-step of 8
      // floats advances 32 bytes in the swizzled row).
      named_sync(my_bar, 256);
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int pass = 0; pass < 3; ++pass) {
        const uint32_t qp = sQ + (pass == 0 ? C::Q_PLANE : 0);
        const uint32_t kp = st + (pass == 1 ? C::K_PLANE : 0);
#pragma unroll
        for (int k = 0; k < C::KSTEPS; ++k) {
          const uint32_t qa = qp + (k / 4) * C::Q_BOX + wg * 64 * 128 + (k % 4) * 32;
          const uint32_t kb = kp + (k / 4) * C::K_BOX + (k % 4) * 32;
          wgmma_s_tf32<HD>(sc, gmma_desc(qa, 16, 1024), gmma_desc(kb, 16, 1024),
                           pass > 0 || k > 0);
        }
      }
      wgmma_commit();
      named_arrive(other_bar, 256);
      wgmma_wait<0>();
      fence_regs(sc);

      // sc[4i + 2r + e]: row rl[r], key k0 + 8i + 2c + e. With a bias,
      // v = s·scale·log2 e + (bias_h·log2 e + bias_w·log2 e) at side 64,
      // s·scale·log2 e + (bias_h + bias_w)·log2 e at other sides (rows past
      // N read row N - 1 and are not stored; keys past N read nothing).
      if constexpr (BIAS == 2) {
        // the tile lies in key-grid row k0 / 64; a 32-key tile takes
        // column half t % 2 of bw
        const bool hf = BK == 32 && (t & 1);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float bhr = sbh[rl[r] * C::BH_PITCH + k0 / MAX_SIDE];
#pragma unroll
          for (int i = 0; i < BK / 8; ++i)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              sc[4 * i + 2 * r + e] = fmaf(sc[4 * i + 2 * r + e], scale_log2,
                                           bhr + (hf ? bw[r][(4 + i) % 8][e] : bw[r][i][e]));
        }
      } else if constexpr (BIAS == 1) {
        const int kh0 = k0 / side, kw0 = k0 - kh0 * side;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const size_t row = ((size_t)bh * n + min(q0 + rl[r], n - 1)) * side;
#pragma unroll
          for (int i = 0; i < BK / 8; ++i)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int off = 8 * i + 2 * c + e;
              int kw = kw0 + off, kh = kh0;
              while (kw >= side) {
                kw -= side;
                ++kh;
              }
              const float b =
                  k0 + off < n ? (__ldg(bias_h + row + kh) + __ldg(bias_w + row + kw)) * LOG2E
                               : 0.f;
              sc[4 * i + 2 * r + e] = fmaf(sc[4 * i + 2 * r + e], scale_log2, b);
            }
        }
      }
      // Keys past N (last tile only) score -inf.
      if (k0 + BK > n) {
#pragma unroll
        for (int i = 0; i < BK / 8; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (k0 + 8 * i + 2 * c + e >= n) {
              sc[4 * i + e] = -INFINITY;
              sc[4 * i + 2 + e] = -INFINITY;
            }
      }

      // Online softmax in base 2, then P's split: hi into sc, lo into plo
      // in the A fragment's order (a0 = row g key 2c, a1 = row g + 8 key
      // 2c, a2 = row g key 2c + 1, a3 = row g + 8 key 2c + 1).
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int i = 0; i < BK / 8; ++i)
          mx = fmaxf(mx, fmaxf(sc[4 * i + 2 * r], sc[4 * i + 2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(mrow[r], mx * sl);
        alpha[r] = ex2(mrow[r] - m_new);                    // 0 on the first tile
        mrow[r] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < BK / 8; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = ex2(fmaf(sc[4 * i + 2 * r + e], sl, -m_new));
            sum += p;
            float lo;
            split_tf32(p, sc[4 * i + 2 * r + e], lo);
            plo[i][r + 2 * e] = __float_as_uint(lo);
          }
        lrow[r] = lrow[r] * alpha[r] + sum;
      }

      // This tile's P·V into a fresh accumulator: lo·hi, hi·lo, hi·hi
      // (Vᵀ K-major; a K-step of 8 keys advances 32 bytes).
      named_sync(my_bar, 256);
      fence_regs(acc);
      fence_regs(plo);
      wgmma_fence();
#pragma unroll
      for (int pass = 0; pass < 3; ++pass) {
        const uint32_t vp = st + 2 * C::K_PLANE + (pass == 1 ? C::V_PLANE : 0);
#pragma unroll
        for (int i = 0; i < BK / 8; ++i) {
          const uint32_t phi[4] = {__float_as_uint(sc[4 * i]), __float_as_uint(sc[4 * i + 2]),
                                   __float_as_uint(sc[4 * i + 1]),
                                   __float_as_uint(sc[4 * i + 3])};
          const uint64_t vb = gmma_desc(vp + (i / 4) * C::V_BOX + (i % 4) * 32, 16, 1024);
          if (pass == 0) wgmma_pv_tf32<HD>(acc, plo[i], vb, i > 0);
          else wgmma_pv_tf32<HD>(acc, phi, vb, 1);
        }
      }
      wgmma_commit();
      if (!(wg == 1 && t == ntiles - 1)) named_arrive(other_bar, 256);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(sc);
      fence_regs(plo);
      mbar_arrive(empty(s));

#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            o[4 * j + 2 * r + e] = fmaf(o[4 * j + 2 * r + e], alpha[r], acc[4 * j + 2 * r + e]);
    }

    // Normalize and store the rows below N.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = lrow[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int qi = q0 + rl[r];
      if (qi < n) {
        const float inv = 1.f / l;
        float* dst = out + ((size_t)bh * n + qi) * HD + 2 * c;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
          *reinterpret_cast<float2*>(dst + 8 * j) =
              make_float2(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
      }
    }
  }
}

// Scratch of the f32 kernel: K's planes [2, bh, n, hd], then Vᵀ's [2, bh,
// hd, n_pad], n_pad = n rounded up to F32_KEY_PAD (the wrapper allocates
// 2·bh·hd·(n + n_pad) floats).
template <int HD, int BIAS>
int launch_f32(const void* q, const void* k, const void* v, const void* bias_h,
               const void* bias_w, void* out, void* scratch, int bh, int n, int side, float scale,
               cudaStream_t stream) {
  using C = F32Cfg<HD>;
  const int n_pad = (n + F32_KEY_PAD - 1) / F32_KEY_PAD * F32_KEY_PAD;
  float* kp = static_cast<float*>(scratch);
  float* vt = kp + (size_t)2 * bh * n * HD;
  auto kernel = flash_attention_tf32x3_kernel<HD, BIAS>;
  const int smem = BIAS == 2 ? C::BIAS_SMEM : C::SMEM;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tq, tk, tv;
  const cuuint64_t qdims[3] = {(cuuint64_t)HD, (cuuint64_t)n, (cuuint64_t)bh};
  const cuuint64_t kdims[3] = {(cuuint64_t)HD, (cuuint64_t)n, (cuuint64_t)2 * bh};
  const cuuint64_t qstrides[2] = {(cuuint64_t)HD * 4, (cuuint64_t)n * HD * 4};
  const cuuint32_t qbox[3] = {F32_BOX, F32_BQ, 1}, kbox[3] = {F32_BOX, C::BK, 1};
  const cuuint64_t vdims[3] = {(cuuint64_t)n_pad, (cuuint64_t)HD, (cuuint64_t)2 * bh};
  const cuuint64_t vstrides[2] = {(cuuint64_t)n_pad * 4, (cuuint64_t)HD * n_pad * 4};
  const cuuint32_t vbox[3] = {F32_BOX, HD, 1};
  if (!tensor_map_f32(&tq, q, 3, qdims, qstrides, qbox) ||
      !tensor_map_f32(&tk, kp, 3, kdims, qstrides, kbox) ||
      !tensor_map_f32(&tv, vt, 3, vdims, vstrides, vbox))
    return (int)cudaErrorInvalidValue;
  split_kv_kernel<HD><<<dim3(n_pad / F32_KEY_PAD, bh), SPLIT_THREADS, C::SPLIT_SMEM, stream>>>(
      static_cast<const float*>(k), static_cast<const float*>(v), kp, vt, bh, n, n_pad);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((n + F32_BQ - 1) / F32_BQ, bh), THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<const float*>(bias_h), static_cast<const float*>(bias_w),
      static_cast<float*>(out), n, side, bh, scale * LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rat_flash_attention(const void* q, const void* k, const void* v,
                                   const void* bias_h, const void* bias_w,
                                   void* out, int bh, int n, int side,
                                   int has_bias, float scale, int hd,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh <= 0 || n <= 0 || bh > 65535) return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 64:
      return dispatch<64>(q, k, v, bias_h, bias_w, out, bh, n, side, has_bias, scale, s);
    case 80:
      return dispatch<80>(q, k, v, bias_h, bias_w, out, bh, n, side, has_bias, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory a CTA takes at head dim hd (for reports).
extern "C" int rat_flash_attention_smem(int hd) {
  return hd == 64 ? Cfg<64>::SMEM : hd == 80 ? Cfg<80>::SMEM : 0;
}

// K1 in f32, no bias: q, k, v, out [bh, n, hd] f32, hd 64 or 80; scratch
// 2·bh·hd·(n + n_pad) floats, n_pad = n rounded up to 64. Two launches on
// the stream: the K/V split, then the attention.
extern "C" int rat_flash_attention_f32(const void* q, const void* k, const void* v,
                                       void* out, void* scratch, int bh, int n, float scale,
                                       int hd, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh <= 0 || n <= 0 || bh > 65535) return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 64:
      return launch_f32<64, 0>(q, k, v, nullptr, nullptr, out, scratch, bh, n, 1, scale, s);
    case 80:
      return launch_f32<80, 0>(q, k, v, nullptr, nullptr, out, scratch, bh, n, 1, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// K1 in f32 with the decomposed bias: as rat_flash_attention_f32, plus
// bias_h and bias_w [bh, n, side] f32, side <= 64 and n = side².
extern "C" int rat_flash_attention_f32_bias(const void* q, const void* k, const void* v,
                                            const void* bias_h, const void* bias_w, void* out,
                                            void* scratch, int bh, int n, int side,
                                            float scale, int hd, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh <= 0 || n <= 0 || bh > 65535 || side < 1 || side > MAX_SIDE || side * side != n)
    return (int)cudaErrorInvalidValue;
  const bool rows = side == MAX_SIDE;
  switch (hd) {
    case 64:
      return rows ? launch_f32<64, 2>(q, k, v, bias_h, bias_w, out, scratch, bh, n, side, scale, s)
                  : launch_f32<64, 1>(q, k, v, bias_h, bias_w, out, scratch, bh, n, side, scale, s);
    case 80:
      return rows ? launch_f32<80, 2>(q, k, v, bias_h, bias_w, out, scratch, bh, n, side, scale, s)
                  : launch_f32<80, 1>(q, k, v, bias_h, bias_w, out, scratch, bh, n, side, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory a CTA of the f32 attention (split = 0), of its
// K/V split (split = 1) or of the attention with the bias at side 64
// (split = 2) takes at head dim hd.
template <int HD>
int f32_smem(int split) {
  return split == 1 ? F32Cfg<HD>::SPLIT_SMEM : split == 2 ? F32Cfg<HD>::BIAS_SMEM : F32Cfg<HD>::SMEM;
}

extern "C" int rat_flash_attention_f32_smem(int hd, int split) {
  return hd == 64 ? f32_smem<64>(split) : hd == 80 ? f32_smem<80>(split) : 0;
}
