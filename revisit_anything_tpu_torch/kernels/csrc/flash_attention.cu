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
// K1 in f32 (entry rat_flash_attention_f32): the same function without the
// bias, on f32 q, k, v and out, for the f32 DINO forwards (DINOv1's
// extraction at AnyLoc's settings: N = 4016, 6 heads of 64; an f32 DINOv2 at
// N >= 1024). The TPU kernel computes in its inputs' dtype (scores f32, p
// rounded to v's dtype), so f32 inputs give f32 attention.
//
// True f32 throughout: scores, the online softmax and the value product on
// the FMA units, with f32 sums (wgmma has no f32 form, and TF32 would lose
// the parity the f32 path exists for). What bounds it: the FMA units,
// 4·N²·Dh FLOP a head at 67 TFLOP/s (DINOv1 ViT-S/8, batch 8: 198 GFLOP,
// 2.96 ms) against 16·N·Dh bytes a head (12 MB, 4 us).
//
// Design (a first, simple pass): one CTA of 256 threads takes 64 query rows
// of one (batch, head). Q is copied into shared memory once; then for each
// 64-key tile, K and V are copied in by coalesced float4 loads (keys past N
// as zeros, masked to -inf), and the 16x16 threads compute S = Q·Kᵀ with
// 4 rows x 4 keys a thread (rows ty + 16i, keys tx + 16j), reading float4s
// along Dh (Q and K rows padded by 4 floats, so the 8 threads of a
// quarter-warp read 8 distinct bank groups; a row of Q is one broadcast).
// The online softmax runs in registers: each row's max and sum are
// reduced over its 16 threads by shuffles, exp by expf. P goes to shared
// memory over K's tile, and O += P·V accumulates in registers (4 rows x
// Dh/16 columns a thread, columns tx·Dh/16 + c). Rows past N are not
// stored.
constexpr int F32_BQ = 64;
constexpr int F32_BK = 64;
constexpr int F32_THREADS = 256;

template <int HD>
struct F32Cfg {
  static constexpr int LD = HD + 4;                     // Q and K/P row stride
  static constexpr int CPT = HD / 16;                   // O columns a thread
  static constexpr int SMEM = (2 * F32_BQ * LD + F32_BK * HD) * 4;
};

template <int HD>
__device__ __forceinline__ void load_rows_f32(float* dst, int ld, const float* src,
                                              int row0, int n, int tid) {
  constexpr int V4 = HD / 4;                            // float4s a row
  for (int idx = tid; idx < 64 * V4; idx += F32_THREADS) {
    const int r = idx / V4, c4 = idx % V4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n)
      val = *reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * HD + 4 * c4);
    *reinterpret_cast<float4*>(dst + r * ld + 4 * c4) = val;
  }
}

template <int HD>
__global__ void __launch_bounds__(F32_THREADS, 2)
flash_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ out,
                           int n, float scale) {
  using C = F32Cfg<HD>;
  extern __shared__ __align__(16) float smem_f[];
  float* qs = smem_f;                                   // [64][LD]
  float* ks = qs + F32_BQ * C::LD;                      // [64][LD], then P
  float* vs = ks + F32_BK * C::LD;                      // [64][HD]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int bh = blockIdx.y, q0 = blockIdx.x * F32_BQ;
  const size_t base = (size_t)bh * n * HD;

  load_rows_f32<HD>(qs, C::LD, q + base, q0, n, tid);

  float o[4][C::CPT];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C::CPT; ++c) o[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < n; k0 += F32_BK) {
    __syncthreads();                                    // last tile's P, V read
    load_rows_f32<HD>(ks, C::LD, k + base, k0, n, tid);
    load_rows_f32<HD>(vs, HD, v + base, k0, n, tid);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * C::LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * C::LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    // Online softmax of each row over its 16 threads.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = (k0 + tx + 16 * j < n) ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);              // finite: k0 < n
      const float alpha = expf(m[i] - m_new);
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
      l[i] = l[i] * alpha + sum;                        // this thread's part
#pragma unroll
      for (int c = 0; c < C::CPT; ++c) o[i][c] *= alpha;
    }

    __syncthreads();                                    // S read K's tile
    float* ps = ks;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) ps[(ty + 16 * i) * C::LD + tx + 16 * j] = s[i][j];
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < F32_BK; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(ps + (ty + 16 * i) * C::LD + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vv[C::CPT];
        const float* vrow = vs + (kk + u) * HD + tx * C::CPT;
        if constexpr (C::CPT == 4) {
          const float4 t = *reinterpret_cast<const float4*>(vrow);
          vv[0] = t.x; vv[1] = t.y; vv[2] = t.z; vv[3] = t.w;
        } else {
#pragma unroll
          for (int c = 0; c < C::CPT; ++c) vv[c] = vrow[c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = u == 0 ? pv[i].x : u == 1 ? pv[i].y : u == 2 ? pv[i].z : pv[i].w;
#pragma unroll
          for (int c = 0; c < C::CPT; ++c) o[i][c] = fmaf(p, vv[c], o[i][c]);
        }
      }
    }
  }

  // The row sums over the 16 threads, then normalize and store.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float li = l[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) li += __shfl_xor_sync(0xffffffffu, li, off);
    const int row = q0 + ty + 16 * i;
    if (row < n) {
      const float inv = 1.f / li;
      float* dst = out + base + (size_t)row * HD + tx * C::CPT;
#pragma unroll
      for (int c = 0; c < C::CPT; ++c) dst[c] = o[i][c] * inv;
    }
  }
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* out, int bh, int n,
               float scale, cudaStream_t stream) {
  using C = F32Cfg<HD>;
  auto kernel = flash_attention_f32_kernel<HD>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + F32_BQ - 1) / F32_BQ, bh);
  kernel<<<grid, F32_THREADS, C::SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), n, scale);
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

// K1 in f32, no bias: q, k, v, out [bh, n, hd] f32, hd 64 or 80.
extern "C" int rat_flash_attention_f32(const void* q, const void* k, const void* v,
                                       void* out, int bh, int n, float scale, int hd,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh <= 0 || n <= 0 || bh > 65535) return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 64:
      return launch_f32<64>(q, k, v, out, bh, n, scale, s);
    case 80:
      return launch_f32<80>(q, k, v, out, bh, n, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory a CTA of the f32 kernel takes at head dim hd.
extern "C" int rat_flash_attention_f32_smem(int hd) {
  return hd == 64 ? F32Cfg<64>::SMEM : hd == 80 ? F32Cfg<80>::SMEM : 0;
}
