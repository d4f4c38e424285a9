// Tensor-core pieces of the probability-factored decode kernels: the
// fused decode tail (decode_tail.cu, B3, all three modes), the image ->
// token probabilities (i2t_probs.cu, B7) and the token -> image attention
// over the rebuilt branch (t2i_probs.cu, B8). The three families of
// per-tile products on a [32 positions x 256 channels] branch tile run on
// the tensor cores; beside them the shared-memory layouts they read
// without bank conflicts, the loads that fill them and the token-side
// pieces (pe terms, scores, softmaxes) on the FMA units. The f32 walks
// (B7 f32 layer 2, B8 f32, B3 f32's walks) are walk_f32.cuh's.
//
//   rebuild   Y <- LN(Y + P^T C + b)     mma.sync m16n8k16 / m16n8k8 bf16
//   scores    S[56 x 32] = Q^ . Y^T        mma.sync m16n8k16 fp16, split
//   context   ctx[56 x 256] += p . Y       mma.sync m16n8k16 fp16, split
//
// The rebuild is exact up to the order of summation: P and C are bf16, so
// every product is exact in f32, and the residual Y is the f32 branch
// itself (img0 for keys1; keys1 for keys2, kept in registers from one
// rebuild to the next, Frag). keys2 leaves from those registers as
// bf16(keys2).
//
// The f32 operands of the scores and the context (the branch Y, the
// query-side matrices Q^ and the probabilities p) are held as two fp16
// planes of the operand times a power of two s: x = v s, hi = f16(x), lo =
// f16(x - hi). Each product is hi.hi + hi.lo + lo.hi with f32 sums, then
// times 1 / s exactly. fp16 keeps 11 significant bits a plane, so hi + lo
// holds x to 2^-22 of its size (f32 itself: 2^-24) and a product to
// ~2^-21, as CUTLASS's 3xTF32 at half its tensor time (bf16 planes hold
// 2^-16). s keeps hi below fp16's 65504 and lo
// out of its subnormals: for Q^ from the matrix's max (x < 2^14), for Y
// from the LayerNorm's bound |y| <= 16 |scale| + |bias| a channel (x <
// 2^10, 64x to spare), for p (<= 1) 2^12. A value with |x| < 2^-3, far
// below the top, keeps an absolute error of 2^-25 in x instead.
//
// Rounding of the sums: mma.sync adds into its f32 accumulator without
// rounding to nearest, a bias that grows with every addition. So each
// product starts from a zero accumulator, and the residual, the bias and
// each tile's context join in f32 rounded to nearest (fmaf). With the
// context summed over a pass's 128 tiles inside the accumulators, the
// kernel moved 20% of the token state's bf16 elements against the plain
// f32 version; as here 4.9%, the FMA design 5.9% (kernels/tail_variants.py
// [precision], 64 prompts at M 4096).
//
// Fragments are PTX's mma.sync ones: in a warp, g = lane / 4 and q =
// lane % 4; ldmatrix matrix i takes its 8 row addresses from lanes 8i..
// 8i+7 (li = lane / 8, lr = lane % 8).
//
// Layouts (element offsets; the eight rows of every ldmatrix matrix fall
// in distinct 16-byte bank groups):
//   wide   16-bit [rows][256]: 16-byte chunk (col / 8) ^ (row & 7)
//          Y hi / lo [32 positions], Q^ hi / lo [56] (fp16), C [56] (bf16)
//   narrow 16-bit [rows][32]:  16-byte chunk (col / 8) ^ ((row >> 1) & 3)
//          P [56 k][32 positions] (bf16), p hi / lo [56][32 positions]
//          (fp16)
//   S      f32 [56][32]:     col ^ 8 * (row & 3)

#pragma once

#include <cuda_fp16.h>

#include "decode_common.cuh"
#include "hopper.cuh"

namespace rat_decode_tc {

using namespace rat_decode;
using rat_hopper::ldsm_x4;
using rat_hopper::ldsm_x4_trans;
using rat_hopper::mma_m16n8k16;
using rat_hopper::mma_m16n8k16_f16;
using rat_hopper::mma_m16n8k8;
using rat_hopper::pack_bf16;

static_assert(HT == 56 && BM == 32 && D == 256 && WARPS == 8,
              "the fragment maps below are written for these widths");

constexpr float P_SCALE = 4096.f;   // p's s
constexpr int Q_TOP = 14;           // Q^ s: max |Q^| s < 2^Q_TOP
constexpr int Y_TOP = 10;           // Y s: bound s < 2^Y_TOP

__device__ __forceinline__ int wide_idx(int row, int col) {
  return row * D + (((col >> 3) ^ (row & 7)) << 3) + (col & 7);
}
__device__ __forceinline__ int narrow_idx(int row, int col) {
  return row * BM + ((((col >> 3) ^ (row >> 1)) & 3) << 3) + (col & 7);
}
__device__ __forceinline__ int s_idx(int row, int col) { return row * BM + (col ^ ((row & 3) << 3)); }

// (a, b) as fp16 pairs hi = f16(a, b) and lo = f16(a - hi.x, b - hi.y).
__device__ __forceinline__ void split2(float a, float b, __half2& hi, __half2& lo) {
  hi = __floats2half2_rn(a, b);
  const float2 h = __half22float2(hi);
  lo = __floats2half2_rn(a - h.x, b - h.y);
}

__device__ __forceinline__ void split1(float a, __half& hi, __half& lo) {
  hi = __float2half_rn(a);
  lo = __float2half_rn(a - __half2float(hi));
}

// The power of two s with bound * s < 2^top (1 for a bound that is not
// positive and finite).
__device__ __forceinline__ float pow2_scale(float bound, int top) {
  if (!(bound > 0.f) || isinf(bound)) return 1.f;
  int e;
  frexpf(bound, &e);                             // bound < 2^e
  return ldexpf(1.f, max(-126, min(126, top - e)));
}

// Max of v over the CTA; scratch [WARPS] floats, free again on return.
__device__ __forceinline__ float block_max(float v, float* scratch) {
  v = warp_max(v);
  if (threadIdx.x % 32 == 0) scratch[threadIdx.x / 32] = v;
  __syncthreads();
  float m = scratch[0];
#pragma unroll
  for (int i = 1; i < WARPS; ++i) m = fmaxf(m, scratch[i]);
  __syncthreads();
  return m;
}

// s of the two branch layers' Y planes, into scale[0], scale[1]: |y| <=
// |(y - mu) rs| |ln scale| + |ln bias| <= 16 |ln scale| + |ln bias| a
// channel, since no normalized value of 256 exceeds sqrt(255). vec = the
// two layers' {b, ln scale, ln bias} [6][D] bf16 (shared).
__device__ __forceinline__ void branch_scales(float* scale, float* scratch,
                                              const __nv_bfloat16* vec) {
  const int d = threadIdx.x;
#pragma unroll
  for (int l = 0; l < 2; ++l) {
    const float bound = block_max(16.f * fabsf(__bfloat162float(vec[(3 * l + 1) * D + d])) +
                                      fabsf(__bfloat162float(vec[(3 * l + 2) * D + d])),
                                  scratch);
    if (d == 0) scale[l] = pow2_scale(bound, Y_TOP);
  }
}

// Loads issued where they stand: the products around them are volatile
// asm, and a plain load could sink below them to its first use.
__device__ __forceinline__ uint32_t lds32(const void* p) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(rat_hopper::smem_u32(p)));
  return v;
}

// A bf16 pair (x the low half) as two floats.
__device__ __forceinline__ float2 bf2(uint32_t v) {
  return make_float2(__uint_as_float(v << 16), __uint_as_float(v & 0xffff0000u));
}

// The calling thread's column of a transposed pe term: pet[h*HD + j][col]
// for its head h (its warp), j < HD, as raw bf16 bits, asked for ahead of
// its use so that the L2 latency hides under the work in between.
struct PeCol {
  unsigned short v[HD];
};

__device__ __forceinline__ void load_pe(PeCol& pe, const __nv_bfloat16* pet, int m, int col) {
  const __nv_bfloat16* p = pet + (size_t)(threadIdx.x / 32) * HD * m + col;
#pragma unroll
  for (int j = 0; j < HD; ++j)
    asm volatile("ld.global.nc.u16 %0, [%1];\n" : "=h"(pe.v[j]) : "l"(p + (size_t)j * m));
}

// A thread's fragment of the branch tile, f32: rows 16 mt + g + 8 hf,
// channels 32 w + 8 nt + 2 q (+ 1) at [mt][nt][2 hf (+ 1)], the layout of
// an m16n8 accumulator.
using Frag = float[2][4][4];

// The same fragment of img0 rows m0.. ([M, D] bf16) as raw bf16 pairs
// [mt][hf][nt], asked for ahead of its use (as load_pe).
using ImgFrag = uint32_t[2][2][4];

__device__ __forceinline__ void load_img0(ImgFrag& v, const __nv_bfloat16* img0, int m0) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const __nv_bfloat16* p = img0 + (size_t)(m0 + lane / 4) * D + 32 * warp + 2 * (lane % 4);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        asm volatile("ld.global.nc.b32 %0, [%1];\n"
                     : "=r"(v[mt][hf][nt])
                     : "l"(p + (size_t)(16 * mt + 8 * hf) * D + 8 * nt));
}

// One prompt's C [HT, D] bf16 (global) into the wide layout.
__device__ __forceinline__ void stage_c(__nv_bfloat16* sC, const __nv_bfloat16* c) {
  constexpr int VPR = D / 8;
  for (int i = threadIdx.x; i < HT * VPR; i += THREADS) {
    const int k = i / VPR, j = i % VPR;
    *reinterpret_cast<uint4*>(sC + wide_idx(k, 8 * j)) =
        reinterpret_cast<const uint4*>(c + (size_t)k * D)[j];
  }
}

// n bf16 values (n % 8 == 0, both 16-byte aligned) copied as they are.
__device__ __forceinline__ void copy16(__nv_bfloat16* dst, const __nv_bfloat16* src, int n) {
  for (int i = threadIdx.x; i < n / 8; i += THREADS)
    reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
}

// 16 bytes from device to shared memory by cp.async (through the L2
// only), in commit groups: a thread waits for its own groups, then a CTA
// barrier makes every thread's copies visible.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(rat_hopper::smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Waits until at most one of the thread's groups is still in flight.
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Positions m0..m0+BM-1 of one prompt's P^T [HT, m] bf16 (global; m and
// m0 multiples of BM) into the narrow P tile [HT k][BM] that rebuild_tc
// reads, by cp.async: 56 rows x 4 16-byte chunks, each to its permuted
// chunk. The caller commits the group.
__device__ __forceinline__ void load_p_async(__nv_bfloat16* sP, const __nv_bfloat16* p, int m,
                                             int m0) {
  for (int i = threadIdx.x; i < HT * (BM / 8); i += THREADS) {
    const int k = i / (BM / 8), c = i % (BM / 8);
    cp_async16(sP + narrow_idx(k, 8 * c), p + (size_t)k * m + m0 + 8 * c);
  }
}

// The fragment's rows as bf16 to out rows ([BM][D], the tile's): the four
// threads of a quad swap channel pairs until each holds 8 adjacent
// channels of a row, then one 16-byte store a thread and row, marked
// evict-first (keys2 streams past the L2, which holds the operands every
// CTA shares).
__device__ __forceinline__ void emit_rows(__nv_bfloat16* out, const Frag& y) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      uint32_t pk[4], o[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) pk[nt] = pack_bf16(y[mt][nt][2 * hf], y[mt][nt][2 * hf + 1]);
      // step i: lane q gets pair q of lane (q + i) % 4, its channels
      // 8 q + 2 ((q + i) % 4)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int give = (q - i) & 3, from = (q + i) & 3;
        const uint32_t v = give == 0 ? pk[0] : give == 1 ? pk[1] : give == 2 ? pk[2] : pk[3];
        const uint32_t r = __shfl_sync(0xffffffffu, v, (lane & ~3) | from);
#pragma unroll
        for (int j = 0; j < 4; ++j) o[j] = from == j ? r : o[j];
      }
      __stcs(reinterpret_cast<uint4*>(out + (size_t)(16 * mt + g + 8 * hf) * D + 32 * warp + 8 * q),
             make_uint4(o[0], o[1], o[2], o[3]));
    }
}

// One branch update on the tile: Y <- LN(Y + P^T C + b) per position,
// with the one-pass variance max(E[y^2] - mu^2, 0) (the JAX `_recon_t`,
// ops/decode_probs.py:51, and `_recon_step`, ops/decode_fused.py:94). The
// residual is img (FROM_IMG0: keys1) or y itself (keys2); y ends as the
// new branch, f32, its planes x ys in sYh / sYl, and as bf16 in out rows
// (when out is given). sP narrow [HT k][BM] and sC wide (rows 56..63 of K
// are never read: the last step is k8), vec = {b, ln scale, ln bias}
// [3][D] bf16, red a [BM][WARPS] float2 scratch. M = 32 positions (2
// m16), K = 56 (3 k16 + 1 k8), N = 256: warp w takes channels 32w..32w+31
// (4 n8), 32 mma.sync, fragments by ldmatrix.trans. The residual and b
// are added after the products, in f32 rounded to nearest as the plain
// version adds them (the tensor cores' own additions into an accumulator
// do not round to nearest). The LayerNorm runs on the accumulators, its
// row sums reduced over the quad by shuffles and over the warps through
// red, the four rows of a thread side by side. Ends with the tile
// complete (synchronised).
template <bool FROM_IMG0>
__device__ __forceinline__ void rebuild_tc(Frag& y, const ImgFrag& img, __half* sYh, __half* sYl,
                                           const __nv_bfloat16* sP, const __nv_bfloat16* sC,
                                           const __nv_bfloat16* vec, float2* red, float eps,
                                           float ys, __nv_bfloat16* out = nullptr) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4, li = lane / 8, lr = lane % 8;
  const int col0 = 32 * warp + 2 * q;           // + 8 nt
  uint32_t vb[4], vs[4], vi[4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    vb[nt] = lds32(vec + col0 + 8 * nt);
    vs[nt] = lds32(vec + D + col0 + 8 * nt);
    vi[nt] = lds32(vec + 2 * D + col0 + 8 * nt);
  }
  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  // P's rows k are the A operand's columns: matrix li is (m + 8 (li & 1),
  // k + 8 (li >> 1)); C's matrix li is (k + 8 (li & 1), n + 8 (li >> 1))
#pragma unroll
  for (int k0 = 0; k0 < 48; k0 += 16) {
    uint32_t a[2][4], b[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      ldsm_x4_trans(a[mt], sP + narrow_idx(k0 + lr + 8 * (li >> 1), 16 * mt + 8 * (li & 1)));
#pragma unroll
    for (int np = 0; np < 2; ++np)
      ldsm_x4_trans(b[np], sC + wide_idx(k0 + lr + 8 * (li & 1), 32 * warp + 16 * np + 8 * (li >> 1)));
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        mma_m16n8k16(acc[mt][nt], a[mt], b[nt >> 1][2 * (nt & 1)], b[nt >> 1][2 * (nt & 1) + 1]);
  }
  {
    // K rows 48..55: matrix li of P is (m 8 li, k 48); of C (k 48, n 8 li)
    uint32_t a[4], b[4];
    ldsm_x4_trans(a, sP + narrow_idx(48 + lr, 8 * li));
    ldsm_x4_trans(b, sC + wide_idx(48 + lr, 32 * warp + 8 * li));
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mma_m16n8k8(acc[mt][nt], a[2 * mt], a[2 * mt + 1], b[nt]);
  }
  // y = (Y + P^T C) + b
  float s[2][2], ss[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      s[mt][hf] = 0.f;
      ss[mt][hf] = 0.f;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float2 bb = bf2(vb[nt]);
        const float2 r = FROM_IMG0 ? bf2(img[mt][hf][nt])
                                   : make_float2(y[mt][nt][2 * hf], y[mt][nt][2 * hf + 1]);
        const float v0 = (r.x + acc[mt][nt][2 * hf]) + bb.x;
        const float v1 = (r.y + acc[mt][nt][2 * hf + 1]) + bb.y;
        y[mt][nt][2 * hf] = v0;
        y[mt][nt][2 * hf + 1] = v1;
        s[mt][hf] += v0 + v1;
        ss[mt][hf] += v0 * v0 + v1 * v1;
      }
    }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        s[mt][hf] += __shfl_xor_sync(0xffffffffu, s[mt][hf], off);
        ss[mt][hf] += __shfl_xor_sync(0xffffffffu, ss[mt][hf], off);
      }
  if (q == 0)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        red[(16 * mt + g + 8 * hf) * WARPS + warp] = make_float2(s[mt][hf], ss[mt][hf]);
  __syncthreads();
  float4 r4[2][2][WARPS / 2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int i = 0; i < WARPS / 2; ++i)
        r4[mt][hf][i] = reinterpret_cast<const float4*>(red + (16 * mt + g + 8 * hf) * WARPS)[i];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float sum = 0.f, sum2 = 0.f;
#pragma unroll
      for (int i = 0; i < WARPS / 2; ++i) {
        sum += r4[mt][hf][i].x + r4[mt][hf][i].z;
        sum2 += r4[mt][hf][i].y + r4[mt][hf][i].w;
      }
      const float mu = sum / D;
      const float rs = rsqrtf(fmaxf(sum2 / D - mu * mu, 0.f) + eps);
      const int row = 16 * mt + g + 8 * hf;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float2 sc = bf2(vs[nt]), bi = bf2(vi[nt]);
        const float v0 = (y[mt][nt][2 * hf] - mu) * rs * sc.x + bi.x;
        const float v1 = (y[mt][nt][2 * hf + 1] - mu) * rs * sc.y + bi.y;
        y[mt][nt][2 * hf] = v0;
        y[mt][nt][2 * hf + 1] = v1;
        __half2 hi, lo;
        split2(v0 * ys, v1 * ys, hi, lo);
        const int o = wide_idx(row, col0 + 8 * nt);
        *reinterpret_cast<__half2*>(sYh + o) = hi;
        *reinterpret_cast<__half2*>(sYl + o) = lo;
      }
    }
  if (out) emit_rows(out, y);
  __syncthreads();
}

// S = Q^ . Y^T into sS (rows h*T + t, the tile's positions), both planes
// scaled (S times Q^'s s and Y's): 4 m16 x 4 n8 fragments over 16 k16
// steps. Warp w takes the rows of m16 tile w % 4 (rows past HT read row
// HT - 1 and are zeroed) against all 32 positions over K half w / 4: 24
// KB of fragments a warp, where halves of the positions would read 32 KB.
// Per step 6 ldmatrix (Q^ hi, lo; Y hi, lo for two n8 tiles, twice) and
// 12 mma.sync; hi.hi and the two cross terms accumulate apart. The second
// K half leaves its sums in sS, the first adds them (one CTA barrier).
__device__ __forceinline__ void scores_tc(float* sS, const __half* sQh, const __half* sQl,
                                          const __half* sYh, const __half* sYl) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4, li = lane / 8, lr = lane % 8;
  const int mt = warp & 3, k1 = (warp >> 2) * (D / 2);
  const bool pad = 16 * mt + 8 >= HT;           // rows 56..63 of the last m16
  const int arow = min(16 * mt + 8 * (li & 1) + lr, HT - 1);
  float acc[4][2][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][p][e] = 0.f;
#pragma unroll 2
  for (int k0 = k1; k0 < k1 + D / 2; k0 += 16) {
    uint32_t x[2][4], y[2][2][4];               // Q^ hi, lo; [positions half][Y hi, lo]
    ldsm_x4(x[0], sQh + wide_idx(arow, k0 + 8 * (li >> 1)));
    ldsm_x4(x[1], sQl + wide_idx(arow, k0 + 8 * (li >> 1)));
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      const int o = wide_idx(16 * np + 8 * (li >> 1) + lr, k0 + 8 * (li & 1));
      ldsm_x4(y[np][0], sYh + o);
      ldsm_x4(y[np][1], sYl + o);
    }
    const uint32_t ah[4] = {x[0][0], pad ? 0u : x[0][1], x[0][2], pad ? 0u : x[0][3]};
    const uint32_t al[4] = {x[1][0], pad ? 0u : x[1][1], x[1][2], pad ? 0u : x[1][3]};
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const uint32_t* bh = y[nt >> 1][0] + 2 * (nt & 1);
      const uint32_t* bl = y[nt >> 1][1] + 2 * (nt & 1);
      mma_m16n8k16_f16(acc[nt][0], ah, bh[0], bh[1]);
      mma_m16n8k16_f16(acc[nt][1], ah, bl[0], bl[1]);
      mma_m16n8k16_f16(acc[nt][1], al, bh[0], bh[1]);
    }
  }
  const int r0 = 16 * mt + g;
  const bool first = k1 == 0;
  if (!first)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = 8 * nt + 2 * q;
      *reinterpret_cast<float2*>(sS + s_idx(r0, col)) =
          make_float2(acc[nt][0][0] + acc[nt][1][0], acc[nt][0][1] + acc[nt][1][1]);
      if (!pad)
        *reinterpret_cast<float2*>(sS + s_idx(r0 + 8, col)) =
            make_float2(acc[nt][0][2] + acc[nt][1][2], acc[nt][0][3] + acc[nt][1][3]);
    }
  __syncthreads();
  if (first)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = 8 * nt + 2 * q;
      float2* lo = reinterpret_cast<float2*>(sS + s_idx(r0, col));
      const float2 o = *lo;
      *lo = make_float2(acc[nt][0][0] + acc[nt][1][0] + o.x, acc[nt][0][1] + acc[nt][1][1] + o.y);
      if (!pad) {
        float2* hi = reinterpret_cast<float2*>(sS + s_idx(r0 + 8, col));
        const float2 u = *hi;
        *hi = make_float2(acc[nt][0][2] + acc[nt][1][2] + u.x,
                          acc[nt][0][3] + acc[nt][1][3] + u.y);
      }
    }
}

// One head's HD weights of a row of W [D][DA] as f32: bf16 (two 16-byte
// loads) or f32 (four).
__device__ __forceinline__ void load_w_head(float w[HD], const __nv_bfloat16* row) {
  const uint4* wrow = reinterpret_cast<const uint4*>(row);
  unpack8(wrow[0], w);
  unpack8(wrow[1], w + 8);
}
__device__ __forceinline__ void load_w_head(float w[HD], const float* row) {
#pragma unroll
  for (int i = 0; i < HD / 4; ++i) {
    const float4 v = reinterpret_cast<const float4*>(row)[i];
    w[4 * i] = v.x;
    w[4 * i + 1] = v.y;
    w[4 * i + 2] = v.z;
    w[4 * i + 3] = v.w;
  }
}

// Token-side matrix pushed through a projection: Q^[h*T + t][d] =
// sum_j q[t][h*HD + j] * W[d][h*HD + j], the query side of (q_h W_h^T) .
// Y = q_h . (Y W_h), so the per-position product shrinks to HT rows (the
// JAX fused tail's `_bd_attend_q`). Into Q^'s hi and lo planes (the
// scores' A operand) times the power of two *scale (written by thread 0),
// chosen from the matrix's max; the products are computed twice, once for
// the max. q [T][DA] f32 (shared), W [D][DA] bf16 or f32 (global),
// scratch [WARPS] floats.
template <typename WT>
__device__ __forceinline__ void project_rows_tc(__half* sQh, __half* sQl, float* scale,
                                                float* scratch, const float* sq, const WT* W) {
  const int d = threadIdx.x;
  float mx = 0.f, s = 1.f;
#pragma unroll 1
  for (int pass = 0; pass < 2; ++pass) {
#pragma unroll 1
    for (int h = 0; h < H; ++h) {
      float w[HD];
      load_w_head(w, W + (size_t)d * DA + h * HD);
#pragma unroll
      for (int t = 0; t < T; ++t) {
        float a = 0.f;
#pragma unroll
        for (int j = 0; j < HD; ++j) a = fmaf(sq[t * DA + h * HD + j], w[j], a);
        if (pass == 0) {
          mx = fmaxf(mx, fabsf(a));
        } else {
          const int o = wide_idx(h * T + t, d);
          split1(a * s, sQh[o], sQl[o]);
        }
      }
    }
    if (pass == 0) s = pow2_scale(block_max(mx, scratch), Q_TOP);
  }
  if (d == 0) *scale = s;
}

// Token-side dense layers on T rows: out[t][n] = bf16(bf16(x[t] . W[:,
// n]) + b[n]), optionally ReLU'd (the JAX `_dense_rows` rounding; each
// output's f32 sum runs over k in order), with wide loads: x by float4
// over four k, and W by 16 bytes (8 outputs a thread, dense_rows_n8: N %
// 8 == 0) or one output a thread (dense_rows_k4). x [T][K] f32 (shared,
// 16-byte aligned rows, K % 4 == 0), W [K][N] bf16 (global), out [T][N]
// f32 (shared). dense_rows_k4 also takes an f32 SAM's f32 W and b, and
// then rounds nothing (the JAX `_dense_rows` at f32; out shared or
// global).
template <typename WT>
__device__ __forceinline__ float dense_out(float acc, const WT* b, int n, bool relu) {
  const float y = round_tok<WT>(round_tok<WT>(acc) + ldw(b + n));
  return relu ? fmaxf(y, 0.f) : y;
}

__device__ __forceinline__ void dense_rows_n8(float* out, const float* x, int K,
                                              const __nv_bfloat16* W, const __nv_bfloat16* b,
                                              int N, bool relu) {
  for (int n8 = threadIdx.x; n8 < N / 8; n8 += THREADS) {
    float acc[T][8];
#pragma unroll
    for (int t = 0; t < T; ++t)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[t][e] = 0.f;
#pragma unroll 2
    for (int k = 0; k < K; k += 4) {
      float w[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        unpack8(*reinterpret_cast<const uint4*>(W + (size_t)(k + i) * N + 8 * n8), w[i]);
#pragma unroll
      for (int t = 0; t < T; ++t) {
        const float4 xv = *reinterpret_cast<const float4*>(x + t * K + k);
        const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[t][e] = fmaf(xs[i], w[i][e], acc[t][e]);
      }
    }
#pragma unroll
    for (int t = 0; t < T; ++t)
#pragma unroll
      for (int e = 0; e < 8; ++e) out[t * N + 8 * n8 + e] = dense_out(acc[t][e], b, 8 * n8 + e, relu);
  }
}

template <typename WT>
__device__ __forceinline__ void dense_rows_k4(float* out, const float* x, int K, const WT* W,
                                              const WT* b, int N, bool relu) {
  for (int n = threadIdx.x; n < N; n += THREADS) {
    float acc[T];
#pragma unroll
    for (int t = 0; t < T; ++t) acc[t] = 0.f;
#pragma unroll 4
    for (int k = 0; k < K; k += 4) {
      float w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) w[i] = ldw(W + (size_t)(k + i) * N + n);
#pragma unroll
      for (int t = 0; t < T; ++t) {
        const float4 xv = *reinterpret_cast<const float4*>(x + t * K + k);
        acc[t] = fmaf(xv.w, w[3], fmaf(xv.z, w[2], fmaf(xv.y, w[1], fmaf(xv.x, w[0], acc[t]))));
      }
    }
#pragma unroll
    for (int t = 0; t < T; ++t) out[t * N + n] = dense_out(acc[t], b, n, relu);
  }
}

// s[t] += sum_j q[t][h*HD + j] * pet[h*HD + j][col] for the calling
// thread's head h (its warp): a token-side vector against a transposed
// positional term, with the token vectors q [T][DA] held as bf16 (they are
// bf16 values: loaded from bf16 or rounded by the dense layers) and the pe
// column already loaded (load_pe).
__device__ __forceinline__ void add_pe_term_bf(float s[T], const __nv_bfloat16* sq,
                                               const PeCol& col) {
  const int h = threadIdx.x / 32;
  float pe[HD];
#pragma unroll
  for (int j = 0; j < HD; ++j) pe[j] = __uint_as_float((uint32_t)col.v[j] << 16);
#pragma unroll
  for (int t = 0; t < T; ++t) {
    float q[HD];
    unpack8(*reinterpret_cast<const uint4*>(sq + t * DA + h * HD), q);
    unpack8(*reinterpret_cast<const uint4*>(sq + t * DA + h * HD + 8), q + 8);
    float a = 0.f;
#pragma unroll
    for (int j = 0; j < HD; ++j) a = fmaf(q[j], pe[j], a);
    s[t] += a;
  }
}

// The same pe term with the token vectors q [T][DA] held as f32 (shared),
// for a walk whose tiles all read the same vectors and whose work is
// mostly this term (B7 layer 1): they are converted once a CTA instead of
// once a tile.
__device__ __forceinline__ void add_pe_term_f32(float s[T], const float* sq, const PeCol& col) {
  const int h = threadIdx.x / 32;
  float pe[HD];
#pragma unroll
  for (int j = 0; j < HD; ++j) pe[j] = __uint_as_float((uint32_t)col.v[j] << 16);
#pragma unroll
  for (int t = 0; t < T; ++t) {
    float a = 0.f;
#pragma unroll
    for (int j = 0; j < HD; ++j) a = fmaf(sq[t * DA + h * HD + j], pe[j], a);
    s[t] += a;
  }
}

// Scores of the calling thread's head (its warp) and position (its lane):
// the tile's S times unscale (1 / the planes' s, exact), plus a pe term,
// scaled.
__device__ __forceinline__ void head_scores_tc(float s[T], const float* sS,
                                               const __nv_bfloat16* sq, const PeCol& pe,
                                               float unscale) {
  const int h = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int t = 0; t < T; ++t) s[t] = sS[s_idx(h * T + t, lane)] * unscale;
  add_pe_term_bf(s, sq, pe);
  const float scale = rsqrtf((float)HD);
#pragma unroll
  for (int t = 0; t < T; ++t) s[t] *= scale;
}

// Probabilities s[T] of the calling thread's head and position into the
// narrow P tile [HT k][BM], rounded to bf16.
__device__ __forceinline__ void store_p(__nv_bfloat16* sP, const float s[T]) {
  const int h = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int t = 0; t < T; ++t) sP[narrow_idx(h * T + t, lane)] = __float2bfloat16(s[t]);
}

// The same probabilities to out, [HT][m] bf16 rows from the tile's first
// position.
__device__ __forceinline__ void emit_p(__nv_bfloat16* out, int m, const float s[T]) {
  const int h = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int t = 0; t < T; ++t) out[(size_t)(h * T + t) * m + lane] = __float2bfloat16(s[t]);
}

// Online softmax of one head's T token rows over the positions: the
// running max (the same in every lane) and each lane's share of the
// running sum. The context itself lives in the mma accumulators
// (context_tc).
struct Online {
  float m[T];
  float l[T];
};

__device__ __forceinline__ void online_init(Online& st) {
#pragma unroll
  for (int t = 0; t < T; ++t) {
    st.m[t] = -INFINITY;
    st.l[t] = 0.f;
  }
}

// Fold one tile's scaled scores s[T] (the calling thread's head and
// position) into the state: p = exp(s - max) into the hi and lo planes
// sPh, sPl [HT][BM] (narrow) times P_SCALE, the rows' rescale factors
// into alpha[HT]. The seven rows' warp maxima run side by side.
__device__ __forceinline__ void online_tile(Online& st, const float s[T], __half* sPh,
                                            __half* sPl, float* alpha) {
  const int h = threadIdx.x / 32, lane = threadIdx.x % 32;
  float mx[T];
#pragma unroll
  for (int t = 0; t < T; ++t) mx[t] = s[t];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int t = 0; t < T; ++t) mx[t] = fmaxf(mx[t], __shfl_xor_sync(0xffffffffu, mx[t], off));
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const float m_new = fmaxf(st.m[t], mx[t]);
    const float a = (st.m[t] == -INFINITY) ? 0.f : expf(st.m[t] - m_new);
    const float p = expf(s[t] - m_new);
    st.l[t] = st.l[t] * a + p;
    st.m[t] = m_new;
    const int o = narrow_idx(h * T + t, lane);
    split1(p * P_SCALE, sPh[o], sPl[o]);
    if (lane == 0) alpha[h * T + t] = a;
  }
}

// 1 / sum of each row into alpha[HT], once the last tile is folded in.
__device__ __forceinline__ void online_finish(const Online& st, float* alpha) {
  const int h = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const float inv = 1.f / warp_sum(st.l[t]);
    if (lane == 0) alpha[h * T + t] = inv;
  }
}

// The context accumulators of a warp: rows 16 mt + g (+ 8), channels
// 32 w + 8 nt + 2 q (+ 1), 64 f32 a thread; rows 56..63 stay zero.
using Ctx = float[4][4][4];

__device__ __forceinline__ void context_init(Ctx& ctx) {
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) ctx[mt][nt][e] = 0.f;
}

// ctx <- ctx * alpha[row] + p . Y: M 64 (56 rows), N = the warp's 32
// channels, K = the tile's 32 positions (2 k16 steps). Y's fragments by
// ldmatrix.trans, all of them first; then per m16 tile its p fragments
// by ldmatrix (rows past HT read row HT - 1 and are zeroed; the next
// tile's asked for before this one's 24 mma.sync) into a fresh
// accumulator, which joins ctx in f32 rounded to nearest (fmaf(ctx,
// alpha, tile)): across the 128 tiles of a pass the tensor cores' own
// additions, which do not round to nearest, would bias ctx.
__device__ __forceinline__ void context_tc(Ctx& ctx, const __half* sPh, const __half* sPl,
                                           const float* alpha, const __half* sYh,
                                           const __half* sYl) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, li = lane / 8, lr = lane % 8;
  // Y's matrix li: (positions 16 ks + 8 (li & 1), channels c0 + 8 (li >>
  // 1)); p's: (rows 16 mt + 8 (li & 1), positions 16 ks + 8 (li >> 1))
  uint32_t bh[2][2][4], bl[2][2][4], a[2][2][2][4];   // a: [buffer][hi, lo][ks]
  float a0[4], a1[4];                                   // alpha of rows 16 mt + g (+ 8)
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    a0[mt] = __uint_as_float(lds32(alpha + 16 * mt + g));
    a1[mt] = mt < 3 ? __uint_as_float(lds32(alpha + 16 * mt + g + 8)) : 0.f;
  }
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      const int o = wide_idx(16 * ks + 8 * (li & 1) + lr, 32 * warp + 16 * np + 8 * (li >> 1));
      ldsm_x4_trans(bh[ks][np], sYh + o);
      ldsm_x4_trans(bl[ks][np], sYl + o);
    }
  auto load_p = [&](uint32_t (&f)[2][2][4], int mt) {
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const int o = narrow_idx(min(16 * mt + 8 * (li & 1) + lr, HT - 1), 16 * ks + 8 * (li >> 1));
      ldsm_x4(f[0][ks], sPh + o);
      ldsm_x4(f[1][ks], sPl + o);
    }
  };
  load_p(a[0], 0);
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    uint32_t (&f)[2][2][4] = a[mt & 1];
    if (mt < 3) load_p(a[(mt + 1) & 1], mt + 1);
    const bool pad = mt == 3;                   // rows 56..63
    float acc[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const uint32_t a_h[4] = {f[0][ks][0], pad ? 0u : f[0][ks][1], f[0][ks][2],
                               pad ? 0u : f[0][ks][3]};
      const uint32_t a_l[4] = {f[1][ks][0], pad ? 0u : f[1][ks][1], f[1][ks][2],
                               pad ? 0u : f[1][ks][3]};
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const uint32_t* b_h = bh[ks][nt >> 1] + 2 * (nt & 1);
        const uint32_t* b_l = bl[ks][nt >> 1] + 2 * (nt & 1);
        mma_m16n8k16_f16(acc[nt], a_h, b_h[0], b_h[1]);
        mma_m16n8k16_f16(acc[nt], a_h, b_l[0], b_l[1]);
        mma_m16n8k16_f16(acc[nt], a_l, b_h[0], b_h[1]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      ctx[mt][nt][0] = fmaf(ctx[mt][nt][0], a0[mt], acc[nt][0]);
      ctx[mt][nt][1] = fmaf(ctx[mt][nt][1], a0[mt], acc[nt][1]);
      ctx[mt][nt][2] = fmaf(ctx[mt][nt][2], a1[mt], acc[nt][2]);
      ctx[mt][nt][3] = fmaf(ctx[mt][nt][3], a1[mt], acc[nt][3]);
    }
  }
}

// ctx * unscale * inv[row] -> out [HT][D] f32 (decode_common.cuh's
// context layout, what attn_out reads); unscale = 1 / the planes' s, exact.
__device__ __forceinline__ void context_store(const Ctx& ctx, const float* inv, float unscale,
                                              float* out) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = 16 * mt + g + 8 * hf;
      if (row >= HT) continue;
      const float r = inv[row];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        *reinterpret_cast<float2*>(out + row * D + 32 * warp + 8 * nt + 2 * q) =
            make_float2(ctx[mt][nt][2 * hf] * unscale * r, ctx[mt][nt][2 * hf + 1] * unscale * r);
    }
}

}  // namespace rat_decode_tc
