// The f32 walks over the rebuilt SAM image branch: B8 f32 (t2i_probs.cu
// rat_t2i_probs_f32 / rat_t2i_probs_f32_keys: the token -> image
// attention at depth 1 or 2) and B7 f32 layer 2 (i2t_probs.cu
// rat_i2t_probs_f32: the image -> token probabilities over keys1). An f32
// SAM's operands (img0, C, pe terms, weights, branch rows and token
// vectors f32; P bf16), one kernel template for the three walks.
//
// What bounds it on the H100: the products against the f32 branch at the
// fp16 tensor rate, ~0.97 / 1.22 ms at 1024 prompts x M 4096 (depth 1 /
// 2; B7 layer 2 0.61): per position the rebuild is 56 x 256
// multiply-adds a layer as two fp16 passes, the scores 56 x 256 as three,
// and B8's context 56 x 256 as three. The design before this one (one
// CTA of 8 warps a prompt, 32-position tiles, the same products) ran at
// 0.14 of that, alternating tensor and FMA phases between 7 (depth 1) to
// 9 (depth 2) CTA barriers a tile (kernels/probs_compare.py --f32
// --phases reads the cycles of each statement of a tile).
//
// Design: two warpgroups a CTA (one CTA a prompt), each walking every
// other tile of 16 positions with its own online-softmax state and
// context, the two states merged once at the end in a fixed order (as
// split-K flash decoding merges them). A warpgroup synchronises only
// with itself, by named barriers (bar.sync 1 + wg, 128), three a tile at
// depth 1 (four at depth 2): the LayerNorm's row sums, the partial
// scores, the probabilities; no CTA barrier runs in the tile loop. Warp w
// of a warpgroup owns channels 64 w .. 64 w + 63 of the branch tile for
// the whole tile:
//   rebuild  Y[16 x 64] = P^T C + residual + b, LN    mma.sync fp16, 2 passes
//   scores   S_w[56 x 16] = Q^[:, own] . Y^T           mma.sync fp16, 3 passes
//   context  ctx[56 x own] += p . Y                    mma.sync fp16, 3 passes
// so the branch tile never leaves the registers: the rebuild's
// accumulators are the f32 branch, split into fp16 hi / lo planes they
// are the scores' B fragments as they lie, and transposed by movmatrix
// they are the context's. The scores over the four warps' channel
// quarters are summed in a fixed order by the softmax threads (one a
// head and position). P tiles arrive by TMA (a 2-D box of [56 rows, 16
// positions] bf16 a layer, 32-byte swizzled: the layout ldmatrix reads
// without bank conflicts) into a two-stage ring, stage = the tile's
// parity = its warpgroup, completing on that stage's mbarrier; one
// thread of the warpgroup asks for the tile after next once the rebuild
// has read the stage. The compute threads neither copy nor convert P in
// shared memory: its fragments go from bf16 to fp16 x 2^15 in registers.
//
// What the measurement showed (PERF.md §6): a warpgroup's 16-position
// tile takes about the cycles the 8 warps of the design before took for
// 32 positions, phase by phase, so the two warpgroups together gain only
// what the barriers and the P conversion cost. What sets the pace is
// each warp's own stream: the same products a warp per 32 positions as
// before, in dependent chains (a rebuild's k steps, a context tile's
// three passes, the softmax's shuffles), with two warps an SM
// sub-partition to hide their latency. So the registers decide: the
// context holds 112 a thread (a state a warpgroup), and the 255 cap
// leaves B8 f32 little room to run independent products side by side.
// Hence (each choice timed against the others in one call,
// kernels/probs_compare.py --f32 --variants):
// - at depth 1, where shared memory has the room, the context's rows
//   32..55 live in shared memory (Ctx<true>, 24 KB a warpgroup): 48
//   registers a thread freed, no spill, and B8 f32 at depth 1 ~11%
//   faster; depth 2 has 3 KB spare and keeps the whole context in
//   registers;
// - independent products side by side where that was faster (NP, MP in
//   the kernel);
// - outside the tile loop (once a prompt): Q^ is computed once, every W
//   row asked for at once (project_rows_f32), C's loads are all in
//   flight before its split, the merge reads each row's factors from a
//   table, and the value projection runs a thread a column over the 7
//   tokens at once (value_out).
//
// Why mma.sync and not wgmma: the rebuild's M is the tile's 16 positions
// (shared memory caps a warpgroup's tile there at depth 2: C1's and C2's
// planes take 114,688 B and Q^'s 57,344), below wgmma's 64 rows; the
// scores and the context would fit (Q^'s and p's 56 rows padded to 64),
// but wgmma reads B from shared memory, so the branch tile would go
// through shared memory and back (16 KB a warpgroup that depth 2 does
// not have), and a wgmma accumulator of the context holds the 8 padding
// rows too (128 floats a thread against the 112 of the m16n8 layout),
// under the 255-register cap that two warpgroups without a producer warp
// keep (a ninth warp caps a thread at 168). The loads need no producer
// warp: one TMA a tile.
//
// Arithmetic (as the parent's; the bounds are in decode_tc.cuh's notes):
// the rebuild exact up to summation order (P bf16 -> fp16 x 2^15 exact,
// C as two fp16 planes of C s, 22 bits, each plane's product from a
// fresh accumulator, the residual and b joined in f32 rounded to
// nearest); the scores and the context as three fp16 products of hi / lo
// planes of power-of-two-scaled f32 operands (22 bits); the context's
// tile products from fresh accumulators joined in f32 by fmaf; the
// output f32, unrounded; the merge in a fixed order, so the result is
// bitwise repeatable.

#pragma once

#include <cuda_fp16.h>

#include "decode_common.cuh"
#include "decode_tc.cuh"
#include "hopper.cuh"

namespace rat_walk_f32 {

using namespace rat_decode;
using namespace rat_decode_tc;
using rat_hopper::ldsm_x4;
using rat_hopper::ldsm_x4_trans;
using rat_hopper::mbar_expect_tx;
using rat_hopper::mbar_init;
using rat_hopper::mbar_wait;
using rat_hopper::mma_m16n8k16_f16;
using rat_hopper::named_sync;
using rat_hopper::smem_u32;
using rat_hopper::tma_load_2d;

constexpr int TP = 16;               // positions of a warpgroup's tile
constexpr int WGT = 128;             // threads of a warpgroup
constexpr float PF_SCALE = 32768.f;  // P's s in the rebuild (P 2^15 <= 2^15 < 65504)
constexpr int C_TOP = 14;            // C's s: max |C| s < 2^C_TOP

// What a walk does after its scores.
enum Kind { ATTEND = 0, ATTEND_KEYS = 1, PROBS = 2 };

// [rows][16 positions] 16-bit, 16-byte chunk (col / 8) ^ ((row >> 2) & 1):
// the layout a TMA box of 16 bf16 columns writes with 32-byte swizzle,
// and conflict-free for ldmatrix (8 rows at 32-byte pitch).
__device__ __forceinline__ int p16_idx(int row, int col) {
  return row * TP + ((((col >> 3) ^ (row >> 2)) & 1) << 3) + (col & 7);
}
// f32 [rows][16]: col ^ 4 ((row >> 1) & 3), conflict-free for a warp's
// float2 stores of an m16n8 accumulator and the softmax threads' reads.
__device__ __forceinline__ int s16_idx(int row, int col) {
  return row * TP + (col ^ (((row >> 1) & 3) << 2));
}

// fp16 at depth 8: A [16 x 8], B [8 x 8].
__device__ __forceinline__ void mma_m16n8k8_f16(float (&d)[4], uint32_t a0, uint32_t a1,
                                                uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.f16.f16.f32 {%0,%1,%2,%3}, "
      "{%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// Two 8x8 16-bit matrices, transposed: lanes 8i..8i+7 give matrix i's rows.
__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// An 8x8 16-bit matrix held by a warp (lane 4 g + q: row g, columns 2 q,
// 2 q + 1), transposed in place.
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t v) {
  uint32_t r;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(r) : "r"(v));
  return r;
}

__device__ __forceinline__ float2 lds64f(const void* p) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(smem_u32(p)));
  return v;
}

__device__ __forceinline__ float ldsf(const float* p) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(smem_u32(p)));
  return v;
}

__device__ __forceinline__ uint32_t h2_bits(__half2 h) {
  return *reinterpret_cast<const uint32_t*>(&h);
}

// A bf16 pair as an fp16 pair times PF_SCALE (exact for P >= 2^-29).
__device__ __forceinline__ uint32_t bf2_to_f16s(uint32_t v) {
  const float2 f = bf2(v);
  return h2_bits(__floats2half2_rn(f.x * PF_SCALE, f.y * PF_SCALE));
}

// s of the two branch layers' Y planes from f32 rows vec = {b, ln scale,
// ln bias} x 2 [6][D] (shared): |y| <= 16 |ln scale| + |ln bias| a
// channel (decode_tc.cuh's bf16 form).
__device__ __forceinline__ void branch_scales(float* scale, float* scratch, const float* vec) {
  const int d = threadIdx.x;
#pragma unroll
  for (int l = 0; l < 2; ++l) {
    const float bound = block_max(
        16.f * fabsf(vec[(3 * l + 1) * D + d]) + fabsf(vec[(3 * l + 2) * D + d]), scratch);
    if (d == 0) scale[l] = pow2_scale(bound, Y_TOP);
  }
}

// One prompt's C [HT, D] f32 (global) into the fp16 planes hi, lo of C s
// (wide layout, hi at sCh, lo HT D after it), s the power of two with max
// |C| s < 2^C_TOP (two reads of C: its max, then the split; scratch
// [WARPS] floats; every thread of the CTA). Returns 1 / (s PF_SCALE),
// exact: what the rebuild's P (x PF_SCALE) C s products are scaled by.
// C s = hi + lo + r with |r| <= 2^-22 |C s| (2^-25 below 2^-3); with
// sum_k P_k <= 8, |P^T C - computed| <= 8 2^-22 max |C| + 56 2^-40 max
// |C| besides the accumulators' rounding.
__device__ __forceinline__ float stage_c(__half* sCh, float* scratch, const float* c) {
  constexpr int VPR = D / 8;
  __half* sCl = sCh + HT * D;
  float mx = 0.f;
  static_assert(HT * D / 4 % THREADS == 0 && HT * VPR % THREADS == 0, "whole rounds");
#pragma unroll
  for (int r = 0; r < HT * D / 4 / THREADS; ++r) {
    const int i = threadIdx.x + r * THREADS;
    const float4 v = reinterpret_cast<const float4*>(c)[i];
    mx = fmaxf(mx, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w))));
  }
  const float s = pow2_scale(block_max(mx, scratch), C_TOP);
  constexpr int R = HT * VPR / THREADS;
  float4 v[R][2];                               // every load in flight before the stores
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = threadIdx.x + r * THREADS;
    const float4* src = reinterpret_cast<const float4*>(c + (size_t)(i / VPR) * D + 8 * (i % VPR));
    v[r][0] = src[0];
    v[r][1] = src[1];
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = threadIdx.x + r * THREADS;
    const float4 a = v[r][0], b = v[r][1];
    __half2 h0, h1, h2, h3, l0, l1, l2, l3;
    split2(a.x * s, a.y * s, h0, l0);
    split2(a.z * s, a.w * s, h1, l1);
    split2(b.x * s, b.y * s, h2, l2);
    split2(b.z * s, b.w * s, h3, l3);
    const int o = wide_idx(i / VPR, 8 * (i % VPR));
    *reinterpret_cast<uint4*>(sCh + o) =
        make_uint4(h2_bits(h0), h2_bits(h1), h2_bits(h2), h2_bits(h3));
    *reinterpret_cast<uint4*>(sCl + o) =
        make_uint4(h2_bits(l0), h2_bits(l1), h2_bits(l2), h2_bits(l3));
  }
  return 1.f / (s * PF_SCALE);
}

// Q^[h T + t][d] = q[t][h HD ..] . W[d][h HD ..] into the fp16 planes
// sQh, sQl times the power of two *scale (thread 0 writes it) chosen from
// the matrix's max: decode_tc.cuh project_rows_tc's products and rounding
// on f32 W, each thread's HT products computed once and held across the
// block max, every head's W row asked for at once. q [T][DA] f32
// (shared), W [D][DA] f32 (global), scratch [WARPS] floats; thread d of
// the CTA computes column d.
__device__ __forceinline__ void project_rows_f32(__half* sQh, __half* sQl, float* scale,
                                                 float* scratch, const float* sq, const float* W) {
  static_assert(THREADS == D, "a thread a column of Q^");
  const int d = threadIdx.x;
  float a[HT], mx = 0.f;
#pragma unroll
  for (int h = 0; h < H; ++h) {
    float w[HD];
    load_w_head(w, W + (size_t)d * DA + h * HD);
#pragma unroll
    for (int t = 0; t < T; ++t) {
      float v = 0.f;
#pragma unroll
      for (int j = 0; j < HD; ++j) v = fmaf(sq[t * DA + h * HD + j], w[j], v);
      a[h * T + t] = v;
      mx = fmaxf(mx, fabsf(v));
    }
  }
  const float s = pow2_scale(block_max(mx, scratch), Q_TOP);
#pragma unroll
  for (int r = 0; r < HT; ++r) {
    const int o = wide_idx(r, d);
    split1(a[r] * s, sQh[o], sQl[o]);
  }
  if (d == 0) *scale = s;
}

// A column of a transposed f32 pe term, pet[h HD + j][col] for j < HD,
// asked for ahead of its use.
struct PeColF {
  float v[HD];
};

__device__ __forceinline__ void load_pe(PeColF& pe, const float* pet, int m, int h, int col) {
  const float* p = pet + (size_t)h * HD * m + col;
#pragma unroll
  for (int j = 0; j < HD; ++j)
    asm volatile("ld.global.nc.f32 %0, [%1];\n" : "=f"(pe.v[j]) : "l"(p + (size_t)j * m));
}

// s[t] += q[t][h HD ..] . pe for head h: f32 token vectors q [T][DA]
// (shared) and an f32 pe column.
__device__ __forceinline__ void add_pe_term_f32(float s[T], const float* sq, const PeColF& col,
                                                int h) {
#pragma unroll
  for (int t = 0; t < T; ++t) {
    float a = 0.f;
#pragma unroll
    for (int j = 0; j < HD; ++j) a = fmaf(sq[t * DA + h * HD + j], col.v[j], a);
    s[t] += a;
  }
}

// Thread coordinates inside a warpgroup: warp w (channels 64 w ..), lane
// (g = lane / 4, q = lane % 4; ldmatrix li = lane / 8, lr = lane % 8),
// and the softmax role: head h = t / 16, position pos = t % 16. Each
// phase of a tile takes them afresh from a copy of threadIdx.x that the
// compiler cannot see through, so that the shared-memory addresses
// derived from them (a swizzled one for each n8 tile, k step and row) are
// computed where they are used and not hoisted out of the tile loop into
// registers held across it beside the context.
struct Lane {
  int t, w, lane, g, q, li, lr, h, pos;
  __device__ __forceinline__ Lane() {
    uint32_t tid = threadIdx.x;
    asm volatile("" : "+r"(tid));
    t = tid % WGT;
    w = t / 32;
    lane = t % 32;
    g = lane / 4;
    q = lane % 4;
    li = lane / 8;
    lr = lane % 8;
    h = t / TP;
    pos = t % TP;
  }
};

// The branch tile of a warp: positions g, g + 8 (hf) of the tile,
// channels 64 w + 8 nt + 2 q (+ 1) at [nt][2 hf (+ 1)], an m16n8
// accumulator's layout. Its img0 residual goes through a ring of 4 n8
// tiles' channel pairs [nt % 4][hf]: 16 registers where the whole tile's
// 32 spilled beside the context.
using Tile = float[8][4];
using ImgRing = float2[4][2];
// The tile's fp16 planes as packed pairs [nt][hf] (the scores' B
// fragments), then transposed (the context's).
using Planes = uint32_t[8][2];

// The img0 residual of n8 tile nt (rows m0 + g, + 8 of [M, D] f32 from
// row, the thread's first element of the tile) into its ring slot.
__device__ __forceinline__ void load_img(ImgRing& v, const float* row, int nt) {
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
    asm volatile("ld.global.nc.v2.f32 {%0, %1}, [%2];\n"
                 : "=f"(v[nt % 4][hf].x), "=f"(v[nt % 4][hf].y)
                 : "l"(row + (size_t)(8 * hf) * D + 8 * nt));
}

// One branch update on the warp's 16 x 64 part of the tile: y <- LN(y +
// P^T C + b) per position, the one-pass variance max(E[y^2] - mu^2, 0)
// (the JAX `_recon_t`, ops/decode_probs.py:51). The residual is img0
// (FROM_IMG0: keys1; the ring holds n8 tiles 0-3, asked for by the
// caller, and each slot is refilled with tile nt + 4 once read) or y
// itself (keys2). sP the layer's P tile [HT k][TP]
// bf16 (p16 layout), ch / cl C's planes (wide), cu their 1 / (s 2^15),
// vec = {b, ln scale, ln bias} [3][D] f32, red the warpgroup's [TP][4]
// float2 row sums, bar its named barrier. M = 16 positions, K = 56 (3 k16
// + 1 k8), N = the warp's 64 channels (8 n8 tiles, each with fresh
// accumulators for P C.hi and P C.lo, NP of them side by side). keys, when
// given, gets the new branch f32 ([TP][D] rows, evict-first).
template <bool FROM_IMG0, int NP>
__device__ __forceinline__ void rebuild(Tile& y, ImgRing& img, const float* img_row,
                                        const __nv_bfloat16* sP,
                                        const __half* ch, const __half* cl, float cu,
                                        const float* vec, float2* red, int bar, float eps,
                                        float* keys) {
  const Lane l;
  // P^T's fragments (positions x k) by ldmatrix.trans, then bf16 -> fp16
  // x 2^15 in registers
  uint32_t a[3][4], a8[2];
#pragma unroll
  for (int ks = 0; ks < 3; ++ks)
    ldsm_x4_trans(a[ks], sP + p16_idx(16 * ks + l.lr + 8 * (l.li >> 1), 8 * (l.li & 1)));
  ldsm_x2_trans(a8, sP + p16_idx(48 + l.lr, 8 * (l.li & 1)));
#pragma unroll
  for (int ks = 0; ks < 3; ++ks)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[ks][e] = bf2_to_f16s(a[ks][e]);
  a8[0] = bf2_to_f16s(a8[0]);
  a8[1] = bf2_to_f16s(a8[1]);
  const int col0 = 64 * l.w + 2 * l.q;          // + 8 nt
  float s[2] = {0.f, 0.f}, ss[2] = {0.f, 0.f};
#pragma unroll
  for (int n0 = 0; n0 < 8; n0 += NP) {
    float ah[NP][4], al[NP][4];
#pragma unroll
    for (int j = 0; j < NP; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) ah[j][e] = al[j][e] = 0.f;
    // the planes' matrix li is (k + 8 (li & 1), n) of hi (li < 2), lo (li >= 2)
    const Lane ln;                              // these n8 tiles' addresses, here
    const __half* plane = (ln.li >> 1) ? cl : ch;
#pragma unroll
    for (int ks = 0; ks < 3; ++ks) {
      uint32_t b[NP][4];
#pragma unroll
      for (int j = 0; j < NP; ++j)
        ldsm_x4_trans(b[j], plane + wide_idx(16 * ks + ln.lr + 8 * (ln.li & 1),
                                             64 * ln.w + 8 * (n0 + j)));
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        mma_m16n8k16_f16(ah[j], a[ks], b[j][0], b[j][1]);
        mma_m16n8k16_f16(al[j], a[ks], b[j][2], b[j][3]);
      }
    }
    {
      // K rows 48..55: the planes' (k 48, n) of hi (li even), lo (li odd)
      uint32_t b[NP][4];
#pragma unroll
      for (int j = 0; j < NP; ++j)
        ldsm_x4_trans(b[j], ((ln.li & 1) ? cl : ch) + wide_idx(48 + ln.lr, 64 * ln.w + 8 * (n0 + j)));
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        mma_m16n8k8_f16(ah[j], a8[0], a8[1], b[j][0]);
        mma_m16n8k8_f16(al[j], a8[0], a8[1], b[j][1]);
      }
    }
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      const int nt = n0 + j;
      const float2 vb = lds64f(vec + col0 + 8 * nt);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float2 r =
            FROM_IMG0 ? img[nt % 4][hf] : make_float2(y[nt][2 * hf], y[nt][2 * hf + 1]);
        const float v0 = (r.x + (ah[j][2 * hf] + al[j][2 * hf]) * cu) + vb.x;
        const float v1 = (r.y + (ah[j][2 * hf + 1] + al[j][2 * hf + 1]) * cu) + vb.y;
        y[nt][2 * hf] = v0;
        y[nt][2 * hf + 1] = v1;
        s[hf] += v0 + v1;
        ss[hf] += v0 * v0 + v1 * v1;
      }
      if (FROM_IMG0 && nt + 4 < 8) load_img(img, img_row, nt + 4);
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      s[hf] += __shfl_xor_sync(0xffffffffu, s[hf], off);
      ss[hf] += __shfl_xor_sync(0xffffffffu, ss[hf], off);
    }
  if (l.q == 0)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) red[(l.g + 8 * hf) * 4 + l.w] = make_float2(s[hf], ss[hf]);
  named_sync(bar, WGT);
  float mu[2], rs[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const float4* r4 = reinterpret_cast<const float4*>(red + (l.g + 8 * hf) * 4);
    const float4 u = r4[0], v = r4[1];
    const float sum = (u.x + u.z) + (v.x + v.z);
    const float sum2 = (u.y + u.w) + (v.y + v.w);
    mu[hf] = sum / D;
    rs[hf] = rsqrtf(fmaxf(sum2 / D - mu[hf] * mu[hf], 0.f) + eps);
  }
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const float2 sc = lds64f(vec + D + col0 + 8 * nt), bi = lds64f(vec + 2 * D + col0 + 8 * nt);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float v0 = (y[nt][2 * hf] - mu[hf]) * rs[hf] * sc.x + bi.x;
      const float v1 = (y[nt][2 * hf + 1] - mu[hf]) * rs[hf] * sc.y + bi.y;
      y[nt][2 * hf] = v0;
      y[nt][2 * hf + 1] = v1;
      if (keys)
        __stcs(reinterpret_cast<float2*>(keys + (size_t)(l.g + 8 * hf) * D + col0 + 8 * nt),
               make_float2(v0, v1));
    }
  }
}

// The tile's planes hi, lo of y ys as packed fp16 pairs.
__device__ __forceinline__ void split_tile(Planes& yh, Planes& yl, const Tile& y, float ys) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      __half2 hi, lo;
      split2(y[nt][2 * hf] * ys, y[nt][2 * hf + 1] * ys, hi, lo);
      yh[nt][hf] = h2_bits(hi);
      yl[nt][hf] = h2_bits(lo);
    }
}

// The warp's partial scores over its 64 channels, S_w = Q^[:, own] .
// Y[own]^T (both planes scaled), into sS part w ([4][HT][TP] f32, s16
// layout): 4 m16 row tiles of Q^ (rows past HT read row HT - 1 and are
// zeroed), MP of them side by side, x 2 n8 position tiles over 4 k16
// steps, Q^'s fragments by ldmatrix, Y's the warp's own planes; hi.hi and
// the two cross terms accumulate apart.
template <int MP>
__device__ __forceinline__ void scores(float* sS, const __half* sQh, const __half* sQl,
                                       const Planes& yh, const Planes& yl) {
  const Lane l;
  float* part = sS + l.w * HT * TP;
#pragma unroll
  for (int m0 = 0; m0 < 4; m0 += MP) {
    float hh[MP][2][4], x[MP][2][4];
#pragma unroll
    for (int u = 0; u < MP; ++u)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) hh[u][n][e] = x[u][n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t ah[MP][4], al[MP][4];
#pragma unroll
      for (int u = 0; u < MP; ++u) {
        const int mt = m0 + u;
        const int arow = min(16 * mt + 8 * (l.li & 1) + l.lr, HT - 1);
        const int o = wide_idx(arow, 64 * l.w + 16 * ks + 8 * (l.li >> 1));
        ldsm_x4(ah[u], sQh + o);
        ldsm_x4(al[u], sQl + o);
        if (mt == 3) ah[u][1] = ah[u][3] = al[u][1] = al[u][3] = 0u;   // rows 56..63
      }
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int u = 0; u < MP; ++u)
          mma_m16n8k16_f16(hh[u][n], ah[u], yh[2 * ks][n], yh[2 * ks + 1][n]);
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int u = 0; u < MP; ++u)
          mma_m16n8k16_f16(x[u][n], ah[u], yl[2 * ks][n], yl[2 * ks + 1][n]);
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int u = 0; u < MP; ++u)
          mma_m16n8k16_f16(x[u][n], al[u], yh[2 * ks][n], yh[2 * ks + 1][n]);
    }
#pragma unroll
    for (int u = 0; u < MP; ++u) {
      const int mt = m0 + u;
      const int r0 = 16 * mt + l.g;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int col = 8 * n + 2 * l.q;
        *reinterpret_cast<float2*>(part + s16_idx(r0, col)) =
            make_float2(hh[u][n][0] + x[u][n][0], hh[u][n][1] + x[u][n][1]);
        if (mt != 3)
          *reinterpret_cast<float2*>(part + s16_idx(r0 + 8, col)) =
              make_float2(hh[u][n][2] + x[u][n][2], hh[u][n][3] + x[u][n][3]);
      }
    }
  }
}

// Scores of the calling thread's head and position: the four channel
// quarters' partial sums in order, times unscale (1 / the planes' s,
// exact), plus the pe term (s[t] += q[t][h HD ..] . pe, the f32 token
// vectors q [T][DA] shared), times 1 / sqrt(HD). One token row at a
// time, each row's accumulator pinned before the next row's loads: the
// 7 x 16 token values and 28 partial sums would otherwise all be loaded
// ahead into registers held beside the context.
__device__ __forceinline__ void head_scores(float s[T], const float* sS, const float* sq,
                                            const PeColF& pe, float unscale) {
  const Lane l;
  const float scale = rsqrtf((float)HD);
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const float* so = sS + s16_idx(l.h * T + t, l.pos);
    const float st = (((ldsf(so) + ldsf(so + HT * TP)) + ldsf(so + 2 * HT * TP)) +
                      ldsf(so + 3 * HT * TP)) *
                     unscale;
    const float* qrow = sq + t * DA + l.h * HD;
    float a = 0.f;
#pragma unroll
    for (int j = 0; j < HD; j += 4) {
      float4 qv;
      asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                   : "=f"(qv.x), "=f"(qv.y), "=f"(qv.z), "=f"(qv.w)
                   : "r"(smem_u32(qrow + j)));
      a = fmaf(qv.x, pe.v[j], a);
      a = fmaf(qv.y, pe.v[j + 1], a);
      a = fmaf(qv.z, pe.v[j + 2], a);
      a = fmaf(qv.w, pe.v[j + 3], a);
    }
    s[t] = (st + a) * scale;
    asm volatile("" : "+f"(s[t]));
  }
}

// B7: the softmax over the T tokens of the calling thread's head and
// position, to out [HT][m] bf16 rows from the tile's first position.
__device__ __forceinline__ void emit_probs(__nv_bfloat16* out, int m, float s[T]) {
  const Lane l;
  softmax_tokens(s);
#pragma unroll
  for (int t = 0; t < T; ++t) out[(size_t)(l.h * T + t) * m + l.pos] = __float2bfloat16(s[t]);
}

// The planes' 8 x 8 blocks transposed in place (the scores' B fragments
// become the context's: k = the positions, n = the channels).
__device__ __forceinline__ void transpose_planes(Planes& yh, Planes& yl) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      yh[nt][hf] = movmatrix_trans(yh[nt][hf]);
      yl[nt][hf] = movmatrix_trans(yl[nt][hf]);
    }
}

// Online softmax of one head's T rows over a warpgroup's positions, its
// state in shared memory (ml: the running max [HT], then the running sum
// [HT]; registers are the context's): fold the tile's scaled scores s[T]
// (the calling thread's head and position) in, p = exp(s - max) into the
// planes sPh, sPl [HT][TP] (p16 layout) times P_SCALE, each row's rescale
// factor into alpha[HT]. The 16 lanes of a head read the state before
// their shuffles and lane 0 writes it after them.
__device__ __forceinline__ void online_tile(float* ml, const float s[T], __half* sPh, __half* sPl,
                                            float* alpha) {
  const Lane l;
  float mx[T], m_old[T];
#pragma unroll
  for (int t = 0; t < T; ++t) {
    mx[t] = s[t];
    m_old[t] = ml[l.h * T + t];
  }
#pragma unroll
  for (int off = TP / 2; off > 0; off >>= 1)
#pragma unroll
    for (int t = 0; t < T; ++t) mx[t] = fmaxf(mx[t], __shfl_xor_sync(0xffffffffu, mx[t], off));
  float ps[T], a[T];
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const float m_new = fmaxf(m_old[t], mx[t]);
    a[t] = (m_old[t] == -INFINITY) ? 0.f : expf(m_old[t] - m_new);
    const float p = expf(s[t] - m_new);
    const int o = p16_idx(l.h * T + t, l.pos);
    split1(p * P_SCALE, sPh[o], sPl[o]);
    ps[t] = p;
    mx[t] = m_new;
  }
#pragma unroll
  for (int off = TP / 2; off > 0; off >>= 1)
#pragma unroll
    for (int t = 0; t < T; ++t) ps[t] += __shfl_xor_sync(0xffffffffu, ps[t], off);
  if (l.pos == 0)
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const int row = l.h * T + t;
      ml[row] = mx[t];
      ml[HT + row] = ml[HT + row] * a[t] + ps[t];
      alpha[row] = a[t];
    }
}

// The warp's context accumulators: rows 16 mt + g (+ 8), channels 64 w +
// 8 nt + 2 q (+ 1); rows 56..63 are not held. With SPLIT rows 32..55 live
// in shared memory instead, a lane's own values at [nt][lane] (sa: m16
// tile 2 as a float4, sb: rows 48..55 as a float2; conflict-free), and
// a[2] and b are not used.
template <bool SPLIT>
struct Ctx {
  float a[3][8][4];                   // m16 tiles 0..2
  float b[8][2];                      // rows 48..55
  float4* sa;
  float2* sb;
};

// ctx <- ctx * alpha[row] + p . Y: M 64 (56 rows), N the warp's 64
// channels, K the tile's 16 positions (one k16 step), p's fragments by
// ldmatrix (rows past HT read row HT - 1 and are zeroed), Y's the warp's
// own planes transposed (yt), each m16 x n8 product hi.hi + hi.lo +
// lo.hi from a fresh accumulator joined by fmaf(ctx, alpha, tile).
template <bool SPLIT>
__device__ __forceinline__ void context(Ctx<SPLIT>& ctx, const __half* sPh, const __half* sPl,
                                        const float* alpha, const Planes& yth,
                                        const Planes& ytl) {
  const Lane l;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    const bool pad = mt == 3;
    const int o = p16_idx(min(16 * mt + 8 * (l.li & 1) + l.lr, HT - 1), 8 * (l.li >> 1));
    uint32_t fh[4], fl[4];
    ldsm_x4(fh, sPh + o);
    ldsm_x4(fl, sPl + o);
    if (pad) fh[1] = fh[3] = fl[1] = fl[3] = 0u;
    const float a0 = alpha[16 * mt + l.g];
    const float a1 = pad ? 0.f : alpha[16 * mt + l.g + 8];
    // the 8 n8 tiles' products side by side, a pass at a time (hi.hi,
    // hi.lo, lo.hi: 8 independent accumulators where one n8 tile's three
    // in a row wait on each other)
    float acc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
      mma_m16n8k16_f16(acc[nt], fh, yth[nt][0], yth[nt][1]);
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) mma_m16n8k16_f16(acc[nt], fh, ytl[nt][0], ytl[nt][1]);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) mma_m16n8k16_f16(acc[nt], fl, yth[nt][0], yth[nt][1]);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      if (SPLIT && pad) {
        float2* p = ctx.sb + nt * 32 + l.lane;
        const float2 o = *p;
        *p = make_float2(fmaf(o.x, a0, acc[nt][0]), fmaf(o.y, a0, acc[nt][1]));
      } else if (SPLIT && mt == 2) {
        float4* p = ctx.sa + nt * 32 + l.lane;
        const float4 o = *p;
        *p = make_float4(fmaf(o.x, a0, acc[nt][0]), fmaf(o.y, a0, acc[nt][1]),
                         fmaf(o.z, a1, acc[nt][2]), fmaf(o.w, a1, acc[nt][3]));
      } else if (pad) {
        ctx.b[nt][0] = fmaf(ctx.b[nt][0], a0, acc[nt][0]);
        ctx.b[nt][1] = fmaf(ctx.b[nt][1], a0, acc[nt][1]);
      } else {
        ctx.a[mt][nt][0] = fmaf(ctx.a[mt][nt][0], a0, acc[nt][0]);
        ctx.a[mt][nt][1] = fmaf(ctx.a[mt][nt][1], a0, acc[nt][1]);
        ctx.a[mt][nt][2] = fmaf(ctx.a[mt][nt][2], a1, acc[nt][2]);
        ctx.a[mt][nt][3] = fmaf(ctx.a[mt][nt][3], a1, acc[nt][3]);
      }
    }
  }
}

// The merged context's value projection, out[t][c] = ctx[h(c) T + t] .
// W_v[:, c] + vb[c] for c < DA (h(c) = c / HD), f32 and unrounded (the
// JAX `astype` to f32; rows of p sum to 1, so the v bias moves out
// exactly). Thread c + DA half sums channels D / 2 half .. + D / 2 - 1 for
// the T tokens at once: T independent chains, each W_v element read once
// for them (coalesced across c), the context by float4 (shared); half 1
// leaves its sums in part [T][DA] (shared), half 0 adds them to its own.
// sCtx [HT][D] f32 (shared), out [T][DA] (global); every thread of the
// CTA.
__device__ __forceinline__ void value_out(float* out, float* part, const float* sCtx,
                                          const float* w_v, const float* vb) {
  static_assert(THREADS == 2 * DA, "a thread a column and half of D");
  const int c = threadIdx.x % DA, half = threadIdx.x / DA;
  const float* crow = sCtx + (c / HD) * T * D + half * (D / 2);
  const float* w = w_v + (size_t)half * (D / 2) * DA + c;
  float a[T];
#pragma unroll
  for (int t = 0; t < T; ++t) a[t] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D / 2; d += 4) {
    float wv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) wv[e] = __ldg(w + (size_t)(d + e) * DA);
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const float4 cv = *reinterpret_cast<const float4*>(crow + t * D + d);
      a[t] = fmaf(cv.x, wv[0], a[t]);
      a[t] = fmaf(cv.y, wv[1], a[t]);
      a[t] = fmaf(cv.z, wv[2], a[t]);
      a[t] = fmaf(cv.w, wv[3], a[t]);
    }
  }
  if (half == 1)
#pragma unroll
    for (int t = 0; t < T; ++t) part[t * DA + c] = a[t];
  __syncthreads();
  if (half == 0)
#pragma unroll
    for (int t = 0; t < T; ++t) out[t * DA + c] = (a[t] + part[t * DA + c]) + vb[c];
}

// Shared memory (bytes) of a CTA: what both warpgroups read, then each
// warpgroup's own (at WG0 and WG0 + WG_BYTES), from a base aligned to
// 256 bytes (the ring stages' swizzle repeats every 256; TOTAL holds the
// alignment's slack).
template <int DEPTH, int KIND>
struct Smem {
  static constexpr bool CTX = KIND != PROBS;
  // the context's rows 32..55 in shared memory (Ctx<true>): depth 1 has
  // the room
  static constexpr bool SPLIT = KIND == ATTEND && DEPTH == 1;
  static constexpr int ALIGN = 256;
  static constexpr int C = 0;                            // C planes hi, lo a layer; B8: the context after the walk
  static constexpr int Q = C + DEPTH * 2 * HT * D * 2;   // Q^ planes hi, lo
  static constexpr int V = Q + 2 * HT * D * 2;           // branch rows 0-5, f32
  static constexpr int QT = V + 6 * D * 4;               // token vectors [T][DA] f32
  static constexpr int SC = QT + T * DA * 4;             // planes' s: Y1, Y2, Q^; scratch [8]
  static constexpr int WG0 = (SC + 16 * 4 + ALIGN - 1) / ALIGN * ALIGN;
  // a warpgroup's: its ring stage (P tiles), partial scores, p planes,
  // alpha, the online softmax's m and l, row sums (a set a layer), its
  // mbarrier, with SPLIT its warps' context rows 32..55 ([4][8][32]
  // float4, then [4][8][32] float2)
  static constexpr int P = 0;
  static constexpr int S = P + DEPTH * HT * TP * 2;
  static constexpr int PP = S + 4 * HT * TP * 4;
  static constexpr int AL = PP + (CTX ? 2 * HT * TP * 2 : 0);
  static constexpr int ML = AL + (CTX ? 64 * 4 : 0);
  static constexpr int RED = ML + (CTX ? 2 * 64 * 4 : 0);
  static constexpr int BAR = RED + DEPTH * TP * 4 * 8;
  static constexpr int CS = BAR + 16;
  static constexpr int WG_BYTES = (CS + (SPLIT ? 4 * 8 * 32 * 24 : 0) + ALIGN - 1) / ALIGN * ALIGN;
  static constexpr int TOTAL = WG0 + 2 * WG_BYTES + ALIGN;
};
static_assert(Smem<1, ATTEND>::TOTAL == 216576 && Smem<2, ATTEND>::TOTAL == 229376 &&
                  Smem<2, ATTEND_KEYS>::TOTAL == 229376 && Smem<1, PROBS>::TOTAL == 158720,
              "the byte counts: B8 f32 depth 1, depth 2 (and with keys2), B7 f32 layer 2");
static_assert(Smem<2, ATTEND_KEYS>::TOTAL <= 232448, "a CTA fits an SM");
static_assert(HT * D * 4 <= Smem<1, ATTEND>::Q, "the merged context fits the C planes");
static_assert(T * DA * 4 <= Smem<1, ATTEND>::PP - Smem<1, ATTEND>::S &&
                  3 * 64 * 4 <= Smem<1, ATTEND>::PP - Smem<1, ATTEND>::S,
              "the merge's factors and the value projection's sums fit a warpgroup's scores");

// The walk of one prompt b (a CTA): KIND ATTEND or ATTEND_KEYS (B8 f32 at
// DEPTH 1 or 2, ATTEND_KEYS also keys2 f32 to keys [b, klimit, D] below
// klimit), or PROBS (B7 f32 layer 2, DEPTH 1: P2 bf16 to out).
//   tok   [B, T, DA]  B8: the token queries q; B7: the token keys k
//   img0  [M, D]; c1, c2 [B, HT, D]; pet [DA, M] (B8: pe_k, B7: peq2)
//   w     [D, DA] (B8: W_k, B7: W_q); rows [8, D]; w_v [D, DA], v_bias [DA]
//   out   B8: [B, T, DA] f32; B7: [B, HT, M] bf16
// tp1, tp2: P1, P2 [B * HT, M] bf16 as 2-D tensor maps of [56, 16] boxes.
template <int DEPTH, int KIND>
__global__ void __launch_bounds__(THREADS, 1)
walk_f32_kernel(const __grid_constant__ CUtensorMap tp1, const __grid_constant__ CUtensorMap tp2,
                const float* __restrict__ tok, const float* __restrict__ img0,
                const float* __restrict__ c1, const float* __restrict__ c2,
                const float* __restrict__ w, const float* __restrict__ w_v,
                const float* __restrict__ pet, const float* __restrict__ rows,
                const float* __restrict__ v_bias, void* __restrict__ out,
                float* __restrict__ keys, int m, float eps, int klimit) {
  static_assert(KIND != PROBS || DEPTH == 1, "B7 walks keys1");
  static_assert(KIND != ATTEND_KEYS || DEPTH == 2, "keys2 leave the depth-2 walk");
  using L = Smem<DEPTH, KIND>;
  // n8 tiles of the rebuild (NP) and m16 tiles of the scores (MP) side by
  // side: of the settings timed (kernels/probs_compare.py --f32
  // --variants) the fastest, B8 two m16 tiles, B3 f32's final walk two n8
  // tiles (two m16 tiles too spill 180 B), B7 one of each
  constexpr int NP = KIND == ATTEND_KEYS ? 2 : 1, MP = KIND == ATTEND ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((L::ALIGN - (smem_u32(smem_raw) & (L::ALIGN - 1))) &
                                    (L::ALIGN - 1));
  __half* sQh = reinterpret_cast<__half*>(smem + L::Q);
  __half* sQl = sQh + HT * D;
  float* sV = reinterpret_cast<float*>(smem + L::V);
  float* sq = reinterpret_cast<float*>(smem + L::QT);
  float* sSc = reinterpret_cast<float*>(smem + L::SC);
  float* scratch = sSc + 8;
  const int b = blockIdx.x, tiles = m / TP;
  const int wg = threadIdx.x / WGT;
  unsigned char* mine = smem + L::WG0 + wg * L::WG_BYTES;
  const __nv_bfloat16* sP = reinterpret_cast<const __nv_bfloat16*>(mine + L::P);
  float* sS = reinterpret_cast<float*>(mine + L::S);
  __half* sPh = reinterpret_cast<__half*>(mine + L::PP);
  __half* sPl = sPh + HT * TP;
  float* alpha = reinterpret_cast<float*>(mine + L::AL);
  float* ml = reinterpret_cast<float*>(mine + L::ML);     // the online softmax's m [HT], l [HT]
  float2* red = reinterpret_cast<float2*>(mine + L::RED);
  const uint32_t full = smem_u32(mine + L::BAR);
  const Lane l;
  const int bar = 1 + wg;

  // the warpgroup's tile i (every other one) into its ring stage
  auto load_p = [&](int i) {
    const uint32_t dst = smem_u32(mine + L::P);
    mbar_expect_tx(full, DEPTH * HT * TP * 2);
    tma_load_2d(dst, &tp1, i * TP, b * HT, full);
    if constexpr (DEPTH == 2) tma_load_2d(dst + HT * TP * 2, &tp2, i * TP, b * HT, full);
  };
  if (l.t == 0) {
    mbar_init(full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (L::CTX && l.t < HT) {
    ml[l.t] = -INFINITY;
    ml[HT + l.t] = 0.f;
  }
  __syncthreads();
  if (l.t == 0) load_p(wg);
  load_f32(sV, rows, 6 * D);
  load_f32(sq, tok + (size_t)b * T * DA, T * DA);
  float cu[DEPTH];
  cu[0] = stage_c(reinterpret_cast<__half*>(smem + L::C), scratch, c1 + (size_t)b * HT * D);
  if constexpr (DEPTH == 2)
    cu[1] = stage_c(reinterpret_cast<__half*>(smem + L::C + 2 * HT * D * 2), scratch,
                    c2 + (size_t)b * HT * D);
  __syncthreads();
  branch_scales(sSc, scratch, sV);
  project_rows_f32(sQh, sQl, sSc + 2, scratch, sq, w);   // q_h W_h^T
  __syncthreads();

  const __half* cp = reinterpret_cast<const __half*>(smem + L::C);
  const float ys = sSc[DEPTH - 1];                        // the attended layer's planes' s
  const float unscale = 1.f / (sSc[2] * ys);
  Ctx<L::SPLIT> ctx;
  if constexpr (L::CTX) {
#pragma unroll
    for (int mt = 0; mt < (L::SPLIT ? 2 : 3); ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) ctx.a[mt][nt][e] = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) ctx.b[nt][0] = ctx.b[nt][1] = 0.f;
    if constexpr (L::SPLIT) {
      ctx.sa = reinterpret_cast<float4*>(mine + L::CS) + l.w * 8 * 32;
      ctx.sb = reinterpret_cast<float2*>(mine + L::CS + 4 * 8 * 32 * 16) + l.w * 8 * 32;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        ctx.sa[nt * 32 + l.lane] = make_float4(0.f, 0.f, 0.f, 0.f);
        ctx.sb[nt * 32 + l.lane] = make_float2(0.f, 0.f);
      }
    }
  }
  int k = 0;                                              // the warpgroup's tiles so far
  for (int i = wg; i < tiles; i += 2) {
    const int m0 = i * TP;
    const Lane lt;
    ImgRing img;                                          // n8 tiles 0-3 asked for ahead
    const float* img_row = img0 + (size_t)(m0 + lt.g) * D + 64 * lt.w + 2 * lt.q;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) load_img(img, img_row, nt);
    mbar_wait(full, k & 1);
    Tile y;
    float* kout = KIND == ATTEND_KEYS && m0 < klimit ? keys + ((size_t)b * klimit + m0) * D
                                                     : nullptr;
    rebuild<true, NP>(y, img, img_row, sP, cp, cp + HT * D, cu[0], sV, red, bar, eps,
                      DEPTH == 1 ? kout : nullptr);
    if constexpr (DEPTH == 2)
      rebuild<false, NP>(y, img, img_row, sP + HT * TP, cp + 2 * HT * D, cp + 3 * HT * D,
                         cu[DEPTH - 1], sV + 3 * D, red + TP * 4, bar, eps, kout);
    if (lt.t == 0 && i + 2 < tiles) load_p(i + 2);       // the stage is read
    Planes yh, yl;
    split_tile(yh, yl, y, ys);
    scores<MP>(sS, sQh, sQl, yh, yl);
    PeColF pe;                                            // its latency under the barrier
    load_pe(pe, pet, m, lt.h, m0 + lt.pos);
    named_sync(bar, WGT);
    float s[T];
    head_scores(s, sS, sq, pe, unscale);
    if constexpr (L::CTX)
      online_tile(ml, s, sPh, sPl, alpha);
    else
      emit_probs(static_cast<__nv_bfloat16*>(out) + (size_t)b * HT * m + m0, m, s);
    if constexpr (L::CTX) transpose_planes(yh, yl);
    if constexpr (L::CTX) named_sync(bar, WGT);
    if constexpr (L::CTX) context(ctx, sPh, sPl, alpha, yh, yl);
    ++k;
  }
  if constexpr (L::CTX) {
    // the two warpgroups' contexts merged in a fixed order (WG1's scaled
    // into the context rows, WG0's added), then projected by W_v
    __syncthreads();
    const float* ml0 = reinterpret_cast<const float*>(smem + L::WG0 + L::ML);
    const float* ml1 = reinterpret_cast<const float*>(smem + L::WG0 + L::WG_BYTES + L::ML);
    // each row's factor for either state and cunscale / the merged sum
    // [3][64] (in WG1's partial scores), the value projection's partial
    // sums [T][DA] (in WG0's)
    float* fac = reinterpret_cast<float*>(smem + L::WG0 + L::WG_BYTES + L::S);
    float* part = reinterpret_cast<float*>(smem + L::WG0 + L::S);
    float* sCtx = reinterpret_cast<float*>(smem + L::C);  // [HT][D] f32
    if (threadIdx.x < HT) {
      const int row = threadIdx.x;
      const float mm = fmaxf(ml0[row], ml1[row]);
      const float e0 = expf(ml0[row] - mm), e1 = expf(ml1[row] - mm);
      fac[row] = e0;
      fac[64 + row] = e1;
      fac[128 + row] = (1.f / (P_SCALE * ys)) / (ml0[HT + row] * e0 + ml1[HT + row] * e1);
    }
    __syncthreads();
    const Lane lm;
    const int col0 = 64 * lm.w + 2 * lm.q;
    auto merge = [&](int row, int nt, float v0, float v1) {
      const float e = fac[64 * wg + row];
      float2* p = reinterpret_cast<float2*>(sCtx + row * D + col0 + 8 * nt);
      if (wg == 1) {
        *p = make_float2(v0 * e, v1 * e);
      } else {
        const float inv = fac[128 + row];
        const float2 o = *p;
        *p = make_float2(fmaf(v0, e, o.x) * inv, fmaf(v1, e, o.y) * inv);
      }
    };
    for (int turn = 1; turn >= 0; --turn) {
      if (wg == turn) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
          for (int mt = 0; mt < (L::SPLIT ? 2 : 3); ++mt) {
            merge(16 * mt + lm.g, nt, ctx.a[mt][nt][0], ctx.a[mt][nt][1]);
            merge(16 * mt + lm.g + 8, nt, ctx.a[mt][nt][2], ctx.a[mt][nt][3]);
          }
          if constexpr (L::SPLIT) {
            const float4 v = ctx.sa[nt * 32 + lm.lane];
            const float2 u = ctx.sb[nt * 32 + lm.lane];
            merge(32 + lm.g, nt, v.x, v.y);
            merge(40 + lm.g, nt, v.z, v.w);
            merge(48 + lm.g, nt, u.x, u.y);
          } else {
            merge(48 + lm.g, nt, ctx.b[nt][0], ctx.b[nt][1]);
          }
        }
      }
      __syncthreads();
    }
    value_out(static_cast<float*>(out) + (size_t)b * T * DA, part, sCtx, w_v, v_bias);
  }
}

// P [b * HT, m] bf16 as a 2-D tensor map of [HT rows, TP positions] boxes,
// 32-byte swizzled (the p16 layout).
inline bool p_map(CUtensorMap* map, const void* p, int b, int m) {
  const cuuint64_t dims[2] = {(cuuint64_t)m, (cuuint64_t)b * HT};
  const cuuint64_t strides[1] = {(cuuint64_t)m * 2};
  const cuuint32_t box[2] = {TP, HT};
  return rat_hopper::tensor_map_of(CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, map, p, 2, dims, strides,
                                   box, CU_TENSOR_MAP_SWIZZLE_32B);
}

// Launch the walk on b prompts (b >= 1, m a positive multiple of 32).
template <int DEPTH, int KIND>
int launch(const float* tok, const float* img0, const void* p1, const float* c1, const void* p2,
           const float* c2, const float* w, const float* w_v, const float* pet,
           const float* rows, const float* v_bias, void* out, float* keys, int b, int m,
           float eps, int klimit, cudaStream_t s) {
  constexpr int smem = Smem<DEPTH, KIND>::TOTAL;
  CUtensorMap t1, t2;
  if (!p_map(&t1, p1, b, m) || !p_map(&t2, DEPTH == 2 ? p2 : p1, b, m))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(walk_f32_kernel<DEPTH, KIND>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  walk_f32_kernel<DEPTH, KIND><<<b, THREADS, smem, s>>>(t1, t2, tok, img0, c1, c2, w, w_v, pet,
                                                          rows, v_bias, out, keys, m, eps,
                                                          klimit);
  return (int)cudaGetLastError();
}

}  // namespace rat_walk_f32
