// Fused SAM mask head: upscaler + hypernetwork in one pass.
//
// Replaces: revisit_anything_tpu/ops/maskhead.py `_mask_head_call` /
// `_mask_head_kernel` -> `mask_head_body` (pallas_call at :299, body
// :138), reached through `fused_mask_head` (:345). Per image position of
// one prompt's final branch keys[n, p, 0:256]:
//   y1 = bf16(bf16(x · up1_w) + up1_b)           (ConvT k=s=2 256 -> 4x64)
//   h1 = bf16(gelu(groupLN_64(y1)))              (4 groups of 64, f32 stats)
//   y2[q] = bf16(bf16(h1[q] · up2_w) + up2_b)    (ConvT 64 -> 4x32 per block q)
//   h2 = bf16(gelu(y2))
//   out[n, p, 4q + r, m] = bf16(sum_c h2[q, r, c] · hyper[n, m, c])   (f32 sum)
// giving [Np, content, 16, M] in the (q, r) = (2a1+b1, 2a2+b2) order.
//
// What bounds it on the H100: the f32 epilogue on the CUDA cores, not the
// tensor cores. A position takes 2 · (256·256 + 4·64·128 + 16·32·M) bf16
// product FLOP (0.65 ms at 1024 prompts x 3136 positions, M = 3 and 989
// TFLOP/s) but ~19,500 f32 operations: 768 GELUs of ~22 each (the A&S erf
// polynomial below), the group LN (~7 a channel) and the bias adds, ~0.95
// ms at 67 TFLOP/s. Keys (1.6 GB) and logits (0.3 GB) take ~0.6 ms at
// 3.35 TB/s. The TPU kernel's block-diagonal conv2 [256, 512] and
// hypernetwork [512, 48] (3/4 and 15/16 zeros, shaped for the 128x128
// MXU) are not carried.
//
// Design (Hopper, sm_90a): persistent CTAs, one an SM, of two
// warpgroups and no producer warp: 8 warps, two a scheduler, so the
// compiler may give a thread 255 registers (the register file is split
// over the 4 schedulers: a third warp on one of them caps every thread
// at 168, where the epilogue beside an accumulator in flight spills or
// has its wgmmas serialized). A work item is (prompt, 64 positions);
// items are dealt round-robin over the CTAs and, inside a CTA,
// alternately to the two warpgroups, each a whole item at a time.
//  - One thread loads up1_w (128 KB) and up2_w (16 KB) once by TMA,
//    128B-swizzled and MN-major (N contiguous, as they lie in memory).
//    Each warpgroup owns one keys slot [64 positions, 256] (four 64x64
//    TMA boxes, a full mbarrier): one of its threads asks for its next
//    item's keys as soon as the current item's last conv1 has retired,
//    so they load under the last group's epilogues. Rows past gg arrive
//    as zeros; rows from content to gg are read and never stored.
//  - Per conv1 group g of an item: y1 = wgmma m64n64k16 x 16 (keys and
//    up1_w from shared memory, 32 f32 accumulators); the epilogue rounds,
//    adds the bias as a bf16 pair, takes the group-LN statistics by two
//    quad shuffles (a row's 64 channels lie in the 4 threads of a quad)
//    and packs GELU's output to bf16 pairs that are conv2's register A
//    operand; y2 = wgmma m64n128k16 x 4 against up2_w (64 accumulators);
//    the second epilogue rounds, adds the bias and packs GELU's output
//    to A fragments again, and the hypernetwork dot is wgmma m64n8k16 x 2
//    for each r of the group against the prompt's hyper rows (B [32
//    channels, 8 masks], built per item in shared memory). The next
//    group's conv1 is issued right behind conv2 and runs under the
//    second epilogue.
//  - GELU is the JAX package's exact-form A&S 7.1.28 erf polynomial
//    (ops/maskhead.py `_gelu`, within 5e-7 of erf) with a fast reciprocal,
//    taken doubled (one multiply fewer) 16 values at a time, one step
//    over all of them before the next. The halves move, exactly, into
//    up2_w and hyper (halved once in shared memory): rounding commutes
//    with a power of two, so h1 and h2 are the JAX package's bf16 values
//    times 2 and every product is the same.
//  - The two warpgroups take turns to issue their products (named
//    barriers, as FA3 does), so that one's epilogue runs under the
//    other's products rather than the two running in step.
//  - Logits go to a per-warpgroup staging tile [64, 16, M] bf16 in shared
//    memory; the item's rows below content are one contiguous run of
//    out (64·16·M bf16, 16-byte aligned) and leave by 16-byte coalesced
//    stores.
// Where its time goes: kernels/maskhead_variants.py (PERF.md).
//
// B6 (entry rat_mask_head_probs) replaces
// revisit_anything_tpu/ops/maskhead.py `_mask_head_call_probs`
// (pallas_call at :257, body :90-126 with recon=True), reached through
// `fused_mask_head_probs` (:409). Its keys tile is not read but rebuilt
// per position from the shared img0 and the two image -> token updates,
//   x = bf16(LN(LN(img0 + P1^T C1 + b1) + P2^T C2 + b2))     (f32, one-pass var)
// and then goes through K3's item body unchanged: one kernel template,
// RECON = true. Bounded like K3 by its f32 work: K3's epilogue plus the
// two branch LayerNorms (~7 operations a channel each), ~23,000
// operations a position, ~1.1 ms at 1024 prompts x 3136 positions; its
// bytes (P1 and P2 ~0.72 GB, logits 0.31 GB) take ~0.33 ms.
//  - The rebuild runs on the tensor cores. A warpgroup presets acc [64
//    positions, 256] f32 (four n64 chunks, 128 registers a thread) to
//    img0 + b1, read straight from global memory (the rows every prompt
//    reads, L2-resident), and adds P1^T · C1 by wgmma m64n64k16 x 16: K =
//    56 padded to 64, P^T an MN-major A (positions contiguous) and C an
//    MN-major B (channels contiguous), by wgmma's transpose bits. P and C
//    are bf16, so the products are exact and summed in f32; the preset
//    takes img0 + b1 + a where JAX takes (img0 + a) + b1, a change of f32
//    summation order only. The LayerNorm runs in registers (a row's 256
//    channels lie in the 4 threads of a quad: two quad shuffles), then b2
//    is added, P2^T · C2 likewise, the second LayerNorm, and the keys
//    leave as bf16 into the warpgroup's keys slot in the 128B-swizzled
//    layout conv1's descriptor reads. The item's first conv1 is issued
//    only after that, so the 128 rebuild accumulators are dead before
//    conv1's and conv2's are live. The rebuild's products take no turn.
//  - Shared memory is K3's, byte for byte: the rebuild's operands borrow
//    the warpgroup's own keys slot and staging tile, in time:
//      keys slot (32 KB) <- C [64 k, 256] as four TMA boxes [64 k, 64 ch];
//      staging tile (8 KB at M = 4) <- P [64 k, 64 positions], one box;
//    each box is 64 rows of a 3-d tensor map whose row extent is 56, so
//    TMA fills rows 56-63 with zeros (never the next prompt's rows) and
//    the padded K-step adds nothing. One full barrier phase a branch
//    layer (C and P, 40 KB). The next item's C1 loads once this item's
//    last conv1 has retired (under the last group's epilogues, as K3's
//    keys do), its P1 once the staging tile's logits have left. Layer
//    2's operands load once layer 1's products have retired, under the
//    first LayerNorm. Rows at or past content are rebuilt and never stored;
//    past gg, img0 and P read as zeros.

#include <math.h>

#include "hopper.cuh"

namespace rat_k3 {

using namespace rat_hopper;

constexpr int D = 256;           // keys channels, conv1 in and out
constexpr int C1 = 64;           // conv1 channels a group
constexpr int C2 = 32;           // conv2 channels a (q, r)
constexpr int BP = 64;           // positions an item: one wgmma row tile
constexpr int MAXM = 4;          // mask tokens
constexpr int THREADS = 256;     // two warpgroups
constexpr int ISSUES = 5;        // product issues an item: conv1, 3 x (conv2 + conv1), conv2
constexpr bool TURNS = true;     // the warpgroups take turns to issue their products

// Shared memory from a 1024-byte aligned base. Every TMA box is rows of
// 128 bytes (64 bf16), 128B-swizzled.
constexpr int BOX_X = BP * 128;                // keys box [64 positions, 64 ch]
constexpr int SLOT = 4 * BOX_X;                // an item's keys [64, 256]
constexpr int BOX_W1 = D * 128;                // up1_w box [256 K, 64 N]
constexpr int BOX_W2 = C1 * 128;               // up2_w box [64 K, 64 N]
constexpr int STAGE = BP * 16 * MAXM * 2;      // logits [64, 16, M] bf16
constexpr int OFF_W1 = 0;
constexpr int OFF_W2 = OFF_W1 + 4 * BOX_W1;
constexpr int OFF_X = OFF_W2 + 2 * BOX_W2;     // slot s at + s·SLOT
constexpr int OFF_STAGE = OFF_X + 2 * SLOT;    // warpgroup w at + w·STAGE
constexpr int HYP = 8 * C2 * 2;                // hypernetwork B [8 m, 32 k] bf16
constexpr int OFF_HYP = OFF_STAGE + 2 * STAGE; // warpgroup w at + w·HYP
constexpr int OFF_B1 = OFF_HYP + 2 * HYP;      // up1_b bf16 [64]
constexpr int OFF_B2 = OFF_B1 + C1 * 2;        // up2_b bf16 [32]
constexpr int OFF_LS = OFF_B2 + C2 * 2;        // ln scale f32 [64]
constexpr int OFF_LB = OFF_LS + C1 * 4;        // ln bias f32 [64]
constexpr int OFF_BAR = OFF_LB + C1 * 4;       // weights, slot 0, slot 1
constexpr int SMEM = 1024 + OFF_BAR + 3 * 8;   // + alignment slack
static_assert(SMEM <= 232448, "one CTA an SM");

// B6: the rebuild's operands in a warpgroup's keys slot (C: four boxes
// [64 k, 64 channels]) and staging tile (P: one box [64 k, 64
// positions]), 64 rows of which TMA fills rows 56-63 with zeros.
constexpr int HT = 56;                         // probability rows a prompt
constexpr int BOX_R = 64 * 128;                // an operand box, bf16
constexpr int LAYER_TX = 5 * BOX_R;            // C and P of one branch layer
static_assert(SLOT == 4 * BOX_R && STAGE >= BOX_R && HT <= 64,
              "B6's operands fit the keys slot and the staging tile");

// Twice the JAX package's GELU (ops/maskhead.py `_gelu`), in place on N
// values, one step of the formula over all N before the next so that N
// independent chains hide each other's latency: A&S 7.1.28 with the
// 1/sqrt(2) argument scale folded into the coefficients,
// 2 gelu(x) = x + |x| (1 - 1/p^16), p = 1 + sum_k c_k |x|^k; the caller
// folds the half into the next product.
template <int N>
__device__ __forceinline__ void gelu2(float (&x)[N]) {
  constexpr float C1_ = 0.0705230784f * 0.70710678118654752f;
  constexpr float C2_ = 0.0422820123f * 0.5f;
  constexpr float C3_ = 0.0092705272f * 0.35355339059327376f;
  constexpr float C4_ = 0.0001520143f * 0.25f;
  constexpr float C5_ = 0.0002765672f * 0.17677669529663688f;
  constexpr float C6_ = 0.0000430638f * 0.125f;
  float a[N], p[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a[n] = fabsf(x[n]);
    p[n] = fmaf(a[n], C6_, C5_);
  }
#pragma unroll
  for (int n = 0; n < N; ++n) p[n] = fmaf(a[n], p[n], C4_);
#pragma unroll
  for (int n = 0; n < N; ++n) p[n] = fmaf(a[n], p[n], C3_);
#pragma unroll
  for (int n = 0; n < N; ++n) p[n] = fmaf(a[n], p[n], C2_);
#pragma unroll
  for (int n = 0; n < N; ++n) p[n] = fmaf(a[n], p[n], C1_);
#pragma unroll
  for (int n = 0; n < N; ++n) p[n] = fmaf(a[n], p[n], 1.f);
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int n = 0; n < N; ++n) p[n] = p[n] * p[n];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    float r;                                    // 1/p^16; 0 when p^16 overflows
    asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(p[n]));
    x[n] = fmaf(-a[n], r, x[n] + a[n]);
  }
}

// A bf16 pair as two floats (x the low half): two integer operations.
__device__ __forceinline__ float2 unpack_bf16(__nv_bfloat162 v) {
  const uint32_t u = *reinterpret_cast<uint32_t*>(&v);
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

// d (+)= A·B: A [64 x 16] K-major and B [16 x 64] MN-major, both in
// shared memory.
__device__ __forceinline__ void wgmma_ss_n64_mn(float (&d)[32], uint64_t da, uint64_t db,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (+)= A·B: A [64 x 16] bf16 in registers, B [16 x 8] K-major in shared
// memory without swizzle.
__device__ __forceinline__ void wgmma_rs_n8(float (&d)[4], const uint32_t (&a)[4], uint64_t db,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// conv1 of group g: acc = keys tile [64, 256] · up1_w[:, 64g : 64g + 64].
// A K-step is 16 channels: 32 bytes inside a box's swizzled rows (keys)
// or 16 rows of 128 bytes (up1_w).
__device__ __forceinline__ void issue_conv1(float (&acc)[32], uint32_t sx, uint32_t sw1,
                                            int g) {
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < D / 16; ++k) {
    const uint64_t da = gmma_desc(sx + (k / 4) * BOX_X + (k % 4) * 32, 16, 1024);
    const uint64_t db = gmma_desc(sw1 + g * BOX_W1 + k * 2048, BOX_W1, 1024);
    wgmma_ss_n64_mn(acc, da, db, k > 0);
  }
  wgmma_commit();
}

// conv2 of one group: acc = h1 [64, 64] (registers) · up2_w [64, 128],
// whose two 64-column halves are the two up2_w boxes.
__device__ __forceinline__ void issue_conv2(float (&acc)[64], const uint32_t (&a)[4][4],
                                            uint32_t sw2) {
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < C1 / 16; ++k)
    wgmma_rs_n128_mn(acc, a[k], gmma_desc(sw2 + k * 2048, BOX_W2, 1024), k > 0);
  wgmma_commit();
}

// y1 -> h1 for one group. acc[4i + 2rr + e] is row (16·warp + lane/4 +
// 8rr), channel 8i + 2c + e (c = lane % 4); h1 leaves as conv2's A
// fragments: a[kk] holds channels 16kk.. of both rows. The two rows'
// statistics are taken side by side, each sum in two halves, to keep the
// dependent chains short.
__device__ __forceinline__ void epilogue1(const float (&acc)[32], uint32_t (&a)[4][4],
                                          const __nv_bfloat162 (&b1)[8], const float* ls,
                                          const float* lb, int c, float eps) {
  float y[2][16], st[2][2];                      // row values; their sum and sum of squares
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float s0 = 0.f, s1 = 0.f, q0 = 0.f, q1 = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float2 f = unpack_bf16(
          __hadd2(__floats2bfloat162_rn(acc[4 * i + 2 * rr], acc[4 * i + 2 * rr + 1]), b1[i]));
      y[rr][2 * i] = f.x;
      y[rr][2 * i + 1] = f.y;
      s0 += f.x;
      s1 += f.y;
      q0 = fmaf(f.x, f.x, q0);
      q1 = fmaf(f.y, f.y, q1);
    }
    st[rr][0] = s0 + s1;
    st[rr][1] = q0 + q1;
  }
#pragma unroll
  for (int lane = 1; lane < 4; lane *= 2)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
#pragma unroll
      for (int k = 0; k < 2; ++k) st[rr][k] += __shfl_xor_sync(0xffffffffu, st[rr][k], lane);
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    // one-pass variance, as the JAX kernel takes it; y·rs - mu·rs
    const float mu = st[rr][0] * (1.f / C1);
    const float rs = rsqrtf(st[rr][1] * (1.f / C1) - mu * mu + eps);
    const float sh = -mu * rs;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float2 sc = reinterpret_cast<const float2*>(ls)[4 * i + c];
      const float2 bi = reinterpret_cast<const float2*>(lb)[4 * i + c];
      y[rr][2 * i] = fmaf(fmaf(y[rr][2 * i], rs, sh), sc.x, bi.x);
      y[rr][2 * i + 1] = fmaf(fmaf(y[rr][2 * i + 1], rs, sh), sc.y, bi.y);
    }
    gelu2(y[rr]);
    // bf16(2 gelu) = 2 bf16(gelu); up2_w was halved in shared memory
#pragma unroll
    for (int i = 0; i < 8; ++i)
      a[i / 2][(i % 2) * 2 + rr] = pack_bf16(y[rr][2 * i], y[rr][2 * i + 1]);
  }
}

// y2 -> logits for group q. acc[4i + 2rr + e] is row (16·warp + lane/4 +
// 8rr), conv2 column 8i + 2c + e = 32r + channel, r = i / 4, channel
// 8(i % 4) + 2c + e. h2 = bf16(2 gelu(y2)) leaves as A fragments, and
// the hypernetwork dot runs on the tensor cores: for each r, [64 rows,
// 32 channels] · hyper/2 [32, 8] (the halves cancel exactly), f32 sums
// of bf16 products, rounded once. Thread c of a quad holds masks 2c and
// 2c + 1 of its two rows.
template <int M>
__device__ __forceinline__ void epilogue2(const float (&acc)[64], __nv_bfloat16* stage,
                                          uint32_t shyp, const __nv_bfloat162 (&b2)[4], int q,
                                          int row0, int c) {
  uint32_t h2[8][4];
  // 16 values at a time: row rr, conv2 columns of i = 8h .. 8h + 7
#pragma unroll
  for (int rr = 0; rr < 2; ++rr)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float z[16];
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int i = 8 * h + t;
        const float2 y = unpack_bf16(__hadd2(
            __floats2bfloat162_rn(acc[4 * i + 2 * rr], acc[4 * i + 2 * rr + 1]), b2[i % 4]));
        z[2 * t] = y.x;
        z[2 * t + 1] = y.y;
      }
      gelu2(z);
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int i = 8 * h + t;
        h2[i / 2][(i % 2) * 2 + rr] = pack_bf16(z[2 * t], z[2 * t + 1]);
      }
    }
  float d[4][4];
  wgmma_fence();
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int k = 0; k < 2; ++k)
      wgmma_rs_n8(d[r], h2[2 * r + k], gmma_desc_plain(shyp + k * 256, 128, 512), k > 0);
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int r = 0; r < 4; ++r) fence_regs(d[r]);
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (2 * c + e < M)
          stage[((row0 + 8 * rr) * 16 + 4 * q + r) * M + 2 * c + e] =
              __float2bfloat16(d[r][2 * rr + e]);
}

// B6: d += A·B, A [64 x 16] and B [16 x 64] both MN-major in shared
// memory (wgmma's transpose bits).
__device__ __forceinline__ void wgmma_ss_n64_tt(float (&d)[32], uint64_t da, uint64_t db,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// B6: acc += P^T [64 positions, 64 k] · C [64 k, 256], P in the staging
// tile and C's four n64 boxes in the keys slot (a K-step is 16 rows of
// 128 bytes in both).
__device__ __forceinline__ void issue_recon(float (&acc)[4][32], uint32_t sp, uint32_t sc) {
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wgmma_ss_n64_tt(acc[j], gmma_desc(sp + k * 2048, BOX_R, 1024),
                      gmma_desc(sc + j * BOX_R + k * 2048, BOX_R, 1024), 1);
  wgmma_commit();
}

// B6: a bf16 pair of a [256] row as two floats.
__device__ __forceinline__ float2 ldg_pair(const __nv_bfloat16* row, int ch) {
  return unpack_bf16(__ldg(reinterpret_cast<const __nv_bfloat162*>(row + ch)));
}

// B6: acc = img0 rows + b1. acc[j][4i + 2rr + e] is row (16·warp +
// lane/4 + 8rr) = position p of the item, channel 64j + 8i + 2c + e;
// positions at or past gg read as zeros.
__device__ __forceinline__ void preset_branch(float (&acc)[4][32], const __nv_bfloat16* img0,
                                              const __nv_bfloat16* b1, int p, int gg, int c) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int ch = 64 * j + 8 * i + 2 * c;
      const float2 b = ldg_pair(b1, ch);
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const float2 x =
            p + 8 * rr < gg ? ldg_pair(img0 + (size_t)(p + 8 * rr) * D, ch) : make_float2(0.f, 0.f);
        acc[j][4 * i + 2 * rr] = x.x + b.x;
        acc[j][4 * i + 2 * rr + 1] = x.y + b.y;
      }
    }
}

// B6: a branch LayerNorm in place on the rebuild's accumulators (layout
// as preset_branch), f32 with the one-pass variance max(E[y^2] - mu^2,
// 0) as the JAX kernel takes it; with NEXT, the next layer's bias b is
// added after it.
template <bool NEXT>
__device__ __forceinline__ void branch_ln(float (&acc)[4][32], const __nv_bfloat16* scale,
                                          const __nv_bfloat16* bias, const __nv_bfloat16* b,
                                          int c, float eps) {
  float st[2][2];                                // a row's sum and sum of squares
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float s0 = 0.f, s1 = 0.f, q0 = 0.f, q1 = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float x = acc[j][4 * i + 2 * rr], y = acc[j][4 * i + 2 * rr + 1];
        s0 += x;
        s1 += y;
        q0 = fmaf(x, x, q0);
        q1 = fmaf(y, y, q1);
      }
    st[rr][0] = s0 + s1;
    st[rr][1] = q0 + q1;
  }
#pragma unroll
  for (int lane = 1; lane < 4; lane *= 2)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
#pragma unroll
      for (int k = 0; k < 2; ++k) st[rr][k] += __shfl_xor_sync(0xffffffffu, st[rr][k], lane);
  float mu[2], rs[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    mu[rr] = st[rr][0] * (1.f / D);
    rs[rr] = rsqrtf(fmaxf(st[rr][1] * (1.f / D) - mu[rr] * mu[rr], 0.f) + eps);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int ch = 64 * j + 8 * i + 2 * c;
      const float2 sc = ldg_pair(scale, ch), bi = ldg_pair(bias, ch);
      const float2 nb = NEXT ? ldg_pair(b, ch) : make_float2(0.f, 0.f);
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float& x = acc[j][4 * i + 2 * rr];
        float& y = acc[j][4 * i + 2 * rr + 1];
        x = fmaf((x - mu[rr]) * rs[rr], sc.x, bi.x);
        y = fmaf((y - mu[rr]) * rs[rr], sc.y, bi.y);
        if (NEXT) {
          x += nb.x;
          y += nb.y;
        }
      }
    }
}

// B6: the rebuilt keys, bf16, into the keys slot where conv1 reads them:
// box j holds channels 64j.., row p at p·128, its 16-byte chunk i at
// (i ^ p % 8)·16 (the 128B swizzle TMA writes; p % 8 = lane / 4).
__device__ __forceinline__ void store_keys(const float (&acc)[4][32], uint8_t* slot, int row0,
                                           int c) {
  const int sw = row0 % 8;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
        *reinterpret_cast<uint32_t*>(slot + j * BOX_R + (row0 + 8 * rr) * 128 +
                                     ((i ^ sw) * 16) + 4 * c) =
            pack_bf16(acc[j][4 * i + 2 * rr], acc[j][4 * i + 2 * rr + 1]);
}

// K3 (RECON false) and B6 (RECON true): one work item at a time a
// warpgroup. The maps: K3 keys [Np, gg, 256] in tkeys; B6 P1 in tkeys, P2
// [Np, 56, gg] in tp2, C1 and C2 [Np, 56, 256] in tc1 and tc2.
template <int M, bool RECON>
__global__ void __launch_bounds__(THREADS, 1)
mask_head_kernel(const __grid_constant__ CUtensorMap tkeys,   // keys | P1
                 const __grid_constant__ CUtensorMap tp2,     // B6: P2
                 const __grid_constant__ CUtensorMap tc1,     // B6: C1
                 const __grid_constant__ CUtensorMap tc2,     // B6: C2
                 const __grid_constant__ CUtensorMap tw1,     // up1_w [256, 256]
                 const __grid_constant__ CUtensorMap tw2,     // up2_w [64, 128]
                 const __nv_bfloat16* __restrict__ up1_b,     // [64]
                 const __nv_bfloat16* __restrict__ ln_s,      // [64]
                 const __nv_bfloat16* __restrict__ ln_b,      // [64]
                 const __nv_bfloat16* __restrict__ up2_b,     // [32]
                 const __nv_bfloat16* __restrict__ hyper,     // [Np, M, 32]
                 __nv_bfloat16* __restrict__ out,             // [Np, content, 16, M]
                 const __nv_bfloat16* __restrict__ img0,      // B6: [gg, 256]
                 const __nv_bfloat16* __restrict__ rows,      // B6: branch rows [8, 256]
                 int content, int gg, int tiles, int total, float eps, float ln_eps) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* sm = smem_raw + (base - raw);
  const uint32_t wbar = base + OFF_BAR;
  auto full = [&](int s) { return base + OFF_BAR + 8 * (1 + s); };
  // this CTA's items: blockIdx.x + k·gridDim.x (the grid is at most
  // total); warpgroup wg takes k = wg, wg + 2, ... into its slot wg
  const int n_items = (total - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int wg = threadIdx.x / 128;
  const int ctid = threadIdx.x % 128;
  const uint32_t sx = base + OFF_X + wg * SLOT;
  const uint32_t sst = base + OFF_STAGE + wg * STAGE;
  // one thread of a warpgroup loads its k-th item's keys into its slot
  auto load_item = [&](int k) {
    const int item = blockIdx.x + k * gridDim.x;
    mbar_expect_tx(full(wg), SLOT);
    for (int b = 0; b < 4; ++b)
      tma_load_3d(sx + b * BOX_X, &tkeys, 64 * b, (item % tiles) * BP, item / tiles, full(wg));
  };
  // B6: C of a branch layer into the slot (and the phase's bytes: P
  // follows by load_p)
  auto load_c = [&](int k, const CUtensorMap* tc) {
    mbar_expect_tx(full(wg), LAYER_TX);
    const int item = blockIdx.x + k * gridDim.x;
    for (int b = 0; b < 4; ++b) tma_load_3d(sx + b * BOX_R, tc, 64 * b, 0, item / tiles, full(wg));
  };
  auto load_p = [&](int k, const CUtensorMap* tp) {
    const int item = blockIdx.x + k * gridDim.x;
    tma_load_3d(sst, tp, (item % tiles) * BP, 0, item / tiles, full(wg));
  };

  __nv_bfloat16* sb1 = reinterpret_cast<__nv_bfloat16*>(sm + OFF_B1);
  __nv_bfloat16* sb2 = reinterpret_cast<__nv_bfloat16*>(sm + OFF_B2);
  float* sls = reinterpret_cast<float*>(sm + OFF_LS);
  float* slb = reinterpret_cast<float*>(sm + OFF_LB);
  for (int i = threadIdx.x; i < C1; i += THREADS) {
    sb1[i] = up1_b[i];
    sls[i] = __bfloat162float(ln_s[i]);
    slb[i] = __bfloat162float(ln_b[i]);
  }
  for (int i = threadIdx.x; i < C2; i += THREADS) sb2[i] = up2_b[i];
  if (threadIdx.x == 0) {
    for (int s = 0; s < 3; ++s) mbar_init(wbar + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(wbar, 4 * BOX_W1 + 2 * BOX_W2);
    for (int j = 0; j < 4; ++j) tma_load_2d(base + OFF_W1 + j * BOX_W1, &tw1, 64 * j, 0, wbar);
    for (int j = 0; j < 2; ++j) tma_load_2d(base + OFF_W2 + j * BOX_W2, &tw2, 64 * j, 0, wbar);
  }
  if (ctid == 0 && wg < n_items) {
    if constexpr (RECON) load_c(wg, &tc1);
    else load_item(wg);
  }

  const int warp = ctid / 32, lane = ctid % 32, c = lane % 4;
  const int row0 = 16 * warp + lane / 4;                 // this thread's first row
  const uint32_t sw1 = base + OFF_W1, sw2 = base + OFF_W2;
  // hyper/2 as wgmma's B [8 masks, 32 channels], K-major without
  // swizzle: (m, k) at byte (k / 8)·128 + m·16 + (k % 8)·2
  __nv_bfloat16* hyp = reinterpret_cast<__nv_bfloat16*>(sm + OFF_HYP + wg * HYP);
  const uint32_t shyp = base + OFF_HYP + wg * HYP;
  __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(sm + OFF_STAGE + wg * STAGE);
  const int bar = 1 + wg;                                // this warpgroup's named barrier
  // Turns (named barriers 3 and 4, as in FA3's ping-pong): warpgroup 0
  // issues first, then each issues only after the other has issued, so
  // one's epilogue runs under the other's products instead of the two
  // running in step. Warpgroup 0 may have one item more; it then issues
  // alone once warpgroup 1 is done. t counts this warpgroup's issues.
  const int n0 = (n_items + 1) / 2, n1 = n_items / 2;
  int t = 0;
  auto turn_begin = [&]() {
    if (TURNS && (wg == 1 || t <= ISSUES * n1)) named_sync(3 + wg, 256);
  };
  auto turn_end = [&]() {
    if (TURNS && (wg == 0 ? t < ISSUES * n1 : t + 1 < ISSUES * n0)) named_arrive(4 - wg, 256);
    ++t;
  };
  if (TURNS && wg == 1) named_arrive(3, 256);             // warpgroup 0 goes first
  __nv_bfloat162 b1[8], b2[4];                           // bias pairs of this thread's channels
#pragma unroll
  for (int i = 0; i < 8; ++i) b1[i] = reinterpret_cast<const __nv_bfloat162*>(sb1)[4 * i + c];
#pragma unroll
  for (int j = 0; j < 4; ++j) b2[j] = reinterpret_cast<const __nv_bfloat162*>(sb2)[4 * j + c];

  mbar_wait(wbar, 0);
  // halve up2_w in place (exact): h1 leaves the first epilogue as
  // bf16(2 gelu) = 2 bf16(gelu)
  for (int i = threadIdx.x; i < 2 * BOX_W2 / 4; i += THREADS) {
    __nv_bfloat162* w = reinterpret_cast<__nv_bfloat162*>(sm + OFF_W2) + i;
    *w = __hmul2(*w, __float2bfloat162_rn(0.5f));
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  for (int j = 0; wg + 2 * j < n_items; ++j) {
    const int k = wg + 2 * j;
    const int item = blockIdx.x + k * gridDim.x;
    const int n = item / tiles, p0 = (item % tiles) * BP;
    // this prompt's hyper rows; the barrier also closes the previous
    // item's staging copy
    for (int e = ctid; e < 8 * C2; e += 128) {
      const int m = e / C2, k = e % C2;
      const float v = m < M ? __bfloat162float(hyper[((size_t)n * M + m) * C2 + k]) : 0.f;
      hyp[(k / 8) * 64 + m * 8 + k % 8] = __float2bfloat16(0.5f * v);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    named_sync(bar, 128);
    if constexpr (RECON) {
      // the keys tile, rebuilt: two phases of the slot's barrier an item
      if (ctid == 0) load_p(k, &tkeys);                   // the staging tile is free
      float r[4][32];
      preset_branch(r, img0, rows, p0 + row0, gg, c);
      mbar_wait(full(wg), 0);
      issue_recon(r, sst, sx);
      wgmma_wait<0>();
#pragma unroll
      for (int q = 0; q < 4; ++q) fence_regs(r[q]);
      named_sync(bar, 128);                               // P1 and C1 are consumed
      if (ctid == 0) {
        load_c(k, &tc2);
        load_p(k, &tp2);
      }
      branch_ln<true>(r, rows + D, rows + 2 * D, rows + 3 * D, c, ln_eps);
      mbar_wait(full(wg), 1);
      issue_recon(r, sst, sx);
      wgmma_wait<0>();
#pragma unroll
      for (int q = 0; q < 4; ++q) fence_regs(r[q]);
      named_sync(bar, 128);                               // P2 and C2 are consumed
      branch_ln<false>(r, rows + 4 * D, rows + 5 * D, nullptr, c, ln_eps);
      store_keys(r, sm + OFF_X + wg * SLOT, row0, c);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      named_sync(bar, 128);
    } else {
      mbar_wait(full(wg), j & 1);
    }
    float acc1[32], acc2[64];
    uint32_t a2[4][4];
    turn_begin();
    issue_conv1(acc1, sx, sw1, 0);
    turn_end();
    wgmma_wait<0>();
    fence_regs(acc1);
#pragma unroll 1
    for (int g = 0; g < 3; ++g) {
      epilogue1(acc1, a2, b1, sls, slb, c, eps);
      fence_regs(a2);
      turn_begin();
      issue_conv2(acc2, a2, sw2);
      issue_conv1(acc1, sx, sw1, g + 1);                 // runs under epilogue2
      turn_end();
      wgmma_wait<1>();                                    // conv2 done
      fence_regs(acc2);
      epilogue2<M>(acc2, stage, shyp, b2, g, row0, c);
      wgmma_wait<0>();
      fence_regs(acc1);
    }
    // the keys tile is consumed: the next item's keys (B6: its C1) load
    // under the last group's epilogues
    if constexpr (RECON) {
      named_sync(bar, 128);
      if (ctid == 0 && k + 2 < n_items) load_c(k + 2, &tc1);
    } else {
      if (ctid == 0 && k + 2 < n_items) load_item(k + 2);
    }
    epilogue1(acc1, a2, b1, sls, slb, c, eps);
    fence_regs(a2);
    turn_begin();
    issue_conv2(acc2, a2, sw2);
    turn_end();
    wgmma_wait<0>();
    fence_regs(acc2);
    epilogue2<M>(acc2, stage, shyp, b2, 3, row0, c);
    named_sync(bar, 128);
    // rows below content: one contiguous run of out
    const int chunks = min(BP, content - p0) * 2 * M;     // 16-byte chunks
    const uint4* src = reinterpret_cast<const uint4*>(stage);
    uint4* dst = reinterpret_cast<uint4*>(out + ((size_t)n * content + p0) * 16 * M);
    for (int i = ctid; i < chunks; i += 128) dst[i] = src[i];
  }
}

// A kernel's arguments: the tensor maps (K3 uses the first and the
// weights'), the vectors and the sizes.
struct Args {
  CUtensorMap maps[4];                           // keys | P1, P2, C1, C2
  CUtensorMap w1, w2;
  const void *up1_b, *ln_s, *ln_b, *up2_b, *hyper, *img0, *rows;
  void* out;
  int np_, gg, content;
  float eps, ln_eps;
};

// A bf16 [np, n_rows, width] tensor as a 3-d tensor map of [64, 64, 1]
// boxes (rows past n_rows read as zeros).
inline bool map3(CUtensorMap* map, const void* ptr, int width, int n_rows, int np_) {
  const cuuint64_t dims[3] = {(cuuint64_t)width, (cuuint64_t)n_rows, (cuuint64_t)np_};
  const cuuint64_t strides[2] = {(cuuint64_t)width * 2, (cuuint64_t)n_rows * width * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  return tensor_map_bf16(map, ptr, 3, dims, strides, box);
}

inline bool map_weights(Args& a, const void* up1_w, const void* up2_w) {
  const cuuint64_t w1dims[2] = {(cuuint64_t)D, (cuuint64_t)D};
  const cuuint64_t w1strides[1] = {(cuuint64_t)D * 2};
  const cuuint32_t w1box[2] = {64, D};
  const cuuint64_t w2dims[2] = {(cuuint64_t)4 * C2, (cuuint64_t)C1};
  const cuuint64_t w2strides[1] = {(cuuint64_t)4 * C2 * 2};
  const cuuint32_t w2box[2] = {64, C1};
  return tensor_map_bf16(&a.w1, up1_w, 2, w1dims, w1strides, w1box) &&
         tensor_map_bf16(&a.w2, up2_w, 2, w2dims, w2strides, w2box);
}

template <int M, bool RECON>
int launch(const Args& a, int n_ctas, cudaStream_t stream) {
  auto kernel = mask_head_kernel<M, RECON>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (a.content + BP - 1) / BP;
  const long long total = (long long)a.np_ * tiles;
  if (total > (1ll << 30)) return (int)cudaErrorInvalidValue;
  const int grid = (int)(total < n_ctas ? total : n_ctas);
  typedef const __nv_bfloat16* P;
  kernel<<<grid, THREADS, SMEM, stream>>>(
      a.maps[0], a.maps[1], a.maps[2], a.maps[3], a.w1, a.w2, static_cast<P>(a.up1_b),
      static_cast<P>(a.ln_s), static_cast<P>(a.ln_b), static_cast<P>(a.up2_b),
      static_cast<P>(a.hyper), static_cast<__nv_bfloat16*>(a.out), static_cast<P>(a.img0),
      static_cast<P>(a.rows), a.content, a.gg, tiles, (int)total, a.eps, a.ln_eps);
  return (int)cudaGetLastError();
}

template <bool RECON>
int launch_m(const Args& a, int n_masks, int n_ctas, cudaStream_t stream) {
  switch (n_masks) {
    case 1: return launch<1, RECON>(a, n_ctas, stream);
    case 2: return launch<2, RECON>(a, n_ctas, stream);
    case 3: return launch<3, RECON>(a, n_ctas, stream);
    case 4: return launch<4, RECON>(a, n_ctas, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace rat_k3

extern "C" int rat_mask_head(const void* keys, const void* up1_w, const void* up1_b,
                             const void* ln_s, const void* ln_b, const void* up2_w,
                             const void* up2_b, const void* hyper, void* out,
                             int np_, int gg, int content, int n_masks, float eps,
                             int n_ctas, void* stream) {
  if (np_ < 1 || content < 1 || content > gg || n_ctas < 1) return (int)cudaErrorInvalidValue;
  rat_k3::Args a = {};
  if (!rat_k3::map3(&a.maps[0], keys, rat_k3::D, gg, np_) ||
      !rat_k3::map_weights(a, up1_w, up2_w))
    return (int)cudaErrorInvalidValue;
  a.up1_b = up1_b, a.ln_s = ln_s, a.ln_b = ln_b, a.up2_b = up2_b, a.hyper = hyper;
  a.out = out, a.np_ = np_, a.gg = gg, a.content = content, a.eps = eps;
  return rat_k3::launch_m<false>(a, n_masks, n_ctas, static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory a K3 or B6 CTA takes (for reports).
extern "C" int rat_mask_head_smem() { return rat_k3::SMEM; }

extern "C" int rat_mask_head_probs(const void* img0, const void* p1, const void* c1m,
                                   const void* p2, const void* c2m, const void* rows,
                                   const void* up1_w, const void* up1_b, const void* ln_s,
                                   const void* ln_b, const void* up2_w, const void* up2_b,
                                   const void* hyper, void* out, int np_, int gg,
                                   int content, int n_masks, float eps, float ln_eps,
                                   int n_ctas, void* stream) {
  // gg % 8: the P maps' row stride a multiple of 16 bytes
  if (np_ < 1 || gg % 8 != 0 || content < 1 || content > gg || n_ctas < 1)
    return (int)cudaErrorInvalidValue;
  using rat_k3::D;
  using rat_k3::HT;
  rat_k3::Args a = {};
  if (!rat_k3::map3(&a.maps[0], p1, gg, HT, np_) || !rat_k3::map3(&a.maps[1], p2, gg, HT, np_) ||
      !rat_k3::map3(&a.maps[2], c1m, D, HT, np_) || !rat_k3::map3(&a.maps[3], c2m, D, HT, np_) ||
      !rat_k3::map_weights(a, up1_w, up2_w))
    return (int)cudaErrorInvalidValue;
  a.up1_b = up1_b, a.ln_s = ln_s, a.ln_b = ln_b, a.up2_b = up2_b, a.hyper = hyper;
  a.img0 = img0, a.rows = rows, a.out = out, a.np_ = np_, a.gg = gg, a.content = content;
  a.eps = eps, a.ln_eps = ln_eps;
  return rat_k3::launch_m<true>(a, n_masks, n_ctas, static_cast<cudaStream_t>(stream));
}

// ---------------------------------------------------------------------------
// K3 in f32 (entry rat_mask_head_f32): the same function on f32 operands,
// for an f32 SAM. The TPU kernel computes in its inputs' dtype, so none of
// the bf16 roundings above happen: y1, h1, y2, h2 and the logits stay f32,
// GELU is the exact erf form (torch's gelu; the TPU kernel's A&S
// polynomial lies within 5e-7 of it) and the group LN's variance is
// two-pass.
//
// What bounds it on the H100: its products, 2 · (256·256 + 4·64·128 +
// 16·32·M) FLOP a position, 0.64 TFLOP at 1024 prompts x 3136 positions and
// M = 3: 3.9 ms at the TF32 rate over the three passes that split TF32
// needs (165 TFLOP/s), against 3.3 GB of keys in and 0.6 GB of logits out
// (1.2 ms at 3.35 TB/s). Beside them run ~11,000 f32 operations a thread
// an item on the FMA units (768 exact GELUs a position, the splits, the
// group LN), about 0.6 of the products' time at their bound.
//
// Precision: split TF32, as K5's f32 form. An operand x is cut into hi =
// tf32_rna(x) and lo = tf32_rna(x - hi), and a product A·B is taken as
// lo·hi + hi·lo + hi·hi, in that order. conv1 (K 256) takes each 32-wide K
// chunk's three passes into a fresh accumulator and adds it to an f32 sum
// (wgmma's accumulator does not round to nearest); conv2 (K 64) keeps one
// accumulator. The hypernetwork dot (32 channels, M <= 4 masks) runs on
// the FMA units in f32.
//
// Design (Hopper, sm_90a), two kernels on the caller's stream:
//  - split_head_weights_kernel (the pre-pass) writes up1_wᵀ [256 N, 256 K]
//    and up2_wᵀ [128 N, 64 K] as TF32 hi and lo planes into 576 KB of
//    scratch that the wrapper allocates, every call (TF32 wgmma takes B
//    only K-major). In each 8 K rows it stores the rows in the order
//    0,2,4,6,1,3,5,7: a thread's f32 accumulator holds columns 2t and 2t + 1
//    of each 8, the register A operand wants K indices t and t + 4, so a
//    value held in the accumulator's layout is already its A fragment: the
//    keys as loaded, conv1's output as conv2's A, with no shuffles.
//  - mask_head_tf32x3_kernel: persistent CTAs of two warpgroups and no
//    producer warp (8 warps: 255 registers a thread). A work item is
//    (prompt, 64 positions), one wgmma row tile; a unit is two consecutive
//    items, one a warpgroup (a warpgroup without an item runs on zeros and
//    stores nothing), and a CTA takes a contiguous run of units.
//  - conv1 runs by group pairs (128 columns: groups 2pr and 2pr + 1), as
//    wgmma m64n128k8 with A from registers: the keys arrive as 8-byte loads
//    in the accumulator's layout straight from device memory (the first
//    pair from HBM, the second from L2), one chunk ahead, and are split in
//    registers a K chunk at a time, the split's inputs pinned so that no
//    split rises above the previous chunk's wait (else several chunks'
//    fragments would be live and the kernel would spill, as K5's did).
//  - up1_wᵀ's planes (512 KB) stream by TMA through a ring of 4 stages of
//    [128 N, 32 K] hi and lo (two 128B-swizzled 16 KB boxes) that both
//    warpgroups read: a unit takes 16 stages. Every thread arrives on a
//    stage's empty barrier once its products on it have retired; one
//    thread of the warpgroup that releases a stage second refills its
//    slot with the stage four ahead. up2_wᵀ's planes (64 KB) stay resident.
//  - The epilogues stay on the FMA units, a group at a time: y1 + up1_b,
//    the group LN's two-pass statistics by quad shuffles (a row's 64
//    channels lie in the 4 threads of a quad), scale and shift, the exact
//    erff GELU; h1 is split in registers as conv2's A (wgmma m64n128k8 x 8
//    k-steps x 3 passes against the resident planes); y2 + up2_b, GELU, and
//    the hypernetwork dot as 8 FMAs a (row, r, mask) and a reduce-scatter
//    over the quad (18 shuffles at M = 3), after which lane c holds r = c.
//  - The warpgroups take turns to issue their products (named barriers 3
//    and 4), so the tensor cores run one's chunk while the other splits,
//    waits or runs its epilogues.
//  - Logits go to a per-warpgroup staging tile [64, 16, M] f32; the item's
//    rows below content are one contiguous run of out and leave by 16-byte
//    coalesced stores.
//
// Shared memory (dynamic, from a 1024-byte aligned base):
//   up1_wᵀ ring            4 x 32,768        131,072
//   up2_wᵀ planes          2 x 2 x 16,384     65,536
//   logits staging         2 x 16,384         32,768  (M = 4)
//   hypernetwork rows      2 x 512             1,024
//   up1_b, LN s, b, up2_b  (3 x 64 + 32) x 4     896
//   mbarriers              9 x 8                  72
//   release counts         4 x 4                  16
//   alignment slack                            1,024
//   total                                    232,408 of 232,448
//
// B6 in f32 (entry rat_mask_head_probs_f32) replaces B6's TPU kernel
// (`_mask_head_call_probs`, pallas_call at :257) on f32 inputs, an f32
// SAM's "probs_split" decode. Its keys tile is rebuilt per item from the
// shared img0 and the two image -> token updates,
//   x = LN2(LN1(img0 + P1^T C1 + b1) + P2^T C2 + b2)      (f32, one-pass var)
// not rounded, and K3 f32's item body runs on it unchanged (one kernel
// template, RECON = true). P1 and P2 are bf16 (the JAX package rounds the
// probabilities to bf16 in every dtype); img0, C, the branch rows, the
// weights and the logits are f32.
//
// What bounds it: K3 f32's products (3.9 ms at 1024 prompts x 3136
// positions, M = 3) and the rebuild's, 2 layers x 2·56·256 FLOP a position
// as two TF32 passes (0.74 ms at 495 TFLOP/s); its bytes (P1 and P2 0.72
// GB, the logits 0.62 GB, C 0.12 GB) take ~0.44 ms.
//
// Precision: a bf16 P is exact in TF32, and C = C_hi + C_lo + a rest below
// 2^-22 |C| (split_tf32_bits), so P^T C is two TF32 passes, P^T C_lo and
// P^T C_hi, each over the 56 rows into a fresh accumulator, joined in f32.
// One pass (C rounded to TF32) misses the JAX kernel by ~1e-4 of the
// logits (tests/test_torch_maskhead.py).
//
// Design: the warpgroup that runs an item's head first rebuilds its keys,
// by mma.sync m16n8k8 in TF32 (TF32 wgmma takes its operands K-major only,
// and P [56, gg] and C [56, 256] are both MN-major in the 56 rows):
//  - A warp rebuilds the 16 rows it owns in the head, all 256 channels:
//    acc [4][32] f32 (128 registers) in the accumulator's layout, the same
//    as B6's, preset to img0's rows (8-byte loads; rows past gg read
//    zeros).
//  - P1^T and P2^T [56, 64 positions] bf16 are copied once an item into
//    the warpgroup's logits staging tile (free between an item's copy-out
//    and its first logits) by cp.async (pieces past gg zero-filled); an A
//    fragment is a bf16's bits shifted into a TF32. C1 then C2 stream in
//    32 chunks of [56, 16 channels] f32 through 4 buffers, 3 ahead, in
//    the warpgroup's half of the up1_wᵀ ring's last stage: B6 f32 runs
//    the ring 3 deep (its head alone took K3 f32's time either way).
//  - Per chunk, P^T C_lo and P^T C_hi of its two n8 tiles run over the 7
//    k-steps into four fresh accumulators, each B value split into TF32
//    hi and lo as it is read; acc = (acc + (lo + hi)), then + b after the
//    layer's last chunk (JAX's (y + a) + b), then the LayerNorm in
//    registers (a row's 256 channels lie in the 4 threads of a quad).
//  - The loops over a layer's four 64-channel groups and a group's four
//    chunks are not unrolled (the accumulators rotate instead): the
//    instruction cache holds the head's code too, and with them unrolled
//    the kernel ran 3.4x K3 f32's time.
//  - The f32 keys fit neither in registers beside the head (K3 f32 runs at
//    221 of 255) nor in shared memory: each thread writes its own keys to
//    the warpgroup's [64, 256] f32 tile in device memory, at the places K3
//    f32's key loads read, and reads them back from there (ld.global.cg,
//    not the read-only path: this kernel writes the tile). A thread reads
//    only what it wrote, so no barrier orders them. The tiles follow the
//    weights' planes in the scratch: 2 x 64 KB a CTA, 16.5 MiB at 132
//    CTAs; the branch [Np, content, 256] f32 (3.3 GB at 1024 x 3136) is
//    never written.
//  - The rebuild takes no turn; its named barriers are its warpgroup's.
// Where its time goes: kernels/maskhead_variants.py --probs-f32 (PERF.md).
//
// Shared memory: K3 f32's, byte for byte (232,408 B), two regions used
// twice by B6 f32:
//   logits staging, warpgroup w    16,384 = P1^T, P2^T [56, 72] bf16 (2 x 8,064)
//   up1_wᵀ ring stage 3            32,768 = 2 warpgroups x 4 C chunks [56, 16] f32
//                                           (4 x 3,584)
// Scratch (floats): the weights' planes (147,456), then the keys tiles,
// n_ctas x 2 x 64 x 256.
namespace rat_k3f {

using namespace rat_hopper;

constexpr int D = 256, C1 = 64, C2 = 32, MAXM = 4;
constexpr int BP = 64;                     // positions an item: a warpgroup's rows
constexpr int THREADS = 256;               // two warpgroups
constexpr int KC = 32;                     // K a chunk: one 128-byte row of f32
constexpr int SLOTS = 4;                   // ring depth
constexpr int BOX = 128 * KC * 4;          // a plane's box [128 N, 32 K]
constexpr int STAGE = 2 * BOX;             // hi, then lo
constexpr int NCHUNK = D / KC;             // conv1 chunks a group pair: 8
constexpr int NSTAGE = 2 * NCHUNK;         // stages a unit: 16
constexpr int STG = BP * 16 * MAXM * 4;    // a warpgroup's logits tile
constexpr int HYP = MAXM * C2 * 4;         // a warpgroup's hypernetwork rows
constexpr int OFF_RING = 0;
constexpr int OFF_W2 = OFF_RING + SLOTS * STAGE;   // plane p, K half h at + (2p + h)·BOX
constexpr int OFF_STG = OFF_W2 + 4 * BOX;
constexpr int OFF_HYP = OFF_STG + 2 * STG;
constexpr int OFF_VEC = OFF_HYP + 2 * HYP;
constexpr int OFF_BAR = OFF_VEC + (3 * C1 + C2) * 4;   // full x4, empty x4, up2_w
constexpr int OFF_CNT = OFF_BAR + (2 * SLOTS + 1) * 8; // releases a slot
constexpr int SMEM = 1024 + OFF_CNT + 4 * SLOTS;
constexpr int PLANES = 2 * (D * 4 * C1 + C1 * 4 * C2);  // the weights' planes (floats)
static_assert(SMEM == 232408 && SMEM <= 232448, "the budget in the note above");

// GELU in its exact form, x·Φ(x) = x/2·(1 + erf(x/√2)), as torch's gelu.
__device__ __forceinline__ float gelu_erf(float x) {
  return x * 0.5f * (1.f + erff(x * 0.70710678118654752f));
}

// B6 f32's rebuild: P1^T and P2^T [HT k, BP positions] bf16 at a pitch of
// PP bytes (144 puts the A fragments' reads in distinct banks) in the
// warpgroup's staging tile, P2 at OFF_P2; NBUF C chunks [HT k, CW
// channels] f32 in its half of the ring's last stage, which B6 f32 does
// not use (CHUNKS an item, 16 a layer); and the keys tile of a warpgroup
// (floats).
constexpr int HT = 56;
constexpr int PP = BP * 2 + 16;
constexpr int OFF_P2 = 8192;
constexpr int FREE = 1;                 // ring stages B6 f32 gives to the rebuild
constexpr int CW = 16;
constexpr int CHUNK = HT * CW * 4;
constexpr int NBUF = 4;
constexpr int CHUNKS = 2 * D / CW;
constexpr int KTILE = BP * D;
static_assert(HT * PP <= OFF_P2 && OFF_P2 + HT * PP <= STG &&
                  NBUF * CHUNK <= FREE * STAGE / 2 && HT % 8 == 0,
              "P1, P2 fit the staging tile, a warpgroup's C chunks its half of the freed stages");

// B6 f32's inputs (K3 f32: all null).
struct Recon {
  const float* img0;                       // [gg, D]
  const __nv_bfloat16 *p1, *p2;            // [Np, HT, gg]
  const float *c1, *c2;                    // [Np, HT, D]
  const float* rows;                       // branch rows [8, D]
  float* keys;                             // keys tiles [n_ctas, 2, BP, D]
  float ln_eps;
};

// The pre-pass: one CTA a 32 x 32 tile of one weight W [K, N] (up1_w 64
// tiles, up2_w 8), written as plane[p][n][k'] = (hi, lo)(W[k][n]) with k'
// = k's place in the order 0,2,4,6,1,3,5,7 of its 8 rows.
__global__ void __launch_bounds__(256)
split_head_weights_kernel(const float* __restrict__ up1_w, const float* __restrict__ up2_w,
                          float* __restrict__ planes) {
  __shared__ float tile[32][33];
  int t = blockIdx.x, k_dim = D, n_dim = 4 * C1;
  const float* w = up1_w;
  float* dst = planes;
  if (t >= 64) {
    t -= 64;
    w = up2_w;
    k_dim = C1;
    n_dim = 4 * C2;
    dst = planes + 2 * D * 4 * C1;
  }
  const int k0 = 32 * (t % (k_dim / 32)), n0 = 32 * (t / (k_dim / 32));
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  for (int r = ty; r < 32; r += 8) tile[r][tx] = w[(size_t)(k0 + r) * n_dim + n0 + tx];
  __syncthreads();
  const int j = tx % 8, from = (tx & ~7) + 2 * (j % 4) + j / 4;
  for (int r = ty; r < 32; r += 8) {
    uint32_t hi, lo;
    split_tf32_bits(tile[from][r], hi, lo);
    const size_t at = (size_t)(n0 + r) * k_dim + k0 + tx;
    dst[at] = __uint_as_float(hi);
    dst[(size_t)n_dim * k_dim + at] = __uint_as_float(lo);
  }
}

// 8 bytes of keys: K3 f32's by the read-only path; B6 f32's keys tile,
// which the kernel writes, at the L2 (cg).
template <bool TILE>
__device__ __forceinline__ float2 ld_keys(const float* p) {
  if constexpr (TILE) return __ldcg(reinterpret_cast<const float2*>(p));
  else return __ldg(reinterpret_cast<const float2*>(p));
}

// K chunk cc of the keys rows g and g + 8 (x0, x8: their column 2c) in
// the accumulator's layout; a row at or past the item's live rows reads
// as zeros.
template <bool TILE>
__device__ __forceinline__ void load_keys(float (&r)[4][4], const float* x0, const float* x8,
                                          int cc, bool v0, bool v8) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int col = KC * cc + 8 * kk;
    const float2 a = v0 ? ld_keys<TILE>(x0 + col) : make_float2(0.f, 0.f);
    const float2 b = v8 ? ld_keys<TILE>(x8 + col) : make_float2(0.f, 0.f);
    r[kk][0] = a.x;
    r[kk][1] = a.y;
    r[kk][2] = b.x;
    r[kk][3] = b.y;
  }
}

// acc = h1 · up2_w: 8 k-steps of 8 channels, lo·hi, hi·lo, then hi·hi
// against the resident planes (hi at sw2, lo at sw2 + 2·BOX; K half h at +
// h·BOX).
__device__ __forceinline__ void issue_conv2(float (&acc)[64], const uint32_t (&ah)[8][4],
                                            const uint32_t (&al)[8][4], uint32_t sw2) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_rs_tf32_n128(acc, al[kk], gmma_desc(sw2 + (kk / 4) * BOX + (kk % 4) * 32, 16, 1024),
                       kk > 0);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_rs_tf32_n128(acc, ah[kk],
                       gmma_desc(sw2 + 2 * BOX + (kk / 4) * BOX + (kk % 4) * 32, 16, 1024), 1);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_rs_tf32_n128(acc, ah[kk], gmma_desc(sw2 + (kk / 4) * BOX + (kk % 4) * 32, 16, 1024),
                       1);
  wgmma_commit();
}

// y1 -> h1 for group half H of a pair: y[4i + 2rr + e] is row (16·warp +
// g + 8rr), pair column 8i + 2c + e; the group's channels 8j + 2c + e are
// i = 8H + j. h1 = GELU(LN(y1 + up1_b)) leaves split as conv2's A
// fragments: a[j] = (row g, ch 8j + 2c), (g + 8, 8j + 2c), (g, +1), (g + 8,
// +1), channels 2c and 2c + 1 being K indices c and c + 4 of up2_wᵀ's
// permuted rows.
template <int H>
__device__ __forceinline__ void head_epilogue1(const float (&y)[64], uint32_t (&ah)[8][4],
                                               uint32_t (&al)[8][4], const float* sb1,
                                               const float* sls, const float* slb, int c,
                                               float eps) {
  float v[2][16], mu[2], rs[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 b = reinterpret_cast<const float2*>(sb1)[4 * j + c];
      v[rr][2 * j] = y[4 * (8 * H + j) + 2 * rr] + b.x;
      v[rr][2 * j + 1] = y[4 * (8 * H + j) + 2 * rr + 1] + b.y;
      s0 += v[rr][2 * j];
      s1 += v[rr][2 * j + 1];
    }
    mu[rr] = s0 + s1;
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    mu[rr] += __shfl_xor_sync(0xffffffffu, mu[rr], 1);
    mu[rr] += __shfl_xor_sync(0xffffffffu, mu[rr], 2);
    mu[rr] *= 1.f / C1;
    float q0 = 0.f, q1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float d0 = v[rr][2 * j] - mu[rr], d1 = v[rr][2 * j + 1] - mu[rr];
      q0 = fmaf(d0, d0, q0);
      q1 = fmaf(d1, d1, q1);
    }
    rs[rr] = q0 + q1;
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    rs[rr] += __shfl_xor_sync(0xffffffffu, rs[rr], 1);
    rs[rr] += __shfl_xor_sync(0xffffffffu, rs[rr], 2);
    rs[rr] = rsqrtf(rs[rr] * (1.f / C1) + eps);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 sc = reinterpret_cast<const float2*>(sls)[4 * j + c];
    const float2 bi = reinterpret_cast<const float2*>(slb)[4 * j + c];
    float h[2][2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      h[rr][0] = gelu_erf(fmaf((v[rr][2 * j] - mu[rr]) * rs[rr], sc.x, bi.x));
      h[rr][1] = gelu_erf(fmaf((v[rr][2 * j + 1] - mu[rr]) * rs[rr], sc.y, bi.y));
    }
    split_tf32_bits(h[0][0], ah[j][0], al[j][0]);
    split_tf32_bits(h[1][0], ah[j][1], al[j][1]);
    split_tf32_bits(h[0][1], ah[j][2], al[j][2]);
    split_tf32_bits(h[1][1], ah[j][3], al[j][3]);
  }
}

// y2 -> logits for group q. acc[4i + 2rr + e] is row (16·warp + g + 8rr),
// conv2 column 8i + 2c + e = 32r + channel: r = i / 4, channel 8(i % 4) +
// 2c + e. h2 = GELU(y2 + up2_b) is dotted with the hypernetwork rows, 8
// FMAs a (row, r, mask) a thread, then summed over the quad by a
// reduce-scatter (halves over lane bit 1, then bit 0) after which lane c
// holds r = c of both its rows, written to the staging tile.
template <int M>
__device__ __forceinline__ void head_epilogue2(const float (&acc)[64], float* stg,
                                               const float* hyp, const float* sb2, int q,
                                               int row0, int c) {
  float part[2][4][M];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int m = 0; m < M; ++m) part[rr][r][m] = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int r = i / 4, j = i % 4;
    const float2 b = reinterpret_cast<const float2*>(sb2)[4 * j + c];
    float2 hy[M];
#pragma unroll
    for (int m = 0; m < M; ++m) hy[m] = reinterpret_cast<const float2*>(hyp + m * C2)[4 * j + c];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const float h0 = gelu_erf(acc[4 * i + 2 * rr] + b.x);
      const float h1 = gelu_erf(acc[4 * i + 2 * rr + 1] + b.y);
#pragma unroll
      for (int m = 0; m < M; ++m)
        part[rr][r][m] = fmaf(h1, hy[m].y, fmaf(h0, hy[m].x, part[rr][r][m]));
    }
  }
  const bool b1 = c & 2, b0 = c & 1;
  float w[2][2][M], o[2][M];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr)
#pragma unroll
    for (int rp = 0; rp < 2; ++rp)
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const float send = b1 ? part[rr][rp][m] : part[rr][2 + rp][m];
        const float keep = b1 ? part[rr][2 + rp][m] : part[rr][rp][m];
        w[rr][rp][m] = keep + __shfl_xor_sync(0xffffffffu, send, 2);
      }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr)
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const float send = b0 ? w[rr][0][m] : w[rr][1][m];
      const float keep = b0 ? w[rr][1][m] : w[rr][0][m];
      o[rr][m] = keep + __shfl_xor_sync(0xffffffffu, send, 1);
    }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr)
#pragma unroll
    for (int m = 0; m < M; ++m) stg[((row0 + 8 * rr) * 16 + 4 * q + c) * M + m] = o[rr][m];
}

// B6 f32: a cp.async group's commit; the wait until at most the NBUF - 2
// latest of this thread's groups are in flight.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_ahead() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(NBUF - 2) : "memory");
}

// B6 f32: a 16-byte cp.async; the same reading src_bytes (16 or 0: zeros).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async16_zfill(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// B6 f32: a prompt's P [HT, gg] (bf16) at positions p0.. into the staging
// tile at ss, [HT, BP] at a pitch of PP bytes; positions past gg read
// zeros (gg % 8 == 0: a 16-byte piece lies wholly below or past it).
__device__ __forceinline__ void load_p(uint32_t ss, const __nv_bfloat16* p, int p0, int gg,
                                       int ctid) {
  for (int i = ctid; i < HT * BP / 8; i += 128) {
    const int r = i / (BP / 8), col = 8 * (i % (BP / 8));
    const bool in = p0 + col < gg;
    cp_async16_zfill(ss + r * PP + col * 2, p + (size_t)r * gg + (in ? p0 + col : 0), in ? 16 : 0);
  }
}

// B6 f32: chunk t of a prompt's C sequence (C1 [HT, D] channels 16t.. for
// t < 16, then C2's, 16(t - 16)..) into buffer t % NBUF at sc, [HT, CW] f32
// whose rows r = 2 mod 4 and 3 mod 4 have their two 8-float halves
// swapped, so that the B fragments' reads (rows 8ks + t and + 4, columns
// 8u + g) fall in 32 banks.
__device__ __forceinline__ void load_chunk(uint32_t sc, const float* c1, const float* c2, int t,
                                           int ctid) {
  const float* cm = t < CHUNKS / 2 ? c1 : c2;
  const int q = t % (CHUNKS / 2);
  const uint32_t dst = sc + (t % NBUF) * CHUNK;
  for (int i = ctid; i < HT * CW / 4; i += 128) {
    const int r = i / (CW / 4), col = 4 * (i % (CW / 4));
    cp_async16(dst + (r * CW + (col ^ ((r & 2) << 2))) * 4, cm + r * D + CW * q + col);
  }
}

// B6 f32: k-step ks's operands from the staging tile: P^T's A fragment at
// the warp's rows pw + g (+ 8), k 8ks + c (+ 4), a bf16's bits shifted into
// a TF32; C's B values (k 8ks + c, + 4; channel 8u + g) of both n8 tiles.
__device__ __forceinline__ void recon_operands(uint32_t (&a)[4], float (&b)[2][2],
                                               const uint8_t* sp, const float* buf, int ks,
                                               int pw, int g, int c) {
  const int k = 8 * ks + c;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const unsigned short* row = reinterpret_cast<const unsigned short*>(sp + (k + 4 * h) * PP);
    a[2 * h] = (uint32_t)row[pw + g] << 16;
    a[2 * h + 1] = (uint32_t)row[pw + g + 8] << 16;
  }
  const int sw = (c & 2) << 2;                   // rows k and k + 4: k % 4 = c
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    b[u][0] = buf[k * CW + ((8 * u + g) ^ sw)];
    b[u][1] = buf[(k + 4) * CW + ((8 * u + g) ^ sw)];
  }
}

// B6 f32: acc += P^T C over the 4 chunks t0.. of C's sequence (the 64
// channels held in acc; see rebuild_keys), P^T from spl; each chunk's
// wait, the named barrier that frees the buffer NBUF - 1 chunks back, and
// that chunk's copy. P^T C_lo and P^T C_hi of a chunk's two n8 tiles run
// over the 7 k-steps into four fresh accumulators, the next k-step's
// operands read ahead; then acc = acc + (lo + hi) on acc[0..7], and acc
// rotates by 8 (the loop is not unrolled: see rebuild_keys).
__device__ __forceinline__ void recon_group(float (&acc)[32], const uint8_t* spl,
                                            const uint8_t* sc, uint32_t ssc, const float* c1,
                                            const float* c2, int t0, int pw, int g, int c,
                                            int ctid, int bar) {
#pragma unroll 1
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + i;
    cp_async_wait_ahead();                         // chunk t has landed: this thread's part,
    named_sync(bar, 128);                          // everyone's; chunk t - 1's buffer is free
    if (t + NBUF - 1 < CHUNKS) load_chunk(ssc, c1, c2, t + NBUF - 1, ctid);
    cp_async_commit();                             // (an empty group past the last chunk)
    const float* buf = reinterpret_cast<const float*>(sc + (t % NBUF) * CHUNK);
    uint32_t a[2][4];
    float b[2][2][2];
    recon_operands(a[0], b[0], spl, buf, 0, pw, g, c);
    float lo[2][4] = {}, hi[2][4] = {};
#pragma unroll
    for (int ks = 0; ks < HT / 8; ++ks) {
      if (ks + 1 < HT / 8)
        recon_operands(a[(ks + 1) % 2], b[(ks + 1) % 2], spl, buf, ks + 1, pw, g, c);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        uint32_t h0, l0, h1, l1;
        split_tf32_bits(b[ks % 2][u][0], h0, l0);
        split_tf32_bits(b[ks % 2][u][1], h1, l1);
        mma_m16n8k8_tf32(lo[u], a[ks % 2], l0, l1);
        mma_m16n8k8_tf32(hi[u], a[ks % 2], h0, h1);
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // channel 16i + 8u + 2c + e % 2 of the group: n8 tile 2i + u, at
        // acc[4u + e] after i rotations
        float& x = acc[4 * u + e];
        x = x + (lo[u][e] + hi[u][e]);
      }
    float head[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) head[e] = acc[e];
#pragma unroll
    for (int e = 0; e < 24; ++e) acc[e] = acc[e + 8];
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[24 + e] = head[e];
  }
}

// B6 f32: prompt n's keys at the item's positions p0.. (the warp's rows pw
// + g, + 8; this thread's tile rows row0 = pw + g and row0 + 8), rebuilt
// from img0 through both branch layers, y = LN((y + P^T C) + b), and
// written to the warpgroup's keys tile kt [BP, D], each value where
// load_keys reads it from the thread that wrote it. acc[q][4j + 2rr + e] is
// row row0 + 8rr, channel 64q + 8j + 2c + e. P1^T and P2^T are copied once
// into the staging tile (sp, at ssp); C's 32 chunks of 16 channels stream
// through NBUF buffers (sc, at ssc), NBUF - 1 ahead of the one the
// warpgroup multiplies by. The loops over a layer's four 64-channel groups
// and a group's four chunks are not unrolled (the group in hand is acc[0],
// the four rotated after each; the chunk's 16 channels acc[0][0..7], the
// group rotated by 8 after each): the instruction cache holds the head's
// code and this, and with this unrolled the kernel ran 3.4x K3 f32's time
// (the variant "unrolled" of kernels/maskhead_variants.py).
__device__ __forceinline__ void rebuild_keys(const float* img0, const __nv_bfloat16* p1,
                                             const __nv_bfloat16* p2, const float* c1,
                                             const float* c2, const float* rows, float ln_eps,
                                             float* kt, int n, int p0, int row0, int gg, int g,
                                             int c, int ctid, int bar, const uint8_t* sp,
                                             uint32_t ssp, const uint8_t* sc, uint32_t ssc) {
  const int pw = row0 - g, pos = p0 + row0;
  const float* c1n = c1 + (size_t)n * HT * D;
  const float* c2n = c2 + (size_t)n * HT * D;
  load_p(ssp, p1 + (size_t)n * HT * gg, p0, gg, ctid);
  load_p(ssp + OFF_P2, p2 + (size_t)n * HT * gg, p0, gg, ctid);
  for (int t = 0; t < NBUF - 1; ++t) {
    load_chunk(ssc, c1n, c2n, t, ctid);
    cp_async_commit();
  }
  float acc[4][32];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int p = pos + 8 * rr;
        const float2 x = p < gg ? __ldg(reinterpret_cast<const float2*>(
                                      img0 + (size_t)p * D + 64 * q + 8 * j + 2 * c))
                                : make_float2(0.f, 0.f);
        acc[q][4 * j + 2 * rr] = x.x;
        acc[q][4 * j + 2 * rr + 1] = x.y;
      }
#pragma unroll 1
  for (int l = 0; l < 2; ++l) {
#pragma unroll 1
    for (int q = 0; q < 4; ++q) {
      recon_group(acc[0], sp + l * OFF_P2, sc, ssc, c1n, c2n, 16 * l + 4 * q, pw, g, c, ctid,
                  bar);
#pragma unroll
      for (int e = 0; e < 32; ++e) {               // the next group to acc[0]
        const float x = acc[0][e];
        acc[0][e] = acc[1][e];
        acc[1][e] = acc[2][e];
        acc[2][e] = acc[3][e];
        acc[3][e] = x;
      }
    }
    // (y + a) + b, then the LayerNorm: one-pass variance max(E[y^2] - mu^2,
    // 0) over the row's 256 channels, which lie in the 4 threads of a quad
    const float* b = rows + 3 * l * D;
    float st[2][2] = {};
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 bb = __ldg(reinterpret_cast<const float2*>(b + 64 * q + 8 * j + 2 * c));
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          float& x = acc[q][4 * j + 2 * rr];
          float& y = acc[q][4 * j + 2 * rr + 1];
          x += bb.x;
          y += bb.y;
          st[rr][0] += x + y;
          st[rr][1] = fmaf(y, y, fmaf(x, x, st[rr][1]));
        }
      }
#pragma unroll
    for (int lane = 1; lane < 4; lane *= 2)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
#pragma unroll
        for (int k = 0; k < 2; ++k) st[rr][k] += __shfl_xor_sync(0xffffffffu, st[rr][k], lane);
    float mu[2], rs[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mu[rr] = st[rr][0] * (1.f / D);
      rs[rr] = rsqrtf(fmaxf(st[rr][1] * (1.f / D) - mu[rr] * mu[rr], 0.f) + ln_eps);
    }
    const float *scale = rows + (3 * l + 1) * D, *bias = rows + (3 * l + 2) * D;
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int ch = 64 * q + 8 * j + 2 * c;
        const float2 sc2 = __ldg(reinterpret_cast<const float2*>(scale + ch));
        const float2 bi2 = __ldg(reinterpret_cast<const float2*>(bias + ch));
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          float& x = acc[q][4 * j + 2 * rr];
          float& y = acc[q][4 * j + 2 * rr + 1];
          x = fmaf((x - mu[rr]) * rs[rr], sc2.x, bi2.x);
          y = fmaf((y - mu[rr]) * rs[rr], sc2.y, bi2.y);
        }
      }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
        *reinterpret_cast<float2*>(kt + (row0 + 8 * rr) * D + 64 * q + 8 * j + 2 * c) =
            make_float2(acc[q][4 * j + 2 * rr], acc[q][4 * j + 2 * rr + 1]);
}

// K3 f32 (RECON false: the keys [Np, gg, D]) and B6 f32 (RECON true: keys
// unused, the keys tile rebuilt from rc).
template <int M, bool RECON>
__global__ void __launch_bounds__(THREADS, 1)
mask_head_tf32x3_kernel(const __grid_constant__ CUtensorMap tw1,   // [2, 256 N, 256 K] planes
                        const __grid_constant__ CUtensorMap tw2,   // [2, 128 N, 64 K] planes
                        const float* __restrict__ keys,            // [Np, gg, D]
                        const float* __restrict__ up1_b,           // [C1]
                        const float* __restrict__ ln_s,            // [C1]
                        const float* __restrict__ ln_b,            // [C1]
                        const float* __restrict__ up2_b,           // [C2]
                        const float* __restrict__ hyper,           // [Np, M, C2]
                        float* __restrict__ out,                   // [Np, content, 16, M]
                        int gg, int content, int tiles, int total, float eps,
                        const Recon rc) {
  extern __shared__ uint8_t smem_k3f[];
  const uint32_t sraw = smem_u32(smem_k3f);
  const uint32_t base = (sraw + 1023) & ~1023u;
  uint8_t* sm = smem_k3f + (base - sraw);
  auto full = [&](int slot) { return base + OFF_BAR + 8 * slot; };
  auto empty = [&](int slot) { return base + OFF_BAR + 8 * (SLOTS + slot); };
  const uint32_t wbar = base + OFF_BAR + 16 * SLOTS;
  // the up1_wᵀ ring's depth: B6 f32 gives its last stages to the rebuild
  constexpr int RING = RECON ? SLOTS - FREE : SLOTS;

  // this CTA's units [u0, u1): unit u is items 2u (warpgroup 0) and 2u + 1
  const long long units = (total + 1) / 2;
  const long long u0 = units * blockIdx.x / gridDim.x;
  const long long u1 = units * (blockIdx.x + 1) / gridDim.x;
  const int wg = threadIdx.x / 128, ctid = threadIdx.x % 128;
  const int warp = ctid / 32, lane = ctid % 32, g = lane / 4, c = lane % 4;
  const int row0 = 16 * warp + g;                 // this thread's rows: row0, row0 + 8
  const int bar = 1 + wg;                         // this warpgroup's named barrier
  float* stg = reinterpret_cast<float*>(sm + OFF_STG + wg * STG);
  float* hyp = reinterpret_cast<float*>(sm + OFF_HYP + wg * HYP);
  float* kt = RECON ? rc.keys + ((size_t)blockIdx.x * 2 + wg) * KTILE : nullptr;

  float* sb1 = reinterpret_cast<float*>(sm + OFF_VEC);
  float* sls = sb1 + C1;
  float* slb = sls + C1;
  float* sb2 = slb + C1;
  for (int i = threadIdx.x; i < C1; i += THREADS) {
    sb1[i] = up1_b[i];
    sls[i] = ln_s[i];
    slb[i] = ln_b[i];
  }
  for (int i = threadIdx.x; i < C2; i += THREADS) sb2[i] = up2_b[i];
  unsigned int* releases = reinterpret_cast<unsigned int*>(sm + OFF_CNT);
  if (threadIdx.x == 0) {
    for (int i = 0; i < SLOTS; ++i) {
      mbar_init(full(i), 1);
      mbar_init(empty(i), THREADS);
      releases[i] = 0u;
    }
    mbar_init(wbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Ring stage st (counted over this CTA's units) holds unit u0 + st / 16,
  // group pair (st % 16) / 8, K chunk st % 8 of up1_wᵀ.
  auto fill = [&](int st) {
    if (u0 + st / NSTAGE >= u1) return;
    const uint32_t dst = base + OFF_RING + (st % RING) * STAGE;
    const int k0 = KC * (st % NCHUNK), n0 = 128 * ((st % NSTAGE) / NCHUNK);
    mbar_expect_tx(full(st % RING), STAGE);
    tma_load_3d(dst, &tw1, k0, n0, 0, full(st % RING));
    tma_load_3d(dst + BOX, &tw1, k0, n0, 1, full(st % RING));
  };
  auto stage_at = [&](int st) { return base + OFF_RING + (st % RING) * STAGE; };
  auto stage_wait = [&](int st) { mbar_wait(full(st % RING), (st / RING) & 1); };
  auto stage_done = [&](int st) {
    mbar_arrive(empty(st % RING));
    if (ctid == 0) {
      // two releases a use of the slot: the odd one is the second
      const bool second = atomicAdd(releases + st % RING, 1u) & 1u;
      if (second && u0 + (st + RING) / NSTAGE < u1) {
        mbar_wait(empty(st % RING), (st / RING) & 1);
        fill(st + RING);
      }
    }
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(wbar, 4 * BOX);
    for (int p = 0; p < 2; ++p)
      for (int h = 0; h < 2; ++h)
        tma_load_3d(base + OFF_W2 + (2 * p + h) * BOX, &tw2, KC * h, 0, p, wbar);
    for (int i = 0; i < RING; ++i) fill(i);
  }
  // The warpgroups issue their products in turns (named barriers 3 and 4,
  // warpgroup 0 first); warpgroup 1 skips the turn after the CTA's last.
  const int my_turn = 3 + wg, other_turn = 4 - wg;
  if (wg == 1) named_arrive(3, 256);
  auto take_turn = [&]() { named_sync(my_turn, 256); };
  auto pass_turn = [&](bool last) {
    if (!(wg == 1 && last)) named_arrive(other_turn, 256);
  };
  mbar_wait(wbar, 0);
  const uint32_t sw2 = base + OFF_W2;

  int s = 0;                                      // ring stages taken
  for (long long u = u0; u < u1; ++u) {
    const long long item = 2 * u + wg;
    const bool live = item < total;
    const int n = live ? (int)(item / tiles) : 0;
    const int p0 = live ? (int)(item % tiles) * BP : 0;
    const int nrows = live ? min(BP, content - p0) : 0;
    const bool v0 = row0 < nrows, v8 = row0 + 8 < nrows;
    const float* x0 = (RECON ? kt + row0 * D : keys + ((size_t)n * gg + p0 + row0) * D) + 2 * c;
    const float* x8 = x0 + 8 * D;
    // the last item's copy-out is done: its staging tile and hypernetwork
    // rows may be overwritten
    named_sync(bar, 128);
    for (int e = ctid; e < M * C2; e += 128) hyp[e] = live ? hyper[(size_t)n * M * C2 + e] : 0.f;
    named_sync(bar, 128);
    if constexpr (RECON) {
      if (live) {
        constexpr int off_c = OFF_RING + RING * STAGE;          // the stages the ring leaves
        constexpr int per_wg = FREE * STAGE / 2;
        rebuild_keys(rc.img0, rc.p1, rc.p2, rc.c1, rc.c2, rc.rows, rc.ln_eps, kt, n, p0, row0,
                     gg, g, c, ctid, bar, sm + OFF_STG + wg * STG, base + OFF_STG + wg * STG,
                     sm + off_c + wg * per_wg, base + off_c + wg * per_wg);
        named_sync(bar, 128);                     // the staging tile is the logits' again
      }
    }

    float r[4][4];
    load_keys<RECON>(r, x0, x8, 0, v0, v8);
#pragma unroll 1
    for (int pr = 0; pr < 2; ++pr) {
      // y1 of groups 2pr, 2pr + 1: a fresh accumulator a K chunk, summed in f32
      float y[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) y[i] = 0.f;
#pragma unroll 1
      for (int cc = 0; cc < NCHUNK; ++cc) {
        uint32_t fh[4][4], fl[4][4];
        split_chunk(r, fh, fl);
        if (cc + 1 < NCHUNK) load_keys<RECON>(r, x0, x8, cc + 1, v0, v8);
        else if (pr == 0) load_keys<RECON>(r, x0, x8, 0, v0, v8);
        float acc[64];
        stage_wait(s);
        take_turn();
        issue_chunk(acc, fh, fl, stage_at(s), true);
        pass_turn(false);
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(fh);
        fence_regs(fl);
        stage_done(s);
        ++s;
#pragma unroll
        for (int i = 0; i < 64; ++i) y[i] += acc[i];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t ah[8][4], al[8][4];
        if (h == 0) head_epilogue1<0>(y, ah, al, sb1, sls, slb, c, eps);
        else head_epilogue1<1>(y, ah, al, sb1, sls, slb, c, eps);
        float acc[64];
        take_turn();
        issue_conv2(acc, ah, al, sw2);
        pass_turn(u + 1 == u1 && pr == 1 && h == 1);
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(ah);
        fence_regs(al);
        head_epilogue2<M>(acc, stg, hyp, sb2, 2 * pr + h, row0, c);
      }
    }
    named_sync(bar, 128);
    // the live rows: one contiguous run of out, 16 bytes at a time
    const int n16 = nrows * 4 * M;
    const float4* src4 = reinterpret_cast<const float4*>(stg);
    float4* dst4 = reinterpret_cast<float4*>(out + ((size_t)n * content + p0) * 16 * M);
    for (int i = ctid; i < n16; i += 128) dst4[i] = src4[i];
  }
}

// A launch's arguments (K3 f32: rc null; B6 f32: keys null).
struct Args {
  const void *keys, *up1_w, *up1_b, *ln_s, *ln_b, *up2_w, *up2_b, *hyper;
  void *out, *scratch;
  int np_, gg, content;
  float eps;
  Recon rc;
};

template <int M, bool RECON>
int launch(const Args& a, int n_ctas, cudaStream_t stream) {
  auto kernel = mask_head_tf32x3_kernel<M, RECON>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (a.content + BP - 1) / BP;
  const long long total = (long long)a.np_ * tiles;
  if (total > (1ll << 30)) return (int)cudaErrorInvalidValue;
  float* planes = static_cast<float*>(a.scratch);
  CUtensorMap t1, t2;
  const cuuint32_t box[3] = {KC, 128, 1};
  const cuuint64_t dims1[3] = {(cuuint64_t)D, (cuuint64_t)4 * C1, 2};
  const cuuint64_t strides1[2] = {(cuuint64_t)D * 4, (cuuint64_t)4 * C1 * D * 4};
  const cuuint64_t dims2[3] = {(cuuint64_t)C1, (cuuint64_t)4 * C2, 2};
  const cuuint64_t strides2[2] = {(cuuint64_t)C1 * 4, (cuuint64_t)4 * C2 * C1 * 4};
  if (!tensor_map_f32(&t1, planes, 3, dims1, strides1, box) ||
      !tensor_map_f32(&t2, planes + 2 * D * 4 * C1, 3, dims2, strides2, box))
    return (int)cudaErrorInvalidValue;
  typedef const float* P;
  split_head_weights_kernel<<<72, 256, 0, stream>>>(static_cast<P>(a.up1_w),
                                                     static_cast<P>(a.up2_w), planes);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long units = (total + 1) / 2;
  const int grid = (int)(units < n_ctas ? units : n_ctas);
  kernel<<<grid, THREADS, SMEM, stream>>>(
      t1, t2, static_cast<P>(a.keys), static_cast<P>(a.up1_b), static_cast<P>(a.ln_s),
      static_cast<P>(a.ln_b), static_cast<P>(a.up2_b), static_cast<P>(a.hyper),
      static_cast<float*>(a.out), a.gg, a.content, tiles, (int)total, a.eps, a.rc);
  return (int)cudaGetLastError();
}

template <bool RECON>
int launch_m(const Args& a, int n_masks, int n_ctas, cudaStream_t stream) {
  switch (n_masks) {
    case 1: return launch<1, RECON>(a, n_ctas, stream);
    case 2: return launch<2, RECON>(a, n_ctas, stream);
    case 3: return launch<3, RECON>(a, n_ctas, stream);
    case 4: return launch<4, RECON>(a, n_ctas, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace rat_k3f

// K3 in f32: the same arguments as rat_mask_head, every tensor f32, plus
// scratch of rat_mask_head_f32_scratch() floats (the weights' TF32 planes,
// 576 KB) after out, and no n_ctas (one CTA an SM); out [Np, content, 16,
// M]. Two launches on the stream: the weight split, then the head.
extern "C" int rat_mask_head_f32(const void* keys, const void* up1_w, const void* up1_b,
                                 const void* ln_s, const void* ln_b, const void* up2_w,
                                 const void* up2_b, const void* hyper, void* out, void* scratch,
                                 int np_, int gg, int content, int n_masks, float eps,
                                 void* stream) {
  if (np_ < 1 || content < 1 || content > gg) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  rat_k3f::Args a = {};
  a.keys = keys, a.up1_w = up1_w, a.up1_b = up1_b, a.ln_s = ln_s, a.ln_b = ln_b;
  a.up2_w = up2_w, a.up2_b = up2_b, a.hyper = hyper, a.out = out, a.scratch = scratch;
  a.np_ = np_, a.gg = gg, a.content = content, a.eps = eps;
  return rat_k3f::launch_m<false>(a, n_masks, sms, static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory a K3 f32 CTA takes (for reports).
extern "C" int rat_mask_head_f32_smem() { return rat_k3f::SMEM; }

// Floats of scratch rat_mask_head_f32 takes: up1_wᵀ's and up2_wᵀ's planes.
extern "C" int rat_mask_head_f32_scratch() { return rat_k3f::PLANES; }

// B6 in f32: rat_mask_head_probs's arguments, every tensor f32 but P1 and
// P2 (bf16), plus scratch of rat_mask_head_probs_f32_scratch(n_ctas)
// floats after out (the weights' TF32 planes, then a keys tile [64, 256]
// for each warpgroup of the grid, at most n_ctas CTAs). Two launches on the
// stream: the weight split, then the head.
extern "C" int rat_mask_head_probs_f32(const void* img0, const void* p1, const void* c1m,
                                       const void* p2, const void* c2m, const void* rows,
                                       const void* up1_w, const void* up1_b, const void* ln_s,
                                       const void* ln_b, const void* up2_w, const void* up2_b,
                                       const void* hyper, void* out, void* scratch, int np_,
                                       int gg, int content, int n_masks, float eps,
                                       float ln_eps, int n_ctas, void* stream) {
  if (np_ < 1 || gg % 8 != 0 || content < 1 || content > gg || n_ctas < 1)
    return (int)cudaErrorInvalidValue;
  rat_k3f::Args a = {};
  a.up1_w = up1_w, a.up1_b = up1_b, a.ln_s = ln_s, a.ln_b = ln_b;
  a.up2_w = up2_w, a.up2_b = up2_b, a.hyper = hyper, a.out = out, a.scratch = scratch;
  a.np_ = np_, a.gg = gg, a.content = content, a.eps = eps;
  typedef const float* F;
  typedef const __nv_bfloat16* B;
  a.rc = {static_cast<F>(img0), static_cast<B>(p1), static_cast<B>(p2), static_cast<F>(c1m),
          static_cast<F>(c2m), static_cast<F>(rows),
          static_cast<float*>(scratch) + rat_k3f::PLANES, ln_eps};
  return rat_k3f::launch_m<true>(a, n_masks, n_ctas, static_cast<cudaStream_t>(stream));
}

// Floats of scratch rat_mask_head_probs_f32 takes for a grid of at most
// n_ctas CTAs: the weights' planes, then two keys tiles a CTA.
extern "C" int rat_mask_head_probs_f32_scratch(int n_ctas) {
  return rat_k3f::PLANES + n_ctas * 2 * rat_k3f::KTILE;
}
