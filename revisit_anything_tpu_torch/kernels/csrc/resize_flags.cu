// Fused lowres -> original mask resize + threshold flags + per-axis stats.
//
// Two instantiations of one kernel, by the logits' type E: bf16 (entry
// rat_resize_flags) and f32 (entry rat_resize_flags_f32, for an f32 SAM:
// the TPU kernel keeps its row matrix and its products in the logits'
// dtype, so the f32 row pass multiplies f32 logits by unrounded f32 taps,
// `ops.maskresize.resize_taps(..., dtype=float32)`). Only the loads
// differ: a grid row is g·16·M·sizeof(E) bytes, so the f32 ring takes
// twice the shared memory (1 CTA an SM at 17places, against 2).
//
// Replaces: revisit_anything_tpu/ops/maskresize.py `fused_resize_flags` /
// `_resize_flags_kernel` (pallas_call at :207, emit_stats=True, called at
// models/sam/amg.py:275-277). Per prompt n and mask token m:
//   T[o, c]   = sum_k wh[o, k] · L[k, c]       bf16 x bf16, f32 accumulate
//   R[o, p]   = sum_c ww[p, c] · T[o, c]       true f32 FMA (no TF32)
//   flags     = (R > thr-off) | (R > thr) << 1 | (R > thr+off) << 2
// where L is the decoder's block-layout logits [Np, gh·g, 16, M] read in
// place: row k = (i, a1, a2) = 4i+2a1+a2, col c = (j, b1, b2) = 4j+2b1+b2.
// Stats (the port's own layout): rowst[n, m, o] = (rows-any, hi count,
// lo count) as int32, colany[n, m, p] uint8 — integer-exact reductions of
// this kernel's own flags.
//
// What bounds it on the H100: bytes. The composed bilinear matrices are
// banded (at most 3 adjacent taps a row and a column for every image
// size AMG serves), so the [H, 4gh]·[4gh, 4g]·[4g, W] products the TPU
// ran on its MXU shrink to 3 FMAs an output; what remains is reading the
// bf16 logits once (0.31 GB at 1024 prompts) and writing the uint8 flags
// once (0.24 GB). Each tap table row is (first tap, w0, w1, w2), built
// once per shape by the wrapper (ops/maskresize.py `tap_table`); taps
// past a row's last non-zero weigh 0, which leaves every sum unchanged up
// to f32 summation order.
//
// Design: persistent CTAs of 12 warps (2 an SM at the serving shape),
// each taking whole prompts (all M masks) and walking a prompt's H output
// rows top to bottom in bands of up to 8 rows; warp-specialized.
// - Loads: grid row i of a prompt, [g, 16, M], is one contiguous chunk of
//   32·g·M bytes. A row-warp thread streams the CTA's chunks, in order, by
//   1-D bulk copies (cp.async.bulk + mbarrier, no tensor map) into a ring
//   of 6 slots, up to 6 rows ahead of the first row of the band in hand
//   (into the next prompt at a prompt's end); a slot is refilled only
//   after the last band that reads it, so each logit is read from HBM once.
// - Row warps (4): a thread owns one (j, b1) run — 2M consecutive bf16 of
//   a row k — for every row of the band, keeps the 3 rows k0..k0+2 of its
//   current output row as f32 in registers (sliding down as k0 grows) and
//   writes T[m, r, c] (f32, shared memory) as float2 pairs, into one of
//   two T buffers; named barriers say when a buffer is full and empty.
// - Column warps (8): a lane owns one pixel (its taps in registers while
//   its warp walks down a 32-pixel chunk, eight rows a step, all loads
//   before the first store), reads 3 T values and writes one flag byte
//   into a staging tile laid out as the flags are in device memory
//   ([m][band rows][W rounded to 32]); consecutive lanes touch consecutive
//   words, without bank conflicts. Then eight threads a row (all of the
//   band's rows at once) copy the staged rows out by 16-byte stores
//   (bytes where W % 16 != 0) and count their bits by popcount, meeting
//   by three shuffles; columns-any is ORed down the rows into a per-mask
//   word array, written out once at the end of the prompt.
// - Both tap tables sit in shared memory where they fit (S).
// The column warps set the pace and are latency-bound, not bound by bytes
// (kernels/resize_variants.py; PERF.md).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace rat_k4 {

using namespace rat_hopper;

constexpr int CT = 256;                // column-pass and stats threads (warps 0-7)
constexpr int RT = 128;                // row-pass threads (warps 8-11), one a (j, b1) run
constexpr int THREADS = CT + RT;
// named barriers: T[x] full (row warps arrive, column warps wait), T[x]
// empty (the reverse), the column warps alone, the row warps alone
constexpr int BAR_FULL = 1, BAR_EMPTY = 3, BAR_C = 5, BAR_R = 6;
constexpr int G = 64;                 // the largest grid: 4G = 256 low-res columns
constexpr int C = 4 * G;              // T's row pitch (floats)
constexpr int TAPS = 3;               // taps a row and a column
constexpr int NSLOT = 6;              // ring slots (grid rows)
constexpr int BAND = 8;               // output rows a band, at most
constexpr int STAGE_BUDGET = 8192;    // staged flag bytes a band and buffer
constexpr int MAX_W = 8192;
constexpr int TABLE_BUDGET = 16384;   // tap tables kept in shared memory up to this size
static_assert(4 * BAND * 8 <= CT, "band_out takes eight threads a row of a band");

// Ring slot pitch; a slot holds one grid row of g·16·M logits of es bytes.
__host__ __device__ constexpr int slot_bytes(int m, int es) { return G * 16 * m * es; }

// Shared memory of a CTA: the ring, two T buffers [M·band][C] f32, two
// staging tiles [M·band][w4] bytes (w4 = W rounded up to 32), two
// columns-any word arrays [M][w4 / 4] (by prompt parity), the barriers,
// and both tap tables where they fit the budget (else they are read from
// device memory).
struct Layout {
  int band, w4, t, stage, cw, bar, tab, total;
};

__host__ __device__ inline Layout layout(int m, int w, int h, int es) {
  Layout L;
  L.w4 = (w + 31) & ~31;                // staged row pitch: whole 32-pixel chunks
  int band = STAGE_BUDGET / (m * L.w4);
  L.band = band < 1 ? 1 : (band > BAND ? BAND : band);
  L.t = NSLOT * slot_bytes(m, es);
  L.stage = L.t + 2 * L.band * m * C * 4;
  L.cw = L.stage + 2 * L.band * m * L.w4;
  L.bar = (L.cw + 2 * m * L.w4 + 7) & ~7;
  L.tab = (L.bar + NSLOT * 8 + 15) & ~15;
  L.total = L.tab + ((h + w) * 16 <= TABLE_BUDGET ? (h + w) * 16 : 0);
  return L;
}

// A tap table row's first tap, kept in [0, hi]: stored as a float in the
// wrapper's table (S = false), as its clamped int bits in the shared
// memory copy (S = true).
template <bool S>
__device__ __forceinline__ int tap_index(float x, int hi) {
  if (S) return __float_as_int(x);
  const int k = __float2int_rn(x);
  return k < 0 ? 0 : (k > hi ? hi : k);
}
template <bool S>
__device__ __forceinline__ int first_tap(const float4* tab, int r, int hi) {
  return tap_index<S>(tab[r].x, hi);
}

// A band: output rows [o0, o1) of the CTA's prompt pl (local index),
// reading grid rows i_lo..i_hi.
struct Band {
  int pl, o0, o1, i_lo, i_hi;
};

// The band after b: up to `band` rows whose taps lie in fewer than NSLOT
// grid rows (every band's grid rows fit the ring at once). The rows'
// first taps are loaded together.
template <bool S>
__device__ __forceinline__ Band next_band(Band b, const float4* htap, int h, int band,
                                          int kmax) {
  Band n;
  n.pl = b.o1 < h ? b.pl : b.pl + 1;
  n.o0 = b.o1 < h ? b.o1 : 0;
  int k[BAND];
#pragma unroll
  for (int r = 0; r < BAND; ++r) k[r] = first_tap<S>(htap, min(n.o0 + r, h - 1), kmax);
#pragma unroll
  for (int r = 0; r < BAND; ++r)
    if (r >= band || n.o0 + r >= h) k[r] = 1 << 20;
  n.i_lo = k[0] >> 2;
  n.o1 = n.o0 + 1;
  n.i_hi = (k[0] + TAPS - 1) >> 2;
#pragma unroll
  for (int r = 1; r < BAND; ++r) {
    const int last = (k[r] + TAPS - 1) >> 2;
    if (n.o1 == n.o0 + r && last - n.i_lo < NSLOT) {
      n.o1 = n.o0 + r + 1;
      n.i_hi = last;
    }
  }
  return n;
}

// The first row thread: bulk-copy the CTA's grid rows issued..lim-1
// (sequence numbers, at most `total`) into their ring slots. Sequence s
// is prompt s / R (blockIdx.x + (s / R)·gridDim.x), grid row i0 + s % R.
template <int M, typename E>
__device__ __forceinline__ void issue_until(int& issued, int lim, int total, int R, int i0, int gh,
                                            int g, const E* logits, uint32_t ring_s,
                                            uint32_t bar0) {
  constexpr int ES = (int)sizeof(E);
  lim = lim < total ? lim : total;
  for (; issued < lim; ++issued) {
    const int s = issued, pl = s / R, i = i0 + s - pl * R;
    const size_t n = blockIdx.x + (size_t)pl * gridDim.x;
    const uint32_t bar = bar0 + 8 * (s % NSLOT);
    mbar_expect_tx(bar, g * 16 * M * ES);
    bulk_load_1d(ring_s + (s % NSLOT) * slot_bytes(M, ES), logits + (n * gh + i) * (g * 16 * M),
                 g * 16 * M * ES, bar);
  }
}

// Wait until the ring holds every grid row band b reads.
__device__ __forceinline__ void wait_rows(Band b, int R, int i0, uint32_t bar0) {
  for (int i = b.i_lo; i <= b.i_hi; ++i) {
    const int s = b.pl * R - i0 + i;
    mbar_wait(bar0 + 8 * (s % NSLOT), (s / NSLOT) & 1);
  }
}

// Row k of this thread's (j, b1) run, 2M logits (M words of bf16 pairs,
// or 2M f32), as f32.
template <int M, typename E>
__device__ __forceinline__ void load_run(float (&dst)[2 * M], const uint8_t* __restrict__ ring,
                                         int k, int seq0, int i0, int j, int b1) {
  const int i = k >> 2, a1 = (k >> 1) & 1, a2 = k & 1;
  const uint8_t* slot = ring + ((seq0 + i - i0) % NSLOT) * slot_bytes(M, (int)sizeof(E));
  const int e0 = (16 * j + 8 * a1 + 4 * b1 + 2 * a2) * M;   // the run's first element
  if constexpr (sizeof(E) == 4) {
    const float* src = reinterpret_cast<const float*>(slot) + e0;
#pragma unroll
    for (int q = 0; q < 2 * M; ++q) dst[q] = src[q];
  } else {
    const uint32_t* src = reinterpret_cast<const uint32_t*>(slot) + (e0 >> 1);
#pragma unroll
    for (int w = 0; w < M; ++w) {
      const uint32_t u = src[w];
      dst[2 * w] = __uint_as_float(u << 16);
      dst[2 * w + 1] = __uint_as_float(u & 0xffff0000u);
    }
  }
}

// T[m·nrows + r, c] = sum_t wh[o0+r, k0+t] · L[k0+t, c, m]: row thread
// `run` owns one (j, b1) run (c = 4j + 2b1 + b2) for every row of the band.
template <int M, bool S, typename E>
__device__ __forceinline__ void row_pass(const uint8_t* __restrict__ ring, float* __restrict__ T,
                                         const float4* htap, int o0, int nrows, int seq0, int i0,
                                         int kmax, int g, int run) {
  if (run >= 2 * g) return;
  const int j = run >> 1, b1 = run & 1;
  float win[TAPS][2 * M];
  int wk = -TAPS - 1;                       // the row of win[0]
  for (int r = 0; r < nrows; ++r) {
    const float4 tp = htap[o0 + r];
    const int k0 = tap_index<S>(tp.x, kmax);
    const int d = k0 - wk;
    if (d == 1) {
#pragma unroll
      for (int q = 0; q < 2 * M; ++q) {
        win[0][q] = win[1][q];
        win[1][q] = win[2][q];
      }
      load_run<M, E>(win[2], ring, k0 + 2, seq0, i0, j, b1);
    } else if (d == 2) {
#pragma unroll
      for (int q = 0; q < 2 * M; ++q) win[0][q] = win[2][q];
      load_run<M, E>(win[1], ring, k0 + 1, seq0, i0, j, b1);
      load_run<M, E>(win[2], ring, k0 + 2, seq0, i0, j, b1);
    } else if (d != 0) {
      load_run<M, E>(win[0], ring, k0, seq0, i0, j, b1);
      load_run<M, E>(win[1], ring, k0 + 1, seq0, i0, j, b1);
      load_run<M, E>(win[2], ring, k0 + 2, seq0, i0, j, b1);
    }
    wk = k0;
    float* trow = T + r * C + 2 * run;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      // element (b2, m) of the run sits at b2·M + m
      const float t0 = fmaf(tp.w, win[2][m], fmaf(tp.z, win[1][m], tp.y * win[0][m]));
      const float t1 =
          fmaf(tp.w, win[2][M + m], fmaf(tp.z, win[1][M + m], tp.y * win[0][M + m]));
      *reinterpret_cast<float2*>(trow + m * nrows * C) = make_float2(t0, t1);
    }
  }
}

// The flag byte of v: bit0 = v > lo, bit1 = v > mid, bit2 = v > hi (three
// compares, a select and two predicated ORs).
__device__ __forceinline__ uint32_t flag_of(float v, float lo, float mid, float hi) {
  uint32_t f = v > lo ? 1u : 0u;
  if (v > mid) f |= 2u;
  if (v > hi) f |= 4u;
  return f;
}

// This warp's share of the column pass: tasks [t0, t1) of the band's
// (32-pixel chunk, row) tasks, cut chunk-major into 8 shares, and the
// taps of its first two chunks, loaded together.
struct ColShare {
  int t0, t1;
  float4 tp[2];
};

__device__ __forceinline__ ColShare col_share(const float4* wtap, int rows, int w, int w4) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tasks = (w4 >> 5) * rows;
  const int per = (tasks + CT / 32 - 1) / (CT / 32);
  ColShare c;
  c.t0 = warp * per;
  c.t1 = min(tasks, c.t0 + per);
  const int ch = c.t0 / rows;
#pragma unroll
  for (int k = 0; k < 2; ++k) c.tp[k] = wtap[min(32 * (ch + k) + lane, w - 1)];
  return c;
}

// Flags of the band's rows rr = m·nrows + r into the staging tile
// st [rr][w4]: a lane keeps its pixel's taps while it walks down the rows
// of a chunk, eight rows a step. Lanes past W compare against +inf (flag
// 0) and write the row's padding.
template <bool S>
__device__ __forceinline__ void column_pass(const float* __restrict__ T,
                                            uint8_t* __restrict__ st, const float4* wtap,
                                            const ColShare& cs, int rows, int w, int w4,
                                            int cmax, float t_lo, float t_mid, float t_hi) {
  const int lane = threadIdx.x & 31;
  const int ch0 = cs.t0 / rows;
  for (int t = cs.t0; t < cs.t1;) {
    const int ch = t / rows, rr0 = t - ch * rows;
    const int rr1 = min(rows, rr0 + cs.t1 - t);
    t += rr1 - rr0;
    const int p = 32 * ch + lane;
    float4 tp = ch == ch0 ? cs.tp[0] : ch == ch0 + 1 ? cs.tp[1] : wtap[min(p, w - 1)];
    const bool in = p < w;
    const float inf = __int_as_float(0x7f800000);
    const float lo = in ? t_lo : inf, mid = in ? t_mid : inf, hi = in ? t_hi : inf;
    const float* tr = T + rr0 * C + tap_index<S>(tp.x, cmax);
    uint8_t* sp = st + rr0 * w4 + p;
    int rr = rr0;
    for (; rr + 8 <= rr1; rr += 8, tr += 8 * C, sp += 8 * w4) {
      // all eight rows' loads before the first store (a byte store could
      // alias T as far as the compiler knows, and would order them)
      float q[8][TAPS];
#pragma unroll
      for (int k = 0; k < 8; ++k)
#pragma unroll
        for (int t = 0; t < TAPS; ++t) q[k][t] = tr[k * C + t];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float v = fmaf(tp.w, q[k][2], fmaf(tp.z, q[k][1], tp.y * q[k][0]));
        sp[k * w4] = (uint8_t)flag_of(v, lo, mid, hi);
      }
    }
    for (; rr < rr1; ++rr, tr += C, sp += w4) {
      const float v = fmaf(tp.w, tr[2], fmaf(tp.z, tr[1], tp.y * tr[0]));
      *sp = (uint8_t)flag_of(v, lo, mid, hi);
    }
  }
}

// Row stats of the staged band into rowst, its columns-any ORed into cw
// [M][w4 / 4], and its flags copied out. Eight threads take a row (the
// band's M·rows ≤ 32 rows all at once), 16 bytes a thread where W % 16 ==
// 0, bytes otherwise; a row's counts meet by three shuffles. Columns-any:
// a thread a (mask, word), ORed down the rows.
template <int M>
__device__ __forceinline__ void band_out(const uint8_t* st, uint32_t* cw, uint8_t* flags,
                                         int* rowst, int n, int o0, int nrows, int h, int w,
                                         int w4) {
  const int nq = w4 >> 2;
  const int rr = threadIdx.x >> 3, sub = threadIdx.x & 7;
  const bool live = rr < M * nrows;
  const int m = (rr >= nrows) + (rr >= 2 * nrows) + (rr >= 3 * nrows), r = rr - m * nrows;
  uint32_t any = 0u, cnt = 0u;                   // cnt: hi count << 16 | lo count
  if (live) {
    uint8_t* dst = flags + (((size_t)n * M + m) * h + o0 + r) * w;
    const uint32_t* row = reinterpret_cast<const uint32_t*>(st + rr * w4);
    if (w % 16 == 0) {
      for (int v = sub; v < (w >> 4); v += 8) {
        const uint4 u = reinterpret_cast<const uint4*>(row)[v];
        reinterpret_cast<uint4*>(dst)[v] = u;
        any |= (u.x | u.y | u.z | u.w) & 0x02020202u;
        cnt += (__popc(u.x & 0x04040404u) + __popc(u.y & 0x04040404u) +
                __popc(u.z & 0x04040404u) + __popc(u.w & 0x04040404u)) << 16;
        cnt += __popc(u.x & 0x01010101u) + __popc(u.y & 0x01010101u) +
               __popc(u.z & 0x01010101u) + __popc(u.w & 0x01010101u);
      }
    } else {
      for (int p = sub; p < w; p += 8) dst[p] = st[rr * w4 + p];
      for (int q = sub; q < nq; q += 8) {
        const uint32_t u = row[q];
        any |= u & 0x02020202u;
        cnt += (__popc(u & 0x04040404u) << 16) + __popc(u & 0x01010101u);
      }
    }
  }
#pragma unroll
  for (int k = 4; k > 0; k >>= 1) {
    any |= __shfl_xor_sync(0xffffffffu, any, k);
    cnt += __shfl_xor_sync(0xffffffffu, cnt, k);
  }
  if (live && sub == 0) {
    int* d = rowst + (((size_t)n * M + m) * h + o0 + r) * 3;
    d[0] = any != 0u;
    d[1] = (int)(cnt >> 16);
    d[2] = (int)(cnt & 0xffffu);
  }
  for (int idx = threadIdx.x; idx < M * nq; idx += CT) {
    const int cm = (idx >= nq) + (idx >= 2 * nq) + (idx >= 3 * nq), q = idx - cm * nq;
    const uint32_t* col = reinterpret_cast<const uint32_t*>(st + cm * nrows * w4) + q;
    uint32_t a = 0u;
#pragma unroll
    for (int k = 0; k < BAND; ++k)
      if (k < nrows) a |= col[k * nq];
    cw[idx] |= a & 0x02020202u;
  }
}

// Columns-any of prompt pl from its word array (reset for the prompt
// after next), by the column threads.
template <int M>
__device__ __forceinline__ void write_colany(uint32_t* cw, uint8_t* colany, size_t n, int w,
                                             int nq) {
  uint8_t* dst = colany + n * M * w;
  for (int idx = threadIdx.x; idx < M * nq; idx += CT) {
    const int m = (idx >= nq) + (idx >= 2 * nq) + (idx >= 3 * nq), q = idx - m * nq;
    const uint32_t a = cw[idx];
    cw[idx] = 0u;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (4 * q + k < w) dst[m * w + 4 * q + k] = (uint8_t)((a >> (8 * k + 1)) & 1u);
  }
}

// Warp-specialized: the four row warps stream the ring into T, band by
// band, into two T buffers; the eight column warps turn each T into
// flags and stats. T[b&1] full and empty are named barriers, so the row
// pass of band b+1 runs under the column pass of band b.
template <int M, bool S, typename E>
__global__ void __launch_bounds__(THREADS, 2)
resize_flags_kernel(const E* __restrict__ logits,              // [Np, gh*g, 16, M]
                    const float4* __restrict__ htap_g,         // [H] (k0, w0, w1, w2)
                    const float4* __restrict__ wtap_g,         // [W] (c0, w0, w1, w2)
                    uint8_t* __restrict__ flags,               // [Np, M, H, W]
                    int* __restrict__ rowst,                   // [Np, M, H, 3]
                    uint8_t* __restrict__ colany,              // [Np, M, W]
                    int np_, int gh, int g, int h, int w, float t_lo, float t_mid, float t_hi) {
  extern __shared__ __align__(128) uint8_t smem[];
  const Layout L = layout(M, w, h, (int)sizeof(E));
  const uint8_t* ring = smem;
  const uint32_t ring_s = smem_u32(smem);
  const uint32_t bar0 = smem_u32(smem + L.bar);
  const int tid = threadIdx.x, nq = L.w4 >> 2;
  const int kmax = 4 * gh - TAPS;
  // the double buffers, by band parity (T, staging) and prompt parity (cw)
  float* const t0 = reinterpret_cast<float*>(smem + L.t);
  float* const t1 = t0 + L.band * M * C;
  uint8_t* const s0 = smem + L.stage;
  uint8_t* const s1 = s0 + L.band * M * L.w4;
  uint32_t* const cw0 = reinterpret_cast<uint32_t*>(smem + L.cw);
  uint32_t* const cw1 = cw0 + M * nq;
  // The CTA's grid rows in order: prompt pl's rows i0..gh-1 are sequence
  // numbers pl·R .. pl·R + R - 1 (rows above the first tap are never read).
  const int i0 = first_tap<false>(htap_g, 0, kmax) >> 2;
  const int R = gh - i0;
  const int n_prompts = (np_ - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int total = n_prompts * R;

  if (tid == 0) {
    for (int s = 0; s < NSLOT; ++s) mbar_init(bar0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < 2 * M * nq; i += THREADS) cw0[i] = 0u;
  // the tap tables: a shared memory copy with int first taps where they
  // fit (S), else the wrapper's tables in device memory
  float4* const tab = reinterpret_cast<float4*>(smem + L.tab);
  const float4* const htap = S ? tab : htap_g;
  const float4* const wtap = S ? tab + h : wtap_g;
  if (S) {
    for (int i = tid; i < h + w; i += THREADS) {
      float4 t = i < h ? htap_g[i] : wtap_g[i - h];
      t.x = __int_as_float(tap_index<false>(t.x, i < h ? kmax : 4 * g - TAPS));
      tab[i] = t;
    }
  }
  __syncthreads();
  const Band first = next_band<S>(Band{-1, h, h, 0, 0}, htap, h, L.band, kmax);
  int bands = 0;                                  // bands a prompt
  for (Band q = first; q.pl == 0; q = next_band<S>(q, htap, h, L.band, kmax)) ++bands;
  const int n_bands = bands * n_prompts;

  if (tid >= CT) {                                // the row warps
    const int run = tid - CT;
    int issued = 0;                               // thread CT's count
    Band bd = first;
    for (int b = 0; b < n_bands; ++b) {
      named_sync(BAR_R, RT);                      // every row thread has left band b-1
      if (run == 0)                               // so rows above band b are free
        issue_until<M, E>(issued, bd.pl * R + bd.i_lo - i0 + NSLOT, total, R, i0, gh, g, logits,
                       ring_s, bar0);
      if (b >= 2) named_sync(BAR_EMPTY + (b & 1), THREADS);
      wait_rows(bd, R, i0, bar0);
      row_pass<M, S, E>(ring, b & 1 ? t1 : t0, htap, bd.o0, bd.o1 - bd.o0, bd.pl * R, i0, kmax, g,
                     run);
      named_arrive(BAR_FULL + (b & 1), THREADS);
      bd = next_band<S>(bd, htap, h, L.band, kmax);
    }
    return;
  }
  // the column warps
  Band bd = first;
  int due = -1;                                   // the prompt whose columns-any is due
  for (int b = 0; b < n_bands; ++b) {
    const int rows = M * (bd.o1 - bd.o0);
    const ColShare cs = col_share(wtap, rows, w, L.w4);
    named_sync(BAR_FULL + (b & 1), THREADS);
    if (due >= 0) {                               // every column thread has left its last band
      write_colany<M>(due & 1 ? cw1 : cw0, colany, blockIdx.x + (size_t)due * gridDim.x, w, nq);
      due = -1;
    }
    column_pass<S>(b & 1 ? t1 : t0, b & 1 ? s1 : s0, wtap, cs, rows, w, L.w4, 4 * g - TAPS,
                   t_lo, t_mid, t_hi);
    if (b + 2 < n_bands) named_arrive(BAR_EMPTY + (b & 1), THREADS);
    named_sync(BAR_C, CT);
    band_out<M>(b & 1 ? s1 : s0, bd.pl & 1 ? cw1 : cw0, flags, rowst,
                blockIdx.x + bd.pl * gridDim.x, bd.o0, bd.o1 - bd.o0, h, w, L.w4);
    if (bd.o1 == h) due = bd.pl;
    bd = next_band<S>(bd, htap, h, L.band, kmax);
  }
  named_sync(BAR_C, CT);
  if (due >= 0)
    write_colany<M>(due & 1 ? cw1 : cw0, colany, blockIdx.x + (size_t)due * gridDim.x, w, nq);
}

template <int M, bool S, typename E>
int launch_as(const void* logits, const void* htap, const void* wtap, void* flags, void* rowst,
              void* colany, int np_, int gh, int g, int h, int w, float t_lo, float t_mid,
              float t_hi, int n_sm, cudaStream_t stream) {
  auto kernel = resize_flags_kernel<M, S, E>;
  const Layout L = layout(M, w, h, (int)sizeof(E));
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, L.total);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long ctas = (long long)n_sm * per_sm;
  const int grid = (int)(np_ < ctas ? np_ : ctas);
  kernel<<<grid, THREADS, L.total, stream>>>(
      static_cast<const E*>(logits), static_cast<const float4*>(htap),
      static_cast<const float4*>(wtap), static_cast<uint8_t*>(flags), static_cast<int*>(rowst),
      static_cast<uint8_t*>(colany), np_, gh, g, h, w, t_lo, t_mid, t_hi);
  return (int)cudaGetLastError();
}

// The tables go to shared memory where they fit TABLE_BUDGET.
template <int M, typename E>
int launch(const void* logits, const void* htap, const void* wtap, void* flags, void* rowst,
           void* colany, int np_, int gh, int g, int h, int w, float t_lo, float t_mid,
           float t_hi, int n_sm, cudaStream_t stream) {
  const Layout L = layout(M, w, h, (int)sizeof(E));
  if (L.total > L.tab)
    return launch_as<M, true, E>(logits, htap, wtap, flags, rowst, colany, np_, gh, g, h, w,
                                 t_lo, t_mid, t_hi, n_sm, stream);
  return launch_as<M, false, E>(logits, htap, wtap, flags, rowst, colany, np_, gh, g, h, w,
                                t_lo, t_mid, t_hi, n_sm, stream);
}

template <typename E>
int dispatch(const void* logits, const void* h_taps, const void* w_taps, void* flags,
             void* rowst, void* colany, int np_, int gh, int g, int n_masks, int h, int w,
             float t_lo, float t_mid, float t_hi, int n_sm, cudaStream_t s) {
  if (np_ < 1 || g < 1 || g > G || gh < 1 || gh > g || h < 1 || w < 1 || w > MAX_W ||
      n_sm < 1 || (long long)np_ * gh > (1ll << 30))
    return (int)cudaErrorInvalidValue;
  switch (n_masks) {
    case 1:
      return launch<1, E>(logits, h_taps, w_taps, flags, rowst, colany, np_, gh, g, h, w, t_lo,
                          t_mid, t_hi, n_sm, s);
    case 2:
      return launch<2, E>(logits, h_taps, w_taps, flags, rowst, colany, np_, gh, g, h, w, t_lo,
                          t_mid, t_hi, n_sm, s);
    case 3:
      return launch<3, E>(logits, h_taps, w_taps, flags, rowst, colany, np_, gh, g, h, w, t_lo,
                          t_mid, t_hi, n_sm, s);
    case 4:
      return launch<4, E>(logits, h_taps, w_taps, flags, rowst, colany, np_, gh, g, h, w, t_lo,
                          t_mid, t_hi, n_sm, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace rat_k4

// logits [Np, gh·g, 16, M] bf16; h_taps [H, 4], w_taps [W, 4] f32 tap
// tables; thresholds thr−off, thr, thr+off; n_sm the card's SM count.
extern "C" int rat_resize_flags(const void* logits, const void* h_taps, const void* w_taps,
                                void* flags, void* rowst, void* colany, int np_, int gh, int g,
                                int n_masks, int h, int w, float t_lo, float t_mid, float t_hi,
                                int n_sm, void* stream) {
  return rat_k4::dispatch<__nv_bfloat16>(logits, h_taps, w_taps, flags, rowst, colany, np_, gh,
                                         g, n_masks, h, w, t_lo, t_mid, t_hi, n_sm,
                                         static_cast<cudaStream_t>(stream));
}

// The same on f32 logits (the taps unrounded f32).
extern "C" int rat_resize_flags_f32(const void* logits, const void* h_taps, const void* w_taps,
                                    void* flags, void* rowst, void* colany, int np_, int gh,
                                    int g, int n_masks, int h, int w, float t_lo, float t_mid,
                                    float t_hi, int n_sm, void* stream) {
  return rat_k4::dispatch<float>(logits, h_taps, w_taps, flags, rowst, colany, np_, gh, g,
                                 n_masks, h, w, t_lo, t_mid, t_hi, n_sm,
                                 static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory of a CTA in bytes, bf16 and f32 logits.
extern "C" int rat_resize_flags_smem(int n_masks, int w, int h) {
  return rat_k4::layout(n_masks, w, h, 2).total;
}
extern "C" int rat_resize_flags_f32_smem(int n_masks, int w, int h) {
  return rat_k4::layout(n_masks, w, h, 4).total;
}

// CTAs an SM (occupancy at that shared memory), 0 on an error.
extern "C" int rat_resize_flags_ctas(int n_masks, int w, int h) {
  using namespace rat_k4;
  using E = __nv_bfloat16;
  const Layout L = layout(n_masks, w, h, 2);
  int per_sm = 0;
  auto query = [&](auto kernel) {
    if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total) ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, L.total))
      per_sm = 0;
  };
  const bool s = L.total > L.tab;
  switch (n_masks) {
    case 1: s ? query(resize_flags_kernel<1, true, E>) : query(resize_flags_kernel<1, false, E>); break;
    case 2: s ? query(resize_flags_kernel<2, true, E>) : query(resize_flags_kernel<2, false, E>); break;
    case 3: s ? query(resize_flags_kernel<3, true, E>) : query(resize_flags_kernel<3, false, E>); break;
    case 4: s ? query(resize_flags_kernel<4, true, E>) : query(resize_flags_kernel<4, false, E>); break;
  }
  return per_sm;
}
