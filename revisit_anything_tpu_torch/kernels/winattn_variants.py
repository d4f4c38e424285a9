"""Time source-level variants of the window attention kernel (B11) on the
card, to see where its time goes: each variant is ``win_attention.cu``
with a few lines replaced (some no longer compute the right answer: they
remove one part of the work to show what it costs), built by its own
nvcc into ``build/torch_kernels/variants/`` and timed at the SAM ViT-H
shape beside ``scaled_dot_product_attention``.

    python -m revisit_anything_tpu_torch.kernels.winattn_variants
    python -m revisit_anything_tpu_torch.kernels.winattn_variants --f32

With ``--f32`` the variants are of B11's f32 form
(``rat_win_attention_f32``: split-TF32 products over a ring of split K|V
tiles; the split, the bias, each product removed in turn, and other row
groupings), held to the plain version in f32 with TF32 off.

Times are CUDA-event medians of 11 calls, each queued behind a device
sleep (as ``chip_smoke.py`` times kernels). Needs a CUDA device and
nvcc; prints one line per shape.
"""

from __future__ import annotations

import ctypes
import math
import re
import statistics
import subprocess
import sys

import torch
import torch.nn.functional as F

from revisit_anything_tpu_torch.kernels import build
from revisit_anything_tpu_torch.ops import winattn as wa

_SRC = build._CSRC / "win_attention.cu"
_OUT = build._BUILD_ROOT / "variants"

_QK = """              mma16816(s[2 * jj], qa[kk], bk[0], bk[1]);
              mma16816(s[2 * jj + 1], qa[kk], bk[2], bk[3]);"""
_BIAS = """              mma16816(sb[0], ab[ke], be[0], be[1]);
              mma16816(sb[1], ab[ke], be[2], be[3]);"""
_PV = """              mma16816(o[2 * jj], pa, bv[0], bv[1]);
              mma16816(o[2 * jj + 1], pa, bv[2], bv[3]);"""
_EXP = "s[j][e] = ex2(s[j][e] - m_new[e / 2]);"
_NO_QK = ("s[2 * jj][0] += __uint_as_float(bk[0]); "
          "s[2 * jj + 1][0] += __uint_as_float(bk[2]);")
_NO_BIAS = ("sb[0][0] += __uint_as_float(be[0]); "
            "sb[1][0] += __uint_as_float(be[2]);")
_NO_PV = ("o[2 * jj][0] += __uint_as_float(bv[0] ^ pa[0]); "
          "o[2 * jj + 1][0] += __uint_as_float(bv[2]);")
_ENTRY = "  extern __shared__ __align__(16) unsigned char smem[];"

# name -> (what it shows, [(old text, new text), ...])
VARIANTS = {
    "kernel": ("the kernel as built", []),
    "tk64": ("64-key tiles (32 in the kernel)",
             [("constexpr int TK = 32;                       // keys a tile\n",
               "constexpr int TK = 64;                       // keys a tile\n")]),
    "round0": ("only the first round of row tiles computes",
               [("    const bool active = row0 < npad;",
                 "    const bool active = row0 < npad && round == 0;")]),
    "nofrag": ("Q and bias fragments not loaded from device memory",
               [("qa[kk][0] = ld_u32(q0 + kk * 16, v0);",
                 "qa[kk][0] = lane * 77u + kk;"),
                ("qa[kk][1] = ld_u32(q1 + kk * 16, v1);",
                 "qa[kk][1] = lane * 7u;"),
                ("qa[kk][2] = ld_u32(q0 + kk * 16 + 8, v0);",
                 "qa[kk][2] = lane * 5u + kk;"),
                ("qa[kk][3] = ld_u32(q1 + kk * 16 + 8, v1);",
                 "qa[kk][3] = lane;"),
                ("ab[ke][q] = bias_at(row, col) | "
                 "(bias_at(row, col + 1) << 16);",
                 "ab[ke][q] = lane * (q + 1) + ke;")]),
    "nomath": ("no mma and no exponential (loads, ldmatrix, softmax "
               "bookkeeping, stores only)",
               [(_QK, _NO_QK), (_BIAS, _NO_BIAS), (_PV, _NO_PV),
                (_EXP, "s[j][e] = s[j][e] - m_new[e / 2];")]),
    "empty": ("returns at entry (launch cost)",
              [(_ENTRY, "  if (n > 0) return;\n" + _ENTRY)]),
}

# SAM ViT-H's windowed layer, 8 of its windows (one CTA an SM), one
# (window, head) alone, and the widest window (K|V streamed)
SHAPES = ((25, 14, 16, 80), (8, 14, 16, 80), (1, 14, 1, 80),
          (2, 31, 16, 80))

# B11 f32 (rat_win_attention_f32): its products, bias, tile split and row
# grouping
_F32_QK = """          mma_m16n8k8_tf32(sc[j], ql[ks], __float_as_uint(kh2.x), __float_as_uint(kh2.y));
          mma_m16n8k8_tf32(sc[j], qh[ks], __float_as_uint(kl2.x), __float_as_uint(kl2.y));
          mma_m16n8k8_tf32(sm[j], qh[ks], __float_as_uint(kh2.x), __float_as_uint(kh2.y));"""
_F32_PV = """          mma_m16n8k8_tf32(ot[nb], pl, vh0, vh1);
          mma_m16n8k8_tf32(ot[nb], ph, vl0, vl1);
          mma_m16n8k8_tf32(ot[nb], ph, vh0, vh1);"""
_F32_JOIN = "o[nb][e] = fmaf(o[nb][e], alpha[e / 2], ot[nb][e]);"
_F32_OT = """    float ot[KS][4];
#pragma unroll
    for (int nb = 0; nb < KS; ++nb) ot[nb][0] = ot[nb][1] = ot[nb][2] = ot[nb][3] = 0.f;"""
_F32_WARPS = "constexpr int MAX_WARPS = 4;"
_F32_BOUNDS = ("__launch_bounds__(MAX_WARPS * 32, 2)\n"
               "win_attention_tf32x3_kernel(")
_F32_ENTRY = "  extern __shared__ __align__(16) float smw[];"

F32_VARIANTS = {
    "kernel": ("the kernel as built", []),
    "w5": ("CTAs of up to 5 warps (10 warps an SM, up to 168 registers)",
           [(_F32_WARPS, "constexpr int MAX_WARPS = 5;")]),
    "w7": ("CTAs of up to 7 warps, one an SM (up to 255 registers)",
           [(_F32_WARPS, "constexpr int MAX_WARPS = 7;"),
            (_F32_BOUNDS, _F32_BOUNDS.replace(", 2)", ", 1)"))]),
    "unroll": ("the tile copy and split loops unrolled by 4",
               [("      for (int i = threadIdx.x; i < 2 * TK * CPR; "
                 "i += blockDim.x) {",
                 "#pragma unroll 4\n      for (int i = threadIdx.x; "
                 "i < 2 * TK * CPR; i += blockDim.x) {"),
                ("    for (int i = threadIdx.x; i < 2 * TK * CPR; "
                 "i += blockDim.x) {\n      float* x",
                 "#pragma unroll 4\n    for (int i = threadIdx.x; "
                 "i < 2 * TK * CPR; i += blockDim.x) {\n      float* x")]),
    "direct": ("P·V into O itself after its rescale (no fresh accumulator "
               "a tile: fewer registers, O's sum truncated by mma.sync)",
               [(_F32_OT, "    float (&ot)[KS][4] = o;\n"
                          "#pragma unroll\n    for (int nb = 0; nb < KS; "
                          "++nb)\n#pragma unroll\n      for (int e = 0; e < 4; "
                          "++e) o[nb][e] *= alpha[e / 2];"),
                (_F32_JOIN, "(void)0;")]),
    "noq": ("Q's fragments not loaded from device memory",
            [("const float2 x0 = v0 ? *reinterpret_cast<const float2*>(q0 + "
              "8 * ks) : make_float2(0.f, 0.f);",
              "const float2 x0 = make_float2(lane * 0.1f, ks * 0.2f);"),
             ("const float2 x1 = v1 ? *reinterpret_cast<const float2*>(q1 + "
              "8 * ks) : make_float2(0.f, 0.f);",
              "const float2 x1 = make_float2(ks * 0.3f, lane * 0.2f);")]),
    "nobias": ("the bias read as zero (no bias loads)",
               [("(brow[r][ch] + brow[r][cw]) * LOG2E", "0.f")]),
    "nostage": ("the bias rows not staged (shared memory read as it is)",
                [("      cp_async4(mine + r * bpitch + col, src, valid);\n",
                  "")]),
    "nosplit": ("K|V tiles not split (the lo planes unwritten)",
                [("    split_tile(t);\n", "")]),
    "noqk": ("no Q·Kᵀ products (K's fragments still loaded)",
             [(_F32_QK, "          sc[j][0] += kh2.x + kl2.y;")]),
    "nopv": ("no P·V products (V's fragments still loaded)",
             [(_F32_PV, "          ot[nb][0] += __uint_as_float(vh0 ^ vl1) + "
                        "__uint_as_float(vh1 ^ vl0);")]),
    "empty": ("returns at entry (launch cost)",
              [(_F32_ENTRY, _F32_ENTRY + "\n  if (n > 0) return;")]),
}

# SAM ViT-H's windowed layer, the same at head dim 64 (ViT-B/L), one
# (window, head) alone, and the widest window
F32_SHAPES = ((25, 14, 16, 80), (25, 14, 16, 64), (1, 14, 1, 80),
              (2, 31, 16, 80))


def _source(reps) -> str:
    text = _SRC.read_text()
    for old, new in reps:
        if old not in text:
            raise ValueError(f"variant patch does not apply: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def _build_all(variants=VARIANTS, entry="rat_win_attention",
               tag="win") -> dict:
    """Each variant by its own nvcc, all started together: {name: its
    entry point}; ptxas's lines of each kernel are in <tag>_<name>.log."""
    _OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (_, reps) in variants.items():
        cu = _OUT / f"{tag}_{name}.cu"
        cu.write_text(_source(reps))
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build._CSRC),
             "-shared", "-o", str(_OUT / f"{tag}_{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        (_OUT / f"{tag}_{name}.log").write_text(log)
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        fn = getattr(ctypes.CDLL(str(_OUT / f"{tag}_{name}.so")), entry)
        fn.argtypes = list(build.SIGNATURES[entry])
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def time_ms(fn, reps: int = 11) -> float:
    """Median device time of ``fn`` in ms over ``reps`` calls between CUDA
    events, each queued behind a device sleep (after 3 warm-up calls)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _registers(tag: str, name: str) -> str:
    """The f32 kernel's registers and spills from the variant's ptxas
    lines."""
    log = (_OUT / f"{tag}_{name}.log").read_text()
    block = log.split("win_attention_tf32x3_kernelILi80E", 1)[-1]
    regs = re.search(r"Used (\d+) registers", block)
    spill = re.search(r"(\d+) bytes spill stores", block)
    return (f"{regs.group(1) if regs else '?'} registers, spill "
            f"{spill.group(1) if spill else '?'} B")


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("winattn_variants: needs a CUDA device")
    dev = torch.device("cuda")
    f32 = "--f32" in sys.argv[1:]
    dtype = torch.float32 if f32 else torch.bfloat16
    table, shapes = (F32_VARIANTS, F32_SHAPES) if f32 else (VARIANTS, SHAPES)
    fns = (_build_all(F32_VARIANTS, "rat_win_attention_f32", "winf32") if f32
           else _build_all())
    torch.backends.cuda.matmul.allow_tf32 = False
    for name, (what, _) in table.items():
        regs = f" (hd 80: {_registers('winf32', name)})" if f32 else ""
        print(f"[variant] {'B11 f32 ' if f32 else ''}{name}: {what}{regs}",
              flush=True)
    g = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for b, side, heads, hd in shapes:
        n, d = side * side, heads * hd
        qkv = torch.randn((b, n, 3 * d), generator=g, device=dev).to(dtype)
        bh, bw = (torch.randn((b, n, heads * side), generator=g,
                              device=dev).to(dtype) for _ in range(2))
        want = wa.windowed_attend_reference(qkv, bh, bw, heads, side).float()
        out = torch.empty((b, n, d), dtype=dtype, device=dev)
        parts = []
        for name, fn in fns.items():
            def call(fn=fn):
                err = fn(qkv.data_ptr(), bh.data_ptr(), bw.data_ptr(),
                         out.data_ptr(), b, n, side, heads, hd,
                         1.0 / math.sqrt(hd), stream)
                if err:
                    raise RuntimeError(f"launch failed: cudaError {err}")
            ms = time_ms(call)
            rel = ((out.float() - want).abs().max() / want.abs().max()).item()
            parts.append(f"{name} {ms * 1e3:.1f} us (rel_err {rel:.1e})")
        q, k, v = (qkv[..., i * d:(i + 1) * d].reshape(b, n, heads, hd)
                   .transpose(1, 2).contiguous() for i in range(3))
        mask = (bh.float().reshape(b, n, heads, side).transpose(1, 2)
                .repeat_interleave(side, -1)
                + bw.float().reshape(b, n, heads, side).transpose(1, 2)
                .repeat(1, 1, 1, side)).to(dtype)
        sdpa = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask))
        print(f"[variants] qkv [{b},{n},{3 * d}] heads {heads}: "
              f"{'; '.join(parts)}; sdpa {sdpa * 1e3:.1f} us", flush=True)


if __name__ == "__main__":
    main()
