"""Time source-level variants of the window attention kernel (B11) on the
card, to see where its time goes: each variant is ``win_attention.cu``
with a few lines replaced (some no longer compute the right answer: they
remove one part of the work to show what it costs), built by its own
nvcc into ``build/torch_kernels/variants/`` and timed at the SAM ViT-H
shape beside ``scaled_dot_product_attention``.

    python -m revisit_anything_tpu_torch.kernels.winattn_variants

Times are CUDA-event medians of 11 calls, each queued behind a device
sleep (as ``chip_smoke.py`` times kernels). Needs a CUDA device and
nvcc; prints one line per shape.
"""

from __future__ import annotations

import ctypes
import math
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
             [("constexpr int TK = 32;", "constexpr int TK = 64;")]),
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


def _source(reps) -> str:
    text = _SRC.read_text()
    for old, new in reps:
        if old not in text:
            raise ValueError(f"variant patch does not apply: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def _build_all() -> dict:
    _OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (_, reps) in VARIANTS.items():
        cu = _OUT / f"{name}.cu"
        cu.write_text(_source(reps))
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o",
             str(_OUT / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        fn = ctypes.CDLL(str(_OUT / f"{name}.so")).rat_win_attention
        fn.argtypes = list(build.SIGNATURES["rat_win_attention"])
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def _time_ms(fn, reps: int = 11) -> float:
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


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("winattn_variants: needs a CUDA device")
    dev = torch.device("cuda")
    fns = _build_all()
    for name, (what, _) in VARIANTS.items():
        print(f"[variant] {name}: {what}", flush=True)
    g = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for b, side, heads, hd in SHAPES:
        n, d = side * side, heads * hd
        qkv = torch.randn((b, n, 3 * d), generator=g, device=dev).bfloat16()
        bh, bw = (torch.randn((b, n, heads * side), generator=g,
                              device=dev).bfloat16() for _ in range(2))
        want = wa.windowed_attend_reference(qkv, bh, bw, heads, side).float()
        out = torch.empty((b, n, d), dtype=torch.bfloat16, device=dev)
        parts = []
        for name, fn in fns.items():
            def call(fn=fn):
                err = fn(qkv.data_ptr(), bh.data_ptr(), bw.data_ptr(),
                         out.data_ptr(), b, n, side, heads, hd,
                         1.0 / math.sqrt(hd), stream)
                if err:
                    raise RuntimeError(f"launch failed: cudaError {err}")
            ms = _time_ms(call)
            rel = ((out.float() - want).abs().max() / want.abs().max()).item()
            parts.append(f"{name} {ms * 1e3:.1f} us (rel_err {rel:.1e})")
        q, k, v = (qkv[..., i * d:(i + 1) * d].reshape(b, n, heads, hd)
                   .transpose(1, 2).contiguous() for i in range(3))
        mask = (bh.float().reshape(b, n, heads, side).transpose(1, 2)
                .repeat_interleave(side, -1)
                + bw.float().reshape(b, n, heads, side).transpose(1, 2)
                .repeat(1, 1, 1, side)).bfloat16()
        sdpa = _time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask))
        print(f"[variants] qkv [{b},{n},{3 * d}] heads {heads}: "
              f"{'; '.join(parts)}; sdpa {sdpa * 1e3:.1f} us", flush=True)


if __name__ == "__main__":
    main()
