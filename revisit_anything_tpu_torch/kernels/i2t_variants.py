"""Time source-level variants of the fused image→token update (K5) on the
card, to see whether the products, the attention, the LayerNorm epilogue,
the weight ring or the bytes set its pace: each variant is
``i2t_update.cu`` with a few lines replaced (all but the first no longer
compute the right answer: they remove one part of the work to show what it
costs), built by its own nvcc into ``build/torch_kernels/variants/`` and
timed at both serving shapes (layer 1: the shared branch, layer 2: per
prompt) and on one work unit alone.

    python -m revisit_anything_tpu_torch.kernels.i2t_variants
    python -m revisit_anything_tpu_torch.kernels.i2t_variants --f32

With ``--f32`` the variants are of K5's f32 form (``rat_i2t_update_f32``:
split-TF32 products, loads, stores, the attention and the weight ring, on
f32 operands).

Times are CUDA-event medians of 11 calls, each queued behind a device
sleep (as ``chip_smoke.py`` times kernels), with the SM clock and board
power nvidia-smi reads while the variant runs back to back. Needs a CUDA
device and nvcc; prints one line per variant and shape.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

from revisit_anything_tpu_torch.kernels import build
from revisit_anything_tpu_torch.kernels.maskhead_variants import _clock
from revisit_anything_tpu_torch.kernels.winattn_variants import time_ms
from revisit_anything_tpu_torch.ops import attention as att

_SRC = build._CSRC / "i2t_update.cu"
_OUT = build._BUILD_ROOT / "variants"

# the attention block's head, skipped: a = q
_ATT = ("    uint32_t af[8][4];                            "
        "// a as the out-projection's A fragments\n    {")
_NO_ATT = ("    uint32_t af[8][4];\n"
           "    for (int h = 0; h < 8; ++h)\n"
           "      for (int k = 0; k < 4; ++k) af[h][k] = qf[h][k];\n"
           "    if (0) {")
# the normalized row: keys = y
_LN = ("pack_bf16(fmaf(fmaf(y.x, rs, sh), sc.x, bi.x), "
       "fmaf(fmaf(y.y, rs, sh), sc.y, bi.y));")
_NO_LN = "yp[i][rr];"
# a product replaced by an empty asm that leaves the accumulators opaque
_KV0 = "      issue_rs(acc, kp[0], stage(s), true);"
_KV1 = "      issue_rs(acc, kp[1], stage(s + 1), false);"
_NO_KV0 = "      fence_regs(acc);"
_NO_KV1 = "      fence_regs(acc);"
_MMA_Q = ("    wgmma_ss_n128_mn(acc, da, gmma_desc(st + kk * 2048, BOX_W, 1024), "
          "kq > 0 || kk > 0);")
_MMA_RS = ("    wgmma_rs_n128_mn(acc, a[kk], gmma_desc(st + kk * 2048, BOX_W, 1024), "
           "!first || kk > 0);")
_NO_MMA_Q = "    fence_regs(acc);"
_NO_MMA_RS = "    fence_regs(acc);"
# the ring filled once and never refilled: the products read whatever the
# first three stages hold
_WAIT_STAGE = "mbar_wait(full(s % SLOTS), (s / SLOTS) & 1);"
_REFILL = "next_stage(s + SLOTS, second);"
_ENTRY = "  extern __shared__ uint8_t smem_raw[];"
# both stages of a product pair waited for before the first is issued
_PAIR_Q = ("      wait_stage(s);\n      issue_q(acc, sx, stage(s), 0);\n"
           "      wait_stage(s + 1);\n")
_PAIR_KV = ("      wait_stage(s);\n      issue_rs(acc, kp[0], stage(s), true);\n"
            "      wait_stage(s + 1);\n")
# the softmax's exponentials and divisions (p = shifted scores)
_EXP0 = "sc[h][2 * rr] = ex2(sc[h][2 * rr] - mx[h][rr]);"
_EXP1 = "sc[h][2 * rr + 1] = ex2(sc[h][2 * rr + 1] - mx[h][rr]);"
_DIV = "__device__ __forceinline__ float divide(float x, float z, float r) {"

# name -> (what it shows, [(old text, new text), ...])
VARIANTS = {
    "kernel": ("the kernel as built", []),
    "noattention": ("no attention (a = q)", [(_ATT, _NO_ATT)]),
    "nosoftmax": ("no exponentials or divisions in the softmax",
                  [(_EXP0, "sc[h][2 * rr] -= mx[h][rr];"),
                   (_EXP1, "sc[h][2 * rr + 1] -= mx[h][rr];"),
                   (_DIV, _DIV + "\n  return x * z;")]),
    "pairwait": ("both stages of a two-stage product waited for before its "
                 "first issue",
                 [(_PAIR_Q, "      wait_stage(s);\n      wait_stage(s + 1);\n"
                   "      issue_q(acc, sx, stage(s), 0);\n"),
                  (_PAIR_KV, "      wait_stage(s);\n      wait_stage(s + 1);\n"
                   "      issue_rs(acc, kp[0], stage(s), true);\n")]),
    "nolayernorm": ("no LayerNorm epilogue (keys = y)", [(_LN, _NO_LN)]),
    "nokv": ("no k|v product (accumulators left opaque)",
             [(_KV0, _NO_KV0), (_KV1, _NO_KV1)]),
    "resident": ("the weight ring filled once and never refilled (no L2 "
                 "weight reads after the first three stages)",
                 [(_WAIT_STAGE, "mbar_wait(full(s % SLOTS), 0);"),
                  (_REFILL, "next_stage(s + SLOTS, false);")]),
    "loadstore": ("x tiles, the weight ring, keys and kvT stores only (no "
                  "products, attention or LayerNorm)",
                  [(_ATT, _NO_ATT), (_LN, _NO_LN), (_MMA_Q, _NO_MMA_Q),
                   (_MMA_RS, _NO_MMA_RS)]),
    "empty": ("returns at entry (launch cost)",
              [(_ENTRY, "  if (m > 0) return;\n" + _ENTRY)]),
}

# K5 f32 (rat_i2t_update_f32): the 8-byte loads of the products' A
# operands (x for q, the normalized row read back), the keys stores, the
# kvT TMA stores, the weight ring's refills and the attention, each removed
_F32_LOAD_A = ("const float2 a = live ? *reinterpret_cast<const float2*>(p0 + col)",
               "const float2 a = false ? *reinterpret_cast<const float2*>(p0 + col)")
_F32_LOAD_B = ("const float2 b = live ? *reinterpret_cast<const float2*>(p8 + col)",
               "const float2 b = false ? *reinterpret_cast<const float2*>(p8 + col)")
_F32_KEYS = [
    ("            if (live) *reinterpret_cast<float2*>(krow + 8 * rr * D + col) =",
     "            if (m < 0) *reinterpret_cast<float2*>(krow + 8 * rr * D + col) ="),
    ("    if (live)\n#pragma unroll\n      for (int i = 0; i < 16; ++i)",
     "    if (m < 0)\n#pragma unroll\n      for (int i = 0; i < 16; ++i)"),
    ("          if (live)\n#pragma unroll\n            for (int kk = 0; kk < 4; ++kk)",
     "          if (m < 0)\n#pragma unroll\n            for (int kk = 0; kk < 4; ++kk)")]
_F32_KVT = ("        tma_store_3d(&tkvt, stg_u32, p0, 128 * j, pb);\n"
            "        tma_store_3d(&tkvt, stg_u32 + 16384, p0 + 32, 128 * j, pb);\n", "")
_F32_RESIDENT = [
    ("auto stage_wait = [&](int st) { mbar_wait(full(st % SLOTS), (st / SLOTS) & 1); };",
     "auto stage_wait = [&](int st) { if (st < SLOTS) mbar_wait(full(st % SLOTS), 0); };"),
    ("      fill(st + SLOTS, second);", "      fill(st + SLOTS, false);")]
_F32_ATT = ("      for (int h = 0; h < H; ++h) {\n        uint32_t qhi[2][4]",
            "      for (int i = 0; i < 64; ++i) a[i] = qv[i];\n"
            "      for (int h = 0; h < 0; ++h) {\n        uint32_t qhi[2][4]")
_F32_ENTRY = "  extern __shared__ uint8_t smem_f32[];"

F32_VARIANTS = {
    "kernel": ("the kernel as built", []),
    "noload": ("the products' A operands from device memory read as zeros "
               "(x for q, the normalized row read back)",
               [_F32_LOAD_A, _F32_LOAD_B]),
    "nokeys": ("no keys stores (half 0 of y, the keys)", _F32_KEYS),
    "nokvt": ("no kvT TMA stores", [_F32_KVT]),
    "resident": ("the weight ring filled once and never refilled",
                 _F32_RESIDENT),
    "noattention": ("no attention (a = q)", [_F32_ATT]),
    "productsonly": ("the products alone: weights resident, no attention, "
                     "no A loads, no keys stores",
                     [_F32_LOAD_A, _F32_LOAD_B, *_F32_KEYS, *_F32_RESIDENT,
                      _F32_ATT]),
    "empty": ("the weight split, then the update returns at entry",
              [(_F32_ENTRY, "  if (m > 0) return;\n" + _F32_ENTRY)]),
}

# (prompts, image leading dim, positions): layer 1 (the shared branch),
# layer 2 (per prompt), one 128-position unit alone
SHAPES = ((1024, 1, 4096), (1024, 1024, 4096), (1, 1, 128))


def _source(reps) -> str:
    text = _SRC.read_text()
    for old, new in reps:
        if old not in text:
            raise ValueError(f"variant patch does not apply: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def _build_all(variants=VARIANTS, entry="rat_i2t_update") -> dict:
    _OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (_, reps) in variants.items():
        cu = _OUT / f"{entry}_{name}.cu"
        cu.write_text(_source(reps))
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build._CSRC),
             "-shared", "-o", str(_OUT / f"{entry}_{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        fn = getattr(ctypes.CDLL(str(_OUT / f"{entry}_{name}.so")), entry)
        fn.argtypes = list(build.SIGNATURES[entry])
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("i2t_variants: needs a CUDA device")
    dev = torch.device("cuda")
    f32 = "--f32" in sys.argv[1:]
    variants = F32_VARIANTS if f32 else VARIANTS
    fns = _build_all(variants, "rat_i2t_update_f32" if f32 else "rat_i2t_update")
    for name, (what, _) in variants.items():
        print(f"[variant] {name}: {what}", flush=True)
    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.float32 if f32 else torch.bfloat16
    torch.backends.cuda.matmul.allow_tf32 = False
    scratch = (torch.empty(att.i2t_f32_scratch(dev), device=dev) if f32
               else None)

    def rnd(*shape, s=1.0, off=0.0):
        return (torch.randn(shape, generator=g, device=dev) * s + off).to(bf)

    stream = torch.cuda.current_stream().cuda_stream
    for b, lead, m in SHAPES:
        args = (rnd(lead, m, 256), rnd(1, m, 128), rnd(b, 7, 128),
                rnd(b, 7, 128), rnd(256, 128, s=0.1), rnd(128, s=0.1),
                rnd(128, 256, s=0.1), rnd(256, s=0.1),
                rnd(256, s=0.1, off=1.0), rnd(256, s=0.1),
                rnd(256, 256, s=0.1))
        # the plain version on the first 64 prompts at most (it carries
        # f32 [B, M, 256] intermediates)
        c = min(b, 64)
        want = att.i2t_update_reference(
            args[0] if lead == 1 else args[0][:c], args[1], args[2][:c],
            args[3][:c], *args[4:], 8, 1e-6)
        keys = torch.empty((b, m, 256), dtype=bf, device=dev)
        kvt = torch.empty((b, 256, m), dtype=bf, device=dev)
        for name, fn in fns.items():
            keys.zero_()
            kvt.zero_()

            def call(fn=fn):
                extra = (scratch.data_ptr(),) if f32 else ()
                err = fn(*(a.data_ptr() for a in args), keys.data_ptr(),
                         kvt.data_ptr(), *extra, b, m, int(lead == 1), 1e-6,
                         stream)
                if err:
                    raise RuntimeError(f"launch failed: cudaError {err}")
            ms = time_ms(call)
            rel = max(((o[:c].float() - w.float()).abs().max()
                       / w.float().abs().max()).item()
                      for o, w in zip((keys, kvt), want))
            clock = _clock(call) if b > 1 else ""
            print(f"[variants] img [{lead},{m},256] {b} prompts: {name} "
                  f"{ms * 1e3:.1f} us (rel_err {rel:.1e}{clock})", flush=True)


if __name__ == "__main__":
    main()
