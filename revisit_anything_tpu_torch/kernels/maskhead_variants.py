"""Time source-level variants of the fused mask head (K3) on the card, to
see whether the tensor cores, the epilogue or the keys ring sets its
pace: each variant is ``mask_head.cu`` with a few lines replaced (all but
the first no longer compute the right answer: they remove one part of
the work to show what it costs), built by its own nvcc into
``build/torch_kernels/variants/`` and timed at the serving shape and on
one work item alone.

    python -m revisit_anything_tpu_torch.kernels.maskhead_variants

Times are CUDA-event medians of 11 calls, each queued behind a device
sleep (as ``chip_smoke.py`` times kernels). Needs a CUDA device and
nvcc; prints one line per shape.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys

import torch

from revisit_anything_tpu_torch.kernels import build
from revisit_anything_tpu_torch.kernels.winattn_variants import _time_ms
from revisit_anything_tpu_torch.ops import maskhead as mh

_SRC = build._CSRC / "mask_head.cu"
_OUT = build._BUILD_ROOT / "variants"

# the first line of each epilogue's body, and the early exit put before
# it: h1 = y1 packed; one logit a thread a group
_EP1 = "  float y[2][16], st[2][2];"
_NO_EP1 = ("#pragma unroll\n  for (int i = 0; i < 16; ++i) "
           "a[i / 4][i % 4] = pack_bf16(acc[2 * i], acc[2 * i + 1]);\n"
           "  return;\n" + _EP1)
_EP2 = "  uint32_t h2[8][4];"
_NO_EP2 = ("  stage[(row0 * 16 + 4 * q + c) * M] = "
           "__float2bfloat16(acc[0] + acc[63]);\n  return;\n" + _EP2)
_MMA1 = "    wgmma_ss_n64_mn(acc, da, db, k > 0);"
_MMA2 = ("    wgmma_rs_n128_mn(acc, a[k], gmma_desc(sw2 + k * 2048, BOX_W2, "
         "1024), k > 0);")
# a product replaced by an empty asm that leaves the accumulators opaque
# (no instruction, but the compiler can fold nothing of the epilogue)
_NO_MMA1 = "    fence_regs(acc);"
_NO_MMA2 = "    fence_regs(acc);"
_MMA3 = ("wgmma_rs_n8(d[r], h2[2 * r + k], gmma_desc_plain(shyp + k * 256, 128, "
         "512), k > 0);")
_NO_MMA3 = "fence_regs(d[r]);"
_ENTRY = "  extern __shared__ uint8_t smem_raw[];"
_WAIT1 = "wgmma_wait<1>();"

# name -> (what it shows, [(old text, new text), ...])
VARIANTS = {
    "kernel": ("the kernel as built", []),
    "noepilogue": ("no epilogue arithmetic (h1 = y1 packed, one logit "
                   "a thread a group)", [(_EP1, _NO_EP1), (_EP2, _NO_EP2)]),
    "noepilogue1": ("no conv1 epilogue (h1 = y1 packed)", [(_EP1, _NO_EP1)]),
    "noepilogue2": ("no conv2 epilogue (one logit a thread a group)",
                    [(_EP2, _NO_EP2)]),
    "noturns": ("the two warpgroups issue their products without taking "
                "turns", [("constexpr bool TURNS = true;",
                           "constexpr bool TURNS = false;")]),
    "serial": ("the next group's conv1 waited for before the conv2 "
               "epilogue, not run under it",
               [(_WAIT1, "wgmma_wait<0>();")]),
    "noproducts": ("no wgmma (accumulators left opaque to the compiler)",
                   [(_MMA1, _NO_MMA1), (_MMA2, _NO_MMA2), (_MMA3, _NO_MMA3)]),
    "loadstore": ("keys ring, hyper rows and logit stores only",
                  [(_EP1, _NO_EP1), (_EP2, _NO_EP2), (_MMA1, _NO_MMA1),
                   (_MMA2, _NO_MMA2)]),
    "empty": ("returns at entry (launch cost)",
              [(_ENTRY, "  if (total > 0) return;\n" + _ENTRY)]),
}

# (prompts, gg, content, mask tokens): the serving shape, and one
# 64-position item alone (one CTA, the weights loaded once)
SHAPES = ((1024, 4096, 3136, 3), (1, 64, 64, 3))


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
        cu = _OUT / f"maskhead_{name}.cu"
        cu.write_text(_source(reps))
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build._CSRC),
             "-shared", "-o", str(_OUT / f"maskhead_{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        fn = ctypes.CDLL(str(_OUT / f"maskhead_{name}.so")).rat_mask_head
        fn.argtypes = list(build.SIGNATURES["rat_mask_head"])
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def _clock(call, n: int = 300) -> str:
    """The SM clock and board power that nvidia-smi reads while ``call``
    runs back to back (medians of 100 ms samples)."""
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, text=True)
    for _ in range(n):
        call()
    torch.cuda.synchronize()
    smi.terminate()
    rows = [r.split(",") for r in smi.communicate()[0].splitlines()
            if r.count(",") == 1]
    if not rows:
        return ", clock not read"
    mhz = statistics.median(float(r[0]) for r in rows)
    watts = statistics.median(float(r[1]) for r in rows)
    return f", {mhz:.0f} MHz {watts:.0f} W"


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("maskhead_variants: needs a CUDA device")
    dev = torch.device("cuda")
    fns = _build_all()
    for name, (what, _) in VARIANTS.items():
        print(f"[variant] {name}: {what}", flush=True)
    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16

    def rnd(*shape, s=1.0, off=0.0):
        return (torch.randn(shape, generator=g, device=dev) * s + off).to(bf)

    stream = torch.cuda.current_stream().cuda_stream
    n_ctas = torch.cuda.get_device_properties(dev).multi_processor_count
    for np_, gg, content, m in SHAPES:
        args = (rnd(np_, gg, 256), rnd(np_, m, 32, s=0.5),
                rnd(256, 256, s=0.1), rnd(64, s=0.1), rnd(64, s=0.1, off=1.0),
                rnd(64, s=0.1), rnd(64, 128, s=0.1), rnd(32, s=0.1))
        want = mh.upscale_masks_blocks(args[0][:, :content], *args[1:],
                                       eps=1e-6).float()
        out = torch.empty((np_, content, 16, m), dtype=bf, device=dev)
        ptrs = args[:1] + args[2:] + args[1:2]          # the C argument order
        parts = []
        for name, fn in fns.items():
            out.zero_()

            def call(fn=fn):
                err = fn(*(a.data_ptr() for a in ptrs), out.data_ptr(), np_,
                         gg, content, m, 1e-6, n_ctas, stream)
                if err:
                    raise RuntimeError(f"launch failed: cudaError {err}")
            ms = _time_ms(call)
            rel = ((out.float() - want).abs().max() / want.abs().max()).item()
            clock = _clock(call) if np_ > 1 else ""
            parts.append(f"{name} {ms * 1e3:.1f} us (rel_err {rel:.1e}{clock})")
        print(f"[variants] keys [{np_},{gg},256] content {content} M {m}: "
              f"{'; '.join(parts)}", flush=True)


if __name__ == "__main__":
    main()
