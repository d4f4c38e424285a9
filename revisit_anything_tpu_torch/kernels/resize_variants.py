"""Time source-level variants of the fused mask resize (K4) on the card, to
see whether its loads, its arithmetic, its stores or its stats set its
pace: each variant is ``resize_flags.cu`` with a few lines replaced (all
but the first no longer compute the right answer: they remove one part of
the work to show what it costs), built by its own nvcc into
``build/torch_kernels/variants/`` and timed at the serving shape (17places:
logits [1024, 3136, 16, 3] → flags [1024, 3, 240, 320]) and on one prompt
alone.

    python -m revisit_anything_tpu_torch.kernels.resize_variants

Times are CUDA-event medians of 11 calls, each queued behind a device
sleep (as ``chip_smoke.py`` times kernels), with the achieved rate (the
bytes the kernel must move, over its time) and the SM clock and board
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
from revisit_anything_tpu_torch.ops import maskresize as mr

_SRC = build._CSRC / "resize_flags.cu"
_OUT = build._BUILD_ROOT / "variants"

_ROW = ("      row_pass<M, S, E>(ring, b & 1 ? t1 : t0, htap, bd.o0, bd.o1 - bd.o0, "
        "bd.pl * R, i0, kmax, g,\n                     run);")
_COL = ("    column_pass<S>(b & 1 ? t1 : t0, b & 1 ? s1 : s0, wtap, cs, rows, w, L.w4, "
        "4 * g - TAPS,\n                   t_lo, t_mid, t_hi);")
_STATS = ("    band_out<M>(b & 1 ? s1 : s0, bd.pl & 1 ? cw1 : cw0, flags, rowst,\n"
          "                blockIdx.x + bd.pl * gridDim.x, bd.o0, bd.o1 - bd.o0, h, w, "
          "L.w4);")
# the staged tile copied out by 16-byte stores, without stats (W % 16 == 0)
_COPY = ("    for (int e = tid; e < rows * (w >> 4); e += CT) {\n"
         "      const int rr = e / (w >> 4), v = e - rr * (w >> 4), "
         "nr = bd.o1 - bd.o0, m = rr / nr;\n"
         "      reinterpret_cast<uint4*>(flags + (((size_t)(blockIdx.x + bd.pl * "
         "gridDim.x) * M + m) * h + bd.o0 + rr - m * nr) * w)[v] =\n"
         "          reinterpret_cast<const uint4*>((b & 1 ? s1 : s0) + rr * L.w4)[v];\n"
         "    }")
_ISSUE = "  lim = lim < total ? lim : total;"
_WAIT = "    mbar_wait(bar0 + 8 * (s % NSLOT), (s / NSLOT) & 1);"
_CONST = ("    for (int e = tid; e < rows * L.w4; e += CT) "
          "(b & 1 ? s1 : s0)[e] = 3;")

# name -> (what it shows, [(old text, new text), ...])
VARIANTS = {
    "kernel": ("the kernel as built", []),
    "nostats": ("no row stats or columns-any (flags copied out alone)",
                [(_STATS, _COPY)]),
    "norowpass": ("no row pass (T left as it is)", [(_ROW, "")]),
    "nocolumnpass": ("no column pass (the staging tile left as it is)",
                     [(_COL, "")]),
    "loadsonly": ("the ring filled and waited for, no arithmetic, the "
                  "staging tile copied out a band",
                  [(_ROW, ""), (_COL, ""), (_STATS, _COPY)]),
    "skeleton": ("the ring filled and waited for, nothing else",
                 [(_ROW, ""), (_COL, ""), (_STATS, "")]),
    "idle": ("no loads, no waits, no passes: the band loop alone",
             [(_ISSUE, "  lim = 0;"), (_WAIT, "    (void)s;"), (_ROW, ""),
              (_COL, ""), (_STATS, "")]),
    "storesonly": ("no loads, flags from a constant: the staging tile "
                   "filled and copied out a band",
                   [(_ISSUE, "  lim = 0;"), (_WAIT, "    (void)s;"),
                    (_ROW, ""), (_COL, _CONST), (_STATS, _COPY)]),
}

# (prompts, image): the 17places serving shape, one prompt alone
SHAPES = ((1024, (240, 320)), (1, (240, 320)))


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
        cu = _OUT / f"resize_{name}.cu"
        cu.write_text(_source(reps))
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build._CSRC),
             "-shared", "-o", str(_OUT / f"resize_{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        fn = ctypes.CDLL(str(_OUT / f"resize_{name}.so")).rat_resize_flags
        fn.argtypes = list(build.SIGNATURES["rat_resize_flags"])
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("resize_variants: needs a CUDA device")
    from revisit_anything_tpu_torch.models.sam import SAM_VIT_H
    from revisit_anything_tpu_torch.models.sam.amg import (
        resize_longest_side, resize_mats_and_rows)
    dev = torch.device("cuda")
    fns = _build_all()
    for name, (what, _) in VARIANTS.items():
        print(f"[variant] {name}: {what}", flush=True)
    lib = build.load()
    print(f"[variants] K4 M 3 at 240x320: {lib.rat_resize_flags_ctas(3, 320, 240)}"
          f" CTAs an SM, {lib.rat_resize_flags_smem(3, 320, 240)} B of shared "
          f"memory a CTA", flush=True)
    g = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for np_, orig in SHAPES:
        wh, ww, gh = resize_mats_and_rows(
            SAM_VIT_H, resize_longest_side(*orig, 1024), orig)
        whd, wwd = torch.from_numpy(wh).to(dev), torch.from_numpy(ww).to(dev)
        htap, wtap = (t.to(dev) for t in mr.resize_taps(wh, ww))
        h, w = wh.shape[0], ww.shape[0]
        x = (torch.randn((np_, gh * 64, 16, 3), generator=g, device=dev)
             * 4.0).to(torch.bfloat16)
        want = mr.resize_flags_reference(x, whd, wwd, 0.0, 1.0, (gh, 64))
        flags = torch.empty((np_, 3, h, w), dtype=torch.uint8, device=dev)
        rowst = torch.empty((np_, 3, h, 3), dtype=torch.int32, device=dev)
        colany = torch.empty((np_, 3, w), dtype=torch.uint8, device=dev)
        moved = sum(t.numel() * t.element_size()
                    for t in (x, htap, wtap, flags, rowst, colany))
        for name, fn in fns.items():
            flags.zero_()

            def call(fn=fn):
                err = fn(x.data_ptr(), htap.data_ptr(), wtap.data_ptr(),
                         flags.data_ptr(), rowst.data_ptr(),
                         colany.data_ptr(), np_, gh, 64, 3, h, w, -1.0, 0.0,
                         1.0, n_sm, stream)
                if err:
                    raise RuntimeError(f"launch failed: cudaError {err}")
            ms = time_ms(call)
            mism = (flags != want).float().mean().item()
            clock = _clock(call, n=3000) if np_ > 1 else ""
            print(f"[variants] logits [{np_},{gh * 64},16,3] -> flags "
                  f"[{np_},3,{h},{w}]: {name} {ms * 1e3:.1f} us, "
                  f"{moved / ms / 1e6:.1f} GB/s (flag mismatch "
                  f"{mism:.1e}{clock})", flush=True)


if __name__ == "__main__":
    main()
