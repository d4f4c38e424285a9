"""Time source-level variants of the fused decode tail (B3) in its keys
mode on the card, to see which part of the work sets its pace: each
variant is ``decode_tail.cu`` (and ``decode_tc.cuh``) with a few lines
replaced (all but the first no longer compute the right answer: they
remove one part of the work, keeping the CTA barriers, to show what it
costs), built by its own nvcc into ``build/torch_kernels/variants/``
(linked with K3's ``mask_head.cu``, which the logits entry calls) and
timed at the serving shape (1024 prompts x M 4096), one wave of 132
prompts, and M = 32 (one tile: the per-prompt token work).

    python -m revisit_anything_tpu_torch.kernels.tail_variants

Times are CUDA-event medians of 11 calls, each queued behind a device
sleep (as ``chip_smoke.py`` times kernels), with the SM clock and board
power nvidia-smi reads while the kernel runs back to back at the serving
shape. Then the phase probe (cycles of each statement of pass B's loop,
``[phases]``) and the precision of the kernel's three modes against the
plain version, beside the plain version in TF32 and with its branch
products rounded from f64 (``[precision]``). Needs a CUDA device and
nvcc; prints one line per variant and shape.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

from revisit_anything_tpu_torch.kernels import build, stamps
from revisit_anything_tpu_torch.kernels.maskhead_variants import _clock
from revisit_anything_tpu_torch.kernels.winattn_variants import time_ms
from revisit_anything_tpu_torch.ops import decode_fused as dfu

_FILES = ("decode_tail.cu", "decode_tc.cuh")
_SRC = build._CSRC / _FILES[0]
_OUT = build._BUILD_ROOT / "variants"

_TAIL, _TC = _FILES
_SCORES = [(_TAIL, "    scores_tc(sS, sQah, sQal, sYh, sYl);\n", ""),
           (_TAIL, "    scores_tc(sS, sQbh, sQbl, sYh, sYl);\n", "")]
_CONTEXT = [(_TAIL, "    context_tc(ctx, sPh, sPl, alpha, sYh, sYl);\n", "")]
# a rebuild ends with two CTA barriers: they stay
_REBUILD = [(_TAIL, "    rebuild_tc<true>(y, img, sYh, sYl, sP, sC1, sV, red, pr.eps, "
                    "ys1, nullptr);",
             "    __syncthreads();\n    __syncthreads();"),
            (_TAIL, "    rebuild_tc<false>(y, img, sYh, sYl, sP, sC2, sV + 3 * D, "
                    "red, pr.eps, ys2,\n                      m0 < klimit ? kout + (size_t)m0 * D "
                    ": nullptr);",
             "    __syncthreads();\n    __syncthreads();")]
_SOFTMAX = ("    __syncthreads();                                           "
            "// S read: p replaces it\n    online_tile(st, s, sPh, sPl, alpha);\n")
_ENTRY = ("__global__ void __launch_bounds__(THREADS, 1) "
          "decode_tail_kernel(const TailParams pr) {\n")

# name -> (what it shows, [(file, old text, new text), ...])
VARIANTS = {
    "kernel": ("the kernel as built", []),
    "noscores": ("no score products (S as left in shared memory)", _SCORES),
    "nocontext": ("no context products", _CONTEXT),
    "norebuild": ("no branch rebuilds (planes as left in shared memory, "
                  "no keys2 stores)", _REBUILD),
    "noproducts": ("none of the three product families",
                   _SCORES + _CONTEXT + _REBUILD),
    "nope": ("no pe terms (no pe loads or their FMA)",
             [(_TC, "                                               const PeCol& col) "
                    "{\n", "                                               "
               "const PeCol& col) {\n  return;\n"),
              (_TC, "#pragma unroll\n  for (int j = 0; j < HD; ++j)\n    asm volatile",
               "  return;\n#pragma unroll\n  for (int j = 0; j < HD; ++j)\n    asm volatile")]),
    "nop1": ("no P1 (P as left in shared memory)",
             [(_TAIL, "    p1_tile(sP, sK1, pe, nullptr, m);\n", ""),
              (_TAIL, "    p1_tile(sP, sK1, pe, p1out ? p1out + m0 : nullptr, m);"
                      "   // P1, emitted in probability mode\n", "")]),
    "nosoftmax": ("no attention softmax (the online update; p as left in "
                  "shared memory)", [(_TAIL, _SOFTMAX, "    __syncthreads();\n")]),
    "noemit": ("no keys2 stores", [(_TAIL, "m0 < klimit ? kout + (size_t)m0 * D "
                                           ": nullptr);", "nullptr);")]),
    "nomlp": ("no token MLP", [
        (_TAIL, "  dense_rows_n8(sQb, sQin, D, pr.lin1_w, pr.lin1_b, pr.mlp, "
                "true); // hidden\n", ""),
        (_TAIL, "  dense_rows_k4(xb, sQb, pr.mlp, pr.lin2_w, pr.lin2_b, D, "
                "false);\n", "")]),
    "empty": ("returns at entry (launch cost)",
              [(_TAIL, _ENTRY, _ENTRY + "  if (pr.m > 0) return;\n")]),
}

# (prompts, positions): the serving shape, one wave, one tile
SHAPES = ((1024, 4096), (132, 4096), (1024, 32))

# The phase probe: pass B's loop with a clock64() stamp after each
# statement, taken by lane 0 of every warp of CTA 0 on tiles 1..TILES and
# written to the (in keys mode unused) C2 pointer.
TILES = 8
_LOOP = "  for (int m0 = 0; m0 < m; m0 += BM) {\n"


def _probe_source() -> tuple:
    """decode_tail.cu with pass B stamped, and the stamped lines."""
    text = _SRC.read_text()
    head = text.index("decode_tail_kernel(const TailParams pr) {")
    start = text.index(_LOOP, text.index(_LOOP, head) + 1) + len(_LOOP)
    return stamps.stamp_loop(text, start, stamps.stamp(
        "(m0 / BM)", TILES, "reinterpret_cast<long long*>(pr.c2m)", 32,
        "WARPS"))


def _source(reps) -> dict:
    """The variant's text of each patched file."""
    texts = {f: (build._CSRC / f).read_text() for f in _FILES}
    for f, old, new in reps:
        if old not in texts[f]:
            raise ValueError(f"variant patch does not apply: {old[:60]!r}")
        texts[f] = texts[f].replace(old, new)
    return texts


def _compile(src, obj) -> subprocess.Popen:
    return subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build._CSRC), "-c", "-o",
         str(obj), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _link(procs: dict, head) -> dict:
    """Wait for the compiles ``procs`` (name -> (directory, process)),
    link each variant's object with K3's ``head`` object (the logits
    entry calls it) and return each library (name -> ctypes library)."""
    libs = {}
    for name, (out, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
    for name, (out, _) in procs.items():
        if out is None:
            continue
        subprocess.run([build._nvcc(), "-shared", "-o", str(out / "tail.so"),
                        str(out / "tail.o"), str(head)], check=True,
                       capture_output=True)
        lib = ctypes.CDLL(str(out / "tail.so"))
        for entry in ("rat_decode_tail", "rat_decode_tail_logits",
                      "rat_mask_head"):
            getattr(lib, entry).argtypes = list(build.SIGNATURES[entry])
            getattr(lib, entry).restype = ctypes.c_int
        libs[name] = lib
    return libs


def _build_all() -> dict:
    _OUT.mkdir(parents=True, exist_ok=True)
    head = _OUT / "mask_head.o"
    procs = {"mask_head.cu": (None, _compile(build._CSRC / "mask_head.cu",
                                             head))}
    for name, (_, reps) in VARIANTS.items():
        out = _OUT / f"tail_{name}"
        out.mkdir(parents=True, exist_ok=True)
        for f, text in _source(reps).items():
            (out / f).write_text(text)
        procs[name] = (out, _compile(out / _TAIL, out / "tail.o"))
    return _link(procs, head)


def _probe(dfu_args) -> None:
    """Run the stamped kernel on the serving shape; print each statement
    of pass B's loop with its cycles (median over tiles, mean and max over
    the 8 warps; a barrier's are the wait)."""
    import statistics
    out = _OUT / "tail_probe"
    out.mkdir(parents=True, exist_ok=True)
    text, lines = _probe_source()
    (out / _TAIL).write_text(text)
    (out / _TC).write_text((build._CSRC / _TC).read_text())
    fn = _link({"probe": (out, _compile(out / _TAIL, out / "tail.o"))},
               _OUT / "mask_head.o")["probe"].rat_decode_tail
    buf = torch.zeros((TILES, 32, 8), dtype=torch.int64, device="cuda")

    class Probe(_Launch):
        def launch(self, params) -> None:
            dfu.TailParams.from_address(params).c2m = buf.data_ptr()
            super().launch(params)

    kernel = dfu.DECODE_TAIL
    dfu.DECODE_TAIL = Probe(fn)
    try:
        with torch.inference_mode():
            dfu.decode_tail_fused(*dfu_args)
        torch.cuda.synchronize()
    finally:
        dfu.DECODE_TAIL = kernel
    st = buf.cpu()
    d = (st[:, 1:len(lines) + 1] - st[:, :len(lines)]).double()
    total = 0.0
    for i, line in enumerate(lines):
        mean = statistics.median(d[:, i].mean(1).tolist())
        top = statistics.median(d[:, i].max(1).values.tolist())
        total += mean
        print(f"[phases] {mean:8.0f} mean {top:8.0f} max cycles  {line}",
              flush=True)
    print(f"[phases] {total:8.0f} cycles a tile of pass B (warp mean)",
          flush=True)


def recon_step_f64(y, p, c, rows3, eps):
    """``ops.decode_probs.recon_step`` with P^T C summed in f64 and rounded
    to f32 once: the plain f32 function moved by at most an f32 ulp."""
    pc = torch.matmul(p.double().transpose(1, 2), c.double()).float()
    y = y + pc + rows3[0].float()
    mu = y.mean(-1, keepdim=True)
    var = torch.clamp((y * y).mean(-1, keepdim=True) - mu * mu, min=0.0)
    return (y - mu) * torch.rsqrt(var + eps) * rows3[1].float() \
        + rows3[2].float()


def _moved(label: str, n: int, names, got, want,
           ref: str = "plain f32") -> None:
    """Print, for each output, the share of its bf16 elements that differ
    from ``ref``'s (``want``) and their mean and max absolute
    difference."""
    for name, a, w in zip(names, got, want):
        d = (a.float() - w.float()).abs()
        print(f"[precision] {label} vs {ref}, {n} prompts: {name} "
              f"differs in {(d > 0).float().mean().item():.4f} of its "
              f"elements, mean |diff| {d.mean().item():.3e}, max "
              f"{d.max().item():.3e}", flush=True)


def _precision(dfu_args, lib, n: int = 64, content: int = 3136) -> None:
    """The kernel (library ``lib``) on the first ``n`` prompts against the
    plain version, in its three modes: the keys mode beside the plain
    version run with TF32 matmuls and with P^T C rounded once from f64
    (``recon_step_f64``: the floor an f32 computation in another order
    sets), then the probability mode's and the logits mode's outputs, and
    K3 alone on the plain version's keys2 (what the mask head moves by
    itself): the share of bf16 elements that differ from the f32 plain
    version and the mean absolute difference; last the logits mode
    against the keys mode's kernel followed by the plain hypernetwork and
    K3 (the "fused_tail_keys" path)."""
    from revisit_anything_tpu_torch.ops import decode_probs as dpr
    from revisit_anything_tpu_torch.ops import maskhead as mh
    args = list(dfu_args)
    for i in (6, 7, 8, 9):                     # the per-prompt operands
        args[i] = args[i][:n]
    outs = {}
    kernels = dfu.DECODE_TAIL, dfu.DECODE_TAIL_LOGITS, mh.MASK_HEAD
    try:
        dfu.DECODE_TAIL = _Launch(lib.rat_decode_tail)
        dfu.DECODE_TAIL_LOGITS = _Launch(lib.rat_decode_tail_logits)
        with torch.inference_mode():
            want = dfu.decode_tail_reference(*args)
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                outs["plain in TF32"] = dfu.decode_tail_reference(*args)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
            saved = dpr.recon_step
            dpr.recon_step = dfu.recon_step = recon_step_f64
            try:
                outs["plain, P^T C from f64"] = dfu.decode_tail_reference(
                    *args)
            finally:
                dpr.recon_step = dfu.recon_step = saved
            outs["kernel"] = dfu.decode_tail_fused(*args)
            for label, res in outs.items():
                _moved(label, n, ("token state", "keys2"), res, want)
            args[-1] = False
            _moved("probability mode kernel", n,
                   ("token state", "P1", "P2", "C2"),
                   dfu.decode_tail_fused(*args),
                   dfu.decode_tail_reference(*args))
            head = dict(mask_head=True, content=content)
            want = dfu.decode_tail_reference(*args, **head)
            _moved("logits mode kernel", n, ("token state", "logits"),
                   dfu.decode_tail_fused(*args, **head), want)
            # K3 alone, on the plain version's keys2 and hypernetwork
            # rows; the logits mode against the "fused_tail_keys" path
            # (the keys mode, the plain hypernetwork, K3)
            mh.MASK_HEAD = _Launch(lib.rat_mask_head)

            def k3(q, keys2):
                return (mh.fused_mask_head(
                    keys2[:, :content].to(q.dtype), mh.hypernetwork(args[0], q),
                    *mh.mask_head_weights(args[0]), eps=args[11],
                    content=content),)
            _moved("K3 on the plain tail's keys2", n, ("logits",),
                   k3(*dfu.decode_tail_reference(*args[:-1], True)),
                   want[1:])
            _moved("logits mode kernel", n, ("logits",),
                   dfu.decode_tail_fused(*args, **head)[1:],
                   k3(*dfu.decode_tail_fused(*args[:-1], True)),
                   ref="keys mode kernel + plain hypernetwork + K3")
    finally:
        dfu.DECODE_TAIL, dfu.DECODE_TAIL_LOGITS, mh.MASK_HEAD = kernels


class _Launch:
    """Stands in for a ``build`` kernel handle in a wrapper: the variant
    library's entry point on the current stream."""

    def __init__(self, fn):
        self.fn = fn

    def launch(self, *args) -> None:
        err = self.fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: cudaError {err}")


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("tail_variants: needs a CUDA device")
    from revisit_anything_tpu_torch.models.sam import SAM_VIT_H
    from revisit_anything_tpu_torch.models.sam.decoder import MaskDecoder
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = _build_all()
    for name, (what, _) in VARIANTS.items():
        print(f"[variant] {name}: {what}", flush=True)
    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16

    def rnd(*shape, s=1.0):
        return (torch.randn(shape, generator=g, device=dev) * s).to(bf)

    dec = MaskDecoder(SAM_VIT_H, dtype=bf, device=dev)
    with torch.no_grad():
        for name, prm in dec.named_parameters():
            x = torch.randn(prm.shape, generator=g, device=dev) * 0.05
            prm.copy_(x + 1.0 if name.endswith("scale") else x)
    kernel = dfu.DECODE_TAIL
    try:
        for b, m in SHAPES:
            args = (dec, rnd(1, m, 256), rnd(1, 128, m), rnd(1, 128, m),
                    rnd(1, 128, m), rnd(1, 128, m), rnd(b, 7, 128),
                    rnd(b, 56, 256, s=0.3), rnd(b, 7, 256), rnd(b, 7, 256),
                    8, 1e-6, True)
            if (b, m) == SHAPES[0]:
                args_serving = args
            for name, lib in libs.items():
                dfu.DECODE_TAIL = _Launch(lib.rat_decode_tail)

                @torch.inference_mode()
                def call():
                    dfu.decode_tail_fused(*args)
                ms = time_ms(call)
                clock = _clock(call, 30) if (b, m) == SHAPES[0] else ""
                print(f"[variants] {b} prompts x M {m}: {name} "
                      f"{ms * 1e3:.1f} us{clock}", flush=True)
    finally:
        dfu.DECODE_TAIL = kernel
    _probe(args_serving)
    _precision(args_serving, libs["kernel"])


if __name__ == "__main__":
    main()
