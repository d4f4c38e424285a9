"""Hold the probability-factored decode kernels, B7 (``i2t_probs``, layers
1 and 2), B8 (``t2i_from_probs``, depths 1 and 2) and B6
(``fused_mask_head_probs``, content 3136, M 3), of this checkout against
another checkout's on the card, and time B7 layer 2's grid two ways.

    python -m revisit_anything_tpu_torch.kernels.probs_compare [OTHER_ROOT]
    python -m revisit_anything_tpu_torch.kernels.probs_compare --f32

Each checkout runs in its own process and build (the two packages share a
name), twice, in turns (other, this, this, other). A run makes the same
seeded inputs (M 4096) and prints, for each of the five launches:

- ``[precision]``: on the first 64 prompts, the share of the kernel's
  bf16 output elements that differ from the checkout's own plain f32
  version, and the largest relative error;
- ``[time]``: the kernel at 1024 prompts, CUDA-event median of 11
  calls, each queued behind a device sleep (``winattn_variants.time_ms``,
  as ``chip_smoke.py`` times kernels).

The 64-prompt outputs of the first runs are compared across the
checkouts, bit for bit and by the share of elements moved. Last,
``[grid]``: in this checkout, B7 layer 2 as built (one CTA a whole prompt
at M 4096) against the same source with runs of 16 tiles a CTA (each
timed in turns, outputs compared bit for bit). Outputs go to
``build/probs_compare/`` at this checkout's root. Needs a CUDA device and
nvcc.

``--f32``: this checkout's f32 forms (f32 operands, P bf16) instead, in
one process: ``[precision]`` on the first 64 prompts against the plain
f32 version with TF32 off (B7: the share of its bf16 P elements that
differ and the largest difference in bf16 ulps; B8: the largest error
relative to the output's scale; B6 the same), then ``[time]`` at 1024
prompts of each
launch in bf16 and in f32, in turns (bf16, f32, f32, bf16: each form's
time the median of its two turns, each turn a median of 11).
"""

from __future__ import annotations

import statistics
import subprocess
import sys
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[2]
_OUT = _ROOT / "build" / "probs_compare"
LAUNCHES = ("B7 layer 1", "B7 layer 2", "B8 depth 1", "B8 depth 2",
            "B6 content 3136")

# B7 f32 rounds P to bf16 as its plain version does: an f32 difference of
# ~2^-20 of a probability (the rebuild's and scores' planes, f32 sums in
# another order) moves its rounding in the elements that lie within that
# of a bf16 rounding boundary, 2^-20 / 2^-8 = 2^-12 of them; at most one
# ulp each, in at most 1e-3 of them (4x that). C rounded once to TF32
# (2^-11) moves a few percent of them (4.3e-2 in the CPU emulation of
# tests/test_torch_decode_probs.py with C x 8).
PROBS_F32_MOVED = 1e-3


def bf16_ulps(got, want) -> tuple:
    """(largest |got - want| in bf16 ulps of ``want``, the share of
    elements that differ) for bf16 values ``want``: one ulp is 2^(e - 8)
    for |want| in [2^(e - 1), 2^e)."""
    import torch
    e = torch.frexp(want.float().abs())[1]
    ulp = torch.ldexp(torch.ones_like(want, dtype=torch.float32), e - 8)
    diff = (got.float() - want.float()).abs()
    return (diff / ulp).max().item(), (diff > 0).float().mean().item()


def _inputs(torch, b, seed=0, dtype=None):
    """The serving widths (D 256, DA 128, 8 heads, 7 tokens, M 4096) for
    ``b`` prompts, as ``chip_smoke.py`` makes them: P bf16, the rest in
    ``dtype`` (bf16 by default); then B6's hypernetwork rows (M 3) and
    mask head weights."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    bf, m = torch.bfloat16, 4096
    dtype = dtype or bf

    def rnd(*shape, s=1.0):
        return (torch.randn(shape, generator=g, device=dev) * s).to(dtype)

    def probs():
        x = torch.randn((b, 8, 7, m), generator=g, device=dev) * 2.0
        return torch.softmax(x, dim=2).reshape(b, 56, m).to(bf)

    rows = torch.zeros((8, 256), device=dev)
    rows[[0, 3]] = torch.randn((2, 256), generator=g, device=dev) * 0.1
    rows[[1, 4]] = torch.randn((2, 256), generator=g, device=dev) * 0.1 + 1
    rows[[2, 5]] = torch.randn((2, 256), generator=g, device=dev) * 0.1
    return dict(img0=rnd(1, m, 256), q1st=rnd(1, 128, m), peqt=rnd(1, 128, m),
                tok_k=rnd(b, 7, 128), q=rnd(b, 7, 128), p1=probs(), p2=probs(),
                c1=rnd(b, 56, 256, s=0.3), c2=rnd(b, 56, 256, s=0.3),
                w_q=rnd(256, 128, s=0.1), w_k=rnd(256, 128, s=0.1),
                w_v=rnd(256, 128, s=0.1), vb=rnd(128, s=0.1),
                rows=rows.to(dtype), hyper=rnd(b, 3, 32, s=0.5),
                head=(rnd(256, 256, s=0.1), rnd(64, s=0.1),
                      rnd(64, s=0.1) + 1, rnd(64, s=0.1),
                      rnd(64, 128, s=0.1), rnd(32, s=0.1)))


def _calls(dpr, x, plain=False):
    """The five launches on inputs ``x`` (kernels, or their plain
    versions), as argument-free functions."""
    from revisit_anything_tpu_torch.ops import maskhead as mh
    i2t = dpr.i2t_probs_reference if plain else dpr.i2t_probs
    t2i = dpr.t2i_from_probs_reference if plain else dpr.t2i_from_probs
    head = mh.mask_head_probs_reference if plain else mh.fused_mask_head_probs
    recon = (x["img0"], x["p1"], x["c1"], x["peqt"], x["w_q"], x["rows"])

    def attend(p2, c2):
        return lambda: t2i(x["q"], x["img0"], x["p1"], x["c1"], p2, c2,
                           x["w_k"], x["w_v"], x["peqt"], x["rows"], x["vb"],
                           8)

    return (lambda: i2t(x["q1st"], x["tok_k"], 8),
            lambda: i2t(None, x["tok_k"], 8, layer=2, recon=recon),
            attend(None, None), attend(x["p2"], x["c2"]),
            lambda: head(x["img0"], x["p1"], x["c1"], x["p2"], x["c2"],
                         x["rows"], x["hyper"], *x["head"], content=3136))


def _worker(root: str, out: str) -> None:
    """In the checkout at ``root``: each launch's precision on 64 prompts
    (outputs saved to ``out``) and its time at 1024 prompts."""
    sys.path[0] = root                 # in place of this script's directory
    import torch

    try:
        from revisit_anything_tpu_torch.kernels.winattn_variants import (
            time_ms)
    except ImportError:                # a checkout where it was private
        from revisit_anything_tpu_torch.kernels.winattn_variants import (
            _time_ms as time_ms)
    from revisit_anything_tpu_torch.ops import decode_probs as dpr
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[compare] {root}: {dpr.__file__}", flush=True)
    x = {k: (v[:64] if k != "head" and v.shape[0] == 1024 else v)
         for k, v in _inputs(torch, 1024).items()}
    saved = []
    with torch.inference_mode():
        for name, k, p in zip(LAUNCHES, _calls(dpr, x), _calls(dpr, x, True)):
            got, want = k(), p()
            d = (got.float() - want.float()).abs()
            saved.append(got.cpu())
            print(f"[precision] {root}: {name}, 64 prompts, against its "
                  f"plain f32 version: {(d > 0).float().mean().item():.4f} "
                  f"of its bf16 elements differ, rel_err "
                  f"{(d.max() / want.float().abs().max()).item():.3e}",
                  flush=True)
        torch.save(saved, out)
        x = _inputs(torch, 1024)
        for name, k in zip(LAUNCHES, _calls(dpr, x)):
            print(f"[time] {root}: {name}, 1024 prompts: "
                  f"{time_ms(k):.3f} ms", flush=True)


def _worker_f32() -> None:
    """This checkout's f32 forms: precision on 64 prompts, then each
    launch's time at 1024 prompts in bf16 and in f32, in turns."""
    import torch

    from revisit_anything_tpu_torch.kernels.winattn_variants import time_ms
    from revisit_anything_tpu_torch.ops import decode_probs as dpr
    torch.backends.cuda.matmul.allow_tf32 = False
    f32 = torch.float32
    with torch.inference_mode():
        x = {k: (v[:64] if k != "head" and v.shape[0] == 1024 else v)
             for k, v in _inputs(torch, 1024, dtype=f32).items()}
        for name, k, p in zip(LAUNCHES, _calls(dpr, x), _calls(dpr, x, True)):
            got, want = k(), p()
            if got.dtype == torch.bfloat16:
                ulps, moved = bf16_ulps(got, want)
                what = (f"{moved:.3e} of its bf16 elements differ, by at "
                        f"most {ulps:.3f} ulp")
            else:
                d = (got - want).abs()
                what = (f"rel_err "
                        f"{(d.max() / want.abs().max()).item():.3e}")
            print(f"[precision] f32 {name}, 64 prompts, against its plain f32"
                  f" version: {what}", flush=True)
        xs = {"bf16": _inputs(torch, 1024), "f32": _inputs(torch, 1024,
                                                           dtype=f32)}
        calls = {k: _calls(dpr, v) for k, v in xs.items()}
        for i, name in enumerate(LAUNCHES):
            times = {"bf16": [], "f32": []}
            for form in ("bf16", "f32", "f32", "bf16"):
                times[form].append(time_ms(calls[form][i]))
            print(f"[time] {name}, 1024 prompts: bf16 "
                  f"{statistics.median(times['bf16']):.3f} ms, f32 "
                  f"{statistics.median(times['f32']):.3f} ms (each the median"
                  " of 2 turns of 11: " + ", ".join(
                      f"{k} " + " ".join(f"{t:.3f}" for t in v)
                      for k, v in times.items()) + ")", flush=True)


def _grid() -> None:
    """B7 layer 2 as built (a whole prompt, 128 tiles, a CTA) against runs
    of 16 tiles a CTA."""
    import ctypes

    import torch

    from revisit_anything_tpu_torch.kernels import build
    from revisit_anything_tpu_torch.kernels.tail_variants import _Launch
    from revisit_anything_tpu_torch.kernels.winattn_variants import time_ms
    from revisit_anything_tpu_torch.ops import decode_probs as dpr
    src = (build._CSRC / "i2t_probs.cu").read_text()
    line = "constexpr int L2_TILES = 128;"
    if line not in src:
        raise ValueError(f"i2t_probs.cu has no line {line!r}")
    out = _OUT / "runs_of_16"
    out.mkdir(parents=True, exist_ok=True)
    (out / "i2t_probs.cu").write_text(src.replace(
        line, "constexpr int L2_TILES = 16;"))
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build._CSRC),
                    "-shared", "-o", str(out / "i2t.so"),
                    str(out / "i2t_probs.cu")], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(out / "i2t.so"))
    lib.rat_i2t_probs.argtypes = list(build.SIGNATURES["rat_i2t_probs"])
    lib.rat_i2t_probs.restype = ctypes.c_int
    x = _inputs(torch, 1024)
    call = _calls(dpr, x)[1]
    handles = {"a whole prompt a CTA (as built)": build.I2T_PROBS,
               "16 tiles a CTA": _Launch(lib.rat_i2t_probs)}
    times = {name: [] for name in handles}
    outs = {}
    try:
        with torch.inference_mode():
            for rep in range(4):
                order = list(handles) if rep % 2 == 0 else list(handles)[::-1]
                for name in order:
                    dpr.I2T_PROBS = handles[name]
                    times[name].append(time_ms(call))
                    outs[name] = call()
    finally:
        dpr.I2T_PROBS = build.I2T_PROBS
    same = torch.equal(*outs.values())
    for name, ts in times.items():
        print(f"[grid] B7 layer 2, 1024 prompts x M 4096, {name}: "
              f"{statistics.median(ts):.3f} ms (median of 4 turns: "
              + " ".join(f"{t:.3f}" for t in ts) + f"); outputs equal {same}",
              flush=True)


def main() -> None:
    import torch
    args = sys.argv[1:]
    if args == ["--f32"]:
        if not torch.cuda.is_available():
            sys.exit("probs_compare: needs a CUDA device")
        _worker_f32()
        return
    if len(args) > 1 or "--f32" in args:
        sys.exit(__doc__)
    if not torch.cuda.is_available():
        sys.exit("probs_compare: needs a CUDA device")
    _OUT.mkdir(parents=True, exist_ok=True)
    roots = {"this": str(_ROOT)}
    if len(sys.argv) == 2:
        roots["other"] = str(Path(sys.argv[1]).resolve())
    turns = (["other", "this", "this", "other"] if "other" in roots
             else ["this"])
    for i, name in enumerate(turns):
        subprocess.run([sys.executable, __file__, "--worker", roots[name],
                        str(_OUT / f"{name}{i}.pt")], check=True)
    if "other" in roots:
        this, other = (torch.load(_OUT / f"{n}{turns.index(n)}.pt")
                       for n in ("this", "other"))
        for name, a, b in zip(LAUNCHES, this, other):
            d = (a.float() - b.float()).abs()
            print(f"[compare] {name}, 64 prompts, this against other: bit "
                  f"for bit {torch.equal(a, b)}, moved "
                  f"{(d > 0).float().mean():.4f} of its elements, max |diff| "
                  f"{d.max():.3e}", flush=True)
    _grid()


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        _worker(*sys.argv[2:4])
    else:
        main()
