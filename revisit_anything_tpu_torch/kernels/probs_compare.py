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

``--f32 OTHER_ROOT``: the f32 forms of both checkouts, each in its own
process, in turns (other, this, this, other): each one's precision
against its own plain version, its times (and B3 f32's, whose walks
these are, in its three modes at 1024 prompts), and this checkout's
outputs against the other's (the share of elements moved, the largest
difference relative to the output's scale).

``--f32 --phases [OTHER_ROOT]``: where the f32 walks' time goes, in this
checkout (or the other): ``[phases]``, each walk's tile loop (B8 f32 at
depths 1 and 2, B7 f32 layer 2) with a ``clock64()`` stamp after each of
its statements, built apart, on 1024 prompts x M 4096 (the cycles of
each statement on the first CTA's tiles 1-8, the median over tiles of
the mean over the warps that ran it; a barrier's are its wait); then
``[fixed]``, each walk at M 4096 and at M 32 (the share of its time
outside the tile loop); then ``[parts]``, B3 f32 in its three modes at 1024 prompts under
torch.profiler, the device time of each of its kernels (the walks, the
token kernels, K3 f32 in logits mode).

``--f32 --variants``: the f32 walks as built beside the settings they
were chosen from (``WALK_VARIANTS``, each a line of ``walk_f32.cuh``
replaced in a copy built apart): each build's registers and spills a
walk, then B7 f32 layer 2 and B8 f32 at both depths (1024 prompts x M
4096) timed in turns (four turns, each a median of 11), each output
against the built one's bit for bit.
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


def _inputs(torch, b, seed=0, dtype=None, m=4096):
    """The serving widths (D 256, DA 128, 8 heads, 7 tokens, M 4096 or
    ``m`` positions) for ``b`` prompts, as ``chip_smoke.py`` makes them: P
    bf16, the rest in ``dtype`` (bf16 by default); then B6's hypernetwork
    rows (M 3) and mask head weights."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    bf = torch.bfloat16
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


def _f32_worker(root: str, out: str) -> None:
    """In the checkout at ``root``: each launch's f32 form against its plain
    version on 64 prompts (outputs saved to ``out``), then its time at
    1024 prompts."""
    sys.path[0] = root
    import torch

    from revisit_anything_tpu_torch.kernels.winattn_variants import time_ms
    from revisit_anything_tpu_torch.ops import decode_probs as dpr
    torch.backends.cuda.matmul.allow_tf32 = False
    f32 = torch.float32
    saved = []
    with torch.inference_mode():
        x = {k: (v[:64] if k != "head" and v.shape[0] == 1024 else v)
             for k, v in _inputs(torch, 1024, dtype=f32).items()}
        for name, k, p in zip(LAUNCHES, _calls(dpr, x), _calls(dpr, x, True)):
            got, want = k(), p()
            saved.append(got.cpu())
            if got.dtype == torch.bfloat16:
                ulps, moved = bf16_ulps(got, want)
                what = (f"{moved:.3e} of its bf16 elements differ, by at "
                        f"most {ulps:.3f} ulp")
            else:
                d = (got - want).abs()
                what = f"rel_err {(d.max() / want.abs().max()).item():.3e}"
            print(f"[precision] {root}: f32 {name}, 64 prompts, against its "
                  f"plain f32 version: {what}", flush=True)
        torch.save(saved, out)
        x = _inputs(torch, 1024, dtype=f32)
        for name, k in zip(LAUNCHES, _calls(dpr, x)):
            print(f"[time] {root}: f32 {name}, 1024 prompts: "
                  f"{time_ms(k):.3f} ms", flush=True)
        del x
        # B3 f32, whose walks these are, in its three modes
        from revisit_anything_tpu_torch.kernels.tail_compare import _args
        from revisit_anything_tpu_torch.ops import decode_fused as dfu
        args = _args(torch, torch.device("cuda"), 1024, 4096, 1, f32)
        for mode, kw in (("keys", {"emit_keys": True}),
                         ("probability", {"emit_keys": False}),
                         ("logits", {"mask_head": True, "content": 3136})):
            ms = time_ms(lambda: dfu.decode_tail_fused(*args, **kw))
            print(f"[time] {root}: f32 B3 {mode} mode, 1024 prompts: "
                  f"{ms:.3f} ms", flush=True)


def _compare_f32(other: Path) -> None:
    """The f32 forms of this checkout and ``other``, in turns."""
    import torch
    _OUT.mkdir(parents=True, exist_ok=True)
    roots = {"this": str(_ROOT), "other": str(other)}
    turns = ["other", "this", "this", "other"]
    for i, name in enumerate(turns):
        subprocess.run([sys.executable, __file__, "--f32-worker", roots[name],
                        str(_OUT / f"f32_{name}{i}.pt")], check=True)
    this, other = (torch.load(_OUT / f"f32_{n}{turns.index(n)}.pt")
                   for n in ("this", "other"))
    for name, a, b in zip(LAUNCHES, this, other):
        d = (a.float() - b.float()).abs()
        print(f"[compare] f32 {name}, 64 prompts, this against other: bit "
              f"for bit {torch.equal(a, b)}, moved "
              f"{(d > 0).float().mean():.4e} of its elements, max |diff| "
              f"{d.max():.3e} ({(d.max() / b.float().abs().max()):.3e} of "
              "the scale)", flush=True)


# The phase probe: the tile loop of each f32 walk with a clock64() stamp
# after each statement at the loop body's own depth, taken by lane 0 of
# every warp of the first CTA on tiles 1..PHASE_TILES into rat_stamps
# [tile][statement][warp]. _LOOPS: (file, the loop's header, its tile
# index), the f32 walk's own first (walk_f32.cuh), then the loops of the
# design before it (t2i_probs.cu, i2t_probs.cu), which a checkout without
# walk_f32.cuh stamps; the first found is stamped.
PHASE_TILES = 8
_LOOPS = (("walk_f32.cuh", "  for (int i = wg; i < tiles; i += 2) {\n", "i"),
          ("t2i_probs.cu", "  for (int i = 0; i < tiles; ++i) {\n", "i"),
          ("i2t_probs.cu", "  for (int i = t0; i < t_end; ++i) {\n", "i"))


def _stamp_line(idx: str) -> str:
    """The stamp after each statement of a walk's loop (tile index
    ``idx``) into rat_stamps [tile][statement][warp]."""
    from revisit_anything_tpu_torch.kernels import stamps
    return stamps.stamp(idx, PHASE_TILES, "rat_stamps", 64, 16)


def _stamp(text: str, header: str, idx: str) -> tuple:
    """``text`` with its loop at ``header`` stamped, and the statements."""
    from revisit_anything_tpu_torch.kernels import stamps
    return stamps.stamp_loop(text, text.rindex(header) + len(header),
                             _stamp_line(idx))


def _phase_build(root: Path, out: Path, cu: str) -> tuple:
    """The checkout's csrc with the tile loop of ``cu``'s walk stamped,
    its nvcc started into ``out``; (process, statements, header)."""
    import shutil

    from revisit_anything_tpu_torch.kernels import build
    csrc = root / "revisit_anything_tpu_torch" / "kernels" / "csrc"
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(csrc, out)
    n = PHASE_TILES * 64 * 16
    for f, header, idx in _LOOPS:
        text = (out / f).read_text() if (out / f).exists() else ""
        if header in text and (f == cu or f"#include \"{f}\"" in
                               (out / cu).read_text()):
            text, labels = _stamp(text, header, idx)
            (out / f).write_text(f"__device__ long long rat_stamps[{n}];\n"
                                 + text)
            break
    else:
        raise ValueError(f"{cu}: no tile loop of {[h for _, h, _ in _LOOPS]}")
    with open(out / cu, "a") as fh:
        fh.write('\nextern "C" int rat_read_stamps(void* dst) {\n'
                 "  return (int)cudaMemcpyFromSymbol(dst, rat_stamps, "
                 "sizeof(rat_stamps));\n}\n")
    proc = subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-shared",
                             "-o", str(out / "probe.so"), str(out / cu)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, labels, f"{f} `{header.strip()}`"


def _phase_load(out: Path, proc):
    """The stamped library once its nvcc has ended."""
    import ctypes

    from revisit_anything_tpu_torch.kernels import build
    log = proc.communicate()[0]
    if proc.returncode:
        raise RuntimeError(f"{out.name}: nvcc failed\n{log}")
    lib = ctypes.CDLL(str(out / "probe.so"))
    for entry in ("rat_i2t_probs_f32", "rat_t2i_probs_f32"):
        if hasattr(lib, entry):
            getattr(lib, entry).argtypes = list(build.SIGNATURES[entry])
            getattr(lib, entry).restype = ctypes.c_int
    lib.rat_read_stamps.argtypes = [ctypes.c_void_p]
    return lib


def _phases_f32(root: Path) -> dict:
    """Each f32 walk's statements with their cycles a tile (see the
    module's note); returns each walk's cycles a tile in all."""
    import torch

    from revisit_anything_tpu_torch.kernels.tail_variants import _Launch
    from revisit_anything_tpu_torch.ops import decode_probs as dpr
    x = _inputs(torch, 1024, dtype=torch.float32)
    calls = _calls(dpr, x)
    walks = (("B8 f32 depth 1", "t2i_probs.cu", "T2I_PROBS_F32",
              "rat_t2i_probs_f32", calls[2]),
             ("B8 f32 depth 2", "t2i_probs.cu", "T2I_PROBS_F32",
              "rat_t2i_probs_f32", calls[3]),
             ("B7 f32 layer 2", "i2t_probs.cu", "I2T_PROBS_F32",
              "rat_i2t_probs_f32", calls[1]))
    builds = {cu: (_OUT / f"phases_{cu[:-3]}",) + _phase_build(
        root, _OUT / f"phases_{cu[:-3]}", cu) for cu in ("t2i_probs.cu",
                                                          "i2t_probs.cu")}
    libs = {cu: (_phase_load(out, proc), labels, header)
            for cu, (out, proc, labels, header) in builds.items()}
    totals = {}
    for name, cu, handle, entry, call in walks:
        lib, labels, header = libs[cu]
        buf = torch.zeros((PHASE_TILES, 64, 16), dtype=torch.int64)
        kernel = getattr(dpr, handle)
        setattr(dpr, handle, _Launch(getattr(lib, entry)))
        try:
            with torch.inference_mode():
                call()
            torch.cuda.synchronize()
        finally:
            setattr(dpr, handle, kernel)
        if lib.rat_read_stamps(buf.data_ptr()):
            raise RuntimeError("reading the stamps failed")
        st = buf[:, :len(labels) + 1].double()
        ran = (st[:, 0] > 0)                       # [tile, warp]
        d = st[:, 1:] - st[:, :-1]
        total = 0.0
        print(f"[phases] {name} ({root.name}), the loop at {header}: cycles "
              "a tile, 1024 prompts x M 4096", flush=True)
        for k, label in enumerate(labels):
            per_tile = [d[t, k][ran[t]].mean().item()
                        for t in range(PHASE_TILES) if ran[t].any()]
            top = [d[t, k][ran[t]].max().item()
                   for t in range(PHASE_TILES) if ran[t].any()]
            mean = statistics.median(per_tile)
            total += mean
            print(f"[phases] {mean:8.0f} mean {statistics.median(top):8.0f} "
                  f"max  {label}", flush=True)
        print(f"[phases] {total:8.0f} cycles a tile in all ({name}; warps "
              f"a tile: {int(ran.sum(1).median())})", flush=True)
        totals[name] = total
    return totals


# The settings the f32 walk was chosen from: (name, [(old line, new line)])
# on walk_f32.cuh. NP / MP: n8 tiles of the rebuild and m16 tiles of the
# scores side by side (KIND ATTEND is B8 f32, ATTEND_KEYS B3 f32's final
# walk, PROBS B7 f32); SPLIT: the context's rows 32-55 in shared memory at
# depth 1.
_KNOB = ("  constexpr int NP = KIND == ATTEND_KEYS ? 2 : 1, "
         "MP = KIND == ATTEND ? 2 : 1;\n")
_SPLIT = "  static constexpr bool SPLIT = KIND == ATTEND && DEPTH == 1;\n"
WALK_VARIANTS = {
    "as built": [],
    "B8 MP 1": [(_KNOB, _KNOB.replace("KIND == ATTEND ? 2 : 1", "1"))],
    "B8 NP 2": [(_KNOB, _KNOB.replace("KIND == ATTEND_KEYS ? 2 : 1",
                                      "KIND == PROBS ? 1 : 2"))],
    "B7 NP, MP 2": [(_KNOB, _KNOB.replace("KIND == ATTEND_KEYS ? 2 : 1",
                                          "KIND == ATTEND ? 1 : 2").replace(
        "KIND == ATTEND ? 2 : 1", "KIND == ATTEND_KEYS ? 1 : 2"))],
    "no SPLIT": [(_SPLIT, "  static constexpr bool SPLIT = false;\n"),
                 ("Smem<1, ATTEND>::TOTAL == 216576",
                  "Smem<1, ATTEND>::TOTAL == 167424")],
}


def _patched(text: str, reps) -> str:
    """``text`` with each (old, new) of ``reps`` replaced."""
    for old, new in reps:
        if old not in text:
            raise ValueError(f"variant patch does not apply: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def _variants_f32() -> None:
    """The f32 walks as built against ``WALK_VARIANTS`` (module note)."""
    import ctypes
    import re
    import shutil

    import torch

    from revisit_anything_tpu_torch.kernels import build
    from revisit_anything_tpu_torch.kernels.tail_variants import _Launch
    from revisit_anything_tpu_torch.kernels.winattn_variants import time_ms
    from revisit_anything_tpu_torch.ops import decode_probs as dpr
    text = (build._CSRC / "walk_f32.cuh").read_text()
    procs = {}
    for i, (name, reps) in enumerate(WALK_VARIANTS.items()):
        out = _OUT / f"variant{i}"
        shutil.rmtree(out, ignore_errors=True)
        shutil.copytree(build._CSRC, out)
        (out / "walk_f32.cuh").write_text(_patched(text, reps))
        procs[name] = (out, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o",
             str(out / "v.so"), str(out / "t2i_probs.cu"),
             str(out / "i2t_probs.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        for blk in log.split("Compiling entry function ")[1:]:
            kernel = re.search(r"walk_f32_kernelILi(\d)ELi(\d)E", blk)
            if kernel and "Used" in blk:
                regs = re.search(r"Used (\d+) registers", blk).group(1)
                spill = re.search(r"(\d+) bytes spill stores", blk).group(1)
                print(f"[variant] {name}: walk_f32_kernel<{kernel[1]}, "
                      f"{kernel[2]}> {regs} registers, {spill} B spilled",
                      flush=True)
        lib = ctypes.CDLL(str(out / "v.so"))
        for entry in ("rat_i2t_probs_f32", "rat_t2i_probs_f32"):
            getattr(lib, entry).argtypes = list(build.SIGNATURES[entry])
            getattr(lib, entry).restype = ctypes.c_int
        libs[name] = lib
    x = _inputs(torch, 1024, dtype=torch.float32)
    calls = _calls(dpr, x)
    walks = (("B7 f32 layer 2", "I2T_PROBS_F32", "rat_i2t_probs_f32", 1),
             ("B8 f32 depth 1", "T2I_PROBS_F32", "rat_t2i_probs_f32", 2),
             ("B8 f32 depth 2", "T2I_PROBS_F32", "rat_t2i_probs_f32", 3))
    names = list(libs)
    with torch.inference_mode():
        for walk, handle, entry, i in walks:
            times, outs = {n: [] for n in names}, {}
            for turn in range(4):
                for n in names if turn % 2 == 0 else names[::-1]:
                    kernel = getattr(dpr, handle)
                    setattr(dpr, handle, _Launch(getattr(libs[n], entry)))
                    try:
                        times[n].append(time_ms(calls[i]))
                        if turn == 0:
                            outs[n] = calls[i]()[:64].clone()
                    finally:
                        setattr(dpr, handle, kernel)
            print(f"[variant] {walk}, 1024 prompts (ms, the median of 4 "
                  "turns; bit for bit the built one's): " + ", ".join(
                      f"{n} {statistics.median(t):.3f} "
                      f"{torch.equal(outs[n], outs[names[0]])}"
                      for n, t in times.items()), flush=True)


def _fixed_f32() -> None:
    """Each f32 walk at 1024 prompts x M 4096 and x M 32 (one tile a
    warpgroup): the share of its time that the work outside the tile loop
    (C's planes, Q^, the merge and the value projection) takes."""
    import torch

    from revisit_anything_tpu_torch.kernels.winattn_variants import time_ms
    from revisit_anything_tpu_torch.ops import decode_probs as dpr
    times = {}
    with torch.inference_mode():
        for m in (4096, 32):
            calls = _calls(dpr, _inputs(torch, 1024, dtype=torch.float32,
                                        m=m))
            for name, i in (("B7 f32 layer 2", 1), ("B8 f32 depth 1", 2),
                            ("B8 f32 depth 2", 3)):
                times.setdefault(name, {})[m] = time_ms(calls[i])
            del calls
            torch.cuda.empty_cache()
    for name, t in times.items():
        print(f"[fixed] {name}, 1024 prompts: M 32 {t[32]:.3f} ms, M 4096 "
              f"{t[4096]:.3f} ms: outside the tile loop (and a tile a "
              f"warpgroup) {t[32] / t[4096]:.3f} of the call", flush=True)


def _parts_f32() -> None:
    """B3 f32's kernels by device time under torch.profiler, each mode at
    1024 prompts x M 4096 (logits at content 3136)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from revisit_anything_tpu_torch.kernels.tail_compare import _args
    from revisit_anything_tpu_torch.ops import decode_fused as dfu
    dev = torch.device("cuda")
    args = _args(torch, dev, 1024, 4096, 1, torch.float32)
    kws = {"keys": {"emit_keys": True}, "probability": {"emit_keys": False},
           "logits": {"mask_head": True, "content": 3136}}
    reps = 3
    for mode, kw in kws.items():
        with torch.inference_mode():
            dfu.decode_tail_fused(*args, **kw)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    dfu.decode_tail_fused(*args, **kw)
                torch.cuda.synchronize()
        rows = []
        for ev in prof.key_averages():
            t = getattr(ev, "device_time_total", None)
            if t is None:
                t = getattr(ev, "cuda_time_total", 0.0)
            if t > 0 and ev.count >= reps and ("kernel" in ev.key or
                                              "Kernel" in ev.key):
                rows.append((t / reps / 1e3, ev.key))
        if not rows:
            print(f"[parts] B3 f32 {mode} mode: no device time in the "
                  "profile (not measured)", flush=True)
            continue
        total = sum(t for t, _ in rows)
        print(f"[parts] B3 f32 {mode} mode, 1024 prompts: {total:.3f} ms of "
              "kernels a call (torch.profiler, mean of 3)", flush=True)
        for t, key in sorted(rows, reverse=True):
            print(f"[parts] {t:8.3f} ms  {key[:110]}", flush=True)


def main() -> None:
    import torch
    args = sys.argv[1:]
    if args[:1] == ["--f32"]:
        if not torch.cuda.is_available():
            sys.exit("probs_compare: needs a CUDA device")
        if args[1:2] == ["--phases"] and len(args) <= 3:
            root = Path(args[2]).resolve() if len(args) == 3 else _ROOT
            if root != _ROOT:          # the other checkout's package
                subprocess.run([sys.executable, __file__, "--phases-worker",
                                str(root)], check=True)
                return
            _phases_f32(root)
            _fixed_f32()
            _parts_f32()
            return
        if args[1:] == ["--variants"]:
            _variants_f32()
            return
        if len(args) == 2:
            _compare_f32(Path(args[1]).resolve())
            return
        if len(args) == 1:
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
    elif sys.argv[1:2] == ["--f32-worker"]:
        _f32_worker(*sys.argv[2:4])
    elif sys.argv[1:2] == ["--phases-worker"]:
        sys.path[0] = sys.argv[2]
        _phases_f32(Path(sys.argv[2]))
        _fixed_f32()
        _parts_f32()
    else:
        main()
