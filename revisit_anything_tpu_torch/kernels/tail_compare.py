"""Hold the fused decode tail (B3) of this checkout against another
checkout's on the card: the same seeded inputs through each checkout's
``decode_tail_fused`` in its three modes (140 prompts x M 4096, the
logits mode at content 3136), in bf16 and again in f32 (an f32 decoder
and activations: B3 f32), compared output by output (bit for bit, and
the share of elements that moved; an f32 mode that one checkout refuses
with ``ValueError`` is reported as missing there); then, in each checkout, the
probability and logits modes on the first 64 prompts against that
checkout's own plain version (the share of bf16 elements moved, as
``tail_variants`` ``[precision]``), and the probability mode on the gpu
test's large-branch inputs (16 prompts x M 256, both branch LayerNorm
scales x 2^15) against its plain version: each output's relative error
and the P2 elements moved by more than 0.25. The f32 modes are also held
to their plain versions on the first 64 prompts by their rule (``[f32
rule]``: the token state and C2 within F32_REL of their scale, keys2 and
the logits per position, TAIL_F32_MOVED's note, P1 and P2 within one
bf16 ulp in at most PROBS_F32_MOVED of their elements), and this
checkout's f32 outputs against the other's by the same measures.

    python -m revisit_anything_tpu_torch.kernels.tail_compare OTHER_ROOT

Each checkout runs in its own process (the two packages share a name),
building its own kernels; outputs go to ``build/tail_compare/`` at this
checkout's root. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[2]
_OUT = _ROOT / "build" / "tail_compare"
MODES = ("keys", "probs", "logits")

# B3 f32 against its plain version in f32 (TF32 off), the criterion of
# the gpu tests and chip_smoke.py: P1 and P2 are bf16 in both. P1 comes
# out bit for bit (its scores see no token state); where the token
# state's f32 reassociation (~1e-6 of its scale) moves a P2 score across
# a bf16 rounding point, that probability rounds the other way (one bf16
# ulp) and P2^T C2 moves at its position alone, by at most 2^-9 max |C2|,
# which the branch LayerNorm carries to keys2 (and K3 to the logits).
# So keys2 and the logits are held per position: within the f32
# tolerance of their scale at all but TAIL_F32_MOVED of the positions,
# and within TAIL_F32_MOVED_REL of it at those. Both are ~2.5x and ~4x
# the largest readings on an H100 80GB HBM3 at 700 W over the gpu tests'
# eight cases (test_torch_kernels.py, `-s` prints them): 4.1e-3 to
# 7.8e-3 of the positions (7.8e-3 at M 96: 12 of 1,536), at most 4.8e-4
# of the scale.
TAIL_F32_MOVED = 2e-2
TAIL_F32_MOVED_REL = 2e-3
F32_REL = 1e-5            # the f32 kernels' tolerance (tests, chip_smoke.py)


def f32_rule(mode: str, i: int, got, want) -> tuple:
    """(what, within) of output ``i`` of B3 f32 in ``mode`` against
    ``want`` by its rule: P1 and P2 (bf16) in ulps, keys2 and the logits
    (output 1 of the keys and logits modes) per position, the rest
    relative to their scale."""
    from revisit_anything_tpu_torch.kernels.probs_compare import (
        PROBS_F32_MOVED, bf16_ulps)
    if got.dtype != want.dtype or got.shape != want.shape:
        return f"dtype or shape {got.dtype} {tuple(got.shape)}", False
    if got.dtype.is_floating_point and got.element_size() == 2:
        ulps, moved = bf16_ulps(got, want)
        return (f"{moved:.3e} of its bf16 elements moved, by at most "
                f"{ulps:.3f} ulp", ulps <= 1.0 and moved <= PROBS_F32_MOVED)
    if i == 1 and mode != "probs":
        moved, worst = moved_positions(got, want, got.dim() - 2, F32_REL)
        return (f"{moved:.3e} of its positions beyond {F32_REL:g} of the "
                f"scale, the largest {worst:.3e}",
                moved <= TAIL_F32_MOVED and worst <= TAIL_F32_MOVED_REL)
    rel = _rel(got, want)
    return f"rel_err {rel:.3e}", rel < F32_REL


def moved_positions(got, want, trailing: int, rel: float) -> tuple:
    """Per position (the max over the last ``trailing`` axes) the error of
    ``got`` relative to ``want``'s scale: (the share of positions beyond
    ``rel``, the largest)."""
    err = (got.float() - want.float()).abs() / want.float().abs().max()
    err = err.flatten(-trailing).amax(-1)
    return (err > rel).float().mean().item(), err.max().item()


def _decoder(torch, g, dev, dtype):
    """A SAM ViT-H mask decoder in ``dtype`` with seeded random weights
    (as the gpu tests' ``serving_decoder``)."""
    from revisit_anything_tpu_torch.models.sam import SAM_VIT_H
    from revisit_anything_tpu_torch.models.sam.decoder import MaskDecoder
    dec = MaskDecoder(SAM_VIT_H, dtype=dtype, device=dev)
    with torch.no_grad():
        for name, prm in dec.named_parameters():
            x = torch.randn(prm.shape, generator=g, device=dev) * 0.05
            prm.copy_(x + 1.0 if name.endswith("scale") else x)
    return dec


def _args(torch, dev, b, m, seed, dtype=None):
    dtype = dtype or torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(seed)
    dec = _decoder(torch, g, dev, dtype)

    def rnd(*shape, s=1.0):
        return (torch.randn(shape, generator=g, device=dev) * s).to(dtype)

    return (dec, rnd(1, m, 256), rnd(1, 128, m), rnd(1, 128, m),
            rnd(1, 128, m), rnd(1, 128, m), rnd(b, 7, 128),
            rnd(b, 56, 256, s=0.3), rnd(b, 7, 256), rnd(b, 7, 256), 8, 1e-6)


def _rel(a, w) -> float:
    d = (a.float() - w.float()).abs().max()
    return (d / w.float().abs().max()).item()


def _worker(root: str, out: str) -> None:
    """In the checkout at ``root``: the three modes' outputs in bf16 and
    in f32 to ``out``, and the large-branch probability case against its
    plain version."""
    sys.path[0] = root                 # in place of this script's directory
    import torch

    from revisit_anything_tpu_torch.ops import decode_fused as dfu
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(f"[compare] {root}: {dfu.__file__}", flush=True)
    args = _args(torch, dev, 140, 4096, 0)
    kws = ({"emit_keys": True}, {"emit_keys": False},
           {"mask_head": True, "content": 3136})
    with torch.inference_mode():
        res = {mode: [o.cpu() for o in dfu.decode_tail_fused(*args, **kw)]
               for mode, kw in zip(MODES, kws)}
    args32 = _args(torch, dev, 140, 4096, 1, torch.float32)
    few32 = tuple(a[:64] if i in (6, 7, 8, 9) else a
                  for i, a in enumerate(args32))
    for mode, kw in zip(MODES, kws):
        try:
            with torch.inference_mode():
                res[f"{mode} f32"] = [o.cpu() for o in
                                      dfu.decode_tail_fused(*args32, **kw)]
                got = dfu.decode_tail_fused(*few32, **kw)
                want = dfu.decode_tail_reference(*few32, **kw)
        except ValueError as err:
            print(f"[compare] {root}: {mode} mode f32 refused: {err}",
                  flush=True)
            continue
        for i, (a, w) in enumerate(zip(got, want)):
            what, ok = f32_rule(mode, i, a, w)
            print(f"[f32 rule] {root}: {mode} mode f32 output {i} against its "
                  f"plain version, 64 prompts: {what}; within its rule {ok}",
                  flush=True)
    del args32, few32
    torch.save(res, out)
    few = tuple(a[:64] if i in (6, 7, 8, 9) else a    # per-prompt operands
                for i, a in enumerate(args))
    for mode, kw in zip(MODES[1:], kws[1:]):
        with torch.inference_mode():
            got = dfu.decode_tail_fused(*few, **kw)
            want = dfu.decode_tail_reference(*few, **kw)
        moved = " ".join(f"{((a != w).float().mean()):.4f}"
                         for a, w in zip(got, want))
        print(f"[compare] {root}: {mode} mode against its plain version, 64 "
              f"prompts: share of bf16 elements moved by output {moved}",
              flush=True)
    args = _args(torch, dev, 16, 256, 7)
    with torch.no_grad():
        for layer in args[0].layers[:2]:
            layer.norm4.scale.mul_(32768.0)
    with torch.inference_mode():
        got = dfu.decode_tail_fused(*args, emit_keys=False)
        want = dfu.decode_tail_reference(*args, emit_keys=False)
    errs = " ".join(f"{_rel(a, w):.3e}" for a, w in zip(got, want))
    moved = int(((got[2].float() - want[2].float()).abs() > 0.25).sum())
    print(f"[compare] {root}: probability mode, both branch LayerNorm scales"
          f" x 2^15, against its plain version: rel_err by output {errs}; "
          f"P2 elements moved > 0.25: {moved} of {got[2].numel()}",
          flush=True)


def main() -> None:
    import torch
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    if not torch.cuda.is_available():
        sys.exit("tail_compare: needs a CUDA device")
    _OUT.mkdir(parents=True, exist_ok=True)
    roots = {"this": str(_ROOT), "other": str(Path(sys.argv[1]).resolve())}
    for name, root in roots.items():
        subprocess.run([sys.executable, __file__, "--worker", root,
                        str(_OUT / f"{name}.pt")], check=True)
    this, other = (torch.load(_OUT / f"{n}.pt") for n in roots)
    for mode in [*MODES, *(f"{mode} f32" for mode in MODES)]:
        if mode not in this or mode not in other:
            print(f"[compare] {mode} mode: missing in "
                  f"{[n for n, r in zip(roots, (this, other)) if mode not in r]}",
                  flush=True)
            continue
        for i, (a, b) in enumerate(zip(this[mode], other[mode])):
            d = (a.float() - b.float()).abs()
            rule = (f"; {f32_rule(mode.split()[0], i, a, b)[0]}"
                    if mode.endswith("f32") else "")
            print(f"[compare] {mode} mode output {i}: bit for bit "
                  f"{torch.equal(a, b)}, moved {(d > 0).float().mean():.4f} "
                  f"of its elements, max |diff| {d.max():.3e}{rule}",
                  flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        _worker(*sys.argv[2:4])
    else:
        main()
