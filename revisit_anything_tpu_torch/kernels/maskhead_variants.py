"""Time source-level variants of the fused mask head (K3) and of its
probability form (B6) on the card, to see whether the tensor cores, the
epilogue, the keys ring or B6's branch rebuild sets the pace: each
variant is ``mask_head.cu`` with a few lines replaced (all but the first
of each table no longer compute the right answer: they remove one part
of the work to show what it costs), built by its own nvcc into
``build/torch_kernels/variants/`` and timed at the serving shape and on
one work item alone.

    python -m revisit_anything_tpu_torch.kernels.maskhead_variants
    python -m revisit_anything_tpu_torch.kernels.maskhead_variants --f32
    python -m revisit_anything_tpu_torch.kernels.maskhead_variants --probs-f32

With ``--f32`` the variants are of K3's f32 form (``rat_mask_head_f32``:
split-TF32 products, the keys loads, the weight ring, the group LN, the
exact GELU and the logits stores, each removed in turn), held to the plain
version in f32 with TF32 off. With ``--probs-f32`` they are of B6's f32
form (``rat_mask_head_probs_f32``: the rebuild or the head removed; the
rebuild's C chunks, P copies, products or splits removed, with and
without the head; the rebuild run twice, its loops unrolled, two ring
stages given to it), held to the kernel's own output,
followed by the count of its local-memory instructions from the SASS and
whether each lies nearer the rebuild's products (HMMA) or the head's
(HGMMA).

Times are CUDA-event medians of 11 calls, each queued behind a device
sleep (as ``chip_smoke.py`` times kernels). Needs a CUDA device and
nvcc; prints one line per kernel and shape. K3's variants are held to
the plain version, B6's to the B6 kernel's own output (its plain version
does not fit the card at 1024 prompts).
"""

from __future__ import annotations

import collections
import ctypes
import statistics
import subprocess
import sys

import torch

from revisit_anything_tpu_torch.kernels import build
from revisit_anything_tpu_torch.kernels.winattn_variants import time_ms
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

# B6: the rebuild's loads (C, and P into the staging tile) and its
# products and LayerNorms
_LOAD_C = "    mbar_expect_tx(full(wg), LAYER_TX);"
_LOAD_P = ("    tma_load_3d(sst, tp, (item % tiles) * BP, 0, item / tiles, "
           "full(wg));")
_RECON = "      issue_recon(r, sst, sx);"
_LN1 = ("      branch_ln<true>(r, rows + D, rows + 2 * D, rows + 3 * D, c, "
        "ln_eps);")
_LN2 = ("      branch_ln<false>(r, rows + 4 * D, rows + 5 * D, nullptr, c, "
        "ln_eps);")
_NO_HEAD = [(_EP1, _NO_EP1), (_EP2, _NO_EP2), (_MMA1, _NO_MMA1),
            (_MMA2, _NO_MMA2)]

# name -> (what it shows, [(old text, new text), ...])
PROBS_VARIANTS = {
    "kernel": ("the kernel as built", []),
    "norebuild": ("rebuild removed: keys = img0 rows + b1 copied to the "
                  "slot (no P or C loads, products or LayerNorms)",
                  [(_LOAD_C, "    mbar_arrive(full(wg));\n    return;"),
                   (_LOAD_P, ""),
                   (_RECON, "      fence_regs(r[0]);"), (_LN1, ""),
                   (_LN2, "")]),
    "nohead": ("head removed: the rebuild, hyper rows and logit stores "
               "only", _NO_HEAD),
    "noturns": ("the two warpgroups issue their products without taking "
                "turns", [("constexpr bool TURNS = true;",
                           "constexpr bool TURNS = false;")]),
}

# K3 f32 (rat_mask_head_f32): the keys loads, the weight ring's refills,
# the group LN, the GELUs and the logits stores, each removed
_F32_GELU = ("  return x * 0.5f * (1.f + erff(x * 0.70710678118654752f));",
             "  return x;")
_F32_LN = [("    mu[rr] *= 1.f / C1;", "    mu[rr] = 0.f;"),
           ("    rs[rr] = rsqrtf(rs[rr] * (1.f / C1) + eps);", "    rs[rr] = 1.f;")]
_F32_STORES = ("    for (int i = ctid; i < n16; i += 128) dst4[i] = src4[i];\n", "")
_F32_LOAD = [("const bool v0 = row0 < nrows, v8 = row0 + 8 < nrows;",
              "const bool v0 = false, v8 = false;")]
_F32_RESIDENT = [
    ("auto stage_wait = [&](int st) { mbar_wait(full(st % RING), (st / RING) & 1); };",
     "auto stage_wait = [&](int st) { if (st < RING) mbar_wait(full(st % RING), 0); };"),
    ("        fill(st + RING);\n", "")]
_F32_ENTRY = "  extern __shared__ uint8_t smem_k3f[];"
_F32_NOTURNS = [("  if (wg == 1) named_arrive(3, 256);\n  auto take_turn",
                 "  auto take_turn"),
                ("  auto take_turn = [&]() { named_sync(my_turn, 256); };",
                 "  auto take_turn = [&]() {};"),
                ("    if (!(wg == 1 && last)) named_arrive(other_turn, 256);",
                 "    (void)last;")]

F32_VARIANTS = {
    "kernel": ("the kernel as built", []),
    "nogelu": ("no GELU (h = its argument)", [_F32_GELU]),
    "nolayernorm": ("no group LN statistics or normalization (h1 = "
                    "GELU(y1 · s + b))", _F32_LN),
    "nostores": ("no logits stores", [_F32_STORES]),
    "noload": ("the keys read as zeros (no keys loads)", _F32_LOAD),
    "resident": ("the weight ring filled once and never refilled (no L2 "
                 "weight reads after the first four stages)", _F32_RESIDENT),
    "productsonly": ("the products alone: weights resident, no keys loads, "
                     "no group LN, no GELU, no logits stores",
                     [_F32_GELU, *_F32_LN, _F32_STORES, *_F32_LOAD,
                      *_F32_RESIDENT]),
    "noturns": ("the two warpgroups issue their products without taking "
                "turns", _F32_NOTURNS),
    "erfcgelu": ("GELU as x/2·erfc(-x/√2) (erfcf) in place of erff's form",
                 [(_F32_GELU[0],
                   "  return 0.5f * x * erfcf(-0.70710678118654752f * x);")]),
    "empty": ("the weight split, then the head returns at entry",
              [(_F32_ENTRY, "  if (total > 0) return;\n" + _F32_ENTRY)]),
}

# B6 f32 (rat_mask_head_probs_f32): the rebuild, the head, and the
# rebuild's C chunks, P copies, products and splits, each removed
_F32_RB = ("        rebuild_keys(rc.img0, rc.p1, rc.p2, rc.c1, rc.c2, rc.rows, rc.ln_eps, kt, "
           "n, p0, row0,\n"
           "                     gg, g, c, ctid, bar, sm + OFF_STG + wg * STG, "
           "base + OFF_STG + wg * STG,\n"
           "                     sm + off_c + wg * per_wg, base + off_c + wg * per_wg);\n")
_F32_PAIRS = "    for (int pr = 0; pr < 2; ++pr) {"
_F32_FILL = ("    mbar_expect_tx(full(st % RING), STAGE);\n"
             "    tma_load_3d(dst, &tw1, k0, n0, 0, full(st % RING));\n"
             "    tma_load_3d(dst + BOX, &tw1, k0, n0, 1, full(st % RING));\n")
_F32_CHUNK = ("    cp_async16(dst + (r * CW + (col ^ ((r & 2) << 2))) * 4, "
              "cm + r * D + CW * q + col);")
_F32_MMA = ("        mma_m16n8k8_tf32(lo[u], a[ks % 2], l0, l1);\n"
            "        mma_m16n8k8_tf32(hi[u], a[ks % 2], h0, h1);\n")
# the products replaced by one add a k-step, which keeps their operands live
_F32_NO_MMA = ("        lo[u][ks % 4] += __uint_as_float(l0 ^ l1 ^ a[ks % 2][0]);\n"
               "        hi[u][ks % 4] += __uint_as_float(h0 ^ h1 ^ a[ks % 2][3]);\n")
_F32_SPLIT = [("        split_tf32_bits(b[ks % 2][u][0], h0, l0);\n"
               "        split_tf32_bits(b[ks % 2][u][1], h1, l1);\n",
               "        h0 = __float_as_uint(b[ks % 2][u][0]), l0 = 0u;\n"
               "        h1 = __float_as_uint(b[ks % 2][u][1]), l1 = 0u;\n")]
_F32_NOHEAD = [(_F32_PAIRS, "    for (int pr = 0; pr < 0; ++pr) {"),
               (_F32_FILL, ""),
               ("  if (wg == 1) named_arrive(3, 256);\n  auto take_turn",
                "  auto take_turn")]
_F32_P = [("  load_p(ssp, p1 + (size_t)n * HT * gg, p0, gg, ctid);\n"
           "  load_p(ssp + OFF_P2, p2 + (size_t)n * HT * gg, p0, gg, ctid);\n", "")]

PROBS_F32_VARIANTS = {
    "kernel": ("the kernel as built", []),
    "norebuild": ("rebuild removed: the head reads the keys tile as left",
                  [(_F32_RB, "")]),
    "nohead": ("head removed: the rebuild, hyper rows and logit copy-out "
               "only (no weight ring, keys loads, products, epilogues or "
               "turns)", _F32_NOHEAD),
    "nohead_nochunks": ("head removed, and the rebuild's C chunks not copied",
                        _F32_NOHEAD + [(_F32_CHUNK, "")]),
    "nohead_noproducts": ("head removed, and the rebuild's mma.sync removed",
                          _F32_NOHEAD + [(_F32_MMA, _F32_NO_MMA)]),
    "nohead_nosplit": ("head removed, and C not split", _F32_NOHEAD + _F32_SPLIT),
    "nohead_nop": ("head removed, and P not copied", _F32_NOHEAD + _F32_P),
    "nochunks": ("the rebuild's C chunks not copied (its products read the "
                 "staging tile as left)", [(_F32_CHUNK, "")]),
    "noproducts": ("the rebuild's mma.sync removed", [(_F32_MMA, _F32_NO_MMA)]),
    "nosplit": ("C not split (its hi plane the raw f32 bits, lo zero)",
                _F32_SPLIT),
    "twice": ("the rebuild run twice an item", [(_F32_RB, _F32_RB + _F32_RB)]),
    "unrolled": ("the rebuild's group and chunk loops unrolled (~16 times "
                 "their code)",
                 [("#pragma unroll 1\n    for (int q = 0; q < 4; ++q) {\n      recon_group",
                   "#pragma unroll\n    for (int q = 0; q < 4; ++q) {\n      recon_group"),
                  ("#pragma unroll 1\n  for (int i = 0; i < 4; ++i) {",
                   "#pragma unroll\n  for (int i = 0; i < 4; ++i) {")]),
    "free2": ("two ring stages given to the rebuild (a 2-stage ring, 8 C "
              "buffers)", [("constexpr int FREE = 1; ", "constexpr int FREE = 2; "),
                           ("constexpr int NBUF = 4;", "constexpr int NBUF = 8;")]),
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


_ENTRIES = {"maskhead": "rat_mask_head", "maskprobs": "rat_mask_head_probs",
            "maskf32": "rat_mask_head_f32",
            "probsf32": "rat_mask_head_probs_f32"}


def _build_all(tables=(("maskhead", VARIANTS),
                       ("maskprobs", PROBS_VARIANTS))) -> dict:
    """The variants of each (tag, table), one nvcc each, all started
    together: {tag: {name: its entry point}}."""
    _OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for tag, table in tables:
        for name, (_, reps) in table.items():
            cu = _OUT / f"{tag}_{name}.cu"
            cu.write_text(_source(reps))
            procs[tag, name] = subprocess.Popen(
                [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build._CSRC),
                 "-shared", "-o", str(_OUT / f"{tag}_{name}.so"), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {tag: {} for tag, _ in tables}
    for (tag, name), proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{tag} {name}: nvcc failed\n{log}")
        entry = _ENTRIES[tag]
        fn = getattr(ctypes.CDLL(str(_OUT / f"{tag}_{name}.so")), entry)
        fn.argtypes = list(build.SIGNATURES[entry])
        fn.restype = ctypes.c_int
        fns[tag][name] = fn
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


def _run(fns: dict, call_args, out, want) -> list:
    """Time each variant on the same arguments; its relative error
    against ``want`` and, at more than one prompt, the clock and power."""
    stream = torch.cuda.current_stream().cuda_stream
    parts = []
    for name, fn in fns.items():
        out.zero_()

        def call(fn=fn):
            err = fn(*call_args, stream)
            if err:
                raise RuntimeError(f"launch failed: cudaError {err}")
        ms = time_ms(call)
        if want is None:
            want = out.float().clone()
        rel = ((out.float() - want).abs().max() / want.abs().max()).item()
        clock = _clock(call) if out.shape[0] > 1 else ""
        parts.append(f"{name} {ms * 1e3:.1f} us (rel_err {rel:.1e}{clock})")
    return parts


def main_f32(dev) -> None:
    """K3 f32's variants at the serving shape and on one unit alone, each
    held to the plain version in f32 with TF32 off."""
    fns = _build_all((("maskf32", F32_VARIANTS),))["maskf32"]
    for name, (what, _) in F32_VARIANTS.items():
        print(f"[variant] K3 f32 {name}: {what}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape, s=1.0, off=0.0):
        return torch.randn(shape, generator=g, device=dev) * s + off

    scratch = torch.empty(mh.mask_head_f32_scratch(), device=dev)
    for np_, gg, content, m in ((1024, 4096, 3136, 3), (1, 128, 128, 3)):
        head = (rnd(256, 256, s=0.1), rnd(64, s=0.1), rnd(64, s=0.1, off=1.0),
                rnd(64, s=0.1), rnd(64, 128, s=0.1), rnd(32, s=0.1))
        keys, hyper = rnd(np_, gg, 256), rnd(np_, m, 32, s=0.5)
        want = mh.upscale_masks_blocks(keys[:, :content], hyper, *head,
                                       eps=1e-6)
        out = torch.empty((np_, content, 16, m), device=dev)
        ptrs = (keys,) + head + (hyper, out, scratch)    # the C argument order
        parts = _run(fns, [a.data_ptr() for a in ptrs] + [
            np_, gg, content, m, 1e-6], out, want)
        print(f"[variants] K3 f32 keys [{np_},{gg},256] content {content} M "
              f"{m}: {'; '.join(parts)}", flush=True)
        del keys, want, out


def main_probs_f32(dev) -> None:
    """B6 f32's variants at the serving shape and on one unit alone, each
    held to the kernel's own output; then the registers, spills and
    local-memory instructions of the kernel as built (cuobjdump)."""
    fns = _build_all((("probsf32", PROBS_F32_VARIANTS),))["probsf32"]
    for name, (what, _) in PROBS_F32_VARIANTS.items():
        print(f"[variant] B6 f32 {name}: {what}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape, s=1.0, off=0.0):
        return torch.randn(shape, generator=g, device=dev) * s + off

    def probs(np_, gg):
        x = torch.randn((np_, 8, 7, gg), generator=g, device=dev) * 2.0
        return torch.softmax(x, dim=2).reshape(np_, 56, gg).to(torch.bfloat16)

    n_ctas = torch.cuda.get_device_properties(dev).multi_processor_count
    scratch = torch.empty(mh.mask_head_probs_f32_scratch(n_ctas), device=dev)
    for np_, gg, content, m in ((1024, 4096, 3136, 3), (1, 64, 64, 3)):
        head = (rnd(256, 256, s=0.1), rnd(64, s=0.1), rnd(64, s=0.1, off=1.0),
                rnd(64, s=0.1), rnd(64, 128, s=0.1), rnd(32, s=0.1))
        rows = torch.zeros((8, 256), device=dev)
        rows[[1, 4]] = 1.0
        rows = rows + rnd(8, 256, s=0.1)
        ins = (rnd(1, gg, 256), probs(np_, gg), rnd(np_, 56, 256, s=0.3),
               probs(np_, gg), rnd(np_, 56, 256, s=0.3), rows) + head + (
                   rnd(np_, m, 32, s=0.5),)
        out = torch.empty((np_, content, 16, m), device=dev)
        parts = _run(fns, [a.data_ptr() for a in ins] + [
            out.data_ptr(), scratch.data_ptr(), np_, gg, content, m, 1e-6,
            1e-6, n_ctas], out, None)
        print(f"[variants] B6 f32 P [{np_},56,{gg}] content {content} M {m}: "
              f"{'; '.join(parts)}", flush=True)
        del ins, out
    import re
    import shutil
    build.load()
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(build.library_path())],
                          capture_output=True, text=True, check=True).stdout
    for f in sass.split("Function : ")[1:]:
        if "mask_head_tf32x3_kernelILi3E" not in f.split("\n", 1)[0]:
            continue
        lines = f.splitlines()
        local = [i for i, ln in enumerate(lines) if re.search(r"\b(STL|LDL)", ln)]
        print(f"[sass] {lines[0][:70]}: {len(lines)} lines, "
              f"{len(local)} local-memory instructions", flush=True)
        # where each lies: nearer an HMMA (the rebuild) or an HGMMA (the head)
        mma = {k: [i for i, ln in enumerate(lines) if re.search(k, ln)]
               for k in (r"\bHMMA", r"\bHGMMA")}
        near = collections.Counter(
            min(mma, key=lambda k: min((abs(i - j) for j in mma[k]),
                                       default=1 << 30)) for i in local)
        print(f"[local] nearest tensor instruction: {dict(near)}", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("maskhead_variants: needs a CUDA device")
    dev = torch.device("cuda")
    if "--f32" in sys.argv[1:]:
        main_f32(dev)
        return
    if "--probs-f32" in sys.argv[1:]:
        main_probs_f32(dev)
        return
    fns = _build_all()
    fns, probs_fns = fns["maskhead"], fns["maskprobs"]
    for name, (what, _) in VARIANTS.items():
        print(f"[variant] K3 {name}: {what}", flush=True)
    for name, (what, _) in PROBS_VARIANTS.items():
        print(f"[variant] B6 {name}: {what}", flush=True)
    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16

    def rnd(*shape, s=1.0, off=0.0):
        return (torch.randn(shape, generator=g, device=dev) * s + off).to(bf)

    def probs(np_, gg):
        x = torch.randn((np_, 8, 7, gg), generator=g, device=dev) * 2.0
        return torch.softmax(x, dim=2).reshape(np_, 56, gg).to(bf)

    n_ctas = torch.cuda.get_device_properties(dev).multi_processor_count
    for np_, gg, content, m in SHAPES:
        head = (rnd(256, 256, s=0.1), rnd(64, s=0.1), rnd(64, s=0.1, off=1.0),
                rnd(64, s=0.1), rnd(64, 128, s=0.1), rnd(32, s=0.1))
        keys, hyper = rnd(np_, gg, 256), rnd(np_, m, 32, s=0.5)
        want = mh.upscale_masks_blocks(keys[:, :content], hyper, *head,
                                       eps=1e-6).float()
        out = torch.empty((np_, content, 16, m), dtype=bf, device=dev)
        ptrs = (keys,) + head + (hyper,)                # the C argument order
        parts = _run(fns, [a.data_ptr() for a in ptrs] + [
            out.data_ptr(), np_, gg, content, m, 1e-6, n_ctas], out, want)
        print(f"[variants] K3 keys [{np_},{gg},256] content {content} M {m}: "
              f"{'; '.join(parts)}", flush=True)
        del keys, want
        rows = torch.zeros((8, 256), device=dev)
        rows[[1, 4]] = 1.0
        rows = (rows + torch.randn((8, 256), generator=g, device=dev) * 0.1
                ).to(bf)
        ins = (rnd(1, gg, 256), probs(np_, gg), rnd(np_, 56, 256, s=0.3),
               probs(np_, gg), rnd(np_, 56, 256, s=0.3), rows) + head + (
                   hyper,)
        parts = _run(probs_fns, [a.data_ptr() for a in ins] + [
            out.data_ptr(), np_, gg, content, m, 1e-6, 1e-6, n_ctas], out,
            None)
        print(f"[variants] B6 P [{np_},56,{gg}] content {content} M {m}: "
              f"{'; '.join(parts)}", flush=True)


if __name__ == "__main__":
    main()
