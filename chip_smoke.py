"""Smoke run of the PyTorch/CUDA port on one GPU: build the kernels, hold
each against its plain PyTorch version at the serving path's shapes, then
serve full-width SegVLAD queries through the kernels over a live database
(inserts, removals, snapshots, pipelined and concurrent queries, the
streaming kNN), in each of the decoder's forms and with the encoder's
windowed layers either way, and load full-size checkpoints onto the card.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the twelve kernels from revisit_anything_tpu_torch/kernels/csrc
     (one nvcc per source, in parallel);
  3. print the registers, shared memory and spill bytes of the redesigned
     entry points' kernels (K1, K2, B10, B11, K3, B6, K5, K4, B3 in its
     three modes, B7 in its two layers and B8 at its two depths) from
     ptxas.log, and the HMMA instructions in the SASS of B3's three
     instantiations, B7's layer 2 and B8's two depths (cuobjdump);
     then
     compare every kernel with its plain version in bf16 at the main
     path's shapes (K1 also at the offline extraction's batches), timing both with CUDA events (median of 7 after
     warm-up, each call queued behind a device sleep so that its host
     launch cost is not timed), beside its bound (the larger of bytes /
     3.35 TB/s and operations / the H100's peak rate for their type:
     bf16 and TF32 products on the tensor cores, f32 on the FMA units),
     its bound share
     (bound / kernel time) and, where one PyTorch call computes the same
     function, that call's time and the kernel's time over it
     (× library);
  4. serve small inputs through the kernels on the card and through the
     plain versions on the CPU, from the same weights, with the
     "shared", "fused_tail_keys" and "fused_tail_logits" decoders and
     with the window kernel: the answers must agree;
  5. build a SegVLADServer at full width (SAM ViT-H, DINOv2 ViT-g/14 in
     bf16, random weights from a seed, SAM's made to segment a blob
     around each point prompt so AMG keeps many segments; 480x640
     queries, SAM at 240x320, 1024-prompt AMG, a 100k-segment /
     2000-image index made on the card, with room for 16 more images);
     [insert]: add two planted images and 14 more through
     add_reference_images in one chunk with the counters reset first:
     the "shared" kernels must launch, each planted image keep at least
     32 segment rows;
  6. answer 3 queries with every launch counter reset first; every kernel
     of the "shared" decoder must have launched, each planted image must
     come back first for a noisy copy of itself, and answers must be
     deterministic;
  7. time one query's stages with CUDA events (the split must give
     query()'s answer) and trace one query with torch.profiler for the
     device's busy time and its host-to-device copies (at most 2: the
     image and the adjacency); then profile one windowed encoder block
     by op, with plain and with kernel windows;
  8. serve one planted query with the encoder's windowed layers through
     the window kernel (B11) with the counters reset first: it must launch
     once per windowed layer (28), the planted image must come first;
     print the kept masks' agreement with plain windows and the encode
     stage either way (CUDA events, median of 7 each, in turns);
  9. serve one planted query through each probability-factored decoder
     form ("probs_split", "fused_tail_probs", "fused_tail_keys",
     "fused_tail_logits") with the counters reset first: its kernels must
     launch and no other decode kernel may, the planted image must come
     first, at least 32 masks kept; print its decode-stage time and its
     kept masks' agreement with "shared" ("fused_tail_logits" also with
     "fused_tail_keys"); for "probs_split" and each "fused_tail_*" form,
     the same query with the form's decode kernels' plain f32 versions in
     their place (B7 and B8; the decode tail), with the predicted IoU at
     the top-128 cut ([witness]);
 10. [insert], continued: remove planted image 1 (its noisy copy must no
     longer find it), snapshot the database to an npz and restore it
     into a fresh server: the same top-5 on the three queries;
 11. [pipeline]: 8 queries one after another, and through query_many with
     1-4 workers: equal answers; wall time, queries/s, device busy time
     and idle share (torch.profiler);
 12. [concurrent]: a restored server inserts 4 images on one thread while
     query_many answers the 8 queries: each answer is the one before or
     after the insert, and the new images are found first afterwards;
 13. [stream-knn]: one query's tail over a 600k-row bf16 database at PCA
     1024 (past the one-shot cap) by the streaming path and by the
     one-shot path with the cap raised: the same top-5, the planted
     image first; tail times and peak device memory;
 14. [offline]: the offline SegLoc pipeline on the same models at the
     17places size (48 database images, 16 noisy-copy queries): SAM masks
     (4 images an encode) and DINOv2-g features (8 a forward) with the
     counters reset first, a 32-cluster vocabulary, order-3 segment
     VLADs, a 1024-component PCA, SegLoc retrieval raw (Recall@1 must be
     1.0) and with the PCA, and AnyLoc's; images/s, seconds a stage,
     peak device memory; the queries' extraction traced again for the
     device's idle share; the first 4 images encoded together against
     one at a time (embeddings and masks); knn_l2 across tiles against
     one tile;
 15. [checkpoint]: a seeded original-layout SAM ViT-H state dict saved
     with torch.save and loaded by load_sam_checkpoint, a hub-layout
     DINOv2-g dict converted in memory, both onto the card in bf16 (load
     seconds, peak host RSS, device memory); leaves spot-checked against
     the dicts; one query through them with the "shared" kernels;
 16. print the kernel table as one JSON line (B10, token_cross_split, has
     no caller on a serving path, as in the JAX package: launches 0),
     then the result line.
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time


VARIANTS = ("probs_split", "fused_tail_probs", "fused_tail_keys",
            "fused_tail_logits")


def _paths() -> dict:
    """The kernels a served query launches in each decoder form (K1 runs
    the SAM encoder's global layers and DINOv2 in all of them), and with
    the window kernel ("shared" decoder)."""
    from revisit_anything_tpu_torch.kernels import build as k
    front = (k.FLASH_ATTENTION, k.TOKEN_CROSS, k.RESIZE_FLAGS)
    shared = front + (k.I2T_UPDATE, k.MASK_HEAD)
    return {"shared": shared,
            "probs_split": front + (k.I2T_PROBS, k.T2I_PROBS,
                                    k.MASK_HEAD_PROBS),
            "fused_tail_probs": front + (k.DECODE_TAIL, k.MASK_HEAD_PROBS),
            "fused_tail_keys": front + (k.DECODE_TAIL, k.MASK_HEAD),
            "fused_tail_logits": front + (k.DECODE_TAIL_LOGITS,),
            "window_kernel": shared + (k.WIN_ATTENTION,)}


def _fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def _time_ms(fn, reps: int = 7, warmup: int = 2) -> float:
    """Median device time of one call between CUDA events. Each call is
    queued behind a ~1 ms device sleep, so the host's cost of launching it
    (the wrapper's checks, the ctypes call, the tensor maps) falls outside
    the events."""
    import torch
    for _ in range(warmup):
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


def _rel(a, b) -> tuple:
    d = (a.float() - b.float()).abs().max().item()
    return d, d / max(b.float().abs().max().item(), 1e-6)


def _tuple_err(out_k, out_p):
    errs = [_rel(a, b) for a, b in zip(out_k, out_p)]
    return max(e[0] for e in errs), max(e[1] for e in errs)


# One H100 SXM (NVIDIA's data sheet, dense): HBM bytes/s, bf16 and TF32
# tensor-core FLOP/s, f32 (non-tensor) FLOP/s
HBM_BYTES_S, BF16_FLOP_S, TF32_FLOP_S, F32_FLOP_S = (3.35e12, 989e12, 495e12,
                                                     67e12)

# The mask head's f32 work a position (K3 and B6), beside its products on
# the tensor cores (bf16 inputs: the two convolutions and the
# hypernetwork's 16·32·M multiply-adds, an f32 sum of bf16 products): 768
# GELUs (256 after conv1, 512 after conv2) of 22 operations each at the
# JAX formula (ops/maskhead.py `_gelu`: |x|, 6 multiply-adds, 4
# squarings, a reciprocal and a subtraction, one multiply-add and the
# halving), the group LN's 7 a channel (sum, square multiply-add,
# normalize and scale-and-shift multiply-adds) over 256 channels, and the
# 768 bias adds.
HEAD_F32 = 768 * 22 + 256 * 7 + 768


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _bound(n_bytes: float, bf16_flop: float = 0.0, f32_flop: float = 0.0,
           tf32_flop: float = 0.0) -> tuple:
    """The least time the card could take: bytes moved once over the HBM
    rate, against operations over the peak rate of their type (bf16 and
    TF32 products one after the other on the tensor cores, f32 products
    on the FMA units, which run beside them)."""
    t_bytes = n_bytes / HBM_BYTES_S
    t_ops = max(bf16_flop / BF16_FLOP_S + tf32_flop / TF32_FLOP_S,
                f32_flop / F32_FLOP_S)
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


# The redesigned kernels' instantiations in ptxas.log, by a piece of
# their mangled names: (label, C entry point, dynamic shared
# memory query and its arguments).
PTXAS_KERNELS = (
    ("token_cross_kernelILb1ELb1E", "K2 shared k|v", "rat_token_cross_kv",
     "rat_token_cross_smem", (1, 1)),
    ("token_cross_kernelILb1ELb0E", "K2 per-prompt k|v", "rat_token_cross_kv",
     "rat_token_cross_smem", (1, 0)),
    ("token_cross_kernelILb0ELb1E", "B10 shared k, v", "rat_token_cross",
     "rat_token_cross_smem", (0, 1)),
    ("token_cross_kernelILb0ELb0E", "B10 per-prompt k, v", "rat_token_cross",
     "rat_token_cross_smem", (0, 0)),
    ("flash_attention_kernelILi80ELi2E", "K1 Dh 80, bias side 64",
     "rat_flash_attention", "rat_flash_attention_smem", (80,)),
    ("flash_attention_kernelILi80ELi1E", "K1 Dh 80, bias other sides",
     "rat_flash_attention", "rat_flash_attention_smem", (80,)),
    ("flash_attention_kernelILi80ELi0E", "K1 Dh 80, no bias",
     "rat_flash_attention", "rat_flash_attention_smem", (80,)),
    ("flash_attention_kernelILi64ELi0E", "K1 Dh 64, no bias",
     "rat_flash_attention", "rat_flash_attention_smem", (64,)),
    ("win_attention_kernelILi80ELi2E", "B11 hd 80, sides 8-15 (at 14)",
     "rat_win_attention", "rat_win_attention_smem", (14, 80)),
    ("win_attention_kernelILi64ELi2E", "B11 hd 64, sides 8-15 (at 14)",
     "rat_win_attention", "rat_win_attention_smem", (14, 64)),
    ("mask_head_kernelILi3ELb0E", "K3 M 3", "rat_mask_head",
     "rat_mask_head_smem", ()),
    ("mask_head_kernelILi3ELb1E", "B6 M 3", "rat_mask_head_probs",
     "rat_mask_head_smem", ()),
    ("i2t_update_kernelILb1E", "K5 shared branch (layer 1)", "rat_i2t_update",
     "rat_i2t_update_smem", ()),
    ("i2t_update_kernelILb0E", "K5 per-prompt (layer 2)", "rat_i2t_update",
     "rat_i2t_update_smem", ()),
    ("resize_flags_kernelILi3ELb1E", "K4 M 3 (240x320)", "rat_resize_flags",
     "rat_resize_flags_smem", (3, 320, 240)),
    ("decode_tail_kernelILi0E", "B3 keys mode", "rat_decode_tail",
     "rat_decode_tail_smem", ()),
    ("decode_tail_kernelILi1E", "B3 probability mode", "rat_decode_tail",
     "rat_decode_tail_smem", ()),
    ("decode_tail_kernelILi2E", "B3 logits mode (then K3)",
     "rat_decode_tail_logits", "rat_decode_tail_smem", ()),
    ("i2t_probs_l1_kernel", "B7 layer 1", "rat_i2t_probs",
     "rat_i2t_probs_smem", (1,)),
    ("i2t_probs_l2_kernel", "B7 layer 2", "rat_i2t_probs",
     "rat_i2t_probs_smem", (2,)),
    ("t2i_probs_kernelILi1E", "B8 depth 1", "rat_t2i_probs",
     "rat_t2i_probs_smem", (1,)),
    ("t2i_probs_kernelILi2E", "B8 depth 2", "rat_t2i_probs",
     "rat_t2i_probs_smem", (2,)),
)

# The kernels whose products run by mma.sync: B3's instantiations, by
# their emission (keys, probability, logits mode), B7's layer 2 and B8's
# two depths
MMA_SASS = (("decode_tail_kernelILi0E", "B3 keys mode"),
            ("decode_tail_kernelILi1E", "B3 probability mode"),
            ("decode_tail_kernelILi2E", "B3 logits mode"),
            ("i2t_probs_l2_kernel", "B7 layer 2"),
            ("t2i_probs_kernelILi1E", "B8 depth 1"),
            ("t2i_probs_kernelILi2E", "B8 depth 2"))


def ptxas_report() -> None:
    """Print the registers, shared memory and spill bytes of the
    redesigned entry points' kernels, read from the build's ptxas.log
    (dynamic shared memory from the sources' own size functions)."""
    import re

    from revisit_anything_tpu_torch.kernels import build
    log = (build.library_path().parent / "ptxas.log").read_text()
    # each kernel's block: "Compiling entry function '<name>'" up to the
    # next such line
    blocks = re.split(r"Compiling entry function ", log)[1:]
    lib = build.load()
    for key, label, entry, smem_fn, smem_args in PTXAS_KERNELS:
        block = next((b for b in blocks if key in b.split("\n", 1)[0]), None)
        if block is None:
            _fail(f"ptxas.log has no kernel {key}")
        regs = re.search(r"Used (\d+) registers", block).group(1)
        static = re.search(r"(\d+) bytes smem", block)
        stores, loads = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                                  r"spill loads", block).groups()
        # ptxas's (C7514) / (C7515) notes name the kernel whose wgmmas it
        # serialized
        serial = any(key in line and "(C751" in line
                     for line in log.splitlines())
        print(f"[ptxas] {label:28s} ({entry}): {regs} registers, shared "
              f"memory {static.group(1) if static else 0} B static + "
              f"{getattr(lib, smem_fn)(*smem_args)} B dynamic a CTA, spill "
              f"stores {stores} B, loads {loads} B"
              f"{', wgmma serialized (C751x)' if serial else ''}", flush=True)
    sass_report(MMA_SASS)


def sass_report(kernels) -> None:
    """Count the tensor-core instructions (HMMA, by shape and type) in the
    SASS of each of ``kernels`` ((piece of the mangled name, label)), from
    one cuobjdump of the built library; fail where there are none."""
    import collections
    import re
    import shutil

    from revisit_anything_tpu_torch.kernels import build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    res = subprocess.run([tool, "-sass", str(build.library_path())],
                         capture_output=True, text=True, check=True)
    for key, label in kernels:
        funcs = [f for f in res.stdout.split("Function : ")[1:]
                 if key in f.split("\n", 1)[0]]
        if not funcs:
            _fail(f"cuobjdump: no kernel {key}")
        kinds = collections.Counter(re.findall(r"HMMA\.[0-9A-Z.]+",
                                               funcs[0]))
        if not kinds:
            _fail(f"{label}: no HMMA in its SASS")
        print(f"[sass] {label} ({key}): {sum(kinds.values())} HMMA ("
              + ", ".join(f"{n} {k}" for k, n in sorted(kinds.items()))
              + ")", flush=True)


def compare_kernels(dev) -> dict:
    """Each kernel vs its plain version at the serving shapes (bf16)."""
    import numpy as np
    import torch

    from revisit_anything_tpu_torch.kernels import build
    from revisit_anything_tpu_torch.models.sam import SAM_VIT_H
    from revisit_anything_tpu_torch.models.sam.amg import (
        resize_mats_and_rows)
    from revisit_anything_tpu_torch.ops import attention as att
    from revisit_anything_tpu_torch.ops import maskhead as mh
    from revisit_anything_tpu_torch.ops import maskresize as mr
    from revisit_anything_tpu_torch.ops import winattn as wa
    from torch.nn import functional as F

    bf = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(1234)

    def rnd(*shape, s=1.0, off=0.0):
        return (torch.randn(shape, generator=g, device=dev) * s + off).to(bf)

    # bf16 outputs rounded at different points in kernel and plain
    # version (unnormalized vs normalized probabilities, accumulation
    # order): relative 2e-2 of the output's scale.
    rel_tol = 2e-2
    # K4: an f32 summation-order change flips a flag only at an exact
    # threshold crossing; mismatch rate 1e-5, stats exactly the
    # reductions of the kernel's own flags.
    flag_tol = 1e-5
    results = {}

    def check(kernel, label, fn_k, fn_p, err_fn, tol, ins, ops,
              library=None, plain_prompts=None, rate=False, was=None):
        """``ins`` the inputs the function must read (views where it
        reads part of a tensor), ``ops`` = (bf16 FLOP, f32 FLOP[, TF32
        FLOP]) its arithmetic; ``plain_prompts``: the plain version ran on only the
        first prompts, and the kernel's output for those is compared;
        ``rate``: also print the achieved GB/s (the bytes it must read
        and write over the kernel's time); ``was``: the previous design's
        time in ms (PERF.md), printed in brackets."""
        out_k, out_p = fn_k(), fn_p()
        torch.cuda.synchronize()
        outs = out_k if isinstance(out_k, (tuple, list)) else (out_k,)
        moved = _nbytes(ins) + _nbytes(outs)
        bound_ms, bound_by = _bound(moved, *ops)
        if plain_prompts:
            out_k = (tuple(o[:plain_prompts] for o in out_k)
                     if isinstance(out_k, tuple) else out_k[:plain_prompts])
        abs_err, rel_err = err_fn(out_k, out_p)
        parts = ([_rel(a, p)[1] for a, p in zip(out_k, out_p)]
                 if isinstance(out_k, tuple) and isinstance(out_p, tuple)
                 else None)
        del out_k, out_p, outs
        ms, plain_ms = _time_ms(fn_k), _time_ms(fn_p)
        library_ms = _time_ms(library) if library else None
        torch.cuda.empty_cache()
        # bound share: the bound's time over the kernel's; × library: the
        # kernel's time over the library call's
        share = bound_ms / ms
        x_lib = ms / library_ms if library else None
        lib = (f"  library {library_ms:.3f} ms  x library {x_lib:.2f}"
               if library else "")
        if rate:
            lib += f"  {moved / ms / 1e6:.1f} GB/s"
        if parts:
            lib += "  rel_err by output " + " ".join(f"{e:.3e}" for e in parts)
        print(f"[kernel] {kernel.name:22s} {label:44s} max_abs_err="
              f"{abs_err:.3e} rel_err={rel_err:.3e} (tol {tol:g}) "
              f"kernel {ms:.3f} ms{f' [{was:.3f}]' if was else ''}  plain "
              f"{plain_ms:.3f} ms{lib}  bound "
              f"{bound_ms:.4f} ms ({bound_by})  bound share {share:.3f}",
              flush=True)
        if not rel_err <= tol or not math.isfinite(abs_err):
            _fail(f"{kernel.name} {label}: error {rel_err} above {tol}")
        row = dict(label=label, max_abs_err=abs_err, rel_err=rel_err, ms=ms,
                   plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                   library_ms=library_ms, bound_share=share, x_library=x_lib)
        if rate:
            row["gb_s"] = moved / ms / 1e6
        if plain_prompts:
            row["plain_prompts"] = plain_prompts
        results.setdefault(kernel.name, []).append(row)

    # K1: SAM ViT-H global layer and DINOv2-g block shapes
    # (library: scaled_dot_product_attention, the bias materialized as
    # its attn_mask outside the timed call)
    q, k, v = (rnd(1, 16, 4096, 80) for _ in range(3))
    bh, bw = rnd(1, 16, 4096, 64), rnd(1, 16, 4096, 64)
    mask = (bh.float().repeat_interleave(64, dim=-1)
            + bw.float().repeat(1, 1, 1, 64)).to(bf)
    check(build.FLASH_ATTENTION, "SAM global q/k/v [1,16,4096,80] + bias",
          lambda: att.attend(q, k, v, bh, bw, side=64),
          lambda: att.attend_reference(q, k, v, bh, bw, side=64),
          _rel, rel_tol, (q, k, v, bh, bw), (4 * 16 * 4096 ** 2 * 80, 0),
          library=lambda: F.scaled_dot_product_attention(q, k, v,
                                                         attn_mask=mask))
    del mask
    q, k, v = (rnd(1, 24, 1531, 64) for _ in range(3))
    check(build.FLASH_ATTENTION, "DINOv2-g q/k/v [1,24,1531,64]",
          lambda: att.attend(q, k, v), lambda: att.attend_reference(q, k, v),
          _rel, rel_tol, (q, k, v), (4 * 24 * 1531 ** 2 * 64, 0),
          library=lambda: F.scaled_dot_product_attention(q, k, v))
    del q, k, v, bh, bw
    # and at the offline extraction's batches: SAM encoding 4 images at
    # once (each image its own rel-pos bias), DINOv2-g 8
    q, k, v = (rnd(4, 16, 4096, 80) for _ in range(3))
    bh, bw = rnd(4, 16, 4096, 64), rnd(4, 16, 4096, 64)
    mask = (bh.float().repeat_interleave(64, dim=-1)
            + bw.float().repeat(1, 1, 1, 64)).to(bf)
    check(build.FLASH_ATTENTION, "SAM global q/k/v [4,16,4096,80] + bias",
          lambda: att.attend(q, k, v, bh, bw, side=64),
          lambda: att.attend_reference(q, k, v, bh, bw, side=64),
          _rel, rel_tol, (q, k, v, bh, bw), (4 * 4 * 16 * 4096 ** 2 * 80, 0),
          library=lambda: F.scaled_dot_product_attention(q, k, v,
                                                         attn_mask=mask))
    del q, k, v, bh, bw, mask
    q, k, v = (rnd(8, 24, 1531, 64) for _ in range(3))
    check(build.FLASH_ATTENTION, "DINOv2-g q/k/v [8,24,1531,64]",
          lambda: att.attend(q, k, v), lambda: att.attend_reference(q, k, v),
          _rel, rel_tol, (q, k, v), (4 * 8 * 24 * 1531 ** 2 * 64, 0),
          library=lambda: F.scaled_dot_product_attention(q, k, v))
    del q, k, v

    # B11: one SAM ViT-H windowed layer, 25 windows of 14x14, 16 heads of
    # 80 (library: scaled_dot_product_attention on q/k/v split and the
    # bias expanded to its attn_mask outside the timed call)
    qkv = rnd(25, 196, 3840)
    bh, bw = rnd(25, 196, 16 * 14), rnd(25, 196, 16 * 14)
    q, k, v = (qkv[..., i * 1280:(i + 1) * 1280].reshape(25, 196, 16, 80)
               .transpose(1, 2).contiguous() for i in range(3))
    mask = (bh.float().reshape(25, 196, 16, 14).transpose(1, 2)
            .repeat_interleave(14, dim=-1)
            + bw.float().reshape(25, 196, 16, 14).transpose(1, 2)
            .repeat(1, 1, 1, 14)).to(bf)
    check(build.WIN_ATTENTION, "qkv [25,196,3840] + bias [25,196,224]",
          lambda: wa.windowed_attend(qkv, bh, bw, 16, 14),
          lambda: wa.windowed_attend_reference(qkv, bh, bw, 16, 14),
          _rel, rel_tol, (qkv, bh, bw), (4 * 25 * 16 * 196 ** 2 * 80, 0),
          library=lambda: F.scaled_dot_product_attention(q, k, v,
                                                         attn_mask=mask))
    del qkv, bh, bw, q, k, v, mask

    # K2: layer-1 shared k|v and per-prompt k|v, 1024 prompts
    qt = rnd(1024, 7, 128)
    pe, vb = rnd(1, 128, 4096), rnd(128)
    # (library: scaled_dot_product_attention on k = k + pe and v = v + bias
    # formed outside the timed call; a shared k|v takes every prompt's
    # queries as one batch of 1024·7 rows)
    for lead, label in ((1, "q [1024,7,128] kvt [1,256,4096] shared"),
                        (1024, "q [1024,7,128] kvt [1024,256,4096]")):
        kvt = rnd(lead, 256, 4096)
        k_l = (kvt[:, :128] + pe).reshape(lead, 8, 16, 4096).transpose(
            2, 3).contiguous()
        v_l = (kvt[:, 128:] + vb[:, None]).reshape(lead, 8, 16, 4096
                                                  ).transpose(2, 3).contiguous()
        q_l = qt.reshape(1024, 7, 8, 16).transpose(1, 2)
        q_l = (q_l.transpose(0, 1).reshape(1, 8, 1024 * 7, 16) if lead == 1
               else q_l).contiguous()
        check(build.TOKEN_CROSS, label,
              lambda: att.token_cross_attend_kv(qt, kvt, pe, vb, 8),
              lambda: att.token_cross_attend_kv_reference(qt, kvt, pe, vb,
                                                          8),
              _rel, rel_tol, (qt, kvt, pe, vb),
              (4 * 1024 * 8 * 7 * 4096 * 16, 0),
              library=lambda: F.scaled_dot_product_attention(q_l, k_l, v_l))
        del kvt, k_l, v_l, q_l
    del pe, vb

    # B10: K2 without pe and v bias on separate kt, vt (library:
    # scaled_dot_product_attention over the 8 heads, k and v laid out
    # for it outside the timed call)
    for lead, label in ((1, "q [1024,7,128] kt, vt [1,128,4096] shared"),
                        (1024, "q [1024,7,128] kt, vt [1024,128,4096]")):
        kt, vt = rnd(lead, 128, 4096), rnd(lead, 128, 4096)
        k_l, v_l = (x.reshape(lead, 8, 16, 4096).transpose(2, 3).contiguous()
                    for x in (kt, vt))
        q_l = qt.reshape(1024, 7, 8, 16).transpose(1, 2)
        q_l = (q_l.transpose(0, 1).reshape(1, 8, 1024 * 7, 16) if lead == 1
               else q_l).contiguous()
        check(build.TOKEN_CROSS_SPLIT, label,
              lambda: att.token_cross_attend(qt, kt, vt, 8),
              lambda: att.token_cross_attend_reference(qt, kt, vt, 8),
              _rel, rel_tol, (qt, kt, vt), (4 * 1024 * 8 * 7 * 4096 * 16, 0),
              library=lambda: F.scaled_dot_product_attention(q_l, k_l, v_l))
        del kt, vt, k_l, v_l, q_l
    del qt

    # K5: layer 1 (shared branch) and layer 2 (per-prompt), 1024 prompts
    for lead, label in ((1, "img [1,4096,256] shared, 1024 prompts"),
                        (1024, "img [1024,4096,256]")):
        iargs = (rnd(lead, 4096, 256), rnd(1, 4096, 128), rnd(1024, 7, 128),
                 rnd(1024, 7, 128), rnd(256, 128, s=0.1), rnd(128, s=0.1),
                 rnd(128, 256, s=0.1), rnd(256, s=0.1),
                 rnd(256, s=0.1, off=1.0), rnd(256, s=0.1),
                 rnd(256, 256, s=0.1))
        check(build.I2T_UPDATE, label,
              lambda: att.i2t_update(*iargs, 8, 1e-6),
              lambda: att.i2t_update_reference(*iargs, 8, 1e-6),
              _tuple_err, rel_tol, iargs,
              (2 * 1024 * 4096 * (256 * 128 + 128 * 256 + 256 * 256)
               + 2 * 2 * 1024 * 4096 * 8 * 7 * 16, 0))
        del iargs

    # K3: 1024 prompts, content 49 rows x 64 = 3136 positions
    margs = (rnd(1024, 4096, 256), rnd(1024, 3, 32, s=0.5),
             rnd(256, 256, s=0.1), rnd(64, s=0.1), rnd(64, s=0.1, off=1.0),
             rnd(64, s=0.1), rnd(64, 128, s=0.1), rnd(32, s=0.1))
    head_bf16 = 2 * (256 * 256 + 4 * 64 * 128 + 16 * 32 * 3)
    check(build.MASK_HEAD, "keys [1024,4096,256] -> [1024,3136,16,3]",
          lambda: mh.fused_mask_head(*margs, eps=1e-6, content=3136),
          lambda: mh.upscale_masks_blocks(margs[0][:, :3136], *margs[1:],
                                          eps=1e-6),
          _rel, rel_tol, (margs[0][:, :3136],) + margs[1:],
          (1024 * 3136 * head_bf16, 1024 * 3136 * HEAD_F32))
    head = margs[2:]
    del margs

    # K4: the 17places mask resize (input 768x1024 -> 240x320, gh = 49)
    wh, ww, gh = resize_mats_and_rows(SAM_VIT_H, (768, 1024), (240, 320))
    whd, wwd = torch.from_numpy(wh).to(dev), torch.from_numpy(ww).to(dev)
    taps = tuple(t.to(dev) for t in mr.resize_taps(wh, ww))
    logits = rnd(1024, gh * 64, 16, 3, s=4.0)

    def flags_err(out_k, flags_p):
        flags, rowst, colany = out_k
        own_rowst, own_colany = mr.flag_stats(flags)
        if not (torch.equal(rowst, own_rowst)
                and torch.equal(colany, own_colany)):
            _fail("resize_flags: stats differ from its own flags")
        mism = (flags != flags_p).float().mean().item()
        return mism, mism

    # the banded resize's taps: row pass nnz(wh)·4g, column pass H·nnz(ww)
    n_taps = int((whd != 0).sum()) * 4 * 64 + 240 * int((wwd != 0).sum())
    check(build.RESIZE_FLAGS, "logits [1024,3136,16,3] -> flags [1024,3,240,320]",
          lambda: mr.fused_resize_flags(logits, whd, wwd, 0.0, 1.0, (gh, 64),
                                        taps=taps),
          lambda: mr.resize_flags_reference(logits, whd, wwd, 0.0, 1.0,
                                            (gh, 64)),
          flags_err, flag_tol, (logits,) + taps, (0, 2 * 1024 * 3 * n_taps),
          rate=True)
    del logits
    torch.cuda.empty_cache()
    compare_probs_kernels(dev, check, head, rel_tol)
    return results


def compare_probs_kernels(dev, check, head, rel_tol) -> None:
    """B7, B8, B6 and B3 at the serving shapes (1024 prompts, M = 4096,
    content 3136), bf16. The plain versions of the kernels that rebuild
    the branch carry f32 [B, 4096, 256] intermediates (~20 GB at 1024
    prompts), so they run on the first 256 prompts and the kernel's
    output for those prompts is compared (prompts are independent); the
    kernel is timed at 1024 prompts, the plain version at 256."""
    import torch

    from revisit_anything_tpu_torch.kernels import build
    from revisit_anything_tpu_torch.models.sam import SAM_VIT_H
    from revisit_anything_tpu_torch.models.sam.decoder import MaskDecoder
    from revisit_anything_tpu_torch.ops import decode_fused as dfu
    from revisit_anything_tpu_torch.ops import decode_probs as dpr
    from revisit_anything_tpu_torch.ops import maskhead as mh

    bf = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(4321)
    b, m, d, da, ht, c = 1024, 4096, 256, 128, 56, 256
    content = 3136
    print(f"[kernel] probability-factored decode kernels: plain versions "
          f"that rebuild the branch run on the first {c} of {b} prompts",
          flush=True)

    def rnd(*shape, s=1.0, off=0.0):
        return (torch.randn(shape, generator=g, device=dev) * s + off).to(bf)

    def probs(n):
        x = torch.randn((n, 8, 7, m), generator=g, device=dev) * 2.0
        return torch.softmax(x, dim=2).reshape(n, ht, m).to(bf)

    rows = torch.zeros((8, d), device=dev)
    rows[[0, 3]] = torch.randn((2, d), generator=g, device=dev) * 0.1
    rows[[1, 4]] = torch.randn((2, d), generator=g, device=dev) * 0.1 + 1.0
    rows[[2, 5]] = torch.randn((2, d), generator=g, device=dev) * 0.1
    rows = rows.to(bf)
    img0, q1st, peqt = rnd(1, m, d), rnd(1, da, m), rnd(1, da, m)
    tok_k, qt = rnd(b, 7, da), rnd(b, 7, da)
    p1, p2 = probs(b), probs(b)
    c1, c2 = rnd(b, ht, d, s=0.3), rnd(b, ht, d, s=0.3)
    w_q, w_k, w_v, vb = (rnd(d, da, s=0.1), rnd(d, da, s=0.1),
                         rnd(d, da, s=0.1), rnd(da, s=0.1))
    # FLOP of one branch rebuild (bf16 P·C), of [56, 256] rows against the
    # f32 branch (f32 operands: counted at the TF32 rate, which holds the
    # tolerance; B3's keys mode runs them as three fp16 products for
    # precision, which a bound need not pay), and of a head's token
    # vectors against a bf16 [DA, M] pe term
    recon = 2 * b * m * ht * d
    rows_x_branch = 2 * b * m * ht * d
    pe_term = 2 * b * ht * m * 16

    check(build.I2T_PROBS, "layer 1: q1st [1,128,4096] -> P [1024,56,4096]",
          lambda: dpr.i2t_probs(q1st, tok_k, 8),
          lambda: dpr.i2t_probs_reference(q1st, tok_k, 8),
          _rel, rel_tol, (q1st, tok_k), (pe_term, 0), was=0.536)
    rec, rec_c = ((img0, p1, c1, peqt, w_q, rows),
                  (img0, p1[:c], c1[:c], peqt, w_q, rows))
    check(build.I2T_PROBS, "layer 2: P1, C1 [1024,56,*] -> P2",
          lambda: dpr.i2t_probs(None, tok_k, 8, layer=2, recon=rec),
          lambda: dpr.i2t_probs_reference(None, tok_k[:c], 8, layer=2,
                                          recon=rec_c),
          _rel, rel_tol, (tok_k,) + rec, (recon + pe_term, 0, rows_x_branch),
          plain_prompts=c, was=14.244)
    for depth in (1, 2):
        ps = (p2, c2) if depth == 2 else (None, None)
        ps_c = (p2[:c], c2[:c]) if depth == 2 else (None, None)
        args = (img0, p1, c1) + ps + (w_k, w_v, peqt, rows, vb, 8)
        args_c = (img0, p1[:c], c1[:c]) + ps_c + (w_k, w_v, peqt, rows, vb,
                                                  8)
        check(build.T2I_PROBS,
              f"depth {depth}: q [1024,7,128] over the rebuilt branch",
              lambda: dpr.t2i_from_probs(qt, *args),
              lambda: dpr.t2i_from_probs_reference(qt[:c], *args_c),
              _rel, rel_tol, [qt] + [x for x in args if
                                     isinstance(x, torch.Tensor)],
              (depth * recon + pe_term, 0, 2 * rows_x_branch),
              plain_prompts=c, was=(21.663, 32.381)[depth - 1])

    hyper = rnd(b, 3, 32, s=0.5)
    margs = (img0, p1, c1, p2, c2, rows, hyper) + head
    margs_c = (img0, p1[:c], c1[:c], p2[:c], c2[:c], rows,
               hyper[:c]) + head
    head_flop = 2 * (256 * 256 + 4 * 64 * 128 + 16 * 32 * 3)
    # f32 work a position: K3's epilogue (HEAD_F32) and the rebuild's two
    # branch LayerNorms at the group LN's 7 a channel, each after a bias
    # add, over 256 channels (the products P^T C are bf16 on the tensor
    # cores): 19,456 + 4,096 = 23,552, ~1.13 ms at 67 TFLOP/s.
    recon_f32 = 2 * 256 * (7 + 1)
    check(build.MASK_HEAD_PROBS,
          "P1,C1,P2,C2 -> [1024,3136,16,3]",
          lambda: mh.fused_mask_head_probs(*margs, content=content),
          lambda: mh.mask_head_probs_reference(*margs_c, content=content),
          _rel, rel_tol,
          (img0[:, :content], p1[..., :content], c1, p2[..., :content], c2,
           rows, hyper) + head,
          (b * content * (head_flop + 2 * 2 * ht * d),
           b * content * (HEAD_F32 + recon_f32)), plain_prompts=c)
    del margs, margs_c, hyper

    dec = MaskDecoder(SAM_VIT_H, dtype=bf, device=dev)
    with torch.no_grad():
        for name, prm in dec.named_parameters():
            x = torch.randn(prm.shape, generator=g, device=dev) * 0.05
            prm.copy_(x + 1.0 if name.endswith("scale") else x)
    pek2t, pekft = rnd(1, da, m), rnd(1, da, m)
    qin, tok = rnd(b, 7, d), rnd(b, 7, d)
    weights = [prm for mod in (dec.layers[1], dec.final_attn,
                               dec.norm_final) for prm in mod.parameters()]
    tail_ins = [img0, q1st, peqt, pek2t, pekft, tok_k, c1, qin, tok,
                rows] + weights
    mlp = 2 * b * 7 * 2 * d * SAM_VIT_H.decoder_mlp_dim
    tail_ops = (2 * recon + 4 * pe_term + mlp, 0, 5 * rows_x_branch)
    for keys in (True, False):
        check(build.DECODE_TAIL,
              "keys mode -> keys2 [1024,4096,256]" if keys else
              "probs mode -> P1, P2 [1024,56,4096], C2",
              lambda: dfu.decode_tail_fused(
                  dec, img0, q1st, peqt, pek2t, pekft, tok_k, c1, qin, tok,
                  8, 1e-6, keys),
              lambda: dfu.decode_tail_reference(
                  dec, img0, q1st, peqt, pek2t, pekft, tok_k[:c], c1[:c],
                  qin[:c], tok[:c], 8, 1e-6, keys),
              _tuple_err, rel_tol, tail_ins, tail_ops, plain_prompts=c,
              was=None if keys else 69.207)
    # logits mode: the tail, then the mask head on keys2's first `content`
    # positions and the three hypernetwork MLPs (no single library call)
    head_ins = [prm for name, prm in dec.named_parameters()
                if name.startswith(("up", "hyper_mlps.1", "hyper_mlps.2",
                                    "hyper_mlps.3"))]
    hyper_flop = 2 * b * 3 * (2 * d * d + d * 32)
    check(build.DECODE_TAIL_LOGITS, "logits mode -> [1024,3136,16,3]",
          lambda: dfu.decode_tail_fused(
              dec, img0, q1st, peqt, pek2t, pekft, tok_k, c1, qin, tok, 8,
              1e-6, mask_head=True, content=content),
          lambda: dfu.decode_tail_reference(
              dec, img0, q1st, peqt, pek2t, pekft, tok_k[:c], c1[:c],
              qin[:c], tok[:c], 8, 1e-6, mask_head=True, content=content),
          _tuple_err, rel_tol, tail_ins + head_ins,
          (tail_ops[0] + b * content * head_flop, hyper_flop, tail_ops[2]),
          plain_prompts=c, was=108.297)
    torch.cuda.empty_cache()


def _image(rng, hw):
    import numpy as np
    h, w = hw
    img = rng.integers(60, 200, (h, w, 3), dtype=np.uint8)
    yy, xx = np.ogrid[:h, :w]
    for _ in range(12):
        cy, cx = rng.integers(20, h - 20), rng.integers(20, w - 20)
        r = rng.integers(15, 80)
        img[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = rng.integers(0, 255, 3)
    return img


def serve(dev, seed: int = 0) -> dict:
    """Full-width server over a 100k-row index with room for 16 images,
    the planted images inserted through ``add_reference_images``, 3
    counted queries, then the other phases on the same models."""
    import numpy as np
    import torch

    from revisit_anything_tpu_torch.config import (DINO_G_DIM, NUM_CLUSTERS,
                                                   PCA_DIM, PLACES17_HW,
                                                   PLACES17_SAM_HW)
    from revisit_anything_tpu_torch.kernels import build
    from revisit_anything_tpu_torch.models.dinov2 import VIT_G14
    from revisit_anything_tpu_torch.models.sam import SAM_VIT_H
    from revisit_anything_tpu_torch.models.sam.amg import AmgConfig
    from revisit_anything_tpu_torch.pipeline.serve import (SegVLADServer,
                                                           ServingIndex)
    from revisit_anything_tpu_torch.weights import (init_dino, init_sam,
                                                    plant_point_segmenter)

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed)
    sam = init_sam(SAM_VIT_H, gen, dev, torch.bfloat16)
    plant_point_segmenter(sam, gen)
    dino = init_dino(VIT_G14, gen, dev, torch.bfloat16)
    n_db, per_image = 100_000, 50
    db = torch.randn((n_db, PCA_DIM), generator=gen, device=dev)
    db = db / db.norm(dim=1, keepdim=True)
    ids = torch.arange(n_db // per_image, device=dev).repeat_interleave(
        per_image)
    pca = torch.randn((PCA_DIM, NUM_CLUSTERS * DINO_G_DIM), generator=gen,
                      device=dev) * 0.01
    index = ServingIndex(
        centers=torch.randn((NUM_CLUSTERS, DINO_G_DIM), generator=gen,
                            device=dev),
        pca_mean=torch.zeros(NUM_CLUSTERS * DINO_G_DIM, device=dev),
        pca_components=pca, pca_variance=torch.ones(PCA_DIM, device=dev),
        pca_whiten=True, db=db, db_image_ids=ids,
        num_ref_images=n_db // per_image, order=3)
    amg = AmgConfig(points_per_batch=1024, pred_iou_thresh=-1e9,
                    stability_score_thresh=0.0)
    kw = dict(sam=sam, dino=dino, full_hw=PLACES17_HW,
              sam_hw=PLACES17_SAM_HW, amg=amg, max_masks=128)
    srv = SegVLADServer(index=index, db_capacity=n_db + 16 * 128,
                        insert_chunk=16, **kw)
    del db, ids, pca, index
    torch.cuda.synchronize()
    print(f"[serve] models + index ready in {time.perf_counter() - t0:.1f} s",
          flush=True)

    # [insert]: planted images A and B, then 14 more, in one chunk, after
    # one query has warmed the front up
    srv.query(_image(np.random.default_rng(seed + 100), PLACES17_HW))
    rng = np.random.default_rng(seed)
    inserted = [_image(rng, PLACES17_HW) for _ in range(16)]
    planted = insert_phase(srv, inserted)

    queries = [_noisy(rng, inserted[i]) for i in range(2)]
    queries.append(_image(rng, PLACES17_HW))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_counts()
    answers, wall = [], []
    for img in queries:
        t = time.perf_counter()
        top = srv.query(img)
        wall.append((time.perf_counter() - t) * 1e3)
        answers.append(top)
    counts = {k.name: k.launches for k in build.KERNELS}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    for i, (top, ms) in enumerate(zip(answers, wall)):
        print(f"[serve] query {i}: top-5 {top.tolist()}  {ms:.1f} ms",
              flush=True)
    print(f"[serve] launches per kernel over the 3 queries: {counts}",
          flush=True)
    print(f"[serve] peak device memory {peak_gib:.2f} GiB", flush=True)

    for top in answers:
        _check_answer(srv, top)
    for i, iid in enumerate(planted):
        if answers[i][0] != iid:
            _fail(f"noisy copy of planted image {iid} answered {answers[i]}")
    again = srv.query(queries[2])
    if not np.array_equal(again, answers[2]):
        _fail(f"query not deterministic: {answers[2]} vs {again}")
    missing = [k.name for k in _paths()["shared"] if counts[k.name] == 0]
    if missing:
        _fail(f"kernels not launched on the served path: {missing}")
    stage_split(srv, queries[2], answers[2])
    layer_breakdown(srv)
    window = serve_window_kernel(srv, queries[0], planted[0])

    # the probability-factored decoder forms: same weights, database and
    # AmgConfig but for ``decode``, one planted query each
    shared_ms = _decode_ms(srv, queries[0])
    print(f"[variant] shared: decode stage {shared_ms:.3f} ms (CUDA events)",
          flush=True)
    variants, servers = {}, {"shared": srv}
    for decode in VARIANTS:
        vsrv = SegVLADServer(index=_live_index(srv), **dict(
            kw, amg=dataclasses.replace(amg, decode=decode)))
        also = ("fused_tail_keys",) if decode == "fused_tail_logits" else ()
        variants[decode] = serve_variant(
            vsrv, queries[0], decode, planted[0],
            {name: servers[name] for name in ("shared",) + also})
        if decode == "fused_tail_keys":
            servers[decode] = vsrv
        plain_witness(vsrv, queries[0], srv, decode)
        del vsrv
    servers.clear()

    remove_and_snapshot(srv, queries, planted, kw)
    more = [_noisy(rng, inserted[i]) for i in range(2, 7)]
    pipelined = pipeline_phase(srv, queries + more)
    concurrent = concurrent_phase(srv, queries + more, rng, kw)
    stream = stream_knn_phase(srv, queries[0], planted[0])
    del srv
    offline = offline_phase(sam, dino)
    return dict(counts=counts, wall_ms=wall, peak_gib=peak_gib,
                variants=variants, window=window, pipelined=pipelined,
                concurrent=concurrent, stream=stream, offline=offline)


def _noisy(rng, img):
    import numpy as np
    return np.clip(img.astype(np.int16) + rng.integers(-4, 5, img.shape),
                   0, 255).astype(np.uint8)


def _check_answer(srv, top) -> None:
    """A well-formed answer: 5 image ids in range, −1 for unfilled ranks."""
    if top.shape != (5,) or not ((top >= -1) & (top < srv.num_ref_images)
                                 ).all():
        _fail(f"malformed answer {top}")


def _live_index(srv):
    """A ServingIndex of ``srv``'s current device state (used in place)."""
    from revisit_anything_tpu_torch.pipeline.serve import ServingIndex
    db, ids, _ = srv._db_state
    return ServingIndex(centers=srv._centers, pca_mean=srv._pca_mean,
                        pca_components=srv._pca_comps,
                        pca_variance=srv._pca_var, pca_whiten=srv._whiten,
                        db=db, db_image_ids=ids,
                        num_ref_images=srv.num_ref_images, order=srv.order)


def insert_phase(srv, imgs) -> list:
    """[insert]: ``imgs`` added in one chunk with the counters reset
    first: the "shared" kernels must launch, and each of the first two
    (the planted images) keep at least 32 segment rows. Returns their
    ids."""
    import torch

    from revisit_anything_tpu_torch.kernels import build
    from revisit_anything_tpu_torch.pipeline.query import DB_GUARD

    cursor = srv._cursor
    torch.cuda.synchronize()
    build.reset_counts()
    t = time.perf_counter()
    ids = srv.add_reference_images(imgs)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    counts = {k.name: k.launches for k in build.KERNELS}
    db, db_ids = srv._db[cursor:srv._cursor], srv._db_ids[cursor:srv._cursor]
    live = (db.float() < DB_GUARD / 2).all(1)
    rows = [int((live & (db_ids == i)).sum()) for i in ids]
    print(f"[insert] {len(imgs)} images in one chunk: {secs:.3f} s, "
          f"{secs / len(imgs) * 1e3:.1f} ms an image; ids {ids[0]}..{ids[-1]}"
          f"; segment rows an image {rows}; cursor {cursor} -> {srv._cursor}"
          f" of {srv._capacity}; launches {counts}", flush=True)
    _check_launches(counts, "shared")
    if ids != list(range(ids[0], ids[0] + len(imgs))):
        _fail(f"insert assigned ids {ids}")
    for iid, n in zip(ids[:2], rows):
        # the planted segmenter keeps ~128 segments a 17places image
        if n < 32:
            _fail(f"planted image {iid} kept {n} segment rows (expected at "
                  "least 32)")
    return ids[:2]


def remove_and_snapshot(srv, queries, planted, kw) -> None:
    """[insert], continued: planted image 1 removed (its noisy copy no
    longer finds it in the top-5), then the database snapshot to an npz,
    read by ``ServingIndex.from_npz`` into a fresh server that answers the
    three queries as the live one."""
    import os
    import tempfile

    import numpy as np

    from revisit_anything_tpu_torch.pipeline.serve import (SegVLADServer,
                                                           ServingIndex)

    srv.remove_reference_image(planted[1])
    after = [srv.query(q) for q in queries]
    if planted[1] in after[1]:
        _fail(f"removed image {planted[1]} still answered: {after[1]}")
    if after[0][0] != planted[0]:
        _fail(f"after the removal planted image {planted[0]} answered "
              f"{after[0]}")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "index.npz")
        t = time.perf_counter()
        snap = srv.snapshot_index(path)
        secs = time.perf_counter() - t
        size = os.path.getsize(path)
        fresh = SegVLADServer(index=ServingIndex.from_npz(path), **kw)
    got = [fresh.query(q) for q in queries]
    print(f"[insert] removed image {planted[1]}: top-5 of its noisy copy "
          f"{after[1].tolist()}; snapshot of {len(snap.db)} rows, "
          f"{snap.num_ref_images} images in {secs:.2f} s ({size / 2 ** 20:.0f}"
          f" MiB npz); restored server top-5 {[g.tolist() for g in got]}",
          flush=True)
    for a, g in zip(after, got):
        if not np.array_equal(a, g):
            _fail(f"restored snapshot answered {g}, the live server {a}")
    del fresh


def _busy_ms(prof) -> float:
    """The union of a trace's device-event intervals, ms."""
    from torch.autograd import DeviceType
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for lo, hi in spans:
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    return busy / 1e3


def pipeline_phase(srv, queries) -> dict:
    """[pipeline]: the queries one after another, then through
    ``query_many`` with 1-4 workers: the answers must be equal. Wall time
    (the best of 3 rounds, the modes in turns), queries/s, the caching
    allocator's device allocations and frees over the rounds, and the
    device's busy time and idle share from one torch.profiler trace of
    each."""
    import numpy as np
    import torch

    runs = {"sequential": lambda: [srv.query(q) for q in queries]}
    for n in (1, 2, 3, 4):
        runs[f"{n} worker{'s' if n > 1 else ''}"] = (
            lambda n=n: srv.query_many(queries, n))
    want = runs["sequential"]()                      # also a warm-up
    walls = {name: [] for name in runs}
    mallocs = {name: [0, 0] for name in runs}
    for _ in range(3):
        for name, run in runs.items():
            torch.cuda.synchronize()
            st = torch.cuda.memory_stats()
            t = time.perf_counter()
            got = run()
            walls[name].append(time.perf_counter() - t)
            st2 = torch.cuda.memory_stats()
            for i, key in enumerate(("num_device_alloc", "num_device_free")):
                mallocs[name][i] += st2[key] - st[key]
            for a, b in zip(got, want):
                if not np.array_equal(a, b):
                    _fail(f"[pipeline] {name} answered {a}, sequential {b}")
    out = {}
    for name, run in runs.items():
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            run()
            torch.cuda.synchronize()
            traced = time.perf_counter() - t
        busy = _busy_ms(prof)
        wall = min(walls[name])
        out[name] = dict(wall_s=wall, qps=len(queries) / wall,
                         busy_ms=busy, traced_wall_s=traced,
                         idle_share=1.0 - busy / 1e3 / wall)
        print(f"[pipeline] {name}: {len(queries)} queries in "
              f"{wall * 1e3:.1f} ms ({out[name]['qps']:.2f} queries/s; "
              f"rounds {' '.join(f'{w * 1e3:.1f}' for w in walls[name])} ms;"
              f" device allocations / frees over the rounds "
              f"{mallocs[name][0]} / {mallocs[name][1]}); device busy "
              f"{busy:.1f} ms of a {traced * 1e3:.1f} ms traced run, idle "
              f"share {out[name]['idle_share']:.3f} of the untraced wall "
              f"({1.0 - busy / 1e3 / traced:.3f} of the traced)", flush=True)
    return out


def concurrent_phase(srv, queries, rng, kw) -> dict:
    """[concurrent]: a server restored from ``srv``'s snapshot with room
    for 4 images; one thread inserts them in one chunk while
    ``query_many`` answers the queries on 4 workers. Every answer must be
    the query's answer before the insert or after it; then each new
    image's noisy copy must find it first."""
    import threading

    import numpy as np
    import torch

    from revisit_anything_tpu_torch.config import PLACES17_HW
    from revisit_anything_tpu_torch.pipeline.serve import SegVLADServer

    snap = srv.snapshot_index()
    live = SegVLADServer(index=snap, db_capacity=len(snap.db) + 4 * 128,
                         insert_chunk=4, **kw)
    new = [_image(rng, PLACES17_HW) for _ in range(4)]
    before = [live.query(q) for q in queries]
    result = {}

    def insert():
        t = time.perf_counter()
        result["ids"] = live.add_reference_images(new)
        result["s"] = time.perf_counter() - t

    torch.cuda.synchronize()
    t = time.perf_counter()
    thread = threading.Thread(target=insert)
    thread.start()
    during = live.query_many(queries, 4)
    thread.join()
    wall = time.perf_counter() - t
    if "ids" not in result:
        _fail("[concurrent] the insert thread failed")
    after = [live.query(q) for q in queries]
    moved = 0
    for d, b, a in zip(during, before, after):
        _check_answer(live, d)
        if not (np.array_equal(d, b) or np.array_equal(d, a)):
            _fail(f"[concurrent] answered {d}: neither the answer before "
                  f"the insert {b} nor after it {a}")
        moved += not np.array_equal(b, a)
    found = [live.query(_noisy(rng, img)) for img in new]
    print(f"[concurrent] {len(queries)} queries on 4 workers beside a "
          f"4-image insert: {wall * 1e3:.1f} ms in all, the insert "
          f"{result['s'] * 1e3:.1f} ms; every answer is the one before or "
          f"after the insert ({moved} queries differ between the two); new "
          f"ids {result['ids']}, their noisy copies answered "
          f"{[f.tolist() for f in found]}", flush=True)
    for iid, top in zip(result["ids"], found):
        if top[0] != iid:
            _fail(f"[concurrent] inserted image {iid} answered {top}")
    del live
    return dict(wall_s=wall, insert_s=result["s"])


def stream_knn_phase(srv, img, planted: int) -> dict:
    """[stream-knn]: one query's tail over a bf16 database of 600k rows at
    PCA 1024 (its [128, 600k] f32 scores pass the 256 MiB one-shot cap):
    the streaming path and the one-shot path (cap raised) must give the
    same top-5, the planted image first. Tail times by CUDA events
    (median of 5) and peak device memory of each; the one-shot tail over
    the live 102k-row f32 database beside them, and the streaming tail at
    other tile sizes."""
    import torch

    from revisit_anything_tpu_torch.pipeline.query import (db_sq_norms,
                                                           query_topk_images)

    dev, n_rows, per_image = srv.device, 600_000, 50
    n_img = n_rows // per_image
    if planted >= n_img:
        _fail(f"[stream-knn] planted id {planted} past {n_img} images")
    with torch.inference_mode():
        img_dev = torch.from_numpy(img).to(dev)
        pm, stats, desc = srv._front(img_dev)
        adj, _ = srv._adjacency(stats.cpu().numpy())
        head = (desc, pm, torch.from_numpy(adj).to(dev), srv._centers,
                srv._pca_mean, srv._pca_comps, srv._pca_var)
        # the planted image's rows as the live server holds them, under
        # its id, among 600k random unit rows
        rows = srv._db[srv._db_ids == planted]
        g = torch.Generator(device=dev).manual_seed(5)
        db = torch.empty((n_rows, rows.shape[1]), dtype=torch.bfloat16,
                         device=dev)
        for s in range(0, n_rows, 100_000):
            x = torch.randn((100_000, rows.shape[1]), generator=g, device=dev)
            db[s:s + 100_000] = (x / x.norm(dim=1, keepdim=True)).bfloat16()
        db[:len(rows)] = rows.bfloat16()
        ids = torch.arange(n_rows, device=dev) // per_image
        ids[:len(rows)] = planted
        norms = db_sq_norms(db)
        torch.cuda.synchronize()

        def tail(db, ids, norms, n_img, cap, **kw):
            return lambda: query_topk_images(
                *head, db, ids, num_ref_images=n_img, db_norms=norms,
                oneshot_cap_bytes=cap, **kw)

        out = {}
        runs = [("streaming 600k bf16", tail(db, ids, norms, n_img,
                                             256 * 2 ** 20)),
                ("one-shot 600k bf16", tail(db, ids, norms, n_img, 2 ** 40)),
                ("one-shot 102k f32 (live)", tail(
                    srv._db, srv._db_ids, srv._db_norms, srv.num_ref_images,
                    256 * 2 ** 20))]
        runs += [(f"streaming 600k bf16, db_tile {t}", tail(
            db, ids, norms, n_img, 256 * 2 ** 20, db_tile=t))
            for t in (8192, 32768, 65536, 131072)]
        for name, fn in runs:
            top = fn().cpu().numpy()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            fn()
            torch.cuda.synchronize()
            peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
            ms = _time_ms(fn, reps=5)
            out[name] = dict(ms=ms, peak_mib=peak, top=top.tolist())
            print(f"[stream-knn] {name}: tail {ms:.3f} ms (CUDA events, "
                  f"median of 5), peak device memory above the database "
                  f"{peak:.1f} MiB, top-5 {top.tolist()}", flush=True)
    a, b = (out[n]["top"] for n in ("streaming 600k bf16",
                                    "one-shot 600k bf16"))
    if a != b or a[0] != planted:
        _fail(f"[stream-knn] streaming {a} vs one-shot {b} (planted rows "
              f"under id {planted})")
    del db, ids, norms
    torch.cuda.empty_cache()
    return out


def _card() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


class _Span:
    """Wall seconds and the CUDA-event span (ms) of the device work a
    block queued, both ending in a synchronize; with ``trace``, also the
    device's busy ms in the block (the union of a torch.profiler trace's
    device events; the trace slows the host)."""

    def __init__(self, trace: bool = False):
        self.trace, self.busy_ms = trace, None

    def __enter__(self):
        import torch
        torch.cuda.synchronize()
        if self.trace:
            self.prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            self.prof.__enter__()
        self.start = torch.cuda.Event(enable_timing=True)
        self.end = torch.cuda.Event(enable_timing=True)
        self.t0 = time.perf_counter()
        self.start.record()
        return self

    def __exit__(self, *exc):
        self.end.record()
        self.end.synchronize()
        self.wall = time.perf_counter() - self.t0
        self.device_ms = self.start.elapsed_time(self.end)
        if self.trace:
            self.prof.__exit__(*exc)
            self.busy_ms = _busy_ms(self.prof)


def _batch_against_single(sam, imgs, sam_hw, amg, batch_masks) -> None:
    """The batched encode against one image at a time, at full width:
    SAM's embeddings of ``imgs`` encoded together and one by one (within
    2e-2 of the scale, the kernels' bf16 tolerance), and the masks
    ``generate_masks_batch`` kept for them (``batch_masks``) against
    ``generate_masks``' for each image (the same count, 95% of the
    batch's masks matching one of the single call's at IoU > 0.5). The
    planted segmenter's masks follow the prompt grid, so a per-image
    fault in a batched launch shows in the embeddings, not in the recall."""
    import numpy as np
    import torch

    from revisit_anything_tpu_torch.models.sam.amg import (_preprocess_any,
                                                           generate_masks)
    from revisit_anything_tpu_torch.pipeline.extract import (
        _resize_cv2_bilinear)

    dev = sam.encoder.pos_embed.device
    small = [_resize_cv2_bilinear(im, (sam_hw[1], sam_hw[0])) for im in imgs]
    with torch.inference_mode():
        x = torch.cat([_preprocess_any(im, sam.cfg, dev)[0] for im in small])
        together = sam.encoder(x)
        alone = torch.cat([sam.encoder(x[i:i + 1])
                           for i in range(len(small))])
    errs = [_rel(together[i], alone[i])[1] for i in range(len(small))]
    counts, shares = [], []
    for im, got in zip(small, batch_masks):
        want = [r.segmentation for r in generate_masks(sam, im, amg,
                                                       max_masks=128)]
        counts.append((len(got), len(want)))
        if not want:
            shares.append(0.0)
            continue
        g = torch.from_numpy(got.reshape(len(got), -1)).to(dev).float()
        w = torch.from_numpy(np.stack(want).reshape(len(want), -1)
                             ).to(dev).float()
        inter = g @ w.t()
        iou = inter / (g.sum(1)[:, None] + w.sum(1)[None] - inter
                       ).clamp(min=1.0)
        shares.append((iou.max(1).values > 0.5).float().mean().item())
    print(f"[offline] batched encode of {len(small)} against one image at "
          f"a time: embedding rel_err {' '.join(f'{e:.3e}' for e in errs)} "
          f"(tol 2e-2); masks kept (batch, single) {counts}, matched at IoU "
          f"> 0.5 {' '.join(f'{a:.4f}' for a in shares)}", flush=True)
    if (not max(errs) <= 2e-2 or any(a != b for a, b in counts)
            or min(shares) < 0.95):
        _fail("[offline] the batched encode disagrees with single images")


def _knn_tiles(banks, dev, tile: int = 1024) -> None:
    """``knn_l2``'s merge across tiles on the card: the raw query segments
    against the database bank in tiles of ``tile`` rows and in the one
    tile of ``DB_TILE`` (the default), timed both ways. cuBLAS sums each
    f32 product of another shape in another order: over K terms that
    moves a unit-scale score by ~sqrt(K)·2^-24 (1.3e-5 at K = 49,152),
    twice that in a squared distance. So the distances agree within 1e-4
    of their scale, and the indices of the top ``KNN_TOPK`` wherever a
    distance is more than that away from its neighbours in the row (a
    near-tie may swap; one rank more is searched, so that the last rank
    has a neighbour below it)."""
    import torch

    from revisit_anything_tpu_torch.config import KNN_TOPK
    from revisit_anything_tpu_torch.ops.knn import DB_TILE, knn_l2

    q = torch.as_tensor(banks["q"].descriptors, device=dev)
    db = torch.as_tensor(banks["db"].descriptors, device=dev)
    d1, i1 = knn_l2(q, db, KNN_TOPK + 1)
    dt, it = knn_l2(q, db, KNN_TOPK + 1, db_tile=tile)
    ms1 = _time_ms(lambda: knn_l2(q, db, KNN_TOPK))
    mst = _time_ms(lambda: knn_l2(q, db, KNN_TOPK, db_tile=tile))
    tol = 1e-4 * d1.abs().max().item()
    err = (dt - d1).abs().max().item()
    gap = d1.diff(dim=1).abs() > tol                  # [n, KNN_TOPK]
    first = torch.ones_like(gap[:, :1])
    apart = torch.cat([first, gap[:, :-1]], 1) & gap  # ranks 0..KNN_TOPK-1
    differ = it[:, :-1] != i1[:, :-1]
    bad = (differ & apart).nonzero()[:, 1].tolist()
    n_tiles = -(-db.shape[0] // tile)
    print(f"[offline] knn_l2 {q.shape[0]} x {db.shape[0]} x {db.shape[1]} "
          f"f32, top {KNN_TOPK}: one tile of {DB_TILE} {ms1:.3f} ms, "
          f"{n_tiles} tiles of {tile} {mst:.3f} ms (median of 7); distances "
          f"max_abs_err {err:.3e} (tol {tol:.3e}); indices differ at "
          f"{differ.float().mean():.6f} of the ranks, at {len(bad)} ranks "
          f"apart from their neighbours {sorted(set(bad))[:10]}", flush=True)
    if not err <= tol or bad:
        _fail("[offline] knn_l2 across tiles disagrees with one tile")


def offline_phase(sam, dino, seed: int = 5) -> dict:
    """[offline]: the offline SegLoc pipeline at the 17places size through
    its per-image functions (the card's machine has no h5py, so the loops
    of the h5 stages run here without their files): 48 database images and
    16 queries (noisy copies of database images 3q) at 480x640; SAM masks
    at 240x320 by ``generate_masks_batch`` (4 images an encoder dispatch,
    1024 prompts, at most 128 masks), DINOv2-g layer-31 value features by
    ``dino_dense_features`` (8 images a forward), with every launch
    counter reset first; a 32-cluster vocabulary over the database's
    descriptors; order-3 segment VLADs (``image_segment_vlad``); a
    1024-component whitened PCA fitted on the database bank; SegLoc
    retrieval on the raw VLADs (Recall@1 must be 1.0), then with the
    PCA, then AnyLoc's. Every planted image must keep at least 32 masks,
    and K1, K2, K5, K3 and K4 must launch during extraction."""
    import numpy as np
    import torch

    from revisit_anything_tpu_torch.config import (DATASETS, NUM_CLUSTERS,
                                                   PCA_DIM)
    from revisit_anything_tpu_torch.kernels import build
    from revisit_anything_tpu_torch.models.sam.amg import (
        AmgConfig, generate_masks_batch)
    from revisit_anything_tpu_torch.ops.masks import mask_pool_matrices
    from revisit_anything_tpu_torch.pipeline.aggregate import (
        SegmentBank, image_global_vlad, image_segment_vlad)
    from revisit_anything_tpu_torch.pipeline.evaluate import (
        run_anyloc_retrieval, run_segloc_retrieval)
    from revisit_anything_tpu_torch.pipeline.extract import (
        _fallback_records, _resize_cv2_bilinear, dino_dense_features)
    from revisit_anything_tpu_torch.pipeline.vocabulary import (
        fit_pca_from_vlads, fit_vocabulary)

    dev = sam.encoder.pos_embed.device
    ds = DATASETS["17places"]
    full_hw, sam_hw = ds.size.hw, ds.sam_size.hw
    n_db, n_q, encode_batch, dino_batch = 48, 16, 4, 8
    rng = np.random.default_rng(seed)
    sets = {"db": [_image(rng, full_hw) for _ in range(n_db)]}
    sets["q"] = [_noisy(rng, sets["db"][3 * q]) for q in range(n_q)]
    gt = [[3 * q] for q in range(n_q)]
    amg = AmgConfig(points_per_batch=1024, pred_iou_thresh=-1e9,
                    stability_score_thresh=0.0)
    card = _card()

    def sam_records(imgs):
        """extract_sam_masks' loop: encode_batch images an encoder
        dispatch."""
        recs = []
        for s in range(0, len(imgs), encode_batch):
            small = [_resize_cv2_bilinear(im, (sam_hw[1], sam_hw[0]))
                     for im in imgs[s:s + encode_batch]]
            recs += [r or _fallback_records(sam_hw) for r in
                     generate_masks_batch(sam, small, amg, max_masks=128)]
        return recs

    def dino_feats(imgs):
        """extract_dino_features' loop: dino_batch images a forward."""
        return torch.cat([
            dino_dense_features(dino, np.stack(imgs[s:s + dino_batch]))
            for s in range(0, len(imgs), dino_batch)])

    # extraction, untimed by any trace
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_counts()
    masks, feats, times = {}, {}, {}
    for tag, imgs in sets.items():
        with _Span() as sam_t:
            recs = sam_records(imgs)
        masks[tag] = [np.stack([r.segmentation for r in rr]) for rr in recs]
        with _Span() as dino_t:
            feats[tag] = dino_feats(imgs)
        times[tag] = (sam_t, dino_t)
    counts = {k.name: k.launches for k in build.KERNELS}
    # the device's busy time: the queries' extraction again under
    # torch.profiler (which slows the host); idle share = 1 - busy / the
    # untraced wall of the same images (PERF.md §3)
    busy = {}
    for name, fn in (("SAM", sam_records), ("DINOv2-g", dino_feats)):
        with _Span(trace=True) as t:
            fn(sets["q"])
        busy[name] = t.busy_ms
    n_img = n_db + n_q
    per_image = {k: round(v / n_img, 2) for k, v in counts.items() if v}
    kept = [len(m) for tag in ("db", "q") for m in masks[tag]]
    for tag, spans in times.items():
        n = len(sets[tag])
        parts = []
        for name, t in zip(("SAM", "DINOv2-g"), spans):
            part = (f"{name} {n / t.wall:.3f} images/s wall, "
                    f"{n * 1e3 / t.device_ms:.3f} by the CUDA-event span "
                    f"({t.wall:.3f} s, {t.device_ms:.3f} ms)")
            if tag == "q":
                part += (f", traced again: device busy {busy[name] / n:.3f} "
                         f"ms an image, idle share "
                         f"{1 - busy[name] / (t.wall * 1e3):.3f} of the "
                         "untraced wall")
            parts.append(part)
        print(f"[offline] extract {tag}: " + "; ".join(parts), flush=True)
    print(f"[offline] launches over the {n_img} images' extraction: "
          f"{counts}; per image {per_image}", flush=True)
    print(f"[offline] masks kept per image: min {min(kept)}, max "
          f"{max(kept)}, mean {np.mean(kept):.1f}", flush=True)
    missing = [k.name for k in (build.FLASH_ATTENTION, build.TOKEN_CROSS,
                                build.I2T_UPDATE, build.MASK_HEAD,
                                build.RESIZE_FLAGS) if counts[k.name] == 0]
    if missing:
        _fail(f"[offline] kernels not launched in extraction: {missing}")
    if min(kept) < 32:
        _fail(f"[offline] an image kept {min(kept)} masks (< 32)")
    _batch_against_single(sam, sets["db"][:encode_batch], sam_hw, amg,
                          masks["db"][:encode_batch])

    # vocabulary over the database's descriptors, as fit_vocabulary_from_h5
    d = feats["db"].shape[1]
    descs = feats["db"].permute(0, 2, 3, 1).reshape(-1, d)
    with _Span() as voc_t:
        centers = fit_vocabulary(descs, NUM_CLUSTERS, seed=42, device=dev)
    print(f"[offline] vocabulary: {NUM_CLUSTERS} clusters over "
          f"{descs.shape[0]} x {d} descriptors in {voc_t.wall:.3f} s",
          flush=True)
    del descs

    # aggregation, as compute_segment_vlads' loop
    pool_a, pool_b = mask_pool_matrices(sam_hw, full_hw)
    banks, agg = {}, {}
    for tag in ("db", "q"):
        f_np = feats[tag].cpu().numpy()
        with _Span() as agg_t:
            vl = [image_segment_vlad(m, f_np[i], centers, pool_a, pool_b,
                                     3, dev)
                  for i, m in enumerate(masks[tag])]
        banks[tag] = SegmentBank(
            np.concatenate(vl), np.repeat(np.arange(len(vl)),
                                          [len(v) for v in vl]),
            num_images=len(vl))
        agg[tag] = agg_t
        n_seg, dim = banks[tag].descriptors.shape
        print(f"[offline] aggregate {tag}: {n_seg} order-3 segment VLADs x "
              f"{dim} f32 ({n_seg * dim * 4 / 2 ** 30:.2f} GiB) in "
              f"{agg_t.wall:.3f} s, {n_seg / agg_t.wall:.1f} segments/s",
              flush=True)

    with _Span() as pca_t:
        pca = fit_pca_from_vlads(banks["db"], PCA_DIM, device=dev)
    print(f"[offline] PCA {pca.components.shape[0]} whitened components fit "
          f"on {len(banks['db'].descriptors)} segments in {pca_t.wall:.3f} "
          f"s", flush=True)

    with _Span() as raw_t:
        raw = run_segloc_retrieval(banks["db"], banks["q"], gt, device=dev)
    with _Span() as pca_r:
        with_pca = run_segloc_retrieval(banks["db"], banks["q"], gt, pca=pca,
                                        device=dev)
    with _Span() as any_t:
        gv = {tag: np.stack([image_global_vlad(f, centers, dev)
                             for f in feats[tag].cpu().numpy()])
              for tag in ("db", "q")}
        anyloc = run_anyloc_retrieval(gv["db"], gv["q"], gt, device=dev)
    _knn_tiles(banks, dev)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    def fmt(recalls):
        return " ".join(f"{x:.4f}" for x in recalls)

    print(f"[offline] Recall@1..5 SegLoc raw {fmt(raw.recalls)} "
          f"({raw_t.wall:.3f} s); with PCA {fmt(with_pca.recalls)} "
          f"({pca_r.wall:.3f} s, PCA applied included); AnyLoc "
          f"{fmt(anyloc.recalls)}, 1%-recall {anyloc.one_percent_recall:.4f}"
          f" ({any_t.wall:.3f} s, global VLADs included)", flush=True)
    print(f"[offline] {card}: peak device memory {peak:.2f} GiB over the "
          "phase", flush=True)
    if raw.recalls[0] != 1.0:
        _fail(f"[offline] Recall@1 {raw.recalls[0]} on the raw VLADs: "
              f"predictions {[p.tolist() for p in raw.predictions]}")
    return dict(counts=counts, kept=kept, recalls=raw.recalls,
                pca_recalls=with_pca.recalls, anyloc=anyloc.recalls)


def _sam_original_spec(cfg) -> list:
    """The original ``sam_vit_*.pth`` layout at ``cfg``'s widths: (key,
    shape, kind) with kind "ln" for LayerNorm weights, "pe" for the
    Fourier matrix, else "w"."""
    d, pd, g, p = cfg.encoder_dim, cfg.prompt_dim, cfg.grid, cfg.patch_size
    spec = []

    def put(key, *shape, kind="w"):
        spec.append((key, shape, kind))

    def linear(key, n_out, n_in):
        put(key + ".weight", n_out, n_in)
        put(key + ".bias", n_out)

    def ln(key, n):
        put(key + ".weight", n, kind="ln")
        put(key + ".bias", n)

    e, mlp = "image_encoder.", int(d * cfg.mlp_ratio)
    put(e + "patch_embed.proj.weight", d, 3, p, p)
    put(e + "patch_embed.proj.bias", d)
    put(e + "pos_embed", 1, g, g, d)
    for i in range(cfg.encoder_depth):
        b = f"{e}blocks.{i}."
        size = g if i in cfg.global_attn_indexes else cfg.window_size
        ln(b + "norm1", d)
        linear(b + "attn.qkv", 3 * d, d)
        linear(b + "attn.proj", d, d)
        put(b + "attn.rel_pos_h", 2 * size - 1, cfg.head_dim)
        put(b + "attn.rel_pos_w", 2 * size - 1, cfg.head_dim)
        ln(b + "norm2", d)
        linear(b + "mlp.lin1", mlp, d)
        linear(b + "mlp.lin2", d, mlp)
    put(e + "neck.0.weight", pd, d, 1, 1)
    ln(e + "neck.1", pd)
    put(e + "neck.2.weight", pd, pd, 3, 3)
    ln(e + "neck.3", pd)
    pe = "prompt_encoder."
    put(pe + "pe_layer.positional_encoding_gaussian_matrix", 2, pd // 2,
        kind="pe")
    for i in range(4):
        put(pe + f"point_embeddings.{i}.weight", 1, pd)
    put(pe + "not_a_point_embed.weight", 1, pd)
    put(pe + "no_mask_embed.weight", 1, pd)
    md = pe + "mask_downscaling."
    for key, shape in ((".0.weight", (4, 1, 2, 2)), (".0.bias", (4,)),
                       (".3.weight", (16, 4, 2, 2)), (".3.bias", (16,)),
                       (".6.weight", (pd, 16, 1, 1)), (".6.bias", (pd,))):
        put(md[:-1] + key, *shape)
    ln(md + "1", 4)
    ln(md + "4", 16)
    m = "mask_decoder."
    put(m + "iou_token.weight", 1, pd)
    put(m + "mask_tokens.weight", cfg.num_mask_tokens, pd)

    def attn(key, down):
        for n in ("q", "k", "v"):
            linear(f"{key}.{n}_proj", pd // down, pd)
        linear(key + ".out_proj", pd, pd // down)

    for i in range(cfg.decoder_depth):
        lp = f"{m}transformer.layers.{i}"
        attn(lp + ".self_attn", 1)
        ln(lp + ".norm1", pd)
        attn(lp + ".cross_attn_token_to_image", 2)
        ln(lp + ".norm2", pd)
        linear(lp + ".mlp.lin1", cfg.decoder_mlp_dim, pd)
        linear(lp + ".mlp.lin2", pd, cfg.decoder_mlp_dim)
        ln(lp + ".norm3", pd)
        attn(lp + ".cross_attn_image_to_token", 2)
        ln(lp + ".norm4", pd)
    attn(m + "transformer.final_attn_token_to_image", 2)
    ln(m + "transformer.norm_final_attn", pd)
    put(m + "output_upscaling.0.weight", pd, pd // 4, 2, 2)
    put(m + "output_upscaling.0.bias", pd // 4)
    ln(m + "output_upscaling.1", pd // 4)
    put(m + "output_upscaling.3.weight", pd // 4, pd // 8, 2, 2)
    put(m + "output_upscaling.3.bias", pd // 8)
    for i in range(cfg.num_mask_tokens):
        for j, (n_out, n_in) in enumerate(((pd, pd), (pd, pd),
                                           (pd // 8, pd))):
            linear(f"{m}output_hypernetworks_mlps.{i}.layers.{j}", n_out,
                   n_in)
    dims = ([pd] + [cfg.iou_head_hidden] * (cfg.iou_head_depth - 1)
            + [cfg.num_mask_tokens])
    for j in range(cfg.iou_head_depth):
        linear(f"{m}iou_prediction_head.layers.{j}", dims[j + 1], dims[j])
    return spec


def _dino_hub_spec(cfg) -> list:
    """The facebookresearch/dinov2 hub layout (layer scale, no register
    tokens) at ``cfg``'s widths, as ``_sam_original_spec``."""
    d, p = cfg.embed_dim, cfg.patch_size
    gh, gw = cfg.pretrain_grid
    spec = [("patch_embed.proj.weight", (d, 3, p, p), "w"),
            ("patch_embed.proj.bias", (d,), "w"),
            ("cls_token", (1, 1, d), "w"), ("pos_embed", (1, 1 + gh * gw, d),
                                            "w"),
            ("mask_token", (1, d), "w"), ("norm.weight", (d,), "ln"),
            ("norm.bias", (d,), "w")]
    hidden = (2 * cfg.swiglu_hidden, cfg.swiglu_hidden)
    for i in range(cfg.depth):
        b = f"blocks.{i}."
        spec += [(b + "norm1.weight", (d,), "ln"),
                 (b + "norm1.bias", (d,), "w"),
                 (b + "attn.qkv.weight", (3 * d, d), "w"),
                 (b + "attn.qkv.bias", (3 * d,), "w"),
                 (b + "attn.proj.weight", (d, d), "w"),
                 (b + "attn.proj.bias", (d,), "w"),
                 (b + "ls1.gamma", (d,), "w"), (b + "ls2.gamma", (d,), "w"),
                 (b + "norm2.weight", (d,), "ln"),
                 (b + "norm2.bias", (d,), "w"),
                 (b + "mlp.w12.weight", (hidden[0], d), "w"),
                 (b + "mlp.w12.bias", (hidden[0],), "w"),
                 (b + "mlp.w3.weight", (d, hidden[1]), "w"),
                 (b + "mlp.w3.bias", (d,), "w")]
    return spec


def _state_dict(spec, gen, dev) -> dict:
    """Seeded f32 CPU tensors for ``spec``: LayerNorm weights 1 + N(0,
    0.02²), the Fourier matrix N(0, 1), the rest N(0, 0.02²); drawn on
    the card, then copied to the host."""
    import torch
    out = {}
    for key, shape, kind in spec:
        x = torch.randn(shape, generator=gen, device=dev)
        if kind != "pe":
            x = x * 0.02 + (1.0 if kind == "ln" else 0.0)
        out[key] = x.cpu()
    return out


class _PeakRss:
    """The peak resident set of this process while the block runs (MiB),
    sampled every 2 ms from /proc/self/statm."""

    def __enter__(self):
        import os
        import threading
        self.page = os.sysconf("SC_PAGE_SIZE")
        self.peak = self.start = self._rss()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _rss(self) -> float:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * self.page / 2 ** 20

    def _run(self):
        while not self._stop.wait(0.002):
            self.peak = max(self.peak, self._rss())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self._rss())


def checkpoint_phase(dev, seed: int = 3) -> dict:
    """[checkpoint]: a seeded original-layout SAM ViT-H state dict saved
    with torch.save (the size of ``sam_vit_h_4b8939.pth``) and loaded by
    ``load_sam_checkpoint``, and a hub-layout DINOv2-g dict converted in
    memory, both onto the card in bf16 (load seconds, the peak host RSS
    of each load, device memory); a few leaves against the dicts (a
    transposed dense weight, the ConvT layout, the patch embeddings);
    then one query through them with the "shared" kernels launched."""
    import os
    import resource
    import tempfile

    import numpy as np
    import torch

    from revisit_anything_tpu_torch.config import (DINO_G_DIM, NUM_CLUSTERS,
                                                   PLACES17_HW,
                                                   PLACES17_SAM_HW)
    from revisit_anything_tpu_torch.kernels import build
    from revisit_anything_tpu_torch.models import dinov2 as dn
    from revisit_anything_tpu_torch.models.sam import SAM_VIT_H
    from revisit_anything_tpu_torch.models.sam.amg import AmgConfig
    from revisit_anything_tpu_torch.models.sam.convert import (
        load_sam_checkpoint)
    from revisit_anything_tpu_torch.pipeline.serve import (SegVLADServer,
                                                           ServingIndex)

    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(seed)
    bf = torch.bfloat16

    def same(name, got, want):
        want = want.to(dev, bf)
        if not torch.equal(got, want):
            err = (got.float() - want.float()).abs().max()
            _fail(f"[checkpoint] {name}: the loaded leaf differs from the "
                  f"state dict (max {err})")

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "sam_vit_h.pth")
        sd = _state_dict(_sam_original_spec(SAM_VIT_H), gen, dev)
        n_sam = sum(v.numel() for v in sd.values())
        t = time.perf_counter()
        torch.save(sd, path)
        save_s = time.perf_counter() - t
        del sd
        size = os.path.getsize(path)
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        with _PeakRss() as rss_sam:
            t = time.perf_counter()
            sam = load_sam_checkpoint(path, SAM_VIT_H, dtype=bf, device=dev)
            torch.cuda.synchronize()
            sam_s = time.perf_counter() - t
        sam_mib = (torch.cuda.memory_allocated() - mem0) / 2 ** 20
        sd = torch.load(path, map_location="cpu", weights_only=True,
                        mmap=True)
        same("encoder block 0 qkv (a transposed dense weight)",
             sam.encoder.blocks[0].qkv.w,
             sd["image_encoder.blocks.0.attn.qkv.weight"].T)
        w = sd["mask_decoder.output_upscaling.0.weight"]
        same("decoder up1_w (the ConvT layout)", sam.decoder.up1_w,
             w.permute(0, 2, 3, 1).reshape(w.shape[0], -1))
        w = sd["image_encoder.patch_embed.proj.weight"]
        same("encoder patch embedding", sam.encoder.patch_embed.w,
             w.permute(2, 3, 1, 0).reshape(-1, w.shape[0]))
        del sd, w

    sd = _state_dict(_dino_hub_spec(dn.VIT_G14), gen, dev)
    n_dino = sum(v.numel() for v in sd.values())
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    with _PeakRss() as rss_dino:
        t = time.perf_counter()
        dino = dn.convert_dinov2_hub_state_dict(sd, dn.VIT_G14, dtype=bf,
                                                device=dev)
        torch.cuda.synchronize()
        dino_s = time.perf_counter() - t
    dino_mib = (torch.cuda.memory_allocated() - mem0) / 2 ** 20
    same("DINOv2 block 39 qkv", dino.blocks[39].qkv.w,
         sd["blocks.39.attn.qkv.weight"].T)
    w = sd["patch_embed.proj.weight"]
    same("DINOv2 patch embedding", dino.patch_embed.w,
         w.permute(2, 3, 1, 0).reshape(-1, w.shape[0]))
    same("DINOv2 block 0 w12", dino.blocks[0].w12.w,
         sd["blocks.0.mlp.w12.weight"].T)
    del sd, w
    max_rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
    print(f"[checkpoint] SAM ViT-H original layout, {n_sam / 1e6:.1f}M "
          f"parameters, {size / 2 ** 30:.2f} GiB file (saved in "
          f"{save_s:.1f} s): loaded onto the card in bf16 in {sam_s:.2f} s, "
          f"host RSS {rss_sam.start:.0f} -> peak {rss_sam.peak:.0f} MiB "
          f"during the load, {sam_mib:.0f} MiB on the card; DINOv2-g hub "
          f"layout, {n_dino / 1e6:.1f}M parameters in memory: converted in "
          f"{dino_s:.2f} s, host RSS {rss_dino.start:.0f} -> peak "
          f"{rss_dino.peak:.0f} MiB, {dino_mib:.0f} MiB on the card; process "
          f"peak RSS so far {max_rss:.0f} MiB", flush=True)

    rng = np.random.default_rng(seed)
    db = rng.standard_normal((5000, 1024)).astype(np.float32)
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    index = ServingIndex(
        centers=rng.standard_normal((NUM_CLUSTERS, DINO_G_DIM)).astype(
            np.float32),
        pca_mean=np.zeros(NUM_CLUSTERS * DINO_G_DIM, np.float32),
        pca_components=(rng.standard_normal((1024, NUM_CLUSTERS * DINO_G_DIM))
                        * 0.01).astype(np.float32),
        pca_variance=np.ones(1024, np.float32), pca_whiten=True, db=db,
        db_image_ids=np.arange(5000) // 50, num_ref_images=100, order=3)
    srv = SegVLADServer(sam=sam, dino=dino, index=index, full_hw=PLACES17_HW,
                        sam_hw=PLACES17_SAM_HW, max_masks=128,
                        amg=AmgConfig(points_per_batch=1024,
                                      pred_iou_thresh=-1e9,
                                      stability_score_thresh=0.0))
    img = _image(rng, PLACES17_HW)
    srv.query(img)
    torch.cuda.synchronize()
    build.reset_counts()
    t = time.perf_counter()
    top = srv.query(img)
    ms = (time.perf_counter() - t) * 1e3
    counts = {k.name: k.launches for k in build.KERNELS}
    print(f"[checkpoint] one query through the loaded models: top-5 "
          f"{top.tolist()} in {ms:.1f} ms; launches {counts}", flush=True)
    _check_answer(srv, top)
    _check_launches(counts, "shared")
    return dict(sam_load_s=sam_s, sam_peak_rss_mib=rss_sam.peak,
                dino_load_s=dino_s, dino_peak_rss_mib=rss_dino.peak,
                sam_mib=sam_mib, dino_mib=dino_mib, query_ms=ms)


def _check_launches(counts: dict, path: str) -> None:
    """Every kernel of ``path`` launched, none outside it."""
    want = {k.name for k in _paths()[path]}
    missing = sorted(n for n in want if counts[n] == 0)
    stray = sorted(n for n, c in counts.items() if c and n not in want)
    if missing or stray:
        _fail(f"{path}: kernels not launched {missing}, launched outside "
              f"the path {stray}")


def _agreement(amg_a, amg_b) -> tuple:
    """Two servers' ``_amg_device`` results (kept masks, stats) on one
    image: (masks kept by a, by b, the share of a's kept masks that match
    one of b's at IoU > 0.5)."""
    (masks_a, st_a), (masks_b, st_b) = amg_a, amg_b
    n_a, n_b = int(st_a[-1]), int(st_b[-1])
    a = masks_a[:n_a].flatten(1).float()
    b = masks_b[:n_b].flatten(1).float()
    inter = a @ b.t()
    iou = inter / (a.sum(1)[:, None] + b.sum(1)[None] - inter).clamp(min=1.0)
    return n_a, n_b, (iou.max(1).values > 0.5).float().mean().item()


def _encode_ms(srv, img_dev) -> float:
    """The SAM preprocess and encode stage of one query between CUDA
    events."""
    import torch

    from revisit_anything_tpu_torch.pipeline import serve as sv

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    srv.sam.encoder(sv._sam_preprocess_fused(img_dev, srv._rh, srv._rw,
                                             srv.sam_cfg.image_size))
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def serve_window_kernel(srv, img, planted: int) -> dict:
    """One planted query with the encoder's windowed layers through the
    window kernel (counters reset just before): B11 once per windowed
    layer, the "shared" decoder's kernels, the planted image first;
    then the kept masks' agreement with plain windows and the encode
    stage with plain and kernel windows (CUDA events, 7 each in turns)."""
    import torch

    from revisit_anything_tpu_torch.kernels import build

    enc = srv.sam.encoder
    cfg = srv.sam_cfg
    n_windowed = cfg.encoder_depth - len(cfg.global_attn_indexes)
    torch.cuda.synchronize()
    try:
        enc.window_attention = "kernel"
        build.reset_counts()
        t = time.perf_counter()
        top = srv.query(img)
        wall = (time.perf_counter() - t) * 1e3
        counts = {k.name: k.launches for k in build.KERNELS}
        _check_launches(counts, "window_kernel")
        if counts[build.WIN_ATTENTION.name] != n_windowed:
            _fail(f"window kernel launched {counts[build.WIN_ATTENTION.name]}"
                  f" times in one query (expected {n_windowed})")
        if top[0] != planted:
            _fail(f"window kernel: noisy copy of planted image {planted} "
                  f"answered {top}")
        with torch.inference_mode():
            img_dev = torch.from_numpy(img).to(srv.device)
            amg_k = srv._amg_device(img_dev)
            enc.window_attention = "plain"
            n_k, n_p, agree = _agreement(amg_k, srv._amg_device(img_dev))
            times = {"plain": [], "kernel": []}
            for rep in range(8):
                order = ("plain", "kernel") if rep % 2 else ("kernel",
                                                             "plain")
                for form in order:
                    enc.window_attention = form
                    times[form].append(_encode_ms(srv, img_dev))
    finally:
        enc.window_attention = "plain"
    # the first turn warms both forms up
    plain_ms = statistics.median(times["plain"][1:])
    kernel_ms = statistics.median(times["kernel"][1:])
    print(f"[window] window kernel: top-5 {top.tolist()}  query {wall:.1f} "
          f"ms, {counts[build.WIN_ATTENTION.name]} window-kernel launches, "
          f"{n_k} masks kept (plain windows {n_p}), {agree:.4f} of them "
          f"match a plain-window mask at IoU > 0.5; encode stage (CUDA "
          f"events, median of 7) plain windows {plain_ms:.3f} ms, kernel "
          f"windows {kernel_ms:.3f} ms; launches {counts}", flush=True)
    if n_k < 32:
        _fail(f"window kernel: {n_k} masks kept (expected at least 32)")
    return dict(query_ms=wall, kept=n_k, agreement=agree, counts=counts,
                encode_plain_ms=plain_ms, encode_kernel_ms=kernel_ms)


def _decode_ms(srv, img) -> float:
    """The AMG decode stage of one query (all prompt batches) between
    CUDA events."""
    import torch

    from revisit_anything_tpu_torch.models.sam.amg import _decode_batch
    from revisit_anything_tpu_torch.pipeline import serve as sv

    with torch.inference_mode():
        img_dev = torch.from_numpy(img).to(srv.device)
        emb = srv.sam.encoder(sv._sam_preprocess_fused(
            img_dev, srv._rh, srv._rw, srv.sam_cfg.image_size))[0]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for s in range(0, srv._pts.shape[0], srv._bsz):
            _decode_batch(srv.sam, srv.sam_cfg, emb, srv._image_pe,
                          srv._pts[s:s + srv._bsz], srv.input_hw,
                          srv.sam_hw, srv.amg)
        end.record()
        end.synchronize()
    return start.elapsed_time(end)


def serve_variant(vsrv, img, decode: str, planted: int, refs: dict) -> dict:
    """One planted query through ``vsrv`` (decoder form ``decode``) with
    the counters reset just before: the form's kernels launched and no
    other, the planted image comes first; then its decode-stage time
    and the share of its kept masks that match a mask of each server in
    ``refs`` (by form name) at IoU > 0.5."""
    import torch

    from revisit_anything_tpu_torch.kernels import build

    torch.cuda.synchronize()
    build.reset_counts()
    t = time.perf_counter()
    top = vsrv.query(img)
    wall = (time.perf_counter() - t) * 1e3
    counts = {k.name: k.launches for k in build.KERNELS}
    _check_launches(counts, decode)
    if top[0] != planted:
        _fail(f"{decode}: noisy copy of planted image {planted} answered "
              f"{top}")
    decode_ms = _decode_ms(vsrv, img)
    agreement = {}
    with torch.inference_mode():
        img_dev = torch.from_numpy(img).to(vsrv.device)
        amg_v = vsrv._amg_device(img_dev)
        n_v = int(amg_v[1][-1])
        for name, ref in refs.items():
            _, n_r, agreement[name] = _agreement(amg_v,
                                                 ref._amg_device(img_dev))
            print(f"[variant] {decode}: {n_v} masks kept ({name} {n_r}), "
                  f"{agreement[name]:.4f} of them match a {name} mask at "
                  f"IoU > 0.5", flush=True)
    print(f"[variant] {decode}: top-5 {top.tolist()}  query {wall:.1f} ms, "
          f"decode stage {decode_ms:.3f} ms (CUDA events); launches "
          f"{counts}", flush=True)
    if n_v < 32:
        _fail(f"{decode}: {n_v} masks kept (expected at least 32)")
    return dict(query_ms=wall, decode_ms=decode_ms, kept=n_v,
                agreement=agreement, counts=counts)


def plain_witness(vsrv, img, ref, decode: str) -> None:
    """The probability-factored server ``vsrv`` (form ``decode``) on
    ``img`` with its decode kernels as they are and with their plain
    versions (f32 on the card) in their place: B7 and B8
    (``i2t_probs_reference``, ``t2i_from_probs_reference``) for
    "probs_split", the decode tail (``decode_tail_reference``) for the
    "fused_tail_*" forms. How many kept masks match one of ``ref``'s
    ("shared") and of the kernels' at IoU > 0.5, and the predicted IoU at
    the top-``kmax`` cut (masks past it are dropped; it falls among
    bf16-rounded ties). A witness of what the f32 function itself serves;
    it fails nothing."""
    import torch

    from revisit_anything_tpu_torch.models.sam import decoder
    from revisit_anything_tpu_torch.ops import decode_fused as dfu
    from revisit_anything_tpu_torch.ops import decode_probs as dpr
    from revisit_anything_tpu_torch.ops.nms import nms_keep_mask
    from revisit_anything_tpu_torch.pipeline import serve as sv

    plain = ({"i2t_probs": dpr.i2t_probs_reference,
              "t2i_from_probs": dpr.t2i_from_probs_reference}
             if decode == "probs_split"
             else {"decode_tail_fused": dfu.decode_tail_reference})

    select, cuts = sv._select_masks_centroids, {}

    def spy(masks, iou, stab, boxes, valid, amg, kmax):
        keep = valid & (stab >= amg.stability_score_thresh)
        if amg.pred_iou_thresh > 0.0:
            keep = keep & (iou > amg.pred_iou_thresh)
        nms = nms_keep_mask(boxes, iou.masked_fill(~keep, float("-inf")),
                            amg.box_nms_thresh)
        left = torch.sort(iou[nms & keep], descending=True).values
        cuts["n"], cuts["at"] = left.numel(), left[kmax - 2:kmax + 2].tolist()
        return select(masks, iou, stab, boxes, valid, amg, kmax)

    kernels, runs = {n: getattr(decoder, n) for n in plain}, {}
    sv._select_masks_centroids = spy
    try:
        with torch.inference_mode():
            img_dev = torch.from_numpy(img).to(vsrv.device)
            runs["shared"] = (ref._amg_device(img_dev), dict(cuts))
            for name, fns in (("kernel", kernels), ("plain f32", plain)):
                for n, fn in fns.items():
                    setattr(decoder, n, fn)
                runs[name] = (vsrv._amg_device(img_dev), dict(cuts))
    finally:
        sv._select_masks_centroids = select
        for n, fn in kernels.items():
            setattr(decoder, n, fn)
    for name, (amg_v, cut) in runs.items():
        agree = [f"{_agreement(amg_v, runs[r][0])[2]:.4f} {r}"
                 for r in ("shared", "kernel") if r != name]
        print(f"[witness] {decode} {'/'.join(plain)} {name}: "
              f"{int(amg_v[1][-1])} masks kept of {cut['n']} past NMS, "
              f"predicted IoU at ranks {vsrv.kmax - 1}-{vsrv.kmax + 2} "
              + " ".join(f"{x:.6f}" for x in cut["at"])
              + "; matched at IoU > 0.5: " + ", ".join(agree), flush=True)


def stage_split(srv, img, answer) -> None:
    """One query's stages between CUDA events (SegVLADServer.query step by
    step; the answer must equal query()'s), then one traced query: the
    device's busy time is the union of its kernels' intervals."""
    import numpy as np
    import torch

    from revisit_anything_tpu_torch.models.sam.amg import _decode_batch
    from revisit_anything_tpu_torch.ops.masks import pool_masks_to_patch_grid
    from revisit_anything_tpu_torch.pipeline import serve as sv
    from revisit_anything_tpu_torch.pipeline.query import query_topk_images

    marks = []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev, time.perf_counter()))

    torch.cuda.synchronize()
    with torch.inference_mode():
        mark("start")
        img_dev = torch.from_numpy(img).to(srv.device)
        batched = sv._sam_preprocess_fused(img_dev, srv._rh, srv._rw,
                                           srv.sam_cfg.image_size)
        emb = srv.sam.encoder(batched)[0]
        mark("upload+preprocess+encode")
        outs = [_decode_batch(srv.sam, srv.sam_cfg, emb, srv._image_pe,
                              srv._pts[s:s + srv._bsz], srv.input_hw,
                              srv.sam_hw, srv.amg)
                for s in range(0, srv._pts.shape[0], srv._bsz)]
        mark("AMG decode")
        masks, iou, stab, boxes = (torch.cat(t) for t in zip(*outs))
        masks, stats = sv._select_masks_centroids(
            masks, iou, stab, boxes, srv._valid, srv.amg, srv.kmax)
        pm = pool_masks_to_patch_grid(masks, srv._pool_a, srv._pool_b)
        mark("select+NMS+pool")
        desc = sv._dino_desc_device(srv.dino, srv.dino_cfg, img_dev,
                                    srv.dino_layer, srv._crop)
        mark("DINOv2")
        adj, _ = srv._adjacency(stats.cpu().numpy())
        mark("readback+host adjacency")
        top = query_topk_images(
            desc, pm, torch.from_numpy(adj).to(srv.device), srv._centers,
            srv._pca_mean, srv._pca_comps, srv._pca_var, srv._db,
            srv._db_ids, num_ref_images=srv.num_ref_images,
            top_images=srv.top_images, whiten=srv._whiten,
            db_norms=srv._db_norms).cpu().numpy()
        mark("retrieval tail+readback")
    torch.cuda.synchronize()
    if not np.array_equal(top, answer):
        _fail(f"stage split answered {top}, query() {answer}")
    parts = [f"{name} {prev.elapsed_time(ev):.3f}"
             for (_, prev, _), (name, ev, _) in zip(marks[:-1], marks[1:])]
    print(f"[split] ms by stage (CUDA events): {'; '.join(parts)}; "
          f"wall {1e3 * (marks[-1][2] - marks[0][2]):.3f}", flush=True)

    from torch.autograd import DeviceType
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        srv.query(img)
        traced_ms = (time.perf_counter() - t) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for lo, hi in spans:
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    total = sum(hi - lo for lo, hi in spans)
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    h2d = sum("HtoD" in n for n in names)
    d2h = sum("DtoH" in n for n in names)
    print(f"[trace] one traced query: {len(spans)} device events, device "
          f"busy {busy / 1e3:.3f} ms (union of intervals; their plain sum "
          f"{total / 1e3:.3f} ms) of {traced_ms:.3f} ms traced wall; "
          f"{h2d} host-to-device copies, {d2h} device-to-host copies",
          flush=True)
    # a query uploads the image and the adjacency, nothing else
    if h2d > 2:
        _fail(f"a traced query made {h2d} host-to-device copies (expected "
              f"at most 2: the image and the adjacency)")


def layer_breakdown(srv, top: int = 8) -> None:
    """Device time of one windowed encoder block (SAM ViT-H's block 0 on
    the 64x64 grid, bf16) by op, with plain and with kernel windows:
    torch.profiler over 3 calls after warm-up, self device time per op,
    the ``top`` largest with their share of the block."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    enc = srv.sam.encoder
    cfg = srv.sam_cfg
    i = next(j for j in range(cfg.encoder_depth)
             if j not in cfg.global_attn_indexes)
    g = torch.Generator(device=srv.device).manual_seed(3)
    x = torch.randn((1, cfg.grid, cfg.grid, cfg.encoder_dim), generator=g,
                    device=srv.device).to(enc.patch_embed.w.dtype)
    reps = 3
    try:
        for form in ("plain", "kernel"):
            enc.window_attention = form
            with torch.inference_mode():
                for _ in range(2):
                    enc._block(x, i)
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    for _ in range(reps):
                        enc._block(x, i)
                    torch.cuda.synchronize()
            # kernels' own entries give the block's device time; the aten
            # ops that launched them (self device time) name its parts,
            # and what no aten op launched (B11, through ctypes) is the
            # rest
            total, rows = 0.0, []
            for ev in prof.key_averages():
                ms = getattr(ev, "self_device_time_total", 0.0) / reps / 1e3
                if ms <= 0:
                    continue
                if ev.device_type == DeviceType.CUDA:
                    total += ms
                else:
                    rows.append((ms, ev.key))
            if total <= 0:
                _fail(f"[layer] the profiler saw no device time ({form})")
            rows.append((total - sum(ms for ms, _ in rows),
                         "kernels no aten op launched"))
            rows.sort(reverse=True)
            parts = "; ".join(f"{name} {ms:.4f} ms {ms / total:.3f}"
                              for ms, name in rows[:top])
            print(f"[layer] windowed block {i}, {form} windows: device "
                  f"{total:.4f} ms a block (torch.profiler, self device "
                  f"time, mean of {reps}); top ops: {parts}", flush=True)
    finally:
        enc.window_attention = "plain"


def reference_check(dev, seed: int = 7) -> None:
    """The served path on a small input, through the kernels on the card
    and through the plain versions on the CPU, from the same bf16
    weights and index, with the "shared" decoder (two inputs), the
    "fused_tail_keys" and the "fused_tail_logits" ones, and the "shared"
    one with the window kernel: the same masks survive, the descriptors
    agree and the answers match. The small models keep every kernel's
    production widths (SAM head dim 80, prompt dim 256, decoder head dim
    16; DINO head dim 64 over 1025 tokens); with the window kernel both
    encoder layers (8x8 windows and the 16x16 global grid) take it."""
    import copy

    import numpy as np
    import torch

    from revisit_anything_tpu_torch.models.dinov2 import DinoV2Config
    from revisit_anything_tpu_torch.models.sam import SamArchConfig
    from revisit_anything_tpu_torch.models.sam.amg import AmgConfig
    from revisit_anything_tpu_torch.pipeline.serve import (SegVLADServer,
                                                           ServingIndex)
    from revisit_anything_tpu_torch.weights import init_dino, init_sam

    sam_cfg = SamArchConfig(encoder_dim=160, encoder_depth=2, encoder_heads=2,
                            global_attn_indexes=(1,), image_size=256,
                            window_size=8, decoder_mlp_dim=512,
                            iou_head_hidden=64)
    dino_cfg = DinoV2Config(embed_dim=128, depth=3, num_heads=2,
                            ffn="swiglu", pretrain_grid=(16, 16))
    gen = torch.Generator().manual_seed(seed)
    sam = init_sam(sam_cfg, gen, "cpu", torch.bfloat16)
    dino = init_dino(dino_cfg, gen, "cpu", torch.bfloat16)
    rng = np.random.default_rng(seed)
    n_img, per_image, c, pca = 50, 10, 8, 32
    db = rng.standard_normal((n_img * per_image, pca)).astype(np.float32)
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    index = ServingIndex(
        centers=rng.standard_normal((c, 128)).astype(np.float32),
        pca_mean=np.zeros(c * 128, np.float32),
        pca_components=(rng.standard_normal((pca, c * 128)) * 0.05
                        ).astype(np.float32),
        pca_variance=np.ones(pca, np.float32), pca_whiten=True, db=db,
        db_image_ids=np.repeat(np.arange(n_img), per_image),
        num_ref_images=n_img, order=3)
    gpu_sam, gpu_dino = copy.deepcopy(sam).to(dev), copy.deepcopy(dino).to(dev)
    inputs = (("shared", "plain"), ("shared", "plain"),
              ("fused_tail_keys", "plain"), ("fused_tail_logits", "plain"),
              ("shared", "kernel"))
    for q, (decode, windows) in enumerate(inputs):
        sam.encoder.window_attention = windows
        gpu_sam.encoder.window_attention = windows
        kw = dict(index=index, full_hw=(448, 448), sam_hw=(224, 224),
                  amg=AmgConfig(points_per_side=8, points_per_batch=64,
                                pred_iou_thresh=-1e9,
                                stability_score_thresh=0.0, decode=decode),
                  dino_layer=2, max_masks=32)
        cpu_srv = SegVLADServer(sam=sam, dino=dino, **kw)
        gpu_srv = SegVLADServer(sam=gpu_sam, dino=gpu_dino, **kw)
        img = _image(rng, (448, 448))
        with torch.inference_mode():
            pm_c, st_c, de_c = cpu_srv._front(torch.from_numpy(img))
            pm_g, st_g, de_g = (x.cpu() for x in gpu_srv._front(
                torch.from_numpy(img).to(dev)))
        n_c, n_g = int(st_c[-1]), int(st_g[-1])
        agree = (pm_c == pm_g).float().mean().item()
        de_abs, de_rel = _rel(de_g, de_c)
        top_c, top_g = cpu_srv.query(img), gpu_srv.query(img)
        print(f"[reference] small input {q}, {decode} decoder, {windows} "
              f"windows: masks kept card {n_g} / cpu "
              f"{n_c}, patch-mask agreement {agree:.6f}, descriptor "
              f"rel_err {de_rel:.3e}, top-5 card {top_g.tolist()} cpu "
              f"{top_c.tolist()}", flush=True)
        # bf16 kernels vs bf16 plain versions: descriptors within 2e-2
        # of their scale; the same masks survive (a flag flip right at
        # the threshold may move a patch: 99% of patch memberships
        # agree) and the answers' top image agrees.
        if not (n_c == n_g and agree >= 0.99 and de_rel <= 2e-2
                and top_c[0] == top_g[0]):
            _fail(f"served path on the card disagrees with the CPU "
                  f"reference on small input {q}")


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false: this smoke needs a GPU")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    print(_card(), flush=True)

    from revisit_anything_tpu_torch.kernels import build
    build.load()
    print(f"[build] kernels built in {build.last_build_seconds:.1f} s "
          f"({build.library_path()})", flush=True)

    ptxas_report()
    results = compare_kernels(dev)
    reference_check(dev)
    served = serve(dev)
    checkpoint_phase(dev)

    # launches: the 3 "shared" queries for the kernels of that form, the
    # probability-factored queries for theirs, the window-kernel query for
    # B11; B10 (token_cross_split) has no caller on a serving path
    table = []
    for k in build.KERNELS:
        main_shape = results[k.name][0]
        launches = (served["counts"][k.name]
                    or sum(v["counts"][k.name]
                           for v in served["variants"].values())
                    or served["window"]["counts"][k.name])
        table.append(dict(
            name=k.name, route="cuda", source=k.source, replaces=k.replaces,
            launches=launches,
            max_abs_err=max(r["max_abs_err"] for r in results[k.name]),
            ms=main_shape["ms"], plain_ms=main_shape["plain_ms"],
            bound_ms=main_shape["bound_ms"],
            bound_by=main_shape["bound_by"],
            library_ms=main_shape["library_ms"],
            bound_share=main_shape["bound_share"],
            x_library=main_shape["x_library"], shapes=results[k.name]))
    for name, v in served["variants"].items():
        agree = ", ".join(f"{ref} {a:.4f}" for ref, a in v["agreement"].items())
        print(f"[variant] {name}: query {v['query_ms']:.1f} ms, decode "
              f"{v['decode_ms']:.3f} ms, agreement with {agree}", flush=True)
    w = served["window"]
    print(f"[window] encode stage plain windows {w['encode_plain_ms']:.3f} ms,"
          f" kernel windows {w['encode_kernel_ms']:.3f} ms; agreement "
          f"{w['agreement']:.4f}", flush=True)
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
