"""Smoke run of the PyTorch/CUDA port on one GPU: build the kernels, hold
each against its plain PyTorch version at the serving path's shapes, then
serve full-width SegVLAD queries through the kernels over a live database
(inserts, removals, snapshots, pipelined and concurrent queries, the
streaming kNN), in each of the decoder's forms, with the encoder's
windowed layers either way and with SAM and DINOv2 in f32, load
full-size checkpoints onto the card, extract features with the other
backbones and train VLAD-BuFF (on one
device and sharded over processes), encode camera-sized images, run the
mesh paths over the card listed twice and the multi-device dry run, and
drive the command line.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the twenty-five kernel entries from
     revisit_anything_tpu_torch/kernels/csrc (one nvcc per source, in
     parallel);
  3. print the registers, shared memory and spill bytes of the redesigned
     entry points' kernels (K1, K2, B10, B11, K3, B6, K5, K4, B3 in its
     three modes, B7 in its two layers and B8 at its two depths, K1 f32
     and its K/V split at head dims 64 and 80, K1 f32 with the bias, the
     f32 forms of K2 and B10 (both schedules each) and K5 (both layers
     and its weight split), K3 f32, K4 f32 and B11 f32 at head dims 64
     and 80, B7 f32 in its two layers, B8 f32 at its two depths, B6 f32
     and B3 f32's own kernels: its final walk, which stores keys2, and
     its three token-side kernels) from ptxas.log, and the tensor-core
     instructions in the SASS of B3's three instantiations, B7's layer 2,
     B8's two depths, their f32 forms, B3 f32's final walk, K2 f32's and
     B10 f32's two schedules, B11 f32 at both
     head dims and B6 f32's rebuild (HMMA) and of K1 f32 at head dims 64
     and 80 and with the bias, K5 f32 at both layers, K3 f32 and B6 f32's
     head (TF32 HGMMA) (cuobjdump); then
     compare every kernel with its plain version in bf16 at the main
     path's shapes (K1 also at the offline extraction's batches, and in
     f32, split TF32, at DINOv1's shape and two more within 1e-5; K4, K3,
     K2 and K5 also at multi-crop AMG's crop shapes: 256 prompts, gh
     52; the f32 forms of K1 with the bias, K2, K5, K3 and K4 at the f32
     served query's shapes, B11 f32 at SAM ViT-H's windowed layer and at
     head dim 64 and B10 f32 in both schedules, within 1e-5, B7 f32 at
     its two layers within one bf16 ulp of P, B8 f32 at its two depths
     and B6 f32 (content 3136, M 3) within 1e-5 (1024 prompts, M 4096),
     B3 f32 in its three modes (1024 prompts, M 4096, content 3136:
     the token state within 1e-5, keys2 and the logits per position within
     1e-5 at all but 0.112 of the positions and 2^-7 at those, as its gpu
     tests; P1 and P2 within one bf16 ulp, moved in at most 1e-3 of their
     elements, and C2 within 1e-5; keys mode minus probability mode, the
     time keys2's stores take),
     K4's flags
     equal outside a band
     of 1e-5 of the logits' scale around each threshold, the band's
     pixels counted), timing both with CUDA events (median of 7 after
     warm-up, each call queued behind a device sleep so that its host
     launch cost is not timed), beside its bound (the larger of bytes /
     3.35 TB/s and operations / the H100's peak rate for their type:
     bf16 and TF32 products on the tensor cores, f32 on the FMA units),
     its bound share
     (bound / kernel time) and, where one PyTorch call computes the same
     function, that call's time and the kernel's time over it
     (× library); then the f32 walks' cycles by statement of their tile
     loop (B8 f32 at both depths, B7 f32 layer 2: kernels/probs_compare.py
     --f32 --phases, its two stamped sources built in parallel; lines
     tagged [phases], their wall seconds the walk_phases entry of the
     [phases] line below);
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
 9b. [sam-f32]: SAM ViT-H (planted) and DINOv2-g in f32 from the same
     seed, serving the 3 queries against the same live index with the
     counters reset before each: K1 f32 with the bias 4 times, without
     it 31, K2 f32 3, K5 f32 2, K3 f32 1, K4 f32 1 and no other kernel;
     the planted images first; each query's kept masks against the bf16
     server's (matched at IoU > 0.5: at least 0.9 of them) and against
     the f32 plain path on the card with TF32 off (the same count, each
     at IoU >= 0.95); wall ms, encode and decode stage ms and every stage
     of [split] (CUDA events), peak device memory; then one more planted
     query with the encoder's windowed layers through B11 f32 (counters
     reset first: the same launches plus 28 of B11 f32, no bf16 kernel;
     the planted image first; the kept masks against the f32 plain path
     with plain windows: the same count, each at IoU >= 0.95) and the
     encode stage with plain and kernel windows (CUDA events, median of 3
     after one, in turns); then the f32 "probs_split" two-way transformer
     (decoder.run_two_way_probs) on the first planted query's embedding
     and its 1024 grid prompts, counters reset first: K2 f32 once, B7 f32
     and B8 f32 twice each and no other kernel; against the same call
     with those three swapped for their plain f32 versions (no kernel):
     P1 and P2 within one bf16 ulp, the token state and C2 within 2^-8 of
     their scale; its ms beside the f32 "shared" transformer's (CUDA
     events, median of 3 after one, in turns); then one planted query
     through an f32 server with decode="probs_split", counters reset
     first: K1 f32 with the bias 4, without it 31, K2 f32 1, B7 f32 2, B8
     f32 2, B6 f32 1, K4 f32 1 and no other kernel; the planted image
     first; its kept masks against the f32 "shared" server's (matched at
     IoU > 0.5: at least 0.9 of them) and against the same query with B7,
     B8 and B6 swapped for their plain f32 versions, 256 prompts a decode
     batch (the same count, each at IoU >= 0.95); its decode stage beside
     the f32 "shared" one's (CUDA events, median of 3 after one, in
     turns), wall ms and the seconds the step took; then the same for
     decode="fused_tail_keys" (K2 f32 1, B3 f32 keys mode 1, K3 f32 1)
     and decode="fused_tail_logits" (K2 f32 1, the B3 f32 logits entry
     1), each against the same query with the tail swapped for its plain
     f32 version, and decode="fused_tail_probs" (K2 f32 1, B3 f32
     probability mode 1, B6 f32 1) against the same query with the tail
     and B6 swapped for their plain f32 versions;
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
 13b. [mesh]: a mesh listing the one H100 twice (the machine has one;
     NCCL and several cards cannot run here): sharded_knn_l2 at 100k f32
     rows against knn_l2 (equal distances and index sets), DINOv2-g on 8
     images split by data_parallel_apply against one forward (K1 31 a
     chunk), a row-sharded server against a one-device one through two
     inserts, a removal and 5 queries (equal top-5; each server's
     launches counted on their own, equal, every "shared" kernel among
     them); ms of each;
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
 15. [multicrop]: one planted 240x320 image through multi-crop AMG
     (crop_n_layers=1, crop_n_points_downscale_factor=2,
     min_mask_region_area=100): launches with the counters reset (K1 20,
     K2 15, K5 10, K3 5, K4 5), every mask inside its crop box, no two
     kept boxes above crop_nms_thresh, deterministic, one crop equal to
     generate_masks; seconds an image, the small-region ms;
 16. [predictor]: SamPredictor on a 480x640 image: 8 grid points (each
     mask at IoU >= 0.95 with AMG's "shared" candidate for the point,
     predicted IoU within 2e-2), a box, a mask input, logits; set_image
     and predict ms;
 17. [export]: the decoder exported by torch.export at 256 prompts,
     saved, loaded and called: within 1e-3 of the eager general path;
     export and load seconds, file MiB;
 17b. [preprocess]: SamPredictor.set_image on a 1200x1600 and a
     2048x1536 image (PIL's host downscale into the 1024 frame): K1 4
     launches an image and no other kernel; for the 2048x1536 image,
     against the same calls on the CPU (bf16, and f32 as the witness of
     which side rounds): the
     embedding, 4 grid points' predicted IoUs, their low-res logits, and
     mask flips only where the CPU's logit is within the low-res bound of
     the threshold; ms on the card, s on the CPU;
 18. [datasets]: radius positives of 2,000 UTM points against a brute
     force, an image listing and get_gt("17places") (no sklearn);
 19. [checkpoint]: a seeded original-layout SAM ViT-H state dict saved
     with torch.save and loaded by load_sam_checkpoint, a hub-layout
     DINOv2-g dict converted in memory, both onto the card in bf16 (load
     seconds, peak host RSS, device memory); leaves spot-checked against
     the dicts; one query through them with the "shared" kernels;
 20. [backbones]: full-width models with seeded weights in f32: DINOv1
     ViT-S/8 (hub.load_model) on 8 images of 480x640 through
     dinov1_dense_features (224x298, stride 4: 4,016 tokens; K1 f32
     must launch 11 times and agree within 1e-4 with its plain version
     in its place), CosPlace ViT-B/16, ResNet-50, VLAD-BuFF and
     DINO-SALAD descriptors, fit_wpca to 512 components: images/s, peak
     device memory;
 21. [train]: five VLAD-BuFF steps at the CLI's defaults from seeded
     PNGs (discover_places, PlacesBatcher, prefetch): finite losses,
     frozen parameters bit for bit, every trainable tensor moved; a
     checkpoint after step 3 restored into a fresh state gives step 4's
     loss and parameters within 1e-6; run_validation on 32 + 16 images;
 21a. [sharded-train]: make_sharded_train_step at [train]'s sizes
     against train_step from the same seeded state, three steps: a 1x1
     mesh on an NCCL group of one process, and meshes (1, 2) and (2, 1)
     of two processes on the one card over gloo with CUDA tensors;
     losses within rtol 1e-4, parameters within atol 1e-4, frozen ones
     bit for bit; steps/s of each; then [dryrun]: dryrun_multichip(4)
     over the card listed 4 times (its extraction must launch K1, K2,
     K5, K3 and K4);
 21b. [cli]: cli.main at full width (seeded SAM ViT-H, DINOv2-g layer
     31, in f32 as the JAX CLI): `query` over a 20,000-row index the
     smoke writes (its top-5 equal to the library's f32 SegVLADServer
     built from the same seeds; the "shared" decoder's f32 kernels
     launched), a three-command `serve` loop, `amg` on a
     1200x1600 image, `train` for 3 steps at [train]'s sizes; seconds a
     command (the h5 commands need h5py, absent there: skipped);
 22. print the wall seconds by function of the run ([phases]: every
     function of this script timed, kernels/smoke_phases.py; the build's
     own seconds are the [build] line) and the whole run's, then the
     kernel table as one JSON line (B10, token_cross_split and
     token_cross_split_f32, has no caller on a serving path, as in the JAX
     package: launches 0; the f32 forms' launches are the 3 f32
     queries', B11 f32's the f32 kernel-window query's, B7 f32's, B8
     f32's and B6 f32's the f32 "probs_split" query's, B3 f32's the f32
     "fused_tail_keys" and "fused_tail_logits" queries'), then the result
     line.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time


VARIANTS = ("probs_split", "fused_tail_probs", "fused_tail_keys",
            "fused_tail_logits")

# Wall seconds by function of this run, filled when the script runs as a
# program (kernels/smoke_phases.py time_functions) and printed as the
# [phases] line.
PHASE_SECONDS: dict = {}


def _paths() -> dict:
    """The kernels a served query launches in each decoder form (K1 runs
    the SAM encoder's global layers and DINOv2 in all of them), with the
    window kernel ("shared" decoder), and in f32 (f32 SAM and DINOv2: K1
    f32 with the bias in SAM's global layers, without it in DINOv2's; the
    five decoder forms)."""
    from revisit_anything_tpu_torch.kernels import build as k
    front = (k.FLASH_ATTENTION, k.TOKEN_CROSS, k.RESIZE_FLAGS)
    shared = front + (k.I2T_UPDATE, k.MASK_HEAD)
    front_f32 = (k.FLASH_ATTENTION_F32_BIAS, k.FLASH_ATTENTION_F32,
                 k.TOKEN_CROSS_F32, k.RESIZE_FLAGS_F32)
    return {"shared": shared,
            "shared_f32": front_f32 + (k.I2T_UPDATE_F32, k.MASK_HEAD_F32),
            "probs_split_f32": front_f32 + (k.I2T_PROBS_F32, k.T2I_PROBS_F32,
                                            k.MASK_HEAD_PROBS_F32),
            "fused_tail_keys_f32": front_f32 + (k.DECODE_TAIL_F32,
                                                k.MASK_HEAD_F32),
            "fused_tail_logits_f32": front_f32 + (k.DECODE_TAIL_LOGITS_F32,),
            "fused_tail_probs_f32": front_f32 + (k.DECODE_TAIL_F32,
                                                 k.MASK_HEAD_PROBS_F32),
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
    ("flash_attention_tf32x3_kernelILi64ELi0E", "K1 f32 Dh 64 (split TF32)",
     "rat_flash_attention_f32", "rat_flash_attention_f32_smem", (64, 0)),
    ("flash_attention_tf32x3_kernelILi80ELi0E", "K1 f32 Dh 80 (split TF32)",
     "rat_flash_attention_f32", "rat_flash_attention_f32_smem", (80, 0)),
    ("flash_attention_tf32x3_kernelILi80ELi2E", "K1 f32 Dh 80 + bias side 64",
     "rat_flash_attention_f32_bias", "rat_flash_attention_f32_smem",
     (80, 2)),
    ("flash_attention_tf32x3_kernelILi80ELi1E", "K1 f32 Dh 80 + bias other",
     "rat_flash_attention_f32_bias", "rat_flash_attention_f32_smem",
     (80, 0)),
    ("flash_attention_tf32x3_kernelILi64ELi2E", "K1 f32 Dh 64 + bias side 64",
     "rat_flash_attention_f32_bias", "rat_flash_attention_f32_smem",
     (64, 2)),
    ("token_cross_kv_tf32x3_kernelILb1ELb1E", "K2 f32 shared k|v (split TF32)",
     "rat_token_cross_kv_f32", "rat_token_cross_f32_smem", (1,)),
    ("token_cross_kv_tf32x3_kernelILb1ELb0E", "K2 f32 per-prompt k|v",
     "rat_token_cross_kv_f32", "rat_token_cross_f32_smem", (0,)),
    ("token_cross_kv_tf32x3_kernelILb0ELb1E", "B10 f32 shared k, v",
     "rat_token_cross_f32", "rat_token_cross_f32_smem", (1,)),
    ("token_cross_kv_tf32x3_kernelILb0ELb0E", "B10 f32 per-prompt k, v",
     "rat_token_cross_f32", "rat_token_cross_f32_smem", (0,)),
    ("win_attention_tf32x3_kernelILi80E", "B11 f32 hd 80 (at side 14)",
     "rat_win_attention_f32", "rat_win_attention_f32_smem", (14, 80)),
    ("win_attention_tf32x3_kernelILi64E", "B11 f32 hd 64 (at side 14)",
     "rat_win_attention_f32", "rat_win_attention_f32_smem", (14, 64)),
    ("i2t_update_tf32x3_kernelILb1E", "K5 f32 layer 1 (split TF32)",
     "rat_i2t_update_f32", "rat_i2t_update_f32_smem", ()),
    ("i2t_update_tf32x3_kernelILb0E", "K5 f32 layer 2 (split TF32)",
     "rat_i2t_update_f32", "rat_i2t_update_f32_smem", ()),
    ("split_weights_kernel", "K5 f32 weight split", "rat_i2t_update_f32",
     None, ()),
    ("mask_head_tf32x3_kernelILi3ELb0E", "K3 f32 M 3 (split TF32)",
     "rat_mask_head_f32", "rat_mask_head_f32_smem", ()),
    ("mask_head_tf32x3_kernelILi3ELb1E", "B6 f32 M 3 (split TF32)",
     "rat_mask_head_probs_f32", "rat_mask_head_f32_smem", ()),
    ("split_head_weights_kernel", "K3 f32 weight split", "rat_mask_head_f32",
     None, ()),
    ("resize_flags_kernelILi3ELb1EfE", "K4 f32 M 3 (240x320)",
     "rat_resize_flags_f32", "rat_resize_flags_f32_smem", (3, 320, 240)),
    ("split_kv_kernelILi64E", "K1 f32 Dh 64 K/V split",
     "rat_flash_attention_f32", "rat_flash_attention_f32_smem", (64, 1)),
    ("split_kv_kernelILi80E", "K1 f32 Dh 80 K/V split",
     "rat_flash_attention_f32", "rat_flash_attention_f32_smem", (80, 1)),
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
    ("resize_flags_kernelILi3ELb1E13__nv_bfloat16", "K4 M 3 (240x320)",
     "rat_resize_flags", "rat_resize_flags_smem", (3, 320, 240)),
    ("decode_tail_kernelILi0E", "B3 keys mode", "rat_decode_tail",
     "rat_decode_tail_smem", ()),
    ("decode_tail_kernelILi1E", "B3 probability mode", "rat_decode_tail",
     "rat_decode_tail_smem", ()),
    ("decode_tail_kernelILi2E", "B3 logits mode (then K3)",
     "rat_decode_tail_logits", "rat_decode_tail_smem", ()),
    ("i2t_probs_l1_kernelI13__nv_bfloat16E", "B7 layer 1", "rat_i2t_probs",
     "rat_i2t_probs_smem", (1,)),
    ("i2t_probs_l2_kernelI13__nv_bfloat16E", "B7 layer 2", "rat_i2t_probs",
     "rat_i2t_probs_smem", (2,)),
    ("t2i_probs_kernelI13__nv_bfloat16Li1E", "B8 depth 1", "rat_t2i_probs",
     "rat_t2i_probs_smem", (1,)),
    ("t2i_probs_kernelI13__nv_bfloat16Li2E", "B8 depth 2", "rat_t2i_probs",
     "rat_t2i_probs_smem", (2,)),
    ("i2t_probs_l1_kernelIfE", "B7 f32 layer 1", "rat_i2t_probs_f32",
     "rat_i2t_probs_f32_smem", (1,)),
    # the f32 walks (walk_f32.cuh walk_f32_kernel<DEPTH, KIND>: KIND 0
    # attend, 1 attend and store keys2, 2 B7's P2)
    ("walk_f32_kernelILi1ELi2E", "B7 f32 layer 2", "rat_i2t_probs_f32",
     "rat_i2t_probs_f32_smem", (2,)),
    ("walk_f32_kernelILi1ELi0E", "B8 f32 depth 1", "rat_t2i_probs_f32",
     "rat_t2i_probs_f32_smem", (1,)),
    ("walk_f32_kernelILi2ELi0E", "B8 f32 depth 2", "rat_t2i_probs_f32",
     "rat_t2i_probs_f32_smem", (2,)),
    # B3 f32: its walks are B7 f32's two kernels, B8 f32 at depth 1 and
    # this depth-2 walk that stores keys2 (probability mode: B8 f32 at
    # depth 2 above); its token side these three
    ("walk_f32_kernelILi2ELi1E", "B3 f32 final walk (+ keys2)",
     "rat_decode_tail_f32", "rat_t2i_probs_f32_smem", (2,)),
    ("tail_queries_f32_kernel", "B3 f32 token queries",
     "rat_decode_tail_f32", None, ()),
    ("tail_mid_f32_kernel", "B3 f32 token mid-ops (MLP 2048)",
     "rat_decode_tail_f32", "rat_decode_tail_f32_smem", (2048,)),
    ("tail_final_f32_kernelILb0E", "B3 f32 final token ops",
     "rat_decode_tail_f32", None, ()),
    ("tail_final_f32_kernelILb1E", "B3 f32 final ops + hypernetwork",
     "rat_decode_tail_logits_f32", None, ()),
)

# The kernels whose products run by mma.sync (HMMA): B3's instantiations,
# by their emission (keys, probability, logits mode), B7's layer 2, B8's
# two depths and their f32 forms (fp16: the f32 rebuild's planes), K2
# f32's and B10 f32's two schedules, B11 f32's two head dims and B6 f32's
# rebuild (TF32); and K1 f32's, K5 f32's, K3 f32's and B6 f32's head, by
# TF32 wgmma (HGMMA ... TF32): (piece of the mangled name, label, the
# instruction that must be there)
# the f32 rebuild's fp16 product at depth 8 (the bf16 kernels' are
# HMMA.1688.F32.BF16)
F16_K8 = r"HMMA\.1688\.F32(\.F16)?$"
MMA_SASS = (("decode_tail_kernelILi0E", "B3 keys mode", "HMMA"),
            ("decode_tail_kernelILi1E", "B3 probability mode", "HMMA"),
            ("decode_tail_kernelILi2E", "B3 logits mode", "HMMA"),
            ("i2t_probs_l2_kernelI13__nv_bfloat16E", "B7 layer 2", "HMMA"),
            ("t2i_probs_kernelI13__nv_bfloat16Li1E", "B8 depth 1",
             "HMMA"),
            ("t2i_probs_kernelI13__nv_bfloat16Li2E", "B8 depth 2",
             "HMMA"),
            ("walk_f32_kernelILi1ELi2E", "B7 f32 layer 2", F16_K8),
            ("walk_f32_kernelILi1ELi0E", "B8 f32 depth 1", F16_K8),
            ("walk_f32_kernelILi2ELi0E", "B8 f32 depth 2", F16_K8),
            ("walk_f32_kernelILi2ELi1E", "B3 f32 final walk (+ keys2)",
             F16_K8),
            ("flash_attention_tf32x3_kernelILi64ELi0E", "K1 f32 Dh 64",
             "HGMMA.*TF32"),
            ("flash_attention_tf32x3_kernelILi80ELi0E", "K1 f32 Dh 80",
             "HGMMA.*TF32"),
            ("flash_attention_tf32x3_kernelILi80ELi2E",
             "K1 f32 Dh 80 + bias side 64", "HGMMA.*TF32"),
            ("mask_head_tf32x3_kernelILi3ELb0E", "K3 f32 M 3", "HGMMA.*TF32"),
            ("mask_head_tf32x3_kernelILi3ELb1E", "B6 f32 M 3 (head)",
             "HGMMA.*TF32"),
            ("mask_head_tf32x3_kernelILi3ELb1E", "B6 f32 M 3 (rebuild)",
             "HMMA.*TF32"),
            ("i2t_update_tf32x3_kernelILb1E", "K5 f32 layer 1", "HGMMA.*TF32"),
            ("i2t_update_tf32x3_kernelILb0E", "K5 f32 layer 2", "HGMMA.*TF32"),
            ("token_cross_kv_tf32x3_kernelILb1ELb1E", "K2 f32 shared k|v",
             "HMMA.*TF32"),
            ("token_cross_kv_tf32x3_kernelILb1ELb0E", "K2 f32 per-prompt k|v",
             "HMMA.*TF32"),
            ("token_cross_kv_tf32x3_kernelILb0ELb1E", "B10 f32 shared k, v",
             "HMMA.*TF32"),
            ("token_cross_kv_tf32x3_kernelILb0ELb0E", "B10 f32 per-prompt k, v",
             "HMMA.*TF32"),
            ("win_attention_tf32x3_kernelILi80E", "B11 f32 hd 80", "HMMA.*TF32"),
            ("win_attention_tf32x3_kernelILi64E", "B11 f32 hd 64", "HMMA.*TF32"))


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
              f"{getattr(lib, smem_fn)(*smem_args) if smem_fn else 0} B "
              f"dynamic a CTA, spill "
              f"stores {stores} B, loads {loads} B"
              f"{', wgmma serialized (C751x)' if serial else ''}", flush=True)
    sass_report(MMA_SASS)


def sass_report(kernels) -> None:
    """Count the tensor-core instructions (HMMA and HGMMA, by shape and
    type) in the SASS of each of ``kernels`` ((piece of the mangled name,
    label, a pattern one of them must match)), from one cuobjdump of the
    built library; fail where none matches."""
    import collections
    import re
    import shutil

    from revisit_anything_tpu_torch.kernels import build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    res = subprocess.run([tool, "-sass", str(build.library_path())],
                         capture_output=True, text=True, check=True)
    for key, label, need in kernels:
        funcs = [f for f in res.stdout.split("Function : ")[1:]
                 if key in f.split("\n", 1)[0]]
        if not funcs:
            _fail(f"cuobjdump: no kernel {key}")
        kinds = collections.Counter(re.findall(r"\bHG?MMA\.[0-9A-Za-z.]+",
                                               funcs[0]))
        if not any(re.match(need, k) for k in kinds):
            _fail(f"{label}: no {need} in its SASS")
        print(f"[sass] {label} ({key}): {sum(kinds.values())} tensor-core "
              "instructions ("
              + ", ".join(f"{n} {k}" for k, n in sorted(kinds.items()))
              + ")", flush=True)


def walk_phases() -> None:
    """The f32 walks' cycles by statement of their tile loops
    (kernels/probs_compare.py's probe, on this checkout's sources); fails
    if a walk's stamps were not all taken."""
    from revisit_anything_tpu_torch.kernels import probs_compare
    totals = probs_compare._phases_f32(probs_compare._ROOT)
    if len(totals) != 3 or not all(math.isfinite(t) and t > 0
                                   for t in totals.values()):
        _fail(f"the f32 walks' phase probe read no cycles: {totals}")


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
              library=None, plain_prompts=None, rate=False):
        """``ins`` the inputs the function must read (views where it
        reads part of a tensor), ``ops`` = (bf16 FLOP, f32 FLOP[, TF32
        FLOP]) its arithmetic; ``plain_prompts``: the plain version ran on only the
        first prompts, and the kernel's output for those is compared;
        ``rate``: also print the achieved GB/s (the bytes it must read
        and write over the kernel's time)."""
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
              f"kernel {ms:.3f} ms  plain "
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
        return row

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

    # K1 in f32 (DINOv1's f32 extraction, an f32 DINOv2 at N >= 1024):
    # products as three TF32 passes of split operands (~2^-21 each) and
    # ex2.approx, relative 1e-5 (library: scaled_dot_product_attention in
    # f32 with TF32 off). Bound: the three passes' 3·4·N²·Dh FLOP a head
    # at the TF32 rate, beside the softmax's f32 operations on the FMA
    # units, 5 a score (the max, the exponent's multiply-add as 2, the row
    # sum's add and the split's subtraction; ex2 runs on the SFU and the
    # TF32 roundings are integer operations). Bytes: q, k, v and out once
    # (the K/V split's scratch is the kernel's own traffic).
    for b, h, n, dh, what in (
            (8, 6, 4016, 64, "DINOv1 ViT-S/8 224x298 s4"),
            (1, 1, 1025, 64, "shortest K1 length"),
            (2, 1, 1531, 80, "head dim 80"),
            (1, 24, 1531, 64, "f32 query's DINOv2-g")):
        q, k, v = (torch.randn((b, h, n, dh), generator=g, device=dev)
                   for _ in range(3))
        check(build.FLASH_ATTENTION_F32,
              f"{what} q/k/v [{b},{h},{n},{dh}] f32",
              lambda: att.attend(q, k, v),
              lambda: att.attend_reference(q, k, v), _rel, 1e-5, (q, k, v),
              (0, 5 * b * h * n * n, 3 * 4 * b * h * n * n * dh),
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
    compare_f32_kernels(dev, check)
    compare_crop_shapes(dev, check, rnd, rel_tol, flag_tol, flags_err)
    compare_probs_kernels(dev, check, head, rel_tol)
    return results


# The f32 forms against their plain versions in f32 with TF32 off: max
# |kernel - plain| / max |plain| (K4: flags equal but where the plain
# logit lies within this share of the logits' scale from a threshold)
F32_REL = 1e-5


def compare_f32_kernels(dev, check) -> None:
    """The f32 forms of the default SAM path's kernels (an f32 SAM, the
    JAX package's default dtype) at the f32 served query's shapes: K1 with
    the bias (SAM ViT-H's global layer) and without it at the same shape
    (the bias form's floor), K2 (shared and per-prompt k|v,
    1024 prompts), K5 (layers 1 and 2), K3 (1024 prompts, content 3136,
    M 3) and K4 (17places); and the window kernel's (SAM ViT-H's windowed
    layer, and at head dim 64) and B10's (as K2's), and B7's (layers 1 and
    2) and B8's (depths 1 and 2) at the "probs_split" decode's (1024
    prompts, M 4096, P bf16); each against its plain
    version in f32 with TF32 off. Bound (as K1 f32's rows): the larger of the bytes over
    3.35 TB/s and the products as three TF32 passes at 495 TFLOP/s; K1's
    softmax operations on the FMA units as in its no-bias rows, K4's taps
    as f32 FMAs as in its bf16 row; B7's and B8's as compare_probs_f32
    says."""
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

    g = torch.Generator(device=dev).manual_seed(2323)

    def rnd(*shape, s=1.0, off=0.0):
        return torch.randn(shape, generator=g, device=dev) * s + off

    # K1 f32 + bias (library: SDPA in f32, the bias expanded into its
    # attn_mask outside the timed call)
    q, k, v = (rnd(1, 16, 4096, 80) for _ in range(3))
    bh, bw = rnd(1, 16, 4096, 64), rnd(1, 16, 4096, 64)
    mask = bh.repeat_interleave(64, dim=-1) + bw.repeat(1, 1, 1, 64)
    # and after it K1 f32 without the bias at the same shape, the bias
    # form's floor
    n2 = 16 * 4096 ** 2
    check(build.FLASH_ATTENTION_F32_BIAS,
          "SAM global q/k/v [1,16,4096,80] + bias f32",
          lambda: att.attend(q, k, v, bh, bw, side=64),
          lambda: att.attend_reference(q, k, v, bh, bw, side=64),
          _rel, F32_REL, (q, k, v, bh, bw),
          (0, 7 * n2, 3 * 4 * n2 * 80),
          library=lambda: F.scaled_dot_product_attention(q, k, v,
                                                         attn_mask=mask))
    del mask
    check(build.FLASH_ATTENTION_F32,
          "SAM global q/k/v [1,16,4096,80] f32, no bias",
          lambda: att.attend(q, k, v), lambda: att.attend_reference(q, k, v),
          _rel, F32_REL, (q, k, v), (0, 5 * n2, 3 * 4 * n2 * 80),
          library=lambda: F.scaled_dot_product_attention(q, k, v))
    del q, k, v, bh, bw
    torch.cuda.empty_cache()

    # K2 f32 (library: SDPA in f32 on k + pe and v + bias formed outside
    # the timed call)
    qt = rnd(1024, 7, 128)
    pe, vb = rnd(1, 128, 4096), rnd(128)
    for lead, label in (
            (1, "q [1024,7,128] kvt [1,256,4096] shared f32"),
            (1024, "q [1024,7,128] kvt [1024,256,4096] f32")):
        kvt = rnd(lead, 256, 4096)
        k_l = (kvt[:, :128] + pe).reshape(lead, 8, 16, 4096).transpose(
            2, 3).contiguous()
        v_l = (kvt[:, 128:] + vb[:, None]).reshape(lead, 8, 16, 4096
                                                  ).transpose(2, 3).contiguous()
        q_l = qt.reshape(1024, 7, 8, 16).transpose(1, 2)
        q_l = (q_l.transpose(0, 1).reshape(1, 8, 1024 * 7, 16) if lead == 1
               else q_l).contiguous()
        check(build.TOKEN_CROSS_F32, label,
              lambda: att.token_cross_attend_kv(qt, kvt, pe, vb, 8),
              lambda: att.token_cross_attend_kv_reference(qt, kvt, pe, vb,
                                                          8),
              _rel, F32_REL, (qt, kvt, pe, vb),
              (0, 0, 3 * 4 * 1024 * 8 * 7 * 4096 * 16),
              library=lambda: F.scaled_dot_product_attention(q_l, k_l, v_l))
        del kvt, k_l, v_l, q_l
    del pe, vb

    # B10 f32: K2 f32's kernel without pe and v bias on separate kᵀ, vᵀ
    # (library: SDPA in f32, k and v laid out for it outside the timed call)
    for lead, label in ((1, "q [1024,7,128] kt, vt [1,128,4096] shared f32"),
                        (1024, "q [1024,7,128] kt, vt [1024,128,4096] f32")):
        kt, vt = rnd(lead, 128, 4096), rnd(lead, 128, 4096)
        k_l, v_l = (x.reshape(lead, 8, 16, 4096).transpose(2, 3).contiguous()
                    for x in (kt, vt))
        q_l = qt.reshape(1024, 7, 8, 16).transpose(1, 2)
        q_l = (q_l.transpose(0, 1).reshape(1, 8, 1024 * 7, 16) if lead == 1
               else q_l).contiguous()
        check(build.TOKEN_CROSS_SPLIT_F32, label,
              lambda: att.token_cross_attend(qt, kt, vt, 8),
              lambda: att.token_cross_attend_reference(qt, kt, vt, 8),
              _rel, F32_REL, (qt, kt, vt),
              (0, 0, 3 * 4 * 1024 * 8 * 7 * 4096 * 16),
              library=lambda: F.scaled_dot_product_attention(q_l, k_l, v_l))
        del kt, vt, k_l, v_l, q_l
    del qt
    torch.cuda.empty_cache()

    # B11 f32: SAM ViT-H's windowed layer (25 windows of 14x14, 16 heads of
    # 80) and ViT-L's (16 heads of 64). Library: SDPA in f32, q/k/v split
    # and the bias expanded into its attn_mask outside the timed call.
    # Bound: the products as three TF32 passes, the bias and softmax's f32
    # operations as K1 f32 + bias's (7 a score).
    for heads, hd, what in ((16, 80, "ViT-H"), (16, 64, "ViT-L")):
        d = heads * hd
        qkv = rnd(25, 196, 3 * d)
        bh, bw = rnd(25, 196, heads * 14), rnd(25, 196, heads * 14)
        q, k, v = (qkv[..., i * d:(i + 1) * d].reshape(25, 196, heads, hd)
                   .transpose(1, 2).contiguous() for i in range(3))
        mask = (bh.reshape(25, 196, heads, 14).transpose(1, 2)
                .repeat_interleave(14, dim=-1)
                + bw.reshape(25, 196, heads, 14).transpose(1, 2)
                .repeat(1, 1, 1, 14))
        n2 = 25 * heads * 196 ** 2
        check(build.WIN_ATTENTION_F32,
              f"{what} qkv [25,196,{3 * d}] + bias [25,196,{heads * 14}] f32",
              lambda: wa.windowed_attend(qkv, bh, bw, heads, 14),
              lambda: wa.windowed_attend_reference(qkv, bh, bw, heads, 14),
              _rel, F32_REL, (qkv, bh, bw), (0, 7 * n2, 3 * 4 * n2 * hd),
              library=lambda: F.scaled_dot_product_attention(q, k, v,
                                                             attn_mask=mask))
        del qkv, bh, bw, q, k, v, mask
    torch.cuda.empty_cache()

    # K5 f32: layer 1 (shared branch) and layer 2 (per prompt). Bound: the
    # products as three TF32 passes (the 8 x 7 attention's 2·2·8·7·16 FLOP
    # a (prompt, position) too, on the tensor cores as the kernel runs
    # them), q = x·Wq counted once a position at layer 1: the kernel
    # computes it once a position block, since it does not depend on the
    # prompt (the first f32 design's bound, 6.755 ms at both layers,
    # counted it once a prompt).
    for lead, label in (
            (1, "img [1,4096,256] shared, 1024 prompts f32"),
            (1024, "img [1024,4096,256] f32")):
        q_rows = 4096 if lead == 1 else 1024 * 4096
        iargs = (rnd(lead, 4096, 256), rnd(1, 4096, 128), rnd(1024, 7, 128),
                 rnd(1024, 7, 128), rnd(256, 128, s=0.1), rnd(128, s=0.1),
                 rnd(128, 256, s=0.1), rnd(256, s=0.1),
                 rnd(256, s=0.1, off=1.0), rnd(256, s=0.1),
                 rnd(256, 256, s=0.1))
        check(build.I2T_UPDATE_F32, label,
              lambda: att.i2t_update(*iargs, 8, 1e-6),
              lambda: att.i2t_update_reference(*iargs, 8, 1e-6),
              _tuple_err, F32_REL, iargs,
              (0, 0, 3 * (2 * q_rows * 256 * 128
                          + 2 * 1024 * 4096 * (128 * 256 + 256 * 256)
                          + 2 * 2 * 1024 * 4096 * 8 * 7 * 16)))
        del iargs
        torch.cuda.empty_cache()

    # K3 f32: 1024 prompts, content 49 rows x 64 = 3136 positions
    margs = (rnd(1024, 4096, 256), rnd(1024, 3, 32, s=0.5),
             rnd(256, 256, s=0.1), rnd(64, s=0.1), rnd(64, s=0.1, off=1.0),
             rnd(64, s=0.1), rnd(64, 128, s=0.1), rnd(32, s=0.1))
    head_products = 2 * (256 * 256 + 4 * 64 * 128 + 16 * 32 * 3)
    check(build.MASK_HEAD_F32,
          "keys [1024,4096,256] -> [1024,3136,16,3] f32",
          lambda: mh.fused_mask_head(*margs, eps=1e-6, content=3136),
          lambda: mh.upscale_masks_blocks(margs[0][:, :3136], *margs[1:],
                                          eps=1e-6),
          _rel, F32_REL, (margs[0][:, :3136],) + margs[1:],
          (0, 0, 3 * 1024 * 3136 * head_products))
    del margs
    torch.cuda.empty_cache()

    # K4 f32: the 17places resize over f32 logits with unrounded f32 taps;
    # flags may differ only within F32_REL of a threshold
    wh, ww, gh = resize_mats_and_rows(SAM_VIT_H, (768, 1024), (240, 320))
    whd, wwd = torch.from_numpy(wh).to(dev), torch.from_numpy(ww).to(dev)
    taps = tuple(t.to(dev) for t in mr.resize_taps(wh, ww, torch.float32))
    logits = rnd(1024, gh * 64, 16, 3, s=4.0)
    near = mr.near_threshold(mr.resize_logits_reference(logits, whd, wwd,
                                                        (gh, 64)),
                             (-1.0, 0.0, 1.0), F32_REL)

    def flags_err_f32(out_k, flags_p):
        flags, rowst, colany = out_k
        own_rowst, own_colany = mr.flag_stats(flags)
        if not (torch.equal(rowst, own_rowst)
                and torch.equal(colany, own_colany)):
            _fail("resize_flags_f32: stats differ from its own flags")
        diff = flags != flags_p
        outside = int((diff & ~near).sum())
        print(f"[kernel] resize_flags_f32: {int(near.sum())} pixels of "
              f"{near.numel()} lie within {F32_REL:g} of the logits' scale "
              f"from a threshold; flags differ at {int(diff.sum())} "
              f"pixels, {outside} of them outside that band", flush=True)
        return diff.float().mean().item(), outside / diff.numel()

    n_taps = int((whd != 0).sum()) * 4 * 64 + 240 * int((wwd != 0).sum())
    check(build.RESIZE_FLAGS_F32,
          "logits [1024,3136,16,3] f32 -> flags [1024,3,240,320]",
          lambda: mr.fused_resize_flags(logits, whd, wwd, 0.0, 1.0, (gh, 64),
                                        taps=taps),
          lambda: mr.resize_flags_reference(logits, whd, wwd, 0.0, 1.0,
                                            (gh, 64)),
          flags_err_f32, 0.0, (logits,) + taps, (0, 2 * 1024 * 3 * n_taps),
          rate=True)
    del logits, near
    torch.cuda.empty_cache()
    compare_probs_f32(dev, check, rnd)
    compare_tail_f32(dev, check, rnd)


def compare_tail_f32(dev, check, rnd) -> None:
    """B3 f32 in keys mode, probability mode and logits mode (content
    3136) at 1024 prompts and M 4096 on an f32 SAM ViT-H decoder with
    seeded random weights (N(0, 0.05²), LayerNorm scales 1 + N(0,
    0.05²)), against the plain f32 version (TF32 off) on the first 256
    prompts, the kernel timed at 1024; the probability mode's P1 and P2
    within one bf16 ulp, moved in at most PROBS_F32_MOVED of their
    elements (B7 f32's criterion), its C2 and token state within F32_REL;
    the keys mode's time minus the probability mode's (the same walks
    but for keys2's stores, timed in this call).
    Bound: bytes (the inputs once, keys2 f32, P1, P2 and C2, or the
    logits once), against
    the products the function needs at the fp16 rate, each [56, 256]
    rows-against-the-branch product a pass: keys1 rebuilt twice (the
    layer-2 token -> image pass and pass B, as bf16 B3 walks) and keys2
    once, two passes each, three score products and two contexts, three
    passes each (21 passes; the entry's split pass B rebuilds keys1 a
    third time, 2 passes of its own overhead, not counted); the four pe
    terms and the token side (dense layers, C2) as f32 FMAs; in logits
    mode also K3 f32's three TF32 passes over content and the
    hypernetwork MLPs."""
    import torch

    from revisit_anything_tpu_torch.kernels import build
    from revisit_anything_tpu_torch.kernels.probs_compare import (
        PROBS_F32_MOVED, bf16_ulps)
    from revisit_anything_tpu_torch.kernels.tail_compare import (
        TAIL_F32_MOVED, TAIL_F32_MOVED_REL, moved_positions)
    from revisit_anything_tpu_torch.models.sam import SAM_VIT_H
    from revisit_anything_tpu_torch.models.sam.decoder import MaskDecoder
    from revisit_anything_tpu_torch.ops import decode_fused as dfu

    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(4329)
    b, m, d, da, ht, c, content = 1024, 4096, 256, 128, 56, 256, 3136
    dec = MaskDecoder(SAM_VIT_H, dtype=torch.float32, device=dev)
    with torch.no_grad():
        for name, prm in dec.named_parameters():
            x = torch.randn(prm.shape, generator=g, device=dev) * 0.05
            prm.copy_(x + 1.0 if name.endswith("scale") else x)
    img0, q1st, peq2t, pek2t, pekft = (rnd(1, m, d), rnd(1, da, m),
                                       rnd(1, da, m), rnd(1, da, m),
                                       rnd(1, da, m))
    tok_k, c1 = rnd(b, 7, da), rnd(b, ht, d, s=0.3)
    qin, tok = rnd(b, 7, d), rnd(b, 7, d)
    shared = (img0, q1st, peq2t, pek2t, pekft)
    weights = [prm for mod in (dec.layers[1], dec.final_attn,
                               dec.norm_final) for prm in mod.parameters()]
    rows = dfu.branch_rows(dec, torch.float32)
    tail_ins = [*shared, tok_k, c1, qin, tok, rows] + weights
    rows_x_branch = 2 * b * m * ht * d
    pe_term = 2 * b * ht * m * 16
    mlp = SAM_VIT_H.decoder_mlp_dim
    token = 2 * b * 7 * (2 * d * mlp + 3 * d * da + 2 * da * d) \
        + 2 * b * ht * 16 * d
    tail_ops = (21 * rows_x_branch, 4 * pe_term + token)

    def tail_err(got, want):
        """The token state's relative error (the row's rel_err, held to
        F32_REL); keys2's or the logits' per position, failing outside
        the gpu tests' criterion (kernels/tail_compare.py
        TAIL_F32_MOVED's note); (the largest |diff| of either, the token
        state's relative error)."""
        d0, rel0 = _rel(got[0], want[0])
        moved, worst = moved_positions(got[1], want[1], got[1].dim() - 2,
                                       F32_REL)
        print(f"[kernel] decode tail f32: {moved:.3e} of the "
              f"{'keys2' if got[1].dim() == 3 else 'logits'} positions "
              f"beyond {F32_REL:g} of the scale (tol {TAIL_F32_MOVED:g}), "
              f"the largest {worst:.3e} (tol {TAIL_F32_MOVED_REL:g})",
              flush=True)
        if moved > TAIL_F32_MOVED or worst > TAIL_F32_MOVED_REL:
            _fail(f"decode tail f32: {moved:.3e} of the positions moved, "
                  f"the largest by {worst:.3e}")
        return max(d0, (got[1] - want[1]).abs().max().item()), rel0

    def probs_err(got, want):
        """P1 and P2 in bf16 ulps of the plain version's, failing above one
        ulp or PROBS_F32_MOVED of their elements moved; (the largest
        |diff| of the four outputs, the largest relative error of the
        token state and C2, held to F32_REL)."""
        for name, p, pw in (("P1", got[1], want[1]), ("P2", got[2], want[2])):
            ulps, moved = bf16_ulps(p, pw)
            print(f"[kernel] decode tail f32 probability mode: {moved:.3e} "
                  f"of {name}'s bf16 elements differ from the plain "
                  f"version's (tol {PROBS_F32_MOVED:g}), by at most "
                  f"{ulps:.3f} ulp", flush=True)
            if ulps > 1.0 or moved > PROBS_F32_MOVED:
                _fail(f"decode tail f32 probability mode: {name} moved in "
                      f"{moved:.3e} of its elements, by {ulps} ulp")
        errs = [_rel(a, w) for a, w in zip(got, want)]
        return (max(e[0] for e in errs),
                max(errs[0][1], errs[3][1]))

    args = (dec, *shared, tok_k, c1, qin, tok, 8, 1e-6)
    args_c = (dec, *shared, tok_k[:c], c1[:c], qin[:c], tok[:c], 8, 1e-6)
    with torch.inference_mode():
        keys_row = check(
            build.DECODE_TAIL_F32, "keys mode -> keys2 [1024,4096,256] f32",
            lambda: dfu.decode_tail_fused(*args, emit_keys=True),
            lambda: dfu.decode_tail_reference(*args_c, emit_keys=True),
            tail_err, F32_REL, tail_ins, tail_ops, plain_prompts=c)
        torch.cuda.empty_cache()
        probs_row = check(
            build.DECODE_TAIL_F32,
            "probability mode -> P1, P2 [1024,56,4096], C2",
            lambda: dfu.decode_tail_fused(*args),
            lambda: dfu.decode_tail_reference(*args_c),
            probs_err, F32_REL, tail_ins, tail_ops, plain_prompts=c)
        torch.cuda.empty_cache()
        print(f"[kernel] decode tail f32: keys mode {keys_row['ms']:.3f} ms "
              f"- probability mode {probs_row['ms']:.3f} ms = "
              f"{keys_row['ms'] - probs_row['ms']:.3f} ms, keys2's stores "
              f"(the same walks otherwise; this call)", flush=True)
        head_ins = [prm for name, prm in dec.named_parameters()
                    if name.startswith(("up", "hyper_mlps.1", "hyper_mlps.2",
                                        "hyper_mlps.3"))]
        head_flop = 2 * (256 * 256 + 4 * 64 * 128 + 16 * 32 * 3)
        hyper_flop = 2 * b * 3 * (2 * d * d + d * 32)
        check(build.DECODE_TAIL_LOGITS_F32,
              "logits mode -> [1024,3136,16,3] f32",
              lambda: dfu.decode_tail_fused(*args, mask_head=True,
                                            content=content),
              lambda: dfu.decode_tail_reference(*args_c, mask_head=True,
                                                content=content),
              tail_err, F32_REL, tail_ins + head_ins,
              (tail_ops[0], tail_ops[1] + b * content * HEAD_F32 + hyper_flop,
               3 * b * content * head_flop), plain_prompts=c)
    del dec, args, args_c, tail_ins, weights
    torch.cuda.empty_cache()
    print(f"[kernel] decode tail f32 rows: {time.perf_counter() - t0:.1f} s",
          flush=True)


def compare_probs_f32(dev, check, rnd) -> None:
    """B7 f32 (layers 1 and 2), B8 f32 (depths 1 and 2) and B6 f32
    (content 3136, M 3) at 1024 prompts and M 4096, with inputs as
    compare_probs_kernels makes them but in f32 (P bf16); the plain
    versions on the first 256 prompts (their f32 [B, 4096, 256] branch),
    the kernel timed at 1024. B8 f32 and B6 f32 within F32_REL; B7 f32's
    bf16 P within one bf16 ulp of its plain version everywhere (its error
    column is the largest |diff| in ulps), the share of elements that
    differ at most PROBS_F32_MOVED. Bound: bytes, against the products as
    the kernels run them on the tensor cores, B7's and B8's at the fp16
    rate (BF16_FLOP_S, the same on the H100): each rebuild's P·C as two
    passes (P x 2^15 is exact in fp16, C two 11-bit planes), the scores'
    and the context's as three (both operands two planes), and the pe
    terms as f32 multiply-adds; B6 f32's at the TF32 rate (its own note)."""
    import torch

    from revisit_anything_tpu_torch.kernels import build
    from revisit_anything_tpu_torch.kernels.probs_compare import (
        PROBS_F32_MOVED, bf16_ulps)
    from revisit_anything_tpu_torch.ops import decode_probs as dpr
    from revisit_anything_tpu_torch.ops import maskhead as mh

    g = torch.Generator(device=dev).manual_seed(4323)
    b, m, d, da, ht, c = 1024, 4096, 256, 128, 56, 256

    def probs(n):
        x = torch.randn((n, 8, 7, m), generator=g, device=dev) * 2.0
        return torch.softmax(x, dim=2).reshape(n, ht, m).to(torch.bfloat16)

    rows = torch.zeros((8, d), device=dev)
    rows[[0, 3]] = rnd(2, d, s=0.1)
    rows[[1, 4]] = rnd(2, d, s=0.1, off=1.0)
    rows[[2, 5]] = rnd(2, d, s=0.1)
    img0, q1st, peqt = rnd(1, m, d), rnd(1, da, m), rnd(1, da, m)
    tok_k, qt = rnd(b, 7, da), rnd(b, 7, da)
    p1, p2 = probs(b), probs(b)
    c1, c2 = rnd(b, ht, d, s=0.3), rnd(b, ht, d, s=0.3)
    w_q, w_k, w_v, vb = (rnd(d, da, s=0.1), rnd(d, da, s=0.1),
                         rnd(d, da, s=0.1), rnd(da, s=0.1))
    recon = 2 * b * m * ht * d          # one rebuild's P·C
    rows_x_branch = 2 * b * m * ht * d  # [56, 256] rows against the branch
    pe_term = 2 * b * ht * m * 16

    def ulp_err(got, want):
        """(largest |diff|, largest |diff| in bf16 ulps of the plain value);
        prints the share of P's elements that differ, and fails above
        PROBS_F32_MOVED of them."""
        ulps, moved = bf16_ulps(got, want)
        print(f"[kernel] i2t_probs_f32: {moved:.3e} of P's bf16 elements "
              f"differ from the plain version's (tol {PROBS_F32_MOVED:g}), "
              f"by at most {ulps:.3f} ulp", flush=True)
        if moved > PROBS_F32_MOVED:
            _fail(f"i2t_probs_f32: {moved:.3e} of P's elements moved, above "
                  f"{PROBS_F32_MOVED:g}")
        return (got.float() - want.float()).abs().max().item(), ulps

    check(build.I2T_PROBS_F32,
          "layer 1: q1st [1,128,4096] f32 -> P [1024,56,4096]",
          lambda: dpr.i2t_probs(q1st, tok_k, 8),
          lambda: dpr.i2t_probs_reference(q1st, tok_k, 8),
          ulp_err, 1.0, (q1st, tok_k), (0, pe_term))
    rec, rec_c = ((img0, p1, c1, peqt, w_q, rows),
                  (img0, p1[:c], c1[:c], peqt, w_q, rows))
    check(build.I2T_PROBS_F32, "layer 2: P1, C1 [1024,56,*] f32 -> P2",
          lambda: dpr.i2t_probs(None, tok_k, 8, layer=2, recon=rec),
          lambda: dpr.i2t_probs_reference(None, tok_k[:c], 8, layer=2,
                                          recon=rec_c),
          ulp_err, 1.0, (tok_k,) + rec,
          (2 * recon + 3 * rows_x_branch, pe_term), plain_prompts=c)
    for depth in (1, 2):
        ps = (p2, c2) if depth == 2 else (None, None)
        ps_c = (p2[:c], c2[:c]) if depth == 2 else (None, None)
        args = (img0, p1, c1) + ps + (w_k, w_v, peqt, rows, vb, 8)
        args_c = (img0, p1[:c], c1[:c]) + ps_c + (w_k, w_v, peqt, rows, vb,
                                                  8)
        check(build.T2I_PROBS_F32,
              f"depth {depth}: q [1024,7,128] f32 over the rebuilt branch",
              lambda: dpr.t2i_from_probs(qt, *args),
              lambda: dpr.t2i_from_probs_reference(qt[:c], *args_c),
              _rel, F32_REL, [qt] + [x for x in args if
                                     isinstance(x, torch.Tensor)],
              (2 * depth * recon + 3 * 2 * rows_x_branch, pe_term),
              plain_prompts=c)
    torch.cuda.empty_cache()

    # B6 f32 at content 3136 (49 items of 64 rows), M 3; the bound's
    # products at the TF32 rate as the kernel runs them: the head's three
    # passes (K3 f32's row) and the rebuild's two (P exact in TF32 against
    # C's hi and lo planes) over the 56 rows, both layers, every position
    content = 3136
    hyper = rnd(b, 3, 32, s=0.5)
    head = (rnd(256, 256, s=0.1), rnd(64, s=0.1), rnd(64, s=0.1, off=1.0),
            rnd(64, s=0.1), rnd(64, 128, s=0.1), rnd(32, s=0.1))
    margs = (img0, p1, c1, p2, c2, rows, hyper) + head
    margs_c = (img0, p1[:c], c1[:c], p2[:c], c2[:c], rows, hyper[:c]) + head
    head_flop = 2 * (256 * 256 + 4 * 64 * 128 + 16 * 32 * 3)
    check(build.MASK_HEAD_PROBS_F32,
          "P1,C1,P2,C2 f32 -> [1024,3136,16,3] f32",
          lambda: mh.fused_mask_head_probs(*margs, content=content),
          lambda: mh.mask_head_probs_reference(*margs_c, content=content),
          _rel, F32_REL,
          (img0[:, :content], p1[..., :content], c1, p2[..., :content], c2,
           rows, hyper) + head,
          (0, 0, b * content * (3 * head_flop + 2 * 2 * 2 * ht * d)),
          plain_prompts=c)
    del margs, margs_c, hyper, head
    torch.cuda.empty_cache()


def compare_crop_shapes(dev, check, rnd, rel_tol, flag_tol,
                        flags_err) -> None:
    """K4, K3, K2 and K5 at the shapes multi-crop AMG gives them on a
    240x320 image (crop_n_layers=1, downscale factor 2): a 161x201 crop's
    SAM frame is 820x1024, so K4 resizes gh = 52 token rows and K3
    decodes content 52·64 = 3328 positions, at 256 prompts (a 16x16
    grid); K2's per-prompt k|v and K5's per-prompt update at 256
    prompts."""
    import torch

    from revisit_anything_tpu_torch.kernels import build
    from revisit_anything_tpu_torch.models.sam import SAM_VIT_H
    from revisit_anything_tpu_torch.models.sam.amg import (
        resize_longest_side, resize_mats_and_rows)
    from revisit_anything_tpu_torch.ops import attention as att
    from revisit_anything_tpu_torch.ops import maskhead as mh
    from revisit_anything_tpu_torch.ops import maskresize as mr
    from torch.nn import functional as F

    b, crop_hw = 256, (161, 201)
    input_hw = resize_longest_side(*crop_hw, 1024)
    wh, ww, gh = resize_mats_and_rows(SAM_VIT_H, input_hw, crop_hw)
    content = gh * 64
    whd, wwd = torch.from_numpy(wh).to(dev), torch.from_numpy(ww).to(dev)
    taps = tuple(t.to(dev) for t in mr.resize_taps(wh, ww))
    logits = rnd(b, content, 16, 3, s=4.0)
    n_taps = (int((whd != 0).sum()) * 4 * 64
              + crop_hw[0] * int((wwd != 0).sum()))
    check(build.RESIZE_FLAGS,
          f"crop logits [{b},{content},16,3] -> flags [{b},3,161,201]",
          lambda: mr.fused_resize_flags(logits, whd, wwd, 0.0, 1.0,
                                        (gh, 64), taps=taps),
          lambda: mr.resize_flags_reference(logits, whd, wwd, 0.0, 1.0,
                                            (gh, 64)),
          flags_err, flag_tol, (logits,) + taps, (0, 2 * b * 3 * n_taps),
          rate=True)
    del logits

    margs = (rnd(b, 4096, 256), rnd(b, 3, 32, s=0.5),
             rnd(256, 256, s=0.1), rnd(64, s=0.1), rnd(64, s=0.1, off=1.0),
             rnd(64, s=0.1), rnd(64, 128, s=0.1), rnd(32, s=0.1))
    head_bf16 = 2 * (256 * 256 + 4 * 64 * 128 + 16 * 32 * 3)
    check(build.MASK_HEAD, f"keys [{b},4096,256] -> [{b},{content},16,3]",
          lambda: mh.fused_mask_head(*margs, eps=1e-6, content=content),
          lambda: mh.upscale_masks_blocks(margs[0][:, :content], *margs[1:],
                                          eps=1e-6),
          _rel, rel_tol, (margs[0][:, :content],) + margs[1:],
          (b * content * head_bf16, b * content * HEAD_F32))
    del margs

    qt, kvt = rnd(b, 7, 128), rnd(b, 256, 4096)
    pe, vb = rnd(1, 128, 4096), rnd(128)
    k_l = (kvt[:, :128] + pe).reshape(b, 8, 16, 4096).transpose(
        2, 3).contiguous()
    v_l = (kvt[:, 128:] + vb[:, None]).reshape(b, 8, 16, 4096).transpose(
        2, 3).contiguous()
    q_l = qt.reshape(b, 7, 8, 16).transpose(1, 2).contiguous()
    check(build.TOKEN_CROSS, f"q [{b},7,128] kvt [{b},256,4096]",
          lambda: att.token_cross_attend_kv(qt, kvt, pe, vb, 8),
          lambda: att.token_cross_attend_kv_reference(qt, kvt, pe, vb, 8),
          _rel, rel_tol, (qt, kvt, pe, vb), (4 * b * 8 * 7 * 4096 * 16, 0),
          library=lambda: F.scaled_dot_product_attention(q_l, k_l, v_l))
    del qt, kvt, pe, vb, k_l, v_l, q_l

    iargs = (rnd(b, 4096, 256), rnd(1, 4096, 128), rnd(b, 7, 128),
             rnd(b, 7, 128), rnd(256, 128, s=0.1), rnd(128, s=0.1),
             rnd(128, 256, s=0.1), rnd(256, s=0.1),
             rnd(256, s=0.1, off=1.0), rnd(256, s=0.1),
             rnd(256, 256, s=0.1))
    check(build.I2T_UPDATE, f"img [{b},4096,256]",
          lambda: att.i2t_update(*iargs, 8, 1e-6),
          lambda: att.i2t_update_reference(*iargs, 8, 1e-6),
          _tuple_err, rel_tol, iargs,
          (2 * b * 4096 * (256 * 128 + 128 * 256 + 256 * 256)
           + 2 * 2 * b * 4096 * 8 * 7 * 16, 0))
    del iargs
    torch.cuda.empty_cache()


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
          _rel, rel_tol, (q1st, tok_k), (pe_term, 0))
    rec, rec_c = ((img0, p1, c1, peqt, w_q, rows),
                  (img0, p1[:c], c1[:c], peqt, w_q, rows))
    check(build.I2T_PROBS, "layer 2: P1, C1 [1024,56,*] -> P2",
          lambda: dpr.i2t_probs(None, tok_k, 8, layer=2, recon=rec),
          lambda: dpr.i2t_probs_reference(None, tok_k[:c], 8, layer=2,
                                          recon=rec_c),
          _rel, rel_tol, (tok_k,) + rec, (recon + pe_term, 0, rows_x_branch),
          plain_prompts=c)
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
              plain_prompts=c)

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
              _tuple_err, rel_tol, tail_ins, tail_ops, plain_prompts=c)
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
          plain_prompts=c)
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
    # mesh=None: these phases measure the one-device server, whatever
    # the cards; [mesh] drives the row-sharded one
    kw = dict(sam=sam, dino=dino, full_hw=PLACES17_HW,
              sam_hw=PLACES17_SAM_HW, amg=amg, max_masks=128, mesh=None)
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
    sam_f32 = sam_f32_phase(srv, queries, planted, kw, seed)

    remove_and_snapshot(srv, queries, planted, kw)
    more = [_noisy(rng, inserted[i]) for i in range(2, 7)]
    pipelined = pipeline_phase(srv, queries + more)
    concurrent = concurrent_phase(srv, queries + more, rng, kw)
    stream = stream_knn_phase(srv, queries[0], planted[0])
    mesh = mesh_phase(srv, dino, queries)
    del srv
    offline = offline_phase(sam, dino)
    del dino
    tools = sam_tools_phase(sam)
    return dict(counts=counts, wall_ms=wall, peak_gib=peak_gib,
                variants=variants, window=window, sam_f32=sam_f32,
                pipelined=pipelined,
                concurrent=concurrent, stream=stream, mesh=mesh,
                offline=offline, tools=tools)


# K1 f32 with the bias in SAM ViT-H's 4 global layers, without it in
# DINOv2-g's first 31 blocks, K2 in the decoder's 3 token->image
# attentions, K5 in its 2 image->token updates, K3 and K4 once: one f32
# query of the "shared" decoder (1024 prompts in one batch)
F32_QUERY_LAUNCHES = {"flash_attention_f32_bias": 4, "flash_attention_f32": 31,
                      "token_cross_attention_f32": 3, "i2t_update_f32": 2,
                      "mask_head_f32": 1, "resize_flags_f32": 1}


@contextlib.contextmanager
def _plain_sam_f32():
    """SAM's kernels on the default path replaced by their plain versions
    (f32 on the card with TF32 off, as main() sets it): K1 and B11 in the
    encoder, K2, K5 and K3 in the decoder, K4 in AMG; and B7, B8 and B6,
    the "probs_split" decode's."""
    from revisit_anything_tpu_torch.models.sam import amg, decoder, encoder
    from revisit_anything_tpu_torch.ops import attention as att
    from revisit_anything_tpu_torch.ops import decode_probs as dpr
    from revisit_anything_tpu_torch.ops import maskhead as mh
    from revisit_anything_tpu_torch.ops import maskresize as mr
    from revisit_anything_tpu_torch.ops import winattn as wa

    def mask_head(keys, hyper, *w, eps=1e-6, content=None):
        return mh.upscale_masks_blocks(keys[:, :content], hyper, *w, eps)

    def resize_flags(lowres, wh, ww, thr, off, grid_hw, taps=None):
        flags = mr.resize_flags_reference(lowres, wh, ww, thr, off, grid_hw)
        return (flags,) + mr.flag_stats(flags)

    swaps = ((encoder, "attend", att.attend_reference),
             (encoder, "windowed_attend", wa.windowed_attend_reference),
             (decoder, "token_cross_attend_kv",
              att.token_cross_attend_kv_reference),
             (decoder, "i2t_update", att.i2t_update_reference),
             (decoder, "i2t_probs", dpr.i2t_probs_reference),
             (decoder, "t2i_from_probs", dpr.t2i_from_probs_reference),
             (decoder, "fused_mask_head", mask_head),
             (decoder, "fused_mask_head_probs", mh.mask_head_probs_reference),
             (amg, "fused_resize_flags", resize_flags))
    kept = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    try:
        for mod, name, fn in swaps:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in kept:
            setattr(mod, name, fn)


def _best_iou(amg_a, amg_b):
    """For each mask a's server kept, its best IoU with a mask b's kept
    (two empty masks: 1)."""
    import torch
    (masks_a, st_a), (masks_b, st_b) = amg_a, amg_b
    a = masks_a[:int(st_a[-1])].flatten(1).float()
    b = masks_b[:int(st_b[-1])].flatten(1).float()
    inter = a @ b.t()
    union = a.sum(1)[:, None] + b.sum(1)[None] - inter
    iou = torch.where(union > 0, inter / union.clamp(min=1.0), 1.0)
    return iou.max(1).values


def sam_f32_phase(srv, queries, planted, kw, seed) -> dict:
    """[sam-f32]: SAM ViT-H (its point segmenter planted) and DINOv2-g in
    f32, the JAX package's and the JAX CLI's dtype, from the bf16 server's
    seed (the same draws, unrounded), serving the 3 queries against the
    bf16 server's live 100k-row index with the counters reset before each:
    every query launches F32_QUERY_LAUNCHES and no other kernel, each
    planted image comes first; then per query its kept masks against the
    bf16 server's on the same image (the share matched at IoU > 0.5, as
    [variant] measures) and against the f32 plain path on the card with
    TF32 off (the same count, each mask at IoU >= 0.95 with one of the
    plain path's); wall ms a query, the encode and decode stages and every
    stage of [split] by CUDA events, peak device memory. Then one more
    planted query with the encoder's windowed layers through B11 f32
    (window_attention="kernel", counters reset first): F32_QUERY_LAUNCHES
    and B11 f32 once a windowed layer, no other kernel, the planted image
    first, its kept masks against the f32 plain path with plain windows
    (the same count, each at IoU >= 0.95); the encode stage with plain and
    kernel windows (CUDA events, median of 3 after one, in turns)."""
    import numpy as np
    import torch

    from revisit_anything_tpu_torch.kernels import build
    from revisit_anything_tpu_torch.models.dinov2 import VIT_G14
    from revisit_anything_tpu_torch.models.sam import SAM_VIT_H
    from revisit_anything_tpu_torch.pipeline.serve import SegVLADServer
    from revisit_anything_tpu_torch.weights import (init_dino, init_sam,
                                                    plant_point_segmenter)

    dev = srv.device
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed)
    sam = init_sam(SAM_VIT_H, gen, dev, torch.float32)
    plant_point_segmenter(sam, gen)
    dino = init_dino(VIT_G14, gen, dev, torch.float32)
    fsrv = SegVLADServer(index=_live_index(srv),
                         **dict(kw, sam=sam, dino=dino))
    fsrv.query(queries[2])                       # warm-up: constants, caches
    torch.cuda.synchronize()
    print(f"[sam-f32] f32 SAM ViT-H + DINOv2-g built and warmed up in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.reset_peak_memory_stats()
    answers, wall, launches = [], [], collections.Counter()
    for i, img in enumerate(queries):
        torch.cuda.synchronize()
        build.reset_counts()
        t = time.perf_counter()
        top = fsrv.query(img)
        wall.append((time.perf_counter() - t) * 1e3)
        counts = {k.name: k.launches for k in build.KERNELS if k.launches}
        launches.update(counts)
        answers.append(top)
        print(f"[sam-f32] query {i}: top-5 {top.tolist()}  {wall[-1]:.1f} ms;"
              f" launches {counts}", flush=True)
        _check_answer(fsrv, top)
        if counts != F32_QUERY_LAUNCHES:
            _fail(f"[sam-f32] query {i} launched {counts}, expected "
                  f"{F32_QUERY_LAUNCHES} and no other kernel")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    for i, iid in enumerate(planted):
        if answers[i][0] != iid:
            _fail(f"[sam-f32] noisy copy of planted image {iid} answered "
                  f"{answers[i]}")
    with torch.inference_mode():
        img_dev = torch.from_numpy(queries[0]).to(dev)
        encode = [_encode_ms(fsrv, img_dev) for _ in range(4)][1:]
    decode = [_decode_ms(fsrv, queries[0]) for _ in range(4)][1:]
    # every stage of the query, as [split] takes the bf16 query's
    splits = [_stage_ms(fsrv, queries[0], answers[0]) for _ in range(4)][1:]
    stages = {name: statistics.median(dict(p)[name] for p, _ in splits)
              for name, _ in splits[0][0]}
    print(f"[sam-f32] f32 query's stages (CUDA events, median of 3 after "
          f"one): {'; '.join(f'{k} {v:.3f}' for k, v in stages.items())}; "
          f"wall {statistics.median(w for _, w in splits):.3f} ms",
          flush=True)
    agree_bf16, plain_iou = [], []
    with torch.inference_mode():
        for i, img in enumerate(queries):
            img_dev = torch.from_numpy(img).to(dev)
            amg_k = fsrv._amg_device(img_dev)
            n_k, n_b, share = _agreement(amg_k, srv._amg_device(img_dev))
            with _plain_sam_f32():
                build.reset_counts()
                amg_p = fsrv._amg_device(img_dev)
                stray = [k.name for k in build.KERNELS if k.launches]
            n_p = int(amg_p[1][-1])
            best = _best_iou(amg_k, amg_p)
            agree_bf16.append(share)
            plain_iou.append(best.min().item() if n_k else 1.0)
            print(f"[sam-f32] query {i}: {n_k} masks kept (bf16 server "
                  f"{n_b}, f32 plain path "
                  f"{n_p}); {share:.4f} of them match a bf16 mask at IoU > "
                  f"0.5; against the f32 plain path: least best IoU "
                  f"{plain_iou[-1]:.4f}, mean {best.mean().item():.4f}",
                  flush=True)
            if stray:
                _fail(f"[sam-f32] the plain path launched {stray}")
            if n_k != n_p or plain_iou[-1] < 0.95:
                _fail(f"[sam-f32] query {i}: {n_k} masks kept against the "
                      f"f32 plain path's {n_p}, least IoU {plain_iou[-1]}")
            # bf16 rounds every layer of both models: a mask near the top-k
            # cut or an NMS tie may differ, most must not
            if share < 0.9:
                _fail(f"[sam-f32] query {i}: only {share:.4f} of the f32 "
                      "masks match a bf16 mask at IoU > 0.5")
    window = _sam_f32_window(fsrv, queries[0], planted[0])
    probs = _sam_f32_probs_split(fsrv, queries[0])
    probs.update(_sam_f32_decode_queries(fsrv, dict(kw, sam=sam, dino=dino),
                                         queries[0], planted[0]))
    enc_ms, dec_ms = statistics.median(encode), statistics.median(decode)
    print(f"[sam-f32] f32 query: wall {statistics.median(wall):.1f} ms "
          f"(median of 3: {', '.join(f'{w:.1f}' for w in wall)}); encode "
          f"stage {enc_ms:.3f} ms, decode stage {dec_ms:.3f} ms (CUDA "
          f"events, median of 3 after one); peak device memory "
          f"{peak_gib:.2f} GiB; masks matched to the bf16 query's "
          f"{', '.join(f'{a:.4f}' for a in agree_bf16)}", flush=True)
    del fsrv, sam, dino
    torch.cuda.empty_cache()
    return dict(counts=dict(launches), wall_ms=wall, encode_ms=enc_ms,
                decode_ms=dec_ms, stages_ms=stages, peak_gib=peak_gib,
                agree_bf16=agree_bf16, plain_least_iou=plain_iou, **window,
                **probs)


def _sam_f32_window(fsrv, img, planted: int) -> dict:
    """[sam-f32]'s kernel-window query (see :func:`sam_f32_phase`)."""
    import torch

    from revisit_anything_tpu_torch.kernels import build

    enc = fsrv.sam.encoder
    cfg = fsrv.sam_cfg
    want = dict(F32_QUERY_LAUNCHES, win_attention_f32=cfg.encoder_depth
                - len(cfg.global_attn_indexes))
    t0 = time.perf_counter()
    try:
        enc.window_attention = "kernel"
        torch.cuda.synchronize()
        build.reset_counts()
        t = time.perf_counter()
        top = fsrv.query(img)
        wall = (time.perf_counter() - t) * 1e3
        counts = {k.name: k.launches for k in build.KERNELS if k.launches}
        if counts != want:
            _fail(f"[sam-f32] kernel-window query launched {counts}, "
                  f"expected {want} and no other kernel")
        if top[0] != planted:
            _fail(f"[sam-f32] kernel windows: noisy copy of planted image "
                  f"{planted} answered {top}")
        with torch.inference_mode():
            img_dev = torch.from_numpy(img).to(fsrv.device)
            amg_k = fsrv._amg_device(img_dev)
            enc.window_attention = "plain"
            with _plain_sam_f32():
                build.reset_counts()
                amg_p = fsrv._amg_device(img_dev)
                stray = [k.name for k in build.KERNELS if k.launches]
            times = {"plain": [], "kernel": []}
            for rep in range(4):
                order = ("plain", "kernel") if rep % 2 else ("kernel",
                                                             "plain")
                for form in order:
                    enc.window_attention = form
                    times[form].append(_encode_ms(fsrv, img_dev))
    finally:
        enc.window_attention = "plain"
    if stray:
        _fail(f"[sam-f32] the plain path launched {stray}")
    n_k, n_p = int(amg_k[1][-1]), int(amg_p[1][-1])
    best = _best_iou(amg_k, amg_p)
    least = best.min().item() if n_k else 1.0
    # the first turn warms both forms up
    plain_ms = statistics.median(times["plain"][1:])
    kernel_ms = statistics.median(times["kernel"][1:])
    print(f"[sam-f32] kernel windows: top-5 {top.tolist()}  query "
          f"{wall:.1f} ms, launches {counts}; {n_k} masks kept (f32 plain "
          f"path with plain windows {n_p}), least best IoU {least:.4f}, mean "
          f"{best.mean().item():.4f}; encode stage (CUDA events, median of 3 "
          f"after one, in turns) plain windows {plain_ms:.3f} ms, kernel "
          f"windows {kernel_ms:.3f} ms; {time.perf_counter() - t0:.1f} s",
          flush=True)
    if n_k != n_p or least < 0.95:
        _fail(f"[sam-f32] kernel windows: {n_k} masks kept against the f32 "
              f"plain path's {n_p}, least IoU {least}")
    return dict(window_counts=counts, window_query_ms=wall,
                window_least_iou=least, encode_plain_windows_ms=plain_ms,
                encode_kernel_windows_ms=kernel_ms)


# The f32 "probs_split" transformer's token state and C2 against its plain
# witness, relative to their scale: K2 f32 and B8 f32 are within F32_REL
# (1e-5) of their plain versions, and where a bf16 probability of P1 or
# P2 rounds the other way (one ulp, 2^-8 of it, in at most
# PROBS_F32_MOVED = 1e-3 of P) the state moves by about 1e-3 x 2^-8 ~
# 4e-6 of its scale to first order. So the state stays within F32_REL;
# one TF32 pass in a product (~1e-4) does not.
PROBS_STATE_REL = F32_REL


def _sam_f32_probs_split(fsrv, img) -> dict:
    """[sam-f32]'s "probs_split" two-way transformer (see
    :func:`sam_f32_phase`): the image's embedding and its 1024 grid
    prompts as amg._decode_batch builds them, through
    decoder.run_two_way_probs with the counters reset first, then with K2,
    B7 and B8 swapped for their plain f32 versions (in chunks of 256
    prompts, which are independent); its ms beside run_two_way_shared's."""
    import torch

    from revisit_anything_tpu_torch.kernels import build
    from revisit_anything_tpu_torch.kernels.probs_compare import (
        PROBS_F32_MOVED, bf16_ulps)
    from revisit_anything_tpu_torch.models.sam import decoder as sd
    from revisit_anything_tpu_torch.models.sam.amg import (
        resize_mats_and_rows)
    from revisit_anything_tpu_torch.models.sam.prompt import (
        embed_points, no_mask_dense_embedding)
    from revisit_anything_tpu_torch.pipeline import serve as sv

    t0 = time.perf_counter()
    sam, cfg, dev = fsrv.sam, fsrv.sam_cfg, fsrv.device
    dec = sam.decoder
    pts = fsrv._pts[:fsrv._bsz]
    n = pts.shape[0]
    gh = resize_mats_and_rows(cfg, tuple(fsrv.input_hw),
                              tuple(fsrv.sam_hw))[2]
    with torch.inference_mode():
        img_dev = torch.from_numpy(img).to(dev)
        emb = sam.encoder(sv._sam_preprocess_fused(
            img_dev, fsrv._rh, fsrv._rw, cfg.image_size))[0]
        sparse = embed_points(sam.prompt, cfg, pts[:, None, :],
                              torch.ones((n, 1), dtype=torch.int32,
                                         device=dev), pad=True)
        dense = no_mask_dense_embedding(sam.prompt, cfg, 1)
        g, d = cfg.grid, emb.shape[-1]
        out_tokens = torch.cat([dec.iou_token, dec.mask_tokens], dim=0)
        tokens = torch.cat([out_tokens[None].expand(n, -1, -1),
                            sparse.to(out_tokens.dtype)], dim=1)
        shared_src = (emb[None] + dense[:1]).reshape(1, g * g, d)
        src_pe_one = fsrv._image_pe.reshape(1, g * g, d).to(shared_src.dtype)
        content = gh * g

        def probs_split(lo=0, hi=n):
            return sd.run_two_way_probs(dec, tokens[lo:hi], shared_src,
                                        src_pe_one, cfg, "probs_split",
                                        content)

        def shared():
            return sd.run_two_way_shared(dec, tokens, shared_src,
                                         src_pe_one, cfg)

        torch.cuda.synchronize()
        build.reset_counts()
        queries, (p1, _, p2, c2, _), _, _ = probs_split()
        torch.cuda.synchronize()
        counts = {k.name: k.launches for k in build.KERNELS if k.launches}
        want = {build.TOKEN_CROSS_F32.name: 1, build.I2T_PROBS_F32.name: 2,
                build.T2I_PROBS_F32.name: 2}
        if counts != want:
            _fail(f"[sam-f32] probs_split transformer launched {counts}, "
                  f"expected {want} and no other kernel")
        with _plain_sam_f32():
            build.reset_counts()
            parts = [probs_split(lo, lo + 256) for lo in range(0, n, 256)]
            torch.cuda.synchronize()
            stray = [k.name for k in build.KERNELS if k.launches]
        if stray:
            _fail(f"[sam-f32] the plain probs_split transformer launched "
                  f"{stray}")
        w_queries = torch.cat([x[0] for x in parts])
        w_p1, w_p2, w_c2 = (torch.cat([x[1][i] for x in parts])
                            for i in (0, 2, 3))
        del parts
        moved = {}
        for name, got, ref in (("P1", p1, w_p1), ("P2", p2, w_p2)):
            ulps, moved[name] = bf16_ulps(got, ref)
            if ulps > 1.0 or moved[name] > PROBS_F32_MOVED:
                _fail(f"[sam-f32] probs_split {name} against its plain "
                      f"witness: {moved[name]:.3e} of its elements moved "
                      f"(tol {PROBS_F32_MOVED:g}), by at most {ulps:.3f} "
                      "bf16 ulp (tol 1)")
        state = {name: _rel(got, ref)[1] for name, got, ref in
                 (("queries", queries, w_queries), ("C2", c2, w_c2))}
        del w_p1, w_p2, w_c2, w_queries
        times = {"probs_split": [], "shared": []}
        for rep in range(4):
            order = (("shared", "probs_split") if rep % 2
                     else ("probs_split", "shared"))
            for form in order:
                fn = probs_split if form == "probs_split" else shared
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                start.record()
                out = fn()
                end.record()
                end.synchronize()
                del out
                times[form].append(start.elapsed_time(end))
    probs_ms = statistics.median(times["probs_split"][1:])
    shared_ms = statistics.median(times["shared"][1:])
    print(f"[sam-f32] probs_split two-way transformer, {n} prompts: launches "
          f"{counts}; against its plain witness (K2, B7, B8 plain f32): "
          f"P1 {moved['P1']:.3e}, P2 {moved['P2']:.3e} of their bf16 "
          f"elements differ (tol {PROBS_F32_MOVED:g}, each by one ulp at "
          f"most), token state rel_err "
          f"{state['queries']:.3e}, C2 {state['C2']:.3e} (tol "
          f"{PROBS_STATE_REL:g}); {probs_ms:.3f} ms against the f32 shared "
          f"transformer's {shared_ms:.3f} ms (CUDA events, median of 3 after "
          f"one, in turns); {time.perf_counter() - t0:.1f} s", flush=True)
    if max(state.values()) > PROBS_STATE_REL:
        _fail(f"[sam-f32] probs_split transformer against its plain witness:"
              f" {state} above {PROBS_STATE_REL}")
    return dict(probs_counts=counts, probs_moved=moved, probs_state=state,
                probs_split_ms=probs_ms, shared_transformer_ms=shared_ms)


# An f32 query of the "probs_split" decoder: K1 f32 with and without the
# bias as in F32_QUERY_LAUNCHES, K2 f32 once (layer 1's token->image
# attention over the shared branch), B7 f32 and B8 f32 twice each, B6 f32
# and K4 f32 once, and no other kernel
F32_PROBS_QUERY_LAUNCHES = {
    "flash_attention_f32_bias": 4, "flash_attention_f32": 31,
    "token_cross_attention_f32": 1, "i2t_probs_f32": 2,
    "t2i_from_probs_f32": 2, "mask_head_probs_f32": 1, "resize_flags_f32": 1}
# and of the "fused_tail_keys" and "fused_tail_logits" decoders: K2 f32
# once, then B3 f32 in keys mode and K3 f32, or the B3 f32 logits entry
# (its K3 f32 launch inside the entry, uncounted), then K4 f32
F32_TAIL_KEYS_QUERY_LAUNCHES = {
    "flash_attention_f32_bias": 4, "flash_attention_f32": 31,
    "token_cross_attention_f32": 1, "decode_tail_f32": 1,
    "mask_head_f32": 1, "resize_flags_f32": 1}
F32_TAIL_LOGITS_QUERY_LAUNCHES = {
    "flash_attention_f32_bias": 4, "flash_attention_f32": 31,
    "token_cross_attention_f32": 1, "decode_tail_logits_f32": 1,
    "resize_flags_f32": 1}
# and of the "fused_tail_probs" decoder: K2 f32 once, B3 f32 in
# probability mode (the keys mode's entry) and B6 f32 on its P1, P2 and
# C2, then K4 f32
F32_TAIL_PROBS_QUERY_LAUNCHES = {
    "flash_attention_f32_bias": 4, "flash_attention_f32": 31,
    "token_cross_attention_f32": 1, "decode_tail_f32": 1,
    "mask_head_probs_f32": 1, "resize_flags_f32": 1}


def _sam_f32_decode_query(fsrv, kw, img, planted: int, decode: str,
                          launches: dict, plain: dict, swapped: tuple,
                          tag: str) -> dict:
    """[sam-f32]'s f32 query of the ``decode`` form (see
    :func:`sam_f32_phase`): a server on the f32 models (``kw``) and fsrv's
    index serves the planted query with the counters reset first:
    ``launches`` and no other kernel, the planted image first; its kept
    masks against fsrv's ("shared": the share matched at IoU > 0.5, at
    least 0.9) and against the same decode with ``plain`` (the decoder's
    names of the form's kernels -> their plain f32 versions) swapped in,
    256 prompts a decode batch, none of ``swapped`` launched (the same
    count, each at IoU >= 0.95); its decode stage beside fsrv's (CUDA
    events, median of 3 after one, in turns). The result's keys start
    with ``tag``."""
    import torch

    from revisit_anything_tpu_torch.kernels import build
    from revisit_anything_tpu_torch.models.sam import decoder
    from revisit_anything_tpu_torch.pipeline.serve import SegVLADServer

    t0 = time.perf_counter()
    psrv = SegVLADServer(index=_live_index(fsrv), **dict(
        kw, amg=dataclasses.replace(kw["amg"], decode=decode)))
    torch.cuda.synchronize()
    build.reset_counts()
    t = time.perf_counter()
    top = psrv.query(img)
    wall = (time.perf_counter() - t) * 1e3
    counts = {k.name: k.launches for k in build.KERNELS if k.launches}
    if counts != launches:
        _fail(f"[sam-f32] {decode} query launched {counts}, expected "
              f"{launches} and no other kernel")
    _check_launches(collections.Counter(counts), f"{decode}_f32")
    if top[0] != planted:
        _fail(f"[sam-f32] {decode}: noisy copy of planted image {planted}"
              f" answered {top}")
    kernels = {name: getattr(decoder, name) for name in plain}
    bsz = psrv._bsz
    with torch.inference_mode():
        img_dev = torch.from_numpy(img).to(fsrv.device)
        amg_k = psrv._amg_device(img_dev)
        n_k, n_s, share = _agreement(amg_k, fsrv._amg_device(img_dev))
        try:
            for name, fn in plain.items():
                setattr(decoder, name, fn)
            psrv._bsz = 256
            build.reset_counts()
            amg_p = psrv._amg_device(img_dev)
            stray = [k.name for k in swapped if k.launches]
        finally:
            psrv._bsz = bsz
            for name, fn in kernels.items():
                setattr(decoder, name, fn)
        times = {decode: [], "shared": []}
        for rep in range(4):
            order = (("shared", decode) if rep % 2 else (decode, "shared"))
            for form in order:
                times[form].append(_decode_ms(
                    psrv if form == decode else fsrv, img))
    if stray:
        _fail(f"[sam-f32] the plain {decode} decode launched {stray}")
    n_p = int(amg_p[1][-1])
    best = _best_iou(amg_k, amg_p)
    least = best.min().item() if n_k else 1.0
    form_ms = statistics.median(times[decode][1:])
    shared_ms = statistics.median(times["shared"][1:])
    seconds = time.perf_counter() - t0
    print(f"[sam-f32] {decode} query: top-5 {top.tolist()}  query "
          f"{wall:.1f} ms, launches {counts}; {n_k} masks kept (f32 shared "
          f"{n_s}), {share:.4f} of them match a shared mask at IoU > 0.5; "
          f"against {', '.join(plain)} plain f32 (256 prompts a decode "
          f"batch): {n_p} kept, least best IoU {least:.4f}, mean "
          f"{best.mean().item():.4f}; decode stage {form_ms:.3f} ms, the "
          f"f32 shared decode's {shared_ms:.3f} ms (CUDA events, median of 3 "
          f"after one, in turns); {seconds:.1f} s", flush=True)
    if share < 0.9:
        _fail(f"[sam-f32] {decode}: only {share:.4f} of its masks match "
              "an f32 shared mask at IoU > 0.5")
    if n_k != n_p or least < 0.95:
        _fail(f"[sam-f32] {decode}: {n_k} masks kept against the plain "
              f"decode's {n_p}, least IoU {least}")
    return {f"{tag}_query_counts": counts, f"{tag}_query_ms": wall,
            f"{tag}_query_share": share, f"{tag}_query_least_iou": least,
            f"{tag}_decode_ms": form_ms, f"{tag}_shared_decode_ms": shared_ms,
            f"{tag}_query_s": seconds}


def _sam_f32_decode_queries(fsrv, kw, img, planted: int) -> dict:
    """[sam-f32]'s f32 "probs_split", "fused_tail_keys",
    "fused_tail_logits" and "fused_tail_probs" queries
    (:func:`_sam_f32_decode_query`)."""
    from revisit_anything_tpu_torch.kernels import build
    from revisit_anything_tpu_torch.ops import decode_fused as dfu
    from revisit_anything_tpu_torch.ops import decode_probs as dpr
    from revisit_anything_tpu_torch.ops import maskhead as mh

    out = _sam_f32_decode_query(
        fsrv, kw, img, planted, "probs_split", F32_PROBS_QUERY_LAUNCHES,
        {"i2t_probs": dpr.i2t_probs_reference,
         "t2i_from_probs": dpr.t2i_from_probs_reference,
         "fused_mask_head_probs": mh.mask_head_probs_reference},
        (build.I2T_PROBS_F32, build.T2I_PROBS_F32,
         build.MASK_HEAD_PROBS_F32), "probs")
    tail = {"decode_tail_fused": dfu.decode_tail_reference}
    out.update(_sam_f32_decode_query(
        fsrv, kw, img, planted, "fused_tail_keys",
        F32_TAIL_KEYS_QUERY_LAUNCHES, tail, (build.DECODE_TAIL_F32,),
        "tail_keys"))
    out.update(_sam_f32_decode_query(
        fsrv, kw, img, planted, "fused_tail_logits",
        F32_TAIL_LOGITS_QUERY_LAUNCHES, tail, (build.DECODE_TAIL_LOGITS_F32,),
        "tail_logits"))
    out.update(_sam_f32_tail_probs_query(fsrv, kw, img, planted))
    return out


def _sam_f32_tail_probs_query(fsrv, kw, img, planted: int) -> dict:
    """[sam-f32]'s f32 "fused_tail_probs" query: B3 f32 in probability
    mode and B6 f32, against the same query with both swapped for their
    plain f32 versions (its own [phases] entry)."""
    from revisit_anything_tpu_torch.kernels import build
    from revisit_anything_tpu_torch.ops import decode_fused as dfu
    from revisit_anything_tpu_torch.ops import maskhead as mh

    return _sam_f32_decode_query(
        fsrv, kw, img, planted, "fused_tail_probs",
        F32_TAIL_PROBS_QUERY_LAUNCHES,
        {"decode_tail_fused": dfu.decode_tail_reference,
         "fused_mask_head_probs": mh.mask_head_probs_reference},
        (build.DECODE_TAIL_F32, build.MASK_HEAD_PROBS_F32), "tail_probs")


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


def _box_iou(a, b) -> float:
    """IoU of two XYXY boxes, areas without +1 (torchvision's)."""
    ix = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    iy = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = ix * iy
    union = ((a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1])
             - inter)
    return inter / union if union > 0 else 0.0


def _same_records(a, b) -> bool:
    import numpy as np
    return len(a) == len(b) and all(
        np.array_equal(x.segmentation, y.segmentation)
        and x.crop_box == y.crop_box and x.bbox == y.bbox
        and x.predicted_iou == y.predicted_iou
        and x.stability_score == y.stability_score for x, y in zip(a, b))


def multicrop_phase(sam, seed: int = 9) -> dict:
    """[multicrop]: one planted 240x320 image through multi-crop AMG with
    upstream's example-notebook settings (crop_n_layers=1,
    crop_n_points_downscale_factor=2, min_mask_region_area=100; the
    thresholds off as the planted segmenter needs): 5 encodes, the full
    image's 32x32 grid and 4 crops' 16x16 grids. Launches with the
    counters reset (K1 20, K2 15, K5 10, K3 5, K4 5), every mask inside
    its XYWH crop box, no two kept boxes above crop_nms_thresh, the same
    records twice, and with crop_n_layers=0 ``_generate_multicrop`` gives
    ``generate_masks``' records bit for bit; seconds an image and the
    small-region post-processing's ms."""
    import numpy as np
    import dataclasses as dc

    import torch

    from revisit_anything_tpu_torch.config import PLACES17_SAM_HW
    from revisit_anything_tpu_torch.kernels import build
    from revisit_anything_tpu_torch.models.sam import amg as pamg

    img = _image(np.random.default_rng(seed), PLACES17_SAM_HW)
    amg = pamg.AmgConfig(points_per_batch=1024, pred_iou_thresh=-1e9,
                         stability_score_thresh=0.0, crop_n_layers=1,
                         crop_n_points_downscale_factor=2,
                         min_mask_region_area=100)
    pamg.generate_masks(sam, img, amg, max_masks=128)        # warm-up
    torch.cuda.synchronize()
    build.reset_counts()
    t0 = time.perf_counter()
    recs = pamg.generate_masks(sam, img, amg, max_masks=128)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k.name: k.launches for k in build.KERNELS}
    want = {build.FLASH_ATTENTION: 20, build.TOKEN_CROSS: 15,
            build.I2T_UPDATE: 10, build.MASK_HEAD: 5, build.RESIZE_FLAGS: 5}
    crops = collections.Counter(r.crop_box for r in recs)
    print(f"[multicrop] {len(recs)} records in {wall:.3f} s an image "
          f"(5 encodes, 1024 + 4 x 256 prompts); by crop box (XYWH) "
          f"{dict(crops)}; launches {counts}", flush=True)
    bad = {k.name: counts[k.name] for k, n in want.items()
           if counts[k.name] != n}
    if bad:
        _fail(f"[multicrop] launches {bad}, expected "
              f"{ {k.name: n for k, n in want.items()} }")
    if not recs:
        _fail("[multicrop] no records")
    boxes = []
    for r in recs:
        x0, y0, w, h = r.crop_box
        ys, xs = np.nonzero(r.segmentation)
        if not (xs.min() >= x0 and xs.max() < x0 + w and ys.min() >= y0
                and ys.max() < y0 + h) or r.area <= 100:
            _fail(f"[multicrop] a mask outside its crop box {r.crop_box} "
                  f"or of area {r.area}")
        boxes.append((xs.min(), ys.min(), xs.max(), ys.max()))
    worst = max((_box_iou(a, b) for i, a in enumerate(boxes)
                 for b in boxes[i + 1:]), default=0.0)
    if worst > amg.crop_nms_thresh + 1e-6:
        _fail(f"[multicrop] two kept boxes at IoU {worst}")
    if not _same_records(recs, pamg.generate_masks(sam, img, amg,
                                                   max_masks=128)):
        _fail("[multicrop] records differ between two runs")
    one = dc.replace(amg, crop_n_layers=0)
    if not _same_records(pamg._generate_multicrop(sam, img, one, 128),
                         pamg.generate_masks(sam, img, one, max_masks=128)):
        _fail("[multicrop] one crop through _generate_multicrop differs "
              "from generate_masks")
    # the post-processing alone, on the candidates it received
    raw = pamg.generate_masks(sam, img, dc.replace(
        amg, min_mask_region_area=0), max_masks=128)
    masks = [r.segmentation for r in raw]
    t0 = time.perf_counter()
    kept, _ = pamg._postprocess_small_regions(masks, 100, 0.7)
    post_ms = (time.perf_counter() - t0) * 1e3
    print(f"[multicrop] max box IoU between kept masks {worst:.3f}; "
          f"deterministic; one crop = generate_masks; small-region "
          f"post-processing {post_ms:.3f} ms for {len(masks)} masks "
          f"({len(kept)} kept)", flush=True)
    _host_profile(lambda: pamg.generate_masks(sam, img, amg, max_masks=128))
    return dict(records=len(recs), seconds=wall, post_ms=post_ms,
                counts=counts)


def _host_profile(fn, top: int = 10) -> None:
    """Where a call's wall time goes on the host: cProfile's functions by
    own time (a function that waits for the device, e.g. a readback,
    holds that wait)."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    prof.enable()
    fn()
    prof.disable()
    st = pstats.Stats(prof)
    total = sum(v[2] for v in st.stats.values())
    rows = sorted(st.stats.items(), key=lambda kv: -kv[1][2])[:top]
    print(f"[multicrop] host profile of one image ({total * 1e3:.1f} ms "
          "under cProfile), own time: " + "; ".join(
              f"{name} ({file.rsplit('/', 1)[-1]}:{line}) "
              f"{v[2] * 1e3:.1f} ms x{v[1]}"
              for (file, line, name), v in rows), flush=True)


def predictor_phase(sam, seed: int = 10) -> dict:
    """[predictor]: ``SamPredictor.set_image`` on a 480x640 image, then
    ``predict`` with 8 grid points one at a time (multimask), a box
    (single mask), the best low-res logits fed back as ``mask_input``,
    and ``return_logits``: shapes and finite values everywhere. The
    predictor's general plain path and AMG's "shared" kernels compute
    the same function for a point: each of its 3 masks must be at IoU >=
    0.95 with AMG's candidate for the same point (before filters) and
    its predicted IoU within 2e-2."""
    import numpy as np
    import torch

    from revisit_anything_tpu_torch.models.sam import amg as pamg
    from revisit_anything_tpu_torch.models.sam.predictor import SamPredictor
    from revisit_anything_tpu_torch.models.sam.prompt import (
        dense_positional_embedding)

    hw, low_side = (480, 640), 4 * sam.cfg.grid
    img = _image(np.random.default_rng(seed), hw)
    pred = SamPredictor(sam)
    pred.set_image(img)                                      # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pred.set_image(img)
    torch.cuda.synchronize()
    set_ms = (time.perf_counter() - t0) * 1e3
    input_hw = pred._input_hw
    pts_in, pts_orig, _ = pamg.prompt_points(32, input_hw, hw, 1024)
    idx = np.array([100, 230, 300, 420, 530, 650, 780, 910])
    emb = pred.get_image_embedding()
    amg = pamg.AmgConfig(points_per_batch=1024)
    with torch.inference_mode():
        pe = dense_positional_embedding(sam.prompt, sam.cfg)[0]
        cand, cand_iou, _, _ = pamg._decode_batch(
            sam, sam.cfg, emb, pe, torch.from_numpy(pts_in[idx]).to(
                emb.device), input_hw, hw, amg)
    cand = cand.reshape(len(idx), 3, *hw).cpu().numpy()
    cand_iou = cand_iou.reshape(len(idx), 3).float().cpu().numpy()
    times, worst_iou, worst_pred = [], 1.0, 0.0
    for j, i in enumerate(idx):
        t0 = time.perf_counter()
        masks, iou, low = pred.predict(point_coords=pts_orig[i][None],
                                       point_labels=np.array([1]))
        times.append((time.perf_counter() - t0) * 1e3)
        if masks.shape != (3,) + hw or low.shape != (3, low_side,
                                                     low_side):
            _fail(f"[predictor] shapes {masks.shape}, {low.shape}")
        if not (np.isfinite(iou).all() and np.isfinite(low).all()):
            _fail("[predictor] non-finite output")
        for k in range(3):
            inter = np.logical_and(masks[k], cand[j, k]).sum()
            union = np.logical_or(masks[k], cand[j, k]).sum()
            worst_iou = min(worst_iou, inter / union if union else 1.0)
            worst_pred = max(worst_pred,
                             abs(float(iou[k] - cand_iou[j, k])))
    print(f"[predictor] 8 points against AMG's candidates: min mask IoU "
          f"{worst_iou:.4f}, max |predicted IoU diff| {worst_pred:.2e}",
          flush=True)
    if worst_iou < 0.95 or worst_pred > 2e-2:
        _fail(f"[predictor] mask IoU {worst_iou} or predicted IoU diff "
              f"{worst_pred} against AMG's candidates")
    masks, iou, low = pred.predict(box=np.array([100, 80, 400, 300]),
                                   multimask_output=False)
    best = low[int(np.argmax(iou))][None]
    fed, fed_iou, _ = pred.predict(point_coords=pts_orig[idx[3]][None],
                                   point_labels=np.array([1]),
                                   mask_input=best, multimask_output=False)
    logits, _, _ = pred.predict(point_coords=pts_orig[idx[3]][None],
                                point_labels=np.array([1]),
                                return_logits=True)
    for name, arr, shape, dtype in (
            ("box", masks, (1,) + hw, np.bool_),
            ("mask_input", fed, (1,) + hw, np.bool_),
            ("return_logits", logits, (3,) + hw, np.float32)):
        if arr.shape != shape or arr.dtype != dtype:
            _fail(f"[predictor] {name}: {arr.shape} {arr.dtype}")
    if not (np.isfinite(logits).all() and np.isfinite(fed_iou).all()):
        _fail("[predictor] non-finite logits")
    predict_ms = statistics.median(times)
    print(f"[predictor] set_image {set_ms:.3f} ms (480x640, K1 x4), "
          f"predict {predict_ms:.3f} ms (median of 8, one point, general "
          f"path in bf16, wall); box {int(masks.sum())} px, mask_input "
          f"{int(fed.sum())} px", flush=True)
    return dict(set_image_ms=set_ms, predict_ms=predict_ms, emb=emb)


def export_phase(sam, emb) -> dict:
    """[export]: ``export_decoder`` at 256 prompts on the card,
    ``load_decoder``, one call on the predictor's embedding: masks and IoU
    within 1e-3 relative of the eager general path."""
    import os
    import tempfile

    import torch

    from revisit_anything_tpu_torch.models.sam import amg as pamg
    from revisit_anything_tpu_torch.models.sam.export import (
        export_decoder, load_decoder, make_decode_fn)

    pts = pamg.prompt_points(16, (768, 1024), (240, 320), 256)[0]
    pts = torch.from_numpy(pts).to(emb.device)
    x = emb.float()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "sam_decoder.pt2")
        t0 = time.perf_counter()
        export_decoder(sam, path, num_prompts=256)
        export_s = time.perf_counter() - t0
        mib = os.path.getsize(path) / 2 ** 20
        t0 = time.perf_counter()
        fn = load_decoder(path)
        load_s = time.perf_counter() - t0
        with torch.no_grad():
            got = fn(x, pts)
            want = make_decode_fn(sam, 256)(x, pts)
    torch.cuda.synchronize()
    errs = [_rel(a, b)[1] for a, b in zip(got, want)]
    print(f"[export] 256 prompts: export {export_s:.2f} s, load "
          f"{load_s:.2f} s, file {mib:.2f} MiB; masks "
          f"{tuple(got[0].shape)} rel_err {errs[0]:.2e}, IoU rel_err "
          f"{errs[1]:.2e} against the eager general path", flush=True)
    low_side = 4 * sam.cfg.grid
    if got[0].shape != (256, 3, low_side, low_side) or max(errs) > 1e-3:
        _fail(f"[export] shape {tuple(got[0].shape)}, rel_err {errs}")
    return dict(export_s=export_s, load_s=load_s, mib=mib, rel_err=errs)


def datasets_phase(seed: int = 11) -> dict:
    """[datasets] on the card's machine (no sklearn): ``radius_positives``
    on 2,000 seeded UTM database points against a brute-force distance
    matrix, ``list_dataset_images`` over a tree written from the seed,
    and ``get_gt("17places")``."""
    import numpy as np
    import os
    import tempfile

    from revisit_anything_tpu_torch.config import DATASETS
    from revisit_anything_tpu_torch.datasets import (get_gt,
                                                     list_dataset_images,
                                                     radius_positives)

    rng = np.random.default_rng(seed)
    db = rng.uniform(0, 2000, (2000, 2)) + np.array([585000.0, 4477000.0])
    q = db[rng.choice(2000, 200, replace=False)] + rng.normal(0, 15,
                                                              (200, 2))
    radius_positives(db[:10], q[:10], 25.0)          # scipy's import
    t0 = time.perf_counter()
    got = radius_positives(db, q, 25.0)
    ms = (time.perf_counter() - t0) * 1e3
    d2 = ((q[:, None, :] - db[None, :, :]) ** 2).sum(-1)
    want = [np.flatnonzero(row <= 625.0).tolist() for row in d2]
    if [g.tolist() for g in got] != want:
        _fail("[datasets] radius positives differ from the brute force")
    ds = DATASETS["17places"]
    with tempfile.TemporaryDirectory() as root:
        for sub, n in ((ds.data_subpath_ref, 40), (ds.data_subpath_query,
                                                   40)):
            d = os.path.join(root, ds.name, sub)
            os.makedirs(d)
            for i in rng.permutation(n):
                open(os.path.join(d, f"{i}.jpg"), "wb").close()
        refs, queries = list_dataset_images(ds, root)
    names = [os.path.basename(p) for p in refs]
    if names != [f"{i}.jpg" for i in range(40)] or len(queries) != 40:
        _fail(f"[datasets] listing {names[:5]}..., {len(queries)} queries")
    gt = get_gt("17places", "", ref_paths=refs, query_paths=queries)
    if gt[20] != list(range(5, 36)) or len(gt) != 40:
        _fail("[datasets] 17places ground truth")
    print(f"[datasets] radius_positives 2000 db x 200 queries in {ms:.3f} "
          f"ms ({sum(len(g) for g in got)} positives), equal to the brute "
          f"force; list_dataset_images and get_gt('17places') ok",
          flush=True)
    return dict(radius_ms=ms)


def sam_tools_phase(sam) -> dict:
    """[multicrop], [predictor], [export], [preprocess] and [datasets] on
    the serve phase's SAM ViT-H."""
    out = dict(multicrop=multicrop_phase(sam))
    out["predictor"] = predictor_phase(sam)
    out["export"] = export_phase(sam, out["predictor"].pop("emb"))
    out["preprocess"] = preprocess_phase(sam)
    out["datasets"] = datasets_phase()
    return out


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


def _timed(tag: str, label: str, fn, n_images: int) -> tuple:
    """``fn()`` once to warm up, then once between a synchronize and a
    CUDA-event span with the peak device memory reset: prints images/s,
    the batch's wall and device ms, the peak GiB; returns (the result,
    its numbers)."""
    import torch
    fn()
    torch.cuda.reset_peak_memory_stats()
    with _Span() as span:
        res = fn()
    nums = dict(images_s=n_images / span.wall, wall_ms=span.wall * 1e3,
                device_ms=span.device_ms,
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    print(f"[{tag}] {label}: {nums['images_s']:.1f} images/s (a batch of "
          f"{n_images}: wall {nums['wall_ms']:.1f} ms, device "
          f"{nums['device_ms']:.1f} ms), peak {nums['peak_gib']:.2f} GiB",
          flush=True)
    return res, nums


def backbones_phase(dev, seed: int = 12) -> dict:
    """[backbones]: full-width models with seeded weights, f32 (TF32 off):
    DINOv1 ViT-S/8 through ``hub.load_model("dino_vits8")`` on 8 images of
    480x640 through ``dinov1_dense_features`` (224x298, stride 4: 4,016
    tokens, layer 11, key facet, upsampled back; K1 f32 must launch 11
    times a batch and nothing else, and one image's features must agree
    within 1e-4 with the same forward with K1's plain version in its
    place); CosPlace ViT-B/16's value facet at 224x224, ResNet-50
    conv1..layer4 at 480x640, and the VLAD-BuFF (NetVLAD-AntiBurst 64 x
    768 = 49,152-d) and DINO-SALAD global descriptors at 224x224, batch 8
    each; then ``fit_wpca`` to 512 components on 1,024 VLAD-BuFF
    descriptors (the dual path), whose whitened training set must have
    unit variance. Images/s and peak device memory each."""
    import numpy as np
    import torch

    from revisit_anything_tpu_torch import hub
    from revisit_anything_tpu_torch.kernels import build
    from revisit_anything_tpu_torch.models import cosplace_vit as cv
    from revisit_anything_tpu_torch.models import dinov2 as dn
    from revisit_anything_tpu_torch.models import resnet as rn
    from revisit_anything_tpu_torch.ops import attention as att
    from revisit_anything_tpu_torch.pipeline.extract import (
        dinov1_dense_features)
    from revisit_anything_tpu_torch.training import vladbuff as vb
    from revisit_anything_tpu_torch.weights import init_cosplace_vit

    torch.cuda.empty_cache()
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {}

    model, cfg, _ = hub.load_model("dino_vits8", seed=seed, device=dev)
    imgs = np.stack([_image(rng, (480, 640)) for _ in range(8)])
    kw = dict(stride=4, layer=11, facet="key", load_size=224)
    build.reset_counts()
    feats = dinov1_dense_features(model, cfg, imgs, **kw)
    torch.cuda.synchronize()
    counts = {k.name: k.launches for k in build.KERNELS}
    if counts.pop(build.FLASH_ATTENTION_F32.name) != 11 or any(
            counts.values()):
        _fail(f"[backbones] DINOv1 batch launched "
              f"{build.FLASH_ATTENTION_F32.name} "
              f"{build.FLASH_ATTENTION_F32.launches} times (11 expected), "
              f"others {counts}")
    out["counts"] = {k.name: k.launches for k in build.KERNELS}
    if (tuple(feats.shape) != (8, 384, 480, 640)
            or not torch.isfinite(feats).all()):
        _fail(f"[backbones] DINOv1 features {tuple(feats.shape)} or not "
              "finite")
    _, out["dinov1"] = _timed(
        "backbones", "DINOv1 ViT-S/8 f32 480x640 -> 224x298 s4 (4,016 "
        "tokens), layer 11 key, upsampled",
        lambda: dinov1_dense_features(model, cfg, imgs, **kw), 8)
    kernel = dn.attend
    dn.attend = att.attend_reference
    try:
        plain = dinov1_dense_features(model, cfg, imgs[:1], **kw)
    finally:
        dn.attend = kernel
    abs_err, rel_err = _rel(feats[:1], plain)
    print(f"[backbones] DINOv1 witness: one image's features with K1 f32 "
          f"against its plain version in its place: max_abs_err "
          f"{abs_err:.3e} rel_err {rel_err:.3e} (tol 1e-4)", flush=True)
    if not rel_err <= 1e-4:
        _fail(f"[backbones] DINOv1 features off the plain forward by "
              f"{rel_err}")
    del model, feats, plain

    x224 = torch.randn((8, 224, 224, 3), generator=gen, device=dev)
    model = init_cosplace_vit(cv.VIT_BASE, gen, dev)
    with torch.inference_mode():
        desc, out["cosplace"] = _timed(
            "backbones", "CosPlace ViT-B/16 224x224 value facet, layer 11",
            lambda: cv.extract_features(model, cv.VIT_BASE, x224, 11,
                                        "value"), 8)
    if tuple(desc.shape) != (8, 196, 768) or not torch.isfinite(desc).all():
        _fail(f"[backbones] CosPlace features {tuple(desc.shape)}")
    del model

    model = rn.init_resnet(rn.RESNET50, seed, device=dev)
    x480 = torch.randn((8, 480, 640, 3), generator=gen, device=dev)
    with torch.inference_mode():
        fm, out["resnet50"] = _timed(
            "backbones", "ResNet-50 conv1..layer4 480x640",
            lambda: rn.resnet_forward(model, rn.RESNET50, x480), 8)
    if tuple(fm.shape) != (8, 2048, 15, 20) or not torch.isfinite(fm).all():
        _fail(f"[backbones] ResNet-50 features {tuple(fm.shape)}")
    del model, x480, fm

    model, cfg, fwd = hub.load_model("vlad_buff", seed=seed, device=dev)
    desc, out["vlad_buff"] = _timed(
        "backbones", "VLAD-BuFF DINOv2 ViT-B/14 + NetVLAD-AntiBurst 64 "
        "224x224 (49,152-d)", lambda: fwd(model, x224), 8)
    salad, scfg, sfwd = hub.load_model("dino_salad", seed=seed, device=dev)
    sdesc, out["dino_salad"] = _timed(
        "backbones", "DINO-SALAD DINOv2 ViT-B/14 224x224 (8,448-d)",
        lambda: sfwd(salad, x224), 8)
    for name, d, width in (("VLAD-BuFF", desc, 49152),
                           ("DINO-SALAD", sdesc, 8448)):
        norms = d.norm(dim=1)
        if (tuple(d.shape) != (8, width)
                or not torch.allclose(norms, torch.ones_like(norms),
                                      atol=1e-4)):
            _fail(f"[backbones] {name} descriptors {tuple(d.shape)} not "
                  "unit rows")
    del salad

    batches = [torch.randn((64, 224, 224, 3), generator=gen, device=dev)
               for _ in range(16)]
    descs = torch.cat([fwd(model, b) for b in batches])
    del batches
    torch.cuda.reset_peak_memory_stats()
    with _Span() as span:
        wpca = vb.fit_wpca(descs, 512)
    var = ((descs @ wpca["w"].T + wpca["b"]).var(0)).cpu()
    print(f"[backbones] fit_wpca 1,024 x 49,152 -> 512 (dual): "
          f"{span.wall:.3f} s, peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f}"
          f" GiB; whitened variance {var.min():.6f}..{var.max():.6f}",
          flush=True)
    if not (torch.isfinite(wpca["w"]).all() and (var - 1).abs().max() < 1e-2):
        _fail("[backbones] fit_wpca: the whitened set is not unit variance")
    out["fit_wpca_s"] = span.wall
    del model, descs, wpca
    torch.cuda.empty_cache()
    return out


def train_phase(dev, seed: int = 13) -> dict:
    """[train]: VLAD-BuFF training at the CLI's defaults (DINOv2 ViT-B/14,
    the last 4 of 12 blocks trainable, NetVLAD-AntiBurst 64, the
    multi-similarity loss, AdamW at lr 6e-5 on the linear schedule), 16
    places x 4 images at 224x224 a batch, f32 with TF32 off, from seeded
    PNGs read by ``discover_places`` → ``PlacesBatcher`` → ``prefetch``.
    Five steps: every loss finite, every frozen parameter bit for bit its
    start, every trainable tensor moved. ``save_train_state`` after step
    3, ``restore_train_state`` into a fresh state and step 4 there: loss
    and parameters within 1e-6 of the continued run's. Then
    ``run_validation`` on 32 references and 16 noisy-copy queries.
    Prints each loss, steps/s, images/s and peak device memory."""
    import os
    import tempfile

    import numpy as np
    import torch
    from PIL import Image

    from revisit_anything_tpu_torch.kernels import build
    from revisit_anything_tpu_torch.training import checkpoint as ck
    from revisit_anything_tpu_torch.training import data
    from revisit_anything_tpu_torch.training import train as tr
    from revisit_anything_tpu_torch.training import validation as val

    torch.cuda.empty_cache()
    rng = np.random.default_rng(seed)
    cfg = tr.VPRTrainConfig()
    steps, ppb, ipp = 5, 16, cfg.imgs_per_place

    def png(path, img):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        Image.fromarray(img).save(path, compress_level=1)

    def view(base):
        noise = rng.normal(0.0, 12.0, base.shape)
        return np.clip(base + noise, 0, 255).astype(np.uint8)

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        for p in range(steps * ppb):
            base = _image(rng, (240, 320))
            for i in range(ipp):
                png(os.path.join(tmp, "gsv", f"city{p % 2}", f"{p:04d}",
                                 f"{i}.png"), view(base))
        places = data.discover_places(os.path.join(tmp, "gsv"), ipp)
        batches = list(data.prefetch(iter(data.PlacesBatcher(
            places, (224, 224), ppb, ipp, seed=seed))))
        print(f"[train] {len(places)} places written and {len(batches)} "
              f"batches of {ppb * ipp} loaded in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        if len(batches) != steps:
            _fail(f"[train] {len(batches)} batches, {steps} expected")

        state = tr.create_train_state(cfg, seed=seed, device=dev)
        start = {n: p.detach().clone()
                 for n, p in state.model.named_parameters()}
        mask = tr._trainable_mask(state.model, cfg)
        build.reset_counts()
        torch.cuda.reset_peak_memory_stats()

        def step(st, i):
            x, y = batches[i]
            torch.cuda.synchronize()
            t = time.perf_counter()
            loss = tr.train_step(st, cfg, torch.from_numpy(x),
                                 torch.from_numpy(y)).item()
            return loss, time.perf_counter() - t

        losses, secs = [], []
        for i in range(steps):
            loss, sec = step(state, i)
            losses.append(loss)
            secs.append(sec)
            if i == 2:
                path = ck.save_train_state(os.path.join(tmp, "ckpt"), state)
                after3 = {n: p.detach().clone()
                          for n, p in state.model.named_parameters()}
            if i == 3:
                at4 = {n: p.detach().clone()
                       for n, p in state.model.named_parameters()}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        counts = {k.name: k.launches for k in build.KERNELS}
        rate = (steps - 1) / sum(secs[1:])
        print(f"[train] losses {' '.join(f'{v:.6f}' for v in losses)}; step "
              f"ms {' '.join(f'{1e3 * v:.1f}' for v in secs)}; "
              f"{rate:.3f} steps/s, {rate * ppb * ipp:.1f} images/s (steps "
              f"2-5), peak {peak:.2f} GiB; kernel launches {counts}",
              flush=True)
        if not all(np.isfinite(losses)):
            _fail(f"[train] a loss is not finite: {losses}")
        for n, p in state.model.named_parameters():
            moved = not torch.equal(p, start[n])
            if moved != mask[n]:
                _fail(f"[train] {n}: {'frozen but changed' if moved else 'trainable but never changed'}")
        n_train = sum(p.numel() for n, p in state.model.named_parameters()
                      if mask[n])
        print(f"[train] {n_train:,} trainable parameters moved, "
              f"{sum(p.numel() for p in state.model.parameters()) - n_train:,}"
              " frozen bit for bit", flush=True)

        fresh = tr.create_train_state(cfg, seed=seed + 1, device=dev)
        ck.restore_train_state(path, fresh)
        same = all(torch.equal(p, after3[n])
                   for n, p in fresh.model.named_parameters())
        loss4, _ = step(fresh, 3)
        worst = max(_rel(p, at4[n])[1]
                    for n, p in fresh.model.named_parameters())
        print(f"[train] resumed from {os.path.basename(path)} (restored "
              f"bit for bit: {same}): step 4 loss {loss4:.9f} against "
              f"{losses[3]:.9f}, parameters within {worst:.3e} relative",
              flush=True)
        if not (same and abs(loss4 - losses[3]) <= 1e-6 * abs(losses[3])
                and worst <= 1e-6):
            _fail("[train] the resumed step 4 differs from the continued "
                  "run's")
        del fresh, after3, at4, start

        root = os.path.join(tmp, "val")
        refs = [_image(rng, (240, 320)) for _ in range(32)]
        for i, img in enumerate(refs):
            png(os.path.join(root, "ref", f"{i:03d}.png"), img)
        for i in range(16):
            png(os.path.join(root, "query", f"{i:03d}.png"), view(refs[i]))
        np.save(os.path.join(root, "gt.npy"),
                np.asarray([[i] for i in range(16)], dtype=object),
                allow_pickle=True)
        vset = val.ValidationSet.from_directory(root)
        with _Span() as span:
            recalls = val.run_validation(state.model, cfg, vset,
                                         print_results=False)
        print(f"[train] run_validation 32 refs, 16 queries: "
              f"{', '.join(f'R@{k} {v:.4f}' for k, v in recalls.items())} "
              f"in {span.wall:.2f} s", flush=True)
    del state
    torch.cuda.empty_cache()
    return dict(losses=losses, steps_s=rate, peak_gib=peak, recalls=recalls)


SHARDED_STEPS = 3


def _sharded_batches(seed: int, ppb: int = 16, ipp: int = 4) -> list:
    """[train]'s batch shape from a seed: ``ppb`` places x ``ipp`` views
    at 224x224, normalized f32; a place's views share a weak common image
    so the miner finds pairs."""
    import numpy as np
    rng = np.random.default_rng(seed)
    labels = np.repeat(np.arange(ppb), ipp)
    out = []
    for _ in range(SHARDED_STEPS):
        base = 0.3 * rng.standard_normal((ppb, 224, 224, 3), np.float32)
        out.append((base[labels] + rng.standard_normal(
            (ppb * ipp, 224, 224, 3), np.float32), labels))
    return out


def _timed_steps(step, batches) -> tuple:
    """Losses of ``step(images, labels)`` over ``batches`` and its steps/s
    after the first (synchronized wall)."""
    import torch
    losses, secs = [], []
    for x, y in batches:
        torch.cuda.synchronize()
        t = time.perf_counter()
        losses.append(step(x, y).item())
        secs.append(time.perf_counter() - t)
    return losses, (len(secs) - 1) / sum(secs[1:])


SHARDED_MESHES = ((1, 2), (2, 1))


def _sharded_worker(argv) -> None:
    """One of [sharded-train] (b)'s two processes on the card (gloo): the
    sharded step from the seeded state on each mesh of
    ``SHARDED_MESHES`` in turn; rank 0 saves each mesh's losses, steps/s,
    peak memory and gathered parameters to ``<argv[3]>/<dp>x<tp>.pt``."""
    import os

    import torch
    import torch.distributed as dist

    from revisit_anything_tpu_torch.dryrun import init_rank
    from revisit_anything_tpu_torch.parallel import make_mesh
    from revisit_anything_tpu_torch.training import train as tr
    addr, rank, seed, out = argv[0], int(argv[1]), int(argv[2]), argv[3]
    dev = init_rank(addr, "gloo", 2, rank, "cuda:0")
    cfg = tr.VPRTrainConfig()
    batches = _sharded_batches(seed)
    for dp, tp in SHARDED_MESHES:
        step_fn, st = tr.make_sharded_train_step(
            make_mesh((dp, tp), ("data", "model"), devices=[dev] * 2), cfg,
            tr.create_train_state(cfg, seed=seed, device=dev))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        losses, rate = _timed_steps(lambda x, y: step_fn(st, x, y), batches)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        params, _ = st.state_dicts()
        if rank == 0:
            torch.save({"losses": losses, "steps_s": rate, "peak_gib": peak,
                        "params": {k: v.cpu() for k, v in params.items()}},
                       os.path.join(out, f"{dp}x{tp}.pt"))
        del st, params
    dist.destroy_process_group()


def sharded_train_phase(dev, seed: int = 17) -> dict:
    """[sharded-train]: ``make_sharded_train_step`` at [train]'s sizes
    (DINOv2 ViT-B/14, 4 of 12 blocks trainable, NetVLAD-AntiBurst 64,
    AdamW at lr 6e-5 on the linear schedule; 16 places x 4 views at
    224x224 a batch, f32 with TF32 off; seeded batches) against
    ``train_step`` from the same seeded state: (a) a 1x1 mesh on an NCCL
    group of this process alone; (b) two processes on the one card over
    gloo with CUDA tensors (NCCL refuses two ranks on one card), meshes
    (1, 2) and (2, 1). Three steps each: losses within rtol 1e-4 and
    every parameter within atol 1e-4 (the CPU test's AdamW bounds), the
    frozen ones bit for bit. Prints steps/s (steps 2-3) of each."""
    import os
    import tempfile

    import torch
    import torch.distributed as dist

    from revisit_anything_tpu_torch.dryrun import free_port, run_ranks
    from revisit_anything_tpu_torch.parallel import make_mesh
    from revisit_anything_tpu_torch.training import train as tr

    torch.cuda.empty_cache()
    cfg = tr.VPRTrainConfig()
    batches = _sharded_batches(seed)
    ref = tr.create_train_state(cfg, seed=seed, device=dev)
    mask = tr._trainable_mask(ref.model, cfg)
    want, want_rate = _timed_steps(
        lambda x, y: tr.train_step(ref, cfg, torch.from_numpy(x),
                                   torch.from_numpy(y)), batches)
    final = {n: p.detach() for n, p in ref.model.named_parameters()}
    print(f"[sharded-train] train_step (one device): losses "
          f"{' '.join(f'{v:.6f}' for v in want)}; {want_rate:.3f} steps/s "
          f"(steps 2-3)", flush=True)
    out = {"one_device_steps_s": want_rate}

    def check(tag, losses, params, rate, note=""):
        dl = max(abs(a - b) / abs(b) for a, b in zip(losses, want))
        dp_ = max((params[n].to(dev) - p).abs().max().item()
                  for n, p in final.items())
        frozen = all(torch.equal(params[n].to(dev), p)
                     for n, p in final.items() if not mask[n])
        print(f"[sharded-train] {tag}: losses "
              f"{' '.join(f'{v:.6f}' for v in losses)}; {rate:.3f} steps/s "
              f"(steps 2-3; train_step {want_rate:.3f}); max loss rel diff "
              f"{dl:.3e}, max |param diff| {dp_:.3e}, frozen bit for bit "
              f"{frozen}{note}", flush=True)
        if not (dl <= 1e-4 and dp_ <= 1e-4 and frozen):
            _fail(f"[sharded-train] {tag} disagrees with train_step")
        out[tag] = dict(losses=losses, steps_s=rate, loss_rel=dl,
                        param_abs=dp_)

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        step_fn, st = tr.make_sharded_train_step(
            make_mesh((1, 1), ("data", "model"), devices=[dev]), cfg,
            tr.create_train_state(cfg, seed=seed, device=dev))
        losses, rate = _timed_steps(lambda x, y: step_fn(st, x, y), batches)
        params, _ = st.state_dicts()
        check("(a) 1x1 mesh, NCCL, world 1", losses, params, rate)
        del st, params
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        addr = f"tcp://127.0.0.1:{free_port()}"
        t0 = time.perf_counter()
        run_ranks("import sys, chip_smoke; "
                  "chip_smoke._sharded_worker(sys.argv[1:])",
                  [[addr, r, seed, tmp] for r in range(2)], timeout=600)
        print(f"[sharded-train] (b) both meshes in "
              f"{time.perf_counter() - t0:.1f} s with the processes' "
              f"start-up", flush=True)
        for dp, tp in SHARDED_MESHES:
            res = torch.load(os.path.join(tmp, f"{dp}x{tp}.pt"),
                             weights_only=True)
            check(f"(b) ({dp}, {tp}) mesh, gloo with CUDA tensors, 2 "
                  f"processes on one card", res["losses"], res["params"],
                  res["steps_s"], f"; rank 0 peak {res['peak_gib']:.2f} GiB")
    del ref, final
    torch.cuda.empty_cache()
    return out


def dryrun_phase() -> dict:
    """[dryrun]: ``dryrun_multichip(4)`` on the card (the mesh paths over
    the one H100 listed 4 times; the train step in 4 processes over
    gloo), with the counters reset first: its extraction path must
    launch K1, K2, K5, K3 and K4."""
    from revisit_anything_tpu_torch.dryrun import dryrun_multichip
    from revisit_anything_tpu_torch.kernels import build
    build.reset_counts()
    t0 = time.perf_counter()
    out = dryrun_multichip(4)
    counts = {k.name: k.launches for k in build.KERNELS if k.launches}
    print(f"[dryrun] {time.perf_counter() - t0:.1f} s; train step "
          f"{out['train']['seconds']:.1f} s with its 4 processes' start-up; "
          f"launches {counts} (extraction with and without the mesh)",
          flush=True)
    missing = [k.name for k in _paths()["shared"] if k.name not in counts]
    if missing:
        _fail(f"[dryrun] kernels not launched: {missing}")
    return out


def preprocess_phase(sam, seed: int = 14) -> dict:
    """[preprocess]: ``SamPredictor.set_image`` at full width on a
    1200x1600 and a 2048x1536 uint8 image, both larger than SAM's 1024
    frame (PIL's host downscale, then the encoder), with the counters
    reset first: K1 must launch 4 times an image (the 4 global layers)
    and no other kernel. For the 2048x1536 image (the CPU's ~90 s a call
    are kept to one image, so the smoke stays inside half its time
    limit) the same calls on the CPU (a copy of the same bf16 weights,
    plain versions) give the reference, and a CPU copy in f32 the
    witness of which side a disagreement is rounding on:

    - the image embedding within 2e-2 of the CPU's in norm (||card -
      cpu|| / ||cpu||; its max-abs error over the max-abs value is
      printed: 32 bf16 layers on each side, rounded in another order);
    - for 4 grid points, each of the 3 masks' predicted IoU within
      [predictor]'s 2e-2 of the CPU's, and its low-res logits (the
      decoder's output, before the upscale) within LOWRES_TOL of the
      CPU's largest |logit|;
    - the masks differ from the CPU's only at pixels whose CPU logit
      lies within that same bound of the threshold: the upscale is a
      convex blend of low-res logits, so a pixel further from it than
      the low-res error cannot flip, and a flip elsewhere is a fault;
    - the card's low-res logits no further from the f32 witness's than
      WITNESS_FACTOR times the CPU bf16 copy's distance from it.

    Printed besides: the masks' IoU against the CPU's and the witness's,
    how many pixels flipped, the largest |CPU logit| among them and the
    share of pixels inside the bound. set_image ms on the card (wall,
    synchronized, after one warm-up call) and its parts, timed apart
    after it (host downscale, upload, encode, the rest), and s on the
    CPU."""
    import copy

    import numpy as np
    import torch

    from revisit_anything_tpu_torch.kernels import build
    from revisit_anything_tpu_torch.models.sam import amg as pamg
    from revisit_anything_tpu_torch.models.sam.predictor import SamPredictor

    LOWRES_TOL, WITNESS_FACTOR = 2e-2, 2.0
    thr = sam.cfg.mask_threshold
    rng = np.random.default_rng(seed)
    cpu_sam = copy.deepcopy(sam).cpu()
    f32_sam = copy.deepcopy(cpu_sam).float()
    out = {}

    def iou(a, b):
        union = np.logical_or(a, b).sum()
        return np.logical_and(a, b).sum() / union if union else 1.0

    for hw, on_cpu in (((1200, 1600), False), ((2048, 1536), True)):
        img = _image(rng, hw)
        pred = SamPredictor(sam)
        pred.set_image(img)                                   # warm-up
        build.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred.set_image(img)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = {k.name: k.launches for k in build.KERNELS if k.launches}
        # set_image's parts, each synchronized: the host downscale and
        # normalize, the upload, the encode, and the rest (the host's
        # low-res -> image resize matrices and their upload)
        parts = {}
        t0 = time.perf_counter()
        x, _ = pamg.preprocess_image(img, sam.cfg, "cpu")
        parts["host"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        x = x.to(sam.encoder.pos_embed.device)
        torch.cuda.synchronize()
        parts["upload"] = (time.perf_counter() - t0) * 1e3
        with torch.inference_mode():
            t0 = time.perf_counter()
            sam.encoder(x)
            torch.cuda.synchronize()
            parts["encode"] = (time.perf_counter() - t0) * 1e3
        parts["rest"] = ms - sum(parts.values())
        del x
        key = f"{hw[0]}x{hw[1]}"
        if not on_cpu:
            finite = bool(torch.isfinite(pred.get_image_embedding()).all())
            print(f"[preprocess] set_image {key} -> input {pred._input_hw}: "
                  f"{ms:.3f} ms on the card ("
                  f"{', '.join(f'{k} {v:.3f}' for k, v in parts.items())} "
                  f"ms); launches {counts}; embedding finite {finite} (no "
                  "CPU reference for this image)", flush=True)
            if counts != {build.FLASH_ATTENTION.name: 4} or not finite:
                _fail(f"[preprocess] {key}: launches {counts}, K1 x4 "
                      f"expected; embedding finite {finite}")
            out[key] = dict(ms=ms, parts=parts)
            continue
        cpu_pred = SamPredictor(cpu_sam)
        t0 = time.perf_counter()
        cpu_pred.set_image(img)
        cpu_s = time.perf_counter() - t0
        f32_pred = SamPredictor(f32_sam)
        f32_pred.set_image(img)
        emb, ref = pred.get_image_embedding(), cpu_pred.get_image_embedding()
        err = _rel(emb.cpu(), ref)
        norm_rel = ((emb.cpu().float() - ref.float()).norm()
                    / ref.float().norm()).item()
        _, pts, _ = pamg.prompt_points(32, pred._input_hw, hw, 1024)
        r = dict(iou_cpu=1.0, iou_f32_card=1.0, iou_f32_cpu=1.0,
                 pred_diff=0.0, lowres_rel=0.0, flipped=0, outside=0,
                 flip_margin=0.0, band_share=0.0, witness_card=0.0,
                 witness_cpu=0.0)
        for i in (100, 300, 530, 910):
            point = dict(point_coords=pts[i][None],
                         point_labels=np.array([1]), return_logits=True)
            lg_card, iou_card, lo_card = pred.predict(**point)
            lg_cpu, iou_cpu, lo_cpu = cpu_pred.predict(**point)
            lg_f32, _, lo_f32 = f32_pred.predict(**point)
            for k in range(3):
                m_card, m_cpu = lg_card[k] > thr, lg_cpu[k] > thr
                m_f32 = lg_f32[k] > thr
                bound = LOWRES_TOL * np.abs(lo_cpu[k]).max()
                lo_err = np.abs(lo_card[k] - lo_cpu[k]).max()
                flip = m_card != m_cpu
                margin = np.abs(lg_cpu[k] - thr)
                r["iou_cpu"] = min(r["iou_cpu"], iou(m_card, m_cpu))
                r["iou_f32_card"] = min(r["iou_f32_card"], iou(m_card, m_f32))
                r["iou_f32_cpu"] = min(r["iou_f32_cpu"], iou(m_cpu, m_f32))
                r["pred_diff"] = max(r["pred_diff"],
                                     abs(float(iou_card[k] - iou_cpu[k])))
                r["lowres_rel"] = max(r["lowres_rel"],
                                      lo_err / np.abs(lo_cpu[k]).max())
                r["flipped"] += int(flip.sum())
                r["outside"] += int((flip & (margin > bound)).sum())
                if flip.any():
                    r["flip_margin"] = max(r["flip_margin"],
                                           float(margin[flip].max()))
                r["band_share"] = max(r["band_share"],
                                      float((margin <= bound).mean()))
                r["witness_card"] = max(r["witness_card"], float(
                    np.abs(lo_card[k] - lo_f32[k]).max()))
                r["witness_cpu"] = max(r["witness_cpu"], float(
                    np.abs(lo_cpu[k] - lo_f32[k]).max()))
        finite = bool(torch.isfinite(emb).all())
        print(f"[preprocess] set_image {key} -> input {pred._input_hw}: "
              f"{ms:.3f} ms on the card ("
              f"{', '.join(f'{k} {v:.3f}' for k, v in parts.items())} ms), "
              f"{cpu_s:.2f} s on the CPU; launches {counts}; embedding against the CPU: max-abs "
              f"rel_err {err[1]:.3e}, norm rel_err {norm_rel:.3e}, finite "
              f"{finite}", flush=True)
        print(f"[preprocess] {key}, 4 points x 3 masks: max |predicted IoU "
              f"diff| {r['pred_diff']:.2e}; low-res logits max-abs err over "
              f"the CPU's max |logit| {r['lowres_rel']:.3e} (limit "
              f"{LOWRES_TOL}); min mask IoU against the CPU "
              f"{r['iou_cpu']:.4f}, card and CPU against the f32 witness "
              f"{r['iou_f32_card']:.4f}, {r['iou_f32_cpu']:.4f}; "
              f"{r['flipped']} pixels flipped, {r['outside']} of them "
              f"outside the bound, largest |CPU logit| among them "
              f"{r['flip_margin']:.3e}, share of pixels inside the bound "
              f"{r['band_share']:.4f}; low-res max |diff| from the f32 "
              f"witness: card {r['witness_card']:.3e}, CPU bf16 "
              f"{r['witness_cpu']:.3e}", flush=True)
        if counts != {build.FLASH_ATTENTION.name: 4}:
            _fail(f"[preprocess] {key}: launches {counts}, K1 x4 expected")
        if not finite or norm_rel > 2e-2 or r["pred_diff"] > 2e-2:
            _fail(f"[preprocess] {key}: the card's embedding or predicted "
                  "IoUs disagree with the CPU's")
        if r["lowres_rel"] > LOWRES_TOL or r["outside"]:
            _fail(f"[preprocess] {key}: the card's low-res logits or masks "
                  "disagree with the CPU's beyond bf16 rounding")
        if r["witness_card"] > WITNESS_FACTOR * r["witness_cpu"]:
            _fail(f"[preprocess] {key}: the card is further from the f32 "
                  "witness than the CPU's bf16 copy")
        out[key] = dict(ms=ms, parts=parts, cpu_s=cpu_s, rel_err=err[1],
                        norm_rel_err=norm_rel, **r)
    del cpu_sam, f32_sam
    return out


def mesh_phase(srv, dino, queries, seed: int = 15) -> dict:
    """[mesh]: a mesh that lists the one H100 twice (the card's machine has
    one; NCCL and a mesh of several cards cannot run here), over which:
    ``sharded_knn_l2`` at 100k f32 rows x 1024 and 128 queries, k 200,
    against ``knn_l2`` (equal distances within 1e-5, equal index sets but
    where two rows tie at the k-th distance within 1e-5);
    ``dino_dense_features`` of DINOv2-g on a batch of 8 480x640 images
    split by ``data_parallel_apply`` against the one forward (within 2e-2
    of the features' scale; K1 31 times a chunk); a row-sharded
    ``SegVLADServer`` (the live index, room for 4 images) against a
    one-device one built the same way: two inserts, a removal and the
    queries give equal top-5 ids; the launches of each server's queries,
    counted on their own, are equal and hold every "shared" kernel.
    ms of each (CUDA events or synchronized wall)."""
    import numpy as np
    import torch

    from revisit_anything_tpu_torch.kernels import build
    from revisit_anything_tpu_torch.ops.knn import knn_l2
    from revisit_anything_tpu_torch.parallel import make_mesh, sharded_knn_l2
    from revisit_anything_tpu_torch.pipeline.extract import (
        dino_dense_features)
    from revisit_anything_tpu_torch.pipeline.serve import SegVLADServer

    dev = srv.device
    mesh = make_mesh(devices=[dev, dev])
    out = {}
    g = torch.Generator(device=dev).manual_seed(seed)
    db = torch.randn((100_000, 1024), generator=g, device=dev)
    db /= db.norm(dim=1, keepdim=True)
    q = torch.randn((128, 1024), generator=g, device=dev)
    q /= q.norm(dim=1, keepdim=True)
    sq_s, idx_s = sharded_knn_l2(q, db, 200, mesh)
    sq_1, idx_1 = knn_l2(q, db, 200)
    d_err = (sq_s - sq_1).abs().max().item()
    kth = sq_1[:, -1:]
    rows_differ, unexplained = 0, 0
    for r in range(q.shape[0]):
        a, b = set(idx_s[r].tolist()), set(idx_1[r].tolist())
        if a != b:
            rows_differ += 1
            odd = torch.tensor(sorted(a ^ b), device=dev)
            dist = ((db[odd] - q[r]) ** 2).sum(1)
            unexplained += int(((dist - kth[r]).abs() > 1e-5).sum())
    out["knn_sharded_ms"] = _time_ms(lambda: sharded_knn_l2(q, db, 200, mesh),
                                     reps=5)
    out["knn_ms"] = _time_ms(lambda: knn_l2(q, db, 200), reps=5)
    print(f"[mesh] sharded_knn_l2 100k x 1024 f32, 128 queries, k 200, 2 "
          f"shards on one H100: {out['knn_sharded_ms']:.3f} ms against "
          f"knn_l2 {out['knn_ms']:.3f} ms (CUDA events, median of 5); "
          f"max |distance diff| {d_err:.3e}, rows whose sets differ "
          f"{rows_differ} (by ties at the k-th: {unexplained == 0})",
          flush=True)
    if d_err > 1e-5 or unexplained:
        _fail("[mesh] sharded_knn_l2 disagrees with knn_l2")
    del db, q

    imgs = np.stack([_image(np.random.default_rng(seed + i), (480, 640))
                     for i in range(8)])
    single = dino_dense_features(dino, imgs, mesh=None)
    build.reset_counts()
    split = dino_dense_features(dino, imgs, mesh=mesh)
    k1_split = build.FLASH_ATTENTION.launches
    build.reset_counts()
    dino_dense_features(dino, imgs, mesh=None)
    k1_single = build.FLASH_ATTENTION.launches
    err = _rel(split, single)
    out["dp_ms"] = _time_ms(lambda: dino_dense_features(dino, imgs,
                                                        mesh=mesh), reps=3)
    out["single_ms"] = _time_ms(lambda: dino_dense_features(dino, imgs),
                                reps=3)
    print(f"[mesh] data_parallel_apply DINOv2-g, batch 8 480x640 in 2 chunks "
          f"of 4: {out['dp_ms']:.3f} ms against one forward "
          f"{out['single_ms']:.3f} ms (CUDA events, median of 3); K1 "
          f"launches {k1_split} split, {k1_single} whole; rel_err "
          f"{err[1]:.3e}", flush=True)
    if err[1] > 2e-2 or k1_split != 2 * k1_single or k1_single != 31:
        _fail("[mesh] the split DINOv2-g forward disagrees with the whole")
    del single, split

    index = _live_index(srv)
    n = index.db.shape[0]
    kw = dict(sam=srv.sam, dino=srv.dino, index=index, full_hw=srv.full_hw,
              sam_hw=srv.sam_hw, amg=srv.amg, max_masks=srv.kmax,
              db_capacity=n + 4 * srv.kmax)
    one = SegVLADServer(mesh=None, **kw)
    two = SegVLADServer(mesh=mesh, **kw)
    rng = np.random.default_rng(seed)
    new = [_image(rng, srv.full_hw) for _ in range(2)]
    ids = [one.add_reference_images(new), two.add_reference_images(new)]
    one.remove_reference_image(ids[0][0])
    two.remove_reference_image(ids[1][0])
    asked = list(queries) + [_noisy(rng, im) for im in new]
    # each server's launches counted on their own: the one device's
    # queries first, then the counters reset and the sharded ones
    build.reset_counts()
    tops_one = [one.query(img) for img in asked]
    counts_one = {k.name: k.launches for k in build.KERNELS if k.launches}
    build.reset_counts()
    tops_two = [two.query(img) for img in asked]
    counts = {k.name: k.launches for k in build.KERNELS if k.launches}
    tops = list(zip(tops_one, tops_two))
    walls = {}
    for name, s in (("one device", one), ("row-sharded", two)):
        t = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s.query(asked[0])
            t.append((time.perf_counter() - t0) * 1e3)
        walls[name] = statistics.median(t)
    out["server_ms"] = walls
    print(f"[mesh] row-sharded SegVLADServer ({n + 4 * srv.kmax} rows in 2 "
          f"shards) against one device: inserted {ids[1]} ({ids[0]}), "
          f"removed {ids[1][0]}; top-5 "
          f"{[b.tolist() for _, b in tops]} sharded, equal: "
          f"{all(np.array_equal(a, b) for a, b in tops)}; query wall "
          f"{walls['row-sharded']:.1f} ms sharded, "
          f"{walls['one device']:.1f} ms one device (median of 3)",
          flush=True)
    per_query = {k: v / len(asked) for k, v in counts.items()}
    print(f"[mesh] launches over {len(asked)} queries: row-sharded {counts} "
          f"({per_query} a query), one device {counts_one}", flush=True)
    if ids[0] != ids[1] or not all(np.array_equal(a, b) for a, b in tops):
        _fail("[mesh] the row-sharded server's answers differ")
    if ids[1][0] in tops[-2][1] or tops[-1][1][0] != ids[1][1]:
        _fail("[mesh] the removed image is found, or the inserted one not "
              "first for its noisy copy")
    missing = [k.name for k in _paths()["shared"] if k.name not in counts]
    if missing:
        _fail(f"[mesh] kernels not launched by the sharded server: {missing}")
    if counts != counts_one:
        _fail(f"[mesh] the sharded server launched {counts}, the one-device "
              f"server {counts_one}")
    out["launches"] = dict(sharded=counts, one_device=counts_one,
                           queries=len(asked))
    del one, two
    torch.cuda.empty_cache()
    return out


def cli_phase(dev, seed: int = 16) -> dict:
    """[cli]: the port's CLI at full width on the card (its default
    device), through ``cli.main``: ``query`` (SAM ViT-H, DINOv2-g layer
    31, seeded weights in f32, the JAX CLI's dtype, the 1024-prompt AMG
    with both thresholds off) over a 20,000-row, 400-image index the smoke
    writes, whose top-5 must equal ``SegVLADServer.query``'s built by the
    library in f32 from the same index and seeds, with the "shared"
    decoder's f32 kernels launched; a ``serve`` loop
    of three commands (query, add, query of the added image, which must
    come first); ``amg`` on one 1200x1600 image (mask PNGs and
    metadata.csv, AMG's kernels launched); ``train`` for 3 steps at the
    [train] phase's sizes (finite losses). Seconds a command. extract,
    vocab, pca, evaluate and build-index write h5 files, which this
    machine cannot (no h5py): they run in the CPU tests only."""
    import contextlib
    import importlib.util
    import io
    import os
    import tempfile

    import numpy as np
    import torch
    from PIL import Image

    from revisit_anything_tpu_torch import cli
    from revisit_anything_tpu_torch.config import (DINO_G_DIM, NUM_CLUSTERS,
                                                   PCA_DIM, PLACES17_HW,
                                                   PLACES17_SAM_HW)
    from revisit_anything_tpu_torch.kernels import build
    from revisit_anything_tpu_torch.models.dinov2 import VIT_G14
    from revisit_anything_tpu_torch.models.sam import SAM_VIT_H
    from revisit_anything_tpu_torch.models.sam.amg import AmgConfig
    from revisit_anything_tpu_torch.pipeline.serve import (SegVLADServer,
                                                           ServingIndex)
    from revisit_anything_tpu_torch.weights import init_dino, init_sam

    torch.cuda.empty_cache()
    rng = np.random.default_rng(seed)
    secs = {}

    def run(name, argv, stdin=None):
        buf, old = io.StringIO(), sys.stdin
        if stdin is not None:
            sys.stdin = io.StringIO(stdin)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                cli.main(argv)
        finally:
            sys.stdin = old
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        return buf.getvalue()

    def counts():
        return {k.name: k.launches for k in build.KERNELS}

    with tempfile.TemporaryDirectory() as tmp:
        n_img, per = 400, 50
        db = rng.standard_normal((n_img * per, PCA_DIM)).astype(np.float32)
        db /= np.linalg.norm(db, axis=1, keepdims=True)
        index = os.path.join(tmp, "index.npz")
        np.savez(
            index, db=db, db_dtype=np.asarray("float32"),
            db_image_ids=np.repeat(np.arange(n_img), per),
            image_keys=np.asarray([f"ref_{i:04d}.png" for i in range(n_img)]),
            centers=rng.standard_normal((NUM_CLUSTERS, DINO_G_DIM)).astype(
                np.float32),
            pca_mean=np.zeros(NUM_CLUSTERS * DINO_G_DIM, np.float32),
            pca_components=(rng.standard_normal(
                (PCA_DIM, NUM_CLUSTERS * DINO_G_DIM), np.float32) * 0.01),
            pca_variance=np.ones(PCA_DIM, np.float32),
            pca_whiten=np.asarray(True), order=np.asarray(3),
            mask_h=np.asarray(PLACES17_SAM_HW[0]),
            mask_w=np.asarray(PLACES17_SAM_HW[1]),
            dino_h=np.asarray(PLACES17_HW[0]),
            dino_w=np.asarray(PLACES17_HW[1]))
        del db
        paths = {}
        for name, hw in (("query", PLACES17_HW), ("added", PLACES17_HW),
                         ("camera", (1200, 1600))):
            paths[name] = os.path.join(tmp, f"{name}.png")
            Image.fromarray(_image(rng, hw)).save(paths[name])
        flags = ["--index", index, "--topk", "5", "--pred-iou-thresh=-1e9",
                 "--stability-score-thresh", "0.0"]

        build.reset_counts()
        got = json.loads(run("query", ["query", "--image", paths["query"],
                                       *flags]).splitlines()[-1])
        c = counts()
        missing = [k.name for k in _paths()["shared_f32"] if c[k.name] == 0]
        srv = SegVLADServer(
            sam=init_sam(SAM_VIT_H, torch.Generator(device=dev).manual_seed(
                0), dev, torch.float32),
            dino=init_dino(VIT_G14, torch.Generator(device=dev).manual_seed(
                1), dev, torch.float32),
            index=ServingIndex.from_npz(index), full_hw=PLACES17_HW,
            sam_hw=PLACES17_SAM_HW, dino_layer=31, top_images=5,
            amg=AmgConfig(points_per_batch=1024, pred_iou_thresh=-1e9,
                          stability_score_thresh=0.0))
        want = srv.query(np.asarray(Image.open(paths["query"]).convert(
            "RGB")))
        del srv
        torch.cuda.empty_cache()
        print(f"[cli] query: {json.dumps(got)} in {secs['query']:.2f} s "
              f"(models built from seeds 0 and 1, index read); the "
              f"library's SegVLADServer: {want.tolist()}; launches {c}",
              flush=True)
        if (sorted(got) != ["image_ids", "matches", "query"]
                or got["image_ids"] != want[want >= 0].tolist()
                or got["matches"] != [f"ref_{i:04d}.png"
                                      for i in got["image_ids"]]):
            _fail("[cli] query's JSON differs from the library's answer")
        if missing:
            _fail(f"[cli] query launched no {missing}")

        script = (f"query {paths['query']}\nadd {paths['added']}\n"
                  f"query {paths['added']}\nquit\n")
        lines = [json.loads(ln) for ln in run(
            "serve", ["serve", *flags, "--db-capacity",
                      str(n_img * per + 128)], stdin=script).splitlines()]
        print(f"[cli] serve (query, add, query the added image): {lines} in "
              f"{secs['serve']:.2f} s", flush=True)
        if (len(lines) != 4 or lines[0].get("ready") is not True
                or lines[1] != got or lines[2].get("image_id") != n_img
                or lines[3].get("image_ids", [None])[0] != n_img):
            _fail("[cli] the serve loop's answers are not the expected ones")

        build.reset_counts()
        amg_out = os.path.join(tmp, "amg")
        run("amg", ["amg", "--input", paths["camera"], "--output", amg_out,
                    "--pred-iou-thresh=-1e9", "--stability-score-thresh",
                    "0.0"])
        c = counts()
        masks = [f for f in os.listdir(os.path.join(amg_out, "camera"))
                 if f.endswith(".png")]
        with open(os.path.join(amg_out, "camera", "metadata.csv")) as f:
            rows = f.read().splitlines()
        print(f"[cli] amg 1200x1600: {len(masks)} masks in "
              f"{secs['amg']:.2f} s (seeded ViT-H built); launches {c}",
              flush=True)
        if not masks or len(rows) != len(masks) + 1 or any(
                c[k.name] == 0 for k in _paths()["shared_f32"]
                if k is not build.FLASH_ATTENTION_F32):
            _fail("[cli] amg wrote no masks or launched no AMG kernel")

        for p in range(16):
            base = _image(rng, (240, 320))
            for i in range(4):
                d = os.path.join(tmp, "gsv", f"city{p % 2}", f"{p:04d}")
                os.makedirs(d, exist_ok=True)
                Image.fromarray(_noisy(rng, base)).save(
                    os.path.join(d, f"{i}.png"), compress_level=1)
        out = run("train", ["train", "--train-root", os.path.join(tmp, "gsv"),
                            "--ckpt-dir", os.path.join(tmp, "ckpt"),
                            "--steps", "3", "--log-every", "1",
                            "--ckpt-every", "100"])
        losses = [float(ln.split("loss")[1]) for ln in out.splitlines()
                  if ln.startswith("step ")]
        print(f"[cli] train 3 steps (DINOv2-B/14, 16 places x 4 at 224x224, "
              f"AdamW): losses {losses} in {secs['train']:.2f} s with the "
              f"model build and a checkpoint", flush=True)
        if len(losses) != 3 or not np.isfinite(losses).all():
            _fail(f"[cli] train printed losses {losses}")
    h5 = importlib.util.find_spec("h5py") is not None
    print(f"[cli] extract, vocab, pca, evaluate, build-index: skipped (they "
          f"write h5 files; h5py {'present' if h5 else 'absent'} here; "
          f"tests/test_torch_cli.py runs them on the CPU)", flush=True)
    print(f"[cli] seconds a command: "
          f"{json.dumps({k: round(v, 2) for k, v in secs.items()})}",
          flush=True)
    return secs


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
    return (int(amg_a[1][-1]), int(amg_b[1][-1]),
            (_best_iou(amg_a, amg_b) > 0.5).float().mean().item())


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


def _stage_ms(srv, img, answer) -> tuple:
    """One query's stages between CUDA events (SegVLADServer.query step by
    step; the answer must equal query()'s): ([(stage, ms), ...], wall ms)."""
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
    return ([(name, prev.elapsed_time(ev))
             for (_, prev, _), (name, ev, _) in zip(marks[:-1], marks[1:])],
            1e3 * (marks[-1][2] - marks[0][2]))


def stage_split(srv, img, answer) -> None:
    """One query's stages between CUDA events (:func:`_stage_ms`), then
    one traced query: the device's busy time is the union of its kernels'
    intervals."""
    import torch

    parts, wall = _stage_ms(srv, img, answer)
    print(f"[split] ms by stage (CUDA events): "
          f"{'; '.join(f'{name} {ms:.3f}' for name, ms in parts)}; "
          f"wall {wall:.3f}", flush=True)

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
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    print(_card(), flush=True)

    from revisit_anything_tpu_torch.kernels import build
    build.load()
    print(f"[build] kernels built in {build.last_build_seconds:.1f} s "
          f"({build.library_path()})", flush=True)

    ptxas_report()
    results = compare_kernels(dev)
    walk_phases()
    reference_check(dev)
    served = serve(dev)
    checkpoint_phase(dev)
    backbones = backbones_phase(dev)
    train_phase(dev)
    sharded_train_phase(dev)
    dryrun_phase()
    cli_phase(dev)

    # launches: the 3 "shared" queries for the kernels of that form, the
    # probability-factored queries for theirs, the window-kernel query for
    # B11, the 3 f32 queries for the f32 forms (K1 f32 without the bias in
    # their DINOv2-g), the f32 kernel-window query for B11 f32, the f32
    # "probs_split" query for B7 f32, B8 f32 and B6 f32, the f32
    # "fused_tail_keys", "fused_tail_logits" and "fused_tail_probs" queries
    # for B3 f32; B10
    # (token_cross_split, token_cross_split_f32) has no caller on a serving
    # path
    table = []
    for k in build.KERNELS:
        main_shape = results[k.name][0]
        launches = (served["counts"][k.name]
                    or sum(v["counts"][k.name]
                           for v in served["variants"].values())
                    or served["window"]["counts"][k.name]
                    or served["sam_f32"]["counts"].get(k.name, 0)
                    or served["sam_f32"]["window_counts"].get(k.name, 0)
                    or served["sam_f32"]["probs_query_counts"].get(k.name, 0)
                    or served["sam_f32"]["tail_keys_query_counts"].get(
                        k.name, 0)
                    or served["sam_f32"]["tail_logits_query_counts"].get(
                        k.name, 0)
                    or served["sam_f32"]["tail_probs_query_counts"].get(
                        k.name, 0)
                    or served["sam_f32"]["probs_counts"].get(k.name, 0)
                    or backbones["counts"][k.name])
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
    f = served["sam_f32"]
    print(f"[sam-f32] f32 query {statistics.median(f['wall_ms']):.1f} ms, "
          f"encode {f['encode_ms']:.3f} ms, decode {f['decode_ms']:.3f} ms, "
          f"peak {f['peak_gib']:.2f} GiB, launches over 3 queries "
          f"{f['counts']}; encode with plain windows "
          f"{f['encode_plain_windows_ms']:.3f} ms, kernel windows "
          f"{f['encode_kernel_windows_ms']:.3f} ms; probs_split transformer "
          f"{f['probs_split_ms']:.3f} ms, shared transformer "
          f"{f['shared_transformer_ms']:.3f} ms; probs_split query "
          f"{f['probs_query_ms']:.1f} ms, decode {f['probs_decode_ms']:.3f} "
          f"ms (shared {f['probs_shared_decode_ms']:.3f} ms); "
          f"fused_tail_keys query {f['tail_keys_query_ms']:.1f} ms, decode "
          f"{f['tail_keys_decode_ms']:.3f} ms (shared "
          f"{f['tail_keys_shared_decode_ms']:.3f} ms); fused_tail_logits "
          f"query {f['tail_logits_query_ms']:.1f} ms, decode "
          f"{f['tail_logits_decode_ms']:.3f} ms (shared "
          f"{f['tail_logits_shared_decode_ms']:.3f} ms); fused_tail_probs "
          f"query {f['tail_probs_query_ms']:.1f} ms, decode "
          f"{f['tail_probs_decode_ms']:.3f} ms (shared "
          f"{f['tail_probs_shared_decode_ms']:.3f} ms)", flush=True)
    from revisit_anything_tpu_torch.kernels.smoke_phases import report
    print(report(PHASE_SECONDS), flush=True)
    print(f"[phases] the whole run {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    from revisit_anything_tpu_torch.kernels.smoke_phases import (
        time_functions)
    time_functions(globals(), PHASE_SECONDS)
    main()
