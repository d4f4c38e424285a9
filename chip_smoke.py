"""Smoke run of the PyTorch/CUDA port on one GPU: build the kernels, hold
each against its plain PyTorch version at the serving path's shapes, then
serve three full-width SegVLAD queries through the kernels.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the five kernels from revisit_anything_tpu_torch/kernels/csrc;
  3. compare every kernel with its plain version in bf16 at the main
     path's shapes, timing both with CUDA events (median of 7 after
     warm-up);
  4. serve a small input through the kernels on the card and through
     the plain versions on the CPU, from the same weights: the answers
     must agree;
  5. build a SegVLADServer at full width (SAM ViT-H, DINOv2 ViT-g/14 in
     bf16, random weights from a seed, SAM's made to segment a blob
     around each point prompt so AMG keeps many segments; 480x640
     queries, SAM at 240x320, 1024-prompt AMG, a 100k-segment /
     2000-image index made on the card) and plant two images' own
     segment rows in the index; each must keep at least 32 segments;
  6. answer 3 queries with every launch counter reset first; every kernel
     must have launched, each planted image must come back first for a
     noisy copy of itself, and answers must be deterministic;
  7. time one query's stages with CUDA events (the split must give
     query()'s answer) and trace one query with torch.profiler for the
     device's busy time;
  8. print the kernel table as one JSON line, then the result line.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time


def _fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def _time_ms(fn, reps: int = 7, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _rel(a, b) -> tuple:
    d = (a.float() - b.float()).abs().max().item()
    return d, d / max(b.float().abs().max().item(), 1e-6)


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

    def check(kernel, label, fn_k, fn_p, err_fn, tol):
        out_k, out_p = fn_k(), fn_p()
        torch.cuda.synchronize()
        abs_err, rel_err = err_fn(out_k, out_p)
        ms, plain_ms = _time_ms(fn_k), _time_ms(fn_p)
        del out_k, out_p
        torch.cuda.empty_cache()
        print(f"[kernel] {kernel.name:22s} {label:44s} max_abs_err="
              f"{abs_err:.3e} rel_err={rel_err:.3e} (tol {tol:g}) "
              f"kernel {ms:.3f} ms  plain {plain_ms:.3f} ms", flush=True)
        if not rel_err <= tol or not math.isfinite(abs_err):
            _fail(f"{kernel.name} {label}: error {rel_err} above {tol}")
        results.setdefault(kernel.name, []).append(dict(
            label=label, max_abs_err=abs_err, rel_err=rel_err, ms=ms,
            plain_ms=plain_ms))

    # K1: SAM ViT-H global layer and DINOv2-g block shapes
    q, k, v = (rnd(1, 16, 4096, 80) for _ in range(3))
    bh, bw = rnd(1, 16, 4096, 64), rnd(1, 16, 4096, 64)
    check(build.FLASH_ATTENTION, "SAM global q/k/v [1,16,4096,80] + bias",
          lambda: att.attend(q, k, v, bh, bw, side=64),
          lambda: att.attend_reference(q, k, v, bh, bw, side=64),
          _rel, rel_tol)
    q, k, v = (rnd(1, 24, 1531, 64) for _ in range(3))
    check(build.FLASH_ATTENTION, "DINOv2-g q/k/v [1,24,1531,64]",
          lambda: att.attend(q, k, v), lambda: att.attend_reference(q, k, v),
          _rel, rel_tol)
    del q, k, v, bh, bw

    # K2: layer-1 shared k|v and per-prompt k|v, 1024 prompts
    qt = rnd(1024, 7, 128)
    pe, vb = rnd(1, 128, 4096), rnd(128)
    for lead, label in ((1, "q [1024,7,128] kvt [1,256,4096] shared"),
                        (1024, "q [1024,7,128] kvt [1024,256,4096]")):
        kvt = rnd(lead, 256, 4096)
        check(build.TOKEN_CROSS, label,
              lambda: att.token_cross_attend_kv(qt, kvt, pe, vb, 8),
              lambda: att.token_cross_attend_kv_reference(qt, kvt, pe, vb,
                                                          8),
              _rel, rel_tol)
        del kvt
    del qt, pe, vb

    # K5: layer 1 (shared branch) and layer 2 (per-prompt), 1024 prompts
    def pair_err(out_k, out_p):
        errs = [_rel(a, b) for a, b in zip(out_k, out_p)]
        return max(e[0] for e in errs), max(e[1] for e in errs)

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
              pair_err, rel_tol)
        del iargs

    # K3: 1024 prompts, content 49 rows x 64 = 3136 positions
    margs = (rnd(1024, 4096, 256), rnd(1024, 3, 32, s=0.5),
             rnd(256, 256, s=0.1), rnd(64, s=0.1), rnd(64, s=0.1, off=1.0),
             rnd(64, s=0.1), rnd(64, 128, s=0.1), rnd(32, s=0.1))
    check(build.MASK_HEAD, "keys [1024,4096,256] -> [1024,3136,16,3]",
          lambda: mh.fused_mask_head(*margs, eps=1e-6, content=3136),
          lambda: mh.upscale_masks_blocks(margs[0][:, :3136], *margs[1:],
                                          eps=1e-6),
          _rel, rel_tol)
    del margs

    # K4: the 17places mask resize (input 768x1024 -> 240x320, gh = 49)
    wh, ww, gh = resize_mats_and_rows(SAM_VIT_H, (768, 1024), (240, 320))
    whd, wwd = torch.from_numpy(wh).to(dev), torch.from_numpy(ww).to(dev)
    logits = rnd(1024, gh * 64, 16, 3, s=4.0)

    def flags_err(out_k, flags_p):
        flags, rowst, colany = out_k
        own_rowst, own_colany = mr.flag_stats(flags)
        if not (torch.equal(rowst, own_rowst)
                and torch.equal(colany, own_colany)):
            _fail("resize_flags: stats differ from its own flags")
        mism = (flags != flags_p).float().mean().item()
        return mism, mism

    check(build.RESIZE_FLAGS, "logits [1024,3136,16,3] -> flags [1024,3,240,320]",
          lambda: mr.fused_resize_flags(logits, whd, wwd, 0.0, 1.0, (gh, 64)),
          lambda: mr.resize_flags_reference(logits, whd, wwd, 0.0, 1.0,
                                            (gh, 64)),
          flags_err, flag_tol)
    del logits
    torch.cuda.empty_cache()
    return results


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
    """Full-width server, planted index, 3 counted queries."""
    import numpy as np
    import torch

    from revisit_anything_tpu_torch.config import (DINO_G_DIM, NUM_CLUSTERS,
                                                   PCA_DIM, PLACES17_HW,
                                                   PLACES17_SAM_HW)
    from revisit_anything_tpu_torch.kernels import build
    from revisit_anything_tpu_torch.models.dinov2 import VIT_G14
    from revisit_anything_tpu_torch.models.sam import SAM_VIT_H
    from revisit_anything_tpu_torch.models.sam.amg import AmgConfig
    from revisit_anything_tpu_torch.pipeline.query import query_segment_rows
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

    def index(rows):
        return ServingIndex(
            centers=torch.randn((NUM_CLUSTERS, DINO_G_DIM), generator=gen_c,
                                device=dev),
            pca_mean=torch.zeros(NUM_CLUSTERS * DINO_G_DIM, device=dev),
            pca_components=pca, pca_variance=torch.ones(PCA_DIM, device=dev),
            pca_whiten=True, db=rows, db_image_ids=ids,
            num_ref_images=n_db // per_image, order=3)

    pca = torch.randn((PCA_DIM, NUM_CLUSTERS * DINO_G_DIM), generator=gen,
                      device=dev) * 0.01
    amg = AmgConfig(points_per_batch=1024, pred_iou_thresh=-1e9,
                    stability_score_thresh=0.0)
    kw = dict(sam=sam, dino=dino, full_hw=PLACES17_HW,
              sam_hw=PLACES17_SAM_HW, amg=amg, max_masks=128)
    gen_c = torch.Generator(device=dev).manual_seed(seed + 1)
    srv = SegVLADServer(index=index(db), **kw)
    torch.cuda.synchronize()
    print(f"[serve] models + index ready in {time.perf_counter() - t0:.1f} s",
          flush=True)

    # plant images A and B (their own segment rows) as database images 0, 1
    rng = np.random.default_rng(seed)
    planted = [_image(rng, PLACES17_HW) for _ in range(2)]
    row = 0
    for iid, img in enumerate(planted):
        with torch.inference_mode():
            pm, stats, desc = srv._front(torch.from_numpy(img).to(dev))
            adj, n_kept = srv._adjacency(stats.cpu().numpy())
            rows, valid = query_segment_rows(
                desc, pm, torch.from_numpy(adj).to(dev), srv._centers,
                srv._pca_mean, srv._pca_comps, srv._pca_var)
            n_plant = min(int(valid.sum()), per_image)
            db[row:row + n_plant] = rows[valid][:n_plant]
            ids[row:row + n_plant] = iid
        row += per_image
        print(f"[serve] planted image {iid}: {n_kept} masks kept, "
              f"{int(valid.sum())} valid segment rows, {n_plant} planted",
              flush=True)
        # the planted segmenter keeps ~128 segments a 17places image
        if n_kept < 32 or n_plant == 0:
            _fail(f"the served AMG kept {n_kept} masks for a planted image "
                  "(expected at least 32)")
    gen_c.manual_seed(seed + 1)
    srv = SegVLADServer(index=index(db), **kw)

    queries = [np.clip(img.astype(np.int16) + rng.integers(-4, 5, img.shape),
                       0, 255).astype(np.uint8) for img in planted]
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
        if top.shape != (5,) or not ((top >= -1) & (top < n_db // per_image)
                                     ).all():
            _fail(f"malformed answer {top}")
    for iid in range(2):
        if answers[iid][0] != iid:
            _fail(f"noisy copy of planted image {iid} answered "
                  f"{answers[iid]}")
    again = srv.query(queries[2])
    if not np.array_equal(again, answers[2]):
        _fail(f"query not deterministic: {answers[2]} vs {again}")
    missing = [name for name, n in counts.items() if n == 0]
    if missing:
        _fail(f"kernels not launched on the served path: {missing}")
    stage_split(srv, queries[2], answers[2])
    return dict(counts=counts, wall_ms=wall, peak_gib=peak_gib)


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
    print(f"[trace] one traced query: {len(spans)} device events, device "
          f"busy {busy / 1e3:.3f} ms (union of intervals; their plain sum "
          f"{total / 1e3:.3f} ms) of {traced_ms:.3f} ms traced wall",
          flush=True)


def reference_check(dev, seed: int = 7) -> None:
    """The served path on a small input, through the kernels on the card
    and through the plain versions on the CPU, from the same bf16
    weights and index: the same masks survive, the descriptors agree and
    the answers match. The small models keep every kernel's production
    widths (SAM head dim 80, prompt dim 256, decoder head dim 16; DINO
    head dim 64 over 1025 tokens)."""
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
    kw = dict(index=index, full_hw=(448, 448), sam_hw=(224, 224),
              amg=AmgConfig(points_per_side=8, points_per_batch=64,
                            pred_iou_thresh=-1e9, stability_score_thresh=0.0),
              dino_layer=2, max_masks=32)
    cpu_srv = SegVLADServer(sam=sam, dino=dino, **kw)
    gpu_srv = SegVLADServer(sam=copy.deepcopy(sam).to(dev),
                            dino=copy.deepcopy(dino).to(dev), **kw)
    for q in range(2):
        img = _image(rng, (448, 448))
        with torch.inference_mode():
            pm_c, st_c, de_c = cpu_srv._front(torch.from_numpy(img))
            pm_g, st_g, de_g = (x.cpu() for x in gpu_srv._front(
                torch.from_numpy(img).to(dev)))
        n_c, n_g = int(st_c[-1]), int(st_g[-1])
        agree = (pm_c == pm_g).float().mean().item()
        de_abs, de_rel = _rel(de_g, de_c)
        top_c, top_g = cpu_srv.query(img), gpu_srv.query(img)
        print(f"[reference] small input {q}: masks kept card {n_g} / cpu "
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

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)

    from revisit_anything_tpu_torch.kernels import build
    build.load()
    print(f"[build] kernels built in {build.last_build_seconds:.1f} s "
          f"({build.library_path()})", flush=True)

    results = compare_kernels(dev)
    reference_check(dev)
    served = serve(dev)

    table = []
    for k in build.KERNELS:
        main_shape = results[k.name][0]
        table.append(dict(
            name=k.name, route="cuda", source=k.source, replaces=k.replaces,
            launches=served["counts"][k.name],
            max_abs_err=max(r["max_abs_err"] for r in results[k.name]),
            ms=main_shape["ms"], plain_ms=main_shape["plain_ms"],
            shapes=results[k.name]))
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
