"""The port's multi-device dry run: six sharded paths over an n-device
mesh, each held to its one-device form.

Counterpart of ``__graft_entry__.py`` ``dryrun_multichip`` /
``_dryrun_body`` (:33-316), which the JAX package keeps:

1. the sharded VLAD-BuFF train step (``training.train.
   make_sharded_train_step``) on a (n/2, 2) mesh at the JAX run's sizes
   (embed 256, depth 4, 8 heads, MLP, 2 trainable blocks, 16 clusters,
   56x56 images, 4 a data rank): n processes, one a mesh position, over
   NCCL where each has a card of its own, over gloo otherwise; two AdamW
   steps, their losses against the one-device ``train_step``'s;
2. ``parallel.data_parallel_apply`` of a DINOv2 forward over a 1-d mesh
   against the whole batch;
3. ``parallel.sharded_knn_l2`` against ``ops.knn.knn_l2``;
4. the serving tail at production widths (128 segments of 32 x 1536
   VLAD, a whitened 1024-d PCA, top-200 kNN, Borda) on a row-sharded
   100,000 x 1,024 database against one device;
5. ``amg.generate_masks_batch`` with the mesh against none: on the CPU
   the JAX run's small SAM; on the card one whose shapes every SAM
   kernel takes (encoder head dim 80, prompt dim 256, 64 prompts a
   batch), so that it launches K1, K2, K5, K3 and K4;
6. two processes joining one group: an all-reduce across them and a
   row-sharded top-k against numpy.

A mesh lists n distinct cards where there are n, else the one device n
times (the card's machine has one H100). Any failed path raises; the
run ends with one ``dryrun_multichip ok: ...`` line.

    python -m revisit_anything_tpu_torch.dryrun 4 [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import List, Sequence

import numpy as np
import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_WORKER_TIMEOUT = 600.0


# ---------------------------------------------------------------------------
# Processes
# ---------------------------------------------------------------------------


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(code: str, argvs: Sequence[Sequence[str]],
              timeout: float = _WORKER_TIMEOUT) -> List[str]:
    """Start ``python -c code arg...`` once for each argument list, all at
    once, from the repository's root with the port importable, and wait
    for every one. Returns their standard outputs in order. On a timeout
    or a non-zero exit every process still running is killed and a
    ``RuntimeError`` carries the first failure's standard error."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_ROOT, env.get("PYTHONPATH")) if p)
    files, procs = [], []
    try:
        for argv in argvs:
            out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile(
                "w+")
            files.append((out, err))
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code, *map(str, argv)], cwd=_ROOT,
                env=env, stdout=out, stderr=err, text=True))
        deadline = time.monotonic() + timeout
        for i, p in enumerate(procs):
            try:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                raise RuntimeError(f"rank {i} did not finish in {timeout} s")
        results = []
        for p, (out, err) in zip(procs, files):
            out.seek(0)
            err.seek(0)
            results.append((p.returncode, out.read(), err.read()))
        for i, (rc, _, err) in enumerate(results):
            if rc != 0:
                raise RuntimeError(f"rank {i} exited {rc}:\n{err[-3000:]}")
        return [out for _, out, _ in results]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for out, err in files:
            out.close()
            err.close()


def rank_devices(n: int, device) -> List[torch.device]:
    """n devices for a mesh: n distinct cards where ``device`` is CUDA and
    there are n, else ``device`` n times."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device (pass device='cpu')")
        if torch.cuda.device_count() >= n:
            return [torch.device("cuda", i) for i in range(n)]
        device = torch.device("cuda", device.index or 0)
    return [device] * n


def backend_for(devices: Sequence[torch.device]) -> str:
    """NCCL where every process has a card of its own, gloo otherwise
    (NCCL refuses two ranks on one card; gloo stages CUDA tensors through
    the host)."""
    cards = [d.index for d in devices if d.type == "cuda"]
    if len(cards) == len(devices) and len(set(cards)) == len(cards):
        return "nccl"
    return "gloo"


def init_rank(addr: str, backend: str, world: int, rank: int,
              device: str) -> torch.device:
    """Join the group (``addr`` "tcp://host:port") and make ``device`` the
    process's current card; true f32 products (TF32 off)."""
    import torch.distributed as dist
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group(backend, init_method=addr, world_size=world,
                            rank=rank)
    return dev


# ---------------------------------------------------------------------------
# 1. The sharded train step
# ---------------------------------------------------------------------------


def _train_cfg():
    from revisit_anything_tpu_torch.models import dinov2 as dn
    from revisit_anything_tpu_torch.training.train import VPRTrainConfig
    return VPRTrainConfig(
        backbone=dn.DinoV2Config(embed_dim=256, depth=4, num_heads=8,
                                 ffn="mlp", pretrain_grid=(4, 4)),
        num_trainable_blocks=2, clusters=16)


def _train_batch(dp: int):
    rng = np.random.default_rng(0)
    batch = dp * 4                       # 4 images a data rank
    images = rng.standard_normal((batch, 56, 56, 3)).astype(np.float32)
    return images, np.repeat(np.arange(batch // 4), 4)


_STEPS = 2


def _train_worker(argv: Sequence[str]) -> None:
    """One rank of path 1: prints the losses as JSON (rank 0)."""
    import torch.distributed as dist

    from revisit_anything_tpu_torch.parallel import make_mesh
    from revisit_anything_tpu_torch.training import train as tr
    addr, backend, dp, tp, rank = argv[0], argv[1], *map(int, argv[2:5])
    devices = argv[5:]
    dev = init_rank(addr, backend, dp * tp, rank, devices[rank])
    cfg = _train_cfg()
    state = tr.create_train_state(cfg, seed=0, device=dev)
    mesh = make_mesh((dp, tp), ("data", "model"), devices=devices)
    step_fn, sharded = tr.make_sharded_train_step(mesh, cfg, state)
    del state
    images, labels = _train_batch(dp)
    losses = [step_fn(sharded, images, labels).item()
              for _ in range(_STEPS)]
    if rank == 0:
        print(json.dumps({"losses": losses}), flush=True)
    dist.destroy_process_group()


def _sharded_train(devices: List[torch.device]) -> dict:
    from revisit_anything_tpu_torch.ops.knn import f32_products
    from revisit_anything_tpu_torch.training import train as tr
    n = len(devices)
    tp = 2 if n % 2 == 0 else 1
    dp = n // tp
    backend = backend_for(devices)
    addr = f"tcp://127.0.0.1:{free_port()}"
    names = [str(d) for d in devices]
    t0 = time.perf_counter()
    outs = run_ranks("import sys; from revisit_anything_tpu_torch.dryrun "
                     "import _train_worker; _train_worker(sys.argv[1:])",
                     [[addr, backend, dp, tp, r, *names] for r in range(n)])
    secs = time.perf_counter() - t0
    losses = json.loads(outs[0].strip().splitlines()[-1])["losses"]
    cfg = _train_cfg()
    images, labels = _train_batch(dp)
    with f32_products():
        state = tr.create_train_state(cfg, seed=0, device=devices[0])
        want = [tr.train_step(state, cfg, torch.from_numpy(images),
                              torch.from_numpy(labels)).item()
                for _ in range(_STEPS)]
    if not (np.all(np.isfinite(losses)) and np.allclose(
            losses, want, rtol=1e-4, atol=0.0)):
        raise RuntimeError(f"sharded train step: losses {losses}, one "
                           f"device {want}")
    return dict(mesh=(dp, tp), backend=backend, losses=losses,
                one_device=want, seconds=secs)


# ---------------------------------------------------------------------------
# 2-5. One process over a mesh
# ---------------------------------------------------------------------------


def _data_parallel(mesh, dev) -> tuple:
    from revisit_anything_tpu_torch.models import dinov2 as dn
    from revisit_anything_tpu_torch.ops.knn import f32_products
    from revisit_anything_tpu_torch.parallel import data_parallel_apply
    from revisit_anything_tpu_torch.weights import init_dino
    cfg = dn.DinoV2Config(embed_dim=32, depth=2, num_heads=2, ffn="mlp",
                          pretrain_grid=(4, 4))
    gen = torch.Generator(device=dev).manual_seed(1)
    model = init_dino(cfg, gen, dev, torch.float32)
    rng = np.random.default_rng(1)
    imgs = rng.standard_normal((mesh.size * 2, 28, 28, 3)).astype(np.float32)

    def fwd(m, x):
        return dn.extract_dense(m, cfg, x, layer=1, facet="value")

    with torch.no_grad(), f32_products():
        feats = data_parallel_apply(fwd, model, imgs, mesh)
        whole = fwd(model, torch.from_numpy(imgs).to(dev)).cpu().numpy()
    err = float(np.abs(feats - whole).max() / np.abs(whole).max())
    if feats.shape != whole.shape or not np.isfinite(feats).all() or \
            err > 1e-5:
        raise RuntimeError(f"data_parallel_apply: shape {feats.shape}, "
                           f"rel_err {err}")
    return feats.shape, err


def _sharded_knn(mesh, dev) -> None:
    from revisit_anything_tpu_torch.ops.knn import knn_l2
    from revisit_anything_tpu_torch.parallel import sharded_knn_l2
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((7, 16)).astype(np.float32))
    db = torch.from_numpy(rng.standard_normal((103, 16)).astype(np.float32))
    _, i_s = sharded_knn_l2(q, db, k=5, mesh=mesh)
    _, i_1 = knn_l2(q.to(dev), db.to(dev), k=5)
    if not torch.equal(i_s.cpu(), i_1.cpu()):
        raise RuntimeError("sharded kNN != single-device")


SERVE_DIMS = dict(n_seg=128, patches=1530, dim=1536, clusters=32,
                  pca_dim=1024, n_db=100_000, segs_per_img=50)


def _serving_tail(mesh, dev) -> None:
    """Production widths (JAX :222-265): 128 masks x (32 clusters x 1536)
    VLAD → 1024-d whitened PCA → top-200 kNN over 100,000 rows → Borda."""
    from revisit_anything_tpu_torch.pipeline.query import (
        db_sq_norms, query_topk_images, query_topk_images_sharded)
    s = SERVE_DIMS
    rng = np.random.default_rng(4)

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    desc = rng.standard_normal((s["patches"], s["dim"])).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    pm = t(rng.random((s["n_seg"], s["patches"])) < 0.1, torch.bool)
    adj = t(np.eye(s["n_seg"], dtype=bool), torch.bool)
    centers = t(rng.standard_normal((s["clusters"], s["dim"])))
    width = s["clusters"] * s["dim"]
    pmean = torch.zeros(width, device=dev)
    pcomp = t(rng.standard_normal((s["pca_dim"], width), np.float32) * 0.01)
    pvar = torch.ones(s["pca_dim"], device=dev)
    db = rng.standard_normal((s["n_db"], s["pca_dim"]), np.float32)
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    n_img = s["n_db"] // s["segs_per_img"]
    ids = np.repeat(np.arange(n_img), s["segs_per_img"])
    kw = dict(num_ref_images=n_img, knn_topk=200, borda_topk=50,
              top_images=5, whiten=True)
    args = (t(desc), pm, adj, centers, pmean, pcomp, pvar)
    with torch.no_grad():
        top_one = query_topk_images(*args, t(db), t(ids, torch.long), **kw)
        devs = mesh.axis_devices("data")
        rows = -(-s["n_db"] // len(devs))
        shards = []
        for i, d in enumerate(devs):
            part = torch.from_numpy(db[i * rows:(i + 1) * rows]).to(d)
            shards.append((part, torch.from_numpy(
                ids[i * rows:(i + 1) * rows]).to(d), db_sq_norms(part)))
        top_sh = query_topk_images_sharded(*args, shards,
                                           num_rows=s["n_db"], **kw)
    if not torch.equal(top_one.cpu(), top_sh.cpu()):
        raise RuntimeError(f"sharded serving tail {top_sh.tolist()} != "
                           f"single-device {top_one.tolist()}")


def _extraction(mesh, dev) -> tuple:
    """generate_masks_batch over the mesh against none: the same masks
    (equal counts, each mask at IoU >= 0.9 with its counterpart, its
    predicted IoU within 2e-2: a split encoder batch may round a
    near-threshold pixel otherwise on the card). Returns (images, masks,
    launches by kernel, bit-identical)."""
    from revisit_anything_tpu_torch.kernels import build
    from revisit_anything_tpu_torch.models.sam import SamArchConfig
    from revisit_anything_tpu_torch.models.sam.amg import (
        AmgConfig, generate_masks_batch)
    from revisit_anything_tpu_torch.weights import (init_sam,
                                                    plant_point_segmenter)
    gen = torch.Generator(device=dev).manual_seed(2)
    rng = np.random.default_rng(2)
    if dev.type == "cuda":
        cfg = SamArchConfig(encoder_dim=320, encoder_depth=2,
                            encoder_heads=4, global_attn_indexes=(1,),
                            image_size=256, window_size=8,
                            decoder_mlp_dim=512, iou_head_hidden=64)
        sam = init_sam(cfg, gen, dev, torch.bfloat16)
        plant_point_segmenter(sam, gen)
        amg = AmgConfig(points_per_side=8, points_per_batch=64,
                        pred_iou_thresh=-1e9, stability_score_thresh=0.0)
        hw = (224, 224)
    else:
        cfg = SamArchConfig(encoder_dim=64, encoder_depth=2, encoder_heads=4,
                            global_attn_indexes=(1,), image_size=128,
                            patch_size=16, window_size=4, prompt_dim=32,
                            decoder_heads=4, decoder_mlp_dim=128,
                            iou_head_hidden=32)
        sam = init_sam(cfg, gen, dev, torch.float32)
        amg = AmgConfig(points_per_side=4, points_per_batch=16,
                        pred_iou_thresh=-1e9, stability_score_thresh=0.0)
        hw = (56, 56)
    imgs = [rng.integers(0, 255, (*hw, 3)).astype(np.uint8)
            for _ in range(mesh.size * 2)]
    before = {k.name: k.launches for k in build.KERNELS}
    recs_dp = generate_masks_batch(sam, imgs, amg, max_masks=32, mesh=mesh)
    launches = {k.name: k.launches - before[k.name] for k in build.KERNELS
                if k.launches > before[k.name]}
    recs_1d = generate_masks_batch(sam, imgs, amg, max_masks=32, mesh=None)
    identical = True
    for rd, r1 in zip(recs_dp, recs_1d):
        if len(rd) != len(r1):
            raise RuntimeError(f"mesh extraction kept {len(rd)} masks, one "
                               f"device {len(r1)}")
        for a, b in zip(rd, r1):
            inter = np.logical_and(a.segmentation, b.segmentation).sum()
            union = np.logical_or(a.segmentation, b.segmentation).sum()
            if inter < 0.9 * union or abs(a.predicted_iou -
                                          b.predicted_iou) > 2e-2:
                raise RuntimeError("mesh extraction masks != single-device")
            identical &= bool(np.array_equal(a.segmentation, b.segmentation)
                              and a.predicted_iou == b.predicted_iou)
    if dev.type == "cuda":
        missing = [k.name for k in (build.FLASH_ATTENTION, build.TOKEN_CROSS,
                                    build.I2T_UPDATE, build.MASK_HEAD,
                                    build.RESIZE_FLAGS)
                   if k.name not in launches]
        if missing:
            raise RuntimeError(f"mesh extraction launched no {missing}")
    return len(imgs), sum(len(r) for r in recs_dp), launches, identical


# ---------------------------------------------------------------------------
# 6. Two processes
# ---------------------------------------------------------------------------


def _multihost_worker(argv: Sequence[str]) -> None:
    """One of path 6's processes: an all-reduce of ones, then this
    process's half of a database's rows, its top-k, the candidates
    gathered and merged, against numpy's answer."""
    import torch.distributed as dist

    from revisit_anything_tpu_torch.parallel import merge_candidates
    addr, backend, world, rank = argv[0], argv[1], int(argv[2]), int(argv[3])
    dev = init_rank(addr, backend, world, rank, argv[4 + rank])
    ones = torch.ones(1, device=dev)
    dist.all_reduce(ones)
    if float(ones) != world:
        raise RuntimeError(f"all-reduce of ones gave {float(ones)}")
    rows, dim, k = world * 32, 8, 5
    rng = np.random.default_rng(0)
    db = rng.standard_normal((rows, dim)).astype(np.float32)
    q = rng.standard_normal((4, dim)).astype(np.float32)
    per = rows // world
    mine = torch.from_numpy(db[rank * per:(rank + 1) * per]).to(dev)
    vals, idx = torch.topk(torch.from_numpy(q).to(dev) @ mine.T, k)
    parts_v = [torch.empty_like(vals) for _ in range(world)]
    parts_i = [torch.empty_like(idx) for _ in range(world)]
    dist.all_gather(parts_v, vals)
    dist.all_gather(parts_i, idx + rank * per)
    _, top = merge_candidates(parts_v, parts_i, k, dev)
    want = np.argsort(-(q @ db.T), axis=1, kind="stable")[:, :k]
    if not np.array_equal(top.cpu().numpy(), want):
        raise RuntimeError("sharded top-k != numpy")
    print(f"mh ok p{rank}/{world}", flush=True)
    dist.destroy_process_group()


def _multihost(devices: List[torch.device]) -> str:
    two = (devices * 2)[:2]
    backend = backend_for(two)
    addr = f"tcp://127.0.0.1:{free_port()}"
    outs = run_ranks("import sys; from revisit_anything_tpu_torch.dryrun "
                     "import _multihost_worker; "
                     "_multihost_worker(sys.argv[1:])",
                     [[addr, backend, 2, r, *map(str, two)]
                      for r in range(2)])
    if not all("mh ok" in o for o in outs):
        raise RuntimeError(f"multihost: {outs}")
    return f"ok(2 processes, {backend})"


# ---------------------------------------------------------------------------


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """The six paths over an ``n_devices`` mesh on ``device`` (see the
    module's docstring); raises if one fails, prints the ok line and
    returns each path's figures."""
    from revisit_anything_tpu_torch.parallel import make_mesh
    devices = rank_devices(n_devices, device)
    dev = devices[0]
    train = _sharded_train(devices)
    mesh = make_mesh(devices=devices)
    feats_shape, dp_err = _data_parallel(mesh, dev)
    _sharded_knn(mesh, dev)
    _serving_tail(mesh, dev)
    n_img, n_masks, launches, identical = _extraction(mesh, dev)
    mh = _multihost(devices)
    s = SERVE_DIMS
    dp, tp = train["mesh"]
    print(f"dryrun_multichip ok: mesh=({dp}x{tp}) backend={train['backend']}"
          f" loss={train['losses'][0]:.4f} "
          f"(one device {train['one_device'][0]:.4f}) "
          f"dp_infer={tuple(feats_shape)} knn_match=True "
          f"serve_tail_match=True serve_tail_dims=({s['n_seg']}x"
          f"{s['clusters'] * s['dim']}->{s['pca_dim']},db={s['n_db']}x"
          f"{s['pca_dim']}) extract_dp=ok({n_img}imgs,{n_masks}masks,"
          f"identical={identical}) multihost={mh}", flush=True)
    return dict(train=train, dp_rel_err=dp_err, extract_masks=n_masks,
                extract_launches=launches, extract_identical=identical,
                multihost=mh)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n_devices", type=int)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n_devices, args.device)


if __name__ == "__main__":
    main()
