"""The port's mesh paths on a mesh of 8 CPU entries against the JAX
package on conftest's 8-device CPU mesh and against the port's own
single-device paths (counterpart of ``tests/test_parallel.py``): the
sharded kNN, data-parallel forwards, the evaluator and the extractors
with a mesh, the row-sharded server, and the process helpers (one gloo
process group of two processes).

Tolerances: kNN distances rtol 1e-5 / atol 1e-4 (f32 dot products of
another summation order), index sets exactly; forwards split into
chunks atol 2e-6 (the JAX test's bound); retrieval answers, records and
server ids exactly."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from revisit_anything_tpu.parallel import make_mesh as jmake_mesh
from revisit_anything_tpu.parallel import sharded_knn_l2 as jsharded_knn
from revisit_anything_tpu_torch.models import dinov2 as pdn
from revisit_anything_tpu_torch.ops.knn import knn_l2
from revisit_anything_tpu_torch.parallel import (Mesh, batch_sharding,
                                                 data_parallel_apply,
                                                 host_shard, make_mesh,
                                                 pad_to_multiple,
                                                 process_info, replicated,
                                                 resolve_mesh, sharded_knn_l2)
from revisit_anything_tpu_torch.pipeline import serve as pserve
from revisit_anything_tpu_torch.weights import init_dino
from tests.test_torch_sam_tools import models  # noqa: F401 (fixture)

torch.set_float32_matmul_precision("highest")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU8 = [torch.device("cpu")] * 8
TINY_DINO = pdn.DinoV2Config(embed_dim=32, depth=2, num_heads=2, ffn="mlp",
                             pretrain_grid=(4, 4))


@pytest.fixture(scope="module")
def mesh():
    return make_mesh((8,), ("data",), devices=CPU8)


@pytest.fixture(scope="module")
def jmesh():
    assert len(jax.devices()) == 8, "conftest must force 8 CPU devices"
    return jmake_mesh((8,), ("data",))


def _same_neighbours(sq_a, idx_a, sq_b, idx_b):
    sq_a, sq_b = np.asarray(sq_a), np.asarray(sq_b)
    np.testing.assert_allclose(np.sort(sq_a, 1), np.sort(sq_b, 1),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(np.sort(np.asarray(idx_a), 1),
                                  np.sort(np.asarray(idx_b), 1))


@pytest.mark.parametrize("nq,nd,dim,k", [(23, 1000, 32, 17),   # even
                                         (5, 203, 16, 50),     # uneven
                                         (3, 20, 8, 10)])      # small
def test_sharded_knn_matches_jax_and_one_device(mesh, jmesh, nq, nd, dim, k):
    rng = np.random.default_rng(nd)
    q = rng.standard_normal((nq, dim)).astype(np.float32)
    db = rng.standard_normal((nd, dim)).astype(np.float32)
    sq, idx = sharded_knn_l2(q, db, k, mesh)
    assert sq.shape == idx.shape == (nq, min(k, nd))
    assert int(idx.max()) < nd                   # padding never returned
    # ascending, and the distances of the rows they name
    assert (np.diff(sq.numpy(), axis=1) >= 0).all()
    true = ((q[:, None, :] - db[idx.numpy()]) ** 2).sum(-1)
    np.testing.assert_allclose(true, sq.numpy(), rtol=1e-5, atol=1e-4)
    sq1, idx1 = knn_l2(torch.from_numpy(q), torch.from_numpy(db), k)
    _same_neighbours(sq, idx, sq1, idx1)
    jsq, jidx = jsharded_knn(q, db, k, jmesh)
    _same_neighbours(sq, idx, jsq, jidx)


def test_sharded_knn_tensors_and_tiles(mesh):
    """Tensor inputs, and tiles smaller than a shard: the same answer."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((4, 8)).astype(np.float32))
    db = torch.from_numpy(rng.standard_normal((1000, 8)).astype(np.float32))
    a = sharded_knn_l2(q, db, 9, mesh)
    b = sharded_knn_l2(q, db, 9, mesh, db_tile=32)
    assert torch.equal(a[1], b[1])
    torch.testing.assert_close(a[0], b[0], rtol=1e-5, atol=1e-4)


def _dino_forward(model, x):
    return pdn.extract_dense(model, model.cfg, x, 1, "value")


def test_data_parallel_apply_matches_single(mesh):
    model = init_dino(TINY_DINO, torch.Generator().manual_seed(0), "cpu",
                      torch.float32)
    imgs = np.random.default_rng(0).standard_normal(
        (11, 56, 56, 3)).astype(np.float32)              # pads to 16
    with torch.inference_mode():
        single = _dino_forward(model, torch.from_numpy(imgs))
        split = data_parallel_apply(_dino_forward, model,
                                    torch.from_numpy(imgs), mesh)
        host = data_parallel_apply(_dino_forward, model, imgs, mesh)
    assert split.shape == single.shape and isinstance(host, np.ndarray)
    torch.testing.assert_close(split, single, rtol=0, atol=2e-6)
    np.testing.assert_allclose(host, single.numpy(), rtol=0, atol=2e-6)


def test_replicas_are_made_once_and_follow_the_weights():
    """A module already on a device is its own replica; elsewhere a copy
    is made once per (module, device) and made again after a weight is
    written (the "meta" device: copies without compute)."""
    model = init_dino(TINY_DINO, torch.Generator().manual_seed(0), "cpu",
                      torch.float32)
    m = Mesh(np.array([torch.device("cpu"), torch.device("meta"),
                       torch.device("meta")], dtype=object), ("data",))
    assert m.replicate(model, "cpu") is model
    r1 = m.replicate(model, "meta")
    assert r1 is not model and r1.pos_embed.device.type == "meta"
    assert model.pos_embed.device.type == "cpu"
    assert m.replicate(model, "meta") is r1
    with torch.no_grad():
        model.pos_embed.add_(1.0)
    r2 = m.replicate(model, "meta")
    assert r2 is not r1 and r2.pos_embed.device.type == "meta"
    tree = {"w": torch.ones(3), "b": [torch.zeros(2)]}
    rt = m.replicate(tree, "meta")
    assert rt["w"].device.type == "meta" and rt["b"][0].device.type == "meta"


def test_mesh_helpers():
    m = make_mesh((4, 2), ("data", "model"), devices=CPU8)
    assert m.shape == {"data": 4, "model": 2} and m.size == 8
    assert len(m.axis_devices("data")) == 4
    assert len(m.axis_devices("model")) == 2
    with pytest.raises(ValueError):
        make_mesh((3,), devices=CPU8)
    x, pad = pad_to_multiple(np.ones((5, 2)), 4, value=7)
    assert x.shape == (8, 2) and pad == 3 and x[-1, 0] == 7
    t, pad = pad_to_multiple(torch.ones(8, 2), 4)
    assert t.shape == (8, 2) and pad == 0
    chunks = m.split(torch.arange(8), "data")
    assert [c.tolist() for c in chunks] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert [c.tolist() for c in batch_sharding(m)(torch.arange(8))] == [
        c.tolist() for c in chunks]
    t = torch.ones(3)
    assert all(r is t for r in replicated(m)(t)) and len(
        replicated(m)(t)) == 8
    # "auto" never moves a CPU caller's work, nor finds a card here
    assert resolve_mesh("auto", "cpu") is None
    assert resolve_mesh(None) is None and resolve_mesh(m) is m
    if not torch.cuda.is_available():
        assert resolve_mesh("auto") is None
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()


def test_segloc_retrieval_mesh_matches_single_device(mesh, jmesh):
    """The evaluator with its kNN sharded over 8 entries: the single-device
    recalls and predictions, and the JAX package's on its 8-device mesh."""
    from revisit_anything_tpu.pipeline.aggregate import SegmentBank as JBank
    from revisit_anything_tpu.pipeline.evaluate import (
        run_segloc_retrieval as jrun)
    from revisit_anything_tpu_torch.pipeline.aggregate import SegmentBank
    from revisit_anything_tpu_torch.pipeline.evaluate import (
        run_segloc_retrieval)

    rng = np.random.default_rng(0)
    n_db_img, n_q_img, segs, dim = 15, 6, 4, 32
    db_desc = rng.standard_normal((n_db_img * segs, dim)).astype(np.float32)
    db_desc /= np.linalg.norm(db_desc, axis=1, keepdims=True)
    targets = [(3 * i + 1) % n_db_img for i in range(n_q_img)]
    q_rows = np.concatenate([np.arange(t * segs, (t + 1) * segs)
                             for t in targets])
    q_desc = db_desc[q_rows] + 0.01 * rng.standard_normal(
        (n_q_img * segs, dim)).astype(np.float32)
    db_ids = np.repeat(np.arange(n_db_img), segs)
    q_ids = np.repeat(np.arange(n_q_img), segs)
    gt = [[t] for t in targets]

    single = run_segloc_retrieval(SegmentBank(db_desc, db_ids),
                                  SegmentBank(q_desc, q_ids), gt,
                                  device="cpu", mesh=None)
    sharded = run_segloc_retrieval(SegmentBank(db_desc, db_ids),
                                   SegmentBank(q_desc, q_ids), gt,
                                   device="cpu", mesh=mesh)
    jax_ = jrun(JBank(db_desc, db_ids), JBank(q_desc, q_ids), gt,
                mesh=jmesh)
    assert single.recalls == sharded.recalls == jax_.recalls
    assert single.recalls[0] == 1.0
    for a, b, c in zip(single.predictions, sharded.predictions,
                       jax_.predictions):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, np.asarray(c))
    np.testing.assert_array_equal(single.matches, sharded.matches)


def test_extract_dino_mesh_matches_single_device(mesh, tmp_path):
    from PIL import Image

    from revisit_anything_tpu_torch.io.h5io import (open_h5,
                                                    read_dino_features)
    from revisit_anything_tpu_torch.pipeline.extract import (
        extract_dino_features)

    model = init_dino(TINY_DINO, torch.Generator().manual_seed(0), "cpu",
                      torch.float32)
    rng = np.random.default_rng(0)
    paths, keys = [], []
    for i in range(5):
        p = str(tmp_path / f"im{i}.png")
        Image.fromarray(rng.integers(0, 255, (56, 56, 3),
                                     dtype=np.uint8)).save(p)
        paths.append(p)
        keys.append(f"im{i}.png")
    kw = dict(target_hw=(56, 56), layer=1, batch_size=3, progress=False)
    single, sharded = str(tmp_path / "single.h5"), str(tmp_path / "mesh.h5")
    extract_dino_features(paths, keys, single, model, mesh=None, **kw)
    extract_dino_features(paths, keys, sharded, model, mesh=mesh, **kw)
    with open_h5(single) as f1, open_h5(sharded) as f2:
        for k in keys:
            np.testing.assert_allclose(read_dino_features(f2, k),
                                       read_dino_features(f1, k),
                                       rtol=0, atol=2e-6)


def test_sam_encode_batch_over_a_mesh(models, mesh):  # noqa: F811
    """generate_masks_batch with the encoder batch split over the mesh:
    the records of the unsplit batch."""
    from revisit_anything_tpu_torch.models.sam import amg as pamg
    from tests.test_torch_sam_tools import _assert_records_equal, _image
    _, sam = models
    rng = np.random.default_rng(5)
    imgs = [_image(rng) for _ in range(3)]
    amg = pamg.AmgConfig(points_per_side=8, points_per_batch=64,
                         pred_iou_thresh=-1e9, stability_score_thresh=0.0)
    want = pamg.generate_masks_batch(sam, imgs, amg)
    got = pamg.generate_masks_batch(sam, imgs, amg, mesh=mesh)
    for g, w in zip(got, want):
        _assert_records_equal(g, w)


# ----- the row-sharded server -----

def _port_models():
    from tests.test_torch_serve_incremental import DINO_KW, SAM_KW
    from revisit_anything_tpu_torch.models.sam import SamArchConfig
    from revisit_anything_tpu_torch.weights import init_sam
    gen = torch.Generator().manual_seed(0)
    sam = init_sam(SamArchConfig(**SAM_KW), gen, "cpu", torch.float32)
    dino = init_dino(pdn.DinoV2Config(**DINO_KW), gen, "cpu", torch.float32)
    return sam, dino


@pytest.fixture(scope="module")
def servers(mesh):
    """build(index arrays, **kw) → (single-device server, row-sharded
    server over the 8 entries) on the same models."""
    from tests.test_torch_serve_incremental import AMG_KW, SERVE_KW
    from revisit_anything_tpu_torch.models.sam.amg import AmgConfig
    sam, dino = _port_models()

    def build(index, **kw):
        return tuple(pserve.SegVLADServer(
            sam=sam, dino=dino, index=pserve.ServingIndex(**index),
            amg=AmgConfig(**AMG_KW), mesh=m, **SERVE_KW, **kw)
            for m in (None, mesh))
    return build


@pytest.mark.parametrize("capacity", [None, 200 + 3 * 32 + 13])
def test_row_sharded_server_matches_one_device(servers, capacity, tmp_path):
    """Queries, then (with a capacity: shards of 39 rows, so inserts
    straddle shard edges) three inserts in one chunk, a removal and
    queries again: equal top-5 ids, equal snapshots."""
    from tests.test_torch_serve_incremental import _image, _index_arrays
    index = _index_arrays(1)
    single, sharded = servers(index, db_capacity=capacity)
    assert not single.sharded and sharded.sharded
    assert len(sharded._db_state) == 8
    rng = np.random.default_rng(3)
    imgs = [_image(rng) for _ in range(4)]
    for img in imgs:
        np.testing.assert_array_equal(sharded.query(img), single.query(img))
    if capacity is not None:
        assert single.add_reference_images(imgs[:3]) == \
            sharded.add_reference_images(imgs[:3]) == [20, 21, 22]
        for img in imgs:
            np.testing.assert_array_equal(sharded.query(img),
                                          single.query(img))
        single.remove_reference_image(21)
        sharded.remove_reference_image(21)
        assert 21 not in sharded.query(imgs[1])
        for img in imgs:
            np.testing.assert_array_equal(sharded.query(img),
                                          single.query(img))
    # the gathered state has the one-device server's contract: its
    # device, its rows (no shard padding), its values
    for name in ("_db", "_db_ids", "_db_norms"):
        one, split = getattr(single, name), getattr(sharded, name)
        assert split.device == one.device and split.shape == one.shape
        np.testing.assert_array_equal(split.numpy(), one.numpy())
    a = single.snapshot_index(str(tmp_path / "a.npz"))
    b = sharded.snapshot_index(str(tmp_path / "b.npz"))
    np.testing.assert_array_equal(a.db, b.db)
    np.testing.assert_array_equal(a.db_image_ids, b.db_image_ids)
    assert a.num_ref_images == b.num_ref_images
    za, zb = np.load(str(tmp_path / "a.npz")), np.load(str(tmp_path / "b.npz"))
    for key in za.files:
        np.testing.assert_array_equal(za[key], zb[key])


def test_shard_insert_writes_the_owning_shards():
    """A block written across shard edges lands where the one-device
    insert puts it; untouched shards are shared with the old state."""
    rng = np.random.default_rng(0)
    db = torch.from_numpy(rng.standard_normal((24, 4)).astype(np.float32))
    ids = torch.arange(24)
    shards = tuple((db[i:i + 6].clone(), ids[i:i + 6].clone(),
                    pserve.db_sq_norms(db[i:i + 6])) for i in range(0, 24, 6))
    rows = torch.from_numpy(rng.standard_normal((9, 4)).astype(np.float32))
    new_ids = torch.arange(100, 109)
    out = pserve._shard_insert(shards, 6, rows, new_ids, 5)
    want_db, want_ids = db.clone(), ids.clone()
    want_db[5:14], want_ids[5:14] = rows, new_ids
    assert torch.equal(torch.cat([s[0] for s in out]), want_db)
    assert torch.equal(torch.cat([s[1] for s in out]), want_ids)
    assert out[3] is shards[3]
    assert torch.equal(out[1][2], pserve.db_sq_norms(want_db[6:12]))


# ----- processes -----

def test_multihost_helpers_single_process():
    rank, world, local, total = process_info()
    assert rank == 0 and world == 1 and local == total >= 1
    s = host_shard(13)
    assert list(range(13))[s] == list(range(13))


_WORKER = """
import sys, torch, torch.distributed as dist
from revisit_anything_tpu_torch.parallel import (host_shard,
    initialize_multihost, process_info)
addr, rank = sys.argv[1], int(sys.argv[2])
assert initialize_multihost(addr, 2, rank)
assert not initialize_multihost(addr, 2, rank)
t = torch.tensor([rank + 1.0])
dist.all_reduce(t)
s = host_shard(13)
print(process_info()[:2], s.start, s.stop, float(t[0]), flush=True)
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_gloo_group_and_host_shards():
    """Two processes join one gloo group by TCP on localhost: ranks,
    world size, an all-reduce, and host_shard's contiguous halves (JAX
    ``distributed.py:63-71``: ⌈13/2⌉ = 7 items, then 6)."""
    addr = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, addr, str(r)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              env=env, cwd=REPO, text=True)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=60)
            assert p.returncode == 0, err
            outs.append(out.split())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert outs[0] == ["(0,", "2)", "0", "7", "3.0"]
    assert outs[1] == ["(1,", "2)", "7", "13", "3.0"]
