"""Port parity of the live database: inserts, removals, snapshots and
pipelined queries of the port's ``SegVLADServer`` against the JAX server
(``mesh=None``) on the same converted weights and index, and the
database updates against the JAX ones bit for bit (counterparts of
``tests/test_serve.py``:284-629)."""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from revisit_anything_tpu.models import dinov2 as jdn
from revisit_anything_tpu.models.sam import SamArchConfig, init_sam_params
from revisit_anything_tpu.models.sam.amg import AmgConfig as JAmg
from revisit_anything_tpu.pipeline import serve as jserve
from revisit_anything_tpu_torch.models import dinov2 as pdn
from revisit_anything_tpu_torch.models.sam import SamArchConfig as PSamCfg
from revisit_anything_tpu_torch.models.sam.amg import AmgConfig as PAmg
from revisit_anything_tpu_torch.pipeline import serve as pserve
from revisit_anything_tpu_torch.pipeline.query import DB_GUARD
from revisit_anything_tpu_torch.weights import (dino_from_jax_params,
                                                sam_from_jax_params)

torch.set_float32_matmul_precision("highest")

SAM_KW = dict(encoder_dim=64, encoder_depth=2, encoder_heads=4,
              global_attn_indexes=(1,), image_size=128, patch_size=16,
              window_size=4, prompt_dim=32, decoder_heads=4,
              decoder_mlp_dim=128, iou_head_hidden=32)
DINO_KW = dict(embed_dim=64, depth=2, num_heads=4, ffn="mlp",
               pretrain_grid=(8, 8))
H, W = 112, 112
KMAX = 32
AMG_KW = dict(points_per_side=6, points_per_batch=36, pred_iou_thresh=-1e9,
              stability_score_thresh=0.0)
SERVE_KW = dict(full_hw=(H, W), sam_hw=(H // 2, W // 2), dino_layer=1,
                max_masks=KMAX, top_images=5)


def _image(rng):
    img = rng.integers(60, 200, (H, W, 3), dtype=np.uint8)
    yy, xx = np.ogrid[:H, :W]
    for _ in range(4):
        cy, cx = rng.integers(10, H - 10), rng.integers(10, W - 10)
        r = rng.integers(6, 20)
        img[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = rng.integers(0, 255, 3)
    return img


def _index_arrays(seed, n_segs=200, n_images=20, clusters=8, pca_dim=16):
    rng = np.random.default_rng(seed)
    db = rng.standard_normal((n_segs, pca_dim)).astype(np.float32)
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    dim = DINO_KW["embed_dim"]
    return dict(
        centers=rng.standard_normal((clusters, dim)).astype(np.float32),
        pca_mean=np.zeros((clusters * dim,), np.float32),
        pca_components=(rng.standard_normal((pca_dim, clusters * dim))
                        * 0.1).astype(np.float32),
        pca_variance=np.ones((pca_dim,), np.float32), pca_whiten=True,
        db=db, db_image_ids=np.repeat(np.arange(n_images),
                                      n_segs // n_images),
        num_ref_images=n_images, order=3)


@pytest.fixture(scope="module")
def make():
    """make(index arrays, **server kwargs) → (JAX server, port server)
    on the same perturbed random weights."""
    rng = np.random.default_rng(0)

    def perturbed(tree):
        return jax.tree_util.tree_map(
            lambda x: (np.asarray(x) + 0.1 * rng.standard_normal(x.shape)
                       ).astype(np.float32), tree)

    sam_tree = perturbed(init_sam_params(SamArchConfig(**SAM_KW),
                                         jax.random.PRNGKey(0)))
    dino_tree = perturbed(jdn.init_params(jdn.DinoV2Config(**DINO_KW),
                                          jax.random.PRNGKey(1)))
    jsam = jax.tree_util.tree_map(jnp.asarray, sam_tree)
    jdino = jax.tree_util.tree_map(jnp.asarray, dino_tree)
    psam = sam_from_jax_params(sam_tree, PSamCfg(**SAM_KW), device="cpu")
    pdino = dino_from_jax_params(dino_tree, pdn.DinoV2Config(**DINO_KW),
                                 device="cpu")

    def build(index, port_only=False, **kw):
        p = pserve.SegVLADServer(sam=psam, dino=pdino,
                                 index=pserve.ServingIndex(**index),
                                 amg=PAmg(**AMG_KW), **SERVE_KW, **kw)
        if port_only:
            return p
        j = jserve.SegVLADServer(
            sam_params=jsam, sam_cfg=SamArchConfig(**SAM_KW),
            dino_params=jdino, dino_cfg=jdn.DinoV2Config(**DINO_KW),
            index=jserve.ServingIndex(**index), amg=JAmg(**AMG_KW),
            mesh=None, **SERVE_KW, **kw)
        return j, p

    return build


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(42)
    return [_image(rng) for _ in range(8)]


def _rank(top, iid):
    pos = np.flatnonzero(np.asarray(top) == iid)
    return int(pos[0]) if len(pos) else len(top)


def _same(j, p, img):
    want, got = np.asarray(j.query(img)), p.query(img)
    np.testing.assert_array_equal(got, want)
    return got


def test_add_then_retrieve_then_remove(make, images):
    jsrv, psrv = make(_index_arrays(7), db_capacity=600)
    new = images[:3]
    ids = psrv.add_reference_images(new)
    assert ids == jsrv.add_reference_images(new) == [20, 21, 22]
    assert psrv.num_images == jsrv.num_images == 23
    assert psrv.num_ref_images == jsrv.num_ref_images == 20 + 400
    for img, iid in zip(new, ids):
        assert iid in _same(jsrv, psrv, img)
    psrv.remove_reference_image(ids[1])
    jsrv.remove_reference_image(ids[1])
    top = _same(jsrv, psrv, new[1])
    assert _rank(top, ids[1]) == len(top)


def test_batched_insert_matches_per_image_and_jax(make, images):
    """One chunk of 4 (one database copy) leaves the database bit for bit
    as four single-image chunks do, and as JAX's batched insert does up
    to the fronts' f32 rounding."""
    index = _index_arrays(23)
    jsrv, psrv = make(index, db_capacity=600, insert_chunk=4)
    single = make(index, port_only=True, db_capacity=600, insert_chunk=1)
    imgs = images[:4]
    assert (psrv.add_reference_images(imgs)
            == single.add_reference_images(imgs)
            == jsrv.add_reference_images(imgs))
    assert psrv._cursor == single._cursor == jsrv._cursor
    db_b = psrv._db.numpy()
    np.testing.assert_array_equal(db_b, single._db.numpy())
    live = np.all(db_b < DB_GUARD / 2, axis=1)
    np.testing.assert_array_equal(psrv._db_ids.numpy()[live],
                                  single._db_ids.numpy()[live])
    jdb = np.asarray(jsrv._db)
    np.testing.assert_array_equal(live, np.all(jdb < DB_GUARD / 2, axis=1))
    np.testing.assert_allclose(db_b[live], jdb[live], atol=1e-4)
    np.testing.assert_array_equal(psrv._db_ids.numpy(),
                                  np.asarray(jsrv._db_ids))


def test_chunk_splits_at_the_capacity(make, images):
    """A batch larger than the free row blocks splits into chunks; past
    the capacity both servers refuse."""
    index = _index_arrays(29)
    jsrv, psrv = make(index, db_capacity=200 + 3 * KMAX, insert_chunk=8)
    ids = psrv.add_reference_images(images[:2])
    assert ids == jsrv.add_reference_images(images[:2]) == [20, 21]
    for img, iid in zip(images[:2], ids):
        assert iid in list(_same(jsrv, psrv, img))
    full = make(index, port_only=True, db_capacity=200 + KMAX - 1)
    with pytest.raises(RuntimeError, match="capacity exhausted"):
        full.add_reference_images(images[:1])
    bins = make(index, port_only=True, db_capacity=400, max_ref_images=20)
    with pytest.raises(RuntimeError, match="Borda bin"):
        bins.add_reference_images(images[:1])


def test_incremental_matches_prebuilt(make, images):
    index = _index_arrays(11)
    jsrv, psrv = make(index, db_capacity=400)
    (new_id,) = psrv.add_reference_images([images[4]])
    assert [new_id] == jsrv.add_reference_images([images[4]])
    used = psrv._cursor
    pre = dict(index, db=psrv._db[:used].numpy(),
               db_image_ids=psrv._db_ids[:used].numpy(),
               num_ref_images=psrv.num_ref_images)
    prebuilt = make(pre, port_only=True)
    for img in (images[5], images[4]):
        np.testing.assert_array_equal(psrv.query(img), prebuilt.query(img))
        _same(jsrv, psrv, img)


@pytest.mark.parametrize("db_dtype", ["float32", "bfloat16"])
def test_snapshot_roundtrip_both_ways(make, images, tmp_path, db_dtype):
    """After an add and a removal, the port's snapshot npz restores into
    a port server and, through JAX ``ServingIndex.from_npz``, a JAX
    server that answer as the original; and a JAX snapshot restores into
    a port server that answers as the JAX one."""
    index = dict(_index_arrays(13), db_dtype=db_dtype)
    jsrv, psrv = make(index, db_capacity=400)
    ids = psrv.add_reference_images(images[:2])
    jsrv.add_reference_images(images[:2])
    for srv in (psrv, jsrv):
        srv.remove_reference_image(ids[0])
    path = str(tmp_path / "port.npz")
    snap = psrv.snapshot_index(path)
    assert snap.db_dtype == db_dtype
    assert not np.any(np.all(snap.db >= 5e5, axis=1))      # compacted
    with np.load(path) as z:
        assert set(z.files) == {
            "db", "db_dtype", "db_image_ids", "image_keys", "num_ref_images",
            "centers", "pca_mean", "pca_components", "pca_variance",
            "pca_whiten", "order", "mask_h", "mask_w", "dino_h", "dino_w"}
        assert z["db_image_ids"].dtype == np.int32
        assert (int(z["mask_h"]), int(z["dino_w"])) == (H // 2, W)
    fields = [f.name for f in dataclasses.fields(pserve.ServingIndex)]
    as_dict = lambda ix: {f: getattr(ix, f) for f in fields}  # noqa: E731
    loaded_j = jserve.ServingIndex.from_npz(path)
    assert loaded_j.db_dtype == db_dtype and loaded_j.num_ref_images == 22
    np.testing.assert_array_equal(loaded_j.db, snap.db)
    j2, p2 = make(as_dict(loaded_j))
    p3 = make(as_dict(pserve.ServingIndex.from_npz(path)), port_only=True)
    q = images[6]
    top = psrv.query(q)
    for srv in (p2, p3):
        np.testing.assert_array_equal(srv.query(q), top)
    np.testing.assert_array_equal(np.asarray(j2.query(q)), top)

    jpath = str(tmp_path / "jax.npz")
    jsrv.snapshot_index(jpath)
    from_jax = make(as_dict(pserve.ServingIndex.from_npz(jpath)),
                    port_only=True)
    np.testing.assert_array_equal(from_jax.query(q), np.asarray(jsrv.query(q)))


def test_snapshot_of_an_empty_database(make, tmp_path):
    jsrv, psrv = make(_index_arrays(17, n_segs=20, n_images=4),
                      db_capacity=100)
    for i in range(4):
        psrv.remove_reference_image(i)
    path = str(tmp_path / "empty.npz")
    snap = psrv.snapshot_index(path)
    assert len(snap.db) == 0
    for from_npz in (pserve.ServingIndex.from_npz,
                     jserve.ServingIndex.from_npz):
        loaded = from_npz(path)
        assert len(loaded.db) == 0 and loaded.num_ref_images == 4


def test_snapshot_persists_the_true_image_count(make, images, tmp_path):
    index = _index_arrays(29)
    jsrv, psrv = make(index, db_capacity=400)
    assert psrv.add_reference_images([images[0]]) == [20]
    path = str(tmp_path / "snap.npz")
    assert psrv.snapshot_index(path).num_ref_images == 21
    fields = [f.name for f in dataclasses.fields(pserve.ServingIndex)]
    loaded = pserve.ServingIndex.from_npz(path)
    srv2 = make({f: getattr(loaded, f) for f in fields}, port_only=True,
                db_capacity=400)
    assert srv2.num_images == 21
    assert srv2.add_reference_images([images[1]]) == [21]
    assert srv2.snapshot_index().num_ref_images == 22


def test_concurrent_inserts_are_serialized(make, images):
    psrv = make(_index_arrays(23), port_only=True, db_capacity=800)
    with ThreadPoolExecutor(max_workers=4) as pool:
        id_lists = list(pool.map(lambda im: psrv.add_reference_images([im]),
                                 images[:4]))
    ids = sorted(i for lst in id_lists for i in lst)
    assert ids == [20, 21, 22, 23]
    db_ids = psrv._db_ids[:psrv._cursor].numpy()
    live = np.all(psrv._db[:psrv._cursor].numpy() < 1e5, axis=1)
    for iid in ids:
        assert np.any(live & (db_ids == iid)), iid


def test_query_many_pipelines_like_sequential_queries(make, images):
    jsrv, psrv = make(_index_arrays(3), db_capacity=500)
    psrv.add_reference_images(images[:3])
    jsrv.add_reference_images(images[:3])
    qs = images[:3] + images[5:8]
    many = psrv.query_many(qs, workers=3)
    jmany = jsrv.query_many(qs, workers=3)
    for img, got, want in zip(qs, many, jmany):
        np.testing.assert_array_equal(got, psrv.query(img))
        np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("facet", ["query", "key", "value", "token"])
def test_dino_facet_serves_like_jax(make, images, facet):
    jsrv, psrv = make(_index_arrays(5), dino_facet=facet)
    img = images[2]
    with torch.inference_mode():
        desc = psrv._front(torch.from_numpy(img))[2].numpy()
    want = np.asarray(jsrv._front(jax.device_put(img))[2])
    np.testing.assert_allclose(desc, want, atol=1e-4)
    _same(jsrv, psrv, img)


def test_constructor_checks_match_jax(make):
    index = _index_arrays(31)
    for kw in (dict(db_capacity=100), dict(db_capacity=400,
                                           max_ref_images=5)):
        with pytest.raises(ValueError):
            make(index, port_only=True, **kw)
    with pytest.raises(ValueError, match="facet"):
        make(index, port_only=True, dino_facet="values")
    with pytest.raises(ValueError, match="db_capacity"):
        make(index, port_only=True).add_reference_images([])


@pytest.mark.parametrize("db_dtype", ["float32", "bfloat16"])
def test_database_updates_match_jax_bit_for_bit(db_dtype):
    """``_db_insert``, ``_compact_insert_many`` (guard tail under the
    chunk's first id, kept rows compacted across images) and
    ``_db_remove`` against the JAX functions."""
    rng = np.random.default_rng(9)
    db = rng.standard_normal((60, 8)).astype(np.float32)
    db[40:] = DB_GUARD
    ids = np.repeat(np.arange(6), 10).astype(np.int32)
    rows = rng.standard_normal((3, 6, 8)).astype(np.float32)
    kept = np.array([4, 0, 6], np.int32)
    for i, k in enumerate(kept):
        rows[i, k:] = DB_GUARD
    img_ids = np.array([6, 7, 8], np.int32)
    jdt, pdt = getattr(jnp, db_dtype), getattr(torch, db_dtype)
    jdb, jids = jnp.asarray(db, jdt), jnp.asarray(ids)
    pdb, pids = torch.from_numpy(db).to(pdt), torch.from_numpy(ids).long()

    def same(got, want):
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))

    want = jserve._compact_insert_many(jdb, jids, jnp.asarray(rows),
                                       jnp.asarray(kept),
                                       jnp.asarray(img_ids), np.int32(30))
    got = pserve._compact_insert_many(pdb, pids, torch.from_numpy(rows),
                                      torch.from_numpy(kept).long(),
                                      torch.from_numpy(img_ids).long(), 30)
    for g, w in zip(got, want):
        same(g, w)
    assert torch.equal(pdb, torch.from_numpy(db).to(pdt))   # a new copy
    want = jserve._db_insert(jdb, jids, jnp.asarray(rows[2]), np.int32(33),
                             np.int32(8))
    got = pserve._db_insert(pdb, pids, torch.from_numpy(rows[2]), 33, 8)
    for g, w in zip(got, want):
        same(g, w)
    same(pserve._db_remove(pdb, pids, 2), jserve._db_remove(jdb, jids,
                                                            np.int32(2)))
