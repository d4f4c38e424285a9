"""Port parity: the retrieval tail (mask pooling, Delaunay adjacency,
segment VLAD, PCA rows, one-shot kNN and weighted Borda) against the JAX
package, including guard rows (scores far below any real row, sims < −4
excluded from the vote normalization) and the −1 fill of ranks no image reaches."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from revisit_anything_tpu.ops.adjacency import delaunay_adjacency as jadj
from revisit_anything_tpu.ops.masks import mask_pool_matrices as jpoolm
from revisit_anything_tpu.ops.masks import pool_masks_to_patch_grid as jpool
from revisit_anything_tpu.ops.vlad import segment_vlad as jvlad
from revisit_anything_tpu.pipeline.query import DB_GUARD
from revisit_anything_tpu.pipeline.query import query_segment_rows as jrows
from revisit_anything_tpu.pipeline.query import query_topk_images as jtopk
from revisit_anything_tpu_torch.ops.adjacency import delaunay_adjacency
from revisit_anything_tpu_torch.ops.masks import (mask_pool_matrices,
                                                  pool_masks_to_patch_grid)
from revisit_anything_tpu_torch.ops.vlad import segment_vlad
from revisit_anything_tpu_torch.pipeline import query as pq

torch.set_float32_matmul_precision("highest")

P, D, C, M, PCA = 48, 16, 4, 12, 8


def _inputs(seed, n_valid=9):
    rng = np.random.default_rng(seed)
    desc = rng.standard_normal((P, D)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    masks = rng.random((M, P)) < 0.2
    masks[n_valid:] = False                      # padding rows
    adj = np.zeros((M, M), bool)
    cents = rng.random((n_valid, 2)) * 50
    adj[:n_valid, :n_valid] = jadj(cents, 3)
    idx = dict(
        centers=rng.standard_normal((C, D)).astype(np.float32),
        pca_mean=(rng.standard_normal(C * D) * 0.01).astype(np.float32),
        pca_components=rng.standard_normal((PCA, C * D)).astype(np.float32),
        pca_variance=(rng.random(PCA) + 0.5).astype(np.float32))
    return desc, masks, adj, idx


def _t(x):
    return torch.from_numpy(np.array(x))


def test_delaunay_adjacency_is_bit_identical():
    rng = np.random.default_rng(0)
    for m in (1, 2, 3, 4, 17, 60):
        cents = rng.random((m, 2)) * 100
        for order in (1, 3):
            np.testing.assert_array_equal(delaunay_adjacency(cents, order),
                                          jadj(cents, order))
    collinear = np.stack([np.arange(6.0), np.arange(6.0)], 1)
    np.testing.assert_array_equal(delaunay_adjacency(collinear, 2),
                                  jadj(collinear, 2))


def test_mask_pooling_matches_jax():
    a, b = mask_pool_matrices((60, 80), (120, 160))
    ja, jb = jpoolm((60, 80), (120, 160))
    np.testing.assert_array_equal(a, ja)
    np.testing.assert_array_equal(b, jb)
    masks = np.random.default_rng(1).random((5, 60, 80)) < 0.05
    want = np.asarray(jpool(jnp.asarray(masks), jnp.asarray(ja),
                            jnp.asarray(jb)))
    got = pool_masks_to_patch_grid(_t(masks), _t(a), _t(b)).numpy()
    np.testing.assert_array_equal(got, want)


def test_segment_vlad_matches_jax():
    desc, masks, adj, idx = _inputs(2)
    want = np.asarray(jvlad(jnp.asarray(desc), jnp.asarray(idx["centers"]),
                            jnp.asarray(masks), jnp.asarray(adj)))
    got = segment_vlad(_t(desc), _t(idx["centers"]), _t(masks),
                       _t(adj)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_segment_rows_match_jax():
    desc, masks, adj, idx = _inputs(3)
    want_rows, want_valid = map(np.asarray, jrows(
        jnp.asarray(desc), jnp.asarray(masks), jnp.asarray(adj),
        *(jnp.asarray(idx[k]) for k in ("centers", "pca_mean",
                                        "pca_components", "pca_variance")),
        num_clusters=C))
    rows, valid = pq.query_segment_rows(
        _t(desc), _t(masks), _t(adj),
        *(_t(idx[k]) for k in ("centers", "pca_mean", "pca_components",
                               "pca_variance")))
    np.testing.assert_array_equal(valid.numpy(), want_valid)
    np.testing.assert_allclose(rows.numpy(), want_rows, rtol=1e-5,
                               atol=1e-5)
    assert pq.DB_GUARD == DB_GUARD


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_topk_images_with_guard_rows_and_fill(seed):
    """Three real images (30 rows) plus 20 guard rows under a fourth id,
    ten Borda bins, top-5: the kNN depth (50) reaches the guard rows,
    which must vote zero and leave the normalization alone; ranks past
    the three matched images are −1."""
    desc, masks, adj, idx = _inputs(seed)
    rng = np.random.default_rng(100 + seed)
    real = rng.standard_normal((30, PCA)).astype(np.float32)
    real /= np.linalg.norm(real, axis=1, keepdims=True)
    db = np.concatenate([real, np.full((20, PCA), DB_GUARD, np.float32)])
    ids = np.concatenate([np.repeat(np.arange(3), 10),
                          np.full(20, 3)]).astype(np.int32)
    kw = dict(num_ref_images=10, top_images=5, whiten=True)
    want = np.asarray(jtopk(
        jnp.asarray(desc), jnp.asarray(masks), jnp.asarray(adj),
        *(jnp.asarray(idx[k]) for k in ("centers", "pca_mean",
                                        "pca_components", "pca_variance")),
        jnp.asarray(db), jnp.asarray(ids), num_clusters=C, **kw))
    norms = pq.db_sq_norms(_t(db))
    assert float(norms[30:].min()) > 1e12        # guard scores sink
    got = pq.query_topk_images(
        _t(desc), _t(masks), _t(adj),
        *(_t(idx[k]) for k in ("centers", "pca_mean", "pca_components",
                               "pca_variance")),
        _t(db), _t(ids), db_norms=norms, **kw).numpy()
    np.testing.assert_array_equal(got, want)
    assert list(got[3:]) == [-1, -1]
    assert set(got[:3]) == {0, 1, 2}


def _db(seed, n_rows=400, n_images=40):
    """Unit rows over ``n_images`` images and a few guard rows."""
    rng = np.random.default_rng(200 + seed)
    db = rng.standard_normal((n_rows, PCA)).astype(np.float32)
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    db[-7:] = DB_GUARD
    ids = np.repeat(np.arange(n_images), n_rows // n_images).astype(np.int32)
    return db, ids


@pytest.mark.parametrize("db_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("path", ["oneshot", "streaming"])
@pytest.mark.parametrize("seed,knn_topk,borda_topk", [
    (0, 200, 50), (1, 30, 50), (2, 200, 7), (3, 5, 5)])
def test_topk_images_match_jax_on_both_knn_paths(db_dtype, path, seed,
                                                 knn_topk, borda_topk):
    """The one-shot score matrix and the streaming tiles (cap 1 byte,
    128-row tiles: 4 tiles, the last one short) against the JAX query on
    an f32 and a bf16 database, with the kNN and Borda depths varied. A
    bf16 database takes the query rounded to bf16 and f32 products on
    both sides."""
    desc, masks, adj, idx = _inputs(10 + seed)
    db, ids = _db(seed)
    kw = dict(num_ref_images=45, top_images=5, knn_topk=knn_topk,
              borda_topk=borda_topk)
    if path == "streaming":
        kw.update(oneshot_cap_bytes=1, db_tile=128)
    jdb = jnp.asarray(db, dtype=getattr(jnp, db_dtype))
    want = np.asarray(jtopk(
        jnp.asarray(desc), jnp.asarray(masks), jnp.asarray(adj),
        *(jnp.asarray(idx[k]) for k in ("centers", "pca_mean",
                                        "pca_components", "pca_variance")),
        jdb, jnp.asarray(ids), num_clusters=C, **kw))
    pdb = _t(db).to(getattr(torch, db_dtype))
    got = pq.query_topk_images(
        _t(desc), _t(masks), _t(adj),
        *(_t(idx[k]) for k in ("centers", "pca_mean", "pca_components",
                               "pca_variance")),
        pdb, _t(ids), db_norms=pq.db_sq_norms(pdb), **kw).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got >= 0).sum() >= 3


@pytest.mark.parametrize("db_dtype", ["float32", "bfloat16"])
def test_knn_scores_match_jax(db_dtype):
    """The streaming merge against JAX ``_knn_scores`` on a database
    padded to whole tiles with +inf norms (the port also takes it
    unpadded, its last tile shorter)."""
    from revisit_anything_tpu.ops.knn import _knn_scores as jknn
    from revisit_anything_tpu.ops.knn import _pad_rows
    from revisit_anything_tpu_torch.ops.knn import _knn_scores
    rng = np.random.default_rng(7)
    q = rng.standard_normal((12, PCA)).astype(np.float32)
    db, _ = _db(1, n_rows=300)
    jdb = jnp.asarray(db, dtype=getattr(jnp, db_dtype))
    norms = np.asarray(jnp.sum(jdb.astype(jnp.float32) ** 2, axis=1))
    jdb_p = _pad_rows(jdb, 128, 0.0)
    norms_p = np.concatenate([norms, np.full(84, np.inf, np.float32)])
    want_s, want_i = map(np.asarray, jknn(jnp.asarray(q), jdb_p,
                                          jnp.asarray(norms_p), 20, 128))
    pdb = _t(db).to(getattr(torch, db_dtype))
    for rows, n in ((pdb, norms), (torch.cat([pdb, pdb.new_zeros(84, PCA)]),
                                   norms_p)):
        got_s, got_i = _knn_scores(_t(q), rows, _t(n), 20, 128)
        np.testing.assert_array_equal(got_i.numpy(), want_i)
        np.testing.assert_allclose(got_s.numpy(), want_s, rtol=1e-5,
                                   atol=1e-5)


def test_pca_tuple_matches_jax():
    from types import SimpleNamespace

    from revisit_anything_tpu.pipeline.query import pca_tuple as jpca
    pca = SimpleNamespace(mean=np.zeros(3), components=np.ones((2, 3)),
                          explained_variance=np.ones(2), whiten=1)
    got, want = pq.pca_tuple(pca), jpca(pca)
    assert got[3] is want[3] is True
    assert all(a is b for a, b in zip(got[:3], want[:3]))
