"""Port parity of the whole serving slice: the JAX ``SegVLADServer`` and
the port's, built from the same converted weights and the same planted
index (database rows are the JAX package's own ``query_segment_rows`` of
a few images), answer noisy copies of those images with identical top-5
ids."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from revisit_anything_tpu.models import dinov2 as jdn
from revisit_anything_tpu.models.sam import SamArchConfig, init_sam_params
from revisit_anything_tpu.models.sam.amg import AmgConfig as JAmg
from revisit_anything_tpu.pipeline.query import query_segment_rows
from revisit_anything_tpu.pipeline.serve import SegVLADServer as JServer
from revisit_anything_tpu.pipeline.serve import ServingIndex as JIndex
from revisit_anything_tpu_torch.models import dinov2 as pdn
from revisit_anything_tpu_torch.models.sam import SamArchConfig as PSamCfg
from revisit_anything_tpu_torch.models.sam.amg import AmgConfig as PAmg
from revisit_anything_tpu_torch.pipeline.serve import SegVLADServer as PServer
from revisit_anything_tpu_torch.pipeline.serve import ServingIndex as PIndex
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
N_IMAGES = 6
C, PCA = 8, 16
SERVE_KW = dict(full_hw=(H, W), sam_hw=(H // 2, W // 2), dino_layer=1,
                max_masks=32, top_images=5)
# random-weight SAM gives few, heavily overlapping masks: keep up to 0.95
# box IoU so the front carries several masks into the adjacency and VLAD
AMG_KW = dict(points_per_side=6, points_per_batch=36, pred_iou_thresh=-1e9,
              stability_score_thresh=0.0, box_nms_thresh=0.95)


def _image(rng):
    img = rng.integers(60, 200, (H, W, 3), dtype=np.uint8)
    yy, xx = np.ogrid[:H, :W]
    for _ in range(4):
        cy, cx = rng.integers(10, H - 10), rng.integers(10, W - 10)
        r = rng.integers(6, 20)
        img[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = rng.integers(0, 255, 3)
    return img


@pytest.fixture(scope="module")
def servers():
    rng = np.random.default_rng(0)

    def perturbed(tree):
        return jax.tree_util.tree_map(
            lambda x: (np.asarray(x) + 0.1 * rng.standard_normal(x.shape)
                       ).astype(np.float32), tree)

    sam_tree = perturbed(init_sam_params(SamArchConfig(**SAM_KW),
                                         jax.random.PRNGKey(0)))
    dino_tree = perturbed(jdn.init_params(jdn.DinoV2Config(**DINO_KW),
                                          jax.random.PRNGKey(1)))
    to_jax = lambda t: jax.tree_util.tree_map(jnp.asarray, t)   # noqa: E731
    idx = dict(
        centers=rng.standard_normal((C, DINO_KW["embed_dim"])).astype(
            np.float32),
        pca_mean=np.zeros((C * DINO_KW["embed_dim"],), np.float32),
        pca_components=(rng.standard_normal(
            (PCA, C * DINO_KW["embed_dim"])) * 0.1).astype(np.float32),
        pca_variance=np.ones((PCA,), np.float32), pca_whiten=True, order=3)
    placeholder = np.eye(PCA, dtype=np.float32)[:N_IMAGES]
    jsrv = JServer(sam_params=to_jax(sam_tree),
                   sam_cfg=SamArchConfig(**SAM_KW),
                   dino_params=to_jax(dino_tree),
                   dino_cfg=jdn.DinoV2Config(**DINO_KW),
                   index=JIndex(db=placeholder,
                                db_image_ids=np.arange(N_IMAGES),
                                num_ref_images=N_IMAGES, **idx),
                   amg=JAmg(**AMG_KW), mesh=None, **SERVE_KW)

    # plant the database: each image's own segment rows, by the JAX package
    images = [_image(rng) for _ in range(N_IMAGES)]
    rows, ids = [], []
    for i, img in enumerate(images):
        pm, stats, desc = jsrv._front(jax.device_put(img))
        adj, _ = jsrv._adjacency(np.asarray(stats))
        r, valid = query_segment_rows(
            desc, pm, jnp.asarray(adj), jsrv._centers, jsrv._pca_mean,
            jsrv._pca_comps, jsrv._pca_var, num_clusters=C, whiten=True)
        valid = np.asarray(valid)
        assert valid.any()
        rows.append(np.asarray(r)[valid])
        ids.append(np.full(valid.sum(), i, np.int32))
    db, db_ids = np.concatenate(rows), np.concatenate(ids)

    jsrv = JServer(sam_params=to_jax(sam_tree),
                   sam_cfg=SamArchConfig(**SAM_KW),
                   dino_params=to_jax(dino_tree),
                   dino_cfg=jdn.DinoV2Config(**DINO_KW),
                   index=JIndex(db=db, db_image_ids=db_ids,
                                num_ref_images=N_IMAGES, **idx),
                   amg=JAmg(**AMG_KW), mesh=None, **SERVE_KW)
    psrv = PServer(sam=sam_from_jax_params(sam_tree, PSamCfg(**SAM_KW),
                                           device="cpu"),
                   dino=dino_from_jax_params(dino_tree,
                                             pdn.DinoV2Config(**DINO_KW),
                                             device="cpu"),
                   index=PIndex(db=db, db_image_ids=db_ids,
                                num_ref_images=N_IMAGES, **idx),
                   amg=PAmg(**AMG_KW), **SERVE_KW)
    return jsrv, psrv, images


def test_front_matches_jax(servers):
    jsrv, psrv, images = servers
    kept = []
    for img in images:
        pm_j, stats_j, desc_j = map(np.asarray,
                                    jsrv._front(jax.device_put(img)))
        with torch.inference_mode():
            pm_p, stats_p, desc_p = (x.numpy() for x in psrv._front(
                torch.from_numpy(img)))
        n = int(stats_j[-1])
        kept.append(n)
        assert int(stats_p[-1]) == n
        np.testing.assert_array_equal(pm_p, pm_j)
        np.testing.assert_allclose(stats_p, stats_j, atol=1e-3)
        np.testing.assert_allclose(desc_p, desc_j, atol=1e-4)
    assert max(kept) > 3          # some query reaches the Delaunay path


@pytest.mark.parametrize("i", range(N_IMAGES))
def test_noisy_copy_top5_matches_jax(servers, i):
    jsrv, psrv, images = servers
    rng = np.random.default_rng(100 + i)
    noisy = np.clip(images[i].astype(np.int16)
                    + rng.integers(-3, 4, images[i].shape), 0, 255
                    ).astype(np.uint8)
    want = np.asarray(jsrv.query(noisy))
    got = psrv.query(noisy)
    np.testing.assert_array_equal(got, want)
    assert i in got               # its own planted rows vote for it


def test_query_many_matches_single(servers):
    _, psrv, images = servers
    got = psrv.query_many(images[:2])
    for img, top in zip(images[:2], got):
        np.testing.assert_array_equal(top, psrv.query(img))
