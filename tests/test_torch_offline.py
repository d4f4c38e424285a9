"""Port parity of the offline SegLoc pipeline: extraction (SAM masks and
DINOv2 features into h5 files), vocabulary, segment-VLAD aggregation and
the whole pipeline on synthetic images whose queries are noisy copies of
database images (``tests/test_e2e_synthetic.py``'s models and sizes),
the JAX package and the port from the same converted weights."""

import os

import h5py
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from revisit_anything_tpu.io import h5io as jio
from revisit_anything_tpu.models import dinov2 as jdn
from revisit_anything_tpu.models.sam import SamArchConfig, init_sam_params
from revisit_anything_tpu.models.sam.amg import AmgConfig as JAmg
from revisit_anything_tpu.ops import kmeans as jkm
from revisit_anything_tpu.pipeline import aggregate as jagg
from revisit_anything_tpu.pipeline import extract as jext
from revisit_anything_tpu.pipeline import vocabulary as jvoc
from revisit_anything_tpu_torch.io import h5io as pio
from revisit_anything_tpu_torch.models import dinov2 as pdn
from revisit_anything_tpu_torch.models.sam import SamArchConfig as PSamCfg
from revisit_anything_tpu_torch.models.sam import amg as pamg
from revisit_anything_tpu_torch.ops import kmeans as pkm
from revisit_anything_tpu_torch.pipeline import aggregate as pagg
from revisit_anything_tpu_torch.pipeline import evaluate as pev
from revisit_anything_tpu_torch.pipeline import extract as pext
from revisit_anything_tpu_torch.pipeline import vocabulary as pvoc
from revisit_anything_tpu_torch.weights import (dino_from_jax_params,
                                                sam_from_jax_params)

torch.set_float32_matmul_precision("highest")

SAM_KW = dict(encoder_dim=64, encoder_depth=2, encoder_heads=4,
              global_attn_indexes=(1,), image_size=128, patch_size=16,
              window_size=4, prompt_dim=32, decoder_heads=4,
              decoder_mlp_dim=128, iou_head_hidden=32)
DINO_KW = dict(embed_dim=64, depth=2, num_heads=4, ffn="mlp",
               pretrain_grid=(8, 8))
H, W = 112, 112          # DINO resolution (8x8 patches); SAM at 56x56
N_DB, N_Q = 8, 4
C = 8
AMG_KW = dict(points_per_side=6, points_per_batch=36, pred_iou_thresh=-1e9,
              stability_score_thresh=0.0, box_nms_thresh=0.95)
CPU = "cpu"


def _image(rng):
    img = rng.integers(60, 200, (H, W, 3), dtype=np.uint8)
    yy, xx = np.ogrid[:H, :W]
    for _ in range(4):
        cy, cx = rng.integers(10, H - 10), rng.integers(10, W - 10)
        r = rng.integers(6, 20)
        img[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = rng.integers(0, 255, 3)
    return img


@pytest.fixture(scope="module")
def models():
    """One weight tree per model (the JAX init, perturbed so the random SAM
    keeps several masks an image), in both packages."""
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
    return dict(
        jsam=to_jax(sam_tree), jdino=to_jax(dino_tree),
        psam=sam_from_jax_params(sam_tree, PSamCfg(**SAM_KW), device=CPU),
        pdino=dino_from_jax_params(dino_tree, pdn.DinoV2Config(**DINO_KW),
                                   device=CPU))


@pytest.fixture(scope="module")
def artifacts(models, tmp_path_factory):
    """Database and query images on disk (queries: noisy copies of
    database images 2q+1), and each package's mask and feature h5 files
    of both sets."""
    tmp = tmp_path_factory.mktemp("offline")
    rng = np.random.default_rng(11)
    db_imgs = [_image(rng) for _ in range(N_DB)]
    targets = [(2 * q + 1) % N_DB for q in range(N_Q)]
    q_imgs = [np.clip(db_imgs[t].astype(int)
                      + rng.integers(-8, 9, (H, W, 3)), 0, 255
                      ).astype(np.uint8) for t in targets]
    from PIL import Image
    files = {}
    for tag, imgs in (("db", db_imgs), ("q", q_imgs)):
        paths = []
        for i, im in enumerate(imgs):
            p = str(tmp / f"{tag}_{i:03d}.png")
            Image.fromarray(im).save(p)
            paths.append(p)
        keys = [os.path.basename(p) for p in paths]
        out = dict(paths=paths, keys=keys)
        for pkg in ("jax", "port"):
            masks_h5 = str(tmp / f"{tag}_{pkg}_masks.h5")
            dino_h5 = str(tmp / f"{tag}_{pkg}_dino.h5")
            if pkg == "jax":
                jext.extract_sam_masks(paths, keys, masks_h5, models["jsam"],
                                       SamArchConfig(**SAM_KW),
                                       (H // 2, W // 2), JAmg(**AMG_KW),
                                       progress=False, mesh=None)
                jext.extract_dino_features(
                    paths, keys, dino_h5, models["jdino"],
                    jdn.DinoV2Config(**DINO_KW), (H, W), layer=1,
                    progress=False, mesh=None)
            else:
                pext.extract_sam_masks(paths, keys, masks_h5, models["psam"],
                                       (H // 2, W // 2),
                                       pamg.AmgConfig(**AMG_KW),
                                       progress=False)
                pext.extract_dino_features(paths, keys, dino_h5,
                                           models["pdino"], (H, W), layer=1,
                                           progress=False)
            out[pkg] = (masks_h5, dino_h5)
        files[tag] = out
    return files, targets


def _records(path, key, reader):
    with h5py.File(path, "r") as f:
        return reader(f, key)


@pytest.mark.parametrize("tag", ["db", "q"])
def test_sam_records_match_jax(artifacts, tag):
    """Per image the same number of records, the same mask bits, boxes,
    points and crop boxes, IoU and stability to 1e-4; each package reads
    the other's file as its own."""
    files, _ = artifacts
    f = files[tag]
    kept = []
    for key in f["keys"]:
        want = _records(f["jax"][0], key, jio.read_image_masks)
        got = _records(f["port"][0], key, pio.read_image_masks)
        kept.append(len(want))
        assert len(got) == len(want), key
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.segmentation, w.segmentation)
            assert g.area == w.area and g.bbox == w.bbox
            assert g.crop_box == w.crop_box
            np.testing.assert_array_equal(g.point_coords, w.point_coords)
            assert abs(g.predicted_iou - w.predicted_iou) <= 1e-4
            assert abs(g.stability_score - w.stability_score) <= 1e-4
        cross = [_records(f["jax"][0], key, pio.read_image_masks),
                 _records(f["port"][0], key, jio.read_image_masks)]
        for a, b in ((cross[0], want), (cross[1], got)):
            assert [r.area for r in a] == [r.area for r in b]
            for ra, rb in zip(a, b):
                np.testing.assert_array_equal(ra.segmentation,
                                              rb.segmentation)
                assert ra.predicted_iou == rb.predicted_iou
    assert max(kept) > 3, kept        # some image reaches the Delaunay path


@pytest.mark.parametrize("tag", ["db", "q"])
def test_dino_features_match_jax(artifacts, tag):
    files, _ = artifacts
    f = files[tag]
    with h5py.File(f["jax"][1]) as fj, h5py.File(f["port"][1]) as fp:
        for key in f["keys"]:
            want = jio.read_dino_features(fj, key)
            got = pio.read_dino_features(fp, key)
            assert got.shape == want.shape == (1, 64, 8, 8)
            assert got.dtype == np.float32
            err = np.abs(got - want).max() / np.abs(want).max()
            assert err <= 1e-5, (key, err)
            np.testing.assert_array_equal(
                jio.read_dino_features(fp, key), got)


def test_batched_encode_matches_one_image_at_a_time(models):
    """One encoder dispatch for two images gives each image's records as
    two single-image dispatches do."""
    rng = np.random.default_rng(5)
    imgs = [pext._resize_cv2_bilinear(_image(rng), (W // 2, H // 2))
            for _ in range(2)]
    amg = pamg.AmgConfig(**AMG_KW)
    both = pamg.generate_masks_batch(models["psam"], imgs, amg)
    for img, recs in zip(imgs, both):
        one = pamg.generate_masks(models["psam"], img, amg)
        assert len(one) == len(recs) > 0
        for a, b in zip(one, recs):
            np.testing.assert_array_equal(a.segmentation, b.segmentation)
            assert abs(a.predicted_iou - b.predicted_iou) <= 1e-5


def test_downscaling_preprocess_raises():
    cfg = PSamCfg(**SAM_KW)
    with pytest.raises(NotImplementedError, match="PIL"):
        pamg._preprocess_any(np.zeros((200, 100, 3), np.uint8), cfg, CPU)


def test_fallback_records_draw_the_jax_pixels(monkeypatch):
    """The zero-mask fallback's random pixel comes from a stream of its
    own, seeded as the JAX package's: calls in the same order draw the
    same pixels."""
    monkeypatch.setattr(jext, "_FALLBACK_RNG", np.random.default_rng(0))
    monkeypatch.setattr(pext, "_FALLBACK_RNG", np.random.default_rng(0))
    for hw in ((56, 56), (30, 40), (56, 56)):
        for a, b in zip(jext._fallback_records(hw),
                        pext._fallback_records(hw)):
            np.testing.assert_array_equal(a.segmentation, b.segmentation)
            assert (a.area, tuple(a.bbox), tuple(a.crop_box)) == (
                b.area, tuple(b.bbox), tuple(b.crop_box))


@pytest.mark.parametrize("src,dst", [((112, 112), (112, 112)),
                                     ((112, 112), (56, 56)),
                                     ((480, 640), (240, 320)),
                                     ((97, 131), (60, 80)),
                                     ((480, 640), (300, 400)),
                                     ((60, 80), (97, 131)),
                                     ((56, 56), (200, 300))])
def test_resize_matches_cv2(src, dst):
    """The port's image resize against ``cv2.resize(INTER_LINEAR)``: exact
    at an equal size and for downscales (the SAM inputs: half the DINO
    size); an upscale within one level, at least 99% of the values
    exact."""
    import cv2
    rng = np.random.default_rng(sum(src + dst))
    img = rng.integers(0, 256, src + (3,), dtype=np.uint8)
    want = cv2.resize(img, (dst[1], dst[0]), interpolation=cv2.INTER_LINEAR)
    got = pext._resize_cv2_bilinear(img, (dst[1], dst[0]))
    assert got.shape == want.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    if dst[0] <= src[0] and dst[1] <= src[1]:
        assert diff.max() == 0
    else:
        assert diff.max() <= 1
        assert (diff == 0).mean() >= 0.99, (diff == 0).mean()


def test_descriptor_sampling_matches_jax(artifacts):
    """Above the large-set threshold both packages take the same images
    and every 2nd pixel."""
    files, _ = artifacts
    f = files["db"]
    kw = dict(large_set_threshold=4, seed=3)
    want = jvoc.sample_descriptors_from_h5(f["jax"][1], f["keys"], **kw)
    got = pvoc.sample_descriptors_from_h5(f["jax"][1], f["keys"], **kw)
    assert got.shape == want.shape == (int(N_DB * 0.3) * 16, 64)
    np.testing.assert_array_equal(got, want)
    full = pvoc.sample_descriptors_from_h5(f["jax"][1], f["keys"])
    assert full.shape == (N_DB * 64, 64)


def _jax_lloyd(x, centers0, iters, mode, monkeypatch):
    """The JAX package's kmeans_fit with its seeding replaced by given
    centers (run unjitted, so the patched seeding is the one called)."""
    monkeypatch.setattr(jkm, "_kmeanspp_init",
                        lambda x_, n, key, mode_: jnp.asarray(centers0))
    c, lab = jkm.kmeans_fit.__wrapped__(
        jnp.asarray(x), centers0.shape[0], jax.random.PRNGKey(0),
        num_iters=iters, mode=mode)
    return np.asarray(c), np.asarray(lab)


@pytest.mark.parametrize("mode", ["cosine", "euclidean"])
def test_lloyd_iterations_match_jax_from_jax_seeding(mode):
    """From JAX's own kmeans++ centers the port's iterations give JAX's
    centers (1e-5) and labels (equal)."""
    rng = np.random.default_rng(4)
    blobs = rng.standard_normal((C, 24)).astype(np.float32) * 3
    x = (blobs[rng.integers(0, C, 600)]
         + rng.standard_normal((600, 24))).astype(np.float32)
    key = jax.random.PRNGKey(7)
    c0 = np.asarray(jkm._kmeanspp_init(jnp.asarray(x), C, key, mode))
    cj, lj = jkm.kmeans_fit(jnp.asarray(x), C, key, num_iters=20, mode=mode)
    cp, lp = pkm.kmeans_iterate(torch.from_numpy(x), torch.from_numpy(c0),
                                20, mode)
    np.testing.assert_allclose(cp.numpy(), np.asarray(cj), atol=1e-5)
    np.testing.assert_array_equal(lp.numpy(), np.asarray(lj))


def test_empty_cluster_center_becomes_zero(monkeypatch):
    """A center no point is nearest to becomes the zero vector and stays
    so, as in JAX from the same centers."""
    rng = np.random.default_rng(6)
    x = rng.random((200, 8)).astype(np.float32)          # positive orthant
    c0 = np.concatenate([x[:3], -np.ones((1, 8), np.float32)])
    cp, lp = pkm.kmeans_iterate(torch.from_numpy(x), torch.from_numpy(c0),
                                5, "cosine")
    cj, lj = _jax_lloyd(x, c0, 5, "cosine", monkeypatch)
    assert not cp[3].any() and not cj[3].any()
    assert not (lp == 3).any()
    np.testing.assert_allclose(cp.numpy(), cj, atol=1e-5)
    np.testing.assert_array_equal(lp.numpy(), lj)


def test_kmeans_fit_is_seeded_and_separates_blobs():
    """The port's own seeding: deterministic for a generator seed, and
    the fit recovers well-separated blobs."""
    rng = np.random.default_rng(8)
    centers = rng.standard_normal((4, 16)).astype(np.float32) * 10
    truth = rng.integers(0, 4, 400)
    x = torch.from_numpy((centers[truth] + rng.standard_normal((400, 16))
                          ).astype(np.float32))
    runs = [pkm.kmeans_fit(x, 4, torch.Generator().manual_seed(1),
                           num_iters=10, mode="euclidean")
            for _ in range(2)]
    assert torch.equal(runs[0][0], runs[1][0])
    labels = runs[0][1].numpy()
    for c in range(4):
        assert len(set(labels[truth == c])) == 1


@pytest.mark.parametrize("order", [0, 1, 2, 3])
def test_segment_vlads_match_jax(artifacts, order):
    files, _ = artifacts
    f = files["db"]
    with h5py.File(f["jax"][1]) as fj:
        centers = np.stack([jio.read_dino_features(fj, k)[0][:, 0, i]
                            for i, k in enumerate(f["keys"])])
    kw = dict(order=order, mask_hw=(H // 2, W // 2), desired_hw=(H, W),
              progress=False)
    want = jagg.compute_segment_vlads(*f["jax"], f["keys"], centers,
                                      num_clusters=C, **kw)
    got = pagg.compute_segment_vlads(*f["jax"], f["keys"], centers,
                                     device=CPU, **kw)
    assert got.descriptors.shape == want.descriptors.shape
    assert got.descriptors.shape[1] == C * 64
    np.testing.assert_array_equal(got.image_indices, want.image_indices)
    assert got.num_images == want.num_images == N_DB
    np.testing.assert_allclose(got.descriptors, want.descriptors, atol=1e-5)


def test_global_vlads_match_jax(artifacts):
    files, _ = artifacts
    f = files["q"]
    centers = np.random.default_rng(9).standard_normal((C, 64)).astype(
        np.float32)
    want = jagg.global_vlads_from_h5(f["jax"][1], f["keys"], centers,
                                     (H, W), C)
    got = pagg.global_vlads_from_h5(f["jax"][1], f["keys"], centers,
                                    device=CPU)
    assert got.shape == (N_Q, C * 64)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_port_alone_recovers_the_planted_mapping(artifacts):
    """The port's own artifacts, vocabulary and banks: Recall@1 = 1.0 on
    the raw order-3 VLADs, with device and host voting."""
    files, targets = artifacts
    db, q = files["db"], files["q"]
    centers = pvoc.fit_vocabulary_from_h5(db["port"][1], db["keys"],
                                          num_clusters=C, device=CPU)
    assert centers.shape == (C, 64)
    kw = dict(order=3, mask_hw=(H // 2, W // 2), desired_hw=(H, W),
              progress=False, device=CPU)
    db_bank = pagg.compute_segment_vlads(*db["port"], db["keys"], centers,
                                         **kw)
    q_bank = pagg.compute_segment_vlads(*q["port"], q["keys"], centers, **kw)
    gt = [[t] for t in targets]
    for voting in (True, False):
        res = pev.run_segloc_retrieval(db_bank, q_bank, gt,
                                       device_voting=voting, device=CPU)
        assert res.recalls[0] == 1.0, (voting, res.predictions)
    pca = pvoc.fit_pca_from_vlads(db_bank, num_components=16, device=CPU)
    assert pca.components.shape == (16, C * 64)
    res = pev.run_segloc_retrieval(db_bank, q_bank, gt, pca=pca, device=CPU)
    assert len(res.recalls) == 5
