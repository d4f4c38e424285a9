"""Port parity of SAM's tools against the JAX package on the CPU: the host
mask operations of ``native.py`` (and scipy's 8-connected labelling),
host NMS, box and mask prompts, the decoder's general path and its
single-mask decode, crop boxes, multi-crop AMG with small-region
post-processing, the interactive predictor and the exported decoder.

The small SAM has the point segmenter planted (``weights.
plant_point_segmenter``, its Fourier matrix doubled so the blobs fit
inside the crops, the mask head's weights lightly perturbed so some
masks carry holes and islands); the JAX package runs the same weights
from a tree read out of the port's modules. f32 on both sides."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from scipy import ndimage

from revisit_anything_tpu import native as jnative
from revisit_anything_tpu.models.sam import SamArchConfig, init_sam_params
from revisit_anything_tpu.models.sam import amg as jamg
from revisit_anything_tpu.models.sam import export as jexport
from revisit_anything_tpu.models.sam import prompt as jprompt
from revisit_anything_tpu.models.sam.decoder import decode_masks as jdecode
from revisit_anything_tpu.models.sam.predictor import (
    SamPredictor as JPredictor)
from revisit_anything_tpu.ops.nms import nms_host as jnms_host
from revisit_anything_tpu_torch import native as pnative
from revisit_anything_tpu_torch.models.sam import SamArchConfig as PortCfg
from revisit_anything_tpu_torch.models.sam import amg as pamg
from revisit_anything_tpu_torch.models.sam import export as pexport
from revisit_anything_tpu_torch.models.sam import prompt as pprompt
from revisit_anything_tpu_torch.models.sam.decoder import decode_masks
from revisit_anything_tpu_torch.models.sam.predictor import SamPredictor
from revisit_anything_tpu_torch.ops.nms import nms_host
from revisit_anything_tpu_torch.weights import (init_sam,
                                                plant_point_segmenter,
                                                sam_from_jax_params)

torch.set_float32_matmul_precision("highest")

KW = dict(encoder_dim=64, encoder_depth=2, encoder_heads=4,
          global_attn_indexes=(1,), image_size=128, patch_size=16,
          window_size=4, prompt_dim=32, decoder_heads=4, decoder_mlp_dim=128,
          iou_head_hidden=32)
JCFG = SamArchConfig(**KW)
PCFG = PortCfg(**KW)
REL = 1e-4     # f32 both sides: summation order and reassociation only
H, W = 96, 128          # fits the 128 frame; its four crops are 64 x 80
AMG_KW = dict(points_per_side=8, points_per_batch=64, pred_iou_thresh=-1e9,
              stability_score_thresh=0.0, crop_n_layers=1,
              crop_n_points_downscale_factor=2)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)


def _tree_of(module, template):
    """The JAX parameter tree of a port module, shaped like ``template``."""
    if isinstance(template, dict):
        return {k: _tree_of(getattr(module, k), v)
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return [_tree_of(module[i], v) for i, v in enumerate(template)]
    return jnp.asarray(module.detach().numpy())


@pytest.fixture(scope="module")
def models():
    gen = torch.Generator().manual_seed(0)
    sam = init_sam(PCFG, gen, "cpu", torch.float32)
    with torch.no_grad():
        sam.prompt.pe_gaussian.mul_(2.0)
    plant_point_segmenter(sam, gen)
    noise = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for p in (sam.decoder.up1_w, sam.decoder.up2_w):
            p.add_(0.01 * torch.randn(p.shape, generator=noise))
    return _tree_of(sam, init_sam_params(JCFG, jax.random.PRNGKey(0))), sam


def _image(rng, h=H, w=W):
    img = rng.integers(60, 200, (h, w, 3), dtype=np.uint8)
    yy, xx = np.ogrid[:h, :w]
    for _ in range(5):
        cy, cx = rng.integers(10, h - 10), rng.integers(10, w - 10)
        r = rng.integers(6, 20)
        img[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = rng.integers(0, 255, 3)
    return img


def _blob_masks(rng, n=6, h=40, w=56):
    """Masks with islands and holes of several sizes."""
    out = []
    for _ in range(n):
        m = rng.random((h, w)) < 0.04
        m = ndimage.binary_dilation(m, iterations=int(rng.integers(1, 4)))
        m &= ~(rng.random((h, w)) < 0.03)
        out.append(m)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_ops_match_jax_and_scipy(seed):
    rng = np.random.default_rng(seed)
    for m in _blob_masks(rng):
        rle = pnative.rle_encode(m)
        assert rle == jnative.rle_encode(m)
        np.testing.assert_array_equal(pnative.rle_decode(rle), m)
        np.testing.assert_array_equal(pnative.rle_decode(rle),
                                      jnative.rle_decode(rle))
        labels, areas = pnative.connected_components(m)
        jl, ja = jnative.connected_components(m)
        np.testing.assert_array_equal(labels, jl)
        np.testing.assert_array_equal(areas, ja)
        want, n = ndimage.label(m, structure=np.ones((3, 3), int))
        np.testing.assert_array_equal(labels, want)
        assert len(areas) == n + 1 and areas[0] == 0
        np.testing.assert_array_equal(areas[1:],
                                      np.bincount(want.ravel())[1:])
        for mode in ("holes", "islands"):
            for thresh in (3, 12, 40):
                got = pnative.remove_small_regions(m, thresh, mode)
                exp = jnative.remove_small_regions(m, thresh, mode)
                np.testing.assert_array_equal(got[0], exp[0])
                assert got[1] == exp[1]
    with pytest.raises(ValueError):
        pnative.remove_small_regions(m, 3, "both")


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """No numpy fallback: a source g++ cannot compile raises, and the
    library is built under build/torch_native, never beside the
    source."""
    bad = tmp_path / "maskops.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(pnative, "_SRC", bad)
    monkeypatch.setattr(pnative, "_BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(pnative, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        pnative.rle_encode(np.ones((2, 2), bool))
    assert not (tmp_path / "libmaskops.so").exists()
    monkeypatch.undo()
    assert pnative.library_path().parent.parent.name == "torch_native"
    assert pnative.library_path().parent.parent.parent.name == "build"


@pytest.mark.parametrize("seed", [0, 1])
def test_host_nms_matches_jax(seed):
    """nms_host and the C++ nms_native keep the JAX package's indices,
    ties (equal scores, stable order) and −inf padding included."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 80, (60, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 40, (60, 2))], 1)
    boxes = boxes.astype(np.float32)
    scores = rng.choice([0.2, 0.5, 0.9, 1.0], 60).astype(np.float32)
    for thresh in (0.3, 0.7):
        got = nms_host(boxes, scores, thresh)
        np.testing.assert_array_equal(got, jnms_host(boxes, scores, thresh))
        assert got.dtype == np.int64 and len(got) > 1
        np.testing.assert_array_equal(
            pnative.nms_native(boxes, scores, thresh),
            jnative.nms_native(boxes, scores, thresh))
    padded = scores.copy()
    padded[::3] = -np.inf
    got = nms_host(boxes, padded, 0.7)
    np.testing.assert_array_equal(got, jnms_host(boxes, padded, 0.7))
    assert not np.isin(got, np.arange(0, 60, 3)).any()


def test_box_and_mask_prompts_match_jax(models):
    tree, sam = models
    rng = np.random.default_rng(3)
    boxes = rng.uniform(0, 128, (3, 2, 4)).astype(np.float32)
    got = pprompt.embed_boxes(sam.prompt, PCFG, torch.from_numpy(boxes))
    want = jprompt.embed_boxes(tree, JCFG, jnp.asarray(boxes))
    assert got.shape == (3, 4, 32)
    assert _rel(got, want) <= 1e-5
    masks = (rng.standard_normal((2, 32, 32)) * 4).astype(np.float32)
    got = pprompt.embed_masks(sam.prompt, PCFG, torch.from_numpy(masks))
    want = jprompt.embed_masks(tree, JCFG, jnp.asarray(masks))
    assert got.shape == (2, 8, 8, 32) and got.dtype == torch.float32
    assert _rel(got, want) <= 1e-5


def _decoder_inputs(tree, sam, seed=4, n=5):
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((8, 8, 32)).astype(np.float32)
    pts = rng.uniform(0, 128, (n, 2, 2)).astype(np.float32)
    labels = np.array([[1, 0]] * n, np.int32)
    masks = (rng.standard_normal((n, 32, 32)) * 3).astype(np.float32)
    jpe = jprompt.dense_positional_embedding(tree, JCFG)[0]
    jsparse = jprompt.embed_points(tree, JCFG, jnp.asarray(pts),
                                   jnp.asarray(labels), pad=True)
    jdense = jprompt.embed_masks(tree, JCFG, jnp.asarray(masks))
    ppe = pprompt.dense_positional_embedding(sam.prompt, PCFG)[0]
    psparse = pprompt.embed_points(sam.prompt, PCFG, torch.from_numpy(pts),
                                   torch.from_numpy(labels), pad=True)
    pdense = pprompt.embed_masks(sam.prompt, PCFG, torch.from_numpy(masks))
    return ((jnp.asarray(emb), jpe, jsparse, jdense),
            (torch.from_numpy(emb), ppe, psparse, pdense))


@pytest.mark.parametrize("multimask", [True, False])
def test_general_decode_matches_jax(models, multimask):
    """Per-prompt dense prompts (mask prompts) through the general path,
    spatial output, multimask and single-mask."""
    tree, sam = models
    jin, pin = _decoder_inputs(tree, sam)
    want_m, want_iou = jdecode(tree, JCFG, *jin, multimask=multimask)
    got_m, got_iou = decode_masks(sam.decoder, PCFG, *pin,
                                  multimask=multimask, dense_shared=False)
    m = 3 if multimask else 1
    assert got_m.shape == (5, m, 32, 32) and got_m.dtype == torch.float32
    assert got_iou.shape == (5, m)
    assert _rel(got_m, want_m) <= REL
    assert _rel(got_iou, want_iou) <= REL


@pytest.mark.parametrize("rows", [6, None])
def test_shared_single_mask_decode_matches_jax(models, rows):
    """multimask=False on AMG's shared path: token 0's hypernetwork and
    IoU in block layout, with pad rows skipped and without."""
    tree, sam = models
    jin, pin = _decoder_inputs(tree, sam, seed=5)
    jnm = jprompt.no_mask_dense_embedding(tree, JCFG, 1)
    pnm = pprompt.no_mask_dense_embedding(sam.prompt, PCFG, 1)
    want_m, want_iou = jdecode(tree, JCFG, *jin[:3], jnm, multimask=False,
                               dense_shared=True, block_layout=True,
                               mask_rows=rows)
    got_m, got_iou = decode_masks(sam.decoder, PCFG, *pin[:3], pnm,
                                  mask_rows=rows, multimask=False)
    assert got_m.shape == (5, 8 * (rows or 8), 16, 1)
    assert got_iou.shape == (5, 1)
    assert _rel(got_m, want_m) <= REL
    assert _rel(got_iou, want_iou) <= REL


def test_decode_options_refuse_what_they_do_not_take(models):
    _, sam = models
    _, pin = _decoder_inputs(*models)
    with pytest.raises(ValueError, match="shared dense prompt"):
        decode_masks(sam.decoder, PCFG, *pin, decode="probs_split",
                     dense_shared=False)
    with pytest.raises(ValueError, match="multimask"):
        decode_masks(sam.decoder, PCFG, *pin, decode="fused_tail_logits",
                     multimask=False)
    with pytest.raises(ValueError, match="shared path"):
        decode_masks(sam.decoder, PCFG, *pin, mask_rows=4, dense_shared=False)


@pytest.mark.parametrize("hw,layers,ratio", [
    ((96, 128), 1, 512 / 1500), ((240, 320), 1, 512 / 1500),
    ((480, 640), 2, 512 / 1500), ((333, 250), 3, 0.25), ((61, 97), 2, 0.5)])
def test_generate_crop_boxes_matches_jax(hw, layers, ratio):
    assert (pamg.generate_crop_boxes(hw, layers, ratio)
            == jamg.generate_crop_boxes(hw, layers, ratio))


def test_amg_config_has_the_jax_fields_and_defaults():
    port = {f.name: f.default for f in dataclasses.fields(pamg.AmgConfig)}
    jax_ = {f.name: f.default for f in dataclasses.fields(jamg.AmgConfig)}
    assert port.pop("decode") == "shared"
    assert port == jax_


def _assert_records_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.segmentation, w.segmentation)
        assert g.area == w.area and g.bbox == w.bbox
        assert g.crop_box == w.crop_box
        np.testing.assert_array_equal(g.point_coords, w.point_coords)
        assert abs(g.predicted_iou - w.predicted_iou) <= 1e-4
        assert abs(g.stability_score - w.stability_score) <= 1e-4


@pytest.mark.parametrize("min_area", [0, 40])
def test_multicrop_records_match_jax(models, min_area):
    """crop_n_layers=1 (four 64 x 80 crops at 4 points a side), with and
    without the small-region post-processing: the JAX package's records,
    mask for mask, in its order; some come from the crops, and the
    post-processing changes some masks."""
    tree, sam = models
    img = _image(np.random.default_rng(11))
    kw = dict(AMG_KW, min_mask_region_area=min_area)
    want = jamg.generate_masks(tree, JCFG, img, jamg.AmgConfig(**kw))
    got = pamg.generate_masks(sam, img, pamg.AmgConfig(**kw))
    _assert_records_equal(got, want)
    crops = {r.crop_box for r in got}
    assert (0, 0, W, H) in crops and len(crops) > 1
    assert len(got) > 8
    for r in got:
        x0, y0, cw, ch = r.crop_box
        ys, xs = np.nonzero(r.segmentation)
        assert xs.min() >= x0 and xs.max() < x0 + cw
        assert ys.min() >= y0 and ys.max() < y0 + ch
        assert r.area > min_area
    if min_area:
        plain = pamg.generate_masks(
            sam, img, pamg.AmgConfig(**dict(kw, min_mask_region_area=0)))
        changed = sum(
            pnative.remove_small_regions(r.segmentation, min_area, m)[1]
            for r in plain for m in ("holes", "islands"))
        assert changed > 0


def test_small_region_postprocess_matches_jax():
    """Filled holes, removed islands, NMS preferring unchanged masks, keep
    order not re-sorted: the JAX function's masks and indices."""
    rng = np.random.default_rng(8)
    masks = _blob_masks(rng, n=10, h=60, w=80)
    for thresh, nms in ((10, 0.7), (40, 0.5)):
        got, gk = pamg._postprocess_small_regions(masks, thresh, nms)
        want, wk = jamg._postprocess_small_regions(masks, thresh, nms)
        np.testing.assert_array_equal(gk, wk)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_generate_masks_of_an_f32_sam_matches_jax(models):
    """The default served path as a whole: ``generate_masks`` of an f32
    SAM (the JAX package's default dtype) in one crop, against JAX's f32
    ``generate_masks`` from the same weights: the encoder, the "shared"
    decoder's plain versions of K1-K5, the filters and NMS give the JAX
    package's records in its order, each mask equal but for a pixel
    whose logit sits within f32 summation order of the threshold (1 of
    12,288 in one mask here)."""
    tree, sam = models
    assert sam.encoder.pos_embed.dtype == torch.float32
    img = _image(np.random.default_rng(13))
    kw = dict(AMG_KW, crop_n_layers=0)
    want = jamg.generate_masks(tree, JCFG, img, jamg.AmgConfig(**kw))
    got = pamg.generate_masks(sam, img, pamg.AmgConfig(**kw))
    assert len(got) == len(want) > 8
    for g, w in zip(got, want):
        assert (g.segmentation != w.segmentation).mean() <= 1e-3
        assert abs(g.area - w.area) <= 1e-3 * g.segmentation.size
        np.testing.assert_array_equal(g.point_coords, w.point_coords)
        assert abs(g.predicted_iou - w.predicted_iou) <= 1e-4


def test_generate_masks_batch_of_an_f32_sam_with_kernel_windows_matches_jax(
        models):
    """The slice as a whole: an f32 SAM with ``window_attention="kernel"``
    (B11 for the windowed layers and the 8x8 global one; B11 f32 on the
    card, its plain version here) through ``generate_masks_batch`` on two
    images, against JAX's f32 ``generate_masks_batch`` with ``_WINATTN =
    "on"`` (its Pallas window kernel in interpret mode) from the same
    weights: each image's records in JAX's order, each mask equal but for
    pixels within f32 summation order of the threshold (at most 1e-3 of
    a mask), predicted IoUs within 1e-4."""
    from revisit_anything_tpu.models.sam import encoder as jenc
    tree, sam = models
    rng = np.random.default_rng(17)
    imgs = [_image(rng) for _ in range(2)]
    kw = dict(AMG_KW, crop_n_layers=0)
    old = jenc._WINATTN
    try:
        jenc._WINATTN = "on"
        jenc.encode_image.clear_cache()
        want = jamg.generate_masks_batch(tree, JCFG, imgs,
                                         jamg.AmgConfig(**kw))
    finally:
        jenc._WINATTN = old
        jenc.encode_image.clear_cache()
    sam.encoder.window_attention = "kernel"
    try:
        got = pamg.generate_masks_batch(sam, imgs, pamg.AmgConfig(**kw))
    finally:
        sam.encoder.window_attention = "plain"
    for got_i, want_i in zip(got, want):
        assert len(got_i) == len(want_i) > 8
        for g, w in zip(got_i, want_i):
            assert (g.segmentation != w.segmentation).mean() <= 1e-3
            np.testing.assert_array_equal(g.point_coords, w.point_coords)
            assert abs(g.predicted_iou - w.predicted_iou) <= 1e-4


def test_multicrop_with_one_crop_is_generate_masks(models):
    _, sam = models
    img = _image(np.random.default_rng(9))
    amg = pamg.AmgConfig(**dict(AMG_KW, crop_n_layers=0))
    _assert_records_equal(pamg._generate_multicrop(sam, img, amg, 512),
                          pamg.generate_masks(sam, img, amg))
    both = pamg.generate_masks_batch(
        sam, [img, img], pamg.AmgConfig(**AMG_KW), max_masks=5)
    assert [len(b) for b in both] == [5, 5]
    _assert_records_equal(both[0], both[1])


@pytest.fixture(scope="module")
def predictors(models):
    tree, sam = models
    img = _image(np.random.default_rng(12), 80, 112)
    jp, pp = JPredictor(tree, JCFG), SamPredictor(sam)
    jp.set_image(img)
    pp.set_image(img)
    return jp, pp


def _same_prediction(got, want, return_logits=False):
    (gm, gi, gl), (wm, wi, wl) = got, want
    assert gm.shape == wm.shape and gm.dtype == wm.dtype
    assert _rel(gl, wl) <= REL and _rel(gi, wi) <= REL
    if return_logits:
        assert _rel(gm, wm) <= REL
    else:
        np.testing.assert_array_equal(gm, wm)


def test_predictor_matches_jax(predictors):
    jp, pp = predictors
    assert _rel(pp.get_image_embedding(), jp.get_image_embedding()) <= REL
    prompts = [
        dict(point_coords=np.array([[50, 30]]), point_labels=np.array([1])),
        dict(point_coords=np.array([[20, 20], [70, 50]]),
             point_labels=np.array([1, 0]), multimask_output=False),
        dict(box=np.array([10, 10, 60, 50]), multimask_output=False),
        dict(point_coords=np.array([[30, 40]]), point_labels=np.array([1]),
             box=np.array([10, 10, 60, 50]), return_logits=True),
    ]
    for kw in prompts:
        got, want = pp.predict(**kw), jp.predict(**kw)
        m = 3 if kw.get("multimask_output", True) else 1
        assert got[0].shape == (m, 80, 112) and got[2].shape == (m, 32, 32)
        _same_prediction(got, want, kw.get("return_logits", False))
    # the best low-res logits fed back as a mask prompt
    masks, iou, low = pp.predict(point_coords=np.array([[50, 30]]),
                                 point_labels=np.array([1]))
    best = low[int(np.argmax(iou))][None]
    kw = dict(point_coords=np.array([[50, 30]]), point_labels=np.array([1]),
              mask_input=best, multimask_output=False)
    _same_prediction(pp.predict(**kw), jp.predict(**kw))


def test_predictor_raises_as_jax_does(models, predictors):
    tree, sam = models
    for fresh in (SamPredictor(sam), JPredictor(tree, JCFG)):
        with pytest.raises(AssertionError):
            fresh.predict(point_coords=np.array([[5, 5]]),
                          point_labels=np.array([1]))
    for p in predictors:
        with pytest.raises(ValueError):
            p.predict()
        with pytest.raises(AssertionError, match="point_labels"):
            p.predict(point_coords=np.array([[5, 5]]))


def test_exported_decoder_round_trip(models, tmp_path):
    """torch.export of the general path at 4 prompts, saved and loaded:
    equal to the eager function, and to the JAX package's decode
    function on the same inputs."""
    tree, sam = models
    path = str(tmp_path / "decoder.pt2")
    pexport.export_decoder(sam, path, num_prompts=4)
    loaded = pexport.load_decoder(path)
    rng = np.random.default_rng(13)
    emb = rng.standard_normal((8, 8, 32)).astype(np.float32)
    pts = rng.uniform(0, 128, (4, 2)).astype(np.float32)
    got = loaded(torch.from_numpy(emb), torch.from_numpy(pts))
    eager = pexport.make_decode_fn(sam, 4)(torch.from_numpy(emb),
                                           torch.from_numpy(pts))
    want = jexport.make_decode_fn(tree, JCFG, 4)(jnp.asarray(emb),
                                                 jnp.asarray(pts))
    for g, e, w in zip(got, eager, want):
        assert g.shape == e.shape == w.shape
        assert torch.equal(g, e)
        assert _rel(g, w) <= REL
    assert got[0].shape == (4, 3, 32, 32)


def test_mask_prompt_weights_are_carried(models):
    """sam_from_jax_params loads mask_down from a JAX tree."""
    tree, sam = models
    again = sam_from_jax_params(jax.tree_util.tree_map(np.asarray, tree),
                                PCFG, device="cpu")
    for name, p in sam.prompt.mask_down.named_parameters():
        assert torch.equal(dict(again.prompt.mask_down.named_parameters())[
            name], p), name
    assert float(sam.prompt.mask_down.conv1_w.abs().sum()) > 0
