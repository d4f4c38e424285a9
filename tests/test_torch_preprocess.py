"""SAM's host downscale against the JAX package on the CPU: an image
larger than SAM's frame is resized by PIL's antialiased bilinear filter
on the host (``amg.preprocess_image``), bit for bit the JAX package's
array, and the predictor and AMG then accept it and answer as the JAX
package does on the same weights (f32 both sides; tolerance REL 1e-4 of
the output's scale, summation order only)."""

import numpy as np
import pytest
import torch

from revisit_anything_tpu.models.sam import SAM_VIT_H as J_VIT_H
from revisit_anything_tpu.models.sam import amg as jamg
from revisit_anything_tpu.models.sam.predictor import (
    SamPredictor as JPredictor)
from revisit_anything_tpu_torch.models.sam import SAM_VIT_H as P_VIT_H
from revisit_anything_tpu_torch.models.sam import amg as pamg
from revisit_anything_tpu_torch.models.sam.predictor import SamPredictor
from tests.test_torch_sam_tools import (JCFG, REL, _assert_records_equal,
                                        _image, _same_prediction)
from tests.test_torch_sam_tools import models  # noqa: F401 (fixture)

torch.set_float32_matmul_precision("highest")


@pytest.mark.parametrize("hw", [(1200, 1600), (1600, 1200), (2048, 2048)])
def test_preprocess_image_is_jax_bit_for_bit(hw):
    """Camera-sized images into SAM ViT-H's 1024 frame."""
    img = np.random.default_rng(sum(hw)).integers(0, 256, (*hw, 3),
                                                  dtype=np.uint8)
    got, got_hw = pamg.preprocess_image(img, P_VIT_H, device="cpu")
    want, want_hw = jamg.preprocess_image(img, J_VIT_H)
    assert got_hw == want_hw and max(got_hw) == 1024
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("hw", [(600, 800), (1200, 1600), (1024, 1025)])
def test_preprocess_any_takes_the_jax_path(hw):
    """``_preprocess_any`` upscales on the device where the image fits the
    frame and downscales by PIL where it does not (it used to raise):
    the JAX function's array either way (the device path within one
    uint8 level's normalized step, the host path exactly)."""
    img = np.random.default_rng(hw[1]).integers(0, 256, (*hw, 3),
                                                dtype=np.uint8)
    got, got_hw = pamg._preprocess_any(img, P_VIT_H, "cpu")
    want, want_hw = jamg._preprocess_any(img, J_VIT_H)
    assert got_hw == want_hw
    want = np.asarray(want)
    if want_hw[0] < hw[0]:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        assert np.abs(got.numpy() - want).max() <= 1.0 / 57.12 + 1e-5


@pytest.fixture(scope="module")
def big_predictors(models):  # noqa: F811
    """Both predictors on a 150x200 image, larger than the 128 frame."""
    tree, sam = models
    img = _image(np.random.default_rng(21), 150, 200)
    jp, pp = JPredictor(tree, JCFG), SamPredictor(sam)
    jp.set_image(img)
    pp.set_image(img)
    return jp, pp


def test_predictor_on_a_downscaled_image_matches_jax(big_predictors):
    jp, pp = big_predictors
    assert pp._input_hw == jp._input_hw == (96, 128)
    assert _rel_emb(pp, jp) <= REL
    for kw in (dict(point_coords=np.array([[90, 60]]),
                    point_labels=np.array([1])),
               dict(box=np.array([20, 15, 120, 100]),
                    multimask_output=False),
               dict(point_coords=np.array([[40, 40], [150, 110]]),
                    point_labels=np.array([1, 0]), return_logits=True)):
        got, want = pp.predict(**kw), jp.predict(**kw)
        m = 3 if kw.get("multimask_output", True) else 1
        assert got[0].shape == (m, 150, 200)
        _same_prediction(got, want, kw.get("return_logits", False))


def _rel_emb(pp, jp):
    a = pp.get_image_embedding().numpy().astype(np.float64)
    b = np.asarray(jp.get_image_embedding(), np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("hw", [(150, 200), (200, 140)])
def test_generate_masks_on_a_downscaled_image_matches_jax(models, hw):  # noqa: F811,E501
    """AMG records of an image larger than the frame, mask for mask."""
    tree, sam = models
    img = _image(np.random.default_rng(hw[0]), *hw)
    kw = dict(points_per_side=8, points_per_batch=64, pred_iou_thresh=-1e9,
              stability_score_thresh=0.0)
    want = jamg.generate_masks(tree, JCFG, img, jamg.AmgConfig(**kw))
    got = pamg.generate_masks(sam, img, pamg.AmgConfig(**kw))
    _assert_records_equal(got, want)
    assert len(got) > 8
    assert got[0].segmentation.shape == hw
    # the batch entry point takes the same path
    _assert_records_equal(pamg.generate_masks_batch(
        sam, [img], pamg.AmgConfig(**kw))[0], got)
