"""Port parity: SAM image encoder, prompt encoder, mask decoder, the AMG
decode batch and NMS against the JAX package on a tiny config with both
windowed and global encoder layers (f32 on both sides)."""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from revisit_anything_tpu.models.sam import SamArchConfig, init_sam_params
from revisit_anything_tpu.models.sam import amg as jamg
from revisit_anything_tpu.models.sam import decoder as jdec_mod
from revisit_anything_tpu.models.sam.decoder import decode_masks as jdecode
from revisit_anything_tpu.models.sam.encoder import encode_image
from revisit_anything_tpu.models.sam import prompt as jprompt
from revisit_anything_tpu.ops.nms import nms_keep_mask as jnms
from revisit_anything_tpu_torch.models.sam import SamArchConfig as PortCfg
from revisit_anything_tpu_torch.models.sam import amg as pamg
from revisit_anything_tpu_torch.models.sam import prompt as pprompt
from revisit_anything_tpu_torch.models.sam.decoder import decode_masks
from revisit_anything_tpu_torch.ops.nms import nms_keep_mask
from revisit_anything_tpu_torch.weights import sam_from_jax_params

torch.set_float32_matmul_precision("highest")

# window 4 on an 8x8 grid (4 windows) and one global layer
KW = dict(encoder_dim=64, encoder_depth=2, encoder_heads=4,
          global_attn_indexes=(1,), image_size=128, patch_size=16,
          window_size=4, prompt_dim=32, decoder_heads=4, decoder_mlp_dim=128,
          iou_head_hidden=32)
JCFG = SamArchConfig(**KW)
PCFG = PortCfg(**KW)
REL = 1e-4     # f32 both sides: summation order and reassociation only


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)


@pytest.fixture(scope="module")
def models():
    """JAX params with every leaf perturbed (non-zero biases and rel-pos
    tables), and the port's Sam converted from the same numpy tree."""
    params = init_sam_params(JCFG, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    tree = jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + 0.05 * rng.standard_normal(x.shape)
                   ).astype(np.float32), params)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    return jparams, sam_from_jax_params(tree, PCFG, device="cpu")


@pytest.fixture(scope="module")
def embedding(models):
    jparams, sam = models
    rng = np.random.default_rng(1)
    img = rng.standard_normal((1, 128, 128, 3)).astype(np.float32)
    want = np.array(encode_image(jparams, JCFG, jnp.asarray(img)))
    with torch.inference_mode():
        got = sam.encoder(torch.from_numpy(img)).numpy()
    return want, got


def test_encoder_matches_jax(embedding):
    want, got = embedding
    assert got.shape == want.shape == (1, 8, 8, 32)
    assert _rel(got, want) < REL


def test_prompt_embeddings_match_jax(models):
    jparams, sam = models
    rng = np.random.default_rng(2)
    coords = (rng.random((5, 1, 2)) * 128).astype(np.float32)
    labels = np.ones((5, 1), np.int32)
    want = np.array(jprompt.embed_points(jparams, JCFG, coords, labels))
    got = pprompt.embed_points(sam.prompt, PCFG, torch.from_numpy(coords),
                               torch.from_numpy(labels)).numpy()
    assert _rel(got, want) < REL
    want = np.array(jprompt.dense_positional_embedding(jparams, JCFG))
    got = pprompt.dense_positional_embedding(sam.prompt, PCFG).numpy()
    assert _rel(got, want) < REL


def _grid_points(n=6, size=128):
    return (jamg.build_point_grid(n) * size).astype(np.float32)


def test_decoder_matches_jax(models, embedding):
    jparams, sam = models
    emb = embedding[0][0]
    pe = np.array(jprompt.dense_positional_embedding(jparams, JCFG))[0]
    pts = _grid_points()
    sparse = np.array(jprompt.embed_points(
        jparams, JCFG, pts[:, None], np.ones((len(pts), 1), np.int32)))
    dense = np.array(jprompt.no_mask_dense_embedding(jparams, JCFG, 1))
    want_m, want_iou = map(np.asarray, jdecode(
        jparams, JCFG, emb, pe, sparse, dense, multimask=True,
        dense_shared=True, block_layout=True, mask_rows=6))
    with torch.inference_mode():
        got_m, got_iou = decode_masks(
            sam.decoder, PCFG, *(torch.from_numpy(x) for x in
                                 (emb, pe, sparse, dense)), mask_rows=6)
    assert got_m.shape == want_m.shape == (len(pts), 48, 16, 3)
    assert _rel(got_m.numpy(), want_m) < REL
    assert _rel(got_iou.numpy(), want_iou) < REL


# the JAX decoder's trace-time flags (_PROBS_PATH, _FUSED_TAIL,
# _TAIL_KEYS) for each of the port's AmgConfig.decode forms;
# "fused_tail_logits" is held to the JAX keys path, which computes the
# function the JAX logits mode means to (test_torch_decode_fused.py)
JAX_DECODE_FLAGS = {"shared": ("off", "auto", "auto"),
                    "probs_split": ("on", "off", "auto"),
                    "fused_tail_probs": ("on", "on", "off"),
                    "fused_tail_keys": ("on", "on", "on"),
                    "fused_tail_logits": ("on", "on", "on")}


@contextlib.contextmanager
def jax_decode_flags(decode):
    """The JAX decode flags set to ``decode``'s form. They are read at
    trace time, so the jitted ``decode_masks`` and ``_decode_batch``
    caches are cleared on the way in and out."""
    names = ("_PROBS_PATH", "_FUSED_TAIL", "_TAIL_KEYS")
    old = [getattr(jdec_mod, n) for n in names]

    def clear():
        jdecode.clear_cache()
        jamg._decode_batch.clear_cache()

    for n, v in zip(names, JAX_DECODE_FLAGS[decode]):
        setattr(jdec_mod, n, v)
    clear()
    try:
        yield
    finally:
        for n, v in zip(names, old):
            setattr(jdec_mod, n, v)
        clear()


@pytest.mark.parametrize("decode", list(JAX_DECODE_FLAGS))
@pytest.mark.parametrize("orig_hw", [(112, 112), (84, 112)])
def test_decode_batch_matches_jax(models, embedding, orig_hw, decode):
    jparams, sam = models
    emb = embedding[0][0]
    pe = np.array(jprompt.dense_positional_embedding(jparams, JCFG))[0]
    input_hw = jamg.resize_longest_side(*orig_hw, 128)
    amg_j = jamg.AmgConfig(points_per_side=6, points_per_batch=36)
    amg_p = pamg.AmgConfig(points_per_side=6, points_per_batch=36,
                           decode=decode)
    pts = _grid_points()
    with jax_decode_flags(decode):
        want = [np.asarray(x) for x in jamg._decode_batch(
            jparams, JCFG, jnp.asarray(emb), jnp.asarray(pe),
            jnp.asarray(pts), input_hw, orig_hw, amg_j)]
    with torch.inference_mode():
        got = [x.numpy() for x in pamg._decode_batch(
            sam, PCFG, torch.from_numpy(emb), torch.from_numpy(pe),
            torch.from_numpy(pts), input_hw, orig_hw, amg_p)]
    masks, iou, stab, boxes = got
    assert masks.shape == want[0].shape
    assert 0.0 < masks.mean() < 1.0           # the masks are not trivial
    assert (masks != want[0]).mean() <= 1e-4
    assert _rel(iou, want[1]) <= 1e-4
    # stability and boxes are integer reductions of the masks: exact
    # wherever the masks agree
    same = (masks == want[0]).all(axis=(1, 2))
    np.testing.assert_array_equal(stab[same], want[2][same])
    np.testing.assert_array_equal(boxes[same], want[3][same])


def test_unknown_amg_decode_raises():
    assert pamg.AmgConfig().decode == "shared"
    with pytest.raises(ValueError, match="decode"):
        pamg.AmgConfig(decode="fused")


def test_entry_points_default_to_the_card():
    """The port runs on the card unless the caller asks for the CPU: the
    constructors and weight builders default to ``device="cuda"``."""
    import inspect

    from revisit_anything_tpu_torch import weights
    from revisit_anything_tpu_torch.models.dinov2 import DinoV2
    from revisit_anything_tpu_torch.models.sam import Sam
    from revisit_anything_tpu_torch.models.sam.decoder import MaskDecoder
    from revisit_anything_tpu_torch.models.sam.encoder import ImageEncoder
    from revisit_anything_tpu_torch.models.sam.prompt import PromptEncoder
    for fn in (weights.sam_from_jax_params, weights.dino_from_jax_params,
               weights.init_sam, weights.init_dino, Sam, DinoV2,
               ImageEncoder, PromptEncoder, MaskDecoder):
        default = inspect.signature(fn).parameters["device"].default
        assert default == "cuda", (fn.__name__, default)


def test_resize_mats_match_jax_unrounded():
    for orig in ((240, 320), (480, 640), (84, 112)):
        cfg_j = jamg.resize_mats_and_rows
        inp = jamg.resize_longest_side(*orig, 1024)
        wh, ww, gh = cfg_j(SamArchConfig(1280, 32, 16, (7, 15, 23, 31)),
                           inp, orig, on_tpu=False)
        pwh, pww, pgh = pamg.resize_mats_and_rows(
            PortCfg(1280, 32, 16, (7, 15, 23, 31)), inp, orig)
        assert pgh == gh
        np.testing.assert_array_equal(pwh, wh)
        np.testing.assert_array_equal(pww, ww)
    assert pamg.resize_mats_and_rows(
        PortCfg(1280, 32, 16, (7, 15, 23, 31)), (768, 1024), (240, 320))[2] \
        == 49


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nms_keep_mask_matches_jax_exactly(seed):
    rng = np.random.default_rng(seed)
    n = 300
    xy = rng.integers(0, 80, (n, 2))
    wh = rng.integers(1, 40, (n, 2))
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    scores = rng.random(n).astype(np.float32)
    scores[rng.random(n) < 0.2] = -np.inf
    want = np.asarray(jnms(jnp.asarray(boxes), jnp.asarray(scores), 0.5))
    got = nms_keep_mask(torch.from_numpy(boxes), torch.from_numpy(scores),
                        0.5).numpy()
    np.testing.assert_array_equal(got, want)


def test_point_segmenter_keeps_many_blob_masks():
    """``weights.plant_point_segmenter`` turns a random SAM into one whose
    point prompts segment blobs around their points, so AMG keeps many
    distinct, moderately sized masks (random weights alone keep one)."""
    from revisit_anything_tpu_torch.models.sam import Sam
    from revisit_anything_tpu_torch.pipeline.serve import (
        _select_masks_centroids)
    from revisit_anything_tpu_torch.weights import (init_sam,
                                                    plant_point_segmenter)
    cfg = PortCfg(encoder_dim=256, encoder_depth=2, encoder_heads=4,
                  global_attn_indexes=(1,), image_size=256, window_size=8)
    gen = torch.Generator().manual_seed(0)
    sam: Sam = init_sam(cfg, gen, "cpu", torch.float32)
    plant_point_segmenter(sam, gen)
    rng = np.random.default_rng(0)
    img = (rng.standard_normal((1, 256, 256, 3)) * 0.5).astype(np.float32)
    amg = pamg.AmgConfig(points_per_side=16, points_per_batch=256,
                         pred_iou_thresh=-1e9, stability_score_thresh=0.0)
    pts = pamg.build_point_grid(16) * 256.0
    with torch.inference_mode():
        emb = sam.encoder(torch.from_numpy(img))[0]
        image_pe = pprompt.dense_positional_embedding(sam.prompt, cfg)[0]
        masks, iou, stab, boxes = pamg._decode_batch(
            sam, cfg, emb, image_pe, torch.from_numpy(pts).float(),
            (256, 256), (128, 128), amg)
        valid = torch.ones(iou.shape[0], dtype=torch.bool)
        sel, stats = _select_masks_centroids(masks, iou, stab, boxes, valid,
                                             amg, 128)
    n = int(stats[-1])
    area = sel[:n].float().mean((1, 2))
    assert n >= 32
    assert 0.005 < float(area.median()) < 0.2
    assert int((area == 0).sum()) <= n // 10


@pytest.mark.parametrize("q_size,k_size,table", [
    (4, 4, 7),       # the table's own size: a gather only
    (4, 4, 11),      # resized table (linear interpolation) first
    (3, 6, 11),      # unequal sizes: scaled coordinates
    (6, 3, 9),
])
def test_rel_pos_gather_matches_jax_with_a_cached_index(q_size, k_size,
                                                        table):
    """The port builds the relative-coordinate index once per (sizes,
    device) and gathers on the device; the index equals a fresh
    computation and the gathered table matches JAX ``_rel_pos_gather``."""
    from revisit_anything_tpu.models.sam.encoder import _rel_pos_gather
    from revisit_anything_tpu_torch.models.sam import encoder as penc
    rng = np.random.default_rng(table + q_size)
    rel_pos = rng.standard_normal((table, 8)).astype(np.float32)
    idx = penc.rel_pos_index(q_size, k_size, "cpu")
    assert penc.rel_pos_index(q_size, k_size, "cpu") is idx
    fresh = ((np.arange(q_size)[:, None] * max(k_size / q_size, 1.0)
              - np.arange(k_size)[None, :] * max(q_size / k_size, 1.0))
             + (k_size - 1) * max(q_size / k_size, 1.0)).astype(np.int64)
    np.testing.assert_array_equal(idx.numpy(), fresh)
    want = np.asarray(_rel_pos_gather(jnp.asarray(rel_pos), q_size, k_size))
    for _ in range(2):                 # the second call reads the caches
        got = penc.rel_pos_gather(torch.from_numpy(rel_pos), q_size,
                                  k_size).numpy()
        assert got.shape == want.shape == (q_size, k_size, 8)
        assert _rel(got, want) < 1e-6


def test_sam_preprocess_keeps_its_bits():
    """The cached normalization constants give the bits the per-call
    uploads gave."""
    from revisit_anything_tpu_torch.models.sam import (SAM_PIXEL_MEAN,
                                                       SAM_PIXEL_STD)
    from revisit_anything_tpu_torch.ops.resize import bilinear_weight_matrix
    from revisit_anything_tpu_torch.pipeline.serve import (
        _sam_preprocess_fused)
    rng = np.random.default_rng(3)
    img = torch.from_numpy(rng.integers(0, 256, (60, 80, 3), dtype=np.uint8))
    rh = torch.from_numpy(bilinear_weight_matrix(48, 60))
    rw = torch.from_numpy(bilinear_weight_matrix(64, 80))
    x = torch.einsum("pw,owc->opc", rw,
                     torch.einsum("oh,hwc->owc", rh, img.float()))
    x = torch.clamp(torch.round(x), 0.0, 255.0)
    x = (x - torch.tensor(SAM_PIXEL_MEAN)) / torch.tensor(SAM_PIXEL_STD)
    want = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, 16))[None]
    for _ in range(2):
        with torch.inference_mode():
            got = _sam_preprocess_fused(img, rh, rw, 64)
        assert torch.equal(got, want)
