"""Port parity of the other backbones and the model hub: the helpers
(position embeddings, resizes, soft VLAD, DINOv2's preprocess and
forward_tokens), DINOv1 with its strided grid, head-minor facets and log
binning, the CosPlace ViT, ResNet (basic and bottleneck, cropped), the
three dense-feature h5 drivers (read both ways) and ``hub.load_model``.
Small models, seeded numpy inputs, the JAX package on the CPU and the
port from the same weights (``weights.py``); f32 throughout."""

import h5py
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from revisit_anything_tpu import hub as jhub
from revisit_anything_tpu.io import h5io as jio
from revisit_anything_tpu.models import cosplace_vit as jcv
from revisit_anything_tpu.models import dinov1 as jd1
from revisit_anything_tpu.models import dinov2 as jdn
from revisit_anything_tpu.models import resnet as jrn
from revisit_anything_tpu.ops import posembed as jpe
from revisit_anything_tpu.ops import resize as jrs
from revisit_anything_tpu.ops import vlad as jvl
from revisit_anything_tpu.pipeline import extract as jext
from revisit_anything_tpu.training import aggregators as jag
from revisit_anything_tpu.training import vladbuff as jvb
from revisit_anything_tpu_torch import hub
from revisit_anything_tpu_torch.io import h5io as pio
from revisit_anything_tpu_torch.models import cosplace_vit as pcv
from revisit_anything_tpu_torch.models import dinov1 as pd1
from revisit_anything_tpu_torch.models import dinov2 as pdn
from revisit_anything_tpu_torch.models import resnet as prn
from revisit_anything_tpu_torch.models.layers import module_tree
from revisit_anything_tpu_torch.ops import posembed as ppe
from revisit_anything_tpu_torch.ops import resize as prs
from revisit_anything_tpu_torch.ops import vlad as pvl
from revisit_anything_tpu_torch.pipeline import extract as pext
from revisit_anything_tpu_torch.training import vladbuff as pvb
from revisit_anything_tpu_torch.weights import (cosplace_from_jax_params,
                                                dino_from_jax_params,
                                                resnet_from_jax_params,
                                                vpr_from_jax_params)

torch.set_float32_matmul_precision("highest")
CPU = "cpu"
# f32 forwards in both packages, sums in another order: relative to the
# output's scale
F32_REL = 2e-5


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


TINY1 = dict(embed_dim=32, depth=3, num_heads=2, patch_size=8,
             layerscale=False, pretrain_grid=(4, 4))


def _dinov1(seed=0):
    jcfg = jdn.DinoV2Config(**TINY1)
    params = jax.device_get(jdn.init_params(jcfg, jax.random.PRNGKey(seed)))
    pcfg = pdn.DinoV2Config(**TINY1)
    return params, jcfg, dino_from_jax_params(params, pcfg, device=CPU), pcfg


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def test_posembed_is_bit_identical():
    for dim, grid, cls in ((16, 4, False), (64, 14, True), (768, 14, True)):
        a = jpe.get_2d_sincos_pos_embed(dim, grid, cls)
        b = ppe.get_2d_sincos_pos_embed(dim, grid, cls)
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("out_hw", [(7, 9), (20, 13), (5, 5)])
def test_resizes_match_jax(rng, out_hw):
    """nearest, bilinear (both corner conventions) and bicubic, with and
    without explicit coordinate scales: the weight matrices bit for bit,
    the resized arrays within f32 rounding (1e-6 of the scale)."""
    x = rng.standard_normal((2, 3, 11, 10)).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(jrs.nearest_resize(jnp.asarray(x), out_hw)),
        prs.nearest_resize(_t(x), out_hw).numpy())
    for fj, fp in ((jrs.bilinear_resize_torch, prs.bilinear_resize_torch),
                   (jrs.bilinear_resize_align_corners,
                    prs.bilinear_resize_align_corners)):
        assert _rel(fp(_t(x), out_hw).numpy(),
                    np.asarray(fj(jnp.asarray(x), out_hw))) < 1e-6
    grid = rng.standard_normal((6, 5, 4)).astype(np.float32)
    for scales in ((None, None), (6 / (out_hw[0] + 0.1),
                                  5 / (out_hw[1] + 0.1))):
        assert np.array_equal(
            jrs.bicubic_weight_matrix(out_hw[0], 6, coord_scale=scales[0]),
            prs.bicubic_weight_matrix(out_hw[0], 6, coord_scale=scales[0]))
        assert _rel(prs.bicubic_resize_torch(_t(grid), out_hw,
                                             scales).numpy(),
                    np.asarray(jrs.bicubic_resize_torch(
                        jnp.asarray(grid), out_hw, scales))) < 1e-6


def test_soft_vlad_and_center_residuals_match_jax(rng):
    desc = rng.standard_normal((40, 16)).astype(np.float32)
    centers = rng.standard_normal((5, 16)).astype(np.float32)
    for temp, intra in ((1.0, True), (10.0, False)):
        assert _rel(pvl.soft_global_vlad(_t(desc), _t(centers), temp,
                                         intra).numpy(),
                    np.asarray(jvl.soft_global_vlad(
                        desc, centers, temp, intra_norm=intra))) < 1e-5
    assert _rel(pvl.concat_center_residuals(_t(centers), _t(desc)).numpy(),
                np.asarray(jvl.concat_center_residuals(centers, desc))) < 1e-6


def test_preprocess_and_forward_tokens_match_jax(rng):
    imgs = rng.integers(0, 256, (2, 31, 45, 3), dtype=np.uint8)
    xj, xp = jdn.preprocess(imgs), pdn.preprocess(imgs)
    assert xp.shape == (2, 28, 42, 3) and np.array_equal(xj, xp)
    kw = dict(embed_dim=32, depth=3, num_heads=2, pretrain_grid=(3, 3))
    jcfg, pcfg = jdn.DinoV2Config(**kw), pdn.DinoV2Config(**kw)
    params = jax.device_get(jdn.init_params(jcfg, jax.random.PRNGKey(3)))
    model = dino_from_jax_params(params, pcfg, device=CPU)
    for nb, norm in ((None, True), (2, False)):
        want = np.asarray(jdn.forward_tokens(params, jcfg, jnp.asarray(xj),
                                             nb, norm))
        got = pdn.forward_tokens(model, pcfg, _t(xp), nb, norm)
        assert got.shape == want.shape == (2, 1 + 6, 32)
        assert _rel(got.numpy(), want) < F32_REL


# ---------------------------------------------------------------------------
# DINOv1
# ---------------------------------------------------------------------------


def test_dinov1_configs_and_grid():
    for name, jc in jd1.CONFIGS.items():
        pc = pd1.CONFIGS[name]
        assert (pc.embed_dim, pc.depth, pc.num_heads, pc.patch_size,
                pc.layerscale, pc.pretrain_grid) == (
            jc.embed_dim, jc.depth, jc.num_heads, jc.patch_size,
            jc.layerscale, jc.pretrain_grid)
    assert pd1.strided_grid(224, 298, 8, 4) == (55, 73)


@pytest.mark.parametrize("facet,use_cls,stride", [
    ("key", False, 4), ("query", True, 4), ("value", False, 8),
    ("token", True, 4)])
def test_dinov1_extract_dense_matches_jax(rng, facet, use_cls, stride):
    """The strided patch embedding (+0.1 offset position resize), the
    blocks, and the facet in the reference's head-minor channel order."""
    params, jcfg, model, pcfg = _dinov1()
    imgs = rng.standard_normal((2, 40, 48, 3)).astype(np.float32)
    want = np.asarray(jd1.extract_dense(params, jcfg, jnp.asarray(imgs), 2,
                                        facet, stride, use_cls))
    got = pd1.extract_dense(model, pcfg, _t(imgs), 2, facet, stride,
                            use_cls).numpy()
    gh, gw = pd1.strided_grid(40, 48, 8, stride)
    assert got.shape == want.shape == (2, gh * gw + use_cls, 32)
    assert _rel(got, want) < F32_REL


def test_dinov1_log_bin_matches_jax(rng):
    feats = rng.standard_normal((2, 7 * 9, 6)).astype(np.float32)
    for hierarchy in (1, 2, 3):
        want = np.asarray(jd1.log_bin(jnp.asarray(feats), (7, 9), hierarchy))
        got = pd1.log_bin(_t(feats), (7, 9), hierarchy).numpy()
        assert got.shape == want.shape == (2, 63, 6 * (1 + 8 * hierarchy))
        assert _rel(got, want) < 1e-6


# ---------------------------------------------------------------------------
# CosPlace ViT and ResNet
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("facet,use_cls,norm", [
    ("value", False, True), ("query", True, False), ("key", False, True),
    ("token", False, False)])
def test_cosplace_vit_matches_jax(rng, facet, use_cls, norm):
    kw = dict(embed_dim=64, depth=3, num_heads=4, patch_size=8,
              image_size=32, intermediate=128)
    jcfg, pcfg = jcv.HfViTConfig(**kw), pcv.HfViTConfig(**kw)
    assert pcfg.eps == 1e-12
    params = jax.device_get(jcv.init_params(jcfg, jax.random.PRNGKey(4)))
    model = cosplace_from_jax_params(params, pcfg, device=CPU)
    imgs = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jcv.extract_features(params, jcfg, jnp.asarray(imgs),
                                           2, facet, use_cls, norm))
    got = pcv.extract_features(model, pcfg, _t(imgs), 2, facet, use_cls,
                               norm).numpy()
    assert got.shape == want.shape == (2, 16 + use_cls, 64)
    assert _rel(got, want) < F32_REL


def test_cosplace_converter_matches_jax(rng):
    """The transformers ViTModel layout → the same leaves in both."""
    cfg = dict(embed_dim=16, depth=1, num_heads=2, patch_size=8,
               image_size=16, intermediate=32)
    d, m = 16, 32
    sd = {"embeddings.cls_token": (1, 1, d),
          "embeddings.position_embeddings": (1, 5, d),
          "embeddings.patch_embeddings.projection.weight": (d, 3, 8, 8),
          "embeddings.patch_embeddings.projection.bias": (d,),
          "layernorm.weight": (d,), "layernorm.bias": (d,)}
    p = "encoder.layer.0"
    for name, shape in (("layernorm_before", (d,)),
                        ("layernorm_after", (d,)),
                        ("attention.attention.query", (d, d)),
                        ("attention.attention.key", (d, d)),
                        ("attention.attention.value", (d, d)),
                        ("attention.output.dense", (d, d)),
                        ("intermediate.dense", (m, d)),
                        ("output.dense", (d, m))):
        sd[f"{p}.{name}.weight"] = shape
        sd[f"{p}.{name}.bias"] = (shape[0],)
    sd = {k: rng.standard_normal(s).astype(np.float32) for k, s in sd.items()}
    want = jax.device_get(jcv.convert_hf_vit_state_dict(
        sd, jcv.HfViTConfig(**cfg)))
    model = pcv.convert_hf_vit_state_dict(
        {k: _t(v) for k, v in sd.items()}, pcv.HfViTConfig(**cfg),
        device=CPU)
    got = module_tree(model)
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    for path, leaf in flat_w:
        node = got
        for key in path:
            node = node[getattr(key, "key", getattr(key, "idx", None))]
        np.testing.assert_array_equal(node, np.asarray(leaf))


@pytest.mark.parametrize("name,crop", [("basic", ()), ("bottleneck", ()),
                                       ("bottleneck", (4,)),
                                       ("basic", (4, 3))])
def test_resnet_matches_jax(rng, name, crop):
    """Small ResNets (width 8) from one torchvision-layout state dict:
    the converted trees leaf for leaf, then the forwards."""
    layers = (1, 2, 1, 1)
    jcfg = jrn.ResNetConfig(name, layers, width=8, layers_to_crop=crop)
    pcfg = prn.ResNetConfig(name, layers, width=8, layers_to_crop=crop)
    sd = prn.synthetic_state_dict(pcfg, np.random.default_rng(5))
    params = jax.device_get(jrn.convert_torchvision_resnet(sd, jcfg))
    model = prn.convert_torchvision_resnet(sd, pcfg, device=CPU)
    assert len(model.layers) == len(params["layers"]) == 4 - len(crop)
    imgs = rng.standard_normal((2, 48, 40, 3)).astype(np.float32)
    want = np.asarray(jrn.resnet_forward(params, jcfg, jnp.asarray(imgs)))
    got = prn.resnet_forward(model, pcfg, _t(imgs)).numpy()
    assert got.shape == want.shape
    assert _rel(got, want) < F32_REL
    same = resnet_from_jax_params(params, pcfg, device=CPU)
    assert torch.equal(prn.resnet_forward(same, pcfg, _t(imgs)),
                       prn.resnet_forward(model, pcfg, _t(imgs)))


def test_resnet_crop_check():
    with pytest.raises(ValueError):
        prn.ResNetConfig("basic", (2, 2, 2, 2), layers_to_crop=(3,))


# ---------------------------------------------------------------------------
# The dense-feature h5 drivers
# ---------------------------------------------------------------------------


def _write_images(tmp_path, rng, n, hw):
    from PIL import Image
    paths = []
    for i in range(n):
        p = tmp_path / f"im{i}.png"
        Image.fromarray(rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
                        ).save(p)
        paths.append(str(p))
    return paths, [f"im{i}" for i in range(n)]


def _read_both(path, keys):
    out = []
    with h5py.File(path, "r") as f:
        for k in keys:
            a, b = jio.read_dino_features(f, k), pio.read_dino_features(f, k)
            assert np.array_equal(a, b)
            out.append(a)
    return np.concatenate(out)


def test_dense_drivers_write_the_jax_h5(tmp_path, rng):
    """DINOv1 (binned and not), dinoNV and dinoSALAD features into h5
    from both packages' drivers on the same images and weights, each
    file read by both packages' readers."""
    paths, keys = _write_images(tmp_path, rng, 3, (50, 60))
    target = (36, 44)
    params, jcfg, model, pcfg = _dinov1(1)
    for binned in (False, True):
        kw = dict(target_hw=target, stride=4, layer=2, facet="key",
                  load_size=32, binned=binned, batch_size=2, progress=False)
        jext.extract_dinov1_features_to_h5(paths, keys, str(tmp_path / "j1.h5"),
                                           params, jcfg, **kw)
        pext.extract_dinov1_features_to_h5(paths, keys, str(tmp_path / "p1.h5"),
                                           model, pcfg, **kw)
        a = _read_both(str(tmp_path / "j1.h5"), keys)
        b = _read_both(str(tmp_path / "p1.h5"), keys)
        assert a.shape == b.shape == (3, 32 * (17 if binned else 1), *target)
        assert _rel(b, a) < F32_REL

    kw = dict(embed_dim=32, depth=2, num_heads=2, pretrain_grid=(2, 2))
    jcfg, pcfg = jdn.DinoV2Config(**kw), pdn.DinoV2Config(**kw)
    k1, k2 = jax.random.split(jax.random.PRNGKey(6))
    tree = jax.device_get({"backbone": jdn.init_params(jcfg, k1),
                           "aggregator": jag.salad_init(k2, 32, 4, 8, 16)})
    model = vpr_from_jax_params(tree, pcfg, device=CPU)
    for jfn, pfn, tag in (
            (jext.extract_dinonv_features_to_h5,
             pext.extract_dinonv_features_to_h5, "nv"),
            (jext.extract_dinosalad_features_to_h5,
             pext.extract_dinosalad_features_to_h5, "salad")):
        jfn(paths, keys, str(tmp_path / f"j{tag}.h5"), tree, jcfg, target,
            batch_size=2, progress=False)
        pfn(paths, keys, str(tmp_path / f"p{tag}.h5"), model, pcfg, target,
            batch_size=2, progress=False)
        a = _read_both(str(tmp_path / f"j{tag}.h5"), keys)
        b = _read_both(str(tmp_path / f"p{tag}.h5"), keys)
        assert a.shape == b.shape == (3, 32, 2, 3)
        assert _rel(b, a) < F32_REL


# ---------------------------------------------------------------------------
# The hub
# ---------------------------------------------------------------------------


def test_hub_unknown_name():
    with pytest.raises(KeyError):
        hub.load_model("resnet50", device=CPU)
    assert hub.MODELS == jhub.MODELS


def test_hub_dino_families_use_the_reference_defaults(rng):
    """dinov2_*: layer depth − 1, value facet; dino_vit*: layer 11, key
    facet, stride 4; f32 by default; seeded weights repeat."""
    imgs = _t(rng.standard_normal((1, 28, 28, 3)).astype(np.float32))
    model, cfg, fwd = hub.load_model("dinov2_vits14", device=CPU)
    assert cfg == pdn.VIT_S14 and model.pos_embed.dtype == torch.float32
    want = pdn.extract_dense(model, cfg, imgs, cfg.depth - 1, "value")
    assert torch.equal(fwd(model, imgs), want)
    model, cfg, fwd = hub.load_model("dino_vits8", seed=1, device=CPU)
    again, _, _ = hub.load_model("dino_vits8", seed=1, device=CPU)
    assert torch.equal(model.blocks[3].qkv.w, again.blocks[3].qkv.w)
    got = fwd(model, imgs[:, :24, :24])
    assert torch.equal(got, pd1.extract_dense(model, cfg, imgs[:, :24, :24],
                                              11, "key", 4))
    assert got.shape == (1, 5 * 5, 384)


def test_hub_global_models_and_sam(tmp_path, rng):
    """vlad_buff (seeded, then through its saved .npy tree), dino_salad
    and a SAM (bf16 by default)."""
    imgs = _t(rng.standard_normal((2, 126, 126, 3)).astype(np.float32))
    model, cfg, fwd = hub.load_model("vlad_buff", device=CPU, clusters=8)
    desc = fwd(model, imgs)
    assert desc.shape == (2, 8 * 768)
    path = pvb.save_vladbuff_params(str(tmp_path / "vb"), model)
    again, _, fwd2 = hub.load_model("vlad_buff", checkpoint=path, device=CPU)
    assert torch.equal(fwd2(again, imgs), desc)
    model, cfg, fwd = hub.load_model("dino_salad", device=CPU)
    assert fwd(model, imgs).shape == (2, 256 + 128 * 64)
    model, cfg, _ = hub.load_model("sam_vit_b", device=CPU)
    assert model.encoder.pos_embed.dtype == torch.float32
    assert cfg.encoder_dim == 768


def test_vladbuff_params_cross_both_ways(tmp_path, rng):
    """A VLAD-BuFF tree saved by the JAX package is read by the port, and
    the port's by the JAX package: the same global descriptors."""
    kw = dict(embed_dim=32, depth=2, num_heads=2, pretrain_grid=(2, 2))
    jcfg, pcfg = jdn.DinoV2Config(**kw), pdn.DinoV2Config(**kw)
    k1, k2 = jax.random.split(jax.random.PRNGKey(7))
    tree = {"backbone": jdn.init_params(jcfg, k1),
            "aggregator": jag.netvlad_init(k2, 32, 4, True),
            "wpca": {"w": jax.random.normal(k2, (6, 4 * 32)),
                     "b": jnp.zeros((6,))}}
    jpath = jvb.save_vladbuff_params(str(tmp_path / "j"), tree)
    model = pvb.load_vladbuff_params(jpath, pcfg, device=CPU)
    imgs = rng.standard_normal((2, 42, 28, 3)).astype(np.float32)
    want = np.asarray(jvb.global_descriptor(tree, jcfg, jnp.asarray(imgs)))
    with torch.no_grad():
        got = pvb.global_descriptor(model, pcfg, _t(imgs)).numpy()
    assert got.shape == want.shape == (2, 6) and _rel(got, want) < F32_REL
    ppath = pvb.save_vladbuff_params(str(tmp_path / "p"), model)
    back = jvb.load_vladbuff_params(ppath)
    again = np.asarray(jvb.global_descriptor(back, jcfg, jnp.asarray(imgs)))
    assert _rel(again, want) < 1e-6
