"""Port parity: DINOv2 dense features (``extract_dense``, value facet)
against the JAX package, for an MLP and a SwiGLU config, with and
without the bicubic position-embedding resize (f32 on both sides)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from revisit_anything_tpu.models import dinov2 as jdn
from revisit_anything_tpu_torch.models import dinov2 as pdn
from revisit_anything_tpu_torch.weights import dino_from_jax_params

torch.set_float32_matmul_precision("highest")

REL = 1e-4

CONFIGS = {
    "mlp": dict(embed_dim=64, depth=2, num_heads=4, ffn="mlp",
                pretrain_grid=(8, 8)),
    "swiglu": dict(embed_dim=48, depth=3, num_heads=4, ffn="swiglu",
                   pretrain_grid=(6, 6)),
}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)


@pytest.mark.parametrize("name,hw,layer", [
    ("mlp", (112, 112), 1),      # pretrain grid: no resize
    ("mlp", (98, 126), 1),       # 7x9 grid: bicubic resize
    ("swiglu", (70, 84), 2),
    ("swiglu", (84, 84), 1),
])
def test_extract_dense_matches_jax(name, hw, layer):
    kw = CONFIGS[name]
    jcfg, pcfg = jdn.DinoV2Config(**kw), pdn.DinoV2Config(**kw)
    params = jdn.init_params(jcfg, jax.random.PRNGKey(1))
    rng = np.random.default_rng(0)
    # perturb every leaf: non-zero biases, LayerScale of order 1
    tree = jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + 0.1 * rng.standard_normal(x.shape)
                   ).astype(np.float32), params)
    img = rng.standard_normal((1,) + hw + (3,)).astype(np.float32)
    want = np.asarray(jdn.extract_dense(
        jax.tree_util.tree_map(jnp.asarray, tree), jcfg, jnp.asarray(img),
        layer, "value"))
    model = dino_from_jax_params(tree, pcfg, device="cpu")
    with torch.inference_mode():
        got = pdn.extract_dense(model, pcfg, torch.from_numpy(img),
                                layer).numpy()
    assert got.shape == want.shape
    assert _rel(got, want) < REL


def test_center_crop_offsets_round_half_even():
    for h, w, hn, wn in ((479, 641, 476, 630), (480, 640, 476, 630),
                         (483, 650, 476, 644)):
        assert (pdn.center_crop_offsets(h, w, hn, wn)
                == jdn.center_crop_offsets(h, w, hn, wn))


def test_pos_embed_cache_follows_weight_loads():
    """The resized position table is cached per grid size but keyed on the
    table's storage and version: two weight loads into one module give two
    different outputs, each equal to JAX's for its weights."""
    from revisit_anything_tpu_torch.weights import load_tree
    kw = CONFIGS["mlp"]
    jcfg, pcfg = jdn.DinoV2Config(**kw), pdn.DinoV2Config(**kw)
    rng = np.random.default_rng(5)
    img = rng.standard_normal((1, 98, 126, 3)).astype(np.float32)
    model = None
    outs = []
    for seed in (2, 3):
        params = jdn.init_params(jcfg, jax.random.PRNGKey(seed))
        tree = jax.tree_util.tree_map(
            lambda x: (np.asarray(x) + 0.1 * rng.standard_normal(x.shape)
                       ).astype(np.float32), params)
        want = np.asarray(jdn.extract_dense(
            jax.tree_util.tree_map(jnp.asarray, tree), jcfg,
            jnp.asarray(img), 1, "value"))
        if model is None:
            model = dino_from_jax_params(tree, pcfg, device="cpu")
        else:
            load_tree(model, tree)
        for _ in range(2):             # the second call reads the cache
            with torch.inference_mode():
                got = pdn.extract_dense(model, pcfg, torch.from_numpy(img),
                                        1).numpy()
            assert _rel(got, want) < REL
        # the cached table is the bits a fresh resize gives
        assert torch.equal(pdn.interpolate_pos_embed(model, pcfg, (7, 9)),
                           pdn._resize_pos_embed(model.pos_embed, pcfg,
                                                 (7, 9)))
        outs.append(got)
    assert _rel(outs[0], outs[1]) > 0.1


def test_dino_descriptors_keep_their_bits():
    """The cached ImageNet constants give the bits the per-call uploads
    gave."""
    from revisit_anything_tpu_torch.pipeline.serve import _dino_desc_device
    from revisit_anything_tpu_torch.weights import init_dino
    pcfg = pdn.DinoV2Config(**CONFIGS["mlp"])
    model = init_dino(pcfg, torch.Generator().manual_seed(0), "cpu",
                      torch.float32)
    rng = np.random.default_rng(6)
    img = torch.from_numpy(rng.integers(0, 256, (100, 130, 3),
                                        dtype=np.uint8))
    crop = (1, 2, 98, 126)
    x = img.float() / 255.0
    x = ((x - torch.from_numpy(pdn.IMAGENET_MEAN))
         / torch.from_numpy(pdn.IMAGENET_STD))
    x = x[1:99, 2:128][None].to(torch.bfloat16)
    with torch.inference_mode():
        d = pdn.extract_dense(model, pcfg, x, 1)[0].float()
        want = d / torch.linalg.vector_norm(d, dim=1, keepdim=True).clamp(
            min=1e-12)
        for _ in range(2):
            got = _dino_desc_device(model, pcfg, img, 1, crop)
            assert torch.equal(got, want)


def test_pos_embed_of_a_model_built_in_inference_mode():
    """A model built in inference mode has no version counter to key the
    cache on: its resized table is computed on every call, the same bits."""
    from revisit_anything_tpu_torch.weights import init_dino
    pcfg = pdn.DinoV2Config(**CONFIGS["mlp"])
    with torch.inference_mode():
        model = init_dino(pcfg, torch.Generator().manual_seed(1), "cpu",
                          torch.float32)
        first = pdn.interpolate_pos_embed(model, pcfg, (7, 9))
        again = pdn.interpolate_pos_embed(model, pcfg, (7, 9))
    assert first is not again and torch.equal(first, again)
    assert not model._pos_cache
