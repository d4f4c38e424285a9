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
