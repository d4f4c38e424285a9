"""Port parity: kernel B11 (``windowed_attend``) and the SAM encoder with
its windowed layers through it, against the JAX package's
``windowed_attend`` (its Pallas kernel in interpret mode) and
``encode_image`` with ``_WINATTN = "on"``; f32 on both sides."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from revisit_anything_tpu.models.sam import SamArchConfig, init_sam_params
from revisit_anything_tpu.models.sam import encoder as jenc
from revisit_anything_tpu.ops.winattn import windowed_attend as jwin
from revisit_anything_tpu_torch.models.sam import SamArchConfig as PortCfg
from revisit_anything_tpu_torch.models.sam.encoder import ImageEncoder
from revisit_anything_tpu_torch.ops import winattn
from revisit_anything_tpu_torch.weights import sam_from_jax_params

torch.set_float32_matmul_precision("highest")

# window 4 on an 8x8 grid (4 windows) and one global layer of 64 tokens,
# which the window kernel also takes (square, below 1024 tokens)
KW = dict(encoder_dim=64, encoder_depth=2, encoder_heads=4,
          global_attn_indexes=(1,), image_size=128, patch_size=16,
          window_size=4, prompt_dim=32)


@pytest.mark.parametrize("b,side,heads,hd", [(3, 4, 2, 8), (2, 6, 4, 16)])
def test_windowed_attend_matches_jax(b, side, heads, hd):
    rng = np.random.default_rng(side)
    n, d = side * side, heads * hd
    qkv = rng.standard_normal((b, n, 3 * d)).astype(np.float32)
    bh, bw = (rng.standard_normal((b, n, heads * side)).astype(np.float32)
              for _ in range(2))
    want = np.asarray(jwin(jnp.asarray(qkv), jnp.asarray(bh), jnp.asarray(bw),
                           heads, side=side, interpret=True))
    got = winattn.windowed_attend(*(torch.from_numpy(x) for x in (qkv, bh, bw)),
                                  heads, side).numpy()
    assert got.shape == (b, n, d)
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_windowed_attend_rejects_a_non_square_window():
    x = torch.zeros(1, 12, 3 * 8)
    with pytest.raises(ValueError, match="side"):
        winattn.windowed_attend(x, x[..., :8], x[..., :8], 2, side=3)


def test_encoder_window_kernel_matches_jax():
    """The port's encoder with ``window_attention="kernel"`` against JAX
    ``encode_image`` with ``_WINATTN = "on"`` (its jit cache cleared
    around the flag, which is read at trace time)."""
    cfg = SamArchConfig(**KW)
    params = init_sam_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    tree = jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + 0.05 * rng.standard_normal(x.shape)
                   ).astype(np.float32), params)
    img = rng.standard_normal((1, 128, 128, 3)).astype(np.float32)
    old = jenc._WINATTN
    try:
        jenc._WINATTN = "on"
        jenc.encode_image.clear_cache()
        want = np.asarray(jenc.encode_image(
            jax.tree_util.tree_map(jnp.asarray, tree), cfg, jnp.asarray(img)))
    finally:
        jenc._WINATTN = old
        jenc.encode_image.clear_cache()
    sam = sam_from_jax_params(tree, PortCfg(**KW), device="cpu")
    sam.encoder.window_attention = "kernel"
    with torch.inference_mode():
        got = sam.encoder(torch.from_numpy(img)).numpy()
    assert got.shape == want.shape == (1, 8, 8, 32)
    np.testing.assert_allclose(got, want, atol=5e-5)


def test_encoder_window_attention_is_checked():
    enc = ImageEncoder(PortCfg(**KW), device="cpu")
    assert enc.window_attention == "plain"
    enc.window_attention = "fused"
    with pytest.raises(ValueError, match="window_attention"):
        enc(torch.zeros(1, 128, 128, 3))
