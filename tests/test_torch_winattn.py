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


LOG2E = 1.4426950408889634


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, by the bit operations the kernels use (``tf32_rna``)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split(x: torch.Tensor):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _win_tf32(qkv, bias_h, bias_w, heads: int, side: int, split: bool):
    """The arithmetic of B11's f32 kernel (win_attention.cu
    ``win_attention_tf32x3_kernel``) in f32 on the CPU: 32-key tiles; S
    as hi·hi and lo·hi + hi·lo of TF32 planes in two sums added at the end
    (``split``; else one TF32 product); each score s·scale·log2 e +
    (bh + bw)·log2 e in f32 (the kernel adds the bias on the FMA units);
    the online softmax
    in base 2; each tile's P·V into a fresh accumulator, 8 keys at a time
    (lo·hi, hi·lo, hi·hi), joined to O by O·α + tile."""
    b, n, three_d = qkv.shape
    d = three_d // 3
    hd = d // heads
    q, k, v = (qkv[..., i * d:(i + 1) * d].reshape(b, n, heads, hd)
               .transpose(1, 2) for i in range(3))              # [B, H, N, hd]
    l2e = torch.tensor(LOG2E, dtype=torch.float32)
    sl = torch.tensor(1.0 / np.sqrt(hd), dtype=torch.float32) * l2e
    bh, bw = (x.reshape(b, n, heads, side).transpose(1, 2)
              for x in (bias_h, bias_w))
    keys = torch.arange(n)
    bias = (bh[..., keys // side] + bw[..., keys % side]) * l2e  # [B, H, N, N]

    def acc_product(acc, a, w):
        if not split:
            t = _tf32(a) @ _tf32(w)
            return t if acc is None else acc + t
        (ah, al), (wh, wl) = _split(a), _split(w)
        for t in (al @ wh, ah @ wl, ah @ wh):
            acc = t if acc is None else acc + t
        return acc

    mrow = torch.full((b, heads, n), -torch.inf)
    lrow = torch.zeros((b, heads, n))
    o = torch.zeros((b, heads, n, hd))
    for k0 in range(0, n, 32):
        k1 = min(k0 + 32, n)
        kt = k[..., k0:k1, :].transpose(-1, -2)
        if split:
            (qh, ql), (kh, kl) = _split(q), _split(kt)
            s = qh @ kh + (ql @ kh + qh @ kl)
        else:
            s = _tf32(q) @ _tf32(kt)
        x = s * sl + bias[..., k0:k1]
        m_new = torch.maximum(mrow, x.amax(-1))
        alpha = torch.exp2(mrow - m_new)
        p = torch.exp2(x - m_new[..., None])
        lrow = lrow * alpha + p.sum(-1)
        tile = None
        for j in range(k0, k1, 8):
            tile = acc_product(tile, p[..., j - k0:j - k0 + 8],
                               v[..., j:min(j + 8, k1), :])
        o = o * alpha[..., None] + tile
        mrow = m_new
    return (o / lrow[..., None]).transpose(1, 2).reshape(b, n, d)


@pytest.mark.parametrize("scale", [1.0, 4.0])
@pytest.mark.parametrize("b,side,heads,hd", [(2, 14, 2, 80), (1, 16, 2, 64)])
def test_split_tf32_window_arithmetic_matches_jax(b, side, heads, hd, scale):
    """B11 f32 emulated in f32 is within 1e-5 of JAX ``windowed_attend`` in
    f32 (its Pallas kernel in interpret mode; relative to the output's
    largest value) at SAM ViT-H's window (side 14, head dim 80; N = 196
    ends on a ragged tile) and at side 16 with head dim 64; with q x 4
    (scores of std ~4) one TF32 pass misses by far."""
    rng = np.random.default_rng(side + int(scale))
    n, d = side * side, heads * hd
    qkv = rng.standard_normal((b, n, 3 * d)).astype(np.float32)
    qkv[..., :d] *= np.float32(scale)
    bh, bw = (rng.standard_normal((b, n, heads * side)).astype(np.float32)
              for _ in range(2))
    want = torch.from_numpy(np.array(jwin(
        jnp.asarray(qkv), jnp.asarray(bh), jnp.asarray(bw), heads,
        side=side, interpret=True)))
    args = [torch.from_numpy(x) for x in (qkv, bh, bw)]

    def rel(got):
        return float((got - want).abs().max() / want.abs().max())

    assert rel(_win_tf32(*args, heads, side, split=True)) < 1e-5
    if scale > 1:
        assert rel(_win_tf32(*args, heads, side, split=False)) > 1e-5


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
