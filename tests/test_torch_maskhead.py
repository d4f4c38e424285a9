"""Port parity: kernel K3 (fused mask head) against the JAX package's
``fused_mask_head`` (Pallas, interpret mode) and its XLA block path
``decoder._upscale_masks_blocks(interleave=False)``."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from revisit_anything_tpu.models.sam.decoder import _upscale_masks_blocks
from revisit_anything_tpu.ops.maskhead import fused_mask_head as jax_mask_head
from revisit_anything_tpu.ops.maskhead import fused_mask_head_probs
from revisit_anything_tpu_torch.ops import maskhead as mh

torch.set_float32_matmul_precision("highest")

# f32 on both sides. The TPU kernel's GELU is a polynomial within 5e-7 of
# erf's and its LN variance is one-pass; both stay below 1e-5 here.
ATOL = 1e-5


def _params(rng, d, m_tok, np_, gg):
    c1, c2 = d // 4, d // 8
    return {
        "keys": rng.standard_normal((np_, gg, d)).astype(np.float32),
        "hyper": (rng.standard_normal((np_, m_tok, c2)) * 0.5).astype(
            np.float32),
        "up1_w": (rng.standard_normal((d, 4 * c1)) * 0.1).astype(np.float32),
        "up1_b": (rng.standard_normal((c1,)) * 0.1).astype(np.float32),
        "ln_scale": (rng.standard_normal((c1,)) * 0.1 + 1.0).astype(
            np.float32),
        "ln_bias": (rng.standard_normal((c1,)) * 0.1).astype(np.float32),
        "up2_w": (rng.standard_normal((c1, 4 * c2)) * 0.1).astype(np.float32),
        "up2_b": (rng.standard_normal((c2,)) * 0.1).astype(np.float32),
    }


_ORDER = ("keys", "hyper", "up1_w", "up1_b", "ln_scale", "ln_bias",
          "up2_w", "up2_b")


@pytest.mark.parametrize("m_tok,content", [(3, 48), (1, 64)])
def test_mask_head_matches_jax_kernel(m_tok, content):
    rng = np.random.default_rng(m_tok)
    p = _params(rng, 32, m_tok, 2, 64)
    want = np.asarray(jax_mask_head(
        *(jnp.asarray(p[k]) for k in _ORDER), eps=1e-6, content=content,
        interpret=True))
    got = mh.fused_mask_head(*(torch.from_numpy(p[k]) for k in _ORDER),
                             eps=1e-6, content=content).numpy()
    assert got.shape == (2, content, 16, m_tok)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_mask_head_matches_jax_block_path():
    rng = np.random.default_rng(7)
    p = _params(rng, 32, 3, 2, 64)
    dec = {"up1_w": jnp.asarray(p["up1_w"]), "up1_b": jnp.asarray(p["up1_b"]),
           "up_ln": {"scale": jnp.asarray(p["ln_scale"]),
                     "bias": jnp.asarray(p["ln_bias"])},
           "up2_w": jnp.asarray(p["up2_w"]), "up2_b": jnp.asarray(p["up2_b"])}
    want = np.asarray(_upscale_masks_blocks(
        jnp.asarray(p["keys"]), jnp.asarray(p["hyper"]), dec,
        SimpleNamespace(grid=8, eps=1e-6), interleave=False))
    got = mh.upscale_masks_blocks(*(torch.from_numpy(p[k]) for k in _ORDER),
                                  eps=1e-6).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_plain_mask_head_keeps_the_kernels_rounding_points_in_bf16(dtype):
    """The plain version the K3 kernel is held to on the card
    (``upscale_masks_blocks``) against the JAX kernel (interpret mode) in
    bf16 at the kernel's real width: D 256, M 4, content 96 of gg 128 (not
    a whole number of 64-position items). Both round y1, h1, y2 and h2 to
    bf16 at the same points; what differs is the f32 summation order of
    the products, the GELU (erf against the A&S polynomial, 5e-7) and the
    LN variance (two-pass against one-pass), each of which can flip an
    intermediate bf16 rounding by one ulp. So the logits may differ by
    one or two bf16 ulps of the output's scale, not more. In f32 (K3's
    f32 form) nothing is rounded: within 1e-5 of the output's scale."""
    rng = np.random.default_rng(5)
    p = _params(rng, 256, 4, 2, 128)
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
                else (jnp.float32, torch.float32))
    ins = {k: jnp.asarray(p[k]).astype(jdt) for k in _ORDER}
    want = np.asarray(jax_mask_head(
        *(ins[k] for k in _ORDER), eps=1e-6, content=96,
        interpret=True).astype(jnp.float32))
    got = mh.upscale_masks_blocks(
        *(torch.from_numpy(p[k]).to(tdt) for k in _ORDER),
        eps=1e-6)[:, :96].float().numpy()
    assert got.shape == want.shape == (2, 96, 16, 4)
    scale = np.abs(want).max()
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
        return
    ulp = 2.0 ** (np.floor(np.log2(scale)) - 7)      # bf16: 8 significant bits
    np.testing.assert_allclose(got, want, rtol=0, atol=2 * ulp)


@pytest.mark.parametrize("content,n_masks", [
    pytest.param(None, 3, id="None"), pytest.param(48, 3, id="48"),
    (None, 1), (48, 1), (None, 4), (48, 4)])
def test_mask_head_probs_matches_jax_kernel(content, n_masks):
    """Kernel B6: the branch rebuilt from two (P, C) updates, then the
    mask head, against the JAX package's recon kernel, at 1, 3 and 4
    mask tokens."""
    rng = np.random.default_rng(11)
    d, ht, np_, gg = 32, 28, 2, 64
    p = _params(rng, d, n_masks, np_, gg)
    img0 = rng.standard_normal((1, gg, d)).astype(np.float32)
    logits = rng.standard_normal((2, np_, ht, gg)) * 2.0
    probs = np.exp(logits - logits.max(2, keepdims=True))
    probs = (probs / probs.sum(2, keepdims=True)).astype(np.float32)
    p1, p2 = (jnp.asarray(x).astype(jnp.bfloat16) for x in probs)
    c1m, c2m = (rng.standard_normal((np_, ht, d)) * 0.3).astype(np.float32), \
        (rng.standard_normal((np_, ht, d)) * 0.3).astype(np.float32)
    rows = np.zeros((8, d), np.float32)
    rows[[0, 3]] = rng.standard_normal((2, d)) * 0.1
    rows[[1, 4]] = rng.standard_normal((2, d)) * 0.1 + 1.0
    rows[[2, 5]] = rng.standard_normal((2, d)) * 0.1
    head = _ORDER[1:]
    want = np.asarray(fused_mask_head_probs(
        jnp.asarray(img0), p1, jnp.asarray(c1m), p2, jnp.asarray(c2m),
        jnp.asarray(rows), *(jnp.asarray(p[k]) for k in head), eps=1e-6,
        ln_eps=1e-6, content=content, interpret=True))

    def t(x):
        return torch.from_numpy(np.array(x, np.float32))

    got = mh.fused_mask_head_probs(
        t(img0), t(p1).to(torch.bfloat16), t(c1m), t(p2).to(torch.bfloat16),
        t(c2m), t(rows), *(t(p[k]) for k in head), eps=1e-6, ln_eps=1e-6,
        content=content).numpy()
    assert got.shape == (np_, content or gg, 16, n_masks)
    np.testing.assert_allclose(got, want, atol=ATOL)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, by the bit operations the f32 kernels use (``tf32_rna``)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split(x: torch.Tensor):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _mask_head_tf32(keys, hyper, up1_w, up1_b, ln_s, ln_b, up2_w, up2_b,
                    eps: float, split: bool) -> torch.Tensor:
    """The arithmetic of K3's f32 kernel (mask_head.cu
    ``mask_head_tf32x3_kernel``) in f32 on the CPU. A product is lo·hi +
    hi·lo + hi·hi of TF32 planes summed in that order (``split``; else one
    TF32 product): conv1 takes each 32-wide K chunk into a fresh
    accumulator added to an f32 sum from zero, conv2 (K 64) keeps one
    accumulator. The group LN is two-pass, GELU exact (erf), the
    hypernetwork dot plain f32."""
    def passes(a, w):
        if not split:
            return _tf32(a) @ _tf32(w)
        (ah, al), (wh, wl) = _split(a), _split(w)
        return (al @ wh + ah @ wl) + ah @ wh

    np_, p, d = keys.shape
    m = hyper.shape[1]
    y = torch.zeros((np_, p, up1_w.shape[1]))
    for k0 in range(0, d, 32):
        y = y + passes(keys[..., k0:k0 + 32], up1_w[k0:k0 + 32])
    y = y.reshape(np_, p, 4, -1) + up1_b
    mu = y.sum(-1, keepdim=True) / y.shape[-1]
    var = ((y - mu) ** 2).sum(-1, keepdim=True) / y.shape[-1]
    h1 = torch.nn.functional.gelu((y - mu) * torch.rsqrt(var + eps) * ln_s
                                  + ln_b)
    y2 = passes(h1, up2_w).reshape(np_, p, 4, 4, -1) + up2_b
    h2 = torch.nn.functional.gelu(y2)
    return torch.einsum("npqrc,nmc->npqrm", h2, hyper).reshape(np_, p, 16, m)


@pytest.mark.parametrize("scale", [1.0, 4.0])
def test_split_tf32_mask_head_arithmetic_matches_jax(scale):
    """K3 f32 emulated in f32 is within 1e-5 of the JAX kernel in f32
    (interpret mode; relative to the logits' largest value) at SAM's widths
    (D 256, M 3), a ragged content of 56 of 64 positions, with the keys at
    unit scale and x 4; one TF32 pass misses by far at both."""
    rng = np.random.default_rng(25 + int(scale))
    p = _params(rng, 256, 3, 2, 64)
    p["keys"] = p["keys"] * np.float32(scale)
    want = torch.from_numpy(np.array(jax_mask_head(
        *(jnp.asarray(p[k]) for k in _ORDER), eps=1e-6, content=56,
        interpret=True)))
    args = [torch.from_numpy(p[k]) for k in _ORDER]
    args[0] = args[0][:, :56]

    def rel(split):
        got = _mask_head_tf32(*args, 1e-6, split=split)
        return float((got - want).abs().max() / want.abs().max())

    assert rel(True) < 1e-5
    assert rel(False) > 1e-5
