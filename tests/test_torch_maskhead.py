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


def _probs_state(rng, np_, gg, c_scale):
    """B6's inputs at SAM's widths (D 256, H·T 56 = 8 heads x 7 tokens):
    img0 [1, gg, 256], P1 and P2 [np_, 56, gg] bf16 (a softmax over each
    head's 7 tokens, as the image→token probabilities are), C1 and C2
    [np_, 56, 256] x ``c_scale``, the branch rows [8, 256]; f32 numpy but
    P."""
    def probs():
        x = rng.standard_normal((np_, 8, 7, gg)) * 2.0
        e = np.exp(x - x.max(2, keepdims=True))
        return jnp.asarray((e / e.sum(2, keepdims=True)).reshape(
            np_, 56, gg).astype(np.float32)).astype(jnp.bfloat16)

    rows = np.zeros((8, 256), np.float32)
    rows[[0, 3]] = rng.standard_normal((2, 256)) * 0.1
    rows[[1, 4]] = rng.standard_normal((2, 256)) * 0.1 + 1.0
    rows[[2, 5]] = rng.standard_normal((2, 256)) * 0.1
    c1m, c2m = ((rng.standard_normal((np_, 56, 256)) * 0.3
                 * c_scale).astype(np.float32) for _ in range(2))
    img0 = rng.standard_normal((1, gg, 256)).astype(np.float32)
    return img0, probs(), c1m, probs(), c2m, rows


def _recon_split(img0, ps, cs, rows, ln_eps, split: bool) -> torch.Tensor:
    """The rebuild of B6's f32 kernel (mask_head.cu ``rebuild_keys``) in
    f32 on the CPU: per branch layer y = (y + a) + b, a = P^T C_lo + P^T
    C_hi over the 56 rows (``split``; a bf16 P is exact in TF32; else one
    TF32 pass, P^T tf32(C)), then the LayerNorm with the one-pass variance
    max(E[y²] - mu², 0); the keys stay f32."""
    y = img0[0]
    for li, (p, c) in enumerate(zip(ps, cs)):
        pt = p.float().transpose(1, 2)                 # [Np, gg, 56]
        if split:
            hi, lo = _split(c)
            a = pt @ lo + pt @ hi
        else:
            a = pt @ _tf32(c)
        y = (y + a) + rows[3 * li]
        mu = y.sum(-1, keepdim=True) * (1.0 / y.shape[-1])
        var = torch.clamp((y * y).sum(-1, keepdim=True) * (1.0 / y.shape[-1])
                          - mu * mu, min=0.0)
        y = (y - mu) * torch.rsqrt(var + ln_eps) * rows[3 * li + 1] \
            + rows[3 * li + 2]
    return y


@pytest.mark.parametrize("c_scale", [1.0, 8.0])
def test_split_b6_f32_arithmetic_matches_jax(c_scale):
    """B6 f32 emulated in f32, in the kernel's order (the rebuild as two
    TF32 passes against C's hi and lo planes, then K3 f32's split-TF32
    head), is within 1e-5 of the JAX recon kernel in f32 (interpret mode;
    relative to the logits' largest value) at SAM's widths (D 256, H·T 56,
    M 3) and a ragged content of 56 of 64 positions, with C at its usual
    scale and x 8; C rounded once to TF32 misses by more at both."""
    rng = np.random.default_rng(28 + int(c_scale))
    img0, p1, c1m, p2, c2m, rows = _probs_state(rng, 2, 64, c_scale)
    p = _params(rng, 256, 3, 2, 64)
    head = _ORDER[1:]
    want = torch.from_numpy(np.array(fused_mask_head_probs(
        jnp.asarray(img0), p1, jnp.asarray(c1m), p2, jnp.asarray(c2m),
        jnp.asarray(rows), *(jnp.asarray(p[k]) for k in head), eps=1e-6,
        ln_eps=1e-6, content=56, interpret=True)))
    ps = [torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        torch.bfloat16)[..., :56] for x in (p1, p2)]
    cs = [torch.from_numpy(x) for x in (c1m, c2m)]
    args = [torch.from_numpy(p[k]) for k in head]

    def rel(split):
        keys = _recon_split(torch.from_numpy(img0)[:, :56], ps, cs,
                            torch.from_numpy(rows), 1e-6, split)
        got = _mask_head_tf32(keys, *args, 1e-6, split=True)
        return float((got - want).abs().max() / want.abs().max())

    assert rel(True) < 1e-5
    assert rel(False) > 1e-5


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_mask_head_probs_operands_are_never_cast(dtype):
    """The operand list B6's CUDA branch hands ``operand``
    (``mask_head_probs_operands``): img0, C1, C2 and the hypernetwork rows
    are the caller's own tensors held to img0's dtype, P1 and P2 bf16, and
    only the branch rows and the head's weights are converted to img0's
    dtype. An activation of the other dtype stays itself, so ``operand``
    raises on it (a mixed call never rounds)."""
    rng = np.random.default_rng(3)
    img0, p1, c1m, p2, c2m, rows = _probs_state(rng, 2, 64, 1.0)
    p = _params(rng, 256, 3, 2, 64)
    other = torch.float32 if dtype == torch.bfloat16 else torch.bfloat16
    ps = [torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        torch.bfloat16) for x in (p1, p2)]
    acts = dict(img0=torch.from_numpy(img0).to(dtype),
                c1m=torch.from_numpy(c1m).to(dtype),
                c2m=torch.from_numpy(c2m).to(dtype),
                hyper=torch.from_numpy(p["hyper"]).to(dtype),
                p1=ps[0], p2=ps[1])
    weights = [torch.from_numpy(p[k]) for k in _ORDER[2:]]
    f32_rows = torch.from_numpy(rows)

    def operands(a):
        return mh.mask_head_probs_operands(
            a["img0"], a["p1"], a["c1m"], a["p2"], a["c2m"], f32_rows,
            a["hyper"], *weights)

    shapes = dict(img0=(1, 64, 256), p1=(2, 56, 64), p2=(2, 56, 64),
                  c1m=(2, 56, 256), c2m=(2, 56, 256), hyper=(2, 3, 32),
                  branch_rows=(8, 256), up1_w=(256, 256), up1_b=(64,),
                  ln_scale=(64,), ln_bias=(64,), up2_w=(64, 128),
                  up2_b=(32,))
    ops = operands(acts)
    assert [x[0] for x in ops] == [
        "img0", "p1", "c1m", "p2", "c2m", "branch_rows", "up1_w", "up1_b",
        "ln_scale", "ln_bias", "up2_w", "up2_b", "hyper"]
    for name, x, want, shape in ops:
        if name in acts:
            assert x is acts[name], name
            assert want == (torch.bfloat16 if name in ("p1", "p2")
                            else dtype), name
        else:
            assert x.dtype == want == dtype, name
        assert x.dtype == want and tuple(x.shape) == shape == shapes[name]
    for name in ("c1m", "c2m", "hyper"):
        mixed = dict(acts, **{name: acts[name].to(other)})
        (x, want), = [(x, w) for n, x, w, _ in operands(mixed) if n == name]
        assert x is mixed[name] and x.dtype == other and want == dtype
