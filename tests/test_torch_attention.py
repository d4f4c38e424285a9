"""Port parity: kernels K1 (flash attention), K2 (token→image cross
attention), B10 (the same on separate kᵀ and vᵀ without pe) and K5
against the JAX package's ``attend`` / ``token_cross_attend_kv`` /
``token_cross_attend`` / ``i2t_update`` (their Pallas kernels run in
interpret mode off-TPU).

On the CPU the port's wrappers take their plain versions; the CUDA
kernels are held against those plain versions in test_torch_kernels.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from revisit_anything_tpu.ops.attention import attend as jax_attend
from revisit_anything_tpu.ops.attention import i2t_update as jax_i2t
from revisit_anything_tpu.ops.attention import (
    token_cross_attend_kv as jax_token_cross_attend_kv)
from revisit_anything_tpu_torch.ops import attention as att

torch.set_float32_matmul_precision("highest")

ATOL = 1e-5    # f32 on both sides: only summation order differs


@pytest.mark.parametrize("n,dh", [(200, 32), (64, 80)])
def test_attend_matches_jax_ragged(n, dh):
    rng = np.random.default_rng(n)
    q, k, v = (rng.standard_normal((1, 2, n, dh)).astype(np.float32)
               for _ in range(3))
    want = np.asarray(jax_attend(q, k, v, block_q=128))
    got = att.attend(*(torch.from_numpy(x) for x in (q, k, v))).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, by the bit operations K1's f32 kernel uses (``tf32_rna``)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split(x: torch.Tensor):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _tf32_attend(q, k, v, split: bool, bias=None) -> torch.Tensor:
    """The arithmetic of K1's f32 kernel (flash_attention.cu
    ``flash_attention_tf32x3_kernel``) in f32 on the CPU: tiles of 64 keys
    (32 at head dim 80), the online softmax in base 2, and each product
    as lo·hi + hi·lo + hi·hi of TF32 planes summed in that order
    (``split``), or as one TF32 product; each tile's P·V joined to O by
    O·α + tile. With ``bias`` = (bias_h, bias_w, side), the terms as the
    kernel adds them at side 64: each score becomes s·scale·log2 e +
    (bias_h·log2 e + bias_w·log2 e), each term times log2 e in f32 before
    the sum, and the softmax runs on it at a scale of 1."""
    dh, n = q.shape[-1], k.shape[-2]
    bk = 64 if dh == 64 else 32
    sl = torch.tensor(1.4426950408889634 / np.sqrt(dh), dtype=torch.float32)
    if bias is not None:
        bias_h, bias_w, side = bias
        l2e = torch.tensor(LOG2E, dtype=torch.float32)
        full = ((bias_h * l2e).repeat_interleave(side, dim=-1)
                + (bias_w * l2e).repeat(1, 1, 1, side))

    def product(a, b):
        if not split:
            return _tf32(a) @ _tf32(b)
        (ah, al), (bh, bl) = _split(a), _split(b)
        return al @ bh + ah @ bl + ah @ bh

    m = torch.full(q.shape[:-1], -torch.inf)
    l = torch.zeros(q.shape[:-1])
    o = torch.zeros(q.shape)
    scale = sl if bias is None else torch.tensor(1.0)
    for k0 in range(0, n, bk):
        s = product(q, k[..., k0:k0 + bk, :].transpose(-1, -2))
        if bias is not None:
            s = s * sl + full[..., k0:k0 + bk]
        m_new = torch.maximum(m, s.amax(-1) * scale)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s * scale - m_new[..., None])
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + product(p, v[..., k0:k0 + bk, :])
        m = m_new
    return o / l[..., None]


@pytest.mark.parametrize("scale", [1.0, 2.0])
@pytest.mark.parametrize("n,dh", [(65, 64), (200, 80)])
def test_split_tf32_arithmetic_matches_jax(n, dh, scale):
    """K1 f32 takes its products as three TF32 passes of split operands:
    emulated here, it is within 1e-5 of JAX ``attend`` in f32 (relative to
    the output's largest value) at unit scale and with q, k x 2 (scores of
    std ~4), where one TF32 pass misses by far."""
    rng = np.random.default_rng(n + int(scale))
    q, k, v = (rng.standard_normal((1, 2, n, dh)).astype(np.float32)
               for _ in range(3))
    q, k = q * np.float32(scale), k * np.float32(scale)
    want = torch.from_numpy(np.array(jax_attend(q, k, v, block_q=128)))
    args = [torch.from_numpy(x) for x in (q, k, v)]

    def rel(got):
        return float((got - want).abs().max() / want.abs().max())

    assert rel(_tf32_attend(*args, split=True)) < 1e-5
    if scale > 1:
        assert rel(_tf32_attend(*args, split=False)) > 1e-5


@pytest.mark.parametrize("scale", [1.0, 2.0])
@pytest.mark.parametrize("side,dh", [(8, 80), (16, 64)])
def test_split_tf32_bias_arithmetic_matches_jax(side, dh, scale):
    """K1 f32 + bias emulated with the bias added in the kernel's order at
    side 64 (each term times log2 e, then their sum onto the scaled score)
    is within 1e-5 of JAX ``attend`` with the decomposed bias in f32, at
    SAM's head dim 80 on a grid of 8 and head dim 64 on a grid of 16; with
    q, k x 2 one TF32 pass misses by far."""
    rng = np.random.default_rng(side + int(scale))
    n = side * side
    q, k, v = (rng.standard_normal((1, 2, n, dh)).astype(np.float32)
               for _ in range(3))
    q, k = q * np.float32(scale), k * np.float32(scale)
    bh, bw = (rng.standard_normal((1, 2, n, side)).astype(np.float32)
              for _ in range(2))
    want = torch.from_numpy(np.array(
        jax_attend(q, k, v, bh, bw, side=side, block_q=n)))
    args = [torch.from_numpy(x) for x in (q, k, v)]
    bias = (torch.from_numpy(bh), torch.from_numpy(bw), side)

    def rel(got):
        return float((got - want).abs().max() / want.abs().max())

    assert rel(_tf32_attend(*args, split=True, bias=bias)) < 1e-5
    if scale > 1:
        assert rel(_tf32_attend(*args, split=False, bias=bias)) > 1e-5


@pytest.mark.parametrize("side,dh", [(12, 40), (8, 80)])
def test_attend_decomposed_bias_matches_jax(side, dh):
    """f32, the dtype of K1's bias form in an f32 SAM; (8, 80): SAM's head
    dim on a grid of 8."""
    rng = np.random.default_rng(1)
    n = side * side
    q, k, v = (rng.standard_normal((1, 2, n, dh)).astype(np.float32)
               for _ in range(3))
    bh, bw = (rng.standard_normal((1, 2, n, side)).astype(np.float32)
              for _ in range(2))
    want = np.asarray(jax_attend(q, k, v, bh, bw, side=side, block_q=n))
    got = att.attend(*(torch.from_numpy(x) for x in (q, k, v, bh, bw)),
                     side=side).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("shared", [True, False])
def test_token_cross_attend_kv_matches_jax(shared):
    rng = np.random.default_rng(2 + shared)
    b, n, d, heads, m = 3, 7, 32, 2, 96
    q = rng.standard_normal((b, n, d)).astype(np.float32)
    kvt = rng.standard_normal((1 if shared else b, 2 * d, m)).astype(
        np.float32)
    pe = rng.standard_normal((1, d, m)).astype(np.float32)
    vb = rng.standard_normal((d,)).astype(np.float32)
    want = np.asarray(jax_token_cross_attend_kv(
        jnp.asarray(q), jnp.asarray(kvt), jnp.asarray(pe), jnp.asarray(vb),
        heads))
    got = att.token_cross_attend_kv(
        *(torch.from_numpy(x) for x in (q, kvt, pe, vb)), heads).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_token_cross_zero_pe_bias_is_plain_cross_attention():
    """token_cross_attend (the pe-less TPU variant) is K2 at pe = 0 and
    v bias = 0."""
    from revisit_anything_tpu.ops.attention import token_cross_attend
    rng = np.random.default_rng(5)
    b, n, d, heads, m = 2, 7, 32, 4, 64
    q = rng.standard_normal((b, n, d)).astype(np.float32)
    kt = rng.standard_normal((b, d, m)).astype(np.float32)
    vt = rng.standard_normal((b, d, m)).astype(np.float32)
    want = np.asarray(token_cross_attend(jnp.asarray(q), jnp.asarray(kt),
                                         jnp.asarray(vt), heads))
    got = att.token_cross_attend_kv(
        torch.from_numpy(q), torch.from_numpy(np.concatenate([kt, vt], 1)),
        torch.zeros(1, d, m), torch.zeros(d), heads).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("shared", [True, False])
def test_token_cross_attend_matches_jax(shared):
    """B10 with shared (leading dim 1) and per-prompt kᵀ/vᵀ."""
    from revisit_anything_tpu.ops.attention import token_cross_attend
    rng = np.random.default_rng(11 + shared)
    b, n, d, heads, m = 3, 7, 32, 2, 96
    q = rng.standard_normal((b, n, d)).astype(np.float32)
    kt, vt = (rng.standard_normal((1 if shared else b, d, m)).astype(
        np.float32) for _ in range(2))
    want = np.asarray(token_cross_attend(jnp.asarray(q), jnp.asarray(kt),
                                         jnp.asarray(vt), heads))
    got = att.token_cross_attend(*(torch.from_numpy(x) for x in (q, kt, vt)),
                                 heads).numpy()
    assert got.shape == (b, n, d)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("far", [False, True])
@pytest.mark.parametrize("shared", [True, False])
def test_i2t_update_matches_jax(shared, far):
    """K5's plain version against the JAX package's ``i2t_update`` (its
    Pallas kernel in interpret mode), the next t2i's k|v emitted too.
    ``far``: head 0's logits sit more than 100 above head 1's, where a softmax
    shifted by the max over all heads would underflow head 1 (the JAX
    kernel shifts per head, ops/attention.py `_i2t_kernel`)."""
    rng = np.random.default_rng(7 + shared + 2 * far)
    b, t, m, d, da, heads = 3, 7, 64, 32, 16, 2
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    args = (f(1 if shared else b, m, d), f(1, m, da), f(b, t, da),
            f(b, t, da), f(d, da) * 0.3, f(da), f(da, d) * 0.3, f(d),
            1.0 + 0.1 * f(d), f(d))
    if far:
        args[5][:8] += 6.0          # b_q: head 0's q near +6, head 1's near -6
        args[5][8:] -= 6.0
        args[2][..., :] += 6.0      # tok_k near +6 in both heads
    w_kv = f(d, 2 * da) * 0.3
    want_keys, want_kvt = jax_i2t(*map(jnp.asarray, args), heads, eps=1e-6,
                                  interpret=True,
                                  w_kv_next=jnp.asarray(w_kv))
    keys, kvt = att.i2t_update(*(torch.from_numpy(x) for x in args),
                               torch.from_numpy(w_kv), heads, 1e-6)
    if far:
        q = args[0] @ args[4] + args[1] + args[5]
        s = np.einsum("bmhe,bthe->bhmt", np.broadcast_to(
            q, (b, m, da)).reshape(b, m, heads, da // heads),
            args[2].reshape(b, t, heads, da // heads)) / np.sqrt(da // heads)
        assert (s[:, 0].max(-1) - s[:, 1].max(-1)).min() > 100
    assert np.isfinite(keys.numpy()).all()
    # logits near +-100 carry f32 rounding of ulp(100) = 7.6e-6 (against
    # ~1e-7 at the O(1) logits of the other cases) into each exponent
    atol = 4 * ATOL if far else ATOL
    np.testing.assert_allclose(keys.numpy(), np.asarray(want_keys),
                               atol=atol)
    np.testing.assert_allclose(kvt.numpy(), np.asarray(want_kvt), atol=atol)


LOG2E = 1.4426950408889634


def _rel(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def _token_cross_tf32(q, kvt, pe, vb, heads: int, tk: int, split: bool):
    """The arithmetic of K2's f32 kernel (token_cross.cu
    ``token_cross_kv_tf32x3_kernel``) in f32 on the CPU: k + pe and v +
    bias in f32, tiles of ``tk`` keys (64 for a shared k|v, 32 per prompt),
    S an 8-key block at a time as lo·hi + hi·lo + hi·hi of TF32 planes
    over the head's 16 channels (``split``; else one TF32 product), the
    online softmax in base 2, and each tile's P·V into a fresh accumulator,
    8 keys at a time (lo·hi, hi·lo, hi·hi), joined to O by O·α + tile."""
    b, n, d = q.shape
    hd, m = d // heads, kvt.shape[-1]
    sl = torch.tensor(LOG2E / np.sqrt(hd), dtype=torch.float32)
    qh = q.reshape(b, n, heads, hd).transpose(1, 2)              # [B, H, n, hd]
    kh = (kvt[:, :d] + pe.reshape(1, d, m)).reshape(-1, heads, hd, m)
    vh = (kvt[:, d:] + vb[:, None]).reshape(-1, heads, hd, m).transpose(
        -1, -2)                                                   # [L, H, M, hd]

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
    for k0 in range(0, m, tk):
        k1 = min(k0 + tk, m)
        s = torch.cat([acc_product(None, qh, kh[..., j:j + 8])
                       for j in range(k0, k1, 8)], -1)
        m_new = torch.maximum(mrow, s.amax(-1) * sl)
        alpha = torch.exp2(mrow - m_new)
        p = torch.exp2(s * sl - m_new[..., None])
        lrow = lrow * alpha + p.sum(-1)
        tile = None
        for j in range(0, k1 - k0, 8):
            tile = acc_product(tile, p[..., j:j + 8],
                               vh[..., k0 + j:k0 + j + 8, :])
        o = o * alpha[..., None] + tile
        mrow = m_new
    return (o / lrow[..., None]).transpose(1, 2).reshape(b, n, d)


@pytest.mark.parametrize("scale", [1.0, 2.0])
@pytest.mark.parametrize("shared", [True, False])
def test_split_tf32_token_cross_arithmetic_matches_jax(shared, scale):
    """K2 f32 (shared k|v: 64-key tiles; per prompt: 32) emulated in f32
    is within 1e-5 of JAX ``token_cross_attend_kv`` in f32 (relative to
    the output's largest value); at q, kvt x 2 (scores of std ~4) one
    TF32 pass misses by far. SAM's widths (8 heads of 16, 7 queries); M =
    200 ends on a ragged tile."""
    rng = np.random.default_rng(30 + shared + int(scale))
    b, n, d, heads, m = 3, 7, 128, 8, 200
    q = rng.standard_normal((b, n, d)).astype(np.float32) * np.float32(scale)
    kvt = rng.standard_normal((1 if shared else b, 2 * d, m)).astype(
        np.float32) * np.float32(scale)
    pe = rng.standard_normal((1, d, m)).astype(np.float32)
    vb = rng.standard_normal((d,)).astype(np.float32)
    want = torch.from_numpy(np.array(jax_token_cross_attend_kv(
        *map(jnp.asarray, (q, kvt, pe, vb)), heads)))
    args = [torch.from_numpy(x) for x in (q, kvt, pe, vb)]
    tk = 64 if shared else 32
    assert _rel(_token_cross_tf32(*args, heads, tk, split=True), want) < 1e-5
    if scale > 1:
        assert _rel(_token_cross_tf32(*args, heads, tk, split=False),
                    want) > 1e-5


@pytest.mark.parametrize("scale", [1.0, 2.0])
@pytest.mark.parametrize("shared", [True, False])
def test_split_tf32_token_cross_split_arithmetic_matches_jax(shared, scale):
    """B10 f32 is K2 f32's kernel without pe and v bias (its stage copies k
    and v only and splits them into the same planes): K2 f32's emulation
    with pe and bias at zero (k + 0 and v + 0 are exact) is within 1e-5 of
    JAX ``token_cross_attend`` in f32 (its Pallas kernel in interpret
    mode), shared and per prompt; at q, kᵀ x 2 one TF32 pass misses by
    far. SAM's widths; M = 200 ends on a ragged tile."""
    from revisit_anything_tpu.ops.attention import token_cross_attend
    rng = np.random.default_rng(50 + shared + int(scale))
    b, n, d, heads, m = 3, 7, 128, 8, 200
    lead = 1 if shared else b
    sc = np.float32(scale)
    q = rng.standard_normal((b, n, d)).astype(np.float32) * sc
    kt = rng.standard_normal((lead, d, m)).astype(np.float32) * sc
    vt = rng.standard_normal((lead, d, m)).astype(np.float32)
    want = torch.from_numpy(np.array(token_cross_attend(
        *map(jnp.asarray, (q, kt, vt)), heads)))
    args = (torch.from_numpy(q), torch.from_numpy(np.concatenate([kt, vt], 1)),
            torch.zeros(1, d, m), torch.zeros(d))
    tk = 64 if shared else 32
    assert _rel(_token_cross_tf32(*args, heads, tk, split=True), want) < 1e-5
    if scale > 1:
        assert _rel(_token_cross_tf32(*args, heads, tk, split=False),
                    want) > 1e-5


def _i2t_tf32(img, peq, tok_k, tok_v, w_q, b_q, w_out, b_out, ln_s, ln_b,
              w_kv, heads: int, eps: float, split: bool):
    """The arithmetic of K5's f32 kernel (i2t_update.cu
    ``i2t_update_tf32x3_kernel``) in f32 on the CPU. Each product runs over
    32-wide K chunks as lo·hi + hi·lo + hi·hi of TF32 planes (``split``;
    else one TF32 product): q takes each chunk into a fresh accumulator
    added to an f32 sum, the out-projection and k|v keep one accumulator
    over their chunks. The attention's two products are split TF32 too
    (q_h · k_hᵀ over the head's 16 channels, p · v_h over the tokens), the
    softmax shifted per head (exp2 of the shifted score times log2 e, one
    reciprocal a row); the residual and the LayerNorm (E[y²] − μ², clamped)
    are plain f32."""
    def passes(a, w):
        if not split:
            return _tf32(a) @ _tf32(w)
        (ah, al), (wh, wl) = _split(a), _split(w)
        return (al @ wh + ah @ wl) + ah @ wh

    def product(a, w, fold):
        out = acc = None
        for k0 in range(0, a.shape[-1], 32):
            x, y = a[..., k0:k0 + 32], w[k0:k0 + 32]
            if split:
                (xh, xl), (yh, yl) = _split(x), _split(y)
                terms = (xl @ yh, xh @ yl, xh @ yh)
            else:
                terms = (_tf32(x) @ _tf32(y),)
            if fold:
                acc = None
            for t in terms:
                acc = t if acc is None else acc + t
            if fold:
                out = acc if out is None else out + acc
        return out if fold else acc

    b, t, da = tok_k.shape
    m, d = img.shape[1:]
    hd = da // heads
    q = (product(img, w_q, True) + peq) + b_q                    # [1|B, M, DA]
    qh = q.reshape(q.shape[0], m, heads, hd).transpose(1, 2)
    s = passes(qh, tok_k.reshape(b, t, heads, hd).permute(0, 2, 3, 1)) * 0.25
    e = torch.exp2((s - s.amax(-1, keepdim=True)) * LOG2E)
    p = e * (1.0 / e.sum(-1, keepdim=True))
    a = passes(p, tok_v.reshape(b, t, heads, hd).transpose(1, 2)).transpose(
        1, 2).reshape(b, m, da)
    y = img + (product(a, w_out, False) + b_out)
    mu = y.sum(-1, keepdim=True) / d
    var = torch.clamp((y * y).sum(-1, keepdim=True) / d - mu * mu, min=0.0)
    keys = (y - mu) * (1.0 / torch.sqrt(var + eps)) * ln_s + ln_b
    return keys, product(keys, w_kv, False).transpose(1, 2)


@pytest.mark.parametrize("scale", [1.0, 4.0])
@pytest.mark.parametrize("shared", [True, False])
def test_split_tf32_i2t_arithmetic_matches_jax(shared, scale):
    """K5 f32 emulated in f32 is within 1e-5 of JAX ``i2t_update`` in f32
    (its Pallas kernel in interpret mode; keys and the next k|v, each
    relative to its largest value), on the shared branch (layer 1) and per
    prompt; with the branch and token keys x 4 (sharper softmaxes) one TF32
    pass misses by far. SAM's widths (D 256, DA 128, 8 heads, 7 tokens)."""
    rng = np.random.default_rng(40 + shared + int(scale))
    b, t, m, d, da, heads = 2, 7, 64, 256, 128, 8
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    sc = np.float32(scale)
    args = (f(1 if shared else b, m, d) * sc, f(1, m, da), f(b, t, da) * sc,
            f(b, t, da), f(d, da) * np.float32(0.1), f(da) * np.float32(0.1),
            f(da, d) * np.float32(0.1), f(d) * np.float32(0.1),
            1.0 + np.float32(0.1) * f(d), f(d) * np.float32(0.1))
    w_kv = f(d, d) * np.float32(0.1)
    want = [torch.from_numpy(np.array(x)) for x in jax_i2t(
        *map(jnp.asarray, args), heads, eps=1e-6, interpret=True,
        w_kv_next=jnp.asarray(w_kv))]
    targs = [torch.from_numpy(x) for x in (*args, w_kv)]
    got = _i2t_tf32(*targs, heads, 1e-6, split=True)
    assert max(_rel(g, w) for g, w in zip(got, want)) < 1e-5
    if scale > 1:
        one = _i2t_tf32(*targs, heads, 1e-6, split=False)
        assert max(_rel(g, w) for g, w in zip(one, want)) > 1e-5
