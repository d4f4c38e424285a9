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


def _tf32_attend(q, k, v, split: bool) -> torch.Tensor:
    """The arithmetic of K1's f32 kernel (flash_attention.cu
    ``flash_attention_tf32x3_kernel``) in f32 on the CPU: tiles of 64 keys
    (32 at head dim 80), the online softmax in base 2, and each product
    as lo·hi + hi·lo + hi·hi of TF32 planes summed in that order
    (``split``), or as one TF32 product; each tile's P·V joined to O by
    O·α + tile."""
    dh, n = q.shape[-1], k.shape[-2]
    bk = 64 if dh == 64 else 32
    sl = torch.tensor(1.4426950408889634 / np.sqrt(dh), dtype=torch.float32)

    def product(a, b):
        if not split:
            return _tf32(a) @ _tf32(b)
        (ah, al), (bh, bl) = _split(a), _split(b)
        return al @ bh + ah @ bl + ah @ bh

    m = torch.full(q.shape[:-1], -torch.inf)
    l = torch.zeros(q.shape[:-1])
    o = torch.zeros(q.shape)
    for k0 in range(0, n, bk):
        s = product(q, k[..., k0:k0 + bk, :].transpose(-1, -2))
        m_new = torch.maximum(m, s.amax(-1) * sl)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s * sl - m_new[..., None])
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
    from revisit_anything_tpu.ops.attention import i2t_update as jax_i2t
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
