"""Port parity: kernels B7 (``i2t_probs``) and B8 (``t2i_from_probs``) and
the ``c_matrix`` helper against the JAX package's
``ops/decode_probs.py`` (Pallas kernels in interpret mode), f32 on both
sides at a small width (D 32, DA 16, 4 heads, 7 tokens, M 64)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from revisit_anything_tpu.ops import decode_probs as jdp
from revisit_anything_tpu_torch.ops import decode_probs as pdp

torch.set_float32_matmul_precision("highest")

B, T, H, D, DA, M = 3, 7, 4, 32, 16, 64
REL = 1e-4     # f32 both sides: summation order and reassociation only


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)


def bf16_ulp(x):
    """One unit in the last place of bf16 values x (8 significant bits)."""
    _, e = np.frexp(np.abs(np.asarray(x, np.float32)))
    return np.ldexp(1.0, e - 8)


def assert_probs_close(got, want):
    """P is rounded to bf16 once: an f32 summation-order change may move
    a value across a rounding boundary, never by more than one ulp."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= bf16_ulp(want))


@pytest.fixture(scope="module")
def state():
    rng = np.random.default_rng(0)

    def rnd(*shape, s=1.0, off=0.0):
        return (rng.standard_normal(shape) * s + off).astype(np.float32)

    p = dict(img0=rnd(1, M, D), q1st=rnd(1, DA, M), tok_k=rnd(B, T, DA),
             tok_v=rnd(B, T, DA), w_out=rnd(DA, D, s=0.3), w_q=rnd(D, DA, s=0.3),
             peq2t=rnd(1, DA, M), tok_k2=rnd(B, T, DA), q_tok=rnd(B, T, DA),
             w_k=rnd(D, DA, s=0.3), w_v=rnd(D, DA, s=0.3), pekt=rnd(1, DA, M),
             v_bias=rnd(DA, s=0.1), rows=np.zeros((8, D), np.float32))
    p["rows"][0::3][:2] = rnd(2, D, s=0.1)            # out-projection biases
    p["rows"][1::3][:2] = rnd(2, D, s=0.1, off=1.0)   # LN scales
    p["rows"][2::3][:2] = rnd(2, D, s=0.1)            # LN biases
    # C and P from the JAX package: the inputs every consumer reads
    c1 = np.asarray(jnp.einsum(
        "bkd,de->bke", jdp._block_diag_tokens_t(jnp.asarray(p["tok_v"]), H),
        jnp.asarray(p["w_out"])))
    p["c1"] = c1
    p["c2"] = rnd(B, H * T, D, s=0.3)
    p["p1"] = np.asarray(jdp.i2t_probs(jnp.asarray(p["q1st"]),
                                       jnp.asarray(p["tok_k"]), H, layer=1,
                                       interpret=True))
    p["p2"] = np.asarray(jdp.i2t_probs(jnp.asarray(p["q1st"]),
                                       jnp.asarray(p["tok_k2"]), H, layer=1,
                                       interpret=True))
    return p


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _vecs(p, depth, v_bias=None):
    r = p["rows"]
    kw = {} if depth == 1 else dict(b2=r[3], s2=r[4], bi2=r[5])
    if v_bias is not None:
        kw["v_bias"] = jnp.asarray(v_bias)
    return jdp._pack_branch_vecs(D, DA, jnp.float32, jnp.asarray(r[0]),
                                 jnp.asarray(r[1]), jnp.asarray(r[2]),
                                 **{k: jnp.asarray(v) for k, v in kw.items()})


def test_c_matrix_matches_jax_einsum(state):
    p = state
    got = pdp.c_matrix(_t(p["tok_v"]), _t(p["w_out"]), H).numpy()
    assert got.shape == (B, H * T, D)
    assert _rel(got, p["c1"]) < REL


@pytest.mark.parametrize("layer", [1, 2])
def test_i2t_probs_matches_jax(state, layer):
    p = state
    if layer == 1:
        want = jdp.i2t_probs(jnp.asarray(p["q1st"]), jnp.asarray(p["tok_k"]),
                             H, layer=1, interpret=True)
        got = pdp.i2t_probs(_t(p["q1st"]), _t(p["tok_k"]), H, layer=1)
    else:
        want = jdp.i2t_probs(
            None, jnp.asarray(p["tok_k2"]), H, layer=2,
            recon=(jnp.asarray(p["img0"]).transpose(0, 2, 1),
                   jnp.asarray(p["p1"]), jnp.asarray(p["c1"]),
                   jnp.asarray(p["peq2t"]), jnp.asarray(p["w_q"]),
                   _vecs(p, 1)), interpret=True)
        got = pdp.i2t_probs(None, _t(p["tok_k2"]), H, layer=2,
                            recon=(_t(p["img0"]), torch.from_numpy(
                                np.asarray(p["p1"], np.float32)).to(
                                    torch.bfloat16), _t(p["c1"]),
                                   _t(p["peq2t"]), _t(p["w_q"]),
                                   _t(p["rows"])))
    assert got.dtype == torch.bfloat16
    assert_probs_close(got.float().numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize("depth", [1, 2])
def test_t2i_from_probs_matches_jax(state, depth):
    p = state
    p1 = jnp.asarray(p["p1"])
    p2 = jnp.asarray(p["p2"]) if depth == 2 else None
    c2 = jnp.asarray(p["c2"]) if depth == 2 else None
    want = np.asarray(jdp.t2i_from_probs(
        jnp.asarray(p["q_tok"]), jnp.asarray(p["img0"]).transpose(0, 2, 1),
        p1, jnp.asarray(p["c1"]), p2, c2, jnp.asarray(p["w_k"]),
        jnp.asarray(p["w_v"]), jnp.asarray(p["pekt"]),
        _vecs(p, depth, p["v_bias"]), H, interpret=True))

    def bf(x):
        return torch.from_numpy(np.array(x, np.float32)).to(torch.bfloat16)

    got = pdp.t2i_from_probs(
        _t(p["q_tok"]), _t(p["img0"]), bf(p["p1"]), _t(p["c1"]),
        bf(p["p2"]) if depth == 2 else None,
        _t(p["c2"]) if depth == 2 else None, _t(p["w_k"]), _t(p["w_v"]),
        _t(p["pekt"]), _t(p["rows"]), _t(p["v_bias"]), H).numpy()
    assert got.shape == want.shape == (B, T, DA)
    assert _rel(got, want) < REL
