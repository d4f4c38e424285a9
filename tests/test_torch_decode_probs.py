"""Port parity: kernels B7 (``i2t_probs``) and B8 (``t2i_from_probs``) and
the ``c_matrix`` helper against the JAX package's
``ops/decode_probs.py`` (Pallas kernels in interpret mode), f32 on both
sides at a small width (D 32, DA 16, 4 heads, 7 tokens, M 64)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from revisit_anything_tpu.ops import decode_probs as jdp
from revisit_anything_tpu_torch.kernels.probs_compare import (
    PROBS_F32_MOVED, bf16_ulps)
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


# ----------------------------------------------------------------------
# The f32 kernels' arithmetic (B7 f32 layer 2, B8 f32), emulated in f32
# on the CPU in each kernel's order: fp16 x fp16 products are exact in
# f32, so rounding each operand to fp16 and multiplying in f32 is what the
# tensor cores compute, up to the order of the f32 sums.

TP = 16        # positions of a warpgroup's tile (walk_f32.cuh)
P_SCALE = 4096.0      # the context's p planes: p 2^12
PF_SCALE = 32768.0    # the f32 rebuild's P: P 2^15
Q_TOP, Y_TOP, C_TOP = 14, 10, 14


def _f16(x):
    return x.to(torch.float16).to(torch.float32)


def _tf32(x):
    """x rounded to TF32 (10 stored mantissa bits), nearest, ties away."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def _pow2_scale(bound, top):
    """The power of two s with bound s < 2^top (the kernels' pow2_scale),
    elementwise over a tensor of bounds."""
    e = torch.frexp(bound)[1]
    return torch.ldexp(torch.ones_like(bound), torch.clamp(top - e, -126, 126))


def _planes(x, s):
    """x s as fp16 hi and lo planes (x s = hi + lo to 2^-22)."""
    hi = _f16(x * s)
    return hi, _f16(x * s - hi)


def _split3(a, b, eq):
    """hi.hi + (hi.lo + lo.hi) of plane pairs a = (hi, lo), b = (hi, lo)."""
    return (torch.einsum(eq, a[0], b[0])
            + (torch.einsum(eq, a[0], b[1]) + torch.einsum(eq, a[1], b[0])))


def _rebuild(y, p, c, rows3, eps, split=True, residual=None):
    """The f32 rebuild on one tile: y [B, TP, D] the residual, p [B, HT, TP]
    bf16, c [B, HT, D] f32. C as two fp16 planes of C s (split) or rounded
    once to TF32 (one pass), P as fp16 x 2^15; the passes from fresh
    accumulators, then the residual and b, then the one-pass LN."""
    p16 = _f16(p.float() * PF_SCALE)
    if split:
        s = _pow2_scale(c.abs().amax((1, 2), keepdim=True), C_TOP)
        ch, cl = _planes(c, s)
        a = (torch.einsum("bkm,bkd->bmd", p16, ch)
             + torch.einsum("bkm,bkd->bmd", p16, cl)) / (s * PF_SCALE)
    else:
        a = torch.einsum("bkm,bkd->bmd", p16, _tf32(c)) / PF_SCALE
    y = (y + a) + rows3[0]
    d = y.shape[-1]
    mu = y.sum(-1, keepdim=True) / d
    var = torch.clamp((y * y).sum(-1, keepdim=True) / d - mu * mu, min=0.0)
    return (y - mu) * torch.rsqrt(var + eps) * rows3[1] + rows3[2]


def _branch_scale(rows3):
    """The Y planes' s of a layer (branch_scales)."""
    return _pow2_scale((16.0 * rows3[1].abs() + rows3[2].abs()).max(), Y_TOP)


def _query_planes(tok, w, heads):
    """project_rows_tc: Q^[b, h, t, d] = tok_h . W[d, h]^T (f32 sums), as
    planes times the prompt's s (from its max)."""
    b, t, da = tok.shape
    hd = da // heads
    q = torch.einsum("bthj,dhj->bhtd", tok.reshape(b, t, heads, hd),
                     w.reshape(w.shape[0], heads, hd))
    s = _pow2_scale(q.abs().amax((1, 2, 3), keepdim=True), Q_TOP)
    return _planes(q, s), s


def _scores(qp, yp, unscale):
    """The scores as the f32 walk (walk_f32.cuh) sums them: each warp's
    64-channel quarter as three fp16 products of the planes, the quarters
    added in order, times 1 / the planes' s."""
    s = None
    for w in range(4):
        sl = slice(64 * w, 64 * w + 64)
        part = _split3((qp[0][..., sl], qp[1][..., sl]),
                       (yp[0][..., sl], yp[1][..., sl]), "bhtd,bmd->bhtm")
        s = part if s is None else s + part
    return s * unscale


def _pe_term(tok, pet, heads):
    b, t, da = tok.shape
    hd = da // heads
    return torch.einsum("bthj,hjm->bhtm", tok.reshape(b, t, heads, hd),
                        pet.reshape(heads, hd, -1))


def _i2t_l2_f32(tok_k, img0, p1, c1, peq2t, w_q, rows, heads, eps=1e-6,
                split=True):
    """B7 f32 layer 2 (walk_f32.cuh's walk, PROBS) tile by tile: keys1
    rebuilt (``split`` False: C rounded once to TF32), the scores K2 .
    keys1^T as three fp16 products of the planes a channel quarter, the pe
    term in f32, the softmax over the tokens, P bf16."""
    b, t, da = tok_k.shape
    hd = da // heads
    (qh, ql), sq = _query_planes(tok_k, w_q, heads)
    ys = _branch_scale(rows[0:3])
    pe = _pe_term(tok_k, peq2t, heads)
    out = []
    for m0 in range(0, img0.shape[1], TP):
        keys1 = _rebuild(img0[:, m0:m0 + TP], p1[..., m0:m0 + TP], c1,
                         rows[0:3], eps, split)
        s = _scores((qh, ql), _planes(keys1, ys), 1.0 / (sq * ys))
        s = (s + pe[..., m0:m0 + TP]) * (1.0 / np.sqrt(hd))
        out.append(torch.softmax(s, dim=2))
    return torch.cat(out, -1).to(torch.bfloat16).reshape(b, heads * t, -1)


def _t2i_f32(q, img0, p1, c1, p2, c2, w_k, w_v, pekt, rows, v_bias, heads,
             eps=1e-6, split=True):
    """B8 f32 (walk_f32.cuh's walk, ATTEND) tile by tile: the branch
    rebuilt (``split`` False: C rounded once to TF32), the scores (q_h
    W_k,h^T) . keys as three fp16 products of the planes a channel quarter
    plus the pe term, two online softmaxes (one a warpgroup: the even and
    the odd 16-position tiles) with p as planes times 2^12 and each tile's
    context from a fresh accumulator joined by an f32 multiply-add, the
    two merged at the end, then the value projection in f32."""
    b, t, da = q.shape
    hd = da // heads
    depth = 1 if p2 is None else 2
    (qh, ql), sq = _query_planes(q, w_k, heads)
    ys = _branch_scale(rows[3:6] if depth == 2 else rows[0:3])
    pe = _pe_term(q, pekt, heads)
    states = [[torch.full((b, heads, t), -torch.inf),
               torch.zeros((b, heads, t)),
               torch.zeros((b, heads, t, img0.shape[-1]))] for _ in range(2)]
    for i, m0 in enumerate(range(0, img0.shape[1], TP)):
        st = states[i % 2]
        sl = slice(m0, m0 + TP)
        y = _rebuild(img0[:, sl], p1[..., sl], c1, rows[0:3], eps, split)
        if depth == 2:
            y = _rebuild(y, p2[..., sl], c2, rows[3:6], eps, split)
        yp = _planes(y, ys)
        s = _scores((qh, ql), yp, 1.0 / (sq * ys))
        s = (s + pe[..., sl]) * (1.0 / np.sqrt(hd))
        m_new = torch.maximum(st[0], s.amax(-1))
        alpha = torch.exp(st[0] - m_new)
        p = torch.exp(s - m_new[..., None])
        st[1] = st[1] * alpha + p.sum(-1)
        ph, pl = _planes(p, P_SCALE)
        tile = (torch.einsum("bhtm,bmd->bhtd", ph, yp[0])
                + torch.einsum("bhtm,bmd->bhtd", ph, yp[1])
                + torch.einsum("bhtm,bmd->bhtd", pl, yp[0]))
        st[2] = st[2] * alpha[..., None] + tile
        st[0] = m_new
    (m0_, l0, c0), (m1_, l1, c1_) = states
    mm = torch.maximum(m0_, m1_)
    e0, e1 = torch.exp(m0_ - mm), torch.exp(m1_ - mm)
    inv = (1.0 / (P_SCALE * ys)) / (l0 * e0 + l1 * e1)
    ctx = (c0 * e0[..., None] + c1_ * e1[..., None]) * inv[..., None]
    o = torch.einsum("bhtd,dhj->bthj", ctx,
                     w_v.reshape(w_v.shape[0], heads, hd))
    return o.reshape(b, t, da) + v_bias


def _jax_t2i(p, c1, c2, depth):
    """JAX ``t2i_from_probs`` in f32 (interpret mode, "highest" products)."""
    import jax
    with jax.default_matmul_precision("highest"):
        return np.asarray(jdp.t2i_from_probs(
            jnp.asarray(p["q_tok"]), jnp.asarray(p["img0"]).transpose(0, 2, 1),
            jnp.asarray(p["p1"]), jnp.asarray(c1),
            jnp.asarray(p["p2"]) if depth == 2 else None,
            jnp.asarray(c2) if depth == 2 else None, jnp.asarray(p["w_k"]),
            jnp.asarray(p["w_v"]), jnp.asarray(p["pekt"]),
            _vecs(p, depth, p["v_bias"]), H, interpret=True))


@pytest.mark.parametrize("c_scale", [1.0, 8.0])
def test_split_f16_i2t_probs_arithmetic_matches_jax(state, c_scale):
    """B7 f32 layer 2 emulated in f32 (C1 as two fp16 planes, P1 as fp16,
    the scores as three fp16 products of planes) gives JAX ``i2t_probs``'s
    bf16 P in f32 (interpret mode) within one bf16 ulp everywhere, moved in
    at most PROBS_F32_MOVED of its elements (the gpu test's criterion);
    with C1 x 8, C1 rounded once to TF32 fails that criterion."""
    import jax
    p = state
    c1 = p["c1"] * np.float32(c_scale)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jdp.i2t_probs(
            None, jnp.asarray(p["tok_k2"]), H, layer=2,
            recon=(jnp.asarray(p["img0"]).transpose(0, 2, 1),
                   jnp.asarray(p["p1"]), jnp.asarray(c1),
                   jnp.asarray(p["peq2t"]), jnp.asarray(p["w_q"]),
                   _vecs(p, 1)), interpret=True), np.float32)
    args = (_t(p["tok_k2"]), _t(p["img0"]), _t(p["p1"]).to(torch.bfloat16),
            _t(c1), _t(p["peq2t"]), _t(p["w_q"]), _t(p["rows"]), H)
    got = _i2t_l2_f32(*args)
    assert_probs_close(got.float().numpy(), want)
    ulps, moved = bf16_ulps(got, torch.from_numpy(want))
    assert ulps <= 1.0 and moved <= PROBS_F32_MOVED
    if c_scale > 1:
        ulps, moved = bf16_ulps(_i2t_l2_f32(*args, split=False),
                                torch.from_numpy(want))
        assert ulps > 1.0 or moved > PROBS_F32_MOVED


@pytest.mark.parametrize("c_scale", [1.0, 8.0])
@pytest.mark.parametrize("depth", [1, 2])
def test_split_f16_t2i_from_probs_arithmetic_matches_jax(state, depth,
                                                         c_scale):
    """B8 f32 emulated in f32 (C as two fp16 planes, P as fp16, scores and
    context as three fp16 products of planes, two online softmaxes over
    alternate 16-position tiles, merged) is within 1e-5 of JAX ``t2i_from_probs`` in f32
    (relative to the output's largest value), at depths 1 and 2; with C x
    8 (the rebuild's product outweighs img0) C rounded once to TF32 misses
    by more than 1e-5."""
    p = state
    c1 = p["c1"] * np.float32(c_scale)
    c2 = p["c2"] * np.float32(c_scale)
    want = _jax_t2i(p, c1, c2, depth)
    args = (_t(p["q_tok"]), _t(p["img0"]), _t(p["p1"]).to(torch.bfloat16),
            _t(c1), _t(p["p2"]).to(torch.bfloat16) if depth == 2 else None,
            _t(c2) if depth == 2 else None, _t(p["w_k"]), _t(p["w_v"]),
            _t(p["pekt"]), _t(p["rows"]), _t(p["v_bias"]), H)
    assert _rel(_t2i_f32(*args).numpy(), want) < 1e-5
    if c_scale > 1:
        assert _rel(_t2i_f32(*args, split=False).numpy(), want) > 1e-5


@pytest.mark.parametrize("tok_dtype", [torch.bfloat16, torch.float32])
def test_probs_kernel_operands_are_never_cast(state, tok_dtype):
    """The operand lists B7's and B8's CUDA branches hand ``operand``: each
    activation (img0, C, the pe terms, q1st) is the caller's own tensor
    held to the token vectors' dtype (an f32 img0 beside bf16 tokens makes
    the bf16 kernel raise, never rounds it), P is bf16, and only the
    weights the plain version converts (W_q, W_k, W_v, v_bias) are
    converted; the rows are the caller's."""
    p = state
    f32 = {k: _t(v) for k, v in p.items()}
    tok = f32["tok_k2"].to(tok_dtype)
    p1 = f32["p1"].to(torch.bfloat16)
    acts = dict(img0=f32["img0"], c1=f32["c1"], peq2t=f32["peq2t"],
                branch_rows=f32["rows"], q1st=f32["q1st"], c2=f32["c2"],
                pekt=f32["pekt"], p1=p1, p2=p1)
    layer1 = pdp.i2t_operands(acts["q1st"], tok, H, 1, None)
    layer2 = pdp.i2t_operands(None, tok, H, 2, (
        acts["img0"], p1, acts["c1"], acts["peq2t"], f32["w_q"],
        acts["branch_rows"]))
    q = f32["q_tok"].to(tok_dtype)
    attend = pdp.t2i_operands(q, acts["img0"], p1, acts["c1"], p1,
                              acts["c2"], f32["w_k"], f32["w_v"],
                              acts["pekt"], acts["branch_rows"],
                              f32["v_bias"], H)
    assert [x is None for x in layer1] == [False] * 2 + [True] * 6
    assert layer2[0] is None and len(attend) == 11
    for name, x, dtype, shape in [x for x in layer1 + layer2 + attend if x]:
        if name in ("w_q", "w_k", "w_v", "v_bias"):
            assert x.dtype == dtype == tok_dtype
        elif name in ("tok_k", "q_tok"):
            assert dtype == tok_dtype
        else:
            assert x is acts[name], name
            assert dtype == (torch.bfloat16 if name in ("p1", "p2")
                             else tok_dtype), name
        assert tuple(x.shape) == tuple(shape), name
