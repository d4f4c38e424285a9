"""Probability-factored SAM decode: kernels B7 (image→token attention
probabilities) and B8 (token→image attention against the rebuilt
branch), each beside its plain PyTorch version.

Counterpart of ``revisit_anything_tpu/ops/decode_probs.py`` (``i2t_probs``
:335, ``t2i_from_probs`` :370, ``_recon_t`` :51, ``_head_softmax_rows``
:79). The per-prompt image branch is never stored: after each
image→token update it is

    keys_l = LN(keys_{l-1} + P_lᵀ C_l + b_l),    keys_0 = img0

with P_l the update's softmax probabilities, stored transposed as
P^T [B, H·T, M] bf16 (row h·T + t), and C_l [B, H·T, D] the per-head
value·out-projection product (:func:`c_matrix`). Every consumer rebuilds
the branch from (img0, P, C) in f32.

Layouts: img0 [1, M, D] (the shared branch input in its normal layout);
the positional terms q1st / peq2t / pekt [1, DA, M] transposed, as the
JAX package passes them; ``branch_rows`` [8, D]: rows 0-2 the layer-1
out-projection bias, LayerNorm scale and bias, rows 3-5 layer 2's
(``decoder._pack_branch_rows`` in the JAX package).

A wrapper takes the plain version only for CPU tensors; for CUDA tensors
it launches its kernel or raises. The kernels come in bf16 and f32 (an
f32 SAM, the JAX package's dtype), picked by the dtype of the token
vectors; every activation operand (img0, C, the pe terms) must have that
dtype and is never cast, P is bf16 in both, and weights are converted
only where the plain version converts them.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from revisit_anything_tpu_torch.kernels.build import (I2T_PROBS,
                                                      I2T_PROBS_F32,
                                                      T2I_PROBS,
                                                      T2I_PROBS_F32, operand)
from revisit_anything_tpu_torch.ops.attention import kernel_dtype

# the shapes the kernels are built for: D, DA, heads, tokens
KERNEL_DIMS = (256, 128, 8, 7)


def c_matrix(tok_v: torch.Tensor, w_out: torch.Tensor,
             heads: int) -> torch.Tensor:
    """C[b, h·T + t, :] = v[b, t, h·hd:(h+1)·hd] · W_out[h·hd:(h+1)·hd, :],
    f32-accumulated and rounded to v's dtype: tok_v [B, T, DA], w_out
    [DA, D] → [B, H·T, D]. (The JAX package's block-diagonal einsum,
    ``decoder.py:421-423``.)"""
    b, t, da = tok_v.shape
    hd = da // heads
    vh = tok_v.float().reshape(b, t, heads, hd).transpose(1, 2)
    wh = w_out.to(tok_v.dtype).float().reshape(heads, hd, -1)
    return torch.matmul(vh, wh).reshape(b, heads * t, -1).to(tok_v.dtype)


def recon_branch(img0: torch.Tensor, ps: Sequence[torch.Tensor],
                 cs: Sequence[torch.Tensor], rows: torch.Tensor,
                 eps: float) -> torch.Tensor:
    """The branch after ``len(ps)`` image→token updates, in f32:
    y = img0; y = LN(y + Pᵀ·C + b_l) per layer, with the one-pass
    variance max(E[y²] − μ², 0). img0 [1, M, D] → [B, M, D]."""
    y = img0.float()
    for li, (p, c) in enumerate(zip(ps, cs)):
        y = recon_step(y, p, c, rows[3 * li:3 * li + 3], eps)
    return y


def recon_step(y: torch.Tensor, p: torch.Tensor, c: torch.Tensor,
               rows3: torch.Tensor, eps: float) -> torch.Tensor:
    """One update of the f32 branch: LN(y + Pᵀ·C + b) with rows3 =
    (b, LN scale, LN bias)."""
    y = y + torch.matmul(p.float().transpose(1, 2), c.float()) \
        + rows3[0].float()
    mu = y.mean(-1, keepdim=True)
    var = torch.clamp((y * y).mean(-1, keepdim=True) - mu * mu, min=0.0)
    return (y - mu) * torch.rsqrt(var + eps) * rows3[1].float() \
        + rows3[2].float()


def branch_probs(keys: torch.Tensor, w_q: torch.Tensor, peqt: torch.Tensor,
                 tok_k: torch.Tensor, heads: int) -> torch.Tensor:
    """P^T of the image→token attention whose queries are the f32 branch
    ``keys`` [B, M, D] projected by w_q plus the pe term peqt [1, DA, M]."""
    q = torch.matmul(keys, w_q.to(tok_k.dtype).float()) \
        + peqt.float().transpose(1, 2)
    return _head_softmax(q, tok_k, heads)


def branch_attend(q_tok: torch.Tensor, keys: torch.Tensor, w_k: torch.Tensor,
                  w_v: torch.Tensor, pekt: torch.Tensor, v_bias: torch.Tensor,
                  heads: int) -> torch.Tensor:
    """Token→image attention of q_tok [B, T, DA] over the f32 branch keys
    [B, M, D]: k = keys·W_k + pe terms, v = keys·W_v + v_bias, per-head
    f32 softmax over M; the output rounded to q's dtype."""
    b, t, da = q_tok.shape
    hd = da // heads
    dt = q_tok.dtype
    k = torch.matmul(keys, w_k.to(dt).float()) + pekt.float().transpose(1, 2)
    v = torch.matmul(keys, w_v.to(dt).float()) + v_bias.to(dt).float()
    qh = q_tok.float().reshape(b, t, heads, hd)
    s = torch.einsum("bthj,bmhj->bhtm", qh,
                     k.reshape(b, -1, heads, hd)) / math.sqrt(hd)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhtm,bmhj->bthj", p, v.reshape(b, -1, heads, hd))
    return o.reshape(b, t, da).to(dt)


def _head_softmax(q: torch.Tensor, tok_k: torch.Tensor,
                  heads: int) -> torch.Tensor:
    """Per-head softmax over the T tokens of q·k/√hd: q [B or 1, M, DA]
    f32, tok_k [B, T, DA] → P^T [B, H·T, M] bf16."""
    b, t, da = tok_k.shape
    hd = da // heads
    kh = tok_k.float().reshape(b, t, heads, hd)
    qh = q.reshape(q.shape[0], q.shape[1], heads, hd)
    s = torch.einsum("bthj,bmhj->bhtm", kh, qh) / math.sqrt(hd)
    return torch.softmax(s, dim=2).to(torch.bfloat16).reshape(
        b, heads * t, -1)


def i2t_probs_reference(q1st: Optional[torch.Tensor], tok_k: torch.Tensor,
                        heads: int, *, layer: int = 1,
                        recon: Optional[Tuple] = None,
                        eps: float = 1e-6) -> torch.Tensor:
    """Plain version of :func:`i2t_probs`."""
    if layer == 1:
        return _head_softmax(q1st.float().transpose(1, 2), tok_k, heads)
    img0, p1, c1, peq2t, w_q, rows = recon
    keys1 = recon_branch(img0, [p1], [c1], rows, eps)
    return branch_probs(keys1, w_q, peq2t, tok_k, heads)


def i2t_probs(q1st: Optional[torch.Tensor], tok_k: torch.Tensor,
              heads: int, *, layer: int = 1,
              recon: Optional[Tuple] = None,
              eps: float = 1e-6) -> torch.Tensor:
    """Image→token attention probabilities, transposed: P^T [B, H·T, M]
    bf16, the softmax over each head's T tokens of q_m·k_t/√hd.

    Layer 1: q1st [1, DA, M] the shared queries ((img0 + pe)·Wq + bq)ᵀ.
    Layer 2: ``recon`` = (img0 [1, M, D], p1, c1 [B, H·T, D], peq2t
    [1, DA, M] = (pe·Wq2 + bq2)ᵀ, w_q [D, DA], branch_rows [8, D]); the
    queries are keys1·Wq2 + peq2 with keys1 rebuilt in the kernel.
    tok_k [B, T, DA] the projected token keys.

    CUDA: kernel B7 in bf16 or f32 by tok_k's dtype (D 256, DA 128, 8
    heads, 7 tokens, M a multiple of 32); P is bf16 in both, as the plain
    version rounds it. Layer 1 computes the scores on the FMA units, as
    the plain version rounds them. Layer 2 rebuilds keys1 a tile at a
    time on the tensor cores onto img0 in f32: from bf16 P1 and C1 by
    bf16 products, exact up to the order of summation (32-position tiles),
    or, with an f32 C1, as two fp16 products of P1 against C1's
    power-of-two-scaled hi/lo planes (22 bits of C1; two warpgroups on
    alternate 16-position tiles). It projects on the
    query side, s = (k_h·W_q,hᵀ)·keys1 + k_h·peq2_h, with the product
    against the f32 branch as three fp16 products of power-of-two-scaled
    hi/lo planes, 22 bits of each operand. The result is the same
    function up to f32 reassociation. CPU: :func:`i2t_probs_reference`."""
    if not tok_k.is_cuda:
        return i2t_probs_reference(q1st, tok_k, heads, layer=layer,
                                   recon=recon, eps=eps)
    b, t, da = tok_k.shape
    dt = kernel_dtype("i2t probs", tok_k)
    if layer == 1:
        m = q1st.shape[-1]
        d = KERNEL_DIMS[0]
    else:
        m, d = recon[0].shape[1], recon[0].shape[2]
    if (d, da, heads, t) != KERNEL_DIMS or m % 32:
        raise ValueError(f"i2t probs: (D={d}, DA={da}, heads={heads}, T={t}, "
                         f"M={m}) not built ({KERNEL_DIMS}, M % 32 == 0)")
    ptrs = [None if x is None else operand(*x).data_ptr()
            for x in i2t_operands(q1st, tok_k, heads, layer, recon)]
    out = torch.empty((b, heads * t, m), dtype=torch.bfloat16,
                      device=tok_k.device)
    (I2T_PROBS_F32 if dt == torch.float32 else I2T_PROBS).launch(
        *ptrs, out.data_ptr(), b, m, int(layer), float(eps))
    return out


def i2t_operands(q1st, tok_k, heads: int, layer: int, recon) -> list:
    """What :func:`i2t_probs` hands its kernel before the output, in the C
    entry's order (q1st, tok_k, img0, p1, c1, peq2t, w_q, rows): each
    ``(name, tensor, dtype, shape)`` for ``operand``, None where the layer
    reads nothing. The activations are the caller's tensors, held to
    tok_k's dtype and never cast; P1 is bf16; W_q is converted to tok_k's
    dtype, as the plain version converts it; the rows are never rounded."""
    b, t, da = tok_k.shape
    dt = tok_k.dtype
    tk = ("tok_k", tok_k, dt, (b, t, da))
    if layer == 1:
        return [("q1st", q1st, dt, (1, da, q1st.shape[-1])), tk] + [None] * 6
    img0, p1, c1, peq2t, w_q, rows = recon
    _, m, d = img0.shape
    ht = heads * t
    return [None, tk, ("img0", img0, dt, (1, m, d)),
            ("p1", p1, torch.bfloat16, (b, ht, m)),
            ("c1", c1, dt, (b, ht, d)), ("peq2t", peq2t, dt, (1, da, m)),
            ("w_q", w_q.to(dt), dt, (d, da)),
            ("branch_rows", rows, dt, (8, d))]


def t2i_from_probs_reference(q_tok, img0, p1, c1, p2, c2, w_k, w_v, pekt,
                             rows, v_bias, heads: int,
                             eps: float = 1e-6) -> torch.Tensor:
    """Plain version of :func:`t2i_from_probs`: the branch rebuilt in
    f32, its k|v projected (k + pe terms, v + bias), a per-head f32
    softmax over M, the output rounded to q's dtype."""
    ps, cs = ([p1], [c1]) if p2 is None else ([p1, p2], [c1, c2])
    keys = recon_branch(img0, ps, cs, rows, eps)
    return branch_attend(q_tok, keys, w_k, w_v, pekt, v_bias, heads)


def t2i_from_probs(q_tok: torch.Tensor, img0: torch.Tensor,
                   p1: torch.Tensor, c1: torch.Tensor,
                   p2: Optional[torch.Tensor], c2: Optional[torch.Tensor],
                   w_k: torch.Tensor, w_v: torch.Tensor, pekt: torch.Tensor,
                   rows: torch.Tensor, v_bias: torch.Tensor, heads: int,
                   eps: float = 1e-6) -> torch.Tensor:
    """Token→image attention against the branch rebuilt from P and C at
    depth 1 (``p2 is None``: the layer-2 t2i) or 2 (the final attention).

    q_tok [B, T, DA] projected token queries; img0 [1, M, D]; w_k, w_v
    [D, DA]; pekt [1, DA, M] = (pe·Wk + bk)ᵀ; rows [8, D] branch rows;
    v_bias [DA]. Returns the pre-out-projection output [B, T, DA].

    CUDA: kernel B8 in bf16 or f32 by q_tok's dtype (the shapes of
    :func:`i2t_probs`; P1, P2 bf16 in both). The kernel rebuilds the
    branch a tile at a time on the tensor cores onto the f32 branch (bf16
    P·C on 32-position tiles, or with f32 C two fp16 products against C's
    power-of-two-scaled hi/lo planes on 16-position tiles, two warpgroups
    on alternate ones) and projects on the query side: s =
    (q_h·W_k,hᵀ)·keys + q_h·pe_k,h and o = (p·keys)·W_v + v_bias, with an
    online softmax over the tiles (in f32 one a warpgroup, the two merged
    in a fixed order at the end). The scores and p·keys against
    the f32 branch run as three fp16 products of power-of-two-scaled
    hi/lo planes, 22 bits of each operand. The output has q_tok's dtype
    (bf16 rounded, f32 unrounded). The result is the same function up to
    f32 reassociation. CPU: :func:`t2i_from_probs_reference`."""
    if not q_tok.is_cuda:
        return t2i_from_probs_reference(q_tok, img0, p1, c1, p2, c2, w_k,
                                        w_v, pekt, rows, v_bias, heads, eps)
    b, t, da = q_tok.shape
    _, m, d = img0.shape
    dt = kernel_dtype("t2i from probs", q_tok)
    if (d, da, heads, t) != KERNEL_DIMS or m % 32:
        raise ValueError(f"t2i from probs: (D={d}, DA={da}, heads={heads}, "
                         f"T={t}, M={m}) not built ({KERNEL_DIMS}, "
                         "M % 32 == 0)")
    depth = 1 if p2 is None else 2
    ptrs = [None if x is None else operand(*x).data_ptr()
            for x in t2i_operands(q_tok, img0, p1, c1, p2, c2, w_k, w_v,
                                  pekt, rows, v_bias, heads)]
    out = torch.empty((b, t, da), dtype=dt, device=q_tok.device)
    (T2I_PROBS_F32 if dt == torch.float32 else T2I_PROBS).launch(
        *ptrs, out.data_ptr(), b, m, depth, float(eps))
    return out


def t2i_operands(q_tok, img0, p1, c1, p2, c2, w_k, w_v, pekt, rows, v_bias,
                 heads: int) -> list:
    """What :func:`t2i_from_probs` hands its kernel before the output, in
    the C entry's order (q, img0, p1, c1, p2, c2, w_k, w_v, pekt, rows,
    v_bias), as :func:`i2t_operands`: the activations held to q_tok's
    dtype and never cast, P bf16, W_k, W_v and v_bias converted to q_tok's
    dtype as the plain version converts them, the rows never rounded;
    p2 and c2 None at depth 1."""
    b, t, da = q_tok.shape
    _, m, d = img0.shape
    dt, bf, ht = q_tok.dtype, torch.bfloat16, heads * t
    deep = p2 is not None
    return [("q_tok", q_tok, dt, (b, t, da)), ("img0", img0, dt, (1, m, d)),
            ("p1", p1, bf, (b, ht, m)), ("c1", c1, dt, (b, ht, d)),
            ("p2", p2, bf, (b, ht, m)) if deep else None,
            ("c2", c2, dt, (b, ht, d)) if deep else None,
            ("w_k", w_k.to(dt), dt, (d, da)), ("w_v", w_v.to(dt), dt, (d, da)),
            ("pekt", pekt, dt, (1, da, m)), ("branch_rows", rows, dt, (8, d)),
            ("v_bias", v_bias.to(dt), dt, (da,))]
