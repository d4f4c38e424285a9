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
it launches its kernel or raises.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from revisit_anything_tpu_torch.kernels.build import (I2T_PROBS, T2I_PROBS,
                                                      operand)

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

    CUDA: kernel B7 (bf16; D 256, DA 128, 8 heads, 7 tokens, M a
    multiple of 32). Layer 1 computes the scores on the FMA units, as
    the plain version rounds them. Layer 2 rebuilds keys1 a 32-position
    tile at a time on the tensor cores, from bf16 P1 and C1 onto the f32
    img0, exact up to the order of summation. It projects on the query
    side, s = (k_h·W_q,hᵀ)·keys1 + k_h·peq2_h, with the product against
    the f32 branch as three fp16 products of power-of-two-scaled hi/lo
    planes, 22 bits of each operand. The result is the same function up
    to f32 reassociation. CPU: :func:`i2t_probs_reference`."""
    if not tok_k.is_cuda:
        return i2t_probs_reference(q1st, tok_k, heads, layer=layer,
                                   recon=recon, eps=eps)
    b, t, da = tok_k.shape
    bf = torch.bfloat16
    if layer == 1:
        m = q1st.shape[-1]
        d = KERNEL_DIMS[0]
    else:
        img0 = recon[0]
        m, d = img0.shape[1], img0.shape[2]
    if (d, da, heads, t) != KERNEL_DIMS or m % 32:
        raise ValueError(f"i2t probs: (D={d}, DA={da}, heads={heads}, T={t}, "
                         f"M={m}) not built ({KERNEL_DIMS}, M % 32 == 0)")
    tk = operand("tok_k", tok_k, bf, (b, t, da))
    if layer == 1:
        q1 = operand("q1st", q1st, bf, (1, da, m)).data_ptr()
        rest = [None] * 6
    else:
        img0, p1, c1, peq2t, w_q, rows = recon
        q1 = None
        rest = [operand(name, x.to(bf), bf, shape) for name, x, shape in (
            ("img0", img0, (1, m, d)), ("p1", p1, (b, heads * t, m)),
            ("c1", c1, (b, heads * t, d)), ("peq2t", peq2t, (1, da, m)),
            ("w_q", w_q, (d, da)), ("branch_rows", rows, (8, d)))]
    out = torch.empty((b, heads * t, m), dtype=bf, device=tok_k.device)
    I2T_PROBS.launch(q1, tk.data_ptr(),
                     *(x if x is None else x.data_ptr() for x in rest),
                     out.data_ptr(), b, m, int(layer), float(eps))
    return out


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

    CUDA: kernel B8 (bf16, the shapes of :func:`i2t_probs`). The kernel
    rebuilds the branch a 32-position tile at a time on the tensor cores
    (bf16 P·C onto the f32 branch) and projects on the query side:
    s = (q_h·W_k,hᵀ)·keys + q_h·pe_k,h and o = (p·keys)·W_v + v_bias,
    with an online softmax over the tiles. The scores and p·keys against
    the f32 branch run as three fp16 products of power-of-two-scaled
    hi/lo planes, 22 bits of each operand. The result is the same
    function up to f32 reassociation. CPU:
    :func:`t2i_from_probs_reference`."""
    if not q_tok.is_cuda:
        return t2i_from_probs_reference(q_tok, img0, p1, c1, p2, c2, w_k,
                                        w_v, pekt, rows, v_bias, heads, eps)
    b, t, da = q_tok.shape
    _, m, d = img0.shape
    if (d, da, heads, t) != KERNEL_DIMS or m % 32:
        raise ValueError(f"t2i from probs: (D={d}, DA={da}, heads={heads}, "
                         f"T={t}, M={m}) not built ({KERNEL_DIMS}, "
                         "M % 32 == 0)")
    bf = torch.bfloat16
    ht = heads * t
    depth = 1 if p2 is None else 2
    ops = [operand("q_tok", q_tok, bf, (b, t, da)),
           operand("img0", img0, bf, (1, m, d)),
           operand("p1", p1, bf, (b, ht, m)),
           operand("c1", c1, bf, (b, ht, d))]
    if depth == 2:
        ops += [operand("p2", p2, bf, (b, ht, m)),
                operand("c2", c2, bf, (b, ht, d))]
    tail = [operand("w_k", w_k.to(bf), bf, (d, da)),
            operand("w_v", w_v.to(bf), bf, (d, da)),
            operand("pekt", pekt, bf, (1, da, m)),
            operand("branch_rows", rows.to(bf), bf, (8, d)),
            operand("v_bias", v_bias.to(bf), bf, (da,))]
    ptrs = [x.data_ptr() for x in ops]
    if depth == 1:
        ptrs += [None, None]
    out = torch.empty((b, t, da), dtype=bf, device=q_tok.device)
    T2I_PROBS.launch(*ptrs, *(x.data_ptr() for x in tail), out.data_ptr(),
                     b, m, depth, float(eps))
    return out
