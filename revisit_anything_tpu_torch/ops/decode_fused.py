"""The fused SAM decode tail: kernel B3 beside its plain version.

Counterpart of ``revisit_anything_tpu/ops/decode_fused.py``
``decode_tail_fused`` (:429; kernel body ``_tail_kernel`` :166-341).
Per prompt, after the layer-1 token side:

    P1 = softmax_T(k1·q1s)                    layer-1 i2t probabilities
    keys1 = LN(img0 + P1ᵀ C1 + b1)            (f32)
    layer-2 t2i over keys1, out-proj, LN, MLP, LN     (token side)
    tok_k2, tok_v2, C2 = per-head tok_v2·W_out2
    P2 = softmax_T(k2·(keys1·Wq2 + peq2))
    keys2 = LN(keys1 + P2ᵀ C2 + b2)
    final t2i over keys2, out-proj, final LN

It emits keys2 [B, M, D] in the activation dtype (keys mode, for the
plain mask head ``ops.maskhead.fused_mask_head``), or P1, P2 [B, H·T, M]
bf16 and C2 [B, H·T, D] (probability mode, for
``ops.maskhead.fused_mask_head_probs``), or runs the hypernetwork of the
multimask tokens itself and the decoder's mask head (kernel K3) on keys2
rounded to the activation dtype and emits the mask logits [B, content,
16, 3] (logits mode, kernel B3's ``mask_head`` form); always also the
token state after the final LayerNorm. Layouts as in
``ops.decode_probs``.

The kernel computes in its inputs' dtype, as the JAX kernel does: bf16
(a bf16 SAM) or f32 (an f32 SAM, the JAX package's dtype), in all three
modes. P1 and P2 are bf16 at both, the rest f32 in f32. The activations
are never cast (:func:`tail_operands`).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from revisit_anything_tpu_torch.kernels.build import (DECODE_TAIL,
                                                      DECODE_TAIL_F32,
                                                      DECODE_TAIL_LOGITS,
                                                      DECODE_TAIL_LOGITS_F32,
                                                      operand)
from revisit_anything_tpu_torch.ops.attention import kernel_dtype
from revisit_anything_tpu_torch.ops.decode_probs import (KERNEL_DIMS,
                                                         branch_attend,
                                                         branch_probs,
                                                         c_matrix,
                                                         i2t_probs_reference,
                                                         recon_branch,
                                                         recon_step)
from revisit_anything_tpu_torch.ops.maskhead import (MULTIMASK_TOKENS,
                                                     decoder_mask_head,
                                                     mask_head_f32_scratch,
                                                     mask_head_weights)


def branch_rows(dec, dtype: torch.dtype) -> torch.Tensor:
    """[8, D] branch constants of a ``MaskDecoder``: rows 0-2 the layer-1
    image→token out-projection bias and norm4 scale / bias, rows 3-5
    layer 2's, rows 6-7 zero (the JAX package's ``_pack_branch_rows``)."""
    l1, l2 = dec.layers[0], dec.layers[1]
    rows = [l1.i2t.out.b, l1.norm4.scale, l1.norm4.bias,
            l2.i2t.out.b, l2.norm4.scale, l2.norm4.bias]
    rows = torch.stack([r.to(dtype) for r in rows])
    return torch.cat([rows, rows.new_zeros(2, rows.shape[1])])


def decode_tail_reference(dec, img0, q1st, peq2t, pek2t, pekft, tok_k1, c1m,
                          queries_b, tokens, heads: int, eps: float = 1e-6,
                          emit_keys: bool = False, mask_head: bool = False,
                          content: Optional[int] = None):
    """Plain version of :func:`decode_tail_fused`: the same steps through
    the port's modules and the plain helpers of ``ops.decode_probs``; the
    logits mode is the keys mode followed by the plain mask head
    (``ops.maskhead.decoder_mask_head``)."""
    l2, fa = dec.layers[1], dec.final_attn
    rows = branch_rows(dec, queries_b.dtype)
    p1 = i2t_probs_reference(q1st, tok_k1, heads)
    keys1 = recon_branch(img0, [p1], [c1m], rows, eps)
    t2 = l2.t2i
    attn = branch_attend(t2.q(queries_b + tokens), keys1, t2.k.w, t2.v.w,
                         pek2t, t2.v.b, heads)
    queries = l2.norm2(queries_b + t2.out(attn), eps)
    queries = l2.norm3(queries + l2.lin2(torch.relu(l2.lin1(queries))), eps)
    i2 = l2.i2t
    p2 = branch_probs(keys1, i2.q.w, peq2t, i2.k(queries + tokens), heads)
    c2m = c_matrix(i2.v(queries), i2.out.w, heads)
    keys2 = recon_step(keys1, p2, c2m, rows[3:6], eps)
    attn = branch_attend(fa.q(queries + tokens), keys2, fa.k.w, fa.v.w,
                         pekft, fa.v.b, heads)
    queries = dec.norm_final(queries + fa.out(attn), eps)
    if mask_head:
        return queries, decoder_mask_head(dec, keys2, queries, eps, content)
    if emit_keys:
        return queries, keys2.to(queries_b.dtype)
    return queries, p1, p2, c2m


# TailParams, field for field as in kernels/csrc/decode_tail.cu
_TAIL_POINTERS = (
    "img0", "q1st", "peq2t", "pek2t", "pekft", "tok_k1", "c1m", "qin", "tok",
    "wq_t2", "bq_t2", "wk_t2", "wv_t2", "vb_t2", "wout_t2", "bout_t2",
    "n2_s", "n2_b", "lin1_w", "lin1_b", "lin2_w", "lin2_b", "n3_s", "n3_b",
    "wq_i2", "wk_i2", "bk_i2", "wv_i2", "bv_i2", "wout_i2",
    "wq_fa", "bq_fa", "wk_fa", "wv_fa", "vb_fa", "wout_fa", "bout_fa",
    "nf_s", "nf_b", "rows", "keys2", "p1", "p2", "c2m", "qout",
    "up1_w", "up1_b", "ln_s", "ln_b", "up2_w", "up2_b",
    "hw1", "hb1", "hw2", "hb2", "hw3", "hb3", "krows", "hyper", "logits",
    "work", "mh_scratch")


class TailParams(ctypes.Structure):
    _fields_ = ([(name, ctypes.c_void_p) for name in _TAIL_POINTERS]
                + [(name, ctypes.c_int) for name in
                   ("b", "m", "mlp", "content", "ctas")]
                + [("eps", ctypes.c_float)])


def tail_f32_scratch(m: int, probs: bool = False) -> int:
    """Bytes of the f32 form's work a prompt at ``m`` positions (the built
    library's ``rat_decode_tail_f32_scratch(m)``): the token rows between
    its walks, f32, then P1 and P2 [H·T, M] bf16 and C2 [H·T, D] f32;
    with ``probs`` (``rat_decode_tail_f32_probs_scratch()``) the token
    rows alone: the probability mode writes P1, P2 and C2 to its
    outputs."""
    d, da, heads, t = KERNEL_DIMS
    rows = 5 * t * da * 4 + t * d * 4
    return rows if probs else rows + 2 * heads * t * m * 2 + heads * t * d * 4


def _mask_head_operands(dec, d: int, dt: torch.dtype) -> list:
    """The logits mode's extra kernel inputs, converted to ``dt``: the
    mask head's weights and the multimask tokens' hypernetwork MLPs
    stacked per layer."""
    c1, c2 = d // 4, d // 8
    names = ("up1_w", "up1_b", "ln_s", "ln_b", "up2_w", "up2_b")
    shapes = ((d, d), (c1,), (c1,), (c1,), (c1, 4 * c2), (c2,))
    ins = [(name, x.to(dt), dt, shape) for name, x, shape in
           zip(names, mask_head_weights(dec), shapes)]
    mlps = [dec.hyper_mlps[i] for i in MULTIMASK_TOKENS]
    if len(mlps[0]) != 3:
        raise ValueError("decode tail: hypernetwork MLPs of depth "
                         f"{len(mlps[0])} not built (3)")
    for j, n_out in enumerate((d, d, c2)):
        ins.append((f"hw{j + 1}", torch.stack([p[j].w for p in mlps]).to(dt),
                    dt, (3, d, n_out)))
        ins.append((f"hb{j + 1}", torch.stack([p[j].b for p in mlps]).to(dt),
                    dt, (3, n_out)))
    return ins


def tail_operands(dec, img0, q1st, peq2t, pek2t, pekft, tok_k1, c1m,
                  queries_b, tokens, heads: int,
                  mask_head: bool = False) -> list:
    """What :func:`decode_tail_fused` hands its kernel, in TailParams'
    order (outputs left out): each ``(name, tensor, dtype, shape)`` for
    ``operand``. The activations (img0, the pe terms, the token keys, C1,
    the token state and the prompt tokens) are the caller's tensors, held
    to queries_b's dtype and never cast; the weights, biases and branch
    rows (and, with ``mask_head``, the mask head's weights and the
    hypernetwork MLPs) are converted to it, as the plain version converts
    them. P never enters: the kernel makes P1 and P2 itself."""
    b, t, d = queries_b.shape
    _, m, _ = img0.shape
    da = tok_k1.shape[2]
    dt = queries_b.dtype
    l2, fa = dec.layers[1], dec.final_attn
    mlp = l2.lin1.w.shape[1]
    t2, i2 = l2.t2i, l2.i2t
    acts = [("img0", img0, (1, m, d)), ("q1st", q1st, (1, da, m)),
            ("peq2t", peq2t, (1, da, m)), ("pek2t", pek2t, (1, da, m)),
            ("pekft", pekft, (1, da, m)), ("tok_k1", tok_k1, (b, t, da)),
            ("c1m", c1m, (b, heads * t, d)), ("qin", queries_b, (b, t, d)),
            ("tok", tokens, (b, t, d))]
    weights = [
        ("wq_t2", t2.q.w, (d, da)), ("bq_t2", t2.q.b, (da,)),
        ("wk_t2", t2.k.w, (d, da)), ("wv_t2", t2.v.w, (d, da)),
        ("vb_t2", t2.v.b, (da,)), ("wout_t2", t2.out.w, (da, d)),
        ("bout_t2", t2.out.b, (d,)), ("n2_s", l2.norm2.scale, (d,)),
        ("n2_b", l2.norm2.bias, (d,)), ("lin1_w", l2.lin1.w, (d, mlp)),
        ("lin1_b", l2.lin1.b, (mlp,)), ("lin2_w", l2.lin2.w, (mlp, d)),
        ("lin2_b", l2.lin2.b, (d,)), ("n3_s", l2.norm3.scale, (d,)),
        ("n3_b", l2.norm3.bias, (d,)),
        ("wq_i2", i2.q.w, (d, da)), ("wk_i2", i2.k.w, (d, da)),
        ("bk_i2", i2.k.b, (da,)), ("wv_i2", i2.v.w, (d, da)),
        ("bv_i2", i2.v.b, (da,)), ("wout_i2", i2.out.w, (da, d)),
        ("wq_fa", fa.q.w, (d, da)), ("bq_fa", fa.q.b, (da,)),
        ("wk_fa", fa.k.w, (d, da)), ("wv_fa", fa.v.w, (d, da)),
        ("vb_fa", fa.v.b, (da,)), ("wout_fa", fa.out.w, (da, d)),
        ("bout_fa", fa.out.b, (d,)), ("nf_s", dec.norm_final.scale, (d,)),
        ("nf_b", dec.norm_final.bias, (d,)),
        ("rows", branch_rows(dec, dt), (8, d))]
    ops = ([(name, x, dt, shape) for name, x, shape in acts]
           + [(name, x.to(dt), dt, shape) for name, x, shape in weights])
    if mask_head:
        ops += _mask_head_operands(dec, d, dt)
    return ops


def decode_tail_fused(dec, img0: torch.Tensor, q1st: torch.Tensor,
                      peq2t: torch.Tensor, pek2t: torch.Tensor,
                      pekft: torch.Tensor, tok_k1: torch.Tensor,
                      c1m: torch.Tensor, queries_b: torch.Tensor,
                      tokens: torch.Tensor, heads: int, eps: float = 1e-6,
                      emit_keys: bool = False, mask_head: bool = False,
                      content: Optional[int] = None):
    """The decode tail of a ``MaskDecoder`` ``dec`` for B prompts.

    img0 [1, M, D] the shared branch input; q1st [1, DA, M] the layer-1
    image→token queries ((img0 + pe)·Wq1 + bq1)ᵀ; peq2t, pek2t, pekft
    [1, DA, M] the pe terms of the layer-2 image→token queries
    (pe·Wq + bq), the layer-2 and the final token→image keys (pe·Wk +
    bk), transposed; tok_k1 [B, T, DA] the layer-1 image→token token
    keys; c1m [B, H·T, D]; queries_b [B, T, D] the token state after the
    layer-2 self-attention and norm1; tokens [B, T, D] the prompt tokens.

    Returns (queries [B, T, D], logits [B, content, 16, 3]) with
    ``mask_head`` (the decoder's mask head on the first ``content``
    positions, default all, for mask tokens 1..3), (queries, keys2
    [B, M, D]) with ``emit_keys``, else (queries, p1, p2, c2m).

    CUDA: kernel B3 by queries_b's dtype (D 256, DA 128, 8 heads, 7
    tokens, M a multiple of 32, MLP width a multiple of 8; the operands
    of :func:`tail_operands`). bf16: one tensor-core kernel for the three
    modes; with ``mask_head`` its entry runs the tail and then K3's kernel
    (``kernels/csrc/mask_head.cu``) on keys2's first rows and the
    hypernetwork rows, on one stream. f32 (an f32 SAM): the three modes,
    the tail's two passes as the walks of kernels B7 f32 and B8 f32 with
    the token side between them in the kernel library, the token rows in
    a per-call scratch, and P1, P2 and C2 there too but in the probability
    mode, whose walks write them to its outputs (P1, P2 bf16, C2 f32);
    keys2 stored from the last walk in keys mode; the logits entry then
    runs K3 f32; f32 outputs but P. CPU: :func:`decode_tail_reference`."""
    _, m, _ = img0.shape
    content = m if content is None else content
    if mask_head and not 0 < content <= m:
        raise ValueError(f"content {content} outside (0, {m}]")
    if not queries_b.is_cuda:
        return decode_tail_reference(dec, img0, q1st, peq2t, pek2t, pekft,
                                     tok_k1, c1m, queries_b, tokens, heads,
                                     eps, emit_keys, mask_head, content)
    b, t, d = queries_b.shape
    da = tok_k1.shape[2]
    mlp = dec.layers[1].lin1.w.shape[1]
    dt = kernel_dtype("decode tail", queries_b)
    if (d, da, heads, t) != KERNEL_DIMS or m % 32 or mlp % 8:
        raise ValueError(f"decode tail: (D={d}, DA={da}, heads={heads}, "
                         f"T={t}, M={m}, MLP={mlp}) not built "
                         f"({KERNEL_DIMS}, M % 32 == 0, MLP % 8 == 0)")
    f32 = dt == torch.float32
    probs = not (emit_keys or mask_head)
    ins = {name: operand(name, x, dtype, shape) for name, x, dtype, shape in
           tail_operands(dec, img0, q1st, peq2t, pek2t, pekft, tok_k1, c1m,
                         queries_b, tokens, heads, mask_head)}
    dev = queries_b.device
    ht = heads * t
    qout = torch.empty((b, t, d), dtype=dt, device=dev)
    outs = dict(qout=qout)
    ctas = 0
    if f32:
        outs["work"] = torch.empty(b * tail_f32_scratch(m, probs),
                                   dtype=torch.uint8, device=dev)
    if mask_head:
        # keys2's rows below content, whole 32-position tiles, and the
        # hypernetwork rows, for K3 (bf16: on persistent CTAs, one an SM;
        # f32: after its weight split into mh_scratch)
        ctas = torch.cuda.get_device_properties(dev).multi_processor_count
        gg = -(-content // 32) * 32
        outs["krows"] = torch.empty((b, gg, d), dtype=dt, device=dev)
        outs["hyper"] = torch.empty((b, len(MULTIMASK_TOKENS), d // 8),
                                    dtype=dt, device=dev)
        outs["logits"] = torch.empty((b, content, 16, 3), dtype=dt,
                                     device=dev)
        if f32:
            outs["mh_scratch"] = torch.empty(mask_head_f32_scratch(),
                                             dtype=dt, device=dev)
    elif emit_keys:
        outs["keys2"] = torch.empty((b, m, d), dtype=dt, device=dev)
    else:
        outs["p1"] = torch.empty((b, ht, m), dtype=torch.bfloat16,
                                 device=dev)
        outs["p2"] = torch.empty((b, ht, m), dtype=torch.bfloat16,
                                 device=dev)
        outs["c2m"] = torch.empty((b, ht, d), dtype=dt, device=dev)
    ptrs = {name: x.data_ptr() for name, x in {**ins, **outs}.items()}
    params = TailParams(*(ptrs.get(name) for name in _TAIL_POINTERS),
                        b, m, mlp, content, ctas, float(eps))
    if mask_head:
        kernel = DECODE_TAIL_LOGITS_F32 if f32 else DECODE_TAIL_LOGITS
    else:
        kernel = DECODE_TAIL_F32 if f32 else DECODE_TAIL
    kernel.launch(ctypes.addressof(params))
    if mask_head:
        return qout, outs["logits"]
    if emit_keys:
        return qout, outs["keys2"]
    return qout, outs["p1"], outs["p2"], outs["c2m"]
