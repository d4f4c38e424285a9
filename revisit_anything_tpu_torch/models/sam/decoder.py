"""SAM mask decoder: two-way transformer, hypernetwork mask head, IoU
head.

Counterpart of ``revisit_anything_tpu/models/sam/decoder.py``
``decode_masks`` (:636). Automatic mask generation and the server call
it with the shared no-mask dense prompt (``dense_shared=True``) and the
block layout with ``mask_rows=gh``; there ``decode`` picks the form, as
the JAX package's
``probs_path`` argument and its trace-time flags ``_FUSED_TAIL`` /
``_TAIL_KEYS`` / ``_TAIL_LOGITS`` (:147-213) do:

- ``"shared"`` (default) follows ``_run_two_way_shared`` (:260-355): the
  three token→image attentions through kernel K2
  (``ops.attention.token_cross_attend_kv``) on k|v in the transposed
  [B, 2D, M] layout; the two image→token updates through kernel K5
  (``ops.attention.i2t_update``), which also emits the next attention's
  k|v; the mask head through kernel K3 (``ops.maskhead.fused_mask_head``).
- ``"probs_split"``, ``"fused_tail_probs"``, ``"fused_tail_keys"``,
  ``"fused_tail_logits"`` follow ``_run_two_way_probs`` (:358-519): the
  per-prompt branch exists only as the image→token probabilities P and
  the products C (``ops.decode_probs``). Layer 1's token→image attention
  runs through K2 on the shared branch. Then ``"probs_split"`` runs
  kernels B7 ×2 (``i2t_probs``) and B8 ×2 (``t2i_from_probs``) with the
  token side in torch; the three ``fused_tail_*`` forms run the whole
  rest of the transformer in kernel B3
  (``ops.decode_fused.decode_tail_fused``), which emits keys2 for K3
  (``"fused_tail_keys"``, the JAX package's TPU default), or P1, P2 and
  C2 for kernel B6 (``ops.maskhead.fused_mask_head_probs``, also after
  ``"probs_split"``), or runs the mask head and the hypernetwork itself
  and emits the mask logits (``"fused_tail_logits"``, :438-446 and
  :724-728), leaving only the IoU head.

Output tokens are selected before the mask product (:730-737):
mask tokens 1..3 (``multimask``) or token 0 and its IoU.

``dense_shared=False`` is the general path for per-prompt dense prompts
(a mask prompt), ``_run_two_way`` (:216-257) and :714-719, with spatial
[Np, M, 4g, 4g] logits (``_upscale_masks_blocks(interleave=True)``,
:555-622): plain PyTorch on every device, since the JAX package reaches
no Pallas kernel there either. The predictor and the exported decoder
run it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from revisit_anything_tpu_torch.models.layers import (Dense, LayerNorm, mlp,
                                                      param)
from revisit_anything_tpu_torch.models.sam.config import SamArchConfig
from revisit_anything_tpu_torch.ops.attention import (i2t_update,
                                                      token_cross_attend_kv)
from revisit_anything_tpu_torch.ops.decode_fused import (branch_rows,
                                                         decode_tail_fused)
from revisit_anything_tpu_torch.ops.decode_probs import (c_matrix, i2t_probs,
                                                         t2i_from_probs)
from revisit_anything_tpu_torch.ops.maskhead import (MULTIMASK_TOKENS,
                                                     blocks_to_spatial,
                                                     fused_mask_head,
                                                     fused_mask_head_probs,
                                                     hypernetwork,
                                                     mask_head_weights,
                                                     upscale_masks_blocks)

DECODES = ("shared", "probs_split", "fused_tail_probs", "fused_tail_keys",
           "fused_tail_logits")


class Attention(nn.Module):
    """transformer.py Attention: q/k/v/out projections, internal dim
    ``dim // downsample``."""

    def __init__(self, dim: int, downsample: int, *, dtype, device):
        super().__init__()
        inner = dim // downsample
        kw = dict(dtype=dtype, device=device)
        self.q = Dense(dim, inner, **kw)
        self.k = Dense(dim, inner, **kw)
        self.v = Dense(dim, inner, **kw)
        self.out = Dense(inner, dim, **kw)


class TwoWayLayer(nn.Module):
    def __init__(self, cfg: SamArchConfig, *, dtype, device):
        super().__init__()
        pd = cfg.prompt_dim
        kw = dict(dtype=dtype, device=device)
        self.self_attn = Attention(pd, 1, **kw)
        self.norm1 = LayerNorm(pd, **kw)
        self.t2i = Attention(pd, 2, **kw)
        self.norm2 = LayerNorm(pd, **kw)
        self.lin1 = Dense(pd, cfg.decoder_mlp_dim, **kw)
        self.lin2 = Dense(cfg.decoder_mlp_dim, pd, **kw)
        self.norm3 = LayerNorm(pd, **kw)
        self.i2t = Attention(pd, 2, **kw)
        self.norm4 = LayerNorm(pd, **kw)


class MaskDecoder(nn.Module):
    def __init__(self, cfg: SamArchConfig, *, dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        pd = cfg.prompt_dim
        kw = dict(dtype=dtype, device=device)
        self.iou_token = param(1, pd, **kw)
        self.mask_tokens = param(cfg.num_mask_tokens, pd, **kw)
        self.layers = nn.ModuleList(TwoWayLayer(cfg, **kw)
                                    for _ in range(cfg.decoder_depth))
        self.final_attn = Attention(pd, 2, **kw)
        self.norm_final = LayerNorm(pd, **kw)
        self.up1_w = param(pd, (pd // 4) * 4, **kw)
        self.up1_b = param(pd // 4, **kw)
        self.up_ln = LayerNorm(pd // 4, **kw)
        self.up2_w = param(pd // 4, (pd // 8) * 4, **kw)
        self.up2_b = param(pd // 8, **kw)

        def head(n_in, hidden, n_out, depth):
            dims = [n_in] + [hidden] * (depth - 1) + [n_out]
            return nn.ModuleList(Dense(dims[j], dims[j + 1], **kw)
                                 for j in range(depth))

        self.hyper_mlps = nn.ModuleList(head(pd, pd, pd // 8, 3)
                                        for _ in range(cfg.num_mask_tokens))
        self.iou_head = head(pd, cfg.iou_head_hidden, cfg.num_mask_tokens,
                             cfg.iou_head_depth)


def _attn(a: Attention, q, k, v, num_heads: int) -> torch.Tensor:
    """Projected multi-head attention (token self-attention), f32 scores."""
    q = a.q(q)
    k = a.k(k)
    v = a.v(v)
    b, nq, d = q.shape
    hd = d // num_heads
    qh = q.reshape(b, nq, num_heads, hd).float()
    kh = k.reshape(b, k.shape[1], num_heads, hd).float()
    vh = v.reshape(b, v.shape[1], num_heads, hd).float()
    logits = torch.einsum("bnhd,bmhd->bhnm", qh, kh) / (hd ** 0.5)
    probs = torch.softmax(logits, dim=-1).to(q.dtype).float()
    out = torch.einsum("bhnm,bmhd->bnhd", probs, vh).to(q.dtype)
    return a.out(out.reshape(b, nq, d))


def run_two_way(dec: MaskDecoder, tokens, src, src_pe, cfg: SamArchConfig):
    """TwoWayTransformer on a per-prompt image branch src [Np, M, D] with
    its PE src_pe (token self-attention, token→image, MLP, image→token,
    depth times, then the final token→image attention), plain PyTorch.
    Returns (queries [Np, T, D], keys [Np, M, D])."""
    nh = cfg.decoder_heads
    queries, keys = tokens, src
    for i, layer in enumerate(dec.layers):
        if i == 0:
            # skip_first_layer_pe: self-attention without PE replaces the
            # queries (no residual)
            queries = _attn(layer.self_attn, queries, queries, queries, nh)
        else:
            q = queries + tokens
            queries = queries + _attn(layer.self_attn, q, q, queries, nh)
        queries = layer.norm1(queries, cfg.eps)

        q = queries + tokens
        k = keys + src_pe
        queries = layer.norm2(queries + _attn(layer.t2i, q, k, keys, nh),
                              cfg.eps)
        queries = layer.norm3(
            queries + layer.lin2(torch.relu(layer.lin1(queries))), cfg.eps)

        q = queries + tokens
        k = keys + src_pe
        keys = layer.norm4(keys + _attn(layer.i2t, k, q, queries, nh),
                           cfg.eps)

    q = queries + tokens
    k = keys + src_pe
    queries = dec.norm_final(
        queries + _attn(dec.final_attn, q, k, keys, nh), cfg.eps)
    return queries, keys


def _t2i(a: Attention, q_tok, keys, pe_one, num_heads: int,
         kvt=None) -> torch.Tensor:
    """tokens→image attention through kernel K2; pe and the v bias fold in
    inside the kernel. ``kvt`` is the transposed k|v projection [B, 2D, M]
    that K5 emitted; without it (layer 1, ``keys`` the shared [1, M, D]
    branch) k|v are projected here in ONE matmul."""
    qp = a.q(q_tok)
    if kvt is None:
        wkv = torch.cat([a.k.w, a.v.w], dim=1).to(keys.dtype)  # [D, 2·DA]
        kvt = torch.matmul(wkv.t(), keys.transpose(1, 2))      # [B, 2DA, M]
    pe_k = a.k.nobias(pe_one) + a.k.b                          # [1, M, DA]
    out = token_cross_attend_kv(qp, kvt, pe_k.transpose(1, 2), a.v.b,
                                num_heads)
    return a.out(out)


def run_two_way_shared(dec: MaskDecoder, tokens, shared_src, src_pe_one,
                       cfg: SamArchConfig):
    """TwoWayTransformer for prompts that share one image branch input
    (image embedding + the no-mask dense prompt): the [B, M, D] branch
    exists only from the layer-1 image→token update on."""
    nh = cfg.decoder_heads
    queries = tokens
    keys = kvt = None
    for i, layer in enumerate(dec.layers):
        if i == 0:
            queries = _attn(layer.self_attn, queries, queries, queries, nh)
        else:
            q = queries + tokens
            queries = queries + _attn(layer.self_attn, q, q, queries, nh)
        queries = layer.norm1(queries, cfg.eps)

        img_side = shared_src if i == 0 else keys
        q = queries + tokens
        queries = queries + _t2i(layer.t2i, q, img_side, src_pe_one, nh,
                                 kvt)
        queries = layer.norm2(queries, cfg.eps)

        queries = queries + layer.lin2(torch.relu(layer.lin1(queries)))
        queries = layer.norm3(queries, cfg.eps)

        q = queries + tokens
        ip = layer.i2t
        nxt = (dec.layers[i + 1].t2i if i + 1 < len(dec.layers)
               else dec.final_attn)
        keys, kvt = i2t_update(
            img_side, ip.q.nobias(src_pe_one), ip.k(q), ip.v(queries),
            ip.q.w, ip.q.b, ip.out.w, ip.out.b, layer.norm4.scale,
            layer.norm4.bias, torch.cat([nxt.k.w, nxt.v.w], dim=1), nh,
            cfg.eps)

    q = queries + tokens
    queries = queries + _t2i(dec.final_attn, q, keys, src_pe_one, nh, kvt)
    queries = dec.norm_final(queries, cfg.eps)
    return queries, keys


def _t_proj(lin, x: torch.Tensor) -> torch.Tensor:
    """(x·W rounded to x's dtype + b)ᵀ of a shared [1, M, D] tensor:
    [1, DA, M] (the JAX package's ``t_proj``)."""
    return (lin.nobias(x) + lin.b.to(x.dtype)).transpose(1, 2)


def run_two_way_probs(dec: MaskDecoder, tokens, shared_src, src_pe_one,
                      cfg: SamArchConfig, decode: str, content: int):
    """Probability-factored two-way transformer for prompts that share
    one image branch input (``_run_two_way_probs``).

    Returns (queries, pstate, keys, logits), one of the last three set:
    pstate = (p1, c1m, p2, c2m, branch rows) for the
    probability-consuming mask head, keys [B, M, D]
    (``"fused_tail_keys"``), or the mask logits of the first ``content``
    positions [B, content, 16, 3] (``"fused_tail_logits"``)."""
    nh = cfg.decoder_heads
    eps = cfg.eps
    l1, l2 = dec.layers[0], dec.layers[1]
    fa = dec.final_attn

    # layer 1: token side, token→image over the shared branch (K2)
    queries = l1.norm1(_attn(l1.self_attn, tokens, tokens, tokens, nh), eps)
    q = queries + tokens
    queries = l1.norm2(queries + _t2i(l1.t2i, q, shared_src, src_pe_one,
                                      nh), eps)
    queries = l1.norm3(queries + l1.lin2(torch.relu(l1.lin1(queries))), eps)

    # layer-1 image→token: its queries are shared by every prompt
    i1 = l1.i2t
    q1st = _t_proj(i1.q, shared_src + src_pe_one)            # [1, DA, M]
    tok_k1 = i1.k(queries + tokens)
    c1m = c_matrix(i1.v(queries), i1.out.w, nh)
    i2 = l2.i2t
    peq2t = _t_proj(i2.q, src_pe_one)
    pek2t = _t_proj(l2.t2i.k, src_pe_one)
    pekft = _t_proj(fa.k, src_pe_one)

    q = queries + tokens
    queries = l2.norm1(queries + _attn(l2.self_attn, q, q, queries, nh), eps)
    rows = branch_rows(dec, shared_src.dtype)
    if decode != "probs_split":
        out = decode_tail_fused(dec, shared_src, q1st, peq2t, pek2t, pekft,
                                tok_k1, c1m, queries, tokens, nh, eps,
                                emit_keys=decode == "fused_tail_keys",
                                mask_head=decode == "fused_tail_logits",
                                content=content)
        if decode == "fused_tail_keys":
            return out[0], None, out[1], None
        if decode == "fused_tail_logits":
            return out[0], None, None, out[1]
        queries, p1, p2, c2m = out
        return queries, (p1, c1m, p2, c2m, rows), None, None

    p1 = i2t_probs(q1st, tok_k1, nh, layer=1, eps=eps)      # [B, HT, M]

    # layer 2: token→image over the branch rebuilt at depth 1 (B8)
    t2 = l2.t2i
    attn = t2i_from_probs(t2.q(queries + tokens), shared_src, p1, c1m, None,
                          None, t2.k.w, t2.v.w, pek2t, rows, t2.v.b, nh, eps)
    queries = l2.norm2(queries + t2.out(attn), eps)
    queries = l2.norm3(queries + l2.lin2(torch.relu(l2.lin1(queries))), eps)

    # layer-2 image→token: queries rebuilt from keys1 in the kernel (B7)
    p2 = i2t_probs(None, i2.k(queries + tokens), nh, layer=2,
                   recon=(shared_src, p1, c1m, peq2t, i2.q.w, rows), eps=eps)
    c2m = c_matrix(i2.v(queries), i2.out.w, nh)

    # final token→image attention over the branch at depth 2 (B8)
    attn = t2i_from_probs(fa.q(queries + tokens), shared_src, p1, c1m, p2,
                          c2m, fa.k.w, fa.v.w, pekft, rows, fa.v.b, nh, eps)
    queries = dec.norm_final(queries + fa.out(attn), eps)
    return queries, (p1, c1m, p2, c2m, rows), None, None


def decode_masks(dec: MaskDecoder, cfg: SamArchConfig,
                 image_embedding: torch.Tensor, image_pe: torch.Tensor,
                 sparse_prompts: torch.Tensor, dense_prompts: torch.Tensor,
                 mask_rows: Optional[int] = None, decode: str = "shared",
                 multimask: bool = True, dense_shared: bool = True
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode Np prompts against ONE image embedding.

    image_embedding, image_pe [g, g, D]; sparse_prompts [Np, T, D];
    dense_prompts [1, g, g, D] (``dense_shared``: one dense prompt for
    every prompt, the no-mask embedding; only its first row is read) or
    [Np, g, g, D] (the general path, :func:`run_two_way`);
    mask_rows: decode mask logits only for the first ``mask_rows`` token
    rows (shared path only; the rest are SAM's square padding, cropped
    away later); decode: the two-way form of the shared path, one of
    ``DECODES`` (module docstring; the general path has one form,
    "shared" by name); multimask: mask tokens 1..3 and their IoU, else
    token 0 and its IoU (not in the ``"fused_tail_logits"`` form, whose
    kernel runs tokens 1..3).

    Returns (logits, iou [Np, M]): the shared path's block layout
    [Np, mask_rows·g, 16, M] in the branch's dtype, the general path's
    spatial [Np, M, 4g, 4g] f32."""
    if decode not in DECODES:
        raise ValueError(f"decode {decode!r} is not one of {DECODES}")
    if not dense_shared and decode != "shared":
        raise ValueError(f"decode {decode!r} needs the shared dense prompt")
    if decode == "fused_tail_logits" and not multimask:
        raise ValueError("the fused_tail_logits kernel decodes the "
                         "multimask tokens only")
    np_, _, d = sparse_prompts.shape
    g = cfg.grid
    if mask_rows is not None and not (dense_shared and 0 < mask_rows <= g):
        raise ValueError(f"mask_rows {mask_rows} needs the shared path "
                         f"and 0 < mask_rows <= {g}")
    content = g * g if mask_rows is None else mask_rows * g
    token_ids = MULTIMASK_TOKENS if multimask else (0,)
    out_tokens = torch.cat([dec.iou_token, dec.mask_tokens], dim=0)
    tokens = torch.cat([out_tokens[None].expand(np_, -1, -1),
                        sparse_prompts.to(out_tokens.dtype)], dim=1)
    pstate = masks = None
    if not dense_shared:
        src = (image_embedding[None] + dense_prompts).reshape(np_, g * g, d)
        src_pe = image_pe.reshape(1, g * g, d).to(src.dtype).expand(
            np_, -1, -1)
        queries, keys = run_two_way(dec, tokens, src, src_pe, cfg)
        masks = blocks_to_spatial(upscale_masks_blocks(
            keys, hypernetwork(dec, queries, token_ids),
            *mask_head_weights(dec), cfg.eps, round_output=False), g)
    else:
        shared_src = (image_embedding[None] + dense_prompts[:1]).reshape(
            1, g * g, d)
        src_pe_one = image_pe.reshape(1, g * g, d).to(shared_src.dtype)
        if decode == "shared":
            queries, keys = run_two_way_shared(dec, tokens, shared_src,
                                               src_pe_one, cfg)
        else:
            queries, pstate, keys, masks = run_two_way_probs(
                dec, tokens, shared_src, src_pe_one, cfg, decode, content)
        if masks is None:
            hyper = hypernetwork(dec, queries, token_ids)
            head = mask_head_weights(dec)
            if pstate is None:
                masks = fused_mask_head(keys, hyper, *head, eps=cfg.eps,
                                        content=content)
            else:
                masks = fused_mask_head_probs(shared_src, *pstate, hyper,
                                              *head, eps=cfg.eps,
                                              ln_eps=cfg.eps,
                                              content=content)
    iou_pred = mlp(queries[:, 0], dec.iou_head)
    return masks, iou_pred[:, 1:] if multimask else iou_pred[:, :1]
