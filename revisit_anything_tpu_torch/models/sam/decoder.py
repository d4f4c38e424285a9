"""SAM mask decoder for automatic mask generation: two-way transformer with
the image branch shared across prompts until it diverges, hypernetwork
mask head in block layout, IoU head.

Counterpart of ``revisit_anything_tpu/models/sam/decoder.py``
``decode_masks`` (:636) with ``dense_shared=True, block_layout=True,
mask_rows=gh``, following ``_run_two_way_shared`` (:260-355):

- the three token→image attentions (layer 1 on the shared [1, M, D]
  branch, layer 2 and the final one per prompt) go through kernel K2
  (``ops.attention.token_cross_attend_kv``) on k|v in the transposed
  [B, 2D, M] layout (``_t2i_fused`` :125-144);
- the two image→token updates go through kernel K5
  (``ops.attention.i2t_update``, the TPU branch at :312-332): q-projection,
  attention over the 7 tokens, out-projection, residual and LayerNorm in
  one pass, which also emits the next token→image attention's transposed
  k|v, so only layer 1's k|v is projected here;
- output tokens are selected before the mask product (:730-737), and the
  mask head runs through kernel K3 (``ops.maskhead.fused_mask_head``).

The JAX package's TPU default fuses layer 2 onward into one kernel
(``ops/decode_fused.py`` ``decode_tail_fused``); that fusion is not ported
yet — the same function runs here as K5, K2 and the token-side ops.
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
from revisit_anything_tpu_torch.ops.maskhead import fused_mask_head


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
                 device=None):
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


def decode_masks(dec: MaskDecoder, cfg: SamArchConfig,
                 image_embedding: torch.Tensor, image_pe: torch.Tensor,
                 sparse_prompts: torch.Tensor, dense_prompts: torch.Tensor,
                 mask_rows: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multimask decode of Np prompts against ONE image embedding.

    image_embedding, image_pe [g, g, D]; sparse_prompts [Np, T, D];
    dense_prompts [1, g, g, D] (the shared no-mask embedding);
    mask_rows: decode mask logits only for the first ``mask_rows`` token
    rows (the rest are SAM's square padding, cropped away later).

    Returns (block-layout logits [Np, mask_rows·g, 16, 3], iou [Np, 3])
    for mask tokens 1..3."""
    np_, _, d = sparse_prompts.shape
    g = cfg.grid
    content = g * g if mask_rows is None else mask_rows * g
    out_tokens = torch.cat([dec.iou_token, dec.mask_tokens], dim=0)
    tokens = torch.cat([out_tokens[None].expand(np_, -1, -1),
                        sparse_prompts.to(out_tokens.dtype)], dim=1)
    shared_src = (image_embedding[None] + dense_prompts[:1]).reshape(
        1, g * g, d)
    src_pe_one = image_pe.reshape(1, g * g, d).to(shared_src.dtype)
    queries, keys = run_two_way_shared(dec, tokens, shared_src, src_pe_one,
                                       cfg)
    iou_token_out = queries[:, 0]
    mask_tokens_out = queries[:, 1:1 + cfg.num_mask_tokens]
    hyper = torch.stack([mlp(mask_tokens_out[:, i], dec.hyper_mlps[i])
                         for i in range(1, cfg.num_mask_tokens)], dim=1)
    masks = fused_mask_head(keys, hyper, dec.up1_w, dec.up1_b,
                            dec.up_ln.scale, dec.up_ln.bias, dec.up2_w,
                            dec.up2_b, eps=cfg.eps, content=content)
    iou_pred = mlp(iou_token_out, dec.iou_head)
    return masks, iou_pred[:, 1:]
