"""Mask head kernels K3 (upscaler + hypernetwork) and B6 (the same on a
branch rebuilt from attention probabilities), each beside its plain
version, and the plain pieces of a decoder's mask head that the decode
tail's logits mode (``ops.decode_fused``) runs in its kernel.

Counterpart of ``revisit_anything_tpu/ops/maskhead.py`` ``fused_mask_head``
(:345) and ``fused_mask_head_probs`` (:409); the plain version is
``decoder._upscale_masks_blocks(interleave=False)``
(``models/sam/decoder.py:555-616``). Output is the block layout
[Np, content, 16, M]: dim 2 = (q, r) = (2a1+b1, 2a2+b2), spatial row
4i+2a1+a2 and column 4j+2b1+b2 of token position (i, j).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from revisit_anything_tpu_torch.kernels.build import (MASK_HEAD,
                                                      MASK_HEAD_F32,
                                                      MASK_HEAD_PROBS,
                                                      MASK_HEAD_PROBS_F32,
                                                      operand)
from revisit_anything_tpu_torch.models.layers import mlp
from revisit_anything_tpu_torch.ops.attention import kernel_dtype
from revisit_anything_tpu_torch.ops.decode_probs import recon_branch

# multimask output: mask tokens 1..3 (mask_decoder.py:96-144)
MULTIMASK_TOKENS = (1, 2, 3)


def mask_head_weights(dec) -> tuple:
    """(up1_w, up1_b, ln scale, ln bias, up2_w, up2_b) of a
    ``MaskDecoder``, in :func:`fused_mask_head`'s argument order."""
    return (dec.up1_w, dec.up1_b, dec.up_ln.scale, dec.up_ln.bias,
            dec.up2_w, dec.up2_b)


def hypernetwork(dec, queries: torch.Tensor,
                 tokens=MULTIMASK_TOKENS) -> torch.Tensor:
    """The hypernetwork MLPs of mask ``tokens`` (the multimask ones by
    default, (0,) for a single mask) on the token state queries [B, T, D]
    (row 0 the IoU token, mask token i at row 1 + i): [B, len(tokens),
    D/8], each dense layer rounded before its bias with ReLU between
    (``mlp``)."""
    return torch.stack([mlp(queries[:, 1 + i], dec.hyper_mlps[i])
                        for i in tokens], dim=1)


def decoder_mask_head(dec, keys: torch.Tensor, queries: torch.Tensor,
                      eps: float, content: Optional[int] = None
                      ) -> torch.Tensor:
    """Plain mask head of a ``MaskDecoder`` for the multimask tokens: the
    first ``content`` positions of the final branch keys [B, M, D],
    rounded to the token state's dtype, upscaled and contracted with
    :func:`hypernetwork` rows → [B, content, 16, 3]."""
    content = keys.shape[1] if content is None else content
    return upscale_masks_blocks(keys[:, :content].to(queries.dtype),
                                hypernetwork(dec, queries),
                                *mask_head_weights(dec), eps)


def upscale_masks_blocks(keys: torch.Tensor, hyper: torch.Tensor,
                         up1_w: torch.Tensor, up1_b: torch.Tensor,
                         ln_scale: torch.Tensor, ln_bias: torch.Tensor,
                         up2_w: torch.Tensor, up2_b: torch.Tensor,
                         eps: float = 1e-6,
                         round_output: bool = True) -> torch.Tensor:
    """Plain version: keys [Np, P, D], hyper [Np, M, D/8] →
    [Np, P, 16, M] in keys' dtype (f32 where ``round_output`` is false,
    as the JAX package's spatial output keeps its f32 products)."""
    np_, gg, d = keys.shape
    m = hyper.shape[1]
    c1 = d // 4
    c2 = d // 8
    y = torch.matmul(keys, up1_w.to(keys.dtype))
    y = y.reshape(np_, gg, 4, c1) + up1_b.to(keys.dtype)
    yf = y.float()
    mu = yf.mean(-1, keepdim=True)
    var = yf.var(-1, unbiased=False, keepdim=True)
    yf = (yf - mu) * torch.rsqrt(var + eps) * ln_scale.float() \
        + ln_bias.float()
    y = F.gelu(yf).to(y.dtype)
    y = torch.matmul(y, up2_w.to(y.dtype))                 # [.., 4, 4·c2]
    y = y.reshape(np_, gg, 4, 4, c2) + up2_b.to(y.dtype)
    y = F.gelu(y)
    masks = torch.einsum("npqrc,nmc->npqrm", y.float(),
                         hyper.to(y.dtype).float())
    if round_output:
        masks = masks.to(y.dtype)
    return masks.reshape(np_, gg, 16, m)


def blocks_to_spatial(masks: torch.Tensor, g: int) -> torch.Tensor:
    """Block layout [Np, g², 16, M] → spatial [Np, M, 4g, 4g]: block
    (q, r) = (2a1+b1, 2a2+b2) of position (i, j) is pixel (4i+2a1+a2,
    4j+2b1+b2)."""
    np_, _, _, m = masks.shape
    x = masks.reshape(np_, g, g, 2, 2, 2, 2, m)   # n i j a1 b1 a2 b2 m
    x = x.permute(0, 7, 1, 3, 5, 2, 4, 6)          # n m i a1 a2 j b1 b2
    return x.reshape(np_, m, 4 * g, 4 * g)


def mask_head_f32_scratch() -> int:
    """Floats of K3 f32's scratch (the built library's
    ``rat_mask_head_f32_scratch()``): up1_wᵀ and up2_wᵀ as TF32 hi and lo
    planes, made anew every call."""
    return 2 * (256 * 256 + 64 * 128)


def mask_head_probs_f32_scratch(n_ctas: int) -> int:
    """Floats of B6 f32's scratch for a grid of at most ``n_ctas`` CTAs
    (the built library's ``rat_mask_head_probs_f32_scratch(n_ctas)``):
    :func:`mask_head_f32_scratch`'s weight planes, then an f32 keys tile
    [64, 256] for each of a CTA's two warpgroups."""
    return mask_head_f32_scratch() + n_ctas * 2 * 64 * 256


def fused_mask_head(keys: torch.Tensor, hyper: torch.Tensor,
                    up1_w: torch.Tensor, up1_b: torch.Tensor,
                    ln_scale: torch.Tensor, ln_bias: torch.Tensor,
                    up2_w: torch.Tensor, up2_b: torch.Tensor,
                    eps: float = 1e-6,
                    content: Optional[int] = None) -> torch.Tensor:
    """Mask logits in block layout for the first ``content`` positions of
    keys [Np, gg, D] (pad-row skipping: later positions are never read).

    CUDA: kernel K3 by keys' dtype (D = 256, M ≤ 4; ``kernels/csrc/
    mask_head.cu``): bf16, persistent TMA + ``wgmma`` CTAs; f32, the same
    shape in split TF32 on the tensor cores (``rat_mask_head_f32``, after a
    pre-pass that splits the weights into :func:`mask_head_f32_scratch`
    floats); other dtypes raise. CPU: the plain version."""
    np_, gg, d = keys.shape
    content = gg if content is None else content
    if not 0 < content <= gg:
        raise ValueError(f"content {content} outside (0, {gg}]")
    if not keys.is_cuda:
        return upscale_masks_blocks(keys[:, :content], hyper, up1_w, up1_b,
                                    ln_scale, ln_bias, up2_w, up2_b, eps)
    m = hyper.shape[1]
    if d != 256 or not 1 <= m <= 4:
        raise ValueError(f"mask head kernel: D={d}, M={m} not built "
                         "(D 256, M ≤ 4)")
    dt = kernel_dtype("mask head", keys)
    kf = operand("keys", keys, dt)
    args = [operand("up1_w", up1_w.to(dt), dt, (256, 256)),
            operand("up1_b", up1_b.to(dt), dt, (64,)),
            operand("ln_scale", ln_scale.to(dt), dt, (64,)),
            operand("ln_bias", ln_bias.to(dt), dt, (64,)),
            operand("up2_w", up2_w.to(dt), dt, (64, 128)),
            operand("up2_b", up2_b.to(dt), dt, (32,)),
            operand("hyper", hyper.to(dt), dt, (np_, m, 32))]
    out = torch.empty((np_, content, 16, m), dtype=dt, device=keys.device)
    ptrs = (kf.data_ptr(), *[a.data_ptr() for a in args], out.data_ptr(),
            np_, gg, content, m, float(eps))
    if dt == torch.float32:
        scratch = torch.empty(mask_head_f32_scratch(), dtype=dt,
                              device=keys.device)
        MASK_HEAD_F32.launch(*ptrs[:9], scratch.data_ptr(), *ptrs[9:])
    else:
        MASK_HEAD.launch(*ptrs, torch.cuda.get_device_properties(
            keys.device).multi_processor_count)
    return out


def mask_head_probs_reference(img0, p1, c1m, p2, c2m, rows, hyper, up1_w,
                              up1_b, ln_scale, ln_bias, up2_w, up2_b,
                              eps: float = 1e-6, ln_eps: float = 1e-6,
                              content: Optional[int] = None) -> torch.Tensor:
    """Plain version of :func:`fused_mask_head_probs`: the branch after
    both image→token updates rebuilt in f32 for the first ``content``
    positions, rounded to img0's dtype, then the plain mask head."""
    content = img0.shape[1] if content is None else content
    keys = recon_branch(img0[:, :content], [p1[..., :content],
                                            p2[..., :content]],
                        [c1m, c2m], rows, ln_eps).to(img0.dtype)
    return upscale_masks_blocks(keys, hyper, up1_w, up1_b, ln_scale, ln_bias,
                                up2_w, up2_b, eps)


def mask_head_probs_operands(img0, p1, c1m, p2, c2m, rows, hyper, up1_w,
                             up1_b, ln_scale, ln_bias, up2_w,
                             up2_b) -> list:
    """What :func:`fused_mask_head_probs` hands its kernel before the
    output, in the C entry's order: each ``(name, tensor, dtype, shape)``
    for ``operand``. The activations (img0, C1, C2, the hypernetwork rows)
    are the caller's tensors, held to img0's dtype and never cast; P1 and
    P2 are bf16; the branch rows and the head's weights are converted to
    img0's dtype, as :func:`fused_mask_head` converts its weights."""
    _, gg, d = img0.shape
    np_, ht, _ = p1.shape
    dt, bf = img0.dtype, torch.bfloat16
    return [("img0", img0, dt, (1, gg, d)), ("p1", p1, bf, (np_, ht, gg)),
            ("c1m", c1m, dt, (np_, ht, d)), ("p2", p2, bf, (np_, ht, gg)),
            ("c2m", c2m, dt, (np_, ht, d)),
            ("branch_rows", rows.to(dt), dt, (8, d)),
            ("up1_w", up1_w.to(dt), dt, (256, 256)),
            ("up1_b", up1_b.to(dt), dt, (64,)),
            ("ln_scale", ln_scale.to(dt), dt, (64,)),
            ("ln_bias", ln_bias.to(dt), dt, (64,)),
            ("up2_w", up2_w.to(dt), dt, (64, 128)),
            ("up2_b", up2_b.to(dt), dt, (32,)),
            ("hyper", hyper, dt, (np_, hyper.shape[1], 32))]


def fused_mask_head_probs(img0: torch.Tensor, p1: torch.Tensor,
                          c1m: torch.Tensor, p2: torch.Tensor,
                          c2m: torch.Tensor, rows: torch.Tensor,
                          hyper: torch.Tensor, up1_w: torch.Tensor,
                          up1_b: torch.Tensor, ln_scale: torch.Tensor,
                          ln_bias: torch.Tensor, up2_w: torch.Tensor,
                          up2_b: torch.Tensor, eps: float = 1e-6,
                          ln_eps: float = 1e-6,
                          content: Optional[int] = None) -> torch.Tensor:
    """:func:`fused_mask_head` on the branch rebuilt per position from the
    image→token probabilities (``ops.decode_probs``): img0 [1, gg, D]
    shared; p1, p2 [Np, H·T, gg] bf16; c1m, c2m [Np, H·T, D]; rows
    [8, D] branch rows; ``ln_eps`` the branch LayerNorm's epsilon.
    Returns [Np, content, 16, M] in img0's dtype.

    CUDA: kernel B6 by img0's dtype (D 256, H·T 56, M ≤ 4, gg a multiple
    of 8; ``kernels/csrc/mask_head.cu``): bf16, K3's persistent TMA +
    ``wgmma`` CTAs behind a ``wgmma`` rebuild of the keys tile; f32, K3
    f32's split-TF32 CTAs behind a rebuild by TF32 ``mma.sync`` (P·C_hi +
    P·C_lo) into an f32 keys tile a warpgroup in
    :func:`mask_head_probs_f32_scratch`. The activations must have img0's
    dtype and P bf16 (:func:`mask_head_probs_operands`); other dtypes
    raise. CPU: the plain version."""
    _, gg, d = img0.shape
    np_, ht, _ = p1.shape
    content = gg if content is None else content
    if not 0 < content <= gg:
        raise ValueError(f"content {content} outside (0, {gg}]")
    if not img0.is_cuda:
        return mask_head_probs_reference(img0, p1, c1m, p2, c2m, rows, hyper,
                                         up1_w, up1_b, ln_scale, ln_bias,
                                         up2_w, up2_b, eps, ln_eps, content)
    m = hyper.shape[1]
    if d != 256 or ht != 56 or not 1 <= m <= 4 or gg % 8:
        raise ValueError(f"mask head (probs) kernel: D={d}, H·T={ht}, M={m}, "
                         f"gg={gg} not built (D 256, H·T 56, M ≤ 4, gg a "
                         "multiple of 8)")
    dt = kernel_dtype("mask head (probs)", img0)
    ins = [operand(*x) for x in mask_head_probs_operands(
        img0, p1, c1m, p2, c2m, rows, hyper, up1_w, up1_b, ln_scale,
        ln_bias, up2_w, up2_b)]
    out = torch.empty((np_, content, 16, m), dtype=dt, device=img0.device)
    n_ctas = torch.cuda.get_device_properties(
        img0.device).multi_processor_count
    ptrs = [a.data_ptr() for a in ins] + [out.data_ptr()]
    sizes = (np_, gg, content, m, float(eps), float(ln_eps), n_ctas)
    if dt == torch.float32:
        scratch = torch.empty(mask_head_probs_f32_scratch(n_ctas), dtype=dt,
                              device=img0.device)
        MASK_HEAD_PROBS_F32.launch(*ptrs, scratch.data_ptr(), *sizes)
    else:
        MASK_HEAD_PROBS.launch(*ptrs, *sizes)
    return out
