"""DINOv1 (legacy) dense features: a stride-patched ViT and GSP log-binned
descriptors.

Counterpart of ``revisit_anything_tpu/models/dinov1.py``: the ViT-S/8,
S/16, B/8 and B/16 configurations (:22-36), ``strided_grid`` (:39),
``embed_patches_strided`` (:44), ``extract_dense`` (:75),
``_avg_pool_excl_pad`` and ``log_bin`` (:110-172) and
``load_checkpoint`` (:175). The blocks are DINOv2's without LayerScale,
so the model is the port's ``dinov2.DinoV2`` and its blocks run through
``dinov2._block``: attention over N >= 1024 tokens on the card takes
kernel K1 (in f32 for the f32 extraction: AnyLoc's ViT-S/8 at stride 4
on a 224x298 image is 4,016 tokens). The strided patch embedding is a
convolution (``F.conv2d``) outside any kernel site.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from revisit_anything_tpu_torch.models import dinov2 as dn
from revisit_anything_tpu_torch.ops.knn import f32_products

# DINOv1 variants (facebookresearch/dino): trained at 224px.
VIT_S8 = dn.DinoV2Config(embed_dim=384, depth=12, num_heads=6, patch_size=8,
                         layerscale=False, pretrain_grid=(28, 28))
VIT_S16 = dn.DinoV2Config(embed_dim=384, depth=12, num_heads=6,
                          patch_size=16, layerscale=False,
                          pretrain_grid=(14, 14))
VIT_B8 = dn.DinoV2Config(embed_dim=768, depth=12, num_heads=12, patch_size=8,
                         layerscale=False, pretrain_grid=(28, 28))
VIT_B16 = dn.DinoV2Config(embed_dim=768, depth=12, num_heads=12,
                          patch_size=16, layerscale=False,
                          pretrain_grid=(14, 14))

CONFIGS = {"dino_vits8": VIT_S8, "dino_vits16": VIT_S16,
           "dino_vitb8": VIT_B8, "dino_vitb16": VIT_B16}


def strided_grid(h: int, w: int, patch: int, stride: int) -> Tuple[int, int]:
    """Token grid for overlapping patches: 1 + (dim - patch) // stride."""
    return 1 + (h - patch) // stride, 1 + (w - patch) // stride


def embed_patches_strided(model: dn.DinoV2, cfg: dn.DinoV2Config,
                          images: torch.Tensor, stride: int) -> torch.Tensor:
    """images [B, H, W, 3] → tokens [B, 1 + gh·gw, D]: the patch
    embedding as a convolution with stride ``stride`` (overlapping
    patches), the cls token, and the position embedding resized to the
    strided grid with the hub's +0.1 offset (DINOv1's ``_fix_pos_enc``
    has the same scale-factor semantics)."""
    pw = model.patch_embed.w
    images = images.to(pw.dtype)
    b, h, w, _ = images.shape
    p, d = cfg.patch_size, cfg.embed_dim
    gh, gw = strided_grid(h, w, p, stride)
    kernel = pw.reshape(p, p, 3, d).permute(3, 2, 0, 1)     # [D, 3, p, p]
    with f32_products():
        x = F.conv2d(images.permute(0, 3, 1, 2), kernel, stride=stride)
    x = x.reshape(b, d, gh * gw).transpose(1, 2) + model.patch_embed.b
    cls = model.cls_token.to(x.dtype).expand(b, 1, d)
    x = torch.cat([cls, x], dim=1)
    return x + dn.interpolate_pos_embed(model, cfg, (gh, gw)).to(x.dtype)


def extract_dense(model: dn.DinoV2, cfg: dn.DinoV2Config,
                  images: torch.Tensor, layer: int = 11, facet: str = "key",
                  stride: int = None, use_cls: bool = False) -> torch.Tensor:
    """Dense facet features [B, N (+1 with ``use_cls``), D] at block
    ``layer`` (ViTExtractor semantics). The q/k/v facets come out
    HEAD-MINOR (channel = dim·H + head), as the reference's extractor
    flattens its hooked [B, h, t, hd] tensor; the token facet is block
    ``layer``'s output."""
    if facet not in dn.FACETS:
        raise ValueError(f"facet {facet!r} not in {dn.FACETS}")
    stride = stride or cfg.patch_size
    x = embed_patches_strided(model, cfg, images, stride)
    for blk in model.blocks[:layer]:
        x = dn._block(x, blk, cfg)
    skip = 0 if use_cls else 1
    blk = model.blocks[layer]
    if facet == "token":
        return dn._block(x, blk, cfg)[:, skip:]
    qkv = blk.qkv(blk.norm1(x, cfg.eps))
    d = cfg.embed_dim
    i = dn.FACETS.index(facet)
    out = qkv[:, skip:, i * d:(i + 1) * d]
    b, n = out.shape[0], out.shape[1]
    heads = cfg.num_heads
    return (out.reshape(b, n, heads, d // heads).transpose(2, 3)
            .reshape(b, n, d))


def _avg_pool_excl_pad(x: torch.Tensor, win: int) -> torch.Tensor:
    """AvgPool2d(win, stride 1, pad win//2, count_include_pad=False) on
    [B, C, H, W], summed in f32."""
    if win == 1:
        return x
    return F.avg_pool2d(x.float(), win, stride=1, padding=win // 2,
                        count_include_pad=False).to(x.dtype)


def log_bin(features: torch.Tensor, grid_hw: Tuple[int, int],
            hierarchy: int = 2) -> torch.Tensor:
    """GSP log-binned descriptors [B, P, D·(1 + 8·hierarchy)] of dense
    features [B, P, D] (P = gh·gw): per location, ring samples of the
    avg-pooled maps at scales 3^k with edge clamping, in raster (k, di,
    dj) order (the location itself is the centre of the k = 0 ring)."""
    gh, gw = grid_hw
    b, p, d = features.shape
    x = features.transpose(1, 2).reshape(b, d, gh, gw)
    pooled = [_avg_pool_excl_pad(x, 3 ** k).reshape(b, d, gh * gw)
              for k in range(hierarchy)]
    ys = np.arange(gh)[:, None]
    xs = np.arange(gw)[None, :]
    parts = []
    for k in range(hierarchy):
        step = 3 ** k
        for di in (-step, 0, step):
            for dj in (-step, 0, step):
                if k != 0 and di == 0 and dj == 0:
                    continue
                ci = np.clip(ys + di, 0, gh - 1)
                cj = np.clip(xs + dj, 0, gw - 1)
                idx = torch.from_numpy((ci * gw + cj).reshape(-1))
                parts.append(pooled[k][:, :, idx.to(features.device)])
    return torch.cat(parts, dim=1).transpose(1, 2)


def load_checkpoint(path: str, cfg: dn.DinoV2Config, *, dtype=torch.float32,
                    device="cuda") -> dn.DinoV2:
    """DINOv1 hub checkpoints have the fused-qkv timm layout of DINOv2's
    hub loader (no ls1/ls2 keys, so no LayerScale)."""
    return dn.load_checkpoint(path, cfg, dtype=dtype, device=device)
