"""CosPlace-ViT intermediate-feature extractor.

Counterpart of ``revisit_anything_tpu/models/cosplace_vit.py``:
``HfViTConfig`` / ``VIT_BASE`` (:25-36), ``convert_hf_vit_state_dict``
(:71), ``load_checkpoint`` (:107) and ``extract_features`` (:165). A
HuggingFace ``ViTModel`` (ViT-B/16, separate q/k/v projections, pre-LN
blocks, LayerNorm eps 1e-12); the forward returns the facet of block
``layer`` directly (no hooks). The JAX package runs this attention plain
at every length, so the port does too (``torch.matmul`` and
``softmax``); no kernel site is on this path.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from revisit_anything_tpu_torch.models.layers import (Dense, LayerNorm,
                                                     linear_leaves, load_tree,
                                                     norm_leaves, param)
from revisit_anything_tpu_torch.models.layers import state_array as _np


@dataclasses.dataclass(frozen=True)
class HfViTConfig:
    """HuggingFace ViTConfig defaults (vit-base-patch16-224)."""
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    patch_size: int = 16
    image_size: int = 224
    intermediate: int = 3072
    eps: float = 1e-12


VIT_BASE = HfViTConfig()


class ViTBlock(nn.Module):
    def __init__(self, cfg: HfViTConfig, *, dtype, device):
        super().__init__()
        d, m = cfg.embed_dim, cfg.intermediate
        kw = dict(dtype=dtype, device=device)
        self.ln1 = LayerNorm(d, **kw)
        self.q, self.k, self.v = (Dense(d, d, **kw) for _ in range(3))
        self.attn_out = Dense(d, d, **kw)
        self.ln2 = LayerNorm(d, **kw)
        self.fc1 = Dense(d, m, **kw)
        self.fc2 = Dense(m, d, **kw)


class CosPlaceViT(nn.Module):
    """The JAX tree's layout: ``cls``, ``pos``, ``patch_w`` [p, p, 3, D],
    ``patch_b``, ``blocks``, ``norm``."""

    def __init__(self, cfg: HfViTConfig = VIT_BASE, *, dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        self.cfg = cfg
        d, p = cfg.embed_dim, cfg.patch_size
        n = (cfg.image_size // p) ** 2
        kw = dict(dtype=dtype, device=device)
        self.cls = param(1, 1, d, **kw)
        self.pos = param(1, n + 1, d, **kw)
        self.patch_w = param(p, p, 3, d, **kw)
        self.patch_b = param(d, **kw)
        self.blocks = nn.ModuleList(ViTBlock(cfg, **kw)
                                    for _ in range(cfg.depth))
        self.norm = LayerNorm(d, **kw)


def convert_hf_vit_state_dict(sd: Dict, cfg: HfViTConfig = VIT_BASE, *,
                              dtype=torch.float32,
                              device="cuda") -> CosPlaceViT:
    """A transformers ``ViTModel`` state dict → ``CosPlaceViT`` on
    ``device``."""
    blocks = []
    for i in range(cfg.depth):
        p = f"encoder.layer.{i}"
        a = p + ".attention.attention"
        blocks.append({
            "ln1": norm_leaves(sd, p + ".layernorm_before"),
            "q": linear_leaves(sd, a + ".query"),
            "k": linear_leaves(sd, a + ".key"),
            "v": linear_leaves(sd, a + ".value"),
            "attn_out": linear_leaves(sd, p + ".attention.output.dense"),
            "ln2": norm_leaves(sd, p + ".layernorm_after"),
            "fc1": linear_leaves(sd, p + ".intermediate.dense"),
            "fc2": linear_leaves(sd, p + ".output.dense")})
    tree = {
        "cls": _np(sd, "embeddings.cls_token"),
        "pos": _np(sd, "embeddings.position_embeddings"),
        # conv kernel [D, 3, ph, pw] → [ph, pw, 3, D]
        "patch_w": _np(sd, "embeddings.patch_embeddings.projection.weight"
                       ).transpose(2, 3, 1, 0),
        "patch_b": _np(sd, "embeddings.patch_embeddings.projection.bias"),
        "blocks": blocks,
        "norm": norm_leaves(sd, "layernorm"),
    }
    model = CosPlaceViT(cfg, dtype=dtype, device=device)
    load_tree(model, tree)
    return model


def load_checkpoint(path: str, cfg: HfViTConfig = VIT_BASE, *,
                    dtype=torch.float32, device="cuda") -> CosPlaceViT:
    """A torch-saved CosPlace ViT checkpoint (optionally under
    ``state_dict``; unpickled, so load only files from a trusted
    source) → ``CosPlaceViT`` on ``device``."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    sd = sd.get("state_dict", sd)
    return convert_hf_vit_state_dict(sd, cfg, dtype=dtype, device=device)


def _attn(x: torch.Tensor, blk: ViTBlock, cfg: HfViTConfig) -> torch.Tensor:
    b, n, d = x.shape
    h = cfg.num_heads
    hd = d // h
    q, k, v = (lin(x).reshape(b, n, h, hd).transpose(1, 2)
               for lin in (blk.q, blk.k, blk.v))
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(hd)
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    out = torch.matmul(probs.float(), v.float()).to(x.dtype)
    return blk.attn_out(out.transpose(1, 2).reshape(b, n, d))


def _block(x: torch.Tensor, blk: ViTBlock, cfg: HfViTConfig) -> torch.Tensor:
    x = x + _attn(blk.ln1(x, cfg.eps), blk, cfg)
    y = blk.fc2(F.gelu(blk.fc1(blk.ln2(x, cfg.eps))))
    return x + y


def embed(model: CosPlaceViT, cfg: HfViTConfig,
          images: torch.Tensor) -> torch.Tensor:
    """[B, H, W, 3] normalized → [B, 1+N, D] with cls and position."""
    b, h, w, _ = images.shape
    p = cfg.patch_size
    x = images.to(model.patch_w.dtype).reshape(b, h // p, p, w // p, p, 3)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, -1, p * p * 3)
    x = torch.matmul(x, model.patch_w.reshape(-1, cfg.embed_dim)) \
        + model.patch_b
    cls = model.cls.expand(b, 1, cfg.embed_dim)
    return torch.cat([cls, x.to(cls.dtype)], dim=1) + model.pos


FACETS = {"query": "q", "key": "k", "value": "v"}


def extract_features(model: CosPlaceViT, cfg: HfViTConfig,
                     images: torch.Tensor, layer: int, facet: str = "value",
                     use_cls: bool = False,
                     norm_descs: bool = True) -> torch.Tensor:
    """The facet of block ``layer`` ("query" / "key" / "value" Linear
    outputs, or "token", the block's output) [B, N (+1), D], the cls
    token dropped unless ``use_cls``, L2-normalized over D when
    ``norm_descs``."""
    if facet != "token" and facet not in FACETS:
        raise ValueError(f"facet {facet!r} not in {(*FACETS, 'token')}")
    x = embed(model, cfg, images)
    for blk in model.blocks[:layer]:
        x = _block(x, blk, cfg)
    blk = model.blocks[layer]
    if facet == "token":
        out = _block(x, blk, cfg)
    else:
        out = getattr(blk, FACETS[facet])(blk.ln1(x, cfg.eps))
    if not use_cls:
        out = out[:, 1:]
    if norm_descs:
        out = out / torch.linalg.vector_norm(
            out.float(), dim=-1, keepdim=True).clamp(min=1e-12).to(out.dtype)
    return out
