"""DINOv2 vision transformer, dense features and checkpoint loading.

Counterpart of ``revisit_anything_tpu/models/dinov2.py``
(``DinoV2Config``, ``VIT_G14``, ``VIT_B14`` and ``CONFIGS``,
``embed_patches`` :232, ``forward_tokens`` :258, ``extract_dense`` :276,
``preprocess`` :306, ``center_crop_offsets`` :320, ``convert_dinov2_hub_state_dict``
:334, ``convert_transformers_state_dict`` :385, ``load_checkpoint``
:437). ``extract_dense`` runs blocks 0..layer−1 plus block ``layer``'s
norm1 and qkv, and returns a facet's slice (or block ``layer``'s output
tokens). ViT-g uses the SwiGLU FFN. Attention over N ≥ 1024 tokens on the
card goes through kernel K1 without bias (production N = 1 + 34·45 =
1531); shorter sequences and CPU tensors use the plain form.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from revisit_anything_tpu_torch.models.layers import (Dense, LayerNorm,
                                                     linear_leaves, load_tree,
                                                     norm_leaves, param)
from revisit_anything_tpu_torch.models.layers import state_array as _np
from revisit_anything_tpu_torch.ops.attention import attend


@dataclasses.dataclass(frozen=True)
class DinoV2Config:
    embed_dim: int
    depth: int
    num_heads: int
    patch_size: int = 14
    mlp_ratio: float = 4.0
    ffn: str = "mlp"                  # "mlp" | "swiglu"
    layerscale: bool = True
    eps: float = 1e-6
    pretrain_grid: Tuple[int, int] = (37, 37)
    num_register_tokens: int = 0
    # hub DINOv2 resizes the pos-embed grid with scale_factor =
    # (grid + offset) / pretrain_grid and maps coordinates by that factor
    interpolate_offset: float = 0.1

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def swiglu_hidden(self) -> int:
        h = int(self.embed_dim * self.mlp_ratio * 2 / 3)
        return (h + 7) // 8 * 8

    @property
    def mlp_hidden(self) -> int:
        return int(self.embed_dim * self.mlp_ratio)


VIT_G14 = DinoV2Config(embed_dim=1536, depth=40, num_heads=24, ffn="swiglu")
VIT_L14 = DinoV2Config(embed_dim=1024, depth=24, num_heads=16)
VIT_B14 = DinoV2Config(embed_dim=768, depth=12, num_heads=12)
VIT_S14 = DinoV2Config(embed_dim=384, depth=12, num_heads=6)

CONFIGS = {"dinov2_vitg14": VIT_G14, "dinov2_vitl14": VIT_L14,
           "dinov2_vitb14": VIT_B14, "dinov2_vits14": VIT_S14}

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

# sequences at least this long take the flash kernel on the card
FLASH_MIN_TOKENS = 1024


class DinoBlock(nn.Module):
    def __init__(self, cfg: DinoV2Config, *, dtype, device):
        super().__init__()
        d = cfg.embed_dim
        kw = dict(dtype=dtype, device=device)
        self.norm1 = LayerNorm(d, **kw)
        self.qkv = Dense(d, 3 * d, **kw)
        self.proj = Dense(d, d, **kw)
        self.norm2 = LayerNorm(d, **kw)
        self.ls1 = param(d, **kw) if cfg.layerscale else None
        self.ls2 = param(d, **kw) if cfg.layerscale else None
        if cfg.ffn == "swiglu":
            self.w12 = Dense(d, 2 * cfg.swiglu_hidden, **kw)
            self.w3 = Dense(cfg.swiglu_hidden, d, **kw)
        else:
            self.fc1 = Dense(d, cfg.mlp_hidden, **kw)
            self.fc2 = Dense(cfg.mlp_hidden, d, **kw)


class DinoV2(nn.Module):
    def __init__(self, cfg: DinoV2Config, *, dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        self.cfg = cfg
        d = cfg.embed_dim
        kw = dict(dtype=dtype, device=device)
        gh, gw = cfg.pretrain_grid
        self.patch_embed = Dense(cfg.patch_size * cfg.patch_size * 3, d, **kw)
        self.cls_token = param(1, 1, d, **kw)
        self.pos_embed = param(1, 1 + gh * gw, d, **kw)
        self.blocks = nn.ModuleList(DinoBlock(cfg, **kw)
                                    for _ in range(cfg.depth))
        self.norm = LayerNorm(d, **kw)
        self.register_tokens = (param(1, cfg.num_register_tokens, d, **kw)
                                if cfg.num_register_tokens else None)
        # interpolate_pos_embed's results: grid → (key, table)
        self._pos_cache: dict = {}


def _attention(x: torch.Tensor, blk: DinoBlock,
               cfg: DinoV2Config) -> torch.Tensor:
    b, n, d = x.shape
    qkv = blk.qkv(x).reshape(b, n, 3, cfg.num_heads, cfg.head_dim)
    q, k, v = (qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3))
    if x.is_cuda and n >= FLASH_MIN_TOKENS:
        out = attend(q, k, v)
    else:
        scale = 1.0 / math.sqrt(cfg.head_dim)
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        out = torch.matmul(probs.float(), v.float()).to(x.dtype)
    return blk.proj(out.permute(0, 2, 1, 3).reshape(b, n, d))


def _ffn(x: torch.Tensor, blk: DinoBlock, cfg: DinoV2Config,
         tp=None) -> torch.Tensor:
    """The block's MLP or SwiGLU FFN. With ``tp`` (a
    ``parallel.collectives.MeshAxis`` over the mesh's "model" axis) the
    hidden dimension is split over it, as the JAX train step's sharding
    splits it (``training/train.py:241-246``): ``blk`` holds this rank's
    fc1 / w12 columns (w12's x1 block and x2 block) and fc2 / w3 rows,
    and the whole 1-d fc1 / w12 bias, which is sliced to those columns;
    the partial products are summed over the axis, then the output bias
    is added once."""
    if tp is not None:
        return _ffn_tensor_parallel(x, blk, cfg, tp)
    if cfg.ffn == "swiglu":
        x1, x2 = blk.w12(x).chunk(2, dim=-1)
        return blk.w3(F.silu(x1) * x2)
    return blk.fc2(F.gelu(blk.fc1(x)))


def _ffn_tensor_parallel(x: torch.Tensor, blk: DinoBlock, cfg: DinoV2Config,
                         tp) -> torch.Tensor:
    x = tp.copy_in(x)
    if cfg.ffn == "swiglu":
        h = blk.w12.nobias(x) + tp.local(blk.w12.b, 0, halves=2)
        x1, x2 = h.chunk(2, dim=-1)
        out, last = blk.w3.nobias(F.silu(x1) * x2), blk.w3
    else:
        h = blk.fc1.nobias(x) + tp.local(blk.fc1.b, 0)
        out, last = blk.fc2.nobias(F.gelu(h)), blk.fc2
    return tp.reduce_out(out) + last.b


def _block(x: torch.Tensor, blk: DinoBlock, cfg: DinoV2Config,
           tp=None) -> torch.Tensor:
    """One transformer block; ``tp`` splits its FFN (:func:`_ffn`)."""
    a = _attention(blk.norm1(x, cfg.eps), blk, cfg)
    if blk.ls1 is not None:
        a = a * blk.ls1
    x = x + a
    f = _ffn(blk.norm2(x, cfg.eps), blk, cfg, tp)
    if blk.ls2 is not None:
        f = f * blk.ls2
    return x + f


def interpolate_pos_embed(model: DinoV2, cfg: DinoV2Config,
                          grid_hw: Tuple[int, int]) -> torch.Tensor:
    """Bicubic resize of the pretrain patch position grid to ``grid_hw``
    (keeping the cls position), with the hub's scale-factor semantics:
    source coordinate = (dst + 0.5)·pretrain/(grid + offset) − 0.5.

    Computed once per grid size and cached on the model, keyed on the
    position table's storage and version counter: a weight load writes
    the table in place (``layers.load_tree``, the seeded initializers)
    and so recomputes it (a model built in inference mode has no version
    counter and recomputes every call). Callers must not write to the
    result."""
    grid_hw = tuple(grid_hw)
    pe = model.pos_embed
    if pe.is_inference():
        return _resize_pos_embed(pe, cfg, grid_hw)
    key = (pe.device, pe.dtype, pe.data_ptr(), pe._version)
    hit = model._pos_cache.get(grid_hw)
    if hit is not None and hit[0] == key:
        return hit[1]
    with torch.inference_mode(False):
        table = _resize_pos_embed(pe, cfg, grid_hw)
    if table.is_cuda:
        # queries on other streams may read the cached table at once
        torch.cuda.current_stream(table.device).synchronize()
    model._pos_cache[grid_hw] = (key, table)
    return table


def _resize_pos_embed(pe: torch.Tensor, cfg: DinoV2Config,
                      grid_hw: Tuple[int, int]) -> torch.Tensor:
    pos = pe.float()
    cls_pos, patch_pos = pos[:, :1], pos[:, 1:]
    gh0, gw0 = cfg.pretrain_grid
    gh, gw = grid_hw
    if (gh, gw) != (gh0, gw0):
        grid = patch_pos.reshape(1, gh0, gw0, cfg.embed_dim).permute(0, 3, 1, 2)
        off = cfg.interpolate_offset
        if off:
            grid = F.interpolate(grid, mode="bicubic", align_corners=False,
                                 scale_factor=((gh + off) / gh0,
                                               (gw + off) / gw0))
        else:
            grid = F.interpolate(grid, size=(gh, gw), mode="bicubic",
                                 align_corners=False)
        if tuple(grid.shape[2:]) != (gh, gw):
            raise ValueError(f"pos-embed resize gave {tuple(grid.shape[2:])}"
                             f", expected {(gh, gw)}")
        patch_pos = grid.permute(0, 2, 3, 1).reshape(1, gh * gw, cfg.embed_dim)
    return torch.cat([cls_pos, patch_pos], dim=1)


def embed_patches(model: DinoV2, cfg: DinoV2Config,
                  images: torch.Tensor) -> torch.Tensor:
    """images [B, H, W, 3] (normalized, H/W multiples of 14) → tokens
    [B, 1+R+N, D] with the position embedding added, in the params'
    dtype."""
    images = images.to(model.patch_embed.w.dtype)
    b, h, w, _ = images.shape
    p = cfg.patch_size
    gh, gw = h // p, w // p
    x = images.reshape(b, gh, p, gw, p, 3)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, gh * gw, p * p * 3)
    x = model.patch_embed(x)
    cls = model.cls_token.to(x.dtype).expand(b, 1, cfg.embed_dim)
    x = torch.cat([cls, x], dim=1)
    x = x + interpolate_pos_embed(model, cfg, (gh, gw)).to(x.dtype)
    if model.register_tokens is not None:
        reg = model.register_tokens.to(x.dtype).expand(
            b, cfg.num_register_tokens, cfg.embed_dim)
        x = torch.cat([x[:, :1], reg, x[:, 1:]], dim=1)
    return x


def forward_tokens(model: DinoV2, cfg: DinoV2Config, images: torch.Tensor,
                   num_blocks: Optional[int] = None,
                   final_norm: bool = True) -> torch.Tensor:
    """Token states [B, 1+R+N, D] after the first ``num_blocks`` blocks
    (all if None), then the final norm unless ``final_norm`` is False."""
    x = embed_patches(model, cfg, images)
    n = cfg.depth if num_blocks is None else num_blocks
    for blk in model.blocks[:n]:
        x = _block(x, blk, cfg)
    if final_norm:
        x = model.norm(x, cfg.eps)
    return x


def patch_features(tokens: torch.Tensor, cfg: DinoV2Config,
                   image_hw: Tuple[int, int]) -> torch.Tensor:
    """Token states [B, 1+R+N, D] of an image of ``image_hw`` → the patch
    tokens as a map [B, D, gh, gw] (cls and register tokens dropped)."""
    patches = tokens[:, 1 + cfg.num_register_tokens:]
    gh, gw = (s // cfg.patch_size for s in image_hw)
    return patches.reshape(patches.shape[0], gh, gw, -1).permute(0, 3, 1, 2)


FACETS = ("query", "key", "value", "token")


def extract_dense(model: DinoV2, cfg: DinoV2Config, images: torch.Tensor,
                  layer: int, facet: str = "value") -> torch.Tensor:
    """Dense patch features [B, N_patches, D] (DinoV2ExtractFeatures
    semantics, without hooks; cls and register tokens dropped, no final
    norm). ``facet`` "query" / "key" / "value": that slice of block
    ``layer``'s qkv projection (from blocks 0..layer−1 and block
    ``layer``'s norm1 and qkv); "token": block ``layer``'s output."""
    if facet not in FACETS:
        raise ValueError(f"facet {facet!r} not in {FACETS}")
    x = embed_patches(model, cfg, images)
    for blk in model.blocks[:layer]:
        x = _block(x, blk, cfg)
    skip = 1 + cfg.num_register_tokens
    blk = model.blocks[layer]
    if facet == "token":
        return _block(x, blk, cfg)[:, skip:]
    qkv = blk.qkv(blk.norm1(x, cfg.eps))
    d = cfg.embed_dim
    i = FACETS.index(facet)
    return qkv[:, skip:, i * d:(i + 1) * d]


def preprocess(images_uint8: np.ndarray,
               patch_multiple: bool = True) -> np.ndarray:
    """RGB uint8 [B, H, W, 3] → ImageNet-normalized float32 (numpy),
    center-cropped to multiples of 14 (getAnyLocFt semantics)."""
    x = images_uint8.astype(np.float32) / 255.0
    x = (x - IMAGENET_MEAN) / IMAGENET_STD
    if patch_multiple:
        h, w = x.shape[1:3]
        hn, wn = (h // 14) * 14, (w // 14) * 14
        top, left = center_crop_offsets(h, w, hn, wn)
        x = x[:, top:top + hn, left:left + wn]
    return x


def center_crop_offsets(h: int, w: int, hn: int, wn: int):
    """torchvision CenterCrop offsets: int(round(trim / 2)) with Python's
    banker's rounding (not floor)."""
    return int(round((h - hn) / 2.0)), int(round((w - wn) / 2.0))


# ---------------------------------------------------------------------------
# Checkpoints (torch only deserializes; leaves are copied one at a time
# into the module on the device, ``layers.load_tree``)
# ---------------------------------------------------------------------------


def _patch_w(w: np.ndarray, cfg: DinoV2Config) -> np.ndarray:
    """conv [D, 3, p, p] → matmul [p·p·3, D] in ``embed_patches``'s
    (p, p, 3) order."""
    return w.transpose(2, 3, 1, 0).reshape(-1, cfg.embed_dim)


def convert_dinov2_hub_state_dict(sd: Dict, cfg: DinoV2Config, *,
                                  dtype=torch.float32,
                                  device="cuda") -> DinoV2:
    """The facebookresearch/dinov2 layout (fused qkv, SwiGLU ``w12``/``w3``
    or MLP ``fc1``/``fc2``, optional ``ls1``/``ls2`` gammas and
    ``register_tokens``) → ``DinoV2`` on ``device``. Layer scale follows
    the checkpoint (the JAX model skips a missing gamma); register tokens
    must match ``cfg.num_register_tokens``. ``mask_token`` is ignored."""
    has_ls = "blocks.0.ls1.gamma" in sd
    blocks = []
    for i in range(cfg.depth):
        p = f"blocks.{i}"
        blk = {"norm1": norm_leaves(sd, p + ".norm1"),
               "qkv": linear_leaves(sd, p + ".attn.qkv"),
               "proj": linear_leaves(sd, p + ".attn.proj"),
               "norm2": norm_leaves(sd, p + ".norm2"),
               "ls1": _np(sd, p + ".ls1.gamma") if has_ls else None,
               "ls2": _np(sd, p + ".ls2.gamma") if has_ls else None}
        if cfg.ffn == "swiglu":
            blk["w12"] = linear_leaves(sd, p + ".mlp.w12")
            blk["w3"] = linear_leaves(sd, p + ".mlp.w3")
        else:
            blk["fc1"] = linear_leaves(sd, p + ".mlp.fc1")
            blk["fc2"] = linear_leaves(sd, p + ".mlp.fc2")
        blocks.append(blk)
    tree = {
        "patch_embed": {"w": _patch_w(_np(sd, "patch_embed.proj.weight"),
                                      cfg),
                        "b": _np(sd, "patch_embed.proj.bias")},
        "cls_token": _np(sd, "cls_token"),
        "pos_embed": _np(sd, "pos_embed"),
        "blocks": blocks,
        "norm": norm_leaves(sd, "norm"),
        "register_tokens": (_np(sd, "register_tokens")
                            if "register_tokens" in sd else None),
    }
    model = DinoV2(dataclasses.replace(cfg, layerscale=has_ls), dtype=dtype,
                   device=device)
    load_tree(model, tree)
    return model


def convert_transformers_state_dict(sd: Dict, cfg: DinoV2Config, *,
                                    dtype=torch.float32,
                                    device="cuda") -> DinoV2:
    """A HuggingFace transformers ``Dinov2Model`` state dict (split q/k/v,
    layer scale always present, no register tokens) → ``DinoV2`` on
    ``device``."""
    blocks = []
    for i in range(cfg.depth):
        p = f"encoder.layer.{i}"
        a = p + ".attention.attention"
        parts = [linear_leaves(sd, f"{a}.{n}")
                 for n in ("query", "key", "value")]
        blk = {
            "norm1": norm_leaves(sd, p + ".norm1"),
            # the one leaf this layout makes a copy of
            "qkv": {"w": np.concatenate([q["w"] for q in parts], axis=1),
                    "b": np.concatenate([q["b"] for q in parts])},
            "proj": linear_leaves(sd, p + ".attention.output.dense"),
            "norm2": norm_leaves(sd, p + ".norm2"),
            "ls1": _np(sd, p + ".layer_scale1.lambda1"),
            "ls2": _np(sd, p + ".layer_scale2.lambda1"),
        }
        if cfg.ffn == "swiglu":
            blk["w12"] = linear_leaves(sd, p + ".mlp.weights_in")
            blk["w3"] = linear_leaves(sd, p + ".mlp.weights_out")
        else:
            blk["fc1"] = linear_leaves(sd, p + ".mlp.fc1")
            blk["fc2"] = linear_leaves(sd, p + ".mlp.fc2")
        blocks.append(blk)
    tree = {
        "patch_embed": {
            "w": _patch_w(_np(sd, "embeddings.patch_embeddings.projection"
                                  ".weight"), cfg),
            "b": _np(sd, "embeddings.patch_embeddings.projection.bias")},
        "cls_token": _np(sd, "embeddings.cls_token"),
        "pos_embed": _np(sd, "embeddings.position_embeddings"),
        "blocks": blocks,
        "norm": norm_leaves(sd, "layernorm"),
        "register_tokens": None,
    }
    model = DinoV2(dataclasses.replace(cfg, layerscale=True), dtype=dtype,
                   device=device)
    load_tree(model, tree)
    return model


def load_checkpoint(path: str, cfg: DinoV2Config, *, dtype=torch.float32,
                    device="cuda") -> DinoV2:
    """A torch-saved DINOv2 checkpoint (hub or transformers layout,
    optionally under a ``model`` key) → ``DinoV2`` on ``device`` in
    ``dtype``. The file is memory-mapped, so its pages are read as each
    leaf is copied."""
    sd = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    if isinstance(sd, dict) and "model" in sd:
        sd = sd["model"]
    if any(k.startswith("encoder.layer") for k in sd):
        return convert_transformers_state_dict(sd, cfg, dtype=dtype,
                                               device=device)
    return convert_dinov2_hub_state_dict(sd, cfg, dtype=dtype, device=device)
