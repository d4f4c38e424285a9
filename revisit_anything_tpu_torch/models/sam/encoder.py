"""SAM image encoder: ViTDet with windowed attention and decomposed
relative-position bias, NHWC throughout.

Counterpart of ``revisit_anything_tpu/models/sam/encoder.py``
(``encode_image`` :243, ``_attention`` :109, ``_rel_pos_gather`` :64,
windows :200-216, neck :268-278). Global layers go through kernel K1
(``ops.attention.attend``) with the q-projected bias components. The
windowed layers (N = 196) take one of two forms, picked by the
encoder's ``window_attention``: ``"plain"`` (the default, as the JAX
package's ``_WINATTN`` is off) keeps them in plain torch with bf16
scores, as the JAX package keeps them on XLA; ``"kernel"`` sends every
square layer below 1024 tokens through kernel B11
(``ops.winattn.windowed_attend``), as ``_WINATTN = "on"`` does
(encoder.py:120-136). The patch embed is a reshape and one matmul.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from revisit_anything_tpu_torch.models.layers import (Dense, LayerNorm,
                                                     device_constant, param)
from revisit_anything_tpu_torch.models.sam.config import SamArchConfig
from revisit_anything_tpu_torch.ops.attention import attend
from revisit_anything_tpu_torch.ops.winattn import windowed_attend

WINDOW_ATTENTIONS = ("plain", "kernel")
# layers below this many tokens (square) take B11 in the "kernel" form:
# every windowed layer, and global layers of small encoders
_WINDOW_KERNEL_MAX_TOKENS = 1024


def _linear_interp_matrix(out_size: int, in_size: int) -> np.ndarray:
    """torch F.interpolate(mode='linear', align_corners=False) as a dense
    [out, in] matrix (rel-pos table resize when sizes mismatch)."""
    if out_size == in_size:
        return np.eye(out_size, dtype=np.float32)
    scale = in_size / out_size
    x = (np.arange(out_size) + 0.5) * scale - 0.5
    lo = np.floor(x).astype(np.int64)
    t = x - lo
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    for tap, w in ((0, 1.0 - t), (1, t)):
        idx = np.clip(lo + tap, 0, in_size - 1)
        np.add.at(mat, (np.arange(out_size), idx), w)
    return mat.astype(np.float32)


def rel_pos_gather(rel_pos: torch.Tensor, q_size: int,
                   k_size: int) -> torch.Tensor:
    """[q_size, k_size, head_dim] relative-position table (the
    reference's get_rel_pos: resize the table to 2·max−1 entries, gather
    by relative coordinate)."""
    max_rel = 2 * max(q_size, k_size) - 1
    dev = rel_pos.device
    if rel_pos.shape[0] != max_rel:
        n_in = rel_pos.shape[0]
        m = device_constant(("rel_pos_interp", max_rel, n_in), dev,
                            lambda: _linear_interp_matrix(max_rel, n_in))
        rel_pos = (m @ rel_pos.float()).to(rel_pos.dtype)
    return rel_pos[rel_pos_index(q_size, k_size, dev)]


def rel_pos_index(q_size: int, k_size: int, device) -> torch.Tensor:
    """[q_size, k_size] int64 relative coordinates into the resized
    table, built once per (sizes, device) (``layers.device_constant``)."""
    def make():
        q_coords = np.arange(q_size)[:, None] * max(k_size / q_size, 1.0)
        k_coords = np.arange(k_size)[None, :] * max(q_size / k_size, 1.0)
        rel = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
        return rel.astype(np.int64)
    return device_constant(("rel_pos_index", q_size, k_size), device, make)


class EncoderBlock(nn.Module):
    def __init__(self, cfg: SamArchConfig, size: int, *, dtype, device):
        super().__init__()
        d = cfg.encoder_dim
        kw = dict(dtype=dtype, device=device)
        self.norm1 = LayerNorm(d, **kw)
        self.qkv = Dense(d, 3 * d, **kw)
        self.proj = Dense(d, d, **kw)
        self.rel_pos_h = param(2 * size - 1, cfg.head_dim, **kw)
        self.rel_pos_w = param(2 * size - 1, cfg.head_dim, **kw)
        self.norm2 = LayerNorm(d, **kw)
        self.lin1 = Dense(d, int(d * cfg.mlp_ratio), **kw)
        self.lin2 = Dense(int(d * cfg.mlp_ratio), d, **kw)


class Neck(nn.Module):
    def __init__(self, cfg: SamArchConfig, *, dtype, device):
        super().__init__()
        d, pd = cfg.encoder_dim, cfg.prompt_dim
        kw = dict(dtype=dtype, device=device)
        self.conv1_w = param(d, pd, **kw)
        self.ln1 = LayerNorm(pd, **kw)
        self.conv2_w = param(3, 3, pd, pd, **kw)         # HWIO
        self.ln2 = LayerNorm(pd, **kw)


def _attention(x: torch.Tensor, blk: EncoderBlock, cfg: SamArchConfig,
               global_layer: bool, window_kernel: bool) -> torch.Tensor:
    """Attention over NHWC tokens with decomposed rel-pos bias
    (image_encoder.py:185-240, :292-361)."""
    b, h, w, d = x.shape
    nh, hd = cfg.encoder_heads, cfg.head_dim
    qkv = blk.qkv(x.reshape(b, h * w, d))

    if window_kernel and h == w and h * w < _WINDOW_KERNEL_MAX_TOKENS:
        # B11 on the raw qkv and the q-projected bias components in
        # head-major channels [b, N, nh·side], f32 accumulate
        rh = rel_pos_gather(blk.rel_pos_h, h, h)
        rw = rel_pos_gather(blk.rel_pos_w, w, w)
        qg = qkv[..., :d].reshape(b, h, w, nh, hd).float()
        bias_h = torch.einsum("bhwnd,hkd->bhwnk", qg,
                              rh.to(qkv.dtype).float()).to(x.dtype)
        bias_w = torch.einsum("bhwnd,wkd->bhwnk", qg,
                              rw.to(qkv.dtype).float()).to(x.dtype)
        out = windowed_attend(qkv, bias_h.reshape(b, h * w, nh * h),
                              bias_w.reshape(b, h * w, nh * w), nh, side=h)
        return blk.proj(out).reshape(b, h, w, d)

    q = qkv[..., :d].reshape(b, h * w, nh, hd)
    k = qkv[..., d:2 * d].reshape(b, h * w, nh, hd)
    v = qkv[..., 2 * d:].reshape(b, h * w, nh, hd)
    rh = rel_pos_gather(blk.rel_pos_h, h, h)             # [h, h, hd]
    rw = rel_pos_gather(blk.rel_pos_w, w, w)             # [w, w, hd]
    qg = q.reshape(b, h, w, nh, hd)

    if global_layer:
        # q-projected bias components [b, nh, N, side], f32 accumulate
        bias_h = torch.einsum("bhwnd,hkd->bnhwk", qg.float(),
                              rh.to(q.dtype).float()).to(x.dtype)
        bias_w = torch.einsum("bhwnd,wkd->bnhwk", qg.float(),
                              rw.to(q.dtype).float()).to(x.dtype)
        out = attend(q.permute(0, 2, 1, 3), k.permute(0, 2, 1, 3),
                     v.permute(0, 2, 1, 3),
                     bias_h.reshape(b, nh, h * w, h),
                     bias_w.reshape(b, nh, h * w, w), side=h)
        out = out.permute(0, 2, 1, 3).reshape(b, h * w, nh * hd)
        return blk.proj(out).reshape(b, h, w, d)

    # Windowed layers: in bf16 the scores and softmax stay bf16 (the JAX
    # package's measured trade-off); f32 inference keeps f32 scores.
    scale = hd ** -0.5
    logits = torch.einsum("bnhd,bmhd->bhnm", q, k) * scale
    bias_h = torch.einsum("bhwnd,hkd->bnhwk", qg, rh.to(q.dtype))
    bias_w = torch.einsum("bhwnd,wkd->bnhwk", qg, rw.to(q.dtype))
    bh = bias_h.reshape(b, nh, h * w, h)
    bw = bias_w.reshape(b, nh, h * w, w)
    logits = logits + (bh.repeat_interleave(w, dim=-1) + bw.repeat(1, 1, 1, h))
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    out = torch.einsum("bhnm,bmhd->bnhd", probs.float(), v.float()).to(x.dtype)
    return blk.proj(out.reshape(b, h * w, nh * hd)).reshape(b, h, w, d)


def _window_partition(x: torch.Tensor, ws: int):
    b, h, w, c = x.shape
    ph, pw = (-h) % ws, (-w) % ws
    x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = h + ph, w + pw
    x = x.reshape(b, hp // ws, ws, wp // ws, ws, c)
    wins = x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, c)
    return wins, (hp, wp)


def _window_unpartition(wins: torch.Tensor, ws: int, pad_hw, hw):
    hp, wp = pad_hw
    h, w = hw
    b = wins.shape[0] // (hp * wp // ws // ws)
    x = wins.reshape(b, hp // ws, wp // ws, ws, ws, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)
    return x[:, :h, :w]


class ImageEncoder(nn.Module):
    """ImageEncoderViT + neck; ``forward`` is the JAX ``encode_image``.

    ``window_attention`` (an attribute, so one set of weights serves both
    ways) is one of ``WINDOW_ATTENTIONS`` (module docstring)."""

    def __init__(self, cfg: SamArchConfig, *, dtype=torch.float32,
                 device="cuda", window_attention: str = "plain"):
        super().__init__()
        self.cfg = cfg
        self.window_attention = window_attention
        d = cfg.encoder_dim
        kw = dict(dtype=dtype, device=device)
        self.patch_embed = Dense(cfg.patch_size * cfg.patch_size * 3, d, **kw)
        self.pos_embed = param(1, cfg.grid, cfg.grid, d, **kw)
        self.blocks = nn.ModuleList(
            EncoderBlock(cfg, cfg.grid if i in cfg.global_attn_indexes
                         else cfg.window_size, **kw)
            for i in range(cfg.encoder_depth))
        self.neck = Neck(cfg, **kw)

    def _block(self, x: torch.Tensor, i: int) -> torch.Tensor:
        cfg = self.cfg
        blk = self.blocks[i]
        shortcut = x
        x = blk.norm1(x, cfg.eps)
        kernel = self.window_attention == "kernel"
        if i in cfg.global_attn_indexes:
            x = _attention(x, blk, cfg, True, kernel)
        else:
            hw = (x.shape[1], x.shape[2])
            x, pad_hw = _window_partition(x, cfg.window_size)
            x = _attention(x, blk, cfg, False, kernel)
            x = _window_unpartition(x, cfg.window_size, pad_hw, hw)
        x = shortcut + x
        y = blk.norm2(x, cfg.eps)
        return x + blk.lin2(F.gelu(blk.lin1(y)))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images [B, S, S, 3] (pixel-normalized) → [B, g, g, prompt_dim]."""
        if self.window_attention not in WINDOW_ATTENTIONS:
            raise ValueError(f"window_attention {self.window_attention!r} "
                             f"is not one of {WINDOW_ATTENTIONS}")
        cfg = self.cfg
        images = images.to(self.patch_embed.w.dtype)
        b, hh, ww, _ = images.shape
        p = cfg.patch_size
        gh, gw = hh // p, ww // p
        x = images.reshape(b, gh, p, gw, p, 3)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, gh, gw, p * p * 3)
        x = self.patch_embed(x)
        x = x + self.pos_embed.to(x.dtype)
        for i in range(len(self.blocks)):
            x = self._block(x, i)
        neck = self.neck
        x = torch.matmul(x, neck.conv1_w.to(x.dtype))
        x = neck.ln1(x, cfg.eps)
        x = F.conv2d(x.permute(0, 3, 1, 2),
                     neck.conv2_w.to(x.dtype).permute(3, 2, 0, 1),
                     padding=1).permute(0, 2, 3, 1)
        return neck.ln2(x.contiguous(), cfg.eps)
