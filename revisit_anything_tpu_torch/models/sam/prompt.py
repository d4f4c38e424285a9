"""SAM prompt encoder: random-Fourier positional encoding, point and box
embeddings, and the dense embedding of a mask prompt or of none
(counterpart of ``revisit_anything_tpu/models/sam/prompt.py``:
``dense_positional_embedding`` :37, ``embed_points`` :52,
``embed_boxes`` :84, ``no_mask_dense_embedding`` :99, ``embed_masks``
:112)."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from revisit_anything_tpu_torch.models.layers import LayerNorm, param
from revisit_anything_tpu_torch.models.sam.config import SamArchConfig

# channels of the mask-prompt downscaling stack (build_sam.py:93)
MASK_IN_CHANS = 16


class MaskDownscaling(nn.Module):
    """PromptEncoder.mask_downscaling (prompt_encoder.py:51-60): conv k2s2
    1 → c/4, channel LN, GELU, conv k2s2 c/4 → c, channel LN, GELU, 1x1
    conv c → prompt_dim. Convolution weights are HWIO, as in the JAX
    tree."""

    def __init__(self, prompt_dim: int, *, dtype, device):
        super().__init__()
        mc = MASK_IN_CHANS
        kw = dict(dtype=dtype, device=device)
        self.conv1_w = param(2, 2, 1, mc // 4, **kw)
        self.conv1_b = param(mc // 4, **kw)
        self.ln1 = LayerNorm(mc // 4, **kw)
        self.conv2_w = param(2, 2, mc // 4, mc, **kw)
        self.conv2_b = param(mc, **kw)
        self.ln2 = LayerNorm(mc, **kw)
        self.conv3_w = param(mc, prompt_dim, **kw)
        self.conv3_b = param(prompt_dim, **kw)


class PromptEncoder(nn.Module):
    """``dense_pe``: keep a second Fourier matrix, ``pe_gaussian_dense``,
    for the dense image PE (the HuggingFace layout's
    ``shared_image_embedding``, independent of the prompts' matrix);
    without it the dense PE uses ``pe_gaussian``, as in the original
    layout."""

    def __init__(self, cfg: SamArchConfig, *, dtype=torch.float32,
                 device="cuda", dense_pe: bool = False):
        super().__init__()
        pd = cfg.prompt_dim
        kw = dict(dtype=dtype, device=device)
        self.pe_gaussian = param(2, pd // 2, **kw)
        self.pe_gaussian_dense = param(2, pd // 2, **kw) if dense_pe else None
        self.point_embed = param(4, pd, **kw)
        self.not_a_point = param(pd, **kw)
        self.no_mask = param(pd, **kw)
        self.mask_down = MaskDownscaling(pd, **kw)


def _fourier_pe(coords01: torch.Tensor, gaussian: torch.Tensor) -> torch.Tensor:
    """coords in [0, 1] (..., 2) → [..., 2·num_feats] (f32)."""
    c = 2.0 * coords01.float() - 1.0
    c = torch.matmul(c, gaussian.float())
    c = 2.0 * math.pi * c
    return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)


def dense_positional_embedding(prompt: PromptEncoder,
                               cfg: SamArchConfig) -> torch.Tensor:
    """PE of the g×g grid cell centres → [1, g, g, prompt_dim] f32, by
    ``pe_gaussian_dense`` where the encoder has one (JAX ``prompt.py``
    :45), else by ``pe_gaussian``."""
    g = cfg.grid
    ys = (np.arange(g, dtype=np.float32) + 0.5) / g
    xs = (np.arange(g, dtype=np.float32) + 0.5) / g
    grid = np.stack(np.meshgrid(xs, ys, indexing="xy"), axis=-1)
    gaussian = (prompt.pe_gaussian_dense
                if prompt.pe_gaussian_dense is not None
                else prompt.pe_gaussian)
    grid = torch.from_numpy(grid).to(gaussian.device)
    return _fourier_pe(grid, gaussian)[None]


def embed_points(prompt: PromptEncoder, cfg: SamArchConfig,
                 coords: torch.Tensor, labels: torch.Tensor,
                 pad: bool = True) -> torch.Tensor:
    """coords [B, N, 2] (x, y) in the resized frame, labels [B, N]
    (1 positive, 0 negative, −1 padding) → [B, N(+1), prompt_dim]; ``pad``
    appends the padding point box-less prompts carry."""
    coords = coords.float() + 0.5
    if pad:
        b = coords.shape[0]
        coords = torch.cat([coords, coords.new_zeros(b, 1, 2)], dim=1)
        labels = torch.cat([labels, -torch.ones_like(labels[:, :1])], dim=1)
    pe = _fourier_pe(coords / cfg.image_size, prompt.pe_gaussian)
    lab = labels[..., None]
    out = torch.where(lab == -1, prompt.not_a_point.float(), pe)
    out = torch.where(lab == 0, out + prompt.point_embed[0].float(), out)
    out = torch.where(lab == 1, out + prompt.point_embed[1].float(), out)
    return out


def embed_boxes(prompt: PromptEncoder, cfg: SamArchConfig,
                boxes: torch.Tensor) -> torch.Tensor:
    """[B, N, 4] XYXY boxes in the resized frame → [B, 2N, prompt_dim]
    corner embeddings (pixel-centre shift, Fourier PE, the two corner
    embeddings added)."""
    b, n, _ = boxes.shape
    corners = (boxes.float() + 0.5).reshape(b, n, 2, 2)
    pe = _fourier_pe(corners / cfg.image_size, prompt.pe_gaussian)
    corner_embed = prompt.point_embed[2:4].float()            # [2, D]
    return (pe + corner_embed).reshape(b, 2 * n, -1)


def embed_masks(prompt: PromptEncoder, cfg: SamArchConfig,
                masks: torch.Tensor) -> torch.Tensor:
    """Mask-prompt dense embedding: low-res mask logits [B, 4g, 4g] →
    [B, g, g, prompt_dim] f32 through ``mask_down``, all in f32 (exact
    GELU; each k2s2 convolution is a reshape and one product)."""
    md = prompt.mask_down
    x = masks[..., None].float()                              # NHWC, C 1

    def conv2s2(x, w, bias):
        bsz, h, wd, c = x.shape
        xr = x.reshape(bsz, h // 2, 2, wd // 2, 2, c).permute(
            0, 1, 3, 2, 4, 5).reshape(bsz, h // 2, wd // 2, 4 * c)
        return torch.matmul(xr, w.float().reshape(-1, w.shape[-1])) \
            + bias.float()

    def chan_ln(x, ln):
        mu = x.mean(-1, keepdim=True)
        var = x.var(-1, unbiased=False, keepdim=True)
        return (x - mu) * torch.rsqrt(var + 1e-6) * ln.scale.float() \
            + ln.bias.float()

    x = F.gelu(chan_ln(conv2s2(x, md.conv1_w, md.conv1_b), md.ln1))
    x = F.gelu(chan_ln(conv2s2(x, md.conv2_w, md.conv2_b), md.ln2))
    return torch.matmul(x, md.conv3_w.float()) + md.conv3_b.float()


def no_mask_dense_embedding(prompt: PromptEncoder, cfg: SamArchConfig,
                            batch: int) -> torch.Tensor:
    """no_mask embedding broadcast over the grid → [B, g, g, prompt_dim]."""
    g = cfg.grid
    return prompt.no_mask.reshape(1, 1, 1, -1).expand(
        batch, g, g, cfg.prompt_dim)
