"""SAM prompt encoder: random-Fourier positional encoding and point
embeddings (counterpart of ``revisit_anything_tpu/models/sam/prompt.py``:
``dense_positional_embedding`` :37, ``embed_points`` :52,
``no_mask_dense_embedding`` :99). Only what automatic mask generation
needs: point prompts, the dense grid PE and the no-mask embedding."""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from revisit_anything_tpu_torch.models.layers import param
from revisit_anything_tpu_torch.models.sam.config import SamArchConfig


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


def no_mask_dense_embedding(prompt: PromptEncoder, cfg: SamArchConfig,
                            batch: int) -> torch.Tensor:
    """no_mask embedding broadcast over the grid → [B, g, g, prompt_dim]."""
    g = cfg.grid
    return prompt.no_mask.reshape(1, 1, 1, -1).expand(
        batch, g, g, cfg.prompt_dim)
