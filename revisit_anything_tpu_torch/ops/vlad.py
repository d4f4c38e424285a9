"""Segment VLAD: hard assignment + per-SuperSegment residual sums
(counterpart of ``revisit_anything_tpu/ops/vlad.py`` ``segment_vlad`` :61,
``global_vlad`` :140, ``hard_assignment``, ``expand_super_masks``,
``l2_normalize``)."""

from __future__ import annotations

from typing import Optional

import torch

_EPS = 1e-12  # torch F.normalize default eps


def l2_normalize(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """x / max(||x||_2, eps) along ``dim``."""
    return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True).clamp(
        min=_EPS)


def hard_assignment(desc: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Cluster label per (L2-normalized) descriptor: argmax of
    desc @ normalize(centers)ᵀ."""
    return torch.argmax(desc @ l2_normalize(centers, 1).T, dim=1)


def expand_super_masks(patch_masks: torch.Tensor,
                       adjacency: Optional[torch.Tensor]) -> torch.Tensor:
    """SuperSegment patch membership bool(adj @ masks), or masks."""
    if adjacency is None:
        return patch_masks
    return (adjacency.float() @ patch_masks.float()) > 0


def segment_vlad(desc: torch.Tensor, centers: torch.Tensor,
                 patch_masks: torch.Tensor,
                 adjacency: Optional[torch.Tensor] = None,
                 intra_norm: bool = True) -> torch.Tensor:
    """Per-segment VLADs [M, C·D] (L2-normalized; all-false mask rows give
    zero rows) from desc [P, D], centers [C, D], patch_masks [M, P] bool
    and the optional order-K adjacency [M, M] bool."""
    desc = desc.float()
    centers = centers.float()
    c = centers.shape[0]
    labels = hard_assignment(desc, centers)
    residuals = desc - centers[labels]
    super_mask = expand_super_masks(patch_masks, adjacency).float()
    onehot = torch.nn.functional.one_hot(labels, c).float()      # [P, C]
    m = patch_masks.shape[0]
    # G[p, (m, c)] = super_mask[m, p]·onehot[p, c]; vlad = Gᵀ @ residuals
    g = (super_mask.T[:, :, None] * onehot[:, None, :]).reshape(-1, m * c)
    vlads = (g.T @ residuals).reshape(m, c, -1)
    if intra_norm:
        vlads = l2_normalize(vlads, -1)
    return l2_normalize(vlads.reshape(m, -1), -1)


def global_vlad(desc: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """AnyLoc's whole-image VLAD [C·D]: ``segment_vlad`` with one all-true
    mask."""
    mask = torch.ones((1, desc.shape[0]), dtype=torch.bool,
                      device=desc.device)
    return segment_vlad(desc, centers, mask)[0]
