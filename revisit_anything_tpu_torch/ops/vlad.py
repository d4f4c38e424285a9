"""Segment VLAD: hard assignment + per-SuperSegment residual sums
(counterpart of ``revisit_anything_tpu/ops/vlad.py`` ``segment_vlad`` :61,
``soft_global_vlad`` :112, ``global_vlad`` :140,
``concat_center_residuals`` :154, ``hard_assignment``,
``expand_super_masks``, ``l2_normalize``)."""

from __future__ import annotations

from typing import Optional

import torch

from revisit_anything_tpu_torch.ops.knn import f32_products

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


def soft_global_vlad(desc: torch.Tensor, centers: torch.Tensor,
                     soft_temp: float = 1.0,
                     intra_norm: bool = True) -> torch.Tensor:
    """Soft-assignment whole-image VLAD [C·D], L2-normalized:
    softmax(temp · cosine(desc, centers)) over clusters; cluster k
    accumulates soft[q, k]·Σ_c (desc_q − center_c), the residual sum over
    ALL centers as the reference's reduction does."""
    desc = desc.float()
    centers = centers.float()
    c = centers.shape[0]
    with f32_products():
        cos = l2_normalize(desc, 1) @ l2_normalize(centers, 1).T
        soft = torch.softmax(soft_temp * cos, dim=1)             # [Q, C]
        # Σ_c (x_q − center_c) = C·x_q − Σ_c center_c
        res_all = c * desc - centers.sum(0)                      # [Q, D]
        vlad = soft.T @ res_all                                  # [C, D]
    if intra_norm:
        vlad = l2_normalize(vlad, 1)
    return l2_normalize(vlad.reshape(-1), 0)


def concat_center_residuals(centers: torch.Tensor,
                            desc: torch.Tensor) -> torch.Tensor:
    """Each descriptor's residual to EVERY center, intra-normalized per
    center, concatenated, then L2-normalized per descriptor (AnyLoc's
    ``concat_desc_dists_clusters``). Returns [N, C·D]."""
    res = desc[:, None, :].float() - centers[None].float()       # [N, C, D]
    res = l2_normalize(res, -1)
    return l2_normalize(res.reshape(desc.shape[0], -1), -1)
