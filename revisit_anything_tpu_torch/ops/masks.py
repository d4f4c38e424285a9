"""Mask → DINO patch-grid OR-pooling and mask geometry (counterpart of
``revisit_anything_tpu/ops/masks.py`` ``mask_pool_matrices`` :28,
``pool_masks_to_patch_grid`` :62, ``mask_centroids`` :76 and
``masks_to_boxes`` :94)."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from revisit_anything_tpu_torch.config import PATCH_SIZE
from revisit_anything_tpu_torch.ops.resize import nearest_indices


def mask_pool_matrices(src_hw: Tuple[int, int], dst_hw: Tuple[int, int],
                       patch: int = PATCH_SIZE
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """0/1 matrices A [dh, src_h], B [src_w, dw] such that
    ``(A @ mask @ B) > 0`` is the reference's nearest-resize-to-dst then
    pixel→patch OR-scatter (pixels past the last full patch fold into
    it)."""
    src_h, src_w = src_hw
    dst_h, dst_w = dst_hw
    dh, dw = dst_h // patch, dst_w // patch
    src_row = nearest_indices(dst_h, src_h)
    src_col = nearest_indices(dst_w, src_w)
    bin_row = np.minimum(np.arange(dst_h) // patch, dh - 1)
    bin_col = np.minimum(np.arange(dst_w) // patch, dw - 1)
    a = np.zeros((dh, src_h), dtype=np.float32)
    a[bin_row, src_row] = 1.0
    b = np.zeros((src_w, dw), dtype=np.float32)
    b[src_col, bin_col] = 1.0
    return a, b


def pool_masks_to_patch_grid(masks: torch.Tensor, a: torch.Tensor,
                             b: torch.Tensor) -> torch.Tensor:
    """OR-pool bool masks [M, src_h, src_w] to the patch grid → bool
    [M, dh·dw] (exact: 0/1 products summed in f32)."""
    pooled = torch.matmul(torch.matmul(a, masks.float()), b)
    return (pooled > 0).reshape(masks.shape[0], -1)


def mask_centroids(masks: np.ndarray) -> np.ndarray:
    """Per-mask centroid (x, y) [M, 2] f64 = mean of the true pixels'
    coordinates (0 for an empty mask); on the host, as the Delaunay
    adjacency's input."""
    out = np.empty((len(masks), 2), dtype=np.float64)
    for i, m in enumerate(masks):
        ys, xs = np.nonzero(m)
        if ys.size == 0:
            out[i] = 0.0
        else:
            out[i, 0] = xs.mean()
            out[i, 1] = ys.mean()
    return out


def masks_to_boxes(masks: torch.Tensor) -> torch.Tensor:
    """XYXY boxes [..., 4] of bool masks [..., H, W]: x2/y2 the last true
    pixel; an empty mask gives [0, 0, 0, 0]."""
    h, w = masks.shape[-2], masks.shape[-1]
    rows = masks.any(-1)
    cols = masks.any(-2)
    ridx = torch.arange(h, device=masks.device)
    cidx = torch.arange(w, device=masks.device)
    top = torch.where(rows, ridx, h).amin(-1)
    bottom = torch.where(rows, ridx, -1).amax(-1)
    left = torch.where(cols, cidx, w).amin(-1)
    right = torch.where(cols, cidx, -1).amax(-1)
    box = torch.stack([left, top, right, bottom], dim=-1)
    return torch.where(rows.any(-1, keepdim=True), box,
                       torch.zeros_like(box))
