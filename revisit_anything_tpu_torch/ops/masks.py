"""Mask → DINO patch-grid OR-pooling (counterpart of
``revisit_anything_tpu/ops/masks.py`` ``mask_pool_matrices`` :28 and
``pool_masks_to_patch_grid`` :62)."""

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
