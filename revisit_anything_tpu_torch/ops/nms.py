"""Exact greedy box NMS on the device and on the host (counterpart of
``revisit_anything_tpu/ops/nms.py`` ``box_iou_matrix`` :18,
``nms_keep_mask`` :33 and ``nms_host`` :87)."""

from __future__ import annotations

import numpy as np
import torch


def box_iou_matrix(boxes: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of XYXY boxes [N, 4] → [N, N]; area = (x2-x1)·(y2-y1)
    (torchvision convention, no +1)."""
    x1, y1, x2, y2 = boxes.unbind(1)
    area = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)
    ix1 = torch.maximum(x1[:, None], x1[None, :])
    iy1 = torch.maximum(y1[:, None], y1[None, :])
    ix2 = torch.minimum(x2[:, None], x2[None, :])
    iy2 = torch.minimum(y2[:, None], y2[None, :])
    inter = (ix2 - ix1).clamp(min=0) * (iy2 - iy1).clamp(min=0)
    union = area[:, None] + area[None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def nms_keep_mask(boxes: torch.Tensor, scores: torch.Tensor,
                  iou_threshold: float = 0.7) -> torch.Tensor:
    """Greedy NMS keep mask [N] bool; score −inf entries never survive.

    Greedy NMS is the unique fixed point of alive_i = valid_i ∧ ¬∃ j
    ranked before i (alive_j ∧ iou_ij > t). Jacobi sweeps (one [N, N]
    0/1 matrix-vector product each) reach it after as many sweeps as the
    longest suppression chain, and a sweep that changes nothing proves
    it: the result is exactly the sequential greedy one."""
    n = boxes.shape[0]
    order = torch.argsort(-scores, stable=True)
    iou = box_iou_matrix(boxes.float()[order])
    valid = (scores[order] > float("-inf")).float()
    idx = torch.arange(n, device=boxes.device)
    kill = ((iou > iou_threshold) & (idx[None, :] < idx[:, None])).float()
    alive = valid
    for _ in range(n + 1):
        new = valid * (torch.mv(kill, alive) == 0).float()
        if torch.equal(new, alive):
            break
        alive = new
    keep = torch.zeros(n, dtype=torch.bool, device=boxes.device)
    keep[order] = alive > 0
    return keep


def nms_host(boxes: np.ndarray, scores: np.ndarray,
             iou_threshold: float = 0.7) -> np.ndarray:
    """Greedy NMS on the host: kept indices int64 by score descending
    (stable), torchvision's return convention. A score of −inf marks a
    padding candidate and is never kept."""
    order = np.argsort(-scores, kind="stable")
    x1, y1, x2, y2 = boxes.T
    area = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
    keep = []
    suppressed = np.zeros(len(boxes), bool)
    for i in order:
        if suppressed[i] or scores[i] == -np.inf:
            continue
        keep.append(i)
        ix1 = np.maximum(x1[i], x1)
        iy1 = np.maximum(y1[i], y1)
        ix2 = np.minimum(x2[i], x2)
        iy2 = np.minimum(y2[i], y2)
        inter = np.maximum(ix2 - ix1, 0) * np.maximum(iy2 - iy1, 0)
        union = area[i] + area - inter
        with np.errstate(invalid="ignore", divide="ignore"):
            iou = np.where(union > 0, inter / union, 0.0)
        suppressed |= iou > iou_threshold
    return np.array(keep, dtype=np.int64)
