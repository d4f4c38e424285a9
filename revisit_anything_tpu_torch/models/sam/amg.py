"""Automatic mask generation: one prompt batch → candidate masks at the
original resolution with IoU, stability and boxes.

Counterpart of ``revisit_anything_tpu/models/sam/amg.py``: ``AmgConfig``,
``build_point_grid``, ``resize_longest_side``, ``resize_mats_and_rows``
(:158, without the TPU's lane rounding of the row count: gh = 49 at
240×320, content 3136) and ``_decode_batch`` (:223). The resize, the
three thresholdings and the per-axis stats run in kernel K4
(``ops.maskresize.fused_resize_flags``); stability and boxes are integer
reductions of its stats, identical to reducing the flag image.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from revisit_anything_tpu_torch.models.layers import device_constant
from revisit_anything_tpu_torch.models.sam.config import SamArchConfig
from revisit_anything_tpu_torch.models.sam.decoder import (DECODES,
                                                           decode_masks)
from revisit_anything_tpu_torch.models.sam.prompt import (
    embed_points, no_mask_dense_embedding)
from revisit_anything_tpu_torch.ops.maskresize import (fused_resize_flags,
                                                       resize_taps)
from revisit_anything_tpu_torch.ops.resize import bilinear_weight_matrix


@dataclasses.dataclass(frozen=True)
class AmgConfig:
    points_per_side: int = 32
    points_per_batch: int = 1024
    pred_iou_thresh: float = 0.88
    stability_score_thresh: float = 0.95
    stability_score_offset: float = 1.0
    box_nms_thresh: float = 0.7
    # two-way decoder form, one of decoder.DECODES: "shared" (K5), or the
    # probability-factored "probs_split", "fused_tail_probs",
    # "fused_tail_keys" (the JAX package's TPU default),
    # "fused_tail_logits" (the mask head inside the decode tail)
    decode: str = "shared"

    def __post_init__(self):
        if self.decode not in DECODES:
            raise ValueError(f"decode {self.decode!r} is not one of "
                             f"{DECODES}")


def build_point_grid(n_per_side: int) -> np.ndarray:
    """[n², 2] xy points in [0,1]² at cell centres, row-major over y."""
    offset = 1.0 / (2 * n_per_side)
    coords = np.linspace(offset, 1.0 - offset, n_per_side)
    xs, ys = np.meshgrid(coords, coords)
    return np.stack([xs.ravel(), ys.ravel()], axis=-1)


def resize_longest_side(h: int, w: int, long_side: int) -> Tuple[int, int]:
    """ResizeLongestSide target (utils/transforms.py get_preprocess_shape)."""
    scale = long_side / max(h, w)
    return int(h * scale + 0.5), int(w * scale + 0.5)


@functools.lru_cache(maxsize=8)
def resize_mats_and_rows(cfg: SamArchConfig, input_hw: Tuple[int, int],
                         orig_hw: Tuple[int, int]):
    """Composed per-axis lowres→original resize matrices (postprocess_masks:
    bilinear 4g→S, crop to the input, bilinear → original) and the number
    of token rows whose logits carry non-zero weight.

    Returns (wh [H, 4·gh], ww [W, 4·g], gh) as numpy f32 (cached per
    shape; callers must not write to the arrays)."""
    up_h = bilinear_weight_matrix(cfg.image_size, cfg.lowres_size)
    wh = bilinear_weight_matrix(orig_hw[0], input_hw[0]) @ up_h[:input_hw[0]]
    ww = bilinear_weight_matrix(orig_hw[1], input_hw[1]) @ up_h[:input_hw[1]]
    used_cols = int(np.flatnonzero(np.abs(wh).sum(axis=0) > 0.0).max()) + 1
    gh = min(-(-used_cols // 4), cfg.grid)
    return wh[:, :4 * gh], ww, gh


def _decode_batch(sam, cfg: SamArchConfig, image_embedding: torch.Tensor,
                  image_pe: torch.Tensor, points_1024: torch.Tensor,
                  input_hw: Tuple[int, int], orig_hw: Tuple[int, int],
                  amg: AmgConfig):
    """Decode one prompt batch and derive every candidate statistic.

    ``sam`` holds ``.prompt`` and ``.decoder``.

    Returns (masks bool [B·3, H, W], iou [B·3], stability [B·3] f32,
    boxes [B·3, 4] f32 XYXY, x2/y2 the last true pixel, empty → 0)."""
    dev = image_embedding.device
    bsz = points_1024.shape[0]
    sparse = embed_points(sam.prompt, cfg, points_1024[:, None, :],
                          torch.ones((bsz, 1), dtype=torch.int32,
                                     device=dev), pad=True)
    dense = no_mask_dense_embedding(sam.prompt, cfg, 1)
    key = (cfg, tuple(input_hw), tuple(orig_hw))
    wh_np, ww_np, gh = resize_mats_and_rows(*key)
    wh = device_constant(("amg_resize_h",) + key, dev, lambda: wh_np)
    ww = device_constant(("amg_resize_w",) + key, dev, lambda: ww_np)
    # K4's tap tables; the CPU path takes the dense matrices
    taps = None
    if dev.type == "cuda":
        taps = tuple(device_constant(("amg_taps", i) + key, dev,
                                     lambda i=i: resize_taps(wh_np, ww_np)[i])
                     for i in range(2))
    lowres_blk, iou = decode_masks(sam.decoder, cfg, image_embedding,
                                   image_pe, sparse, dense, mask_rows=gh,
                                   decode=amg.decode)
    iou = iou.reshape(-1)

    hgt, wid = orig_hw
    flags, rowst, colany = fused_resize_flags(
        lowres_blk, wh, ww, cfg.mask_threshold, amg.stability_score_offset,
        grid_hw=(gh, cfg.grid), taps=taps)
    masks_bool = (flags.reshape(-1, hgt, wid) & 2) != 0
    rowst = rowst.reshape(-1, hgt, 3)
    hi = rowst[..., 1].sum(-1).float()
    lo = rowst[..., 2].sum(-1).float()
    stability = hi / lo.clamp(min=1.0)
    rows = rowst[..., 0] > 0                             # [B·3, H]
    cols = colany.reshape(-1, wid) > 0                   # [B·3, W]
    ridx = torch.arange(hgt, device=dev)
    cidx = torch.arange(wid, device=dev)
    top = torch.where(rows, ridx, hgt).amin(1)
    bottom = torch.where(rows, ridx, -1).amax(1)
    left = torch.where(cols, cidx, wid).amin(1)
    right = torch.where(cols, cidx, -1).amax(1)
    empty = ~rows.any(1)
    boxes = torch.stack([left, top, right, bottom], dim=1)
    boxes = torch.where(empty[:, None], torch.zeros_like(boxes), boxes).float()
    return masks_bool, iou, stability, boxes
