"""Automatic mask generation: images → SAM encoder (one dispatch a
batch) → prompt batches decoded to candidate masks at the original
resolution with IoU, stability and boxes → filters, NMS and top-k →
mask records.

Counterpart of ``revisit_anything_tpu/models/sam/amg.py``: ``AmgConfig``,
``build_point_grid``, ``resize_longest_side``, ``resize_mats_and_rows``
(:158, without the TPU's lane rounding of the row count: gh = 49 at
240×320, content 3136), ``_decode_batch`` (:223), ``_pack_bits`` (:327),
``_select_and_pack`` (:341), ``generate_masks`` (:380),
``generate_masks_batch`` (:411), ``_crop_candidates`` (:449, one crop),
``_assemble_records`` (:515) and ``_generate_from_embedding`` (:540).
The resize, the three thresholdings and the per-axis stats run in kernel
K4 (``ops.maskresize.fused_resize_flags``); stability and boxes are
integer reductions of its stats, identical to reducing the flag image.

Not ported yet: multi-crop AMG and the small-region post-processing
(the JAX ``AmgConfig``'s ``crop_*`` and ``min_mask_region_area`` fields),
so records keep every non-empty mask and carry the full-image crop box.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch

from revisit_anything_tpu_torch.io.h5io import MaskRecord
from revisit_anything_tpu_torch.models.layers import device_constant
from revisit_anything_tpu_torch.models.sam.config import (SAM_PIXEL_MEAN,
                                                          SAM_PIXEL_STD,
                                                          SamArchConfig)
from revisit_anything_tpu_torch.models.sam.decoder import (DECODES,
                                                           decode_masks)
from revisit_anything_tpu_torch.models.sam.prompt import (
    dense_positional_embedding, embed_points, no_mask_dense_embedding)
from revisit_anything_tpu_torch.ops.maskresize import (fused_resize_flags,
                                                       resize_taps)
from revisit_anything_tpu_torch.ops.nms import nms_keep_mask
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


def prompt_points(points_per_side: int, input_hw: Tuple[int, int],
                  crop_hw: Tuple[int, int], bsz: int):
    """The point grid over a crop, in the crop's frame (``pts_orig``) and
    in the SAM frame (apply_coords scaling, ``pts_in``), padded to whole
    batches of ``bsz`` with zero points; ``valid`` [n + pad] marks the
    real ones. Returns (pts_in [n + pad, 2] f32, pts_orig f64, valid)."""
    h, w = crop_hw
    pts_orig = build_point_grid(points_per_side) * np.array([w, h],
                                                            np.float32)
    scale = np.array([input_hw[1] / w, input_hw[0] / h], np.float32)
    pts_in = (pts_orig * scale).astype(np.float32)
    n = len(pts_in)
    pad = (-n) % bsz
    pts_in = np.concatenate([pts_in, np.zeros((pad, 2), np.float32)])
    pts_orig = np.concatenate([pts_orig, np.zeros((pad, 2))])
    valid = np.concatenate([np.ones(n, bool), np.zeros(pad, bool)])
    return pts_in, pts_orig, valid


def _sam_preprocess_fused(img_u8: torch.Tensor, rh: torch.Tensor,
                          rw: torch.Tensor, pad_to: int) -> torch.Tensor:
    """uint8 [H, W, 3] → [1, S, S, 3] normalized SAM input. rh/rw are the
    per-axis bilinear matrices to the S frame's resized size; the resized
    image is re-quantized to uint8 levels (half to even) before
    normalizing, as the reference normalizes PIL's uint8 output."""
    x = img_u8.float()
    x = torch.einsum("oh,hwc->owc", rh, x)
    x = torch.einsum("pw,owc->opc", rw, x)
    x = torch.clamp(torch.round(x), 0.0, 255.0)
    mean = device_constant(("sam_pixel_mean",), x.device,
                           lambda: torch.tensor(SAM_PIXEL_MEAN))
    std = device_constant(("sam_pixel_std",), x.device,
                          lambda: torch.tensor(SAM_PIXEL_STD))
    x = (x - mean) / std
    nh, nw = x.shape[0], x.shape[1]
    return torch.nn.functional.pad(x, (0, 0, 0, pad_to - nw,
                                       0, pad_to - nh))[None]


def _preprocess_any(image_rgb: np.ndarray, cfg: SamArchConfig, device):
    """uint8 RGB [H, W, 3] → ([1, S, S, 3] on ``device``, input_hw): the
    JAX package's device path, bilinear upscaling to the S frame. Raises
    where the JAX package takes its host PIL path (an image larger than
    the S frame, downscaled with PIL's antialiased filter): no dataset of
    ``config.DATASETS`` does, and the port does not reproduce PIL."""
    h, w = image_rgb.shape[:2]
    input_hw = resize_longest_side(h, w, cfg.image_size)
    if input_hw[0] < h or input_hw[1] < w:
        raise NotImplementedError(
            f"a {h}x{w} image is downscaled into SAM's {cfg.image_size} "
            "frame by PIL's antialiased bilinear filter, which the port "
            "does not reproduce")
    rh = device_constant(("sam_pre_rows", input_hw[0], h), device,
                         lambda: bilinear_weight_matrix(input_hw[0], h))
    rw = device_constant(("sam_pre_cols", input_hw[1], w), device,
                         lambda: bilinear_weight_matrix(input_hw[1], w))
    img = torch.from_numpy(np.ascontiguousarray(image_rgb)).to(device)
    return _sam_preprocess_fused(img, rh, rw, cfg.image_size), input_hw


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


def _keep_order(iou: torch.Tensor, stab: torch.Tensor, boxes: torch.Tensor,
                valid: torch.Tensor, amg: AmgConfig, k_take: int):
    """The AMG filters (validity, stability, predicted IoU when its
    threshold is positive), greedy box NMS over the survivors, and the
    kept candidates by predicted IoU descending (stable).

    Returns (order [k_take] candidate indices, the kept ones first;
    n_kept, a 0-d tensor ≤ k_take)."""
    keep = valid & (stab >= amg.stability_score_thresh)
    if amg.pred_iou_thresh > 0.0:
        keep = keep & (iou > amg.pred_iou_thresh)
    neg = float("-inf")
    nms_keep = nms_keep_mask(boxes, iou.masked_fill(~keep, neg),
                             amg.box_nms_thresh)
    final_scores = iou.masked_fill(~(nms_keep & keep), neg)
    order = torch.argsort(-final_scores, stable=True)[:k_take]
    n_kept = torch.clamp((final_scores > neg).sum(), max=k_take)
    return order, n_kept


def _pack_bits(masks: torch.Tensor) -> torch.Tensor:
    """bool [M, H, W] → uint8 [M, H, ceil(W/8)] in ``np.unpackbits``'s
    layout (first pixel in the high bit): 8× less to read back."""
    m, h, w = masks.shape
    x = torch.nn.functional.pad(masks.to(torch.uint8), (0, (-w) % 8))
    x = x.reshape(m, h, -1, 8).to(torch.int32)
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int32,
                           device=masks.device)
    return (x * weights).sum(-1).to(torch.uint8)


def _select_and_pack(masks, iou, stab, boxes, valid, amg: AmgConfig,
                     max_out: int):
    """Filters, NMS and the top ``max_out`` on the device; only the kept
    masks' bits are packed. Returns (packed, order, n_kept)."""
    order, n_kept = _keep_order(iou, stab, boxes, valid, amg, max_out)
    return _pack_bits(masks[order]), order, n_kept


def _crop_candidates(sam, embedding: torch.Tensor,
                     input_hw: Tuple[int, int], orig_hw: Tuple[int, int],
                     amg: AmgConfig, max_masks: int):
    """Decode the point grid over the whole image (the one crop) and
    return its kept candidates on the host, in NMS keep order: (masks
    bool [n, h, w], iou [n], stability [n], points [n, 2] in the image's
    frame)."""
    cfg = sam.cfg
    h, w = orig_hw
    dev = embedding.device
    image_pe = dense_positional_embedding(sam.prompt, cfg)[0]
    bsz = min(amg.points_per_batch, amg.points_per_side ** 2)
    key = (amg.points_per_side, tuple(input_hw), tuple(orig_hw), bsz)
    pts_in, pts_orig, valid = prompt_points(*key)
    pts = device_constant(("amg_points",) + key, dev, lambda: pts_in)
    valid_dev = device_constant(("amg_valid",) + key, dev,
                                lambda: np.repeat(valid, 3))
    outs = [_decode_batch(sam, cfg, embedding, image_pe, pts[s:s + bsz],
                          input_hw, orig_hw, amg)
            for s in range(0, pts.shape[0], bsz)]
    masks, iou, stab, boxes = (torch.cat(t) for t in zip(*outs))
    max_out = min(max_masks, masks.shape[0])
    packed, order, n_kept = _select_and_pack(masks, iou, stab, boxes,
                                             valid_dev, amg, max_out)
    n_kept = int(n_kept)
    if n_kept == 0:
        z = np.zeros((0,))
        return np.zeros((0, h, w), bool), z, z, np.zeros((0, 2))
    order = order[:n_kept]
    masks = np.unpackbits(packed[:n_kept].cpu().numpy(),
                          axis=-1)[:, :, :w].astype(bool)
    return (masks, iou[order].float().cpu().numpy(),
            stab[order].cpu().numpy(),
            np.repeat(pts_orig, 3, axis=0)[order.cpu().numpy()])


def _assemble_records(final_masks, iou, stab, points) -> List[MaskRecord]:
    """MaskRecords of the non-empty masks (the reference's final area
    filter at ``min_mask_region_area`` 0), each with the full-image crop
    box."""
    records = []
    for j, seg in enumerate(final_masks):
        area = int(seg.sum())
        if area == 0:
            continue
        ys, xs = np.nonzero(seg)
        bbox = (float(xs.min()), float(ys.min()),
                float(xs.max() - xs.min()), float(ys.max() - ys.min()))
        records.append(MaskRecord(
            segmentation=seg, area=area, bbox=bbox,
            predicted_iou=float(iou[j]),
            point_coords=points[j][None, :].astype(np.float64),
            stability_score=float(stab[j]),
            crop_box=(0, 0, seg.shape[1], seg.shape[0])))
    return records


def _generate_from_embedding(sam, embedding: torch.Tensor,
                             input_hw: Tuple[int, int],
                             orig_hw: Tuple[int, int], amg: AmgConfig,
                             max_masks: int) -> List[MaskRecord]:
    return _assemble_records(*_crop_candidates(sam, embedding, input_hw,
                                               orig_hw, amg, max_masks))


def generate_masks(sam, image_rgb: np.ndarray, amg: AmgConfig = AmgConfig(),
                   max_masks: int = 512) -> List[MaskRecord]:
    """Automatic mask generation for one uint8 RGB image on ``sam``'s
    device: records by predicted IoU descending (NMS keep order), at most
    ``max_masks``."""
    return generate_masks_batch(sam, [image_rgb], amg, max_masks)[0]


def generate_masks_batch(sam, images_rgb: Sequence[np.ndarray],
                         amg: AmgConfig = AmgConfig(),
                         max_masks: int = 512) -> List[List[MaskRecord]]:
    """AMG over same-shape images: one encoder dispatch for the batch,
    then each image's prompt batches, filters and records."""
    if not len(images_rgb):
        return []
    if len({im.shape for im in images_rgb}) != 1:
        raise ValueError("generate_masks_batch needs same-shape images")
    dev = sam.encoder.pos_embed.device
    with torch.inference_mode():
        pre = [_preprocess_any(im, sam.cfg, dev) for im in images_rgb]
        embeddings = sam.encoder(torch.cat([p[0] for p in pre]))
        return [_generate_from_embedding(sam, embeddings[i], pre[i][1],
                                         images_rgb[i].shape[:2], amg,
                                         max_masks)
                for i in range(len(images_rgb))]
