"""Automatic mask generation: images → SAM encoder (one dispatch a
batch) → prompt batches decoded to candidate masks at the original
resolution with IoU, stability and boxes → filters, NMS and top-k →
mask records.

Counterpart of ``revisit_anything_tpu/models/sam/amg.py``: ``AmgConfig``
(:44), ``build_point_grid``, ``generate_crop_boxes`` (:75),
``resize_longest_side``, ``preprocess_image`` (:109, PIL's downscale
into the S frame; ``_preprocess_any`` takes it for an image larger than
the frame, as JAX :368 does), ``resize_mats_and_rows`` (:158, without the
TPU's lane rounding of the row count: gh = 49 at 240×320, content 3136),
``_decode_batch`` (:223), ``_pack_bits`` (:327), ``_select_and_pack``
(:341, with the crop-edge filter), ``generate_masks`` (:380),
``generate_masks_batch`` (:411), ``_crop_candidates`` (:449),
``_assemble_records`` (:515), ``_generate_from_embedding`` (:540),
``_generate_multicrop`` (:565) and ``_postprocess_small_regions``
(:648). The resize, the three thresholdings and the per-axis stats run
in kernel K4 (``ops.maskresize.fused_resize_flags``); stability and
boxes are integer reductions of its stats, identical to reducing the
flag image.

Multi-crop AMG (``crop_n_layers`` > 0) encodes each crop of
``generate_crop_boxes`` on its own and decodes its point grid
(``points_per_side`` over ``crop_n_points_downscale_factor`` to the
layer's power), drops masks at a crop edge that is not an image edge,
uncrops the rest and keeps the smaller crop's mask where two overlap
(host NMS by 1/area of the crop box). ``min_mask_region_area`` > 0 fills
small holes and removes small islands (``native.py``), keeps the
unchanged masks first by host NMS and drops masks of at most that area.
"""

from __future__ import annotations

import dataclasses
import functools
import math
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
from revisit_anything_tpu_torch.native import nms_native, remove_small_regions
from revisit_anything_tpu_torch.ops.maskresize import (fused_resize_flags,
                                                       resize_taps)
from revisit_anything_tpu_torch.ops.nms import nms_host, nms_keep_mask
from revisit_anything_tpu_torch.ops.resize import bilinear_weight_matrix
from revisit_anything_tpu_torch.parallel import data_parallel_apply


@dataclasses.dataclass(frozen=True)
class AmgConfig:
    points_per_side: int = 32
    points_per_batch: int = 1024
    pred_iou_thresh: float = 0.88
    stability_score_thresh: float = 0.95
    stability_score_offset: float = 1.0
    box_nms_thresh: float = 0.7
    min_mask_region_area: int = 0   # > 0: small-region post-processing
    # multi-crop (automatic_mask_generator.py:40-48): layer i adds
    # (2^i)² overlapping crops, each through the whole grid pipeline,
    # deduplicated by cross-crop NMS that prefers smaller crops. The
    # server ignores these fields and decodes the one grid, as the JAX
    # server does (its pipeline/serve.py:381).
    crop_n_layers: int = 0
    crop_nms_thresh: float = 0.7
    crop_overlap_ratio: float = 512 / 1500
    crop_n_points_downscale_factor: int = 1
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


def generate_crop_boxes(im_hw: Tuple[int, int], n_layers: int,
                        overlap_ratio: float):
    """XYXY crop boxes and their layers: layer 0 the whole image, layer i
    (2^i)² crops of length ceil((overlap·(n−1) + len)/n), overlap
    int(ratio · short side · 2/n) (utils/amg.py:200-235)."""
    im_h, im_w = im_hw
    short_side = min(im_h, im_w)
    crop_boxes = [[0, 0, im_w, im_h]]
    layer_idxs = [0]

    def crop_len(orig_len, n_crops, overlap):
        return int(math.ceil((overlap * (n_crops - 1) + orig_len) / n_crops))

    for i_layer in range(n_layers):
        n_per_side = 2 ** (i_layer + 1)
        overlap = int(overlap_ratio * short_side * (2 / n_per_side))
        crop_w = crop_len(im_w, n_per_side, overlap)
        crop_h = crop_len(im_h, n_per_side, overlap)
        for x0 in (int((crop_w - overlap) * i) for i in range(n_per_side)):
            for y0 in [int((crop_h - overlap) * j)
                       for j in range(n_per_side)]:
                crop_boxes.append([x0, y0, min(x0 + crop_w, im_w),
                                   min(y0 + crop_h, im_h)])
                layer_idxs.append(i_layer + 1)
    return crop_boxes, layer_idxs


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


def preprocess_image(image_rgb: np.ndarray, cfg: SamArchConfig,
                     device="cuda") -> Tuple[torch.Tensor, Tuple[int, int]]:
    """uint8 RGB [H, W, 3] → ([1, S, S, 3] f32 on ``device``, the resized
    (pre-pad) dims): PIL's antialiased bilinear resize of the longest side
    to S (ResizeLongestSide.apply_image, utils/transforms.py:30-38), then
    normalized and zero-padded, on the host in the JAX package's numpy
    arithmetic (its ``preprocess_image``, amg.py:109-127, bit for bit),
    then one upload. PIL is imported here: the card's machine has it,
    and no module of the port loads it at import."""
    from PIL import Image
    h, w = image_rgb.shape[:2]
    nh, nw = resize_longest_side(h, w, cfg.image_size)
    resized = np.asarray(
        Image.fromarray(image_rgb).resize((nw, nh),
                                          Image.Resampling.BILINEAR),
        dtype=np.float32)
    x = (resized - np.asarray(SAM_PIXEL_MEAN)) / np.asarray(SAM_PIXEL_STD)
    out = np.zeros((1, cfg.image_size, cfg.image_size, 3), np.float32)
    out[0, :nh, :nw] = x
    return torch.from_numpy(out).to(device), (nh, nw)


def _preprocess_any(image_rgb: np.ndarray, cfg: SamArchConfig, device):
    """uint8 RGB [H, W, 3] → ([1, S, S, 3] on ``device``, input_hw), by
    the JAX package's two paths (its ``_preprocess_any``, amg.py:368):
    an image that fits the S frame goes up as uint8 and is upscaled on
    the device (:func:`_sam_preprocess_fused`; for an upscale PIL's
    antialiased bilinear is plain half-pixel bilinear); a larger one is
    downscaled on the host by PIL (:func:`preprocess_image`)."""
    h, w = image_rgb.shape[:2]
    input_hw = resize_longest_side(h, w, cfg.image_size)
    if input_hw[0] < h or input_hw[1] < w:
        return preprocess_image(image_rgb, cfg, device)
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


def amg_taps(key: tuple, device, dtype: torch.dtype) -> tuple:
    """K4's tap tables of the resize matrices of ``key`` = (cfg, input_hw,
    orig_hw) (:func:`resize_mats_and_rows`), wh's weights at the logits'
    ``dtype`` (rounded to bf16 for bf16 logits, kept f32 for f32 ones, as
    the JAX package rounds its row matrix to the logits' dtype), built
    once per (key, dtype, device)."""
    wh_np, ww_np, _ = resize_mats_and_rows(*key)
    return tuple(device_constant(
        ("amg_taps", i, dtype) + key, device,
        lambda i=i: resize_taps(wh_np, ww_np, dtype)[i]) for i in range(2))


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
    lowres_blk, iou = decode_masks(sam.decoder, cfg, image_embedding,
                                   image_pe, sparse, dense, mask_rows=gh,
                                   decode=amg.decode)
    iou = iou.reshape(-1)
    # K4's tap tables; the CPU path takes the dense matrices
    taps = (amg_taps(key, dev, lowres_blk.dtype) if dev.type == "cuda"
            else None)

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
                valid: torch.Tensor, amg: AmgConfig, k_take: int,
                crop_box=None, orig_box=None):
    """The AMG filters (validity, stability, predicted IoU when its
    threshold is positive, and with ``crop_box`` / ``orig_box`` (XYXY
    tuples) the crop-edge filter: no box within 20 px of a crop edge
    that is not within 20 px of the image's, is_box_near_crop_edge,
    utils/amg.py:78-89), greedy box NMS over the survivors, and the kept
    candidates by predicted IoU descending (stable).

    Returns (order [k_take] candidate indices, the kept ones first;
    n_kept, a 0-d tensor ≤ k_take)."""
    keep = valid & (stab >= amg.stability_score_thresh)
    if amg.pred_iou_thresh > 0.0:
        keep = keep & (iou > amg.pred_iou_thresh)
    if crop_box is not None:
        dev = boxes.device
        x0, y0 = crop_box[0], crop_box[1]
        cb, ob, off = (device_constant(("amg_box", tuple(v)), dev,
                                       lambda v=v: np.asarray(v, np.float32))
                       for v in (crop_box, orig_box, (x0, y0, x0, y0)))
        b = boxes + off
        near_crop = (b - cb).abs() <= 20.0
        near_img = (b - ob).abs() <= 20.0
        keep = keep & ~(near_crop & ~near_img).any(1)
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
                     max_out: int, crop_box=None, orig_box=None):
    """Filters, NMS and the top ``max_out`` on the device; only the kept
    masks' bits are packed. Returns (packed, order, n_kept)."""
    order, n_kept = _keep_order(iou, stab, boxes, valid, amg, max_out,
                                crop_box, orig_box)
    return _pack_bits(masks[order]), order, n_kept


def _crop_candidates(sam, embedding: torch.Tensor,
                     input_hw: Tuple[int, int], crop_hw: Tuple[int, int],
                     amg: AmgConfig, max_masks: int, points_per_side: int,
                     crop_box=None, orig_box=None):
    """Decode the ``points_per_side``² grid over one crop (its SAM frame
    ``input_hw``, its size ``crop_hw``) and return its kept candidates
    on the host, in NMS keep order: (masks bool [n, h, w], iou [n],
    stability [n], points [n, 2] and boxes [n, 4] XYXY, both in the
    crop's frame). ``crop_box`` / ``orig_box`` turn the crop-edge filter
    on (:func:`_keep_order`)."""
    cfg = sam.cfg
    h, w = crop_hw
    dev = embedding.device
    image_pe = dense_positional_embedding(sam.prompt, cfg)[0]
    bsz = min(amg.points_per_batch, points_per_side ** 2)
    key = (points_per_side, tuple(input_hw), tuple(crop_hw), bsz)
    pts_in, pts_orig, valid = prompt_points(*key)
    pts = device_constant(("amg_points",) + key, dev, lambda: pts_in)
    valid_dev = device_constant(("amg_valid",) + key, dev,
                                lambda: np.repeat(valid, 3))
    outs = [_decode_batch(sam, cfg, embedding, image_pe, pts[s:s + bsz],
                          input_hw, crop_hw, amg)
            for s in range(0, pts.shape[0], bsz)]
    masks, iou, stab, boxes = (torch.cat(t) for t in zip(*outs))
    max_out = min(max_masks, masks.shape[0])
    packed, order, n_kept = _select_and_pack(masks, iou, stab, boxes,
                                             valid_dev, amg, max_out,
                                             crop_box, orig_box)
    n_kept = int(n_kept)
    if n_kept == 0:
        z = np.zeros((0,))
        return (np.zeros((0, h, w), bool), z, z, np.zeros((0, 2)),
                np.zeros((0, 4), np.float32))
    order = order[:n_kept]
    masks = np.unpackbits(packed[:n_kept].cpu().numpy(),
                          axis=-1)[:, :, :w].astype(bool)
    return (masks, iou[order].float().cpu().numpy(),
            stab[order].cpu().numpy(),
            np.repeat(pts_orig, 3, axis=0)[order.cpu().numpy()],
            boxes[order].cpu().numpy())


def _assemble_records(final_masks, iou, stab, points, crop_boxes_per_mask,
                      amg: AmgConfig) -> List[MaskRecord]:
    """MaskRecords of the masks of area above ``min_mask_region_area``
    (the reference's final area filter, automatic_mask_generator.py
    :192-194), each with its crop box as XYWH."""
    records = []
    for j, seg in enumerate(final_masks):
        area = int(seg.sum())
        if area <= amg.min_mask_region_area:
            continue
        ys, xs = np.nonzero(seg)
        bbox = (float(xs.min()), float(ys.min()),
                float(xs.max() - xs.min()), float(ys.max() - ys.min()))
        records.append(MaskRecord(
            segmentation=seg, area=area, bbox=bbox,
            predicted_iou=float(iou[j]),
            point_coords=points[j][None, :].astype(np.float64),
            stability_score=float(stab[j]),
            crop_box=tuple(crop_boxes_per_mask[j])))
    return records


def _postprocess_small_regions(masks: List[np.ndarray], min_area: int,
                               nms_thresh: float):
    """Fill small holes and remove small islands in each mask, then NMS
    that prefers the unchanged masks (postprocess_small_regions,
    automatic_mask_generator.py:324-376). Returns (kept masks, their
    indices), in NMS keep order: the unchanged masks first, not
    re-sorted."""
    new_masks, unchanged = [], []
    for m in masks:
        m2, ch_holes = remove_small_regions(m, min_area, "holes")
        m2, ch_islands = remove_small_regions(m2, min_area, "islands")
        new_masks.append(m2)
        unchanged.append(float(not (ch_holes or ch_islands)))
    boxes = []
    for m in new_masks:
        ys, xs = np.nonzero(m)
        boxes.append([xs.min(), ys.min(), xs.max(), ys.max()]
                     if len(xs) else [0, 0, 0, 0])
    keep = nms_native(np.asarray(boxes, np.float32),
                      np.asarray(unchanged, np.float32), nms_thresh)
    return [new_masks[i] for i in keep], keep


def _finish(masks, iou, stab, points, crop_boxes, amg: AmgConfig):
    """Small-region post-processing (at the larger of the box and crop
    NMS thresholds, as the reference passes even with one crop) and the
    records; ``crop_boxes`` XYWH a mask."""
    final_masks = list(masks)
    keep = np.arange(len(final_masks))
    if amg.min_mask_region_area > 0 and final_masks:
        final_masks, keep = _postprocess_small_regions(
            final_masks, amg.min_mask_region_area,
            max(amg.box_nms_thresh, amg.crop_nms_thresh))
    return _assemble_records(final_masks, iou[keep], stab[keep],
                             points[keep], [crop_boxes[k] for k in keep],
                             amg)


def _generate_from_embedding(sam, embedding: torch.Tensor,
                             input_hw: Tuple[int, int],
                             orig_hw: Tuple[int, int], amg: AmgConfig,
                             max_masks: int) -> List[MaskRecord]:
    """The one grid over the whole image: records in NMS keep order."""
    h, w = orig_hw
    masks, iou, stab, points, _ = _crop_candidates(
        sam, embedding, input_hw, orig_hw, amg, max_masks,
        amg.points_per_side)
    if len(masks) == 0:
        return []
    return _finish(masks, iou, stab, points, [(0, 0, w, h)] * len(masks),
                   amg)


def _generate_multicrop(sam, image_rgb: np.ndarray, amg: AmgConfig,
                        max_masks: int) -> List[MaskRecord]:
    """Multi-crop AMG (_generate_masks / _process_crop,
    automatic_mask_generator.py:198-265): per crop one encode and the
    scaled point grid with the crop-edge filter and the crop's NMS; masks,
    points and boxes uncropped to the image; cross-crop host NMS scored
    1/area(crop box), so smaller crops win; at most ``max_masks``
    records, best predicted IoU first."""
    orig_h, orig_w = image_rgb.shape[:2]
    crop_boxes, layer_idxs = generate_crop_boxes(
        (orig_h, orig_w), amg.crop_n_layers, amg.crop_overlap_ratio)
    dev = sam.encoder.pos_embed.device
    all_masks, all_iou, all_stab, all_pts, all_boxes, all_cb = (
        [], [], [], [], [], [])
    for cb, layer in zip(crop_boxes, layer_idxs):
        x0, y0, x1, y1 = cb
        crop = image_rgb[y0:y1, x0:x1]
        with torch.inference_mode():
            batched, input_hw = _preprocess_any(crop, sam.cfg, dev)
            embedding = sam.encoder(batched)[0]
            pps = max(1, int(amg.points_per_side
                             / (amg.crop_n_points_downscale_factor ** layer)))
            masks, iou, stab, pts, bxs = _crop_candidates(
                sam, embedding, input_hw, crop.shape[:2], amg, max_masks,
                pps, crop_box=tuple(cb), orig_box=(0, 0, orig_w, orig_h))
        if len(masks) == 0:
            continue
        unc = np.zeros((len(masks), orig_h, orig_w), bool)
        unc[:, y0:y1, x0:x1] = masks
        all_masks.append(unc)
        all_iou.append(iou)
        all_stab.append(stab)
        all_pts.append(pts + np.array([x0, y0], np.float32))
        all_boxes.append(bxs + np.array([x0, y0, x0, y0], np.float32))
        all_cb.extend([tuple(cb)] * len(masks))
    if not all_masks:
        return []
    masks = np.concatenate(all_masks)
    iou = np.concatenate(all_iou)
    stab = np.concatenate(all_stab)
    points = np.concatenate(all_pts)
    if len(crop_boxes) > 1:
        boxes = np.concatenate(all_boxes).astype(np.float32)
        areas = np.array([(c[2] - c[0]) * (c[3] - c[1]) for c in all_cb],
                         np.float64)
        keep = nms_host(boxes, (1.0 / areas).astype(np.float32),
                        amg.crop_nms_thresh)
        masks, iou, stab, points = (masks[keep], iou[keep], stab[keep],
                                    points[keep])
        all_cb = [all_cb[k] for k in keep]
    records = _finish(masks, iou, stab, points,
                      [(c[0], c[1], c[2] - c[0], c[3] - c[1])
                       for c in all_cb], amg)
    if len(records) > max_masks:
        records.sort(key=lambda r: -r.predicted_iou)
        records = records[:max_masks]
    return records


def generate_masks(sam, image_rgb: np.ndarray, amg: AmgConfig = AmgConfig(),
                   max_masks: int = 512) -> List[MaskRecord]:
    """Automatic mask generation for one uint8 RGB image on ``sam``'s
    device: records by predicted IoU descending (NMS keep order), at most
    ``max_masks``."""
    return generate_masks_batch(sam, [image_rgb], amg, max_masks)[0]


def _encode(encoder, x: torch.Tensor) -> torch.Tensor:
    return encoder(x)


def generate_masks_batch(sam, images_rgb: Sequence[np.ndarray],
                         amg: AmgConfig = AmgConfig(),
                         max_masks: int = 512,
                         mesh=None) -> List[List[MaskRecord]]:
    """AMG over same-shape images: one encoder dispatch for the batch,
    then each image's prompt batches, filters and records. Multi-crop
    (``crop_n_layers`` > 0) encodes each crop on its own, so its images
    run one at a time. With a mesh of several devices (JAX :415-439) the
    encoder batch is split over it (``parallel.data_parallel_apply``),
    the embeddings gathered on ``sam``'s device, where every image is
    decoded."""
    if not len(images_rgb):
        return []
    if len({im.shape for im in images_rgb}) != 1:
        raise ValueError("generate_masks_batch needs same-shape images")
    if amg.crop_n_layers > 0:
        return [_generate_multicrop(sam, im, amg, max_masks)
                for im in images_rgb]
    dev = sam.encoder.pos_embed.device
    with torch.inference_mode():
        pre = [_preprocess_any(im, sam.cfg, dev) for im in images_rgb]
        batched = torch.cat([p[0] for p in pre])
        if mesh is not None and mesh.size > 1:
            embeddings = data_parallel_apply(_encode, sam.encoder, batched,
                                             mesh)
        else:
            embeddings = sam.encoder(batched)
        return [_generate_from_embedding(sam, embeddings[i], pre[i][1],
                                         images_rgb[i].shape[:2], amg,
                                         max_masks)
                for i in range(len(images_rgb))]
