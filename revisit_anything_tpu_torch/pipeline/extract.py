"""Offline extraction: images → SAM mask records and DINOv2 dense features,
in the h5 schemas the JAX package and the reference read.

Counterpart of ``revisit_anything_tpu/pipeline/extract.py``:
``load_image_rgb``, ``_resize_cv2_bilinear``, ``_fallback_records``,
``extract_sam_masks`` (:68), ``extract_dino_features`` (:135, with
its ``mesh``: the batch split over the mesh's devices by
``parallel.data_parallel_apply``, as the SAM encoder batch of
``generate_masks_batch``),
``extract_dinov1_features_to_h5`` (:182), ``extract_dinonv_features_to_h5``
(:267) and ``extract_dinosalad_features_to_h5`` (:303). SAM runs at half
the DINO resolution (``config.DatasetConfig.sam_size``); DINOv2-g's
layer-31 value facet at the full one, L2-normalized over channels. The
per-batch work (:func:`generate_masks_batch`, :func:`dino_dense_features`,
:func:`dinov1_dense_features`, :func:`dinonv_dense_features`,
:func:`dinosalad_dense_features`) is separate from the h5 files, so it
runs where ``h5py`` is not installed. The h5 drivers record the JAX
package's stages in ``utils.profiling.stage_timer()`` (``sam.load``,
``sam.generate``, ``sam.write``, ``dino.*``, ``dinov1.*``, ...).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from revisit_anything_tpu_torch.io.h5io import (MaskRecord, open_h5,
                                                write_dino_features,
                                                write_image_masks)
from revisit_anything_tpu_torch.models import dinov2 as dn
from revisit_anything_tpu_torch.models.layers import device_constant
from revisit_anything_tpu_torch.models.sam.amg import (AmgConfig,
                                                       generate_masks_batch)
from revisit_anything_tpu_torch.ops.vlad import l2_normalize
from revisit_anything_tpu_torch.parallel import (data_parallel_apply,
                                                 resolve_mesh)
from revisit_anything_tpu_torch.utils.profiling import stage_timer


def load_image_rgb(path: str) -> np.ndarray:
    """uint8 RGB image from disk (PIL, imported here)."""
    from PIL import Image
    return np.asarray(Image.open(path).convert("RGB"))


def _cv2_linear_taps(out_size: int, in_size: int) -> np.ndarray:
    """cv2's INTER_LINEAR taps along one axis: first source index and the
    two 11-bit fixed-point weights (x = (d + 0.5)·in/out − 0.5 in f32,
    clamped at the borders) → int32 [out, 3]."""
    fx = ((np.arange(out_size) + 0.5) * (in_size / out_size) - 0.5
          ).astype(np.float32)
    sx = np.floor(fx).astype(np.int64)
    fx = (fx - sx).astype(np.float32)
    low, high = sx < 0, sx >= in_size - 1
    fx[low | high] = 0.0
    sx = np.clip(sx, 0, in_size - 1)
    a1 = np.rint(fx * np.float32(2048)).astype(np.int64)
    a0 = np.rint((np.float32(1) - fx) * np.float32(2048)).astype(np.int64)
    return np.stack([sx, a0, a1], axis=1).astype(np.int32)


def _resize_cv2_bilinear(img: np.ndarray, wh: Tuple[int, int]) -> np.ndarray:
    """The reference's image resize, ``cv2.resize(img, wh, INTER_LINEAR)``
    with ``wh`` = (width, height), in cv2's fixed-point arithmetic on a
    tensor (no cv2 needed): 11-bit weights, the column pass summed exactly
    in integers, the row pass as cv2's vector code does it (each column
    sum shifted right by 4, times the 11-bit weight, the high 16 bits
    kept, then (sum + 2) >> 2). It gave cv2 4.x's values exactly for
    downscales (the SAM inputs: half the DINO size); an upscale differs
    by one level at ~0.3-0.5% of the values
    (``tests/test_torch_offline.py``)."""
    w, h = wh
    in_h, in_w = img.shape[:2]
    if (in_h, in_w) == (h, w):
        return np.array(img)
    th = torch.from_numpy(_cv2_linear_taps(h, in_h))
    tw = torch.from_numpy(_cv2_linear_taps(w, in_w))
    x = torch.from_numpy(np.ascontiguousarray(img)).to(torch.int32)
    c0 = tw[:, 0].long()
    c1 = (c0 + 1).clamp(max=in_w - 1)
    cols = x[:, c0] * tw[:, 1, None] + x[:, c1] * tw[:, 2, None]
    r0 = th[:, 0].long()
    r1 = (r0 + 1).clamp(max=in_h - 1)
    rows = (((cols[r0] >> 4) * th[:, 1, None, None]) >> 16) + (
        ((cols[r1] >> 4) * th[:, 2, None, None]) >> 16)
    return ((rows + 2) >> 2).clamp(0, 255).to(torch.uint8).numpy()


# One stream across calls, as the reference draws the pixel from numpy's
# global RNG: a fresh default_rng(0) a call would give every zero-mask
# image the same pixel. Same seed as the JAX package's, so calls made in
# the same order draw the same pixels.
_FALLBACK_RNG = np.random.default_rng(0)


def _fallback_records(hw: Tuple[int, int]) -> List[MaskRecord]:
    """Records for an image where AMG keeps nothing: a full-frame mask and
    one random pixel (the reference's FastSAM empty-output fallback, which
    the JAX package also applies to SAM), so the image's segment table is
    not empty."""
    h, w = hw
    full = np.ones((h, w), dtype=bool)
    pixel = np.zeros((h, w), dtype=bool)
    ry = int(_FALLBACK_RNG.integers(0, h))
    rx = int(_FALLBACK_RNG.integers(0, w))
    pixel[ry, rx] = True
    return [MaskRecord(full, h * w, (0, 0, w - 1, h - 1), 0.0,
                       np.zeros((1, 2)), 0.0, (0, 0, w, h)),
            MaskRecord(pixel, 1, (rx, ry, 0, 0), 0.0,
                       np.zeros((1, 2)), 0.0, (0, 0, w, h))]


def extract_sam_masks(image_paths: Sequence[str], image_keys: Sequence[str],
                      out_h5_path: str, sam, target_hw: Tuple[int, int],
                      amg: AmgConfig = AmgConfig(), progress: bool = True,
                      encode_batch: int = 0, mesh="auto") -> None:
    """AMG over images resized to ``target_hw``, written in the mask h5
    schema; ``encode_batch`` images a SAM encoder dispatch (0: the mesh's
    device count, 1 without a mesh), the fallback records where none is
    kept. Runs on ``sam``'s device; with a mesh of several devices
    ("auto": every card, when ``sam`` is on one) the encoder batch is
    split over it."""
    mesh = resolve_mesh(mesh, sam.encoder.pos_embed.device)
    if encode_batch <= 0:
        encode_batch = mesh.size if mesh is not None and mesh.size > 1 else 1
    timer = stage_timer()
    with open_h5(out_h5_path, "w") as f:
        for s in range(0, len(image_paths), encode_batch):
            with timer.stage("sam.load"):
                imgs = [_resize_cv2_bilinear(load_image_rgb(p),
                                             (target_hw[1], target_hw[0]))
                        for p in image_paths[s:s + encode_batch]]
            with timer.stage("sam.generate"):
                per_image = generate_masks_batch(sam, imgs, amg, mesh=mesh)
            with timer.stage("sam.write"):
                for key, records in zip(image_keys[s:s + encode_batch],
                                        per_image):
                    if not records:
                        records = _fallback_records(target_hw)
                    write_image_masks(f, key, records)
                    if progress:
                        print(f"[sam] {key}: {len(records)} masks",
                              flush=True)


def _dino_forward(layer: int, facet: str):
    def forward(model, x):
        return dn.extract_dense(model, model.cfg, x, layer, facet)
    return forward


def dino_dense_features(dino, images_u8: np.ndarray, layer: int = 31,
                        facet: str = "value", mesh=None) -> torch.Tensor:
    """uint8 RGB [B, H, W, 3] → f32 [B, D, dh, dw] on ``dino``'s device:
    ImageNet normalization, centre crop to patch multiples, the facet of
    block ``layer``, L2-normalized over D. With a mesh of several
    devices the forward's batch is split over it
    (``parallel.data_parallel_apply``; "auto": every card)."""
    cfg = dino.cfg
    dev = dino.pos_embed.device
    x = torch.from_numpy(np.ascontiguousarray(images_u8)).to(dev)
    x = x.float() / 255.0
    mean = device_constant(("imagenet_mean",), dev, lambda: dn.IMAGENET_MEAN)
    std = device_constant(("imagenet_std",), dev, lambda: dn.IMAGENET_STD)
    x = (x - mean) / std
    h, w = x.shape[1:3]
    hn, wn = (h // 14) * 14, (w // 14) * 14
    top, left = dn.center_crop_offsets(h, w, hn, wn)
    x = x[:, top:top + hn, left:left + wn]
    mesh = resolve_mesh(mesh, dev)
    fwd = _dino_forward(layer, facet)
    with torch.inference_mode():
        if mesh is not None and mesh.size > 1:
            feats = data_parallel_apply(fwd, dino, x, mesh).float()
        else:
            feats = fwd(dino, x).float()
    b = feats.shape[0]
    feats = feats.transpose(1, 2).reshape(b, -1, hn // 14, wn // 14)
    return l2_normalize(feats, 1)


def extract_dino_features(image_paths: Sequence[str],
                          image_keys: Sequence[str], out_h5_path: str, dino,
                          target_hw: Tuple[int, int], layer: int = 31,
                          facet: str = "value", batch_size: int = 8,
                          progress: bool = True, mesh="auto") -> None:
    """DINOv2 dense features of images resized to ``target_hw`` →
    ``ift_dino`` [1, D, dh, dw] per image, ``batch_size`` images a
    forward. Runs on ``dino``'s device, the batch split over ``mesh``
    when it has several devices ("auto": every card, when ``dino`` is on
    one; None: one device)."""
    mesh = resolve_mesh(mesh, dino.pos_embed.device)
    _h5_features(image_paths, image_keys, out_h5_path, target_hw,
                 batch_size, progress, "dino",
                 lambda imgs: dino_dense_features(dino, imgs, layer, facet,
                                                  mesh))


def dinov1_dense_features(model, cfg, images_u8: np.ndarray,
                          stride: int = 4, layer: int = 11,
                          facet: str = "key", load_size: int = 224,
                          binned: bool = False,
                          upsample: bool = True) -> torch.Tensor:
    """uint8 RGB [B, H, W, 3] at the dataset size → DINOv1 features
    [B, D (·17 binned), H, W] (``upsample``) or [B, ·, gh, gw] on
    ``model``'s device: /255 with NO ImageNet normalization, the float
    bilinear resize of the short side to ``load_size`` (torchvision
    ``F.resize(int)``), the stride-``stride`` facet of block ``layer``
    (head-minor channels) in the model's dtype, the optional GSP log
    binning, then the align-corners bilinear upsample to (H, W). Raw,
    not normalized."""
    from revisit_anything_tpu_torch.models import dinov1 as d1
    from revisit_anything_tpu_torch.ops.resize import (
        bilinear_resize_align_corners, bilinear_resize_torch)
    th, tw = images_u8.shape[1:3]
    if th <= tw:
        lh, lw = load_size, int(load_size * tw / th)
    else:
        lh, lw = int(load_size * th / tw), load_size
    gh, gw = d1.strided_grid(lh, lw, cfg.patch_size, stride)
    dev = model.pos_embed.device
    x = torch.from_numpy(np.ascontiguousarray(images_u8)).to(dev)
    x = x.float().permute(0, 3, 1, 2) / 255.0
    x = bilinear_resize_torch(x, (lh, lw)).permute(0, 2, 3, 1)
    with torch.inference_mode():
        feats = d1.extract_dense(model, cfg, x, layer=layer, facet=facet,
                                 stride=stride)
        if binned:
            feats = d1.log_bin(feats, (gh, gw))
        fm = feats.transpose(1, 2).reshape(len(images_u8), -1, gh, gw)
        if upsample:
            fm = bilinear_resize_align_corners(fm.float(), (th, tw))
    return fm.float()


def _h5_features(image_paths, image_keys, out_h5_path, target_hw,
                 batch_size, progress, tag, features) -> None:
    """The h5 loop of the dense extractors: images resized to
    ``target_hw`` (cv2 bilinear), ``features(uint8 batch)`` → one
    ``ift_dino`` [1, D, h, w] entry an image; stages ``<tag>.load``,
    ``<tag>.forward`` (ending in the readback) and ``<tag>.write``, the
    tag lower-cased."""
    timer = stage_timer()
    stage = tag.lower()
    with open_h5(out_h5_path, "w") as f:
        for s in range(0, len(image_paths), batch_size):
            paths = image_paths[s:s + batch_size]
            with timer.stage(f"{stage}.load"):
                imgs = np.stack([_resize_cv2_bilinear(load_image_rgb(p),
                                                      (target_hw[1],
                                                       target_hw[0]))
                                 for p in paths])
            with timer.stage(f"{stage}.forward"):
                feats = features(imgs).cpu().numpy()
            with timer.stage(f"{stage}.write"):
                for i, key in enumerate(image_keys[s:s + batch_size]):
                    write_dino_features(f, key, feats[i:i + 1])
            if progress:
                print(f"[{tag}] {s + len(paths)}/{len(image_paths)}",
                      flush=True)


def extract_dinov1_features_to_h5(image_paths: Sequence[str],
                                  image_keys: Sequence[str],
                                  out_h5_path: str, model, cfg,
                                  target_hw: Tuple[int, int],
                                  stride: int = 4, layer: int = 11,
                                  facet: str = "key", load_size: int = 224,
                                  binned: bool = False,
                                  upsample: bool = True,
                                  batch_size: int = 8,
                                  progress: bool = True) -> None:
    """DINOv1 dense features (:func:`dinov1_dense_features` of images
    resized to ``target_hw``) → h5 ``ift_dino`` entries."""
    _h5_features(image_paths, image_keys, out_h5_path, target_hw,
                 batch_size, progress, "dinoV1",
                 lambda imgs: dinov1_dense_features(
                     model, cfg, imgs, stride, layer, facet, load_size,
                     binned, upsample))


def dinonv_dense_features(model, cfg, images_u8: np.ndarray) -> torch.Tensor:
    """uint8 RGB [B, H, W, 3] → the VLAD-BuFF backbone's dense features
    [B, 768, dh, dw] (ImageNet-normalized, centre-cropped to multiples of
    14; token facet after the final norm, unnormalized) on ``model``'s
    device."""
    from revisit_anything_tpu_torch.training.vladbuff import (
        extract_dinonv_features)
    dev = next(model.parameters()).device
    x = torch.from_numpy(dn.preprocess(images_u8)).to(dev)
    with torch.inference_mode():
        return extract_dinonv_features(model, cfg, x).float()


def extract_dinonv_features_to_h5(image_paths: Sequence[str],
                                  image_keys: Sequence[str],
                                  out_h5_path: str, model, cfg,
                                  target_hw: Tuple[int, int],
                                  batch_size: int = 8,
                                  progress: bool = True) -> None:
    """SegVLAD-FineT dense backbone features (raw) → ``*_dinoNV_*.h5``
    with the ``ift_dino`` dataset name."""
    _h5_features(image_paths, image_keys, out_h5_path, target_hw,
                 batch_size, progress, "dinoNV",
                 lambda imgs: dinonv_dense_features(model, cfg, imgs))


def dinosalad_dense_features(model, cfg,
                             images_u8: np.ndarray) -> torch.Tensor:
    """As :func:`dinonv_dense_features` through the DINO-SALAD backbone,
    L2-normalized over channels."""
    return l2_normalize(dinonv_dense_features(model, cfg, images_u8), 1)


def extract_dinosalad_features_to_h5(image_paths: Sequence[str],
                                     image_keys: Sequence[str],
                                     out_h5_path: str, model, cfg,
                                     target_hw: Tuple[int, int],
                                     batch_size: int = 8,
                                     progress: bool = True) -> None:
    """DINO-SALAD dense backbone features (channel-L2-normalized) →
    ``*_dinoSALAD_*.h5``."""
    _h5_features(image_paths, image_keys, out_h5_path, target_hw,
                 batch_size, progress, "dinoSALAD",
                 lambda imgs: dinosalad_dense_features(model, cfg, imgs))
