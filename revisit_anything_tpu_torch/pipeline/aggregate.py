"""Segment-VLAD aggregation: mask and feature artifacts → one
[n_segments, C·D] descriptor bank; and AnyLoc's whole-image VLADs.

Counterpart of ``revisit_anything_tpu/pipeline/aggregate.py``
(``SegmentBank``, ``image_segment_vlad``, ``compute_segment_vlads``,
``global_vlads_from_h5``). The JAX package pads each image's mask count
to a bucket (``MASK_BUCKETS``) so XLA compiles once per bucket; the
padding rows give zero VLADs that it slices off, so the port runs at
the true count. The Delaunay adjacency stays on the host.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from revisit_anything_tpu_torch.io.h5io import (open_h5, read_all_masks_bool,
                                                read_dino_features)
from revisit_anything_tpu_torch.ops.adjacency import delaunay_adjacency
from revisit_anything_tpu_torch.ops.knn import f32_products
from revisit_anything_tpu_torch.ops.masks import (mask_centroids,
                                                  mask_pool_matrices,
                                                  pool_masks_to_patch_grid)
from revisit_anything_tpu_torch.ops.vlad import (global_vlad, l2_normalize,
                                                 segment_vlad)
from revisit_anything_tpu_torch.utils.profiling import stage_timer


@dataclasses.dataclass
class SegmentBank:
    """Flat segment-descriptor table over an image set."""
    descriptors: np.ndarray           # [n_segments, dim]
    image_indices: np.ndarray         # [n_segments] image id per segment
    # trailing images without segments never appear in image_indices;
    # their recall rows must still exist (as misses)
    num_images: Optional[int] = None

    @property
    def seg_ranges(self) -> List[np.ndarray]:
        derived = (int(self.image_indices.max()) + 1
                   if len(self.image_indices) else 0)
        n_img = self.num_images if self.num_images is not None else derived
        return [np.where(self.image_indices == i)[0] for i in range(n_img)]


def _desc(feats: np.ndarray, device) -> torch.Tensor:
    """[D, dh, dw] features → [dh·dw, D] f32 on ``device``, L2-normalized
    over D (the reference normalizes on every load; raw dinoNV files need
    it, the DINOv2 files are normalized already)."""
    d = feats.shape[0]
    t = torch.as_tensor(feats.reshape(d, -1).T, device=device)
    return l2_normalize(t.float(), 1)


def image_segment_vlad(masks: np.ndarray, feats: np.ndarray,
                       centers: np.ndarray, pool_a: np.ndarray,
                       pool_b: np.ndarray, order: int,
                       device="cuda") -> np.ndarray:
    """Segment VLADs [M, C·D] f32 of one image.

    masks [M, h, w] bool at the stored resolution; feats [D, dh, dw]
    dense features (the h5 layout); centers [C, D]; pool_a / pool_b from
    ``mask_pool_matrices``; order: SuperSegment order (0: no
    adjacency)."""
    m = len(masks)
    if m == 0:
        return np.zeros((0, centers.shape[0] * feats.shape[0]), np.float32)
    as_t = functools.partial(torch.as_tensor, device=device)
    with f32_products():
        patch_masks = pool_masks_to_patch_grid(as_t(masks), as_t(pool_a),
                                               as_t(pool_b))
        adj = None
        if order:
            adj = as_t(delaunay_adjacency(mask_centroids(masks), order))
        vlads = segment_vlad(_desc(feats, device), as_t(centers).float(),
                             patch_masks, adj)
    return vlads.cpu().numpy()


def compute_segment_vlads(masks_h5_path: str, dino_h5_path: str,
                          image_keys: Sequence[str], centers: np.ndarray,
                          order: int, mask_hw: Tuple[int, int],
                          desired_hw: Tuple[int, int], progress: bool = True,
                          device="cuda") -> SegmentBank:
    """Every image's segment VLADs from the mask and feature h5 files, in
    ``image_keys`` order; stages ``agg.read`` and ``agg.vlad``."""
    timer = stage_timer()
    pool_a, pool_b = mask_pool_matrices(mask_hw, desired_hw)
    descs, im_inds = [], []
    with open_h5(masks_h5_path) as mh5, open_h5(dino_h5_path) as dh5:
        for i, key in enumerate(image_keys):
            with timer.stage("agg.read"):
                masks = read_all_masks_bool(mh5, key)
                feats = read_dino_features(dh5, key)[0]  # [D, dh, dw]
            with timer.stage("agg.vlad"):
                v = image_segment_vlad(masks, feats, centers, pool_a,
                                       pool_b, order, device)
            descs.append(v)
            im_inds.extend([i] * len(v))
            if progress and (i + 1) % 50 == 0:
                print(f"[segvlad] {i + 1}/{len(image_keys)}", flush=True)
    if not descs:
        return SegmentBank(np.zeros((0, 0), np.float32),
                           np.zeros((0,), np.int64),
                           num_images=len(image_keys))
    return SegmentBank(np.concatenate(descs).astype(np.float32),
                       np.asarray(im_inds, dtype=np.int64),
                       num_images=len(image_keys))


def image_global_vlad(feats: np.ndarray, centers: np.ndarray,
                      device="cuda") -> np.ndarray:
    """AnyLoc's whole-image VLAD [C·D] of one image's [D, dh, dw]
    features, over the raw patch grid (the reference's upsampling in
    this branch is commented out)."""
    with f32_products():
        v = global_vlad(_desc(feats, device),
                        torch.as_tensor(centers, device=device))
    return v.cpu().numpy()


def global_vlads_from_h5(dino_h5_path: str, image_keys: Sequence[str],
                         centers: np.ndarray,
                         device="cuda") -> np.ndarray:
    """[N, C·D] AnyLoc VLADs of the images of a feature h5 file."""
    with open_h5(dino_h5_path) as f:
        return np.stack([image_global_vlad(read_dino_features(f, key)[0],
                                           centers, device)
                         for key in image_keys])
