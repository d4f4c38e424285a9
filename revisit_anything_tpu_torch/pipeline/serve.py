"""Online serving: raw query image → top-k database images, on one device.

Counterpart of ``revisit_anything_tpu/pipeline/serve.py``:
``ServingIndex`` (+``from_npz``), ``SegVLADServer.__init__``, ``query``
(:555) and ``query_many``, with the device stages
``_sam_preprocess_fused`` (:141), ``_select_masks_centroids`` (:170),
``_dino_desc_device`` (:210) and the host ``_adjacency`` (:517).

Per query: one uint8 upload; SAM preprocess → encode → AMG decode batches
→ thresholds/NMS/top-``kmax`` select → mask→patch pooling, and the DINO
dense features, all on the device; one small readback (centroids) for the
host Qhull Delaunay adjacency; the retrieval tail on the device; one
readback of the top ids. The query path's constants (normalization,
rel-pos indices, resize matrices, DINOv2's resized position table) are
built on the device once, so the image and the adjacency are the only
host→device copies of a query. Single device; the database is static
(no incremental inserts in this slice).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from revisit_anything_tpu_torch.config import RECALL_TOPK
from revisit_anything_tpu_torch.models import dinov2 as dn
from revisit_anything_tpu_torch.models.layers import device_constant
from revisit_anything_tpu_torch.models.sam import (SAM_PIXEL_MEAN,
                                                   SAM_PIXEL_STD, Sam)
from revisit_anything_tpu_torch.models.sam.amg import (
    AmgConfig, _decode_batch, build_point_grid, resize_longest_side)
from revisit_anything_tpu_torch.models.sam.prompt import (
    dense_positional_embedding)
from revisit_anything_tpu_torch.ops.adjacency import delaunay_adjacency
from revisit_anything_tpu_torch.ops.masks import (mask_pool_matrices,
                                                  pool_masks_to_patch_grid)
from revisit_anything_tpu_torch.ops.nms import nms_keep_mask
from revisit_anything_tpu_torch.ops.resize import bilinear_weight_matrix
from revisit_anything_tpu_torch.pipeline.query import (db_sq_norms,
                                                       query_topk_images)


def _sam_preprocess_fused(img_u8: torch.Tensor, rh: torch.Tensor,
                          rw: torch.Tensor, pad_to: int) -> torch.Tensor:
    """uint8 [H, W, 3] → [1, S, S, 3] normalized SAM input. rh/rw are the
    composed per-axis bilinear matrices (full → half res → S frame); the
    resized image is re-quantized to uint8 levels before normalizing."""
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


def _select_masks_centroids(masks: torch.Tensor, iou: torch.Tensor,
                            stab: torch.Tensor, boxes: torch.Tensor,
                            valid: torch.Tensor, amg: AmgConfig, kmax: int):
    """Filter + NMS + top-``kmax`` gather, keeping masks on the device.

    Returns (masks [kmax, h, w] bool in IoU-descending NMS-keep order,
    padding rows all-false; stats [2·kmax+1] f32 = centroid (x, y) pairs
    then the kept count — one array, one readback)."""
    keep = valid & (stab >= amg.stability_score_thresh)
    if amg.pred_iou_thresh > 0.0:
        keep = keep & (iou > amg.pred_iou_thresh)
    neg = float("-inf")
    scores = iou.masked_fill(~keep, neg)
    nms_keep = nms_keep_mask(boxes, scores, amg.box_nms_thresh)
    final_scores = iou.masked_fill(~(nms_keep & keep), neg)
    k_take = min(kmax, int(final_scores.shape[0]))
    order = torch.argsort(-final_scores, stable=True)[:k_take]
    n_kept = torch.clamp((final_scores > neg).sum(), max=k_take)

    sel = masks[order]
    if k_take < kmax:
        sel = torch.nn.functional.pad(sel, (0, 0, 0, 0, 0, kmax - k_take))
    row_valid = torch.arange(kmax, device=sel.device) < n_kept
    sel = sel & row_valid[:, None, None]

    h, w = sel.shape[1], sel.shape[2]
    m = sel.float()
    total = m.sum((1, 2))
    cy = torch.einsum("khw,h->k", m, torch.arange(h, device=m.device).float())
    cx = torch.einsum("khw,w->k", m, torch.arange(w, device=m.device).float())
    denom = total.clamp(min=1.0)
    cents = torch.stack([cx / denom, cy / denom], dim=1)
    stats = torch.cat([cents.reshape(-1), n_kept.reshape(1).float()])
    return sel, stats


def _dino_desc_device(model: dn.DinoV2, cfg: dn.DinoV2Config,
                      img_u8: torch.Tensor, layer: int,
                      crop: Tuple[int, int, int, int]) -> torch.Tensor:
    """uint8 [H, W, 3] → L2-normalized dense descriptors [P, D] f32
    (ImageNet normalize, centre crop to patch multiples, bf16 input)."""
    top, left, hn, wn = crop
    x = img_u8.float() / 255.0
    mean = device_constant(("imagenet_mean",), x.device,
                           lambda: dn.IMAGENET_MEAN)
    std = device_constant(("imagenet_std",), x.device, lambda: dn.IMAGENET_STD)
    x = (x - mean) / std
    x = x[top:top + hn, left:left + wn][None].to(torch.bfloat16)
    d = dn.extract_dense(model, cfg, x, layer)[0].float()
    return d / torch.linalg.vector_norm(d, dim=1, keepdim=True).clamp(
        min=1e-12)


@dataclasses.dataclass
class ServingIndex:
    """Prebuilt retrieval state. Arrays may be numpy or torch tensors
    (a tensor already on the serving device is used in place)."""
    centers: object                # [C, D] VLAD vocabulary
    pca_mean: object               # [C·D]
    pca_components: object         # [pca_dim, C·D]
    pca_variance: object           # [pca_dim]
    pca_whiten: bool
    db: object                     # [Nd, pca_dim] normalized db segments
    db_image_ids: object           # [Nd]
    num_ref_images: int
    order: int = 3
    db_dtype: str = "float32"

    @classmethod
    def from_npz(cls, path) -> "ServingIndex":
        """Load the build-index npz (a path or an opened np.load)."""
        z = path if hasattr(path, "files") else np.load(path)
        ids = z["db_image_ids"]
        if "num_ref_images" in z:
            n_ref = int(z["num_ref_images"])
        else:
            n_ref = int(ids.max()) + 1 if len(ids) else 0
        return cls(centers=z["centers"], pca_mean=z["pca_mean"],
                   pca_components=z["pca_components"],
                   pca_variance=z["pca_variance"],
                   pca_whiten=bool(z["pca_whiten"]), db=z["db"],
                   db_image_ids=ids, num_ref_images=n_ref,
                   order=int(z["order"]),
                   db_dtype=(str(z["db_dtype"]) if "db_dtype" in z
                             else "float32"))


def _to_device(x, device, dtype=None) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    return t.to(device=device, dtype=dtype)


class SegVLADServer:
    """Persistent online-query server for one (models, index) pair on one
    device.

    Args:
      sam, dino: the port's models (``Sam``, ``DinoV2``) on the serving
        device.
      full_hw: the dataset's query resolution (queries arrive at it).
      sam_hw: SAM extraction resolution (half of full_hw in the reference
        datasets).
      max_masks: static mask capacity; masks beyond it (post-NMS,
        IoU-descending) are dropped.
    """

    def __init__(self, *, sam: Sam, dino: dn.DinoV2, index: ServingIndex,
                 full_hw: Tuple[int, int], sam_hw: Tuple[int, int],
                 amg: Optional[AmgConfig] = None, dino_layer: int = 31,
                 max_masks: int = 128, top_images: int = RECALL_TOPK):
        self.sam = sam
        self.sam_cfg = sam.cfg
        self.dino = dino
        self.dino_cfg = dino.cfg
        self.device = sam.encoder.pos_embed.device
        dev = self.device
        self.amg = amg or AmgConfig()
        self.full_hw = tuple(full_hw)
        self.sam_hw = tuple(sam_hw)
        self.dino_layer = dino_layer
        self.kmax = max_masks
        self.top_images = top_images
        self.order = index.order
        self.num_ref_images = int(index.num_ref_images)

        fh, fw = self.full_hw
        sh, sw = self.sam_hw
        s = self.sam_cfg.image_size
        self.input_hw = resize_longest_side(sh, sw, s)
        # composed resize matrices: full res → SAM half res → S frame
        rh = (bilinear_weight_matrix(self.input_hw[0], sh)
              @ bilinear_weight_matrix(sh, fh))
        rw = (bilinear_weight_matrix(self.input_hw[1], sw)
              @ bilinear_weight_matrix(sw, fw))
        self._rh = torch.from_numpy(rh).to(dev)
        self._rw = torch.from_numpy(rw).to(dev)

        hn, wn = (fh // 14) * 14, (fw // 14) * 14
        top, left = dn.center_crop_offsets(fh, fw, hn, wn)
        self._crop = (top, left, hn, wn)

        # AMG point grid in the S frame (apply_coords scaling), padded to
        # whole batches; padding prompts are invalid candidates
        grid = build_point_grid(self.amg.points_per_side)
        pts = grid * np.array([sw, sh], np.float32)
        pts = (pts * np.array([self.input_hw[1] / sw, self.input_hw[0] / sh],
                              np.float32)).astype(np.float32)
        bsz = self.amg.points_per_batch
        pad = (-len(pts)) % bsz
        n_pts = len(pts)
        if pad:
            pts = np.concatenate([pts, np.zeros((pad, 2), np.float32)])
        self._pts = torch.from_numpy(pts).to(dev)
        self._valid = torch.from_numpy(np.repeat(np.concatenate(
            [np.ones(n_pts, bool), np.zeros(pad, bool)]), 3)).to(dev)
        self._bsz = bsz

        pool_a, pool_b = mask_pool_matrices(self.sam_hw, self.full_hw)
        self._pool_a = torch.from_numpy(pool_a).to(dev)
        self._pool_b = torch.from_numpy(pool_b).to(dev)

        f32 = torch.float32
        self._centers = _to_device(index.centers, dev, f32)
        self._pca_mean = _to_device(index.pca_mean, dev, f32)
        self._pca_comps = _to_device(index.pca_components, dev, f32)
        self._pca_var = _to_device(index.pca_variance, dev, f32)
        self._whiten = bool(index.pca_whiten)
        self._db = _to_device(index.db, dev, getattr(torch, index.db_dtype))
        self._db_ids = _to_device(index.db_image_ids, dev, torch.int64)
        self._db_norms = db_sq_norms(self._db)

        with torch.inference_mode():
            self._image_pe = dense_positional_embedding(
                sam.prompt, self.sam_cfg)[0]

    # ----- device stages -----

    def _amg_device(self, img_dev: torch.Tensor):
        """Image → (masks [kmax, sh, sw] bool, stats [2·kmax+1])."""
        batched = _sam_preprocess_fused(img_dev, self._rh, self._rw,
                                        self.sam_cfg.image_size)
        emb = self.sam.encoder(batched)[0]
        outs = [_decode_batch(self.sam, self.sam_cfg, emb, self._image_pe,
                              self._pts[s:s + self._bsz], self.input_hw,
                              self.sam_hw, self.amg)
                for s in range(0, self._pts.shape[0], self._bsz)]
        masks, iou, stab, boxes = (torch.cat(t) for t in zip(*outs))
        return _select_masks_centroids(masks, iou, stab, boxes, self._valid,
                                       self.amg, self.kmax)

    def _front(self, img_dev: torch.Tensor):
        """(patch_masks [kmax, P] bool, stats, desc [P, D] f32)."""
        masks, stats = self._amg_device(img_dev)
        pm = pool_masks_to_patch_grid(masks, self._pool_a, self._pool_b)
        desc = _dino_desc_device(self.dino, self.dino_cfg, img_dev,
                                 self.dino_layer, self._crop)
        return pm, stats, desc

    def _adjacency(self, stats_np: np.ndarray) -> Tuple[np.ndarray, int]:
        n = int(stats_np[-1])
        adj = np.zeros((self.kmax, self.kmax), dtype=bool)
        if n > 0 and self.order > 0:
            cents = stats_np[:2 * self.kmax].reshape(self.kmax, 2)[:n]
            adj[:n, :n] = delaunay_adjacency(cents.astype(np.float64),
                                             self.order)
        elif n > 0:
            adj[:n, :n] = np.eye(n, dtype=bool)
        return adj, n

    # ----- public API -----

    def query(self, img_uint8: np.ndarray) -> np.ndarray:
        """One query image (uint8 RGB at full_hw) → top image ids."""
        if tuple(img_uint8.shape[:2]) != self.full_hw:
            raise ValueError(f"expected {self.full_hw}, got "
                             f"{img_uint8.shape[:2]}: resize on the host "
                             "first")
        with torch.inference_mode():
            img_dev = torch.from_numpy(np.ascontiguousarray(img_uint8)).to(
                self.device)
            patch_masks, stats, desc = self._front(img_dev)
            adj, _ = self._adjacency(stats.cpu().numpy())
            top = query_topk_images(
                desc, patch_masks, torch.from_numpy(adj).to(self.device),
                self._centers, self._pca_mean, self._pca_comps,
                self._pca_var, self._db, self._db_ids,
                num_ref_images=self.num_ref_images,
                top_images=self.top_images, whiten=self._whiten,
                db_norms=self._db_norms)
            return top.cpu().numpy()

    def query_many(self, imgs: Sequence[np.ndarray]) -> List[np.ndarray]:
        """Queries in order. One CUDA stream serializes the device work,
        so they run one after another."""
        return [self.query(img) for img in imgs]
