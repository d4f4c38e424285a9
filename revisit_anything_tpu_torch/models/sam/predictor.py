"""Interactive SAM predictor: encode an image once, then decode any point,
box or mask prompt against it (counterpart of
``revisit_anything_tpu/models/sam/predictor.py``, SamPredictor,
predictor.py:17-269).

``set_image`` runs the encoder on ``sam``'s device (kernel K1 in its
global layers, B11 in its windowed ones when the encoder is built with
``window_attention="kernel"``); ``predict`` runs the decoder's general
path (``decode_masks(dense_shared=False)``) and resizes its low-res
logits to the image by two f32 products, TF32 off.
Prompts are in the image's coordinates.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from revisit_anything_tpu_torch.models.sam.amg import _preprocess_any
from revisit_anything_tpu_torch.models.sam.decoder import decode_masks
from revisit_anything_tpu_torch.models.sam.prompt import (
    dense_positional_embedding, embed_boxes, embed_masks, embed_points,
    no_mask_dense_embedding)
from revisit_anything_tpu_torch.ops.knn import f32_products
from revisit_anything_tpu_torch.ops.resize import bilinear_weight_matrix


class SamPredictor:
    """Encode once, prompt many times, on ``sam``'s device."""

    def __init__(self, sam):
        self.sam = sam
        self.cfg = sam.cfg
        self.device = sam.encoder.pos_embed.device
        self._embedding = None
        self._input_hw = None
        self._orig_hw = None

    def set_image(self, image_rgb: np.ndarray) -> None:
        """Encode a uint8 RGB image [H, W, 3] (predictor.py set_image
        :34-83) and build its low-res → image resize matrices."""
        cfg = self.cfg
        self._orig_hw = image_rgb.shape[:2]
        with torch.inference_mode():
            batched, self._input_hw = _preprocess_any(image_rgb, cfg,
                                                      self.device)
            self._embedding = self.sam.encoder(batched)[0]
        up = bilinear_weight_matrix(cfg.image_size, cfg.lowres_size)
        (h, w), (ih, iw) = self._orig_hw, self._input_hw
        self._wh = torch.from_numpy(
            bilinear_weight_matrix(h, ih) @ up[:ih]).to(self.device)
        self._ww = torch.from_numpy(
            bilinear_weight_matrix(w, iw) @ up[:iw]).to(self.device)

    @property
    def is_image_set(self) -> bool:
        return self._embedding is not None

    def get_image_embedding(self) -> torch.Tensor:
        """The image embedding [g, g, D] of the last ``set_image``."""
        assert self.is_image_set, "call set_image first"
        return self._embedding

    def _scale(self) -> np.ndarray:
        h, w = self._orig_hw
        return np.array([self._input_hw[1] / w, self._input_hw[0] / h],
                        np.float32)

    def predict(self,
                point_coords: Optional[np.ndarray] = None,
                point_labels: Optional[np.ndarray] = None,
                box: Optional[np.ndarray] = None,
                mask_input: Optional[np.ndarray] = None,
                multimask_output: bool = True,
                return_logits: bool = False
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Masks for ONE prompt set (predictor.py predict :85-166).

        point_coords [N, 2] (x, y) and point_labels [N] (1 foreground, 0
        background); box [4] XYXY; mask_input [1, 4g, 4g] low-res logits
        of an earlier round. Returns (masks [M, H, W] bool, or f32 logits
        with ``return_logits``; iou [M]; low-res logits [M, 4g, 4g]), M 3
        with ``multimask_output``, else 1."""
        assert self.is_image_set, "call set_image first"
        cfg, sam, dev = self.cfg, self.sam, self.device
        scale = self._scale()
        with torch.inference_mode():
            parts = []
            if point_coords is not None:
                assert point_labels is not None, (
                    "point_labels must be supplied if point_coords is "
                    "supplied.")
                pts = np.asarray(point_coords, np.float32) * scale
                labels = np.asarray(point_labels, np.int32)
                parts.append(embed_points(
                    sam.prompt, cfg, torch.from_numpy(pts[None]).to(dev),
                    torch.from_numpy(labels[None]).to(dev),
                    pad=box is None)[0])
            if box is not None:
                b = np.asarray(box, np.float32).reshape(2, 2) * scale
                parts.append(embed_boxes(
                    sam.prompt, cfg,
                    torch.from_numpy(b.reshape(1, 1, 4)).to(dev))[0])
            if not parts:
                raise ValueError("provide point_coords and/or box")
            sparse = torch.cat(parts)[None]
            if mask_input is not None:
                dense = embed_masks(sam.prompt, cfg, torch.from_numpy(
                    np.asarray(mask_input, np.float32)).to(dev))
            else:
                dense = no_mask_dense_embedding(sam.prompt, cfg, 1)
            pe = dense_positional_embedding(sam.prompt, cfg)[0]
            lowres, iou = decode_masks(
                sam.decoder, cfg, self._embedding, pe, sparse, dense,
                multimask=multimask_output, dense_shared=False)
            lowres = lowres[0]                            # [M, 4g, 4g]
            with f32_products():
                m = torch.einsum("oh,nhw->now", self._wh, lowres)
                m = torch.einsum("pw,now->nop", self._ww, m)
            if not return_logits:
                m = m > cfg.mask_threshold
            return (m.cpu().numpy(), iou[0].float().cpu().numpy(),
                    lowres.cpu().numpy())
