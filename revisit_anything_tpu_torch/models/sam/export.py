"""A serialized SAM decoder for serving: the ONNX-export equivalent
(sam/segment_anything/utils/onnx.py) on ``torch.export``. Counterpart of
``revisit_anything_tpu/models/sam/export.py``: ``make_decode_fn`` :25,
``export_decoder`` :44, ``load_decoder`` :65.

The exported function is (image embedding [g, g, D] f32, point prompts
[Np, 2] f32 in SAM's resized frame) → (low-res logits [Np, M, 4g, 4g]
f32, IoU [Np, M]) for a fixed Np: the decoder's general path
(``decode_masks(dense_shared=False)``), plain PyTorch, with the prompt
encoder's and the decoder's weights baked into the ``.pt2`` file. As in the JAX export, no hand-written kernel is in it
(a ctypes launch cannot be traced).
"""

from __future__ import annotations

import torch
from torch import nn

from revisit_anything_tpu_torch.models.sam.decoder import decode_masks
from revisit_anything_tpu_torch.models.sam.prompt import (
    dense_positional_embedding, embed_points, no_mask_dense_embedding)


class _DecodeFn(nn.Module):
    """(image_embedding, points) → (masks, iou) for ``num_prompts`` single
    positive points, each with SAM's padding point and the no-mask dense
    embedding. Its constants (the dense PE, the labels) are buffers,
    built here, outside the traced function."""

    def __init__(self, sam, num_prompts: int, multimask: bool = True):
        super().__init__()
        self.cfg = sam.cfg
        self.num_prompts = num_prompts
        self.multimask = multimask
        self.prompt = sam.prompt
        self.decoder = sam.decoder
        dev = sam.prompt.no_mask.device
        with torch.no_grad():
            self.register_buffer("image_pe", dense_positional_embedding(
                sam.prompt, sam.cfg)[0].clone())
        self.register_buffer("labels", torch.ones(
            (num_prompts, 1), dtype=torch.int32, device=dev))

    def forward(self, image_embedding: torch.Tensor, points: torch.Tensor):
        sparse = embed_points(self.prompt, self.cfg, points[:, None, :],
                              self.labels, pad=True)
        dense = no_mask_dense_embedding(self.prompt, self.cfg,
                                        self.num_prompts)
        return decode_masks(self.decoder, self.cfg, image_embedding,
                            self.image_pe, sparse, dense,
                            multimask=self.multimask, dense_shared=False)


def make_decode_fn(sam, num_prompts: int, multimask: bool = True
                   ) -> nn.Module:
    """The eager function that :func:`export_decoder` traces: (image
    embedding [g, g, D], points [num_prompts, 2]) → (masks, iou)."""
    return _DecodeFn(sam, num_prompts, multimask)


def export_decoder(sam, path: str, num_prompts: int = 256,
                   multimask: bool = True) -> None:
    """Trace :func:`make_decode_fn` on ``sam``'s device with
    ``torch.export.export`` at ``num_prompts`` prompts and save it, its
    weights included, with ``torch.export.save`` (a ``.pt2`` file)."""
    fn = make_decode_fn(sam, num_prompts, multimask).eval()
    cfg = sam.cfg
    dev = fn.labels.device
    args = (torch.zeros((cfg.grid, cfg.grid, cfg.prompt_dim),
                        dtype=torch.float32, device=dev),
            torch.zeros((num_prompts, 2), dtype=torch.float32, device=dev))
    with torch.no_grad():
        exported = torch.export.export(fn, args, strict=False)
    torch.export.save(exported, path)


def load_decoder(path: str):
    """An exported decoder as a callable (image_embedding, points) →
    (masks, iou), on the device it was exported on."""
    return torch.export.load(path).module()
