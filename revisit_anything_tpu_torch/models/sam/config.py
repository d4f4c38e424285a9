"""SAM architecture configuration (copy of the JAX package's
``models/sam/config.py``).

vit_h 1280/32/16 global@[7,15,23,31]; vit_l 1024/24/16 global@[5,11,17,23];
vit_b 768/12/12 global@[2,5,8,11]; prompt dim 256, image 1024, patch 16,
window 14.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class SamArchConfig:
    encoder_dim: int
    encoder_depth: int
    encoder_heads: int
    global_attn_indexes: Tuple[int, ...]
    image_size: int = 1024
    patch_size: int = 16
    window_size: int = 14
    mlp_ratio: float = 4.0
    prompt_dim: int = 256
    num_multimask_outputs: int = 3
    decoder_depth: int = 2
    decoder_heads: int = 8
    decoder_mlp_dim: int = 2048
    iou_head_hidden: int = 256
    iou_head_depth: int = 3
    eps: float = 1e-6
    mask_threshold: float = 0.0

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size      # 64

    @property
    def head_dim(self) -> int:
        return self.encoder_dim // self.encoder_heads

    @property
    def num_mask_tokens(self) -> int:
        return self.num_multimask_outputs + 1

    @property
    def lowres_size(self) -> int:
        return self.grid * 4                            # 256


SAM_VIT_H = SamArchConfig(1280, 32, 16, (7, 15, 23, 31))
SAM_VIT_L = SamArchConfig(1024, 24, 16, (5, 11, 17, 23))
SAM_VIT_B = SamArchConfig(768, 12, 12, (2, 5, 8, 11))

SAM_REGISTRY = {"vit_h": SAM_VIT_H, "vit_l": SAM_VIT_L, "vit_b": SAM_VIT_B,
                "default": SAM_VIT_H}

# Pixel normalization in 0-255 space (Sam.preprocess).
SAM_PIXEL_MEAN = (123.675, 116.28, 103.53)
SAM_PIXEL_STD = (58.395, 57.12, 57.375)
