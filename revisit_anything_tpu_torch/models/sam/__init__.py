"""SAM (image encoder, prompt encoder, mask decoder, AMG) in PyTorch."""

from torch import nn

from revisit_anything_tpu_torch.models.sam.config import (  # noqa: F401
    SAM_PIXEL_MEAN, SAM_PIXEL_STD, SAM_REGISTRY, SAM_VIT_B, SAM_VIT_H,
    SAM_VIT_L, SamArchConfig)
from revisit_anything_tpu_torch.models.sam.decoder import MaskDecoder
from revisit_anything_tpu_torch.models.sam.encoder import ImageEncoder
from revisit_anything_tpu_torch.models.sam.prompt import PromptEncoder


class Sam(nn.Module):
    """The three SAM modules under the JAX parameter tree's top-level
    names (``encoder``, ``prompt``, ``decoder``); ``dense_pe`` as in
    :class:`PromptEncoder`."""

    def __init__(self, cfg: SamArchConfig, *, dtype, device="cuda",
                 dense_pe: bool = False):
        super().__init__()
        self.cfg = cfg
        self.encoder = ImageEncoder(cfg, dtype=dtype, device=device)
        self.prompt = PromptEncoder(cfg, dtype=dtype, device=device,
                                    dense_pe=dense_pe)
        self.decoder = MaskDecoder(cfg, dtype=dtype, device=device)
