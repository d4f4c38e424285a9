"""Model registry: build any model family by name, optionally from a
checkpoint.

Counterpart of ``revisit_anything_tpu/hub.py`` (``MODELS``,
``load_model`` :25-130). ``load_model`` returns ``(model, cfg,
forward)``, ``forward(model, inputs)`` being the model's primary
inference entry (run under ``torch.inference_mode``):

- ``sam_*``: automatic mask generation over one uint8 RGB image →
  records (kwarg ``amg``);
- ``dinov2_*``: the dense facet (kwargs ``layer``, default 31 for ViT-g
  and depth − 1 otherwise; ``facet``, default "value") of normalized
  [B, H, W, 3] images;
- ``dino_vit*`` (DINOv1): the dense facet at ``layer`` 11, ``facet``
  "key", ``stride`` 4 (the reference extractor's overlapping grid);
- ``vlad_buff``: the whole-image VLAD-BuFF descriptor (from a saved
  ``.npy`` tree, a VLAD-BuFF checkpoint, or seeded; kwargs ``clusters``,
  ``antiburst``, ``nv_pca``, ``nv_pca_mode``);
- ``dino_salad``: the whole-image DINO-SALAD descriptor.

Without ``checkpoint`` the weights are seeded random (``seed``). The
models live on ``device`` (default the card) in ``dtype``: by default
f32, the JAX package's, for every family (SAM's kernels on the default
decoder path are built for f32 and for bf16; ``dtype=torch.bfloat16``
takes the bf16 ones).
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

MODELS = (
    "sam_vit_h", "sam_vit_l", "sam_vit_b",
    "dinov2_vitg14", "dinov2_vitl14", "dinov2_vitb14", "dinov2_vits14",
    "dino_vits8", "dino_vits16", "dino_vitb8", "dino_vitb16",
    "vlad_buff", "dino_salad",
)


def _inference(fn: Callable) -> Callable:
    def forward(model, inputs):
        with torch.inference_mode():
            return fn(model, inputs)
    return forward


def load_model(name: str, checkpoint: Optional[str] = None, seed: int = 0,
               device="cuda", dtype=None, **kwargs
               ) -> Tuple[Any, Any, Callable]:
    """Build model ``name`` (one of :data:`MODELS`); raises ``KeyError``
    for an unknown name. Returns (model, cfg, forward)."""
    if name not in MODELS:
        raise KeyError(f"unknown model {name!r}; known: {MODELS}")
    gen = torch.Generator(device=device).manual_seed(seed)
    f32 = torch.float32 if dtype is None else dtype

    if name.startswith("sam_"):
        from revisit_anything_tpu_torch.models.sam import (SAM_VIT_B,
                                                           SAM_VIT_H,
                                                           SAM_VIT_L)
        from revisit_anything_tpu_torch.models.sam.amg import (
            AmgConfig, generate_masks)
        from revisit_anything_tpu_torch.models.sam.convert import (
            load_sam_checkpoint)
        from revisit_anything_tpu_torch.weights import init_sam
        cfg = {"sam_vit_h": SAM_VIT_H, "sam_vit_l": SAM_VIT_L,
               "sam_vit_b": SAM_VIT_B}[name]
        model = (load_sam_checkpoint(checkpoint, cfg, dtype=f32, device=device)
                 if checkpoint else init_sam(cfg, gen, device, f32))
        amg = kwargs.get("amg", AmgConfig())
        return model, cfg, _inference(
            lambda m, image: generate_masks(m, image, amg))

    if name.startswith("dinov2_"):
        from revisit_anything_tpu_torch.models import dinov2 as dn
        from revisit_anything_tpu_torch.weights import init_dino
        cfg = dn.CONFIGS[name]
        model = (dn.load_checkpoint(checkpoint, cfg, dtype=f32, device=device)
                 if checkpoint else init_dino(cfg, gen, device, f32))
        layer = kwargs.get("layer", 31 if "vitg" in name else cfg.depth - 1)
        facet = kwargs.get("facet", "value")
        return model, cfg, _inference(
            lambda m, images: dn.extract_dense(m, cfg, images, layer, facet))

    if name.startswith("dino_vit"):
        from revisit_anything_tpu_torch.models import dinov1 as d1
        from revisit_anything_tpu_torch.weights import init_dino
        cfg = d1.CONFIGS[name]
        model = (d1.load_checkpoint(checkpoint, cfg, dtype=f32, device=device)
                 if checkpoint else init_dino(cfg, gen, device, f32))
        layer = kwargs.get("layer", 11)
        facet = kwargs.get("facet", "key")
        stride = kwargs.get("stride", 4)
        return model, cfg, _inference(
            lambda m, images: d1.extract_dense(m, cfg, images, layer, facet,
                                               stride))

    from revisit_anything_tpu_torch.models import dinov2 as dn
    from revisit_anything_tpu_torch.training import aggregators as ag
    from revisit_anything_tpu_torch.training import vladbuff as vb
    from revisit_anything_tpu_torch.training.train import VPRModel
    from revisit_anything_tpu_torch.weights import init_dino
    cfg = dn.VIT_B14
    if name == "vlad_buff":
        if checkpoint and checkpoint.endswith(".npy"):
            # a saved tree (possibly WPCA-baked), either package's
            model = vb.load_vladbuff_params(checkpoint, cfg, dtype=f32,
                                            device=device)
        elif checkpoint:
            model = vb.load_vladbuff_checkpoint(checkpoint, cfg, dtype=f32,
                                                device=device)
        else:
            model = VPRModel(init_dino(cfg, gen, device, f32), ag.netvlad_init(
                gen, cfg.embed_dim, kwargs.get("clusters", 64),
                kwargs.get("antiburst", True), nv_pca=kwargs.get("nv_pca"),
                nv_pca_mode=kwargs.get("nv_pca_mode", "rot"), device=device))
        return model, cfg, _inference(
            lambda m, images: vb.global_descriptor(m, cfg, images))

    model = (vb.load_dinosalad_checkpoint(checkpoint, cfg, dtype=f32,
                                          device=device) if checkpoint
             else VPRModel(init_dino(cfg, gen, device, f32),
                           ag.salad_init(gen, cfg.embed_dim, device=device)))
    return model, cfg, _inference(
        lambda m, images: vb.salad_global_descriptor(m, cfg, images))
