"""Weights: conversion from the JAX package's parameter trees and seeded
random initialization directly on the device.

The port's modules keep the JAX tree's names and layouts
(``models/sam/params.py``, ``models/dinov2._init_params``): a dense
weight is ``w`` [in, out] with bias ``b``, LayerNorms hold ``scale`` and
``bias``, lists are ``nn.ModuleList``s. So a JAX tree (as numpy arrays)
loads leaf for leaf with :func:`load_tree`: SAM, DINOv2 and DINOv1
(``dino_from_jax_params``), the CosPlace ViT, ResNet, any aggregator
(``training.aggregators.from_jax_tree``) and the VLAD-BuFF / SALAD
``{"backbone", "aggregator", "wpca"?}`` trees (:func:`vpr_from_jax_params`).
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from revisit_anything_tpu_torch.models.cosplace_vit import (CosPlaceViT,
                                                           HfViTConfig)
from revisit_anything_tpu_torch.models.dinov2 import DinoV2, DinoV2Config
from revisit_anything_tpu_torch.models.layers import load_tree, tree_module
from revisit_anything_tpu_torch.models.resnet import ResNet, ResNetConfig
from revisit_anything_tpu_torch.models.sam import Sam, SamArchConfig
from revisit_anything_tpu_torch.models.sam.prompt import (
    dense_positional_embedding)
from revisit_anything_tpu_torch.training.train import VPRModel


def sam_from_jax_params(tree, cfg: SamArchConfig, *,
                        dtype=torch.float32, device="cuda") -> Sam:
    """The port's Sam from a JAX SAM parameter tree (numpy leaves). A
    tree with a separate dense-PE Fourier matrix (``pe_gaussian_dense``,
    the HuggingFace layout's) keeps it."""
    sam = Sam(cfg, dtype=dtype, device=device,
              dense_pe="pe_gaussian_dense" in tree["prompt"])
    load_tree(sam, tree)
    return sam


def dino_from_jax_params(tree, cfg: DinoV2Config, *,
                         dtype=torch.float32, device="cuda") -> DinoV2:
    """The port's DinoV2 from a JAX DINOv2 parameter tree."""
    dino = DinoV2(cfg, dtype=dtype, device=device)
    load_tree(dino, tree)
    return dino


def cosplace_from_jax_params(tree, cfg: HfViTConfig, *,
                             dtype=torch.float32,
                             device="cuda") -> CosPlaceViT:
    """The port's CosPlace ViT from a JAX ``cosplace_vit`` tree."""
    model = CosPlaceViT(cfg, dtype=dtype, device=device)
    load_tree(model, tree)
    return model


def resnet_from_jax_params(tree, cfg: ResNetConfig, *, dtype=torch.float32,
                           device="cuda") -> ResNet:
    """The port's ResNet from a JAX ``resnet`` tree (folded batch
    norms)."""
    model = ResNet(cfg, dtype=dtype, device=device)
    load_tree(model, tree)
    return model


def vpr_from_jax_params(tree, cfg: DinoV2Config, *, dtype=torch.float32,
                        device="cuda") -> VPRModel:
    """A VLAD-BuFF or DINO-SALAD ``{"backbone", "aggregator", "wpca"?}``
    tree (numpy leaves) → ``VPRModel`` on ``device``, layer scale as the
    backbone tree has it."""
    has_ls = tree["backbone"]["blocks"][0].get("ls1") is not None
    backbone = dino_from_jax_params(
        tree["backbone"], dataclasses.replace(cfg, layerscale=has_ls),
        dtype=dtype, device=device)
    model = VPRModel(backbone, tree_module(tree["aggregator"],
                                           device=device))
    if tree.get("wpca") is not None:
        model.add_module("wpca", tree_module(tree["wpca"], device=device))
    return model


def _fill(module: nn.Module, generator: torch.Generator,
          normal_std, skip: str = None) -> None:
    """Initialize every parameter (but those under the prefix ``skip``):
    ``normal_std(name, param)`` returns the std of a N(0, std²) init,
    0.0 for zeros or None for ones."""
    for name, p in module.named_parameters():
        if skip is not None and name.startswith(skip):
            continue
        std = normal_std(name, p)
        with torch.no_grad():
            if std is None:
                p.fill_(1.0)
            elif std == 0.0:
                p.zero_()
            else:
                p.copy_(torch.randn(p.shape, generator=generator,
                                    device=p.device) * std)


def _is_ln(name: str) -> bool:
    parts = name.split(".")
    return len(parts) >= 2 and parts[-2].startswith(("norm", "ln", "up_ln"))


def init_sam(cfg: SamArchConfig, generator: torch.Generator,
             device="cuda", dtype=torch.bfloat16) -> Sam:
    """Random SAM weights with the JAX init's layout and scales
    (``models/sam/params.py``): dense weights N(0, 0.02²), biases 0,
    LayerNorms (1, 0), pe_gaussian N(0, 1). The rel-pos tables, zero in
    the JAX init, get N(0, 0.02²) so the served path exercises the bias.
    The mask-prompt stack (convolutions N(0, 0.2²), N(0, 0.1²),
    N(0, 0.05²)) draws from its own generator, seeded from
    ``generator``'s seed, so the other weights, and what the caller
    draws from ``generator`` next, are those of a SAM without it."""
    sam = Sam(cfg, dtype=dtype, device=device)

    def std(name, p):
        leaf = name.split(".")[-1]
        if _is_ln(name):
            return None if leaf == "scale" else 0.0
        if leaf in ("b", "up1_b", "up2_b"):
            return 0.0
        if leaf == "pe_gaussian":
            return 1.0
        return 0.02

    _fill(sam, generator, std, skip="prompt.mask_down.")
    mask_gen = torch.Generator(device=generator.device).manual_seed(
        generator.initial_seed() + 1)
    conv_std = {"conv1_w": 0.2, "conv2_w": 0.1, "conv3_w": 0.05}

    def mask_std(name, p):
        if _is_ln(name):
            return None if name.endswith("scale") else 0.0
        return conv_std.get(name, 0.0)

    _fill(sam.prompt.mask_down, mask_gen, mask_std)
    return sam


def init_dino(cfg: DinoV2Config, generator: torch.Generator,
              device="cuda", dtype=torch.bfloat16) -> DinoV2:
    """Random DINOv2 weights with the JAX init's layout and scales
    (``dinov2._init_params``): N(0, 0.02²) weights, embeddings and
    tokens, zero biases, LayerNorms (1, 0), LayerScale 1e-5."""
    dino = DinoV2(cfg, dtype=dtype, device=device)

    def std(name, p):
        leaf = name.split(".")[-1]
        if _is_ln(name):
            return None if leaf == "scale" else 0.0
        if leaf == "b":
            return 0.0
        return 0.02

    _fill(dino, generator, std)
    with torch.no_grad():
        for blk in dino.blocks:
            for ls in (blk.ls1, blk.ls2):
                if ls is not None:
                    ls.fill_(1e-5)
    return dino


def init_cosplace_vit(cfg: HfViTConfig, generator: torch.Generator,
                      device="cuda", dtype=torch.float32) -> CosPlaceViT:
    """Random CosPlace ViT weights with the JAX init's scales
    (``cosplace_vit.init_params``): N(0, 0.02²) weights, tokens and
    position table, zero biases, LayerNorms (1, 0)."""
    model = CosPlaceViT(cfg, dtype=dtype, device=device)

    def std(name, p):
        leaf = name.split(".")[-1]
        if _is_ln(name):
            return None if leaf == "scale" else 0.0
        if leaf in ("b", "patch_b"):
            return 0.0
        return 0.02

    _fill(model, generator, std)
    return model


def plant_point_segmenter(sam: Sam, generator: torch.Generator) -> None:
    """Overwrite part of a randomly initialized SAM so that automatic mask
    generation finds many distinct segments: each point prompt's mask is
    a blob around its point, one size per multimask output.

    Random weights alone give every prompt the same mask (one segment per
    image survives NMS), so a run would exercise NMS, the Delaunay
    adjacency and the segment VLAD at one segment. Here:

    - the encoder's position embedding carries the prompt encoder's dense
      Fourier PE (times 32, well above what the random blocks add) in its
      first ``prompt_dim`` channels
      and the neck passes those channels through, so the image embedding
      at a grid cell is ≈ √2·PE(cell);
    - layer 0's token self-attention sends each mask token to the point
      token (found by a point-label direction) and copies its PE;
    - the mask head and the hypernetworks both project onto the same
      random [D/8, D/4]·[D/4, D] directions, so a mask logit is a rank-
      D/8 estimate of PE(cell)·PE(point) — a Gaussian kernel of the
      distance, since the PE is random Fourier features — minus an offset
      carried by one constant channel, which cuts masks 1..3 at 0.5, 0.35
      and 0.2 of the kernel's peak (about 3% of a 17places image for the
      middle one).

    Every other weight keeps its random init, so the blobs are noisy and
    the image content still moves them a little. Needs encoder_dim ≥
    prompt_dim."""
    cfg = sam.cfg
    pd = cfg.prompt_dim
    c1, c2 = pd // 4, pd // 8
    levels = (0.5, 0.35, 0.2)
    if cfg.encoder_dim < pd or cfg.num_mask_tokens != len(levels) + 1:
        raise ValueError("needs encoder_dim >= prompt_dim and 3 multimask "
                         "outputs")
    dev = sam.encoder.pos_embed.device

    def randn(*shape):
        return torch.randn(shape, generator=generator, device=dev)

    def unit(v):
        return v / v.norm()

    enc, dec = sam.encoder, sam.decoder
    q_dirs = torch.linalg.qr(randn(pd, c1))[0].t()            # [c1, pd]
    r_dirs = randn(c2, c1) / math.sqrt(c1)                     # [c2, c1]
    r_dirs[0] = 0.0                                            # offset ch.
    e_pt, m_tok = unit(randn(pd)), unit(randn(pd))
    eye = torch.eye(pd, device=dev)
    with torch.no_grad():
        pe = dense_positional_embedding(sam.prompt, cfg)[0]    # [g, g, pd]
        enc.pos_embed.zero_()
        enc.pos_embed[0, :, :, :pd] = 32.0 * pe
        enc.neck.conv1_w.copy_(torch.cat(
            [eye, eye.new_zeros(cfg.encoder_dim - pd, pd)]))
        enc.neck.conv2_w.zero_()
        enc.neck.conv2_w[1, 1] = eye

        sam.prompt.point_embed[1] = 10.0 * e_pt
        dec.mask_tokens.copy_(5.0 * m_tok.expand_as(dec.mask_tokens))
        sa = dec.layers[0].self_attn
        sa.q.w.copy_(20.0 * torch.outer(m_tok, e_pt))
        sa.k.w.copy_(torch.outer(e_pt, e_pt))
        sa.v.w.copy_(eye - torch.outer(e_pt, e_pt))
        sa.out.w.copy_(eye)
        for lin in (sa.q, sa.k, sa.v, sa.out):
            lin.b.zero_()

        dec.up1_w.copy_(q_dirs.t().repeat(1, 4))
        dec.up1_b.zero_()
        dec.up_ln.scale.fill_(0.1)
        dec.up_ln.bias.zero_()
        dec.up2_w.copy_(r_dirs.t().repeat(1, 4))
        dec.up2_b.zero_()
        dec.up2_b[0] = 1.0

        # peak of the mask logit: h2 ≈ GELU'(0)² · 0.1 · R·Q·k with
        # k ≈ √2·PE, hyper = R·Q·x with x ≈ √2·PE; R·Q keeps about
        # c2/pd of PE·PE = pd/2 at the point
        gelu1 = 0.5 * (1.0 + math.erf(1.0 / math.sqrt(2.0)))
        peak = 0.25 * 0.1 * 2.0 * (c2 - 1) / pd * (pd / 2)
        for i, frac in enumerate(levels):
            l0, l1, l2 = dec.hyper_mlps[i + 1]
            for lin in (l0, l1, l2):
                lin.w.zero_()
                lin.b.zero_()
            l0.w[:, :c1] = q_dirs.t()
            l0.w[:, c1:2 * c1] = -q_dirs.t()
            ic = torch.eye(c1, device=dev)
            l1.w[:c1, :c1], l1.w[c1:2 * c1, :c1] = ic, -ic
            l1.w[:c1, c1:2 * c1], l1.w[c1:2 * c1, c1:2 * c1] = -ic, ic
            l2.w[:c1] = r_dirs.t()
            l2.w[c1:2 * c1] = -r_dirs.t()
            l2.b[0] = -frac * peak / gelu1
