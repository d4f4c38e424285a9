"""VPR training on one device: the VLAD-BuFF trainer.

Counterpart of ``revisit_anything_tpu/training/train.py``'s unsharded
path: ``VPRTrainConfig`` (:38-62), ``backbone_forward`` (:71),
``model_forward``, the trainable set of ``_trainable_mask`` (:101),
``make_schedule`` (:128), ``make_optimizer`` (:154),
``create_train_state`` (:171), ``loss_fn`` and ``train_step``
(:202-229). A DINOv2 backbone whose first depth − N blocks run under
``torch.no_grad()`` (JAX's ``stop_gradient``) and stay frozen, the last N
blocks and the final norm trainable, NetVLAD(+AntiBurst) on top, the
MultiSimilarity loss and miner.

The machine with the card has no optax, so the schedules are the port's
own functions of the step (optax's formulas, in f32) and the optimizers
are torch's: ``AdamW`` with optax's defaults (β 0.9 / 0.999, eps 1e-8,
decay decoupled and scaled by the scheduled lr) and ``SGD`` (coupled
weight decay, then momentum with no dampening), each given the
scheduled lr before its step. The trainable set is carried as
``requires_grad`` and as the optimizer's parameter list, so frozen
parameters are never written: they stay bit-identical, as the JAX step
leaves them (their gradients are exactly zero there, and ``optax.masked``
adds that zero).

The sharded step (JAX :232-285) needs a mesh and waits for the
multi-device slice. A flash-attention (K1) length on the card (N >= 1024
tokens) in a trainable block raises, since K1 has no backward; the
trainer's 224x224 crops are 257 tokens.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List

import numpy as np
import torch
from torch import nn

from revisit_anything_tpu_torch.models import dinov2 as dn
from revisit_anything_tpu_torch.training.aggregators import (
    CRN_FROZEN, netvlad_forward, netvlad_init)
from revisit_anything_tpu_torch.training.losses import multi_similarity_loss


@dataclasses.dataclass(frozen=True)
class VPRTrainConfig:
    backbone: dn.DinoV2Config = dn.VIT_B14
    num_trainable_blocks: int = 4          # train.py --num_trainable_blocks
    clusters: int = 64
    antiburst: bool = True
    lr: float = 6e-5                       # train.py --lr
    weight_decay: float = 9.5e-9           # train.py --weight_decay
    warmup_steps: int = 600                # unused by the reference's
    #                                        schedules
    total_steps: int = 20000
    lin_end_factor: float = 0.2            # train.py lr_sched_args
    lin_total_iters: int = 4000
    imgs_per_place: int = 4
    optimizer: str = "adamw"               # sgd | adam | adamw
    momentum: float = 0.9                  # sgd
    lr_sched: str = "linear"               # linear | multistep | cosine
    milestones: tuple = (5, 10, 15)        # multistep (unit: epochs->steps
    steps_per_epoch: int = 0               # 0: milestones are raw steps
    gamma: float = 0.3                     # multistep decay
    cosine_t_max: int = 0                  # cosine; 0 -> total_steps


class VPRModel(nn.Module):
    """The trained model: ``backbone`` (a ``dinov2.DinoV2``) and
    ``aggregator`` (the NetVLAD module), the JAX tree's two halves."""

    def __init__(self, backbone: dn.DinoV2, aggregator: nn.Module):
        super().__init__()
        self.backbone = backbone
        self.aggregator = aggregator


@dataclasses.dataclass
class VPRTrainState:
    model: VPRModel
    optimizer: torch.optim.Optimizer
    step: int


def backbone_forward(backbone: dn.DinoV2, cfg: dn.DinoV2Config,
                     images: torch.Tensor,
                     num_trainable: int) -> torch.Tensor:
    """[B, H, W, 3] → [B, D, gh, gw] patch features; gradients flow only
    through the last ``num_trainable`` blocks and the final norm."""
    if num_trainable > cfg.depth:
        raise ValueError(f"num_trainable_blocks {num_trainable} exceeds "
                         f"backbone depth {cfg.depth}")
    split = cfg.depth - num_trainable
    with torch.no_grad():
        x = dn.embed_patches(backbone, cfg, images)
        for blk in backbone.blocks[:split]:
            x = dn._block(x, blk, cfg)
    for blk in backbone.blocks[split:]:
        x = dn._block(x, blk, cfg)
    return dn.patch_features(backbone.norm(x, cfg.eps), cfg,
                             images.shape[1:3])


def model_forward(model: VPRModel, cfg: VPRTrainConfig,
                  images: torch.Tensor) -> torch.Tensor:
    feats = backbone_forward(model.backbone, cfg.backbone, images,
                             cfg.num_trainable_blocks)
    return netvlad_forward(model.aggregator, feats)


def _trainable_mask(model: VPRModel, cfg: VPRTrainConfig) -> dict:
    """{parameter name: trainable}: the aggregator (but CRN's fixed
    accumulation conv), the last N backbone blocks and the final norm."""
    if cfg.num_trainable_blocks > cfg.backbone.depth:
        raise ValueError(f"num_trainable_blocks {cfg.num_trainable_blocks}"
                         f" exceeds backbone depth {cfg.backbone.depth}")
    split = cfg.backbone.depth - cfg.num_trainable_blocks
    trainable = tuple(f"backbone.blocks.{i}."
                      for i in range(split, cfg.backbone.depth))
    trainable += ("backbone.norm.", "aggregator.")
    frozen = tuple(f"aggregator.crn.{k}" for k in CRN_FROZEN)
    return {name: name.startswith(trainable) and name not in frozen
            for name, _ in model.named_parameters()}


def make_schedule(cfg: VPRTrainConfig) -> Callable[[int], float]:
    """The lr at a step (0-based): "linear" (torch LinearLR: lr →
    lr·lin_end_factor over lin_total_iters steps, constant after, no
    warmup), "multistep" (×gamma at each milestone·unit) or "cosine"
    (cosine decay to 0 over t_max). Each is optax's schedule formula in
    f32, as the JAX trainer evaluates it."""
    f32 = np.float32
    sched = cfg.lr_sched.lower()
    if sched == "linear":
        end = cfg.lr * cfg.lin_end_factor
        span = f32(cfg.lr - end)
        steps = cfg.lin_total_iters

        def linear(step: int) -> float:
            if steps <= 0:
                return float(f32(cfg.lr))
            count = f32(min(max(step, 0), steps))
            frac = f32(1) - count / f32(steps)
            return float(span * frac + f32(end))
        return linear
    if sched == "multistep":
        unit = cfg.steps_per_epoch if cfg.steps_per_epoch > 0 else 1
        bounds = sorted({int(m * unit): f32(cfg.gamma)
                         for m in cfg.milestones}.items())

        def multistep(step: int) -> float:
            v = f32(cfg.lr)
            for threshold, scale in bounds:
                if step >= threshold:
                    v = scale * v
            return float(v)
        return multistep
    if sched == "cosine":
        t_max = f32(cfg.cosine_t_max or cfg.total_steps)
        if not t_max > 0:
            raise ValueError("cosine schedule needs a positive t_max")

        def cosine(step: int) -> float:
            count = min(f32(step), t_max)
            decay = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * count
                                                / t_max, dtype=f32))
            return float(f32(cfg.lr) * decay)
        return cosine
    raise ValueError(f"unknown lr_sched {cfg.lr_sched!r}")


def make_optimizer(cfg: VPRTrainConfig,
                   params: List[nn.Parameter]) -> torch.optim.Optimizer:
    """AdamW for "adamw" and "adam" (the reference's "adam" is AdamW
    too), SGD with momentum for "sgd", over the trainable ``params``; the
    lr is set from :func:`make_schedule` before every step."""
    opt = cfg.optimizer.lower()
    lr0 = make_schedule(cfg)(0)
    if opt == "sgd":
        return torch.optim.SGD(params, lr=lr0, momentum=cfg.momentum,
                               dampening=0.0,
                               weight_decay=cfg.weight_decay)
    if opt in ("adamw", "adam"):
        return torch.optim.AdamW(params, lr=lr0, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=cfg.weight_decay)
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")


def create_train_state(cfg: VPRTrainConfig, seed: int = 0,
                       init_descriptors=None, device="cuda",
                       model: VPRModel = None) -> VPRTrainState:
    """A fresh train state: seeded f32 weights on ``device`` (or the
    given ``model``), the trainable set marked, the optimizer at step 0.

    ``init_descriptors`` [N, D]: sample backbone descriptors for the
    reference's NetVLAD cluster initialization (euclidean k-means, 100
    iterations, then ``netvlad_init_from_cluster_centers``); without
    them the aggregator starts from a seeded random init."""
    if model is None:
        from revisit_anything_tpu_torch.training.aggregators import (
            netvlad_init_from_cluster_centers)
        from revisit_anything_tpu_torch.weights import init_dino
        gen = torch.Generator(device=device).manual_seed(seed)
        backbone = init_dino(cfg.backbone, gen, device, torch.float32)
        if init_descriptors is not None:
            from revisit_anything_tpu_torch.ops.kmeans import kmeans_fit
            x = torch.as_tensor(np.asarray(init_descriptors, np.float32),
                                device=device)
            centers, _ = kmeans_fit(x, cfg.clusters, gen, num_iters=100,
                                    mode="euclidean")
            aggregator = netvlad_init_from_cluster_centers(
                centers, descriptors=x, antiburst=cfg.antiburst)
        else:
            aggregator = netvlad_init(gen, cfg.backbone.embed_dim,
                                      cfg.clusters, cfg.antiburst,
                                      device=device)
        model = VPRModel(backbone, aggregator)
    mask = _trainable_mask(model, cfg)
    for name, p in model.named_parameters():
        p.requires_grad_(mask[name])
    params = [p for name, p in model.named_parameters() if mask[name]]
    return VPRTrainState(model, make_optimizer(cfg, params), 0)


def loss_fn(model: VPRModel, cfg: VPRTrainConfig, images: torch.Tensor,
            labels: torch.Tensor) -> torch.Tensor:
    return multi_similarity_loss(model_forward(model, cfg, images), labels)


def train_step(state: VPRTrainState, cfg: VPRTrainConfig,
               images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """One optimization step on ``state`` (in place): images [B, H, W, 3]
    f32 (normalized), labels [B] place ids. Returns the loss (before the
    update) and advances ``state.step``."""
    dev = next(state.model.parameters()).device
    images = torch.as_tensor(images, device=dev)
    labels = torch.as_tensor(labels, device=dev)
    lr = make_schedule(cfg)(state.step)
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    state.optimizer.zero_grad(set_to_none=True)
    loss = loss_fn(state.model, cfg, images, labels)
    loss.backward()
    state.optimizer.step()
    state.step += 1
    return loss.detach()
