"""ResNet backbones: the VLAD-BuFF CNN family, conv1..layer4.

Counterpart of ``revisit_anything_tpu/models/resnet.py``:
``ResNetConfig`` and ``CONFIGS`` (:18-62), ``resnet_forward`` (:104),
``convert_torchvision_resnet`` (:126) and the seeded init (:166). A
torchvision-layout ResNet without avgpool and fc, with optional cropping
of layer3/layer4; batch norm is folded into a scale and a bias at
conversion (frozen, eval mode). Convolutions are ``F.conv2d`` with the
JAX package's explicit symmetric padding (k − 1) // 2, in true f32 for
f32 weights.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from revisit_anything_tpu_torch.models.layers import load_tree, param
from revisit_anything_tpu_torch.models.layers import state_array as _np
from revisit_anything_tpu_torch.ops.knn import f32_products


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    block: str                      # "basic" | "bottleneck"
    layers: Tuple[int, int, int, int]
    width: int = 64
    layers_to_crop: Tuple[int, ...] = ()

    def __post_init__(self):
        # the forward stops at the first cropped layer, so cropping 3
        # drops 4 as well; require it explicitly or out_channels would
        # misreport the feature width
        if 3 in self.layers_to_crop and 4 not in self.layers_to_crop:
            raise ValueError("layers_to_crop=(3,) also drops layer4 — "
                             "pass layers_to_crop=(4, 3) explicitly")

    @property
    def expansion(self) -> int:
        return 1 if self.block == "basic" else 4

    @property
    def out_channels(self) -> int:
        base = 512 * self.expansion
        if 4 in self.layers_to_crop:
            base //= 2
        if 3 in self.layers_to_crop:
            base //= 2
        return base


RESNET18 = ResNetConfig("basic", (2, 2, 2, 2))
RESNET34 = ResNetConfig("basic", (3, 4, 6, 3))
RESNET50 = ResNetConfig("bottleneck", (3, 4, 6, 3))
RESNET101 = ResNetConfig("bottleneck", (3, 4, 23, 3))
RESNET152 = ResNetConfig("bottleneck", (3, 8, 36, 3))

CONFIGS = {"resnet18": RESNET18, "resnet34": RESNET34,
           "resnet50": RESNET50, "resnet101": RESNET101,
           "resnet152": RESNET152}


class ConvBN(nn.Module):
    """A convolution ``w`` [k, k, cin, cout] (HWIO, the JAX tree's) with
    its folded batch norm ``bn_scale``, ``bn_bias`` [cout]."""

    def __init__(self, cin: int, cout: int, k: int, *, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.w = param(k, k, cin, cout, **kw)
        self.bn_scale = param(cout, **kw)
        self.bn_bias = param(cout, **kw)

    def forward(self, x: torch.Tensor, stride: int = 1,
                relu: bool = True) -> torch.Tensor:
        k = self.w.shape[0]
        with f32_products():
            y = F.conv2d(x, self.w.permute(3, 2, 0, 1), stride=stride,
                         padding=(k - 1) // 2)
        y = y * self.bn_scale[:, None, None] + self.bn_bias[:, None, None]
        return torch.relu(y) if relu else y


def _stage_plan(cfg: ResNetConfig):
    """(layer index, [(cin, planes, cout, downsample)] a block) for every
    stage before the first cropped one."""
    cin = cfg.width
    for li, n_blocks in enumerate(cfg.layers, start=1):
        if li in cfg.layers_to_crop:
            return
        planes = cfg.width * 2 ** (li - 1)
        cout = planes * cfg.expansion
        blocks = []
        for bi in range(n_blocks):
            blocks.append((cin, planes, cout,
                           bi == 0 and (cin != cout or li > 1)))
            cin = cout
        yield li, blocks


class ResNet(nn.Module):
    """``stem`` and ``layers`` (a list of stages, each a list of blocks
    with ``conv1``, ``conv2``, ``conv3`` for bottlenecks, ``downsample``
    where the stage changes shape), as the JAX tree."""

    def __init__(self, cfg: ResNetConfig, *, dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        self.cfg = cfg
        kw = dict(dtype=dtype, device=device)
        self.stem = ConvBN(3, cfg.width, 7, **kw)
        stages = []
        for _, blocks in _stage_plan(cfg):
            stage = nn.ModuleList()
            for cin, planes, cout, down in blocks:
                blk = nn.Module()
                if cfg.block == "basic":
                    blk.conv1 = ConvBN(cin, planes, 3, **kw)
                    blk.conv2 = ConvBN(planes, planes, 3, **kw)
                else:
                    blk.conv1 = ConvBN(cin, planes, 1, **kw)
                    blk.conv2 = ConvBN(planes, planes, 3, **kw)
                    blk.conv3 = ConvBN(planes, cout, 1, **kw)
                if down:
                    blk.downsample = ConvBN(cin, cout, 1, **kw)
                stage.append(blk)
            stages.append(stage)
        self.layers = nn.ModuleList(stages)


def _basic_block(x, p, stride):
    y = p.conv1(x, stride)
    y = p.conv2(y, 1, relu=False)
    identity = (p.downsample(x, stride, relu=False)
                if hasattr(p, "downsample") else x)
    return torch.relu(y + identity)


def _bottleneck_block(x, p, stride):
    y = p.conv1(x, 1)
    y = p.conv2(y, stride)
    y = p.conv3(y, 1, relu=False)
    identity = (p.downsample(x, stride, relu=False)
                if hasattr(p, "downsample") else x)
    return torch.relu(y + identity)


def resnet_forward(model: ResNet, cfg: ResNetConfig,
                   images: torch.Tensor) -> torch.Tensor:
    """images [B, H, W, 3] (ImageNet-normalized) → features [B, C, H/s,
    W/s] (channel-first, as the torch backbone)."""
    x = images.to(model.stem.w.dtype).permute(0, 3, 1, 2)
    # stem: 7x7/2 conv + bn + relu, then the 3x3/2 max pool (padding 1)
    x = model.stem(x, 2)
    x = F.max_pool2d(x, 3, stride=2, padding=1)
    block = _basic_block if cfg.block == "basic" else _bottleneck_block
    for li, stage in enumerate(model.layers, start=1):
        for bi, blk in enumerate(stage):
            x = block(x, blk, 2 if (li > 1 and bi == 0) else 1)
    return x


def convert_torchvision_resnet(state_dict: Dict, cfg: ResNetConfig,
                               eps: float = 1e-5, *, dtype=torch.float32,
                               device="cuda") -> ResNet:
    """A torchvision ResNet state dict → ``ResNet`` on ``device``, batch
    norms folded (scale = gamma / sqrt(var + eps), bias = beta −
    scale·mean)."""
    def conv_bn(conv_key, bn_key):
        gamma = _np(state_dict, bn_key + ".weight")
        mean = _np(state_dict, bn_key + ".running_mean")
        var = _np(state_dict, bn_key + ".running_var")
        scale = gamma / np.sqrt(var + eps)
        return {"w": _np(state_dict, conv_key + ".weight").transpose(
                    2, 3, 1, 0),
                "bn_scale": scale,
                "bn_bias": _np(state_dict, bn_key + ".bias") - scale * mean}

    layers = []
    for li, blocks in _stage_plan(cfg):
        stage = []
        for bi, (_, _, _, down) in enumerate(blocks):
            pre = f"layer{li}.{bi}"
            blk = {"conv1": conv_bn(pre + ".conv1", pre + ".bn1"),
                   "conv2": conv_bn(pre + ".conv2", pre + ".bn2")}
            if cfg.block == "bottleneck":
                blk["conv3"] = conv_bn(pre + ".conv3", pre + ".bn3")
            if down:
                blk["downsample"] = conv_bn(pre + ".downsample.0",
                                            pre + ".downsample.1")
            stage.append(blk)
        layers.append(stage)
    model = ResNet(cfg, dtype=dtype, device=device)
    load_tree(model, {"stem": conv_bn("conv1", "bn1"), "layers": layers})
    return model


def synthetic_state_dict(cfg: ResNetConfig,
                         rng: np.random.Generator) -> Dict[str, np.ndarray]:
    """A torchvision-layout state dict of random convolutions
    (N(0, 0.05²)) and identity batch norms, every stage included (as the
    JAX package's ``init_resnet_params`` draws it)."""
    sd = {}

    def add_conv_bn(name_c, name_b, cin, cout, k):
        sd[name_c + ".weight"] = rng.standard_normal(
            (cout, cin, k, k)).astype(np.float32) * 0.05
        sd[name_b + ".weight"] = np.ones(cout, np.float32)
        sd[name_b + ".bias"] = np.zeros(cout, np.float32)
        sd[name_b + ".running_mean"] = np.zeros(cout, np.float32)
        sd[name_b + ".running_var"] = np.ones(cout, np.float32)

    add_conv_bn("conv1", "bn1", 3, cfg.width, 7)
    full = dataclasses.replace(cfg, layers_to_crop=())
    for li, blocks in _stage_plan(full):
        for bi, (cin, planes, cout, down) in enumerate(blocks):
            pre = f"layer{li}.{bi}"
            if cfg.block == "basic":
                add_conv_bn(pre + ".conv1", pre + ".bn1", cin, planes, 3)
                add_conv_bn(pre + ".conv2", pre + ".bn2", planes, planes, 3)
            else:
                add_conv_bn(pre + ".conv1", pre + ".bn1", cin, planes, 1)
                add_conv_bn(pre + ".conv2", pre + ".bn2", planes, planes, 3)
                add_conv_bn(pre + ".conv3", pre + ".bn3", planes, cout, 1)
            if down:
                add_conv_bn(pre + ".downsample.0", pre + ".downsample.1",
                            cin, cout, 1)
    return sd


def init_resnet(cfg: ResNetConfig, seed: int = 0, *, dtype=torch.float32,
                device="cuda") -> ResNet:
    """Random ResNet weights from ``seed`` (synthetic testing; real
    weights come from torchvision checkpoints)."""
    sd = synthetic_state_dict(cfg, np.random.default_rng(seed))
    return convert_torchvision_resnet(sd, cfg, dtype=dtype, device=device)
