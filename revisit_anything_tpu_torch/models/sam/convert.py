"""SAM checkpoints into the port's ``Sam`` (counterpart of
``revisit_anything_tpu/models/sam/convert.py``:
``convert_original_sam_state_dict`` :138, ``convert_hf_sam_state_dict``
:191, ``load_sam_checkpoint`` :250).

Two source layouts:
- the original ``sam_vit_h_4b8939.pth`` state dict (prefixes
  ``image_encoder.`` / ``prompt_encoder.`` / ``mask_decoder.``);
- HuggingFace ``SamModel`` (prefix ``vision_encoder.`` etc.), which keeps
  a second Fourier matrix for the dense image PE.

Each converter builds the JAX package's parameter tree with numpy leaves
that are views into the state dict where the layout allows (a transposed
dense weight is a view; a convolution reshaped for a matmul is one
leaf's copy), then copies it leaf by leaf into a ``Sam`` built on
``device`` in ``dtype`` (``layers.load_tree``). So a checkpoint goes from
the state dict into the module on the card with no second copy of the
model on the host. The mask-prompt downscaling stack (``mask_down``) is
not read: the port runs point prompts only.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from revisit_anything_tpu_torch.models.layers import (linear_leaves,
                                                     load_tree, norm_leaves)
from revisit_anything_tpu_torch.models.layers import state_array as _np
from revisit_anything_tpu_torch.models.sam import Sam
from revisit_anything_tpu_torch.models.sam.config import SamArchConfig


def _convt_w(sd, prefix):
    """ConvTranspose2d(k=2, s=2) weight [in, out, 2, 2] → [in, 4·out] in
    the upscaler's (kh, kw, cout) order, and its bias."""
    w = _np(sd, prefix + ".weight")
    cin, cout = w.shape[0], w.shape[1]
    return (w.transpose(0, 2, 3, 1).reshape(cin, 4 * cout),
            _np(sd, prefix + ".bias"))


def _mlp_layers(sd, prefix, n, hf=False):
    if hf:
        names = ([f"{prefix}.proj_in"]
                 + [f"{prefix}.layers.{i}" for i in range(n - 2)]
                 + [f"{prefix}.proj_out"])
    else:
        names = [f"{prefix}.layers.{i}" for i in range(n)]
    return [linear_leaves(sd, nm) for nm in names]


def _encoder_common(sd, cfg: SamArchConfig, p):
    """Shared encoder mapping; ``p`` maps logical names → state-dict keys."""
    pe_w = _np(sd, p["patch_w"])
    pe_w = pe_w.transpose(2, 3, 1, 0).reshape(-1, cfg.encoder_dim)
    blocks = []
    for i in range(cfg.encoder_depth):
        b = p["block"](i)
        blocks.append({
            "norm1": norm_leaves(sd, b["norm1"]),
            "qkv": linear_leaves(sd, b["qkv"]),
            "proj": linear_leaves(sd, b["proj"]),
            "rel_pos_h": _np(sd, b["rel_h"]),
            "rel_pos_w": _np(sd, b["rel_w"]),
            "norm2": norm_leaves(sd, b["norm2"]),
            "lin1": linear_leaves(sd, b["lin1"]),
            "lin2": linear_leaves(sd, b["lin2"]),
        })
    return {
        "patch_embed": {"w": pe_w, "b": _np(sd, p["patch_b"])},
        "pos_embed": _np(sd, p["pos_embed"]),
        "blocks": blocks,
        "neck": {"conv1_w": _np(sd, p["neck_c1"])[:, :, 0, 0].T,
                 "ln1": norm_leaves(sd, p["neck_ln1"]),
                 "conv2_w": _np(sd, p["neck_c2"]).transpose(2, 3, 1, 0),
                 "ln2": norm_leaves(sd, p["neck_ln2"])},
    }


def _decoder_common(sd, cfg: SamArchConfig, pfx: str, hf: bool):
    def attn(prefix):
        return {"q": linear_leaves(sd, prefix + ".q_proj"),
                "k": linear_leaves(sd, prefix + ".k_proj"),
                "v": linear_leaves(sd, prefix + ".v_proj"),
                "out": linear_leaves(sd, prefix + ".out_proj")}

    norm = ".layer_norm" if hf else ".norm"
    layers = []
    for i in range(cfg.decoder_depth):
        lp = f"{pfx}.transformer.layers.{i}"
        layers.append({
            "self_attn": attn(lp + ".self_attn"),
            "norm1": norm_leaves(sd, lp + norm + "1"),
            "t2i": attn(lp + ".cross_attn_token_to_image"),
            "norm2": norm_leaves(sd, lp + norm + "2"),
            "lin1": linear_leaves(sd, lp + ".mlp.lin1"),
            "lin2": linear_leaves(sd, lp + ".mlp.lin2"),
            "norm3": norm_leaves(sd, lp + norm + "3"),
            "i2t": attn(lp + ".cross_attn_image_to_token"),
            "norm4": norm_leaves(sd, lp + norm + "4"),
        })

    if hf:
        up1_w, up1_b = _convt_w(sd, pfx + ".upscale_conv1")
        up2_w, up2_b = _convt_w(sd, pfx + ".upscale_conv2")
        up_ln = norm_leaves(sd, pfx + ".upscale_layer_norm")
        final_norm = norm_leaves(
            sd, pfx + ".transformer.layer_norm_final_attn")
    else:
        up1_w, up1_b = _convt_w(sd, pfx + ".output_upscaling.0")
        up2_w, up2_b = _convt_w(sd, pfx + ".output_upscaling.3")
        up_ln = norm_leaves(sd, pfx + ".output_upscaling.1")
        final_norm = norm_leaves(sd, pfx + ".transformer.norm_final_attn")

    return {
        "iou_token": _np(sd, pfx + ".iou_token.weight"),
        "mask_tokens": _np(sd, pfx + ".mask_tokens.weight"),
        "layers": layers,
        "final_attn": attn(pfx + ".transformer.final_attn_token_to_image"),
        "norm_final": final_norm,
        "up1_w": up1_w, "up1_b": up1_b, "up_ln": up_ln,
        "up2_w": up2_w, "up2_b": up2_b,
        "hyper_mlps": [
            _mlp_layers(sd, f"{pfx}.output_hypernetworks_mlps.{i}", 3, hf)
            for i in range(cfg.num_mask_tokens)],
        "iou_head": _mlp_layers(sd, pfx + ".iou_prediction_head",
                                cfg.iou_head_depth, hf),
    }


def _load(tree, cfg: SamArchConfig, dtype, device) -> Sam:
    sam = Sam(cfg, dtype=dtype, device=device,
              dense_pe="pe_gaussian_dense" in tree["prompt"])
    load_tree(sam, tree)
    return sam


def convert_original_sam_state_dict(sd: Dict, cfg: SamArchConfig, *,
                                    dtype=torch.float32,
                                    device="cuda") -> Sam:
    """The original SAM layout (name → tensor or array) → ``Sam``."""
    enc = _encoder_common(sd, cfg, {
        "patch_w": "image_encoder.patch_embed.proj.weight",
        "patch_b": "image_encoder.patch_embed.proj.bias",
        "pos_embed": "image_encoder.pos_embed",
        "block": lambda i: {
            "norm1": f"image_encoder.blocks.{i}.norm1",
            "qkv": f"image_encoder.blocks.{i}.attn.qkv",
            "proj": f"image_encoder.blocks.{i}.attn.proj",
            "rel_h": f"image_encoder.blocks.{i}.attn.rel_pos_h",
            "rel_w": f"image_encoder.blocks.{i}.attn.rel_pos_w",
            "norm2": f"image_encoder.blocks.{i}.norm2",
            "lin1": f"image_encoder.blocks.{i}.mlp.lin1",
            "lin2": f"image_encoder.blocks.{i}.mlp.lin2",
        },
        "neck_c1": "image_encoder.neck.0.weight",
        "neck_ln1": "image_encoder.neck.1",
        "neck_c2": "image_encoder.neck.2.weight",
        "neck_ln2": "image_encoder.neck.3",
    })
    prompt = {
        "pe_gaussian": _np(
            sd, "prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"),
        "point_embed": np.stack(
            [_np(sd, f"prompt_encoder.point_embeddings.{i}.weight")[0]
             for i in range(4)]),
        "not_a_point": _np(sd, "prompt_encoder.not_a_point_embed.weight")[0],
        "no_mask": _np(sd, "prompt_encoder.no_mask_embed.weight")[0],
    }
    dec = _decoder_common(sd, cfg, "mask_decoder", hf=False)
    return _load({"encoder": enc, "prompt": prompt, "decoder": dec}, cfg,
                 dtype, device)


def convert_hf_sam_state_dict(sd: Dict, cfg: SamArchConfig, *,
                              dtype=torch.float32, device="cuda") -> Sam:
    """The HuggingFace ``SamModel`` layout → ``Sam``, keeping both of its
    Fourier matrices (the prompts' and the dense image PE's)."""
    enc = _encoder_common(sd, cfg, {
        "patch_w": "vision_encoder.patch_embed.projection.weight",
        "patch_b": "vision_encoder.patch_embed.projection.bias",
        "pos_embed": "vision_encoder.pos_embed",
        "block": lambda i: {
            "norm1": f"vision_encoder.layers.{i}.layer_norm1",
            "qkv": f"vision_encoder.layers.{i}.attn.qkv",
            "proj": f"vision_encoder.layers.{i}.attn.proj",
            "rel_h": f"vision_encoder.layers.{i}.attn.rel_pos_h",
            "rel_w": f"vision_encoder.layers.{i}.attn.rel_pos_w",
            "norm2": f"vision_encoder.layers.{i}.layer_norm2",
            "lin1": f"vision_encoder.layers.{i}.mlp.lin1",
            "lin2": f"vision_encoder.layers.{i}.mlp.lin2",
        },
        "neck_c1": "vision_encoder.neck.conv1.weight",
        "neck_ln1": "vision_encoder.neck.layer_norm1",
        "neck_c2": "vision_encoder.neck.conv2.weight",
        "neck_ln2": "vision_encoder.neck.layer_norm2",
    })
    prompt = {
        "pe_gaussian": _np(
            sd, "prompt_encoder.shared_embedding.positional_embedding"),
        "pe_gaussian_dense": _np(
            sd, "shared_image_embedding.positional_embedding"),
        "point_embed": np.stack(
            [_np(sd, f"prompt_encoder.point_embed.{i}.weight")[0]
             for i in range(4)]),
        "not_a_point": _np(sd, "prompt_encoder.not_a_point_embed.weight")[0],
        "no_mask": _np(sd, "prompt_encoder.no_mask_embed.weight")[0],
    }
    dec = _decoder_common(sd, cfg, "mask_decoder", hf=True)
    return _load({"encoder": enc, "prompt": prompt, "decoder": dec}, cfg,
                 dtype, device)


def load_sam_checkpoint(path: str, cfg: SamArchConfig, *,
                        dtype=torch.float32, device="cuda") -> Sam:
    """A torch SAM checkpoint (.pth, either layout, optionally under a
    ``state_dict`` key) → ``Sam`` on ``device`` in ``dtype``. The file is
    memory-mapped, so its pages are read as each leaf is copied."""
    sd = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    if any(k.startswith("vision_encoder.") for k in sd):
        return convert_hf_sam_state_dict(sd, cfg, dtype=dtype, device=device)
    return convert_original_sam_state_dict(sd, cfg, dtype=dtype,
                                           device=device)
