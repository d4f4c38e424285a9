"""Port parity of checkpoint loading: seeded state dicts in the original
and HuggingFace SAM layouts and the hub and transformers DINOv2 layouts
(built here, no download) go through the JAX converters and the port's
loaders; the port's module leaves must equal the JAX trees exactly, and
the converted weights must serve as the JAX ones do. Also the dense
positional encoding of a HuggingFace SAM, whose image PE has its own
Fourier matrix (f32 on both sides)."""

import inspect
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from revisit_anything_tpu.models import dinov2 as jdn
from revisit_anything_tpu.models.sam import SamArchConfig
from revisit_anything_tpu.models.sam import amg as jamg
from revisit_anything_tpu.models.sam import convert as jconv
from revisit_anything_tpu.models.sam import prompt as jprompt
from revisit_anything_tpu.models.sam.encoder import encode_image
from revisit_anything_tpu_torch.models import dinov2 as pdn
from revisit_anything_tpu_torch.models.sam import SamArchConfig as PortCfg
from revisit_anything_tpu_torch.models.sam import amg as pamg
from revisit_anything_tpu_torch.models.sam import convert as pconv
from revisit_anything_tpu_torch.models.sam import prompt as pprompt
from revisit_anything_tpu_torch.weights import sam_from_jax_params

torch.set_float32_matmul_precision("highest")

SAM_KW = dict(encoder_dim=64, encoder_depth=2, encoder_heads=4,
              global_attn_indexes=(1,), image_size=128, patch_size=16,
              window_size=4, prompt_dim=32, decoder_heads=4,
              decoder_mlp_dim=128, iou_head_hidden=32)
JCFG, PCFG = SamArchConfig(**SAM_KW), PortCfg(**SAM_KW)
DINO_KW = {"mlp": dict(embed_dim=64, depth=2, num_heads=4, ffn="mlp",
                       pretrain_grid=(8, 8)),
           "swiglu": dict(embed_dim=48, depth=2, num_heads=4, ffn="swiglu",
                          pretrain_grid=(6, 6))}
REL = 1e-4     # f32 both sides: summation order and reassociation only


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)


class _Dict(dict):
    """A state dict whose entries are made from ``rng`` as they are
    named (scale 0.1; LayerNorm scales around 1)."""

    def __init__(self, rng):
        super().__init__()
        self.rng = rng

    def put(self, key, *shape, scale=0.1, offset=0.0):
        self[key] = torch.from_numpy(
            (self.rng.standard_normal(shape) * scale + offset).astype(
                np.float32))

    def linear(self, key, n_out, n_in, bias=True):
        self.put(key + ".weight", n_out, n_in)
        if bias:
            self.put(key + ".bias", n_out)

    def ln(self, key, n):
        self.put(key + ".weight", n, offset=1.0)
        self.put(key + ".bias", n)


def sam_original_state_dict(cfg, seed):
    """The original ``sam_vit_*.pth`` layout at ``cfg``'s widths."""
    sd = _Dict(np.random.default_rng(seed))
    d, pd, g, p = cfg.encoder_dim, cfg.prompt_dim, cfg.grid, cfg.patch_size
    e = "image_encoder."
    sd.put(e + "patch_embed.proj.weight", d, 3, p, p)
    sd.put(e + "patch_embed.proj.bias", d)
    sd.put(e + "pos_embed", 1, g, g, d)
    for i in range(cfg.encoder_depth):
        b = f"{e}blocks.{i}."
        size = g if i in cfg.global_attn_indexes else cfg.window_size
        sd.ln(b + "norm1", d)
        sd.linear(b + "attn.qkv", 3 * d, d)
        sd.linear(b + "attn.proj", d, d)
        sd.put(b + "attn.rel_pos_h", 2 * size - 1, cfg.head_dim)
        sd.put(b + "attn.rel_pos_w", 2 * size - 1, cfg.head_dim)
        sd.ln(b + "norm2", d)
        sd.linear(b + "mlp.lin1", int(d * cfg.mlp_ratio), d)
        sd.linear(b + "mlp.lin2", d, int(d * cfg.mlp_ratio))
    sd.put(e + "neck.0.weight", pd, d, 1, 1)
    sd.ln(e + "neck.1", pd)
    sd.put(e + "neck.2.weight", pd, pd, 3, 3)
    sd.ln(e + "neck.3", pd)
    pe = "prompt_encoder."
    sd.put(pe + "pe_layer.positional_encoding_gaussian_matrix", 2, pd // 2,
           scale=1.0)
    for i in range(4):
        sd.put(pe + f"point_embeddings.{i}.weight", 1, pd)
    sd.put(pe + "not_a_point_embed.weight", 1, pd)
    sd.put(pe + "no_mask_embed.weight", 1, pd)
    md = pe + "mask_downscaling."
    sd.put(md + "0.weight", 4, 1, 2, 2)
    sd.put(md + "0.bias", 4)
    sd.ln(md + "1", 4)
    sd.put(md + "3.weight", 16, 4, 2, 2)
    sd.put(md + "3.bias", 16)
    sd.ln(md + "4", 16)
    sd.put(md + "6.weight", pd, 16, 1, 1)
    sd.put(md + "6.bias", pd)
    m = "mask_decoder."
    sd.put(m + "iou_token.weight", 1, pd)
    sd.put(m + "mask_tokens.weight", cfg.num_mask_tokens, pd)

    def attn(key, down):
        for n in ("q", "k", "v"):
            sd.linear(f"{key}.{n}_proj", pd // down, pd)
        sd.linear(key + ".out_proj", pd, pd // down)

    for i in range(cfg.decoder_depth):
        lp = f"{m}transformer.layers.{i}"
        attn(lp + ".self_attn", 1)
        sd.ln(lp + ".norm1", pd)
        attn(lp + ".cross_attn_token_to_image", 2)
        sd.ln(lp + ".norm2", pd)
        sd.linear(lp + ".mlp.lin1", cfg.decoder_mlp_dim, pd)
        sd.linear(lp + ".mlp.lin2", pd, cfg.decoder_mlp_dim)
        sd.ln(lp + ".norm3", pd)
        attn(lp + ".cross_attn_image_to_token", 2)
        sd.ln(lp + ".norm4", pd)
    attn(m + "transformer.final_attn_token_to_image", 2)
    sd.ln(m + "transformer.norm_final_attn", pd)
    sd.put(m + "output_upscaling.0.weight", pd, pd // 4, 2, 2)
    sd.put(m + "output_upscaling.0.bias", pd // 4)
    sd.ln(m + "output_upscaling.1", pd // 4)
    sd.put(m + "output_upscaling.3.weight", pd // 4, pd // 8, 2, 2)
    sd.put(m + "output_upscaling.3.bias", pd // 8)
    for i in range(cfg.num_mask_tokens):
        for j, (n_out, n_in) in enumerate(((pd, pd), (pd, pd),
                                           (pd // 8, pd))):
            sd.linear(f"{m}output_hypernetworks_mlps.{i}.layers.{j}",
                      n_out, n_in)
    dims = ([pd] + [cfg.iou_head_hidden] * (cfg.iou_head_depth - 1)
            + [cfg.num_mask_tokens])
    for j in range(cfg.iou_head_depth):
        sd.linear(f"{m}iou_prediction_head.layers.{j}", dims[j + 1], dims[j])
    return dict(sd)


# original SAM key → HuggingFace SamModel key
_HF_RENAMES = (
    (r"^image_encoder\.patch_embed\.proj\.", "vision_encoder.patch_embed."
     "projection."),
    (r"^image_encoder\.blocks\.(\d+)\.norm(\d)", r"vision_encoder.layers.\1."
     r"layer_norm\2"),
    (r"^image_encoder\.blocks\.", "vision_encoder.layers."),
    (r"^image_encoder\.neck\.0\.", "vision_encoder.neck.conv1."),
    (r"^image_encoder\.neck\.1\.", "vision_encoder.neck.layer_norm1."),
    (r"^image_encoder\.neck\.2\.", "vision_encoder.neck.conv2."),
    (r"^image_encoder\.neck\.3\.", "vision_encoder.neck.layer_norm2."),
    (r"^image_encoder\.", "vision_encoder."),
    (r"pe_layer\.positional_encoding_gaussian_matrix",
     "shared_embedding.positional_embedding"),
    (r"point_embeddings\.", "point_embed."),
    (r"mask_downscaling\.0\.", "mask_embed.conv1."),
    (r"mask_downscaling\.1\.", "mask_embed.layer_norm1."),
    (r"mask_downscaling\.3\.", "mask_embed.conv2."),
    (r"mask_downscaling\.4\.", "mask_embed.layer_norm2."),
    (r"mask_downscaling\.6\.", "mask_embed.conv3."),
    (r"(transformer\.layers\.\d+)\.norm(\d)", r"\1.layer_norm\2"),
    (r"transformer\.norm_final_attn", "transformer.layer_norm_final_attn"),
    (r"output_upscaling\.0\.", "upscale_conv1."),
    (r"output_upscaling\.1\.", "upscale_layer_norm."),
    (r"output_upscaling\.3\.", "upscale_conv2."),
    (r"\.layers\.0\.(weight|bias)$", r".proj_in.\1"),
    (r"\.layers\.2\.(weight|bias)$", r".proj_out.\1"),
    (r"\.layers\.1\.(weight|bias)$", r".layers.0.\1"),
)


def sam_hf_state_dict(cfg, seed):
    """The HuggingFace layout, with its dense-PE Fourier matrix drawn
    independently of the prompts' one."""
    hf = {}
    for key, v in sam_original_state_dict(cfg, seed).items():
        for pat, rep in _HF_RENAMES:
            if "hypernetworks" in key or "iou_prediction" in key or not (
                    pat.startswith(r"\.layers")):
                key = re.sub(pat, rep, key)
        hf[key] = v
    rng = np.random.default_rng(seed + 1000)
    hf["shared_image_embedding.positional_embedding"] = torch.from_numpy(
        rng.standard_normal((2, cfg.prompt_dim // 2)).astype(np.float32))
    return hf


def dino_hub_state_dict(cfg, seed, layerscale=True, registers=0):
    sd = _Dict(np.random.default_rng(seed))
    d, p = cfg.embed_dim, cfg.patch_size
    gh, gw = cfg.pretrain_grid
    sd.put("patch_embed.proj.weight", d, 3, p, p)
    sd.put("patch_embed.proj.bias", d)
    sd.put("cls_token", 1, 1, d)
    sd.put("pos_embed", 1, 1 + gh * gw, d)
    sd.put("mask_token", 1, d)
    if registers:
        sd.put("register_tokens", 1, registers, d)
    for i in range(cfg.depth):
        b = f"blocks.{i}."
        sd.ln(b + "norm1", d)
        sd.linear(b + "attn.qkv", 3 * d, d)
        sd.linear(b + "attn.proj", d, d)
        sd.ln(b + "norm2", d)
        if layerscale:
            sd.put(b + "ls1.gamma", d, offset=1.0)
            sd.put(b + "ls2.gamma", d, offset=1.0)
        if cfg.ffn == "swiglu":
            sd.linear(b + "mlp.w12", 2 * cfg.swiglu_hidden, d)
            sd.linear(b + "mlp.w3", d, cfg.swiglu_hidden)
        else:
            sd.linear(b + "mlp.fc1", cfg.mlp_hidden, d)
            sd.linear(b + "mlp.fc2", d, cfg.mlp_hidden)
    sd.ln("norm", d)
    return dict(sd)


def dino_transformers_state_dict(cfg, seed):
    """The transformers ``Dinov2Model`` layout of a hub dict's weights."""
    hub = dino_hub_state_dict(cfg, seed)
    d = cfg.embed_dim
    out = {"embeddings.patch_embeddings.projection.weight":
           hub["patch_embed.proj.weight"],
           "embeddings.patch_embeddings.projection.bias":
           hub["patch_embed.proj.bias"],
           "embeddings.cls_token": hub["cls_token"],
           "embeddings.position_embeddings": hub["pos_embed"],
           "embeddings.mask_token": hub["mask_token"],
           "layernorm.weight": hub["norm.weight"],
           "layernorm.bias": hub["norm.bias"]}
    mlp = (("w12", "weights_in"), ("w3", "weights_out")) \
        if cfg.ffn == "swiglu" else (("fc1", "fc1"), ("fc2", "fc2"))
    for i in range(cfg.depth):
        b, t = f"blocks.{i}.", f"encoder.layer.{i}."
        a = t + "attention.attention."
        for j, n in enumerate(("query", "key", "value")):
            for s in ("weight", "bias"):
                out[f"{a}{n}.{s}"] = hub[f"{b}attn.qkv.{s}"][j * d:(j + 1) * d]
        for s in ("weight", "bias"):
            out[f"{t}attention.output.dense.{s}"] = hub[f"{b}attn.proj.{s}"]
            out[f"{t}norm1.{s}"] = hub[f"{b}norm1.{s}"]
            out[f"{t}norm2.{s}"] = hub[f"{b}norm2.{s}"]
            for old, new in mlp:
                out[f"{t}mlp.{new}.{s}"] = hub[f"{b}mlp.{old}.{s}"]
        out[t + "layer_scale1.lambda1"] = hub[b + "ls1.gamma"]
        out[t + "layer_scale2.lambda1"] = hub[b + "ls2.gamma"]
    return out


def _np_dict(sd):
    return {k: v.numpy() for k, v in sd.items()}


def assert_leaves_equal(module, tree, path="", skip=()):
    """Every leaf of the JAX ``tree`` equals the port module's entry of
    the same name, exactly."""
    if isinstance(tree, dict):
        for key, sub in tree.items():
            if key not in skip:
                assert_leaves_equal(getattr(module, key), sub,
                                    f"{path}{key}.", skip)
    elif isinstance(tree, (list, tuple)):
        assert len(tree) == len(module), path
        for i, sub in enumerate(tree):
            assert_leaves_equal(module[i], sub, f"{path}{i}.", skip)
    elif tree is None:
        assert module is None, path
    else:
        np.testing.assert_array_equal(module.detach().numpy(),
                                      np.asarray(tree), err_msg=path)


SAM_LAYOUTS = {
    "original": (sam_original_state_dict,
                 jconv.convert_original_sam_state_dict,
                 pconv.convert_original_sam_state_dict),
    "hf": (sam_hf_state_dict, jconv.convert_hf_sam_state_dict,
           pconv.convert_hf_sam_state_dict),
}


@pytest.fixture(scope="module")
def sam_pairs():
    """Per SAM layout: (state dict, JAX tree, the port's Sam)."""
    out = {}
    for name, (make, jconvert, pconvert) in SAM_LAYOUTS.items():
        sd = make(JCFG, 0)
        out[name] = (sd, jconvert(_np_dict(sd), JCFG),
                     pconvert(sd, PCFG, device="cpu"))
    return out


@pytest.mark.parametrize("layout", list(SAM_LAYOUTS))
def test_sam_converter_matches_jax_leaf_for_leaf(sam_pairs, layout):
    sd, tree, sam = sam_pairs[layout]
    assert_leaves_equal(sam, tree, skip=("mask_down",))
    assert (sam.prompt.pe_gaussian_dense is None) == (layout == "original")


def test_hf_dense_positional_encoding_matches_jax(sam_pairs):
    """A HuggingFace SAM's dense image PE comes from its own Fourier
    matrix (JAX ``prompt.py``:45): through ``sam_from_jax_params`` of the
    JAX converter's tree, the port's dense PE and one AMG decode batch
    match the JAX package's."""
    _, tree, _ = sam_pairs["hf"]
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    np_tree = jax.tree_util.tree_map(np.asarray, tree)
    sam = sam_from_jax_params(np_tree, PCFG, device="cpu")
    want = np.asarray(jprompt.dense_positional_embedding(jparams, JCFG))
    with torch.inference_mode():
        got = pprompt.dense_positional_embedding(sam.prompt, PCFG).numpy()
    assert not np.allclose(tree["prompt"]["pe_gaussian"],
                           tree["prompt"]["pe_gaussian_dense"])
    assert _rel(got, want) < REL
    _decode_batch_matches(jparams, sam, seed=5)


def _decode_batch_matches(jparams, sam, seed):
    """One encode and one AMG decode batch, JAX against the port (the
    tolerances of ``test_torch_sam.py``)."""
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((1, 128, 128, 3)).astype(np.float32)
    emb_j = np.asarray(encode_image(jparams, JCFG, jnp.asarray(img)))
    pe_j = np.asarray(jprompt.dense_positional_embedding(jparams, JCFG))[0]
    with torch.inference_mode():
        emb_p = sam.encoder(torch.from_numpy(img))
        pe_p = pprompt.dense_positional_embedding(sam.prompt, PCFG)[0]
    assert _rel(emb_p.numpy(), emb_j) < REL
    orig_hw = (112, 112)
    input_hw = jamg.resize_longest_side(*orig_hw, 128)
    g = (np.arange(6) + 0.5) / 6
    pts = (np.stack(np.meshgrid(g, g), -1).reshape(-1, 2) * 128).astype(
        np.float32)
    want = [np.asarray(x) for x in jamg._decode_batch(
        jparams, JCFG, jnp.asarray(emb_j[0]), jnp.asarray(pe_j),
        jnp.asarray(pts), input_hw, orig_hw,
        jamg.AmgConfig(points_per_side=6, points_per_batch=36))]
    with torch.inference_mode():
        masks, iou, _, _ = (x.numpy() for x in pamg._decode_batch(
            sam, PCFG, emb_p[0], pe_p, torch.from_numpy(pts), input_hw,
            orig_hw, pamg.AmgConfig(points_per_side=6, points_per_batch=36)))
    assert masks.shape == want[0].shape
    assert 0.0 < masks.mean() < 1.0
    assert (masks != want[0]).mean() <= 1e-4
    assert _rel(iou, want[1]) <= 1e-4


def test_original_layout_serves_like_jax(sam_pairs):
    _, tree, sam = sam_pairs["original"]
    _decode_batch_matches(jax.tree_util.tree_map(jnp.asarray, tree), sam,
                          seed=6)


DINO_CASES = [("hub", "mlp", True, 0), ("hub", "mlp", False, 0),
              ("hub", "swiglu", True, 4), ("hub", "swiglu", False, 2),
              ("transformers", "mlp", True, 0),
              ("transformers", "swiglu", True, 0)]


def _dino_pair(layout, ffn, layerscale, registers, seed=0):
    kw = dict(DINO_KW[ffn], num_register_tokens=registers)
    jcfg, pcfg = jdn.DinoV2Config(**kw), pdn.DinoV2Config(**kw)
    if layout == "hub":
        sd = dino_hub_state_dict(pcfg, seed, layerscale, registers)
        tree = jdn.convert_dinov2_hub_state_dict(_np_dict(sd), jcfg)
        model = pdn.convert_dinov2_hub_state_dict(sd, pcfg, device="cpu")
    else:
        sd = dino_transformers_state_dict(pcfg, seed)
        tree = jdn.convert_transformers_state_dict(_np_dict(sd), jcfg)
        model = pdn.convert_transformers_state_dict(sd, pcfg, device="cpu")
    return sd, jcfg, tree, model


@pytest.mark.parametrize("layout,ffn,layerscale,registers", DINO_CASES)
def test_dino_converter_matches_jax_leaf_for_leaf(layout, ffn, layerscale,
                                                  registers):
    _, _, tree, model = _dino_pair(layout, ffn, layerscale, registers)
    assert_leaves_equal(model, tree)
    assert model.cfg.layerscale == layerscale
    assert (model.register_tokens is None) == (registers == 0)


@pytest.mark.parametrize("layout,ffn,layerscale,registers",
                         [DINO_CASES[3], DINO_CASES[4]])
def test_converted_dino_extracts_like_jax(layout, ffn, layerscale,
                                          registers):
    _, jcfg, tree, model = _dino_pair(layout, ffn, layerscale, registers)
    rng = np.random.default_rng(3)
    img = rng.standard_normal((1, 98, 112, 3)).astype(np.float32)
    want = np.asarray(jdn.extract_dense(
        jax.tree_util.tree_map(jnp.asarray, tree), jcfg, jnp.asarray(img), 1,
        "value"))
    with torch.inference_mode():
        got = pdn.extract_dense(model, model.cfg, torch.from_numpy(img),
                                1).numpy()
    assert got.shape == want.shape
    assert _rel(got, want) < REL


def test_dino_register_tokens_must_match_the_config():
    sd = dino_hub_state_dict(pdn.DinoV2Config(**DINO_KW["mlp"]), 0,
                             registers=2)
    with pytest.raises(ValueError, match="register_tokens"):
        pdn.convert_dinov2_hub_state_dict(
            sd, pdn.DinoV2Config(**DINO_KW["mlp"]), device="cpu")


@pytest.mark.parametrize("layout", ["original", "hf"])
def test_load_sam_checkpoint_from_a_file(sam_pairs, tmp_path, layout):
    """A ``torch.save``d dict (the original layout under a
    ``state_dict`` key) loads as the in-memory conversion does."""
    sd, tree, _ = sam_pairs[layout]
    path = tmp_path / "sam.pth"
    torch.save({"state_dict": sd} if layout == "original" else sd, path)
    sam = pconv.load_sam_checkpoint(str(path), PCFG, device="cpu")
    assert_leaves_equal(sam, tree, skip=("mask_down",))
    half = pconv.load_sam_checkpoint(str(path), PCFG, dtype=torch.bfloat16,
                                     device="cpu")
    assert half.encoder.blocks[0].qkv.w.dtype == torch.bfloat16
    torch.testing.assert_close(half.encoder.blocks[0].qkv.w.float(),
                               sd[next(k for k in sd if k.endswith(
                                   "0.attn.qkv.weight"))].T.bfloat16().float())


@pytest.mark.parametrize("layout", ["hub", "transformers"])
def test_load_dino_checkpoint_from_a_file(tmp_path, layout):
    sd, _, tree, _ = _dino_pair(layout, "swiglu", True, 0)
    path = tmp_path / "dino.pth"
    torch.save({"model": sd} if layout == "hub" else sd, path)
    model = pdn.load_checkpoint(str(path),
                                pdn.DinoV2Config(**DINO_KW["swiglu"]),
                                device="cpu")
    assert_leaves_equal(model, tree)


def test_loaders_default_to_the_card():
    for fn in (pconv.convert_original_sam_state_dict,
               pconv.convert_hf_sam_state_dict, pconv.load_sam_checkpoint,
               pdn.convert_dinov2_hub_state_dict,
               pdn.convert_transformers_state_dict, pdn.load_checkpoint):
        default = inspect.signature(fn).parameters["device"].default
        assert default == "cuda", fn.__name__
