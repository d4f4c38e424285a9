"""VLAD-BuFF and DINO-SALAD models: checkpoint import, dense features,
global descriptors, and the whitened-PCA output layer.

Counterpart of ``revisit_anything_tpu/training/vladbuff.py``:
``convert_vladbuff_checkpoint`` (:36), ``load_vladbuff_checkpoint``
(:95), ``extract_dinonv_features`` (:104), ``global_descriptor`` (:117),
``convert_dinosalad_checkpoint`` (:131), ``load_dinosalad_checkpoint``
(:164), ``extract_dinosalad_features`` (:173), ``salad_global_descriptor``
(:181), ``fit_wpca`` (:197), ``bake_wpca`` (:235) and
``save_vladbuff_params`` / ``load_vladbuff_params`` (:245-256). A model
is a ``train.VPRModel`` (``backbone``, ``aggregator``) with an optional
``wpca`` module (``w`` [K, C·D], ``b`` [K]): the JAX tree's
``{"backbone", "aggregator", "wpca"?}``, which ``layers.module_tree``
writes out and ``weights.vpr_from_jax_params`` reads, so the ``.npy``
files of the two packages are the same format.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from revisit_anything_tpu_torch.models import dinov2 as dn
from revisit_anything_tpu_torch.models.layers import (module_tree,
                                                     tree_module)
from revisit_anything_tpu_torch.models.layers import state_array as _np
from revisit_anything_tpu_torch.ops.knn import f32_products
from revisit_anything_tpu_torch.ops.vlad import l2_normalize
from revisit_anything_tpu_torch.training.aggregators import (netvlad_forward,
                                                             salad_forward)
from revisit_anything_tpu_torch.training.train import VPRModel
from revisit_anything_tpu_torch.weights import vpr_from_jax_params


def _backbone(state_dict, cfg, dtype, device) -> dn.DinoV2:
    bb = {k[len("backbone.model."):]: v for k, v in state_dict.items()
          if k.startswith("backbone.model.")}
    return dn.convert_dinov2_hub_state_dict(bb, cfg, dtype=dtype,
                                            device=device)


def convert_vladbuff_checkpoint(state_dict: Dict,
                                cfg: dn.DinoV2Config = dn.VIT_B14, *,
                                dtype=torch.float32,
                                device="cuda") -> VPRModel:
    """A Lightning VPRModel state dict (``backbone.model.*`` in the hub
    DINOv2 layout, ``aggregator.conv.weight`` [C, D, 1, 1],
    ``aggregator.centroids``, optional ``aggregator.ab_params``, the
    nv_pca pre-projections, optional WPCA layers) → ``VPRModel``. Of
    several cumulative ``WPCA_k`` layers the widest is taken."""
    g = lambda k: _np(state_dict, k)                           # noqa: E731
    agg = {"assign_w": g("aggregator.conv.weight")[:, :, 0, 0].T,
           "centroids": g("aggregator.centroids")}
    if "aggregator.ab_params" in state_dict:
        agg["ab_params"] = g("aggregator.ab_params")
    # the torch module registers pca_mean/pca_rot in the alt modes too;
    # the forward uses them only in "rot" mode
    if "aggregator.bottleneck.weight" in state_dict:
        agg["bottleneck"] = {"w": g("aggregator.bottleneck.weight").T,
                             "b": g("aggregator.bottleneck.bias")}
    elif "aggregator.mlp.0.weight" in state_dict:
        agg["nv_mlp"] = {
            "fc1": {"w": g("aggregator.mlp.0.weight").T,
                    "b": g("aggregator.mlp.0.bias")},
            "fc2": {"w": g("aggregator.mlp.2.weight").T,
                    "b": g("aggregator.mlp.2.bias")}}
    elif "aggregator.pca_rot" in state_dict:
        agg["pca_mean"] = g("aggregator.pca_mean")
        agg["pca_rot"] = g("aggregator.pca_rot")
    model = VPRModel(_backbone(state_dict, cfg, dtype, device),
                     tree_module(agg, device=device))
    wpca_keys = [k for k in state_dict if "wpca" in k.lower()
                 and k.endswith(".weight")]
    if wpca_keys:
        wk = max(wpca_keys, key=lambda k: state_dict[k].shape[0])
        w = g(wk)
        w = w[:, :, 0, 0] if w.ndim == 4 else w
        bk = wk[:-len(".weight")] + ".bias"
        b = g(bk) if bk in state_dict else np.zeros(w.shape[0], np.float32)
        model.add_module("wpca", tree_module({"w": w, "b": b},
                                             device=device))
    return model


def _load_state_dict(path: str) -> Dict:
    # Lightning checkpoints hold more than tensors (hyper-parameters), so
    # they are unpickled: load only files from a trusted source
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    return ckpt.get("state_dict", ckpt)


def load_vladbuff_checkpoint(path: str, cfg: dn.DinoV2Config = dn.VIT_B14,
                             *, dtype=torch.float32,
                             device="cuda") -> VPRModel:
    return convert_vladbuff_checkpoint(_load_state_dict(path), cfg,
                                       dtype=dtype, device=device)


def extract_dinonv_features(model: VPRModel, cfg: dn.DinoV2Config,
                            images: torch.Tensor) -> torch.Tensor:
    """Dense backbone features [B, D, gh, gw] (every block, the final
    norm, the token facet): what the reference stores in
    ``*_dinoNV_*.h5``, unnormalized."""
    tokens = dn.forward_tokens(model.backbone, cfg, images, final_norm=True)
    return dn.patch_features(tokens, cfg, images.shape[1:3])


def _apply_wpca(model, desc: torch.Tensor) -> torch.Tensor:
    if not hasattr(model, "wpca"):
        return desc
    with f32_products():
        desc = desc @ model.wpca.w.T + model.wpca.b
    return l2_normalize(desc, 1)


def global_descriptor(model: VPRModel, cfg: dn.DinoV2Config,
                      images: torch.Tensor) -> torch.Tensor:
    """Whole-image VLAD-BuFF descriptor: backbone → NetVLAD (→ WPCA,
    L2-normalized)."""
    feats = extract_dinonv_features(model, cfg, images)
    return _apply_wpca(model, netvlad_forward(model.aggregator, feats))


def convert_dinosalad_checkpoint(state_dict: Dict,
                                 cfg: dn.DinoV2Config = dn.VIT_B14, *,
                                 dtype=torch.float32,
                                 device="cuda") -> VPRModel:
    """A DINO-SALAD checkpoint → ``VPRModel`` with the SALAD aggregator
    (``token_features.{0,2}`` Linear, ``cluster_features.{0,3}`` and
    ``score.{0,3}`` 1x1 convolutions, ``dust_bin``)."""
    g = lambda k: _np(state_dict, k)                           # noqa: E731

    def linear(prefix):
        return {"w": g(prefix + ".weight").T, "b": g(prefix + ".bias")}

    def conv1x1(prefix):
        return {"w": g(prefix + ".weight")[:, :, 0, 0].T,
                "b": g(prefix + ".bias")}

    agg = {"score_w1": conv1x1("aggregator.score.0"),
           "score_w2": conv1x1("aggregator.score.3"),
           "feat_w1": conv1x1("aggregator.cluster_features.0"),
           "feat_w2": conv1x1("aggregator.cluster_features.3"),
           "tok_w1": linear("aggregator.token_features.0"),
           "tok_w2": linear("aggregator.token_features.2"),
           "dustbin": g("aggregator.dust_bin")}
    return VPRModel(_backbone(state_dict, cfg, dtype, device),
                    tree_module(agg, device=device))


def load_dinosalad_checkpoint(path: str, cfg: dn.DinoV2Config = dn.VIT_B14,
                              *, dtype=torch.float32,
                              device="cuda") -> VPRModel:
    return convert_dinosalad_checkpoint(_load_state_dict(path), cfg,
                                        dtype=dtype, device=device)


def extract_dinosalad_features(model: VPRModel, cfg: dn.DinoV2Config,
                               images: torch.Tensor) -> torch.Tensor:
    """Dense backbone features for the dinoSALAD h5 path, L2-normalized
    over channels."""
    return l2_normalize(extract_dinonv_features(model, cfg, images), 1)


def salad_global_descriptor(model: VPRModel, cfg: dn.DinoV2Config,
                            images: torch.Tensor) -> torch.Tensor:
    """Whole-image DINO-SALAD descriptor: backbone (patch features and
    the cls token) → SALAD."""
    tokens = dn.forward_tokens(model.backbone, cfg, images, final_norm=True)
    feats = dn.patch_features(tokens, cfg, images.shape[1:3])
    return salad_forward(model.aggregator, feats, token=tokens[:, 0])


def fit_wpca(descriptors: torch.Tensor, num_components: int,
             eps: float = 1e-9) -> Dict[str, torch.Tensor]:
    """Whitened PCA as a linear layer y = W x + b: W = diag(1/sqrt(lam +
    eps)) Uᵀ (the whitening eps additive), b = −W mu. The eigenproblem
    is the smaller of the covariance [D, D] and the gram [N, N] (the
    dual path recovers U = Xᵀ U_dual diag(1/sqrt(max(lam, 1e-9))) /
    sqrt(N − 1)). Runs in true f32 on the descriptors' device;
    eigenvectors are defined up to sign."""
    x = descriptors.float()
    n, d = x.shape
    mu = x.mean(0)
    xc = x - mu
    with f32_products():
        if d <= n:
            lam, u = torch.linalg.eigh(xc.T @ xc / (n - 1))
            order = torch.argsort(-lam, stable=True)[:num_components]
            lam, u = lam[order], u[:, order]                 # u [D, K]
        else:
            lam, ud = torch.linalg.eigh(xc @ xc.T / (n - 1))
            order = torch.argsort(-lam, stable=True)[:num_components]
            lam, ud = lam[order], ud[:, order]               # ud [N, K]
            u = (xc.T @ (ud / torch.sqrt(torch.clamp(lam, min=1e-9))[None])
                 / float(np.sqrt(np.float32(n - 1.0))))
        w = (u / torch.sqrt(lam + eps)[None, :]).T           # [K, D]
        b = -(w @ mu)
    return {"w": w, "b": b}


def bake_wpca(model: VPRModel, descriptors: torch.Tensor,
              num_pcs: int) -> VPRModel:
    """Fit the whitened PCA on ``descriptors`` and attach it to ``model``
    as its ``wpca`` layer (in place; returns ``model``)."""
    model.add_module("wpca", tree_module(
        fit_wpca(descriptors, num_pcs),
        device=next(model.parameters()).device))
    return model


def save_vladbuff_params(path: str, model: VPRModel) -> str:
    """Write the model's tree (numpy leaves, object array) as the JAX
    package's ``save_vladbuff_params`` does."""
    np.save(path, np.asarray(module_tree(model), dtype=object),
            allow_pickle=True)
    return path if path.endswith(".npy") else path + ".npy"


def load_vladbuff_params(path: str, cfg: dn.DinoV2Config = dn.VIT_B14, *,
                         dtype=torch.float32, device="cuda") -> VPRModel:
    """A tree written by either package's ``save_vladbuff_params``
    (unpickled: only files this pipeline wrote) → ``VPRModel``."""
    tree = np.load(path if path.endswith(".npy") else path + ".npy",
                   allow_pickle=True).item()
    return vpr_from_jax_params(tree, cfg, dtype=dtype, device=device)
