"""Trainable aggregators: NetVLAD (+AntiBurst), the pooled forms,
CosPlace, ConvAP, MixVPR, RRM, SALAD and CRN.

Counterpart of ``revisit_anything_tpu/training/aggregators.py``. Each
aggregator's parameters are a module built by ``layers.tree_module``
whose attributes carry the JAX tree's names (``assign_w`` [D, C],
``centroids`` [C, D], ``ab_params`` [3], ...), so a JAX tree converts
with :func:`from_jax_tree` and the forwards keep the JAX signatures,
with the module in the place of the tree. The ``*_init`` functions draw
seeded weights from a ``torch.Generator`` (not the JAX package's
``jax.random`` draws). GeM, MAC, SPoC and R-MAC have no parameters and
stay functions. Products run in true f32 (``ops.knn.f32_products``), as
the JAX package's ``Precision.HIGHEST``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from revisit_anything_tpu_torch.models.layers import tree_module
from revisit_anything_tpu_torch.ops.knn import f32_products
from revisit_anything_tpu_torch.ops.vlad import _EPS, l2_normalize


def from_jax_tree(tree, *, dtype=torch.float32, device="cuda") -> nn.Module:
    """Any aggregator's JAX parameter tree (numpy leaves) → its module."""
    return tree_module(tree, dtype=dtype, device=device)


def _randn(gen: torch.Generator, shape, std: float, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device).to(device) * std


def _dense(gen, n_in, n_out, device, std=0.02) -> dict:
    return {"w": _randn(gen, (n_in, n_out), std, device),
            "b": torch.zeros(n_out, device=device)}


def _ln(n, device) -> dict:
    return {"scale": torch.ones(n, device=device),
            "bias": torch.zeros(n, device=device)}


# ---------------------------------------------------------------------------
# NetVLAD (+AntiBurst)
# ---------------------------------------------------------------------------


def netvlad_init(gen: torch.Generator, dim: int, clusters: int = 64,
                 antiburst: bool = True, ab_w: float = 8.0,
                 ab_b: float = 7.0, ab_p: float = 1.0,
                 nv_pca: Optional[int] = None, nv_pca_mode: str = "rot", *,
                 device="cuda") -> nn.Module:
    """NetVLAD(+AntiBurst) parameters: ``assign_w`` (the bias-free 1x1
    conv) N(0, 0.02²), ``centroids`` N(0, 0.02²), ``ab_params`` (8, 7, 1)
    by default; ``nv_pca`` adds the learnable pre-projection ("rot": mean
    and rotation U(0, 1); "fc": a bottleneck Linear; "mlp":
    Linear-ReLU-Linear)."""
    d_eff = nv_pca if nv_pca is not None else dim
    tree = {"assign_w": _randn(gen, (d_eff, clusters), 0.02, device),
            "centroids": _randn(gen, (clusters, d_eff), 0.02, device)}
    if nv_pca is not None:
        if nv_pca_mode == "rot":
            tree["pca_mean"] = torch.rand(dim, generator=gen,
                                          device=gen.device).to(device)
            tree["pca_rot"] = torch.rand((nv_pca, dim), generator=gen,
                                         device=gen.device).to(device)
        elif nv_pca_mode == "fc":
            tree["bottleneck"] = _dense(gen, dim, nv_pca, device)
        elif nv_pca_mode == "mlp":
            tree["nv_mlp"] = {"fc1": _dense(gen, dim, nv_pca, device),
                              "fc2": _dense(gen, nv_pca, nv_pca, device)}
        else:
            raise ValueError(f"nv_pca_mode {nv_pca_mode!r}")
    if antiburst:
        tree["ab_params"] = torch.tensor([ab_w, ab_b, ab_p], device=device)
    return tree_module(tree, device=device)


def _nv_pca_project(params: nn.Module, x: torch.Tensor,
                    normalize_input: bool) -> torch.Tensor:
    """The learnable pre-projection of [B, D, P] descriptors, then the
    re-normalization over the new descriptor dim."""
    if hasattr(params, "pca_rot"):
        x = x - params.pca_mean[None, :, None]
        x = torch.einsum("bdp,kd->bkp", x, params.pca_rot)
    elif hasattr(params, "bottleneck"):
        x = (torch.einsum("bdp,dk->bkp", x, params.bottleneck.w)
             + params.bottleneck.b[None, :, None])
    elif hasattr(params, "nv_mlp"):
        m = params.nv_mlp
        x = torch.einsum("bdp,dk->bkp", x, m.fc1.w) + m.fc1.b[None, :, None]
        x = torch.relu(x)
        x = torch.einsum("bdp,dk->bkp", x, m.fc2.w) + m.fc2.b[None, :, None]
    else:
        return x
    if normalize_input:
        x = l2_normalize(x, 1)
    return x


def netvlad_init_from_cluster_centers(centers: torch.Tensor,
                                      descriptors: torch.Tensor = None,
                                      alpha: float = None,
                                      antiburst: bool = True) -> nn.Module:
    """NetVLAD from k-means centers: ``assign_w`` = alpha · normalized
    centers (no bias), alpha = −log(0.01) / mean(top1 − top2 assignment
    dot gap) over ``descriptors`` when given, else 30."""
    dev = centers.device
    cn = l2_normalize(centers.float(), 1)
    if alpha is None:
        if descriptors is not None:
            with f32_products():
                dots = cn @ descriptors.float().T
            top2 = torch.topk(dots.T, 2, dim=1).values              # [N, 2]
            gap = torch.mean(top2[:, 0] - top2[:, 1])
            alpha = float(-np.log(np.float32(0.01))
                          / torch.clamp(gap, min=1e-12).item())
        else:
            alpha = 30.0
    tree = {"assign_w": (alpha * cn).T, "centroids": centers.float()}
    if antiburst:
        tree["ab_params"] = torch.tensor([8.0, 7.0, 1.0], device=dev)
    return tree_module(tree, device=dev)


def _antiburst_weights(x_flat: torch.Tensor,
                       ab_params: torch.Tensor) -> torch.Tensor:
    """w[b, p] = (Σ_q sigmoid(w·selfDis[b, p, q] + b))^p_exp, selfDis =
    −2 + 2·xᵀx."""
    gram = torch.einsum("bdp,bdq->bpq", x_flat, x_flat)
    self_dis = -2.0 + 2.0 * gram
    w = torch.sigmoid(ab_params[0] * self_dis + ab_params[1])
    return torch.sum(w, dim=-1) ** ab_params[2]


def netvlad_forward(params: nn.Module, features: torch.Tensor,
                    normalize_input: bool = True, tp=None) -> torch.Tensor:
    """features [B, D, H, W] → [B, clusters·D] VLADs: input L2-norm over
    D, softmax soft assignment, optional AntiBurst down-weighting,
    residual aggregation, intra-norm and global L2.

    With ``tp`` (a ``parallel.collectives.MeshAxis`` over the mesh's
    "model" axis) the clusters are split over it, as the JAX train
    step's sharding splits them (``assign_w`` by columns, ``centroids``
    by rows: ``params`` holds this rank's): the softmax over clusters is
    reduced over the axis (the max, then the sum of exponentials), the
    global L2 norm comes from the all-reduced squared norms, and the
    descriptor is gathered over the axis. Residuals and intra-norms stay
    local; the AntiBurst weights come from the replicated input. A
    replicated value that meets this rank's clusters passes
    ``tp.copy_in``, whose backward sums the ranks' partial gradients."""
    b, d = features.shape[:2]
    with f32_products():
        x = features.reshape(b, d, -1).float()                # [B, D, P]
        if normalize_input:
            x = l2_normalize(x, 1)
        x = _nv_pca_project(params, x, normalize_input)
        # replicated values enter this rank's clusters through copy_in
        xc = x if tp is None else tp.copy_in(x)
        logits = torch.einsum("bdp,dc->bcp", xc, params.assign_w)
        soft_assign = (torch.softmax(logits, dim=1) if tp is None
                       else _softmax_over(logits, tp))        # [B, C, P]
        if hasattr(params, "ab_params"):
            w_burst = _antiburst_weights(x, params.ab_params)
            if tp is not None:
                w_burst = tp.copy_in(w_burst)
            soft_assign = soft_assign / w_burst[:, None, :]
        vlad = (torch.einsum("bcp,bdp->bcd", soft_assign, xc)
                - soft_assign.sum(2)[:, :, None] * params.centroids)
    vlad = l2_normalize(vlad, 2)                              # intra-norm
    if tp is None:
        return l2_normalize(vlad.reshape(b, -1), 1)
    vlad = vlad.reshape(b, -1)
    sq = _sum_over((vlad * vlad).sum(1, keepdim=True), tp)
    return tp.gather(vlad / torch.sqrt(sq).clamp(min=_EPS), 1)


def _sum_over(x: torch.Tensor, tp) -> torch.Tensor:
    """A sum over ``tp``'s ranks that each rank then uses with its own
    clusters only: the forward's all-reduce, and an all-reduce of the
    backward's partial gradients (``copy_in``)."""
    return tp.copy_in(tp.reduce_out(x))


def _softmax_over(logits: torch.Tensor, tp) -> torch.Tensor:
    """Softmax over dim 1 of clusters split over ``tp``."""
    shift = tp.all_max(logits.detach().amax(1, keepdim=True))
    e = torch.exp(logits - shift)
    return e / _sum_over(e.sum(1, keepdim=True), tp)


# ---------------------------------------------------------------------------
# Pooled forms (no parameters)
# ---------------------------------------------------------------------------


def gem_pool(features: torch.Tensor, p=3.0, eps: float = 1e-6):
    """GeM pooling: [B, D, H, W] → [B, D]."""
    x = torch.clamp(features, min=eps) ** p
    return torch.mean(x, dim=(2, 3)) ** (1.0 / p)


def mac_pool(features: torch.Tensor) -> torch.Tensor:
    """MAC: global max pool."""
    return torch.amax(features, dim=(2, 3))


def spoc_pool(features: torch.Tensor) -> torch.Tensor:
    """SPoC: global average pool."""
    return torch.mean(features, dim=(2, 3))


def rmac_pool(features: torch.Tensor, levels: int = 3,
              eps: float = 1e-6) -> torch.Tensor:
    """R-MAC with cirtorch ``rmac`` semantics: the global max-pool region,
    then per-level region grids of side floor(2·min(H, W)/(l + 1)) whose
    long-axis surplus count comes from the ~40% overlap search over steps
    2..7, each region's max-pool L2-scaled by (norm + eps), then a final
    L2. [B, D, H, W] → [B, D]."""
    b, d, hgt, wid = features.shape
    ovr = 0.4
    steps = np.array([2, 3, 4, 5, 6, 7], np.float64)
    w = min(hgt, wid)
    if max(hgt, wid) != w:
        bdist = (max(hgt, wid) - w) / (steps - 1)
        idx = int(np.argmin(np.abs((w * w - w * bdist) / (w * w) - ovr)))
    else:
        idx = -1
    wd = idx + 1 if hgt < wid else 0
    hd = idx + 1 if hgt > wid else 0

    v = torch.amax(features, dim=(2, 3))
    out = v / (torch.linalg.vector_norm(v, dim=1, keepdim=True) + eps)
    for lvl in range(1, levels + 1):
        wl = int(np.floor(2 * w / (lvl + 1)))
        if wl == 0:
            continue
        wl2 = int(np.floor(wl / 2 - 1))
        b_w = 0.0 if lvl + wd == 1 else (wid - wl) / (lvl + wd - 1)
        cen_w = (np.floor(wl2 + np.arange(lvl + wd) * b_w) - wl2).astype(int)
        b_h = 0.0 if lvl + hd == 1 else (hgt - wl) / (lvl + hd - 1)
        cen_h = (np.floor(wl2 + np.arange(lvl + hd) * b_h) - wl2).astype(int)
        for y0 in cen_h:
            for x0 in cen_w:
                vt = torch.amax(features[:, :, y0:y0 + wl, x0:x0 + wl],
                                dim=(2, 3))
                out = out + vt / (torch.linalg.vector_norm(
                    vt, dim=1, keepdim=True) + eps)
    return out / torch.clamp(torch.linalg.vector_norm(out, dim=1,
                                                      keepdim=True), min=eps)


# ---------------------------------------------------------------------------
# CosPlace, ConvAP, MixVPR, RRM
# ---------------------------------------------------------------------------


def cosplace_init(gen: torch.Generator, in_dim: int, out_dim: int, *,
                  device="cuda") -> nn.Module:
    return tree_module({"fc_w": _randn(gen, (in_dim, out_dim), 0.02, device),
                        "fc_b": torch.zeros(out_dim, device=device),
                        "gem_p": torch.tensor(3.0, device=device)},
                       device=device)


def cosplace_forward(params: nn.Module, features: torch.Tensor):
    """CosPlace: channel L2 → GeM (learnable p) → FC → L2."""
    x = gem_pool(l2_normalize(features, 1), p=params.gem_p)
    with f32_products():
        x = x @ params.fc_w + params.fc_b
    return l2_normalize(x, 1)


def convap_init(gen: torch.Generator, in_dim: int, out_dim: int = 512, *,
                device="cuda") -> nn.Module:
    return tree_module({"conv_w": _randn(gen, (in_dim, out_dim), 0.02,
                                         device),
                        "conv_b": torch.zeros(out_dim, device=device)},
                       device=device)


def _adaptive_pool_axis(x: torch.Tensor, axis: int, out_size: int,
                        in_size: int) -> torch.Tensor:
    """Adaptive average pooling along ``axis`` with torch's bin edges."""
    starts = (np.arange(out_size) * in_size) // out_size
    ends = -(-((np.arange(out_size) + 1) * in_size) // out_size)
    return torch.cat([x.narrow(axis, int(s), int(e - s)).mean(
        axis, keepdim=True) for s, e in zip(starts, ends)], dim=axis)


def convap_forward(params: nn.Module, features: torch.Tensor,
                   s1: int = 2, s2: int = 2) -> torch.Tensor:
    """ConvAP: 1x1 channel conv → adaptive s1 x s2 average pool →
    flatten → L2."""
    b, d, hgt, wid = features.shape
    with f32_products():
        x = torch.einsum("bdhw,do->bohw", features, params.conv_w)
    x = x + params.conv_b[None, :, None, None]
    x = _adaptive_pool_axis(x, 2, s1, hgt)
    x = _adaptive_pool_axis(x, 3, s2, wid)
    return l2_normalize(x.reshape(b, -1), 1)


def mixvpr_init(gen: torch.Generator, in_channels: int, in_h: int,
                in_w: int, out_channels: int = 512, mix_depth: int = 1,
                mlp_ratio: float = 1.0, out_rows: int = 4, *,
                device="cuda") -> nn.Module:
    hw = in_h * in_w
    hid = int(hw * mlp_ratio)
    mixers = [{"ln": _ln(hw, device), "fc1": _dense(gen, hw, hid, device),
               "fc2": _dense(gen, hid, hw, device)}
              for _ in range(mix_depth)]
    return tree_module({
        "mixers": mixers,
        "channel_proj": _dense(gen, in_channels, out_channels, device),
        "row_proj": _dense(gen, hw, out_rows, device)}, device=device)


def _ln_plain(x: torch.Tensor, p: nn.Module, eps: float = 1e-5):
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, unbiased=False, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p.scale + p.bias


def mixvpr_forward(params: nn.Module, features: torch.Tensor):
    """MixVPR: feature-mixer MLPs over the flattened spatial axis, then
    the channel and row projections; [B, D, H, W] → [B, out_c·rows] in
    (out_c, rows) order."""
    b, d = features.shape[:2]
    x = features.reshape(b, d, -1)                        # [B, D, HW]
    with f32_products():
        for mx in params.mixers:
            h = _ln_plain(x, mx.ln)
            h = torch.relu(h @ mx.fc1.w + mx.fc1.b)
            x = x + (h @ mx.fc2.w + mx.fc2.b)
        x = (torch.einsum("bdp,do->bpo", x, params.channel_proj.w)
             + params.channel_proj.b)                     # [B, HW, O]
        x = (torch.einsum("bpo,pr->bro", x, params.row_proj.w)
             + params.row_proj.b[:, None])                # [B, R, O]
    return l2_normalize(x.transpose(1, 2).reshape(b, -1), 1)


def rrm_init(gen: torch.Generator, dim: int, *, device="cuda") -> nn.Module:
    return tree_module({"ln1": _ln(dim, device),
                        "fc1": _dense(gen, dim, dim, device),
                        "fc2": _dense(gen, dim, dim, device),
                        "ln2": _ln(dim, device)}, device=device)


def rrm_forward(params: nn.Module, features: torch.Tensor) -> torch.Tensor:
    """Residual Retrieval Module: GAP → LN → residual MLP → LN → L2."""
    x = _ln_plain(features.mean(dim=(2, 3)), params.ln1)
    with f32_products():
        h = (torch.relu(x @ params.fc1.w + params.fc1.b) @ params.fc2.w
             + params.fc2.b)
    return l2_normalize(_ln_plain(x + h, params.ln2), 1)


# ---------------------------------------------------------------------------
# SALAD (Sinkhorn optimal-transport assignment)
# ---------------------------------------------------------------------------


def salad_init(gen: torch.Generator, dim: int, num_clusters: int = 64,
               cluster_dim: int = 128, token_dim: int = 256, *,
               device="cuda") -> nn.Module:
    return tree_module({
        "score_w1": _dense(gen, dim, 512, device),
        "score_w2": _dense(gen, 512, num_clusters, device),
        "feat_w1": _dense(gen, dim, 512, device),
        "feat_w2": _dense(gen, 512, cluster_dim, device),
        "tok_w1": _dense(gen, dim, 512, device),
        "tok_w2": _dense(gen, 512, token_dim, device),
        "dustbin": torch.tensor(1.0, device=device)}, device=device)


def _log_optimal_transport(scores: torch.Tensor, dustbin: torch.Tensor,
                           iters: int = 3) -> torch.Tensor:
    """SuperGlue log-space optimal transport in f32: a dustbin row
    appended, marginals mu = [1/(m+n)]·m + (n−m)/(m+n), nu = [1/(m+n)]·n,
    ``iters`` Sinkhorn iterations, then Z − norm."""
    b, m, n = scores.shape
    if n <= m:
        raise ValueError(
            f"SALAD optimal transport needs more patches ({n}) than "
            f"clusters ({m}): the dustbin marginal is log(n-m)")
    dev = scores.device
    bins = dustbin.to(scores.dtype).expand(b, 1, n)
    couplings = torch.cat([scores, bins], dim=1)          # [B, m+1, n]
    norm = -float(np.log(np.float32(m + n)))
    log_mu = torch.cat([torch.full((m,), norm, device=dev),
                        torch.tensor([float(np.log(np.float32(n - m)))
                                      + norm], device=dev)])
    log_nu = torch.full((n,), norm, device=dev)
    u = torch.zeros((b, m + 1), device=dev)
    v = torch.zeros((b, n), device=dev)
    for _ in range(iters):
        u = log_mu[None] - torch.logsumexp(couplings + v[:, None, :], dim=2)
        v = log_nu[None] - torch.logsumexp(couplings + u[:, :, None], dim=1)
    return couplings + u[:, :, None] + v[:, None, :] - norm


def salad_forward(params: nn.Module, features: torch.Tensor,
                  token: Optional[torch.Tensor] = None,
                  sinkhorn_iters: int = 3) -> torch.Tensor:
    """[B, D, H, W] (+ an optional [B, D] global token) → the SALAD
    descriptor [B, token_dim + cluster_dim·num_clusters], flattened in
    (cluster_dim, num_clusters) order."""
    b, d = features.shape[:2]
    x = features.reshape(b, d, -1).transpose(1, 2).float()   # [B, P, D]

    def mlp(h, w1, w2):
        return torch.relu(h @ w1.w + w1.b) @ w2.w + w2.b

    with f32_products():
        scores = mlp(x, params.score_w1, params.score_w2).transpose(1, 2)
        feats = mlp(x, params.feat_w1, params.feat_w2)        # [B, P, l]
        log_p = _log_optimal_transport(scores, params.dustbin,
                                       sinkhorn_iters)
        p_assign = torch.exp(log_p)[:, :-1, :]                # [B, C, P]
        agg = torch.einsum("bpl,bmp->blm", feats, p_assign)
        agg = l2_normalize(agg, 1).reshape(b, -1)
        if token is None:
            token = x.mean(1)
        tok = l2_normalize(mlp(token.float(), params.tok_w1,
                               params.tok_w2), 1)
    return l2_normalize(torch.cat([tok, agg], dim=1), 1)


# ---------------------------------------------------------------------------
# CRN (Contextual Reweighting Network)
# ---------------------------------------------------------------------------


CRN_FROZEN = ("acc_w", "acc_b")


def crn_init(gen: torch.Generator, dim: int, clusters: int = 64, *,
             device="cuda") -> nn.Module:
    """NetVLAD parameters plus the CRN context module: 3x3/5x5/7x7
    context filters (HWIO, xavier-normal, zero bias) and the FIXED 1x1
    accumulation conv (weights 1, bias 0), which keeps
    ``requires_grad=False`` whatever the trainer does."""
    nv = netvlad_init(gen, dim, clusters, antiburst=False, device=device)

    def xavier(shape):
        fan_in = shape[0] * shape[1] * shape[2]
        fan_out = shape[0] * shape[1] * shape[3]
        return _randn(gen, shape, (2.0 / (fan_in + fan_out)) ** 0.5, device)

    crn = {"f3": {"w": xavier((3, 3, dim, 32)),
                  "b": torch.zeros(32, device=device)},
           "f5": {"w": xavier((5, 5, dim, 32)),
                  "b": torch.zeros(32, device=device)},
           "f7": {"w": xavier((7, 7, dim, 20)),
                  "b": torch.zeros(20, device=device)},
           "acc_w": torch.ones((84, 1), device=device),
           "acc_b": torch.zeros(1, device=device)}
    nv.add_module("crn", tree_module(crn, device=device))
    return nv


def _avgpool_3x3_s2_ceil(x: torch.Tensor) -> torch.Tensor:
    """AvgPool2d(kernel 3, stride 2, padding 0, ceil_mode=True): windows
    that overhang the input average only their valid elements."""
    return F.avg_pool2d(x, 3, stride=2, padding=0, ceil_mode=True)


def _conv_same(x: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """NCHW convolution with HWIO weights, SAME padding (odd kernels)."""
    with f32_products():
        y = F.conv2d(x, w.permute(3, 2, 0, 1), padding=w.shape[0] // 2)
    return y + b[None, :, None, None]


def crn_forward(params: nn.Module, features: torch.Tensor,
                normalize_input: bool = True) -> torch.Tensor:
    """CRN: the soft assignment reweighted by a contextual mask (avg-pool
    downsample, multiscale context convs, relu, the fixed 1x1
    accumulation, relu, 2x bilinear upsample). Needs an even H and W."""
    from revisit_anything_tpu_torch.ops.resize import bilinear_resize_torch
    b, d, h, w = features.shape
    if h % 2 or w % 2:
        raise ValueError("CRN needs an even patch grid")
    x = l2_normalize(features, 1) if normalize_input else features
    crn = params.crn
    xd = _avgpool_3x3_s2_ceil(x)
    g = torch.relu(torch.cat([_conv_same(xd, crn.f3.w, crn.f3.b),
                              _conv_same(xd, crn.f5.w, crn.f5.b),
                              _conv_same(xd, crn.f7.w, crn.f7.b)], dim=1))
    with f32_products():
        acc = (torch.einsum("bchw,co->bohw", g, crn.acc_w)
               + crn.acc_b[None, :, None, None])
        mask = bilinear_resize_torch(torch.relu(acc), (h, w))
        x_flat = x.reshape(b, d, -1)
        soft_assign = torch.softmax(
            torch.einsum("bdp,dc->bcp", x_flat, params.assign_w), dim=1)
        soft_assign = soft_assign * mask.reshape(b, 1, h * w)
        vlad = (torch.einsum("bcp,bdp->bcd", soft_assign, x_flat)
                - soft_assign.sum(2)[:, :, None] * params.centroids)
    vlad = l2_normalize(vlad, 2)
    return l2_normalize(vlad.reshape(b, -1), 1)
