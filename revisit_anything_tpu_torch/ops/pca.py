"""Whitened PCA: applied as one product, fitted by a randomized range
finder (counterpart of ``revisit_anything_tpu/ops/pca.py``: ``PCAParams``,
``pca_apply``, ``pca_fit``, ``pca_fit_full``, ``save_pca_npz``,
``load_pca_npz``, ``load_sklearn_pca_pickle``).

``pca_fit``'s random projection comes from a ``torch.Generator``, so it
is not the JAX package's ``jax.random`` draw; the tests hold both fits
to each other and to sklearn by explained variance and by the principal
angles between their subspaces. Every product runs in true f32
(``ops.knn.f32_products``). ``reduce_pca`` (JAX :140) is AnyLoc's helper
on :func:`pca_fit_full`.
"""

from __future__ import annotations

import pickle
from typing import NamedTuple

import numpy as np
import torch

from revisit_anything_tpu_torch.ops.knn import f32_products


class PCAParams(NamedTuple):
    mean: torch.Tensor                # [D]
    components: torch.Tensor          # [K, D]
    explained_variance: torch.Tensor  # [K]
    whiten: bool


def pca_apply(x: torch.Tensor, params: PCAParams) -> torch.Tensor:
    """sklearn's transform: ((x − mean) @ componentsᵀ) / √ev (whitened)."""
    with f32_products():
        y = (x.float() - params.mean) @ params.components.T
    if params.whiten:
        y = y / torch.sqrt(params.explained_variance)
    return y


def _params(mean, components, ev, whiten, device) -> PCAParams:
    as_t = lambda a: torch.as_tensor(                     # noqa: E731
        np.asarray(a, dtype=np.float32)).to(device)
    return PCAParams(as_t(mean), as_t(components), as_t(ev), bool(whiten))


def load_sklearn_pca_pickle(path: str, device="cuda") -> PCAParams:
    """A fitted sklearn PCA pickle → parameters on ``device`` (unpickling
    imports sklearn; only load pickles this pipeline wrote)."""
    with open(path, "rb") as f:
        pca = pickle.load(f)
    return _params(pca.mean_, pca.components_, pca.explained_variance_,
                   getattr(pca, "whiten", False), device)


def save_pca_npz(path: str, params: PCAParams) -> None:
    np.savez(path, mean=params.mean.cpu().numpy(),
             components=params.components.cpu().numpy(),
             explained_variance=params.explained_variance.cpu().numpy(),
             whiten=np.asarray(params.whiten))


def load_pca_npz(path: str, device="cuda") -> PCAParams:
    z = np.load(path)
    return _params(z["mean"], z["components"], z["explained_variance"],
                   z["whiten"], device)


def _sign_fix(components: torch.Tensor) -> torch.Tensor:
    """Each component's largest-|.| coordinate made positive."""
    idx = torch.argmax(components.abs(), dim=1)
    signs = torch.sign(components.gather(1, idx[:, None]))
    return components * signs


def pca_fit(x: torch.Tensor, num_components: int, whiten: bool = True,
            power_iters: int = 7, oversample: int = 16,
            seed: int = 0) -> PCAParams:
    """Top ``num_components`` right singular vectors of the centered data
    by a randomized range finder (Halko et al.: a Gaussian projection of
    k + ``oversample`` columns, ``power_iters`` power iterations with QR
    between, then an exact SVD of the projected rows), explained variance
    S²/(N−1), signs fixed so each component's largest-|.| entry is
    positive. Runs on ``x``'s device; deterministic given ``seed``."""
    n, d = x.shape
    k = num_components
    width = min(d, k + oversample)
    x = x.float()
    gen = torch.Generator(device=x.device).manual_seed(seed)
    with f32_products():
        mean = x.mean(0)
        xc = x - mean
        omega = torch.randn((d, width), generator=gen, device=x.device)
        q, _ = torch.linalg.qr(xc @ omega)
        for _ in range(power_iters):
            q, _ = torch.linalg.qr(xc.T @ q)
            q, _ = torch.linalg.qr(xc @ q)
        b = q.T @ xc                                   # [width, D]
        _, s, vt = torch.linalg.svd(b, full_matrices=False)
    components = _sign_fix(vt[:k])
    return PCAParams(mean, components, (s[:k] ** 2) / (n - 1), whiten)


def pca_fit_full(x: torch.Tensor) -> PCAParams:
    """Every min(N, D) component by an exact SVD of the centered data
    (sklearn ``svd_solver='full'``), signs fixed as in :func:`pca_fit`;
    not whitened."""
    x = x.float()
    n = x.shape[0]
    with f32_products():
        mean = x.mean(0)
        _, s, vt = torch.linalg.svd(x - mean, full_matrices=False)
    return PCAParams(mean, _sign_fix(vt), (s ** 2) / (n - 1), False)


def reduce_pca(train_descs, test_descs, lower_dim: int,
               low_factor: float = 0.0, fallback: int = 256,
               whitening: bool = False, device="cuda") -> tuple:
    """Train and test descriptors reduced by a PCA fit on the train set
    (AnyLoc's helper), computed on ``device``; returns numpy arrays.

    ``low_factor`` > 0 takes that fraction of the ``lower_dim`` basis
    vectors from the BOTTOM of the spectrum and the rest from the top
    (not whitened); when the train set has fewer samples than features,
    both sets are first projected to ``fallback`` dims by a PCA fit on
    their concatenation."""
    if not 0.0 <= low_factor <= 1.0:
        raise ValueError(f"low_factor {low_factor} not in [0, 1]")
    as_t = lambda a: torch.as_tensor(                     # noqa: E731
        np.asarray(a, dtype=np.float32)).to(device)
    train, test = as_t(train_descs), as_t(test_descs)
    if low_factor == 0.0:
        p = pca_fit_full(train)
        p = PCAParams(p.mean, p.components[:lower_dim],
                      p.explained_variance[:lower_dim], whitening)
        return (pca_apply(train, p).cpu().numpy(),
                pca_apply(test, p).cpu().numpy())
    n_samples, n_feat = train.shape
    if n_samples < n_feat:
        both = torch.cat([train, test])
        p = pca_fit_full(both)
        p = PCAParams(p.mean, p.components[:fallback],
                      p.explained_variance[:fallback], False)
        down = pca_apply(both, p)
        train, test = down[:n_samples], down[n_samples:]
    n_down = int(low_factor * lower_dim)
    n_up = lower_dim - n_down
    p = pca_fit_full(train)
    comps = (p.components[:lower_dim] if n_down == 0 else
             torch.cat([p.components[:n_up], p.components[-n_down:]]))
    tf = PCAParams(p.mean, comps, torch.ones(comps.shape[0], device=device),
                   False)
    return (pca_apply(train, tf).cpu().numpy(),
            pca_apply(test, tf).cpu().numpy())
