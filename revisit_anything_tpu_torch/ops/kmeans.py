"""KMeans (cosine or euclidean assignment) for VLAD vocabularies
(counterpart of ``revisit_anything_tpu/ops/kmeans.py``: ``_assign``,
``_kmeanspp_init``, ``kmeans_fit``).

The kmeans++ seeding draws from a ``torch.Generator`` on the data's
device, so it cannot reproduce the JAX package's ``jax.random`` stream;
:func:`kmeans_iterate` runs the Lloyd iterations from given centers, and
the tests hold it to the JAX iterations from JAX's own seeding. Every
product runs in true f32 (``ops.knn.f32_products``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from revisit_anything_tpu_torch.ops.knn import f32_products
from revisit_anything_tpu_torch.ops.vlad import l2_normalize

MODES = ("cosine", "euclidean")


def _assign(x: torch.Tensor, centers: torch.Tensor, mode: str,
            x_normalized: bool = False) -> torch.Tensor:
    """Nearest center per row: argmax of cosine, or of x·c − ‖c‖²/2 (the
    argmin of ‖x − c‖²)."""
    if mode == "cosine":
        xn = x if x_normalized else l2_normalize(x)
        return torch.argmax(xn @ l2_normalize(centers).T, dim=1)
    scores = x @ centers.T - 0.5 * (centers * centers).sum(1)
    return torch.argmax(scores, dim=1)


def _sq_dist_to_center(x: torch.Tensor, center: torch.Tensor,
                       mode: str) -> torch.Tensor:
    if mode == "cosine":
        return 1.0 - l2_normalize(x) @ l2_normalize(center, 0)
    diff = x - center
    return (diff * diff).sum(1)


def _kmeanspp_init(x: torch.Tensor, num_clusters: int,
                   generator: torch.Generator, mode: str) -> torch.Tensor:
    """kmeans++ D²-sampling: the first center uniform, each next one
    drawn with probability ∝ its squared distance to the nearest center
    so far."""
    n = x.shape[0]
    first = torch.randint(0, n, (1,), generator=generator,
                          device=x.device)[0]
    centers = torch.zeros((num_clusters, x.shape[1]), dtype=x.dtype,
                          device=x.device)
    centers[0] = x[first]
    min_d = _sq_dist_to_center(x, x[first], mode)
    for i in range(1, num_clusters):
        probs = min_d.clamp(min=0.0)
        probs = probs / probs.sum().clamp(min=1e-30) + 1e-30
        idx = torch.multinomial(probs, 1, generator=generator)[0]
        centers[i] = x[idx]
        min_d = torch.minimum(min_d, _sq_dist_to_center(x, x[idx], mode))
    return centers


def kmeans_iterate(x: torch.Tensor, centers: torch.Tensor,
                   num_iters: int = 100, mode: str = "cosine",
                   assume_normalized: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lloyd iterations from ``centers`` → (centers [C, D], labels [N]).

    Each center becomes the mean of its points; an empty cluster's center
    becomes the zero vector (fast_pytorch_kmeans' full-batch update, which
    the JAX package keeps: a dead cluster stays dead, and its zero block
    enters every VLAD). ``assume_normalized``: ``x`` is already
    L2-normalized (cosine mode skips normalizing it)."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    x = x.float()
    centers = centers.float()
    c = centers.shape[0]
    x_assign = (x if assume_normalized or mode != "cosine"
                else l2_normalize(x))
    with f32_products():
        for _ in range(num_iters):
            labels = _assign(x_assign, centers, mode, x_normalized=True)
            onehot = torch.nn.functional.one_hot(labels, c).float()
            sums = onehot.T @ x
            counts = onehot.sum(0)[:, None]
            centers = torch.where(counts > 0, sums / counts.clamp(min=1.0),
                                  torch.zeros_like(sums))
        labels = _assign(x_assign, centers, mode, x_normalized=True)
    return centers, labels


def kmeans_fit(x: torch.Tensor, num_clusters: int,
               generator: torch.Generator, num_iters: int = 100,
               mode: str = "cosine", assume_normalized: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """kmeans++ seeding from ``generator`` (on ``x``'s device), then
    :func:`kmeans_iterate`. Returns (centers [C, D], labels [N])."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    x = x.float()
    with f32_products():
        centers0 = _kmeanspp_init(x, num_clusters, generator, mode)
    return kmeans_iterate(x, centers0, num_iters, mode, assume_normalized)
