"""Vocabulary (kmeans centers) and PCA fitting stages (counterpart of
``revisit_anything_tpu/pipeline/vocabulary.py``).

Sampling follows the reference: above 2000 images, 30% of them and
every 2nd pixel in height and width; the PCA takes at most 50k segments,
each with probability 50000/N. Both samples draw from numpy's RNG as the
JAX package does, so the port picks the same descriptors and segments.
The kmeans++ seeding and the PCA's random projection draw from
``torch.Generator``s instead of ``jax.random``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from revisit_anything_tpu_torch.config import NUM_CLUSTERS, PCA_DIM
from revisit_anything_tpu_torch.io.h5io import open_h5, read_dino_features
from revisit_anything_tpu_torch.ops.kmeans import kmeans_fit
from revisit_anything_tpu_torch.ops.pca import PCAParams, pca_fit
from revisit_anything_tpu_torch.ops.vlad import l2_normalize
from revisit_anything_tpu_torch.pipeline.aggregate import SegmentBank


def sample_descriptors_from_h5(dino_h5_path: str,
                               image_keys: Sequence[str],
                               large_set_threshold: int = 2000,
                               image_fraction: float = 0.3,
                               pixel_stride: int = 2,
                               seed: int = 42) -> np.ndarray:
    """Dense descriptors [N, D] f32 for vocabulary training, with the
    reference's subsampling."""
    rng = np.random.default_rng(seed)
    keys = list(image_keys)
    stride = 1
    if len(keys) > large_set_threshold:
        keys = [keys[i] for i in
                sorted(rng.choice(len(keys),
                                  int(len(keys) * image_fraction),
                                  replace=False))]
        stride = pixel_stride
    chunks = []
    with open_h5(dino_h5_path) as f:
        for key in keys:
            feats = read_dino_features(f, key)[0][:, ::stride, ::stride]
            chunks.append(feats.reshape(feats.shape[0], -1).T)   # [P, D]
    return np.concatenate(chunks).astype(np.float32)


def fit_vocabulary(descriptors, num_clusters: int = NUM_CLUSTERS,
                   seed: int = 0, num_iters: int = 100,
                   device="cuda") -> np.ndarray:
    """Cosine kmeans over the L2-normalized descriptors [N, D] (numpy or
    a tensor) on ``device`` → [C, D] centers."""
    x = l2_normalize(torch.as_tensor(descriptors, device=device).float(), 1)
    gen = torch.Generator(device=x.device).manual_seed(seed)
    centers, _ = kmeans_fit(x, num_clusters, gen, num_iters=num_iters,
                            mode="cosine", assume_normalized=True)
    return centers.cpu().numpy()


def fit_vocabulary_from_h5(dino_h5_path: str, image_keys: Sequence[str],
                           num_clusters: int = NUM_CLUSTERS, seed: int = 42,
                           device="cuda") -> np.ndarray:
    descs = sample_descriptors_from_h5(dino_h5_path, image_keys, seed=seed)
    return fit_vocabulary(descs, num_clusters, seed=seed, device=device)


def fit_pca_from_vlads(bank: SegmentBank, num_components: int = PCA_DIM,
                       max_segments: int = 50000, seed: int = 42,
                       whiten: bool = True, device="cuda") -> PCAParams:
    """The whitened PCA of a segment bank, fitted on ≤ ``max_segments``
    of its rows, with min(num_components, rows − 1, dim) components."""
    x = bank.descriptors
    n = len(x)
    if n > max_segments:
        x = x[np.random.default_rng(seed).random(n) < (max_segments / n)]
    k = min(num_components, x.shape[0] - 1, x.shape[1])
    return pca_fit(torch.as_tensor(x, device=device), k, whiten=whiten,
                   seed=seed)
