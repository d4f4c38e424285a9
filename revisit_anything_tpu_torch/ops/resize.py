"""Resize helpers: the per-axis bilinear weight matrix (numpy copy of
``revisit_anything_tpu/ops/resize.py``) and the nearest-index map.

The port cannot import the JAX package (its ``__init__`` imports JAX), so
these small numpy builders are carried here; they must stay bit-identical
to the JAX package's."""

from __future__ import annotations

import numpy as np


def nearest_indices(out_size: int, in_size: int) -> np.ndarray:
    """torch 'nearest' source index: floor(dst * in/out) (asymmetric)."""
    scale = in_size / out_size
    idx = np.floor(np.arange(out_size) * scale).astype(np.int32)
    return np.minimum(idx, in_size - 1)


def bilinear_weight_matrix(out_size: int, in_size: int) -> np.ndarray:
    """[out, in] matrix reproducing torch F.interpolate(mode='bilinear',
    align_corners=False, antialias=False) along one axis."""
    if out_size == in_size:
        return np.eye(out_size, dtype=np.float32)
    scale = in_size / out_size
    x = (np.arange(out_size) + 0.5) * scale - 0.5
    x = np.clip(x, 0.0, in_size - 1)
    lo = np.floor(x).astype(np.int64)
    lo = np.clip(lo, 0, in_size - 1)
    hi = np.minimum(lo + 1, in_size - 1)
    t = x - lo
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    np.add.at(mat, (np.arange(out_size), lo), 1.0 - t)
    np.add.at(mat, (np.arange(out_size), hi), t)
    return mat.astype(np.float32)
