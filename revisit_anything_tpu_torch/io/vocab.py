"""Vocabulary (cluster-center) files (counterpart of
``revisit_anything_tpu/io/vocab.py``): the reference's torch-saved
``c_centers.pt``, or ``.npy`` / ``.npz`` (key ``c_centers``)."""

from __future__ import annotations

import os

import numpy as np
import torch


def load_cluster_centers(path: str) -> np.ndarray:
    """Load cluster centers (.pt, .npy or .npz) → float32 [C, D]."""
    if path.endswith(".npy"):
        arr = np.load(path)
    elif path.endswith(".npz"):
        arr = np.load(path)["c_centers"]
    else:
        arr = torch.load(path, map_location="cpu", weights_only=True).numpy()
    arr = np.asarray(arr, dtype=np.float32)
    if arr.ndim != 2:
        raise ValueError(f"cluster centers must be 2-D, got {arr.shape}")
    return arr


def save_cluster_centers(path: str, centers: np.ndarray) -> None:
    """Save centers in the reference's .pt format (or .npy)."""
    if os.path.dirname(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
    centers = np.asarray(centers, dtype=np.float32)
    if path.endswith(".npy"):
        np.save(path, centers)
    else:
        torch.save(torch.from_numpy(centers), path)
