"""Determinism helpers (counterpart of
``revisit_anything_tpu/utils/seeding.py``)."""

from __future__ import annotations

import random

import numpy as np
import torch


def seed_everything(seed: int = 42) -> np.random.Generator:
    """Seed Python's and numpy's global generators and torch's (every CUDA
    device's too, when there is one); return a fresh numpy Generator,
    the JAX package's stream for the same seed."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)          # seeds the CUDA generators as well
    return np.random.default_rng(seed)
