"""2D sine-cosine position embeddings (MAE-style): a numpy copy of
``revisit_anything_tpu/ops/posembed.py``, held bit-identical to it by
``tests/test_torch_backbones.py`` (the port cannot import the JAX
package). Host-side numpy: the embeddings are constants."""

from __future__ import annotations

import numpy as np


def get_1d_sincos_pos_embed_from_grid(embed_dim: int,
                                      pos: np.ndarray) -> np.ndarray:
    """[M] positions → [M, D] (first half sin, second half cos)."""
    assert embed_dim % 2 == 0
    omega = np.arange(embed_dim // 2, dtype=np.float64)
    omega /= embed_dim / 2.0
    omega = 1.0 / 10000 ** omega
    out = np.einsum("m,d->md", pos.reshape(-1).astype(np.float64), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def get_2d_sincos_pos_embed_from_grid(embed_dim: int,
                                      grid: np.ndarray) -> np.ndarray:
    assert embed_dim % 2 == 0
    emb_h = get_1d_sincos_pos_embed_from_grid(embed_dim // 2, grid[0])
    emb_w = get_1d_sincos_pos_embed_from_grid(embed_dim // 2, grid[1])
    return np.concatenate([emb_h, emb_w], axis=1)


def get_2d_sincos_pos_embed(embed_dim: int, grid_size: int,
                            cls_token: bool = False) -> np.ndarray:
    """[grid², D] (or [1+grid², D] with a zero cls row)."""
    coords = np.arange(grid_size, dtype=np.float32)
    grid = np.stack(np.meshgrid(coords, coords), axis=0)  # w first
    grid = grid.reshape(2, 1, grid_size, grid_size)
    pos = get_2d_sincos_pos_embed_from_grid(embed_dim, grid)
    if cls_token:
        pos = np.concatenate([np.zeros((1, embed_dim)), pos], axis=0)
    return pos
