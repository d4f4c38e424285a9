"""Resizes with the reference's torch semantics, built as in
``revisit_anything_tpu/ops/resize.py``: the per-axis weight matrices and
index maps are numpy copies of the JAX package's builders (bit-identical
to them), applied to tensors in true f32.

- :func:`nearest_resize`: torch ``F.interpolate(mode='nearest')``;
- :func:`bicubic_resize_torch`: bicubic, align_corners=False (the
  position-embedding grid), with optional explicit coordinate scales;
- :func:`bilinear_resize_torch`: bilinear, align_corners=False;
- :func:`bilinear_resize_align_corners`: bilinear, align_corners=True
  (dense-feature upsampling).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from revisit_anything_tpu_torch.ops.knn import f32_products


def nearest_indices(out_size: int, in_size: int) -> np.ndarray:
    """torch 'nearest' source index: floor(dst * in/out) (asymmetric)."""
    scale = in_size / out_size
    idx = np.floor(np.arange(out_size) * scale).astype(np.int32)
    return np.minimum(idx, in_size - 1)


def nearest_resize(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Resize the last two dims of ``x`` with torch-nearest semantics."""
    in_h, in_w = x.shape[-2], x.shape[-1]
    out_h, out_w = out_hw
    if (in_h, in_w) == (out_h, out_w):
        return x
    ih = torch.from_numpy(nearest_indices(out_h, in_h).astype(np.int64))
    iw = torch.from_numpy(nearest_indices(out_w, in_w).astype(np.int64))
    return x[..., ih.to(x.device), :][..., iw.to(x.device)]


def _cubic_conv_weights(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Cubic convolution kernel weights for the 4 taps around fractional
    offset t (torch bicubic uses a = -0.75, no antialias)."""
    def w(x):
        x = np.abs(x)
        return np.where(
            x <= 1, (a + 2) * x ** 3 - (a + 3) * x ** 2 + 1,
            np.where(x < 2, a * x ** 3 - 5 * a * x ** 2 + 8 * a * x - 4 * a,
                     0.0))
    return np.stack([w(1 + t), w(t), w(1 - t), w(2 - t)], axis=-1)


def bicubic_weight_matrix(out_size: int, in_size: int,
                          a: float = -0.75,
                          coord_scale: float = None) -> np.ndarray:
    """[out, in] matrix reproducing torch F.interpolate(mode='bicubic',
    align_corners=False, antialias=False); ``coord_scale`` is an explicit
    source-coordinate scale (src = (dst + 0.5)·scale − 0.5), default
    in/out."""
    if out_size == in_size and coord_scale is None:
        return np.eye(out_size, dtype=np.float32)
    scale = in_size / out_size if coord_scale is None else coord_scale
    x = (np.arange(out_size) + 0.5) * scale - 0.5
    f = np.floor(x).astype(np.int64)
    t = x - f
    weights = _cubic_conv_weights(t, a)             # [out, 4]
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    for tap in range(4):
        idx = np.clip(f - 1 + tap, 0, in_size - 1)
        np.add.at(mat, (np.arange(out_size), idx), weights[:, tap])
    return mat.astype(np.float32)


def _mat(m: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(m).to(device)


def bicubic_resize_torch(x: torch.Tensor, out_hw: Tuple[int, int],
                         coord_scales: Tuple[float, float] = (None, None)
                         ) -> torch.Tensor:
    """Bicubic resize of the FIRST two dims of ``x`` [H, W, ...] in f32,
    matching torch bicubic (align_corners=False), with optional explicit
    per-axis source-coordinate scales."""
    in_h, in_w = x.shape[0], x.shape[1]
    out_h, out_w = out_hw
    if (in_h, in_w) == (out_h, out_w) and coord_scales == (None, None):
        return x
    wh = _mat(bicubic_weight_matrix(out_h, in_h,
                                    coord_scale=coord_scales[0]), x.device)
    ww = _mat(bicubic_weight_matrix(out_w, in_w,
                                    coord_scale=coord_scales[1]), x.device)
    with f32_products():
        y = torch.einsum("oi,ij...->oj...", wh, x.float())
        return torch.einsum("pj,oj...->op...", ww, y)


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


def bilinear_resize_torch(x: torch.Tensor,
                          out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of the LAST two dims in f32, matching torch
    F.interpolate(align_corners=False)."""
    in_h, in_w = x.shape[-2], x.shape[-1]
    out_h, out_w = out_hw
    if (in_h, in_w) == (out_h, out_w):
        return x
    wh = _mat(bilinear_weight_matrix(out_h, in_h), x.device)
    ww = _mat(bilinear_weight_matrix(out_w, in_w), x.device)
    with f32_products():
        y = torch.einsum("oi,...iw->...ow", wh, x.float())
        return torch.einsum("pw,...ow->...op", ww, y)


def _align_corners_coords(out_size: int, in_size: int) -> np.ndarray:
    """torch bilinear align_corners=True source coordinate per output index."""
    if out_size == 1 or in_size == 1:
        return np.zeros(out_size, dtype=np.float64)
    return np.arange(out_size) * (in_size - 1) / (out_size - 1)


def bilinear_resize_align_corners(x: torch.Tensor,
                                  out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of the last two dims, align_corners=True semantics
    (torch ``F.interpolate(..., mode='bilinear', align_corners=True)``),
    as gathers and two lerps in ``x``'s dtype, in the JAX package's
    arithmetic (lo + (hi − lo)·frac), the lerps in place on the gathered
    copies so an upsample to a full image holds two of them, not five."""
    in_h, in_w = x.shape[-2], x.shape[-1]
    out_h, out_w = out_hw
    if (in_h, in_w) == (out_h, out_w):
        return x

    def axis_weights(out_size, in_size):
        coords = _align_corners_coords(out_size, in_size)
        lo = np.clip(np.floor(coords).astype(np.int64), 0, in_size - 1)
        hi = np.minimum(lo + 1, in_size - 1)
        frac = (coords - lo).astype(np.float32)
        return (torch.from_numpy(lo).to(x.device),
                torch.from_numpy(hi).to(x.device),
                torch.from_numpy(frac).to(x.device))

    hlo, hhi, hfrac = axis_weights(out_h, in_h)
    wlo, whi, wfrac = axis_weights(out_w, in_w)
    dt = torch.promote_types(x.dtype, torch.float32)   # as jnp promotes
    top = x[..., hlo, :].to(dt)
    rows = x[..., hhi, :].to(dt).sub_(top).mul_(hfrac[:, None]).add_(top)
    del top
    left = rows[..., wlo]
    return rows[..., whi].sub_(left).mul_(wfrac).add_(left)
