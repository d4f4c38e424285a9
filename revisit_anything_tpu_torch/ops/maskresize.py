"""Mask resize + threshold flags + stats, kernel K4 beside its plain
version.

Counterpart of ``revisit_anything_tpu/ops/maskresize.py``
``fused_resize_flags`` (:138, ``emit_stats=True``) and
``resize_flags_reference`` (:224). Flags are uint8 with bit0 = logits >
thr−off, bit1 = logits > thr (the mask), bit2 = logits > thr+off.

Stats use the port's own layout: ``rowst`` [Np, M, H, 3] int32 = (row has
a mask pixel, per-row count of bit2, per-row count of bit0) and
``colany`` [Np, M, W] uint8 = column has a mask pixel. Both are exact
integer reductions of the flags.
"""

from __future__ import annotations

from typing import Tuple

import torch

from revisit_anything_tpu_torch.kernels.build import RESIZE_FLAGS, operand


def resize_flags_reference(lowres_blk: torch.Tensor, wh: torch.Tensor,
                           ww: torch.Tensor, thr: float, off: float,
                           grid_hw: Tuple[int, int]) -> torch.Tensor:
    """Plain version: lowres_blk [Np, gh·g, 16, M] block-layout logits,
    wh [H, 4gh] (rounded to the logits' dtype, as the JAX path does),
    ww [W, 4g] f32 → flags [Np, M, H, W] uint8. Both contractions run in
    f32 (bf16 products are exact in f32)."""
    np_, gg, _, n_masks = lowres_blk.shape
    gh, g = grid_hw
    if gh * g != gg:
        raise ValueError(f"grid {grid_hw} does not match {gg} positions")
    h, w = wh.shape[0], ww.shape[0]
    wh_blk = wh.to(lowres_blk.dtype).float().reshape(h, gh, 2, 2)
    ww_blk = ww.float().reshape(w, g, 2, 2)
    m = lowres_blk.float().reshape(np_, gh, g, 2, 2, 2, 2, n_masks)
    m = torch.einsum("oiac,nijabcdm->nojbdm", wh_blk, m)
    m = torch.einsum("pjbd,nojbdm->nmop", ww_blk, m)
    return ((m > thr - off).to(torch.uint8)
            + (m > thr).to(torch.uint8) * 2
            + (m > thr + off).to(torch.uint8) * 4)


def flag_stats(flags: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stats of a flag image [Np, M, H, W] in the layout the kernel emits."""
    mask = (flags & 2) != 0
    rowst = torch.stack([mask.any(-1).to(torch.int32),
                         (flags >> 2).sum(-1, dtype=torch.int32),
                         (flags & 1).sum(-1, dtype=torch.int32)], dim=-1)
    return rowst, mask.any(-2).to(torch.uint8)


def tap_ranges(mat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per row of mat [R, K]: [lo, hi) spanning its non-zero entries
    (empty rows give [0, 0)), int32 on mat's device."""
    nz = mat != 0
    k = mat.shape[1]
    has = nz.any(1)
    first = nz.to(torch.int32).argmax(1)
    last = k - 1 - nz.flip(1).to(torch.int32).argmax(1)
    zero = torch.zeros_like(first)
    lo = torch.where(has, first, zero).to(torch.int32)
    hi = torch.where(has, last + 1, zero).to(torch.int32)
    return lo.contiguous(), hi.contiguous()


def fused_resize_flags(lowres_blk: torch.Tensor, wh: torch.Tensor,
                       ww: torch.Tensor, thr: float, off: float,
                       grid_hw: Tuple[int, int]):
    """Resize block-layout logits to [H, W], threshold, and reduce.

    Returns (flags [Np, M, H, W] uint8, rowst [Np, M, H, 3] int32,
    colany [Np, M, W] uint8). CUDA: kernel K4 (bf16 logits; the column
    pass in true f32). CPU: :func:`resize_flags_reference` and
    :func:`flag_stats`."""
    if not lowres_blk.is_cuda:
        flags = resize_flags_reference(lowres_blk, wh, ww, thr, off, grid_hw)
        return (flags,) + flag_stats(flags)
    np_, gg, sixteen, n_masks = lowres_blk.shape
    gh, g = grid_hw
    h, w = wh.shape[0], ww.shape[0]
    if sixteen != 16 or gh * g != gg:
        raise ValueError(f"logits {tuple(lowres_blk.shape)} do not match "
                         f"grid {grid_hw}")
    bf = torch.bfloat16
    lx = operand("logits", lowres_blk, bf)
    whd = operand("wh", wh.to(bf), bf, (h, 4 * gh))
    wwf = operand("ww", ww.float(), torch.float32, (w, 4 * g))
    h_lo, h_hi = tap_ranges(whd)
    w_lo, w_hi = tap_ranges(wwf)
    dev = lowres_blk.device
    flags = torch.empty((np_, n_masks, h, w), dtype=torch.uint8, device=dev)
    rowst = torch.empty((np_, n_masks, h, 3), dtype=torch.int32, device=dev)
    colany = torch.empty((np_, n_masks, w), dtype=torch.uint8, device=dev)
    RESIZE_FLAGS.launch(lx.data_ptr(), whd.data_ptr(), wwf.data_ptr(),
                        h_lo.data_ptr(), h_hi.data_ptr(), w_lo.data_ptr(),
                        w_hi.data_ptr(), flags.data_ptr(), rowst.data_ptr(),
                        colany.data_ptr(), np_, gh, g, n_masks, h, w,
                        float(thr), float(off))
    return flags, rowst, colany
