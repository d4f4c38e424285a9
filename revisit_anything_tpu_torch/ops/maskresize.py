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

from typing import Optional, Tuple

import torch

from revisit_anything_tpu_torch.kernels.build import (RESIZE_FLAGS,
                                                      RESIZE_FLAGS_F32,
                                                      operand)
from revisit_anything_tpu_torch.ops.attention import kernel_dtype


def resize_logits_reference(lowres_blk: torch.Tensor, wh: torch.Tensor,
                            ww: torch.Tensor,
                            grid_hw: Tuple[int, int]) -> torch.Tensor:
    """The plain resize: lowres_blk [Np, gh·g, 16, M] block-layout logits,
    wh [H, 4gh] (rounded to the logits' dtype, as the JAX path does),
    ww [W, 4g] f32 → logits [Np, M, H, W] f32. Both contractions run in
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
    return torch.einsum("pjbd,nojbdm->nmop", ww_blk, m)


def resize_flags_reference(lowres_blk: torch.Tensor, wh: torch.Tensor,
                           ww: torch.Tensor, thr: float, off: float,
                           grid_hw: Tuple[int, int]) -> torch.Tensor:
    """Plain version: :func:`resize_logits_reference` thresholded →
    flags [Np, M, H, W] uint8."""
    m = resize_logits_reference(lowres_blk, wh, ww, grid_hw)
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


def near_threshold(logits: torch.Tensor, thresholds, tol: float
                   ) -> torch.Tensor:
    """Pixels of plain f32 logits (:func:`resize_logits_reference`) that
    lie within ``tol`` of the logits' largest |value| from one of
    ``thresholds``: the only pixels whose flags an f32 summation-order
    change (the f32 kernel against its plain version) may flip."""
    band = tol * float(logits.abs().max())
    return torch.stack([(logits - t).abs() <= band for t in thresholds]
                       ).any(0)


# the kernel's limits: taps a row and a column, the logits' largest grid
# width, masks, output width
TAPS, GRID, MAX_MASKS, MAX_W = 3, 64, 4, 8192


def tap_table(mat, round_to: Optional[torch.dtype] = None,
              monotone: bool = False) -> torch.Tensor:
    """The banded matrix mat [R, K] as the kernel's tap table [R, 4] f32
    on the host: per row (first tap k0 as a float, w[k0], w[k0+1],
    w[k0+2]), with k0 ≤ K − 3 so that all three taps lie inside the row.
    ``round_to`` rounds the weights first (the row pass multiplies bf16
    weights, as the reference does); ``monotone`` requires k0 to be
    non-decreasing (the row pass slides down the rows), and an empty row
    takes the previous row's k0. Raises ValueError for a row whose
    non-zeros span more than 3 columns."""
    m = torch.as_tensor(mat).detach().to("cpu", torch.float32)
    if round_to is not None:
        m = m.to(round_to).float()
    rows, k = m.shape
    if k < TAPS:
        raise ValueError(f"resize matrix {tuple(m.shape)}: fewer than "
                         f"{TAPS} columns")
    nz = m != 0
    has = nz.any(1)
    first = nz.to(torch.int64).argmax(1)
    last = k - 1 - nz.flip(1).to(torch.int64).argmax(1)
    if bool(((last - first + 1 > TAPS) & has).any()):
        raise ValueError(f"resize matrix {tuple(m.shape)}: a row spans more "
                         f"than {TAPS} taps; the kernel was not built for it")
    k0 = torch.where(has, first.clamp(max=k - TAPS), 0)
    if monotone:
        if bool((k0[has].diff() < 0).any()):
            raise ValueError("resize matrix: first taps decrease down the "
                             "rows; the kernel was not built for it")
        k0 = torch.cummax(k0, 0).values
    w = m.gather(1, k0[:, None] + torch.arange(TAPS))
    return torch.cat([k0[:, None].float(), w], 1).contiguous()


def resize_taps(wh, ww, dtype: torch.dtype = torch.bfloat16
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tap tables (host, f32) of wh [H, 4gh] (weights rounded to the
    logits' ``dtype``) and ww [W, 4g] for :func:`fused_resize_flags`."""
    return (tap_table(wh, round_to=dtype, monotone=True), tap_table(ww))


def fused_resize_flags(lowres_blk: torch.Tensor, wh: torch.Tensor,
                       ww: torch.Tensor, thr: float, off: float,
                       grid_hw: Tuple[int, int],
                       taps: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """Resize block-layout logits to [H, W], threshold, and reduce.

    Returns (flags [Np, M, H, W] uint8, rowst [Np, M, H, 3] int32,
    colany [Np, M, W] uint8). CUDA: kernel K4 by the logits' dtype, bf16
    or f32 (the column pass in true f32) over ``taps`` = :func:`resize_taps`
    of (wh, ww) at the logits' dtype, on the logits' device (built here,
    through the host, when not given); other dtypes raise. CPU:
    :func:`resize_flags_reference` and :func:`flag_stats`.

    The kernel takes g ≤ 64, gh ≤ g, 1-4 masks, any H and W ≤ 8192, and
    at most 3 adjacent taps a row of wh and of ww; it raises ValueError on
    anything else."""
    if not lowres_blk.is_cuda:
        flags = resize_flags_reference(lowres_blk, wh, ww, thr, off, grid_hw)
        return (flags,) + flag_stats(flags)
    np_, gg, sixteen, n_masks = lowres_blk.shape
    gh, g = grid_hw
    h, w = wh.shape[0], ww.shape[0]
    if sixteen != 16 or gh * g != gg:
        raise ValueError(f"logits {tuple(lowres_blk.shape)} do not match "
                         f"grid {grid_hw}")
    if (not 1 <= g <= GRID or not 1 <= gh <= g
            or not 1 <= n_masks <= MAX_MASKS
            or not 1 <= w <= MAX_W or h < 1 or np_ < 1
            or tuple(wh.shape) != (h, 4 * gh) or tuple(ww.shape) != (w, 4 * g)):
        raise ValueError(
            f"resize_flags: logits {tuple(lowres_blk.shape)} on grid "
            f"{grid_hw} to {h}x{w}: the kernel was not built for it (g <= "
            f"{GRID}, gh <= g, 1-{MAX_MASKS} masks, W <= {MAX_W})")
    dev = lowres_blk.device
    dt = kernel_dtype("resize_flags", lowres_blk)
    if taps is None:
        taps = tuple(t.to(dev) for t in resize_taps(wh, ww, dt))
    f32 = torch.float32
    lx = operand("logits", lowres_blk, dt)
    htap = operand("h_taps", taps[0], f32, (h, 4))
    wtap = operand("w_taps", taps[1], f32, (w, 4))
    flags = torch.empty((np_, n_masks, h, w), dtype=torch.uint8, device=dev)
    rowst = torch.empty((np_, n_masks, h, 3), dtype=torch.int32, device=dev)
    colany = torch.empty((np_, n_masks, w), dtype=torch.uint8, device=dev)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    (RESIZE_FLAGS_F32 if dt == f32 else RESIZE_FLAGS).launch(
        lx.data_ptr(), htap.data_ptr(), wtap.data_ptr(), flags.data_ptr(),
        rowst.data_ptr(), colany.data_ptr(), np_, gh, g, n_masks, h, w,
        float(thr - off), float(thr), float(thr + off), n_sm)
    return flags, rowst, colany
