"""Port parity: kernel K4 (resize + flags + stats) against the JAX
package's ``fused_resize_flags`` (Pallas, interpret mode, HIGHEST column
precision, ``emit_stats``) and ``resize_flags_reference``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from revisit_anything_tpu.ops.maskresize import (fused_resize_flags,
                                                 resize_flags_reference)
from revisit_anything_tpu.ops.resize import bilinear_weight_matrix
from revisit_anything_tpu_torch.ops import maskresize as mr
from revisit_anything_tpu_torch.ops.resize import (
    bilinear_weight_matrix as port_bilinear)

torch.set_float32_matmul_precision("highest")


def _setup(h, w, gh=8, g=8, np_=3, seed=0):
    rng = np.random.default_rng(seed)
    lowres = (rng.standard_normal((np_, gh * g, 16, 3)) * 4.0).astype(
        np.float32)
    up = bilinear_weight_matrix(4 * g, 4 * g)
    wh = (bilinear_weight_matrix(h, 4 * g) @ up)[:, :4 * gh]
    ww = bilinear_weight_matrix(w, 4 * g) @ up
    return lowres, wh.astype(np.float32), ww.astype(np.float32)


def test_bilinear_matrix_is_bit_identical():
    for out, inp in ((240, 196), (320, 256), (1024, 256), (5, 9)):
        np.testing.assert_array_equal(port_bilinear(out, inp),
                                      bilinear_weight_matrix(out, inp))


@pytest.mark.parametrize("h,w,gh", [(30, 40, 8), (25, 50, 6), (64, 20, 8)])
def test_flags_and_stats_match_jax_kernel(h, w, gh):
    lowres, wh, ww = _setup(h, w, gh=gh)
    flags, rowst, colst = map(np.asarray, fused_resize_flags(
        jnp.asarray(lowres), wh, ww, 0.0, 1.0, grid_hw=(gh, 8),
        interpret=True, col_precision="highest", emit_stats=True))
    pf, prow, pcol = (x.numpy() for x in mr.fused_resize_flags(
        torch.from_numpy(lowres), torch.from_numpy(wh),
        torch.from_numpy(ww), 0.0, 1.0, grid_hw=(gh, 8)))
    np.testing.assert_array_equal(pf, flags)
    # JAX stats: rowst [Np, H, 16] lanes m / 4+m / 8+m, colst [Np, 8, W]
    for m in range(3):
        np.testing.assert_array_equal(prow[:, m, :, 0], rowst[:, :, m] > 0)
        np.testing.assert_array_equal(prow[:, m, :, 1], rowst[:, :, 4 + m])
        np.testing.assert_array_equal(prow[:, m, :, 2], rowst[:, :, 8 + m])
        np.testing.assert_array_equal(pcol[:, m] > 0, colst[:, m] > 0)


def test_reference_matches_jax_reference():
    lowres, wh, ww = _setup(30, 40)
    want = np.asarray(resize_flags_reference(jnp.asarray(lowres), wh, ww,
                                             0.0, 1.0))
    got = mr.resize_flags_reference(torch.from_numpy(lowres),
                                    torch.from_numpy(wh),
                                    torch.from_numpy(ww), 0.0, 1.0,
                                    grid_hw=(8, 8)).numpy()
    np.testing.assert_array_equal(got, want)


def _dense_from_taps(tab, k):
    """The dense [R, k] matrix a tap table [R, 4] stands for."""
    tab = tab.numpy()
    out = np.zeros((tab.shape[0], k), np.float32)
    for r, (k0, *w) in enumerate(tab):
        assert k0 == int(k0) and 0 <= k0 <= k - mr.TAPS
        out[r, int(k0):int(k0) + mr.TAPS] = w
    return out


def _amg_mats(orig_hw):
    from revisit_anything_tpu_torch.models.sam import SAM_VIT_H
    from revisit_anything_tpu_torch.models.sam.amg import (
        resize_longest_side, resize_mats_and_rows)
    input_hw = resize_longest_side(*orig_hw, 1024)
    wh, ww, _ = resize_mats_and_rows(SAM_VIT_H, input_hw, orig_hw)
    return wh, ww


# the 17places shape (240x320 from a 768x1024 input) and the three shapes
# of the parity test above
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", ["17places", (30, 40, 8), (25, 50, 6),
                                   (64, 20, 8)])
def test_tap_tables_rebuild_the_dense_matrices(shape, dtype):
    """K4's tap tables hold every non-zero of wh (rounded to the logits'
    dtype, as the JAX package rounds its row matrix: bf16, or f32 kept
    exactly) and ww exactly, in rows of 3 adjacent taps whose first tap
    never decreases down wh's rows."""
    if shape == "17places":
        wh, ww = _amg_mats((240, 320))
    else:
        _, wh, ww = _setup(*shape[:2], gh=shape[2])
    htab, wtab = mr.resize_taps(wh, ww, dtype)
    # JAX's row matrix at that dtype (ops/maskresize.py:188)
    wh_d = np.asarray(jnp.asarray(wh, jnp.bfloat16 if dtype == torch.bfloat16
                                  else jnp.float32), np.float32)
    np.testing.assert_array_equal(_dense_from_taps(htab, wh.shape[1]), wh_d)
    np.testing.assert_array_equal(_dense_from_taps(wtab, ww.shape[1]), ww)
    assert (np.diff(htab[:, 0].numpy()) >= 0).all()
    if dtype == torch.float32:
        np.testing.assert_array_equal(wh_d, wh)


def test_amg_keeps_the_taps_of_each_logits_dtype_apart():
    """AMG's K4 tap tables are cached per (shape, logits dtype): an f32
    SAM and a bf16 SAM in one process do not share one table, and the two
    differ (the bf16 one rounds wh's weights, the f32 one keeps them)."""
    from revisit_anything_tpu_torch.models.sam import SAM_VIT_H
    from revisit_anything_tpu_torch.models.sam.amg import (
        amg_taps, resize_longest_side, resize_mats_and_rows)
    key = (SAM_VIT_H, resize_longest_side(240, 320, 1024), (240, 320))
    h_bf, w_bf = amg_taps(key, "cpu", torch.bfloat16)
    h_32, w_32 = amg_taps(key, "cpu", torch.float32)
    assert h_bf is not h_32
    assert not torch.equal(h_bf, h_32)
    assert torch.equal(w_bf, w_32)
    wh = resize_mats_and_rows(*key)[0]
    np.testing.assert_array_equal(_dense_from_taps(h_32, wh.shape[1]), wh)
    assert amg_taps(key, "cpu", torch.float32)[0] is h_32


@pytest.mark.parametrize("orig_hw", [(32, 48), (100, 133), (64, 64),
                                     (2000, 3000), (333, 250)])
def test_amg_resize_matrices_fit_the_kernel_taps(orig_hw):
    """Every image size AMG resizes to has at most 3 adjacent taps a row
    and a column, so K4 serves it: the tables build and rebuild the
    matrices."""
    wh, ww = _amg_mats(orig_hw)
    htab, wtab = mr.resize_taps(wh, ww)
    np.testing.assert_array_equal(_dense_from_taps(wtab, ww.shape[1]), ww)
    assert htab.shape == (wh.shape[0], 4)


def test_tap_table_refuses_what_the_kernel_does_not_take():
    wide = np.zeros((2, 8), np.float32)
    wide[0, 1:5] = 0.25                                   # 4 taps
    with pytest.raises(ValueError, match="taps"):
        mr.tap_table(wide)
    down = np.zeros((2, 8), np.float32)
    down[0, 4], down[1, 1] = 1.0, 1.0                     # first tap falls
    with pytest.raises(ValueError, match="decrease"):
        mr.tap_table(down, monotone=True)
    assert mr.tap_table(down).shape == (2, 4)


def test_cpu_path_ignores_the_tap_tables():
    lowres, wh, ww = _setup(30, 40)
    args = (torch.from_numpy(lowres), torch.from_numpy(wh),
            torch.from_numpy(ww), 0.0, 1.0, (8, 8))
    got = mr.fused_resize_flags(*args, taps=mr.resize_taps(wh, ww))
    for a, b in zip(got, mr.fused_resize_flags(*args)):
        assert torch.equal(a, b)
