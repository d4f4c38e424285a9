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


def test_tap_ranges_cover_all_nonzeros():
    _, wh, ww = _setup(240, 320, gh=8)
    for mat in (wh, ww):
        lo, hi = (x.numpy() for x in mr.tap_ranges(torch.from_numpy(mat)))
        for r in range(mat.shape[0]):
            nz = np.flatnonzero(mat[r])
            if len(nz):
                assert lo[r] == nz[0] and hi[r] == nz[-1] + 1
            else:
                assert lo[r] == hi[r] == 0
