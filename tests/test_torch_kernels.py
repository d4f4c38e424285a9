"""The twelve CUDA kernels against their plain PyTorch versions on the card
(marked ``gpu``; they skip where there is no CUDA device), plus the
port's import and dispatch contract, which holds everywhere.

This file imports no JAX, so the card's machine (which has none) runs it:
``python -m pytest tests/test_torch_kernels.py -m gpu --noconftest``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from revisit_anything_tpu_torch.kernels import build
from revisit_anything_tpu_torch.ops import attention as att
from revisit_anything_tpu_torch.ops import decode_fused as dfu
from revisit_anything_tpu_torch.ops import decode_probs as dpr
from revisit_anything_tpu_torch.ops import maskhead as mh
from revisit_anything_tpu_torch.ops import maskresize as mr
from revisit_anything_tpu_torch.ops import winattn as wa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# bf16 outputs: kernel and plain version round at different points
# (unnormalized vs normalized probabilities, f32 accumulation order);
# relative 2e-2 of the output's scale.
BF16_REL = 2e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel_err(a, b):
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-6))


OFFLINE_MODULES = (
    "config", "io.h5io", "io.vocab", "ops.masks", "ops.vlad", "ops.kmeans",
    "ops.pca", "ops.knn", "models.sam.amg", "pipeline.extract",
    "pipeline.vocabulary", "pipeline.aggregate", "retrieval.matching",
    "retrieval.recall", "pipeline.evaluate")


def test_port_imports_without_jax_or_nvcc():
    """The serving path and the fifteen modules of the offline pipeline
    import on a machine with neither JAX in use nor nvcc (the kernels
    build at their first CUDA launch), and load none of h5py, PIL, cv2
    or sklearn (the card's machine lacks some of them: they are imported
    where a function needs them)."""
    mods = ["pipeline.serve", "weights", "models.sam.convert",
            *OFFLINE_MODULES]
    code = ("import sys; " + "; ".join(
        f"import revisit_anything_tpu_torch.{m}" for m in mods) + "; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'revisit_anything_tpu.')) or "
            "m.split('.')[0] in ('h5py', 'PIL', 'cv2', 'sklearn')]; "
            "assert not bad, bad")
    env = dict(os.environ, PATH="/usr/bin:/bin")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                   check=True)


def test_cpu_tensors_take_the_plain_versions():
    """On CPU tensors no kernel launches (no counter moves, no build)."""
    build.reset_counts()
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, 2, 16, 8)).astype(
        np.float32))
    assert torch.equal(att.attend(q, q, q), att.attend_reference(q, q, q))
    kvt = torch.from_numpy(rng.standard_normal((1, 32, 20)).astype(
        np.float32))
    out = att.token_cross_attend_kv(q[0, :, :7, :].reshape(2, 7, 8).repeat(
        1, 1, 2), kvt, torch.zeros(1, 16, 20), torch.zeros(16), 2)
    assert out.shape == (2, 7, 16)
    x = torch.from_numpy(rng.standard_normal((1, 64, 32)).astype(np.float32))
    tok = torch.from_numpy(rng.standard_normal((2, 7, 16)).astype(
        np.float32))
    w = torch.from_numpy(rng.standard_normal((32, 32)).astype(np.float32))
    keys, kvt = att.i2t_update(x, x[:, :, :16], tok, tok, w[:, :16], w[0, :16],
                               w[:16], w[0], w[1], w[2], w, 2, 1e-6)
    assert keys.shape == (2, 64, 32) and kvt.shape == (2, 32, 64)
    pet = x[:, :, :16].transpose(1, 2)                     # [1, DA, M]
    p = dpr.i2t_probs(pet, tok, 2)
    assert p.shape == (2, 14, 64) and p.dtype == torch.bfloat16
    c = w[:14][None].repeat(2, 1, 1)                       # [B, H·T, D]
    out = dpr.t2i_from_probs(tok, x, p, c, None, None, w[:, :16], w[:, :16],
                             pet, w[:8], w[0, :16], 2)
    assert out.shape == (2, 7, 16)
    out = att.token_cross_attend(tok, pet, pet, 2)
    assert out.shape == (2, 7, 16)
    qkv = torch.from_numpy(rng.standard_normal((3, 16, 48)).astype(
        np.float32))
    out = wa.windowed_attend(qkv, qkv[..., :8], qkv[..., 8:16], 2, side=4)
    assert torch.equal(out, wa.windowed_attend_reference(
        qkv, qkv[..., :8], qkv[..., 8:16], 2, 4))
    dec = serving_decoder(torch.device("cpu"))
    r = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)
    with torch.inference_mode():
        qo, logits = dfu.decode_tail_fused(
            dec, r(1, 64, 256), r(1, 128, 64), r(1, 128, 64), r(1, 128, 64),
            r(1, 128, 64), r(2, 7, 128), r(2, 56, 256), r(2, 7, 256),
            r(2, 7, 256), 8, 1e-6, mask_head=True, content=48)
    assert qo.shape == (2, 7, 256) and logits.shape == (2, 48, 16, 3)
    assert all(k.launches == 0 for k in build.KERNELS)


def test_kernel_table_points_at_sources():
    assert len(build.KERNELS) == 12
    assert len({k.entry for k in build.KERNELS}) == 12
    for k in build.KERNELS:
        assert os.path.exists(os.path.join(REPO, k.source)), k.source
        path, line = k.replaces.split(":")
        with open(os.path.join(REPO, path)) as f:
            assert "pallas_call" in f.readlines()[int(line) - 1]


def test_winattn_variants_patch_the_kernel_source():
    """Every variant of ``kernels.winattn_variants`` still finds the lines
    it replaces in ``win_attention.cu`` (the tool runs only on the
    card)."""
    from revisit_anything_tpu_torch.kernels import winattn_variants as wv
    base = wv._SRC.read_text()
    for name, (_, reps) in wv.VARIANTS.items():
        text = wv._source(reps)
        assert (text == base) == (not reps), name


def test_maskhead_variants_patch_the_kernel_source():
    """Every variant of ``kernels.maskhead_variants``, K3's and B6's,
    still finds the lines it replaces in ``mask_head.cu`` (the tool runs
    only on the card)."""
    from revisit_anything_tpu_torch.kernels import maskhead_variants as mv
    base = mv._SRC.read_text()
    for name, (_, reps) in (*mv.VARIANTS.items(),
                            *mv.PROBS_VARIANTS.items()):
        text = mv._source(reps)
        assert (text == base) == (not reps), name


def test_i2t_variants_patch_the_kernel_source():
    """Every variant of ``kernels.i2t_variants`` still finds the lines it
    replaces in ``i2t_update.cu`` (the tool runs only on the card)."""
    from revisit_anything_tpu_torch.kernels import i2t_variants as iv
    base = iv._SRC.read_text()
    for name, (_, reps) in iv.VARIANTS.items():
        text = iv._source(reps)
        assert (text == base) == (not reps), name


def test_resize_variants_patch_the_kernel_source():
    """Every variant of ``kernels.resize_variants`` still finds the lines
    it replaces in ``resize_flags.cu`` (the tool runs only on the card)."""
    from revisit_anything_tpu_torch.kernels import resize_variants as rv
    base = rv._SRC.read_text()
    for name, (_, reps) in rv.VARIANTS.items():
        text = rv._source(reps)
        assert (text == base) == (not reps), name


def test_tail_variants_patch_the_kernel_source():
    """Every variant of ``kernels.tail_variants`` still finds the lines it
    replaces in ``decode_tail.cu`` / ``decode_tc.cuh`` (the tool runs only
    on the card)."""
    from revisit_anything_tpu_torch.kernels import tail_variants as tv
    base = tv._source([])
    for name, (_, reps) in tv.VARIANTS.items():
        assert (tv._source(reps) == base) == (not reps), name


def _flash_inputs(cuda, b, n, dh, bias, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    bf = torch.bfloat16
    q, k, v = (torch.randn((b, 2, n, dh), generator=g, device=cuda).to(bf)
               for _ in range(3))
    side = int(round(n ** 0.5)) if bias else 0
    bh = bw = None
    if bias:
        bh, bw = (torch.randn((b, 2, n, side), generator=g,
                              device=cuda).to(bf) for _ in range(2))
    return (q, k, v, bh, bw), side


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,dh,bias", [
    (1, 4096, 80, True),     # SAM ViT-H global layer (side 64)
    (1, 1531, 64, False),    # DINOv2-g: ragged last key and row tile
    (1, 200, 64, False),
    (2, 64, 64, False),      # batch·heads 4, one partial tile
    (2, 65, 80, False),      # one key past a 64-row boundary
    (2, 1531, 80, False),
    (2, 196, 80, True),      # side 14: the bias looked up per score
    (2, 1024, 64, True),     # side 32
    (1, 256, 80, True),      # side 16 (the smoke's small SAM)
])
def test_flash_kernel_matches_plain(cuda, b, n, dh, bias):
    args, side = _flash_inputs(cuda, b, n, dh, bias)
    before = build.FLASH_ATTENTION.launches
    got = att.attend(*args, side=side)
    want = att.attend_reference(*args, side=side)
    torch.cuda.synchronize()
    assert build.FLASH_ATTENTION.launches == before + 1
    assert got.shape == want.shape
    assert _rel_err(got, want) < BF16_REL


def _token_inputs(cuda, b, n, m, lead, pe, seed=1):
    g = torch.Generator(device=cuda).manual_seed(seed)
    bf = torch.bfloat16
    d = 128
    q = torch.randn((b, n, d), generator=g, device=cuda).to(bf)
    if pe:
        return (q, torch.randn((lead, 2 * d, m), generator=g,
                               device=cuda).to(bf),
                torch.randn((1, d, m), generator=g, device=cuda).to(bf),
                torch.randn((d,), generator=g, device=cuda).to(bf))
    return (q,) + tuple(torch.randn((lead, d, m), generator=g,
                                    device=cuda).to(bf) for _ in range(2))


# (shared k|v, prompts, queries a prompt, keys): the serving shapes; 5
# prompts of 7 rows (a prompt crosses a warp's 16 rows, the last row tile
# is ragged); 20 prompts (a prompt crosses a CTA's 128 rows); n = 8; M =
# 1024 and ragged last key tiles (M = 1000, 1032).
TOKEN_CASES = [(True, 16, 7, 4096), (False, 16, 7, 4096),
               (True, 5, 7, 4096), (True, 20, 7, 1024), (True, 5, 8, 1000),
               (True, 4, 7, 1032), (False, 5, 8, 1024), (False, 3, 7, 1000)]


@pytest.mark.gpu
@pytest.mark.parametrize("shared,b,n,m", TOKEN_CASES)
def test_token_cross_kernel_matches_plain(cuda, shared, b, n, m):
    args = _token_inputs(cuda, b, n, m, 1 if shared else b, pe=True)
    before = build.TOKEN_CROSS.launches
    got = att.token_cross_attend_kv(*args, 8)
    want = att.token_cross_attend_kv_reference(*args, 8)
    torch.cuda.synchronize()
    assert build.TOKEN_CROSS.launches == before + 1
    assert got.shape == want.shape == (b, n, 128)
    assert _rel_err(got, want) < BF16_REL


@pytest.mark.gpu
@pytest.mark.parametrize("shared,b,n,m", TOKEN_CASES)
def test_token_cross_split_kernel_matches_plain(cuda, shared, b, n, m):
    args = _token_inputs(cuda, b, n, m, 1 if shared else b, pe=False,
                         seed=8)
    before = build.TOKEN_CROSS_SPLIT.launches
    got = att.token_cross_attend(*args, 8)
    want = att.token_cross_attend_reference(*args, 8)
    torch.cuda.synchronize()
    assert build.TOKEN_CROSS_SPLIT.launches == before + 1
    assert got.shape == want.shape == (b, n, 128)
    assert _rel_err(got, want) < BF16_REL


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["flash", "flash_bias", "token_shared",
                                  "token_prompt", "split_shared", "window"])
def test_attention_kernels_are_bitwise_repeatable(cuda, case):
    """Two launches on the same inputs give the same bits (no atomics, no
    order that depends on scheduling)."""
    if case == "window":
        args = _win_inputs(cuda, 25, 14, 16, 80)
        run = lambda: wa.windowed_attend(*args, 16, 14)  # noqa: E731
    elif case.startswith("flash"):
        args, side = _flash_inputs(cuda, 2, 1024, 80, case == "flash_bias")
        run = lambda: att.attend(*args, side=side)  # noqa: E731
    elif case.startswith("token"):
        shared = case == "token_shared"
        args = _token_inputs(cuda, 20, 7, 4096, 1 if shared else 20, pe=True)
        run = lambda: att.token_cross_attend_kv(*args, 8)  # noqa: E731
    else:
        args = _token_inputs(cuda, 20, 7, 4096, 1, pe=False)
        run = lambda: att.token_cross_attend(*args, 8)  # noqa: E731
    first, second = run(), run()
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.gpu
def test_attention_kernels_refuse_shapes_they_do_not_take(cuda):
    """K2 and B10 need M % 8 == 0; K1's bias needs side <= 64; B11 head
    dim 64 or 80 and N < 1024."""
    args = _token_inputs(cuda, 2, 7, 1004, 2, pe=True)
    with pytest.raises(ValueError, match="multiple of 8"):
        att.token_cross_attend_kv(*args, 8)
    args = _token_inputs(cuda, 2, 7, 1004, 1, pe=False)
    with pytest.raises(ValueError, match="multiple of 8"):
        att.token_cross_attend(*args, 8)
    args, side = _flash_inputs(cuda, 1, 65 * 65, 64, True)
    with pytest.raises(ValueError, match="side <= 64"):
        att.attend(*args, side=side)
    for side, hd in ((14, 96), (32, 80)):
        with pytest.raises(ValueError, match="not built"):
            wa.windowed_attend(*_win_inputs(cuda, 1, side, 2, hd), 2, side)


def _win_inputs(cuda, b, side, heads, hd, seed=9):
    g = torch.Generator(device=cuda).manual_seed(seed)
    bf = torch.bfloat16
    n = side * side
    qkv = torch.randn((b, n, 3 * heads * hd), generator=g, device=cuda).to(bf)
    bh, bw = (torch.randn((b, n, heads * side), generator=g,
                          device=cuda).to(bf) for _ in range(2))
    return qkv, bh, bw


# (windows, side, heads, head dim): SAM ViT-H's windowed layer (25 windows
# of 14x14, 16 heads of 80) and one window of it; N = 196 at hd 64; N =
# 256 (16 row tiles: 3 rounds of 6 warps); N = 25 (ragged, padded to 32); sides
# 20 and 31 (N = 400 and 961: K|V resident at 400, streamed in key blocks
# at 961)
WIN_CASES = [(25, 14, 16, 80), (1, 14, 16, 80), (2, 14, 2, 64),
             (3, 16, 2, 64), (4, 5, 2, 80), (4, 5, 2, 64), (2, 20, 2, 80),
             (1, 31, 2, 80), (1, 31, 2, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,side,heads,hd", WIN_CASES)
def test_win_attention_kernel_matches_plain(cuda, b, side, heads, hd):
    """B11 against its plain version, from the SAM shape to N = 961."""
    qkv, bh, bw = _win_inputs(cuda, b, side, heads, hd)
    n = side * side
    before = build.WIN_ATTENTION.launches
    got = wa.windowed_attend(qkv, bh, bw, heads, side)
    want = wa.windowed_attend_reference(qkv, bh, bw, heads, side)
    torch.cuda.synchronize()
    assert build.WIN_ATTENTION.launches == before + 1
    assert got.shape == want.shape == (b, n, heads * hd)
    assert _rel_err(got, want) < BF16_REL


def _i2t_inputs(cuda, shared, b, m, seed=4, far=False):
    """K5's operands; ``far``: head 0's logits sit ~500 above head 1's
    (q_0 and k_0 near +8, q_1 near -8), so a softmax shifted by the row's
    max over all heads would underflow head 1 to 0/0."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    bf = torch.bfloat16

    def rnd(*shape, s=1.0, off=0.0):
        return (torch.randn(shape, generator=g, device=cuda) * s + off).to(bf)

    b_q, tok_k = rnd(128, s=0.1), rnd(b, 7, 128)
    if far:
        b_q[:16] += 8.0
        b_q[16:32] -= 8.0
        tok_k[..., :32] += 8.0
    return (rnd(1 if shared else b, m, 256), rnd(1, m, 128), tok_k,
            rnd(b, 7, 128), rnd(256, 128, s=0.1), b_q,
            rnd(128, 256, s=0.1), rnd(256, s=0.1), rnd(256, s=0.1, off=1.0),
            rnd(256, s=0.1), rnd(256, 256, s=0.1))


# (shared, b, M, far): b 1 leaves most persistent CTAs idle; M 192 ends on
# half a 128-position unit (its second warpgroup's rows lie past M), M 64
# is that half alone; far: head 0's logits ~500 above head 1's, where only
# a softmax shifted per head keeps head 1 from 0/0.
I2T_CASES = [(shared, b, m, False) for shared in (True, False)
             for b in (1, 3, 16) for m in (64, 192, 4096)] + [
    (True, 5, 192, True), (False, 5, 192, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("shared,b,m,far", I2T_CASES)
def test_i2t_update_kernel_matches_plain(cuda, shared, b, m, far):
    args = _i2t_inputs(cuda, shared, b, m, seed=5 if far else 4, far=far)
    before = build.I2T_UPDATE.launches
    keys, kvt = att.i2t_update(*args, 8, 1e-6)
    want_keys, want_kvt = att.i2t_update_reference(*args, 8, 1e-6)
    torch.cuda.synchronize()
    assert build.I2T_UPDATE.launches == before + 1
    assert keys.shape == (b, m, 256) and kvt.shape == (b, 256, m)
    assert torch.isfinite(keys.float()).all()
    assert torch.isfinite(kvt.float()).all()
    assert _rel_err(keys, want_keys) < BF16_REL
    assert _rel_err(kvt, want_kvt) < BF16_REL


@pytest.mark.gpu
@pytest.mark.parametrize("shared", [True, False])
def test_i2t_update_kernel_is_bitwise_repeatable(cuda, shared):
    """Two launches of K5 on the same inputs give the same bits."""
    args = _i2t_inputs(cuda, shared, 16, 4096)
    (k1, t1), (k2, t2) = (att.i2t_update(*args, 8, 1e-6) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(k1, k2) and torch.equal(t1, t2)


@pytest.mark.gpu
def test_i2t_update_kernel_refuses_shapes_it_does_not_take(cuda):
    """K5 takes D 256, DA 128, 8 heads, T 7, M % 64 == 0 and a 256x256
    w_kv_next only."""
    args = list(_i2t_inputs(cuda, False, 2, 128))
    bad = {
        "M % 64": lambda a: [a[0][:, :96], a[1][:, :96]] + a[2:],
        "D": lambda a: [a[0][..., :128]] + a[1:4] + [a[4][:128]] + a[5:],
        "DA": lambda a: a[:1] + [a[1][..., :64], a[2][..., :64],
                                a[3][..., :64], a[4][:, :64], a[5][:64],
                                a[6][:64]] + a[7:],
        "T": lambda a: a[:2] + [a[2][:, :6], a[3][:, :6]] + a[4:],
        "w_kv_next": lambda a: a[:10] + [a[10][:, :128]],
    }
    for cut in bad.values():
        with pytest.raises(ValueError, match="not built"):
            att.i2t_update(*cut(args), 8, 1e-6)
    with pytest.raises(ValueError, match="not built"):
        att.i2t_update(*args, 4, 1e-6)


def _mask_head_inputs(cuda, np_, gg, m, d=256, seed=2):
    g = torch.Generator(device=cuda).manual_seed(seed)
    bf = torch.bfloat16

    def rnd(*shape, s=1.0, off=0.0):
        return (torch.randn(shape, generator=g, device=cuda) * s + off).to(bf)

    return (rnd(np_, gg, d), rnd(np_, m, d // 8, s=0.5),
            rnd(d, d, s=0.1), rnd(d // 4, s=0.1), rnd(d // 4, s=0.1, off=1.0),
            rnd(d // 4, s=0.1), rnd(d // 4, d // 2, s=0.1), rnd(d // 8, s=0.1))


# (prompts, gg, content, mask tokens): content a whole number of 64-row
# items (3136), a ragged last item (3130) and less than one item (37),
# each at M 1, 3 and 4 and at 1 prompt (most CTAs idle) and 8; then
# content = gg, where the last item reads past the tensor (zero-filled).
MASK_HEAD_CASES = [(np_, 4096, content, m) for np_ in (1, 8)
                   for content in (3136, 3130, 37) for m in (1, 3, 4)] + [
    (2, 3130, 3130, 3), (3, 37, 37, 4)]


@pytest.mark.gpu
@pytest.mark.parametrize("np_,gg,content,m", MASK_HEAD_CASES)
def test_mask_head_kernel_matches_plain(cuda, np_, gg, content, m):
    args = _mask_head_inputs(cuda, np_, gg, m)
    before = build.MASK_HEAD.launches
    got = mh.fused_mask_head(*args, eps=1e-6, content=content)
    want = mh.upscale_masks_blocks(args[0][:, :content], *args[1:], eps=1e-6)
    torch.cuda.synchronize()
    assert build.MASK_HEAD.launches == before + 1
    assert got.shape == want.shape == (np_, content, 16, m)
    assert _rel_err(got, want) < BF16_REL


@pytest.mark.gpu
def test_mask_head_kernel_is_bitwise_repeatable(cuda):
    """Two launches of K3 on the same inputs give the same bits."""
    args = _mask_head_inputs(cuda, 8, 4096, 3)
    first, second = (mh.fused_mask_head(*args, eps=1e-6, content=3130)
                     for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.gpu
def test_mask_head_kernel_refuses_shapes_it_does_not_take(cuda):
    """K3 takes D 256 and M 1-4 only."""
    with pytest.raises(ValueError, match="not built"):
        mh.fused_mask_head(*_mask_head_inputs(cuda, 2, 128, 3, d=128), eps=1e-6)
    with pytest.raises(ValueError, match="not built"):
        mh.fused_mask_head(*_mask_head_inputs(cuda, 2, 128, 5), eps=1e-6)


def _resize_inputs(cuda, orig_hw, np_, m, seed=3, const=None, side=1024):
    """AMG's resize matrices for an image of orig_hw (input resized to the
    long side ``side``, SAM's grid side / 16) and seeded bf16 logits
    [np_, gh·g, 16, m]."""
    import dataclasses

    from revisit_anything_tpu_torch.models.sam import SAM_VIT_H
    from revisit_anything_tpu_torch.models.sam.amg import (
        resize_longest_side, resize_mats_and_rows)
    cfg = dataclasses.replace(SAM_VIT_H, image_size=side)
    wh, ww, gh = resize_mats_and_rows(
        cfg, resize_longest_side(*orig_hw, side), orig_hw)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((np_, gh * cfg.grid, 16, m)).astype(
        np.float32) * 4.0
    if const is not None:
        x[:] = const
    x = torch.from_numpy(x).to(cuda, torch.bfloat16)
    return (x, torch.from_numpy(wh).to(cuda), torch.from_numpy(ww).to(cuda),
            (gh, cfg.grid))


# (image, prompts, masks, constant logits, SAM input side): 17places
# (240x320, gh 49) at 1-4 masks, and at 301 prompts (no multiple of the
# CTA count: 2 an SM); a square grid (gh = g = 64, 256x256); portrait
# (H > W) at W = 240 and at W = 250 (not a multiple of 16: byte stores);
# a small SAM's grid (g 16, 224x224); tap tables too large for shared
# memory (600x800: bands of 3 rows; 2000x3000: bands of 1 row); all
# pixels above and all below every threshold
RESIZE_CASES = [
    ((240, 320), 16, 3, None, 1024), ((240, 320), 16, 1, None, 1024),
    ((240, 320), 8, 2, None, 1024), ((240, 320), 8, 4, None, 1024),
    ((240, 320), 301, 3, None, 1024), ((256, 256), 16, 3, None, 1024),
    ((320, 240), 16, 3, None, 1024), ((333, 250), 16, 1, None, 1024),
    ((224, 224), 16, 3, None, 256), ((600, 800), 4, 3, None, 1024),
    ((2000, 3000), 2, 3, None, 1024),
    ((240, 320), 4, 3, 20.0, 1024), ((240, 320), 4, 3, -20.0, 1024),
]


@pytest.mark.gpu
@pytest.mark.parametrize("orig_hw,np_,m,const,side", RESIZE_CASES)
def test_resize_kernel_matches_plain(cuda, orig_hw, np_, m, const, side):
    x, whd, wwd, grid = _resize_inputs(cuda, orig_hw, np_, m, const=const,
                                       side=side)
    taps = tuple(t.to(cuda) for t in mr.resize_taps(whd, wwd))
    build.RESIZE_FLAGS.launches = 0
    flags, rowst, colany = mr.fused_resize_flags(x, whd, wwd, 0.0, 1.0,
                                                 grid, taps=taps)
    want = mr.resize_flags_reference(x, whd, wwd, 0.0, 1.0, grid)
    torch.cuda.synchronize()
    assert build.RESIZE_FLAGS.launches == 1
    # f32 summation order only: flips only at exact threshold crossings
    assert float((flags != want).float().mean()) <= 1e-5
    if const is not None:
        assert torch.equal(flags, want)
        assert bool((flags == (7 if const > 0 else 0)).all())
    own_rowst, own_colany = mr.flag_stats(flags)
    assert torch.equal(rowst, own_rowst)
    assert torch.equal(colany, own_colany)


@pytest.mark.gpu
def test_resize_kernel_builds_its_tap_tables_when_not_given(cuda):
    x, whd, wwd, grid = _resize_inputs(cuda, (240, 320), 4, 3)
    got = mr.fused_resize_flags(x, whd, wwd, 0.0, 1.0, grid)
    taps = tuple(t.to(cuda) for t in mr.resize_taps(whd, wwd))
    again = mr.fused_resize_flags(x, whd, wwd, 0.0, 1.0, grid, taps=taps)
    torch.cuda.synchronize()
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_resize_kernel_refuses_shapes_it_does_not_take(cuda):
    """K4 takes g <= 64, gh <= g, 1-4 masks, W <= 8192 and 3 taps."""
    x, whd, wwd, (gh, _) = _resize_inputs(cuda, (240, 320), 2, 3)
    x80 = torch.zeros((2, gh * 80, 16, 3), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="not built"):          # g = 80
        mr.fused_resize_flags(x80, whd, torch.zeros((320, 320), device=cuda),
                              0.0, 1.0, (gh, 80))
    x5 = torch.zeros((2, gh * 64, 16, 5), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="not built"):          # 5 masks
        mr.fused_resize_flags(x5, whd, wwd, 0.0, 1.0, (gh, 64))
    wide = torch.zeros((8200, 256), device=cuda)
    with pytest.raises(ValueError, match="not built"):          # W 8200
        mr.fused_resize_flags(x, whd, wide, 0.0, 1.0, (gh, 64))
    spread = wwd.clone()
    spread[:, 0] = 0.5                                          # 4+ taps
    with pytest.raises(ValueError, match="taps"):
        mr.fused_resize_flags(x, whd, spread, 0.0, 1.0, (gh, 64))


def _probs_inputs(cuda, b=16, m=4096, seed=5):
    """Inputs of the probability-factored decode kernels at the serving
    widths (D 256, DA 128, 8 heads, 7 tokens) for ``b`` prompts."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    bf = torch.bfloat16

    def rnd(*shape, s=1.0, off=0.0):
        return (torch.randn(shape, generator=g, device=cuda) * s + off).to(bf)

    def probs(*shape):
        x = torch.randn(shape, generator=g, device=cuda) * 2.0
        return torch.softmax(x.reshape(b, 8, 7, m), dim=2).reshape(
            shape).to(bf)

    rows = torch.zeros((8, 256), device=cuda)
    rows[[0, 3]] = torch.randn((2, 256), generator=g, device=cuda) * 0.1
    rows[[1, 4]] = torch.randn((2, 256), generator=g, device=cuda) * 0.1 + 1
    rows[[2, 5]] = torch.randn((2, 256), generator=g, device=cuda) * 0.1
    return dict(img0=rnd(1, m, 256), q1st=rnd(1, 128, m), tok_k=rnd(b, 7, 128),
                p1=probs(b, 56, m), p2=probs(b, 56, m),
                c1=rnd(b, 56, 256, s=0.3), c2=rnd(b, 56, 256, s=0.3),
                peqt=rnd(1, 128, m), w=rnd(256, 128, s=0.1),
                w_v=rnd(256, 128, s=0.1), q=rnd(b, 7, 128),
                v_bias=rnd(128, s=0.1), rows=rows.to(bf))


def _large_branch(x, ln_scale, depth):
    """The inputs ``x`` with the branch LayerNorm scales of the first
    ``depth`` layers times ``ln_scale`` and the query-side weight ``w``
    divided by it (both exact in bf16 at a power of two): the branch
    grows by ``ln_scale`` and the scores against it keep their usual
    size (at 2^15 times it a softmax over them is one hot and flips at
    near-ties under any change of the summation order, PERF.md §6)."""
    rows = x["rows"].clone()
    rows[[1, 4][:depth]] *= ln_scale
    return dict(x, rows=rows, w=x["w"] / ln_scale)


# (layer or depth, prompts, M, branch LayerNorm scale): the serving shape
# at 16 prompts, more prompts than the card's 132 SMs, M = 96 (three
# tiles: the online softmax rescales its context across tiles) and both
# branch LayerNorm scales times 2^15, so that the branch passes fp16's
# largest value 65504, which the kernels' fp16 planes hold times a power
# of two
PROBS_CASES = [
    pytest.param(1, 16, 4096, 1.0, id="1"),
    pytest.param(2, 16, 4096, 1.0, id="2"),
    pytest.param(1, 140, 4096, 1.0, id="1-140-4096"),
    pytest.param(2, 140, 4096, 1.0, id="2-140-4096"),
    pytest.param(1, 16, 96, 1.0, id="1-16-96"),
    pytest.param(2, 16, 96, 1.0, id="2-16-96"),
    pytest.param(1, 16, 256, 32768.0, id="1-16-256-large-branch"),
    pytest.param(2, 16, 256, 32768.0, id="2-16-256-large-branch")]


@pytest.mark.gpu
@pytest.mark.parametrize("layer,b,m,ln_scale", PROBS_CASES)
def test_i2t_probs_kernel_matches_plain(cuda, layer, b, m, ln_scale):
    x = _large_branch(_probs_inputs(cuda, b=b, m=m), ln_scale, 1)
    recon = (x["img0"], x["p1"], x["c1"], x["peqt"], x["w"], x["rows"])
    kw = dict(layer=layer, recon=recon if layer == 2 else None)
    q1st = x["q1st"] if layer == 1 else None
    before = build.I2T_PROBS.launches
    got = dpr.i2t_probs(q1st, x["tok_k"], 8, **kw)
    want = dpr.i2t_probs_reference(q1st, x["tok_k"], 8, **kw)
    torch.cuda.synchronize()
    assert build.I2T_PROBS.launches == before + 1
    assert got.shape == want.shape == (b, 56, m)
    if ln_scale > 1.0 and layer == 2:
        keys1 = dpr.recon_branch(x["img0"], [x["p1"]], [x["c1"]], x["rows"],
                                 1e-6)
        assert keys1.abs().max().item() > 65504
    assert _rel_err(got, want) < BF16_REL


@pytest.mark.gpu
@pytest.mark.parametrize("depth,b,m,ln_scale", PROBS_CASES)
def test_t2i_from_probs_kernel_matches_plain(cuda, depth, b, m, ln_scale):
    x = _large_branch(_probs_inputs(cuda, b=b, m=m), ln_scale, depth)
    p2, c2 = (x["p2"], x["c2"]) if depth == 2 else (None, None)
    args = (x["q"], x["img0"], x["p1"], x["c1"], p2, c2, x["w"], x["w_v"],
            x["peqt"], x["rows"], x["v_bias"], 8)
    before = build.T2I_PROBS.launches
    got = dpr.t2i_from_probs(*args)
    want = dpr.t2i_from_probs_reference(*args)
    torch.cuda.synchronize()
    assert build.T2I_PROBS.launches == before + 1
    assert got.shape == want.shape == (b, 7, 128)
    if ln_scale > 1.0:
        ps, cs = [x["p1"], x["p2"]][:depth], [x["c1"], x["c2"]][:depth]
        keys = dpr.recon_branch(x["img0"], ps, cs, x["rows"], 1e-6)
        assert keys.abs().max().item() > 65504
    assert torch.isfinite(got.float()).all()
    assert _rel_err(got, want) < BF16_REL


@pytest.mark.gpu
def test_probs_kernels_permute_with_their_prompts(cuda):
    """Permuting the prompts permutes B7's (both layers) and B8's (both
    depths) outputs bit for bit: a CTA reads its own prompt's token rows,
    P and C only."""
    b = 24
    x = _probs_inputs(cuda, b=b, m=256)
    perm = torch.randperm(b, generator=torch.Generator().manual_seed(0))
    perm = perm.to(cuda)
    xp = {k: (v[perm] if k in ("tok_k", "q", "p1", "p2", "c1", "c2") else v)
          for k, v in x.items()}

    def run(y):
        recon = (y["img0"], y["p1"], y["c1"], y["peqt"], y["w"], y["rows"])
        outs = [dpr.i2t_probs(y["q1st"], y["tok_k"], 8),
                dpr.i2t_probs(None, y["tok_k"], 8, layer=2, recon=recon)]
        for p2, c2 in ((None, None), (y["p2"], y["c2"])):
            outs.append(dpr.t2i_from_probs(
                y["q"], y["img0"], y["p1"], y["c1"], p2, c2, y["w"],
                y["w_v"], y["peqt"], y["rows"], y["v_bias"], 8))
        return outs

    base, got = run(x), run(xp)
    torch.cuda.synchronize()
    for a, w in zip(got, base):
        assert torch.equal(a, w[perm])


def _mask_head_probs_args(cuda, np_, m, seed=6):
    """B6's arguments at the serving widths (gg 4096) for ``np_`` prompts
    and ``m`` mask tokens."""
    x = _probs_inputs(cuda, b=np_)
    g = torch.Generator(device=cuda).manual_seed(seed)

    def rnd(*shape, s=1.0, off=0.0):
        return (torch.randn(shape, generator=g, device=cuda) * s + off).to(
            torch.bfloat16)

    return (x["img0"], x["p1"], x["c1"], x["p2"], x["c2"], x["rows"],
            rnd(np_, m, 32, s=0.5), rnd(256, 256, s=0.1), rnd(64, s=0.1),
            rnd(64, s=0.1, off=1.0), rnd(64, s=0.1), rnd(64, 128, s=0.1),
            rnd(32, s=0.1))


# (prompts, content, mask tokens) at gg 4096: a whole number of 64-row
# items (3136), a ragged last item (3130), less than one item (40) and
# content = gg (the last item's P boxes past gg are zero-filled), each at
# M 1-4 on 8 prompts; then 133 prompts, more than a 132-SM card's CTAs.
MASK_HEAD_PROBS_CASES = [
    pytest.param(8, 3136, 3, id="3136"), pytest.param(8, 3130, 3, id="3130")
] + [(8, content, m) for content in (3136, 3130, 40, 4096)
     for m in (1, 2, 3, 4) if (content, m) not in ((3136, 3), (3130, 3))] + [
    (133, 3136, 3), (133, 4096, 4)]


@pytest.mark.gpu
@pytest.mark.parametrize("np_,content,m", MASK_HEAD_PROBS_CASES)
def test_mask_head_probs_kernel_matches_plain(cuda, np_, content, m):
    args = _mask_head_probs_args(cuda, np_, m)
    before = build.MASK_HEAD_PROBS.launches
    got = mh.fused_mask_head_probs(*args, content=content)
    want = mh.mask_head_probs_reference(*args, content=content)
    torch.cuda.synchronize()
    assert build.MASK_HEAD_PROBS.launches == before + 1
    assert got.shape == want.shape == (np_, content, 16, m)
    assert _rel_err(got, want) < BF16_REL


@pytest.mark.gpu
def test_mask_head_probs_kernel_permutes_with_its_prompts(cuda):
    """Permuting the prompts permutes B6's output bit for bit: an item
    reads its own prompt's P and C only (the 64-row boxes' rows 56-63
    are zeros, never the next prompt's rows 0-7)."""
    args = _mask_head_probs_args(cuda, 133, 3)
    perm = torch.randperm(133, generator=torch.Generator().manual_seed(0))
    perm = perm.to(cuda)
    per_prompt = (1, 2, 3, 4, 6)              # p1, c1, p2, c2, hyper
    shuffled = tuple(a[perm] if i in per_prompt else a
                     for i, a in enumerate(args))
    base = mh.fused_mask_head_probs(*args, content=3130)
    got = mh.fused_mask_head_probs(*shuffled, content=3130)
    torch.cuda.synchronize()
    assert torch.equal(got, base[perm])


def serving_decoder(device, seed=0):
    """A bf16 SAM ViT-H mask decoder (prompt dim 256, 8 heads, MLP 2048)
    with seeded random weights: N(0, 0.05²), LayerNorm scales 1 + N(0,
    0.05²)."""
    from revisit_anything_tpu_torch.models.sam import SAM_VIT_H
    from revisit_anything_tpu_torch.models.sam.decoder import MaskDecoder
    dec = MaskDecoder(SAM_VIT_H, dtype=torch.bfloat16, device=device)
    g = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for name, p in dec.named_parameters():
            x = torch.randn(p.shape, generator=g, device=device) * 0.05
            p.copy_(x + 1.0 if name.endswith("scale") else x)
    return dec


def _tail_args(cuda, b, m, emit_keys, seed=7):
    """Decode-tail inputs for ``b`` prompts over ``m`` positions."""
    x = _probs_inputs(cuda, b=b, m=m)
    g = torch.Generator(device=cuda).manual_seed(seed)
    dec = serving_decoder(cuda)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=cuda).to(torch.bfloat16)

    return (dec, x["img0"], x["q1st"], x["peqt"], rnd(1, 128, m),
            rnd(1, 128, m), x["tok_k"], x["c1"], rnd(b, 7, 256),
            rnd(b, 7, 256), 8, 1e-6, emit_keys)


@pytest.mark.gpu
@pytest.mark.parametrize("emit_keys,b,m,ln_scale", [
    pytest.param(True, 16, 4096, 1.0, id="True"),
    pytest.param(False, 16, 4096, 1.0, id="False"),
    # keys mode at more prompts than the card's 132 SMs, and at M = 96
    # (three tiles: the online softmax rescales its context across tiles)
    pytest.param(True, 140, 4096, 1.0, id="True-140-4096"),
    pytest.param(True, 16, 96, 1.0, id="True-16-96"),
    # both branch LayerNorm scales times 2^15 (exact in bf16): keys2
    # passes fp16's largest value 65504, which the kernel's fp16 planes
    # hold times a power of two
    pytest.param(True, 16, 256, 32768.0, id="True-16-256-large-branch"),
    # the probability mode at the same cases
    pytest.param(False, 140, 4096, 1.0, id="False-140-4096"),
    pytest.param(False, 16, 96, 1.0, id="False-16-96"),
    pytest.param(False, 16, 256, 32768.0, id="False-16-256-large-branch")])
def test_decode_tail_kernel_matches_plain(cuda, emit_keys, b, m, ln_scale):
    args = _tail_args(cuda, b, m, emit_keys)
    with torch.no_grad():
        for layer in args[0].layers[:2]:
            layer.norm4.scale.mul_(ln_scale)
        if not emit_keys:
            # the layer-2 i2t query weight down by as much (exact), so that
            # P2's scores keep their usual size: at 2^15 times it P2 is one
            # hot, and its bf16 elements flip 0 <-> 1 at near-ties of
            # tokens under any change of the summation order (PERF.md §6)
            args[0].layers[1].i2t.q.w.div_(ln_scale)
    before = build.DECODE_TAIL.launches
    with torch.inference_mode():
        got = dfu.decode_tail_fused(*args)
        want = dfu.decode_tail_reference(*args)
        keys2 = (want if emit_keys else
                 dfu.decode_tail_reference(*args[:-1], True))[1]
    torch.cuda.synchronize()
    assert build.DECODE_TAIL.launches == before + 1
    assert len(got) == len(want) == (2 if emit_keys else 4)
    if ln_scale > 1.0:
        assert keys2.float().abs().max().item() > 65504
    for a, w in zip(got, want):
        assert a.shape == w.shape
        assert torch.isfinite(a.float()).all()
        assert _rel_err(a, w) < BF16_REL


@pytest.mark.gpu
def test_decode_tail_keys_kernel_permutes_with_its_prompts(cuda):
    """Permuting the prompts permutes the keys mode's outputs bit for bit:
    a CTA reads its own prompt's tokens, keys and C1 only."""
    b = 24
    args = _tail_args(cuda, b, 256, True)
    perm = torch.randperm(b, generator=torch.Generator().manual_seed(0))
    perm = perm.to(cuda)
    per_prompt = (6, 7, 8, 9)                 # tok_k1, c1m, queries, tokens
    shuffled = tuple(a[perm] if i in per_prompt else a
                     for i, a in enumerate(args))
    with torch.inference_mode():
        base = dfu.decode_tail_fused(*args)
        got = dfu.decode_tail_fused(*shuffled)
    torch.cuda.synchronize()
    for a, w in zip(got, base):
        assert torch.equal(a, w[perm])


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["probs", "logits"])
def test_decode_tail_probs_and_logits_kernels_permute_with_their_prompts(
        cuda, mode):
    """Permuting the prompts permutes the probability and logits modes'
    outputs bit for bit (the logits mode at a content that is not a
    multiple of 32: K3 reads keys2's rows up to the next multiple)."""
    b = 24
    args = _tail_args(cuda, b, 256, False)
    kw = dict(mask_head=True, content=200) if mode == "logits" else {}
    perm = torch.randperm(b, generator=torch.Generator().manual_seed(0))
    perm = perm.to(cuda)
    per_prompt = (6, 7, 8, 9)                 # tok_k1, c1m, queries, tokens
    shuffled = tuple(a[perm] if i in per_prompt else a
                     for i, a in enumerate(args))
    with torch.inference_mode():
        base = dfu.decode_tail_fused(*args, **kw)
        got = dfu.decode_tail_fused(*shuffled, **kw)
    torch.cuda.synchronize()
    assert len(got) == (2 if kw else 4)
    for a, w in zip(got, base):
        assert torch.equal(a, w[perm])


@pytest.mark.gpu
@pytest.mark.parametrize("content", [3136, 4096, 3100, 20])
def test_decode_tail_logits_kernel_matches_plain(cuda, content):
    """The logits mode at 140 prompts (more than the card's 132 SMs), at
    content a multiple of 32, not one (K3 reads keys2's rows up to the
    next multiple) and below one tile; its entry launches the tail and
    K3 as one counted launch."""
    b = 140
    x = _probs_inputs(cuda, b=b)
    g = torch.Generator(device=cuda).manual_seed(10)
    dec = serving_decoder(cuda)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=cuda).to(torch.bfloat16)

    args = (dec, x["img0"], x["q1st"], x["peqt"], rnd(1, 128, 4096),
            rnd(1, 128, 4096), x["tok_k"], x["c1"], rnd(b, 7, 256),
            rnd(b, 7, 256), 8, 1e-6)
    before = build.DECODE_TAIL_LOGITS.launches
    head_before = build.MASK_HEAD.launches
    with torch.inference_mode():
        got = dfu.decode_tail_fused(*args, mask_head=True, content=content)
        want = dfu.decode_tail_reference(*args, mask_head=True,
                                         content=content)
    torch.cuda.synchronize()
    assert build.DECODE_TAIL_LOGITS.launches == before + 1
    assert build.MASK_HEAD.launches == head_before
    assert got[1].shape == want[1].shape == (b, content, 16, 3)
    for a, w in zip(got, want):
        assert _rel_err(a, w) < BF16_REL


def _small_server(dev, seed=7, **kw):
    """A server over small models that keep every "shared" kernel's
    production widths (SAM head dim 80 on a 16x16 grid, prompt dim 256;
    DINO head dim 64 over 1025 tokens) and a random index of 50 images,
    with the point segmenter planted so AMG keeps many masks."""
    from revisit_anything_tpu_torch.models.dinov2 import DinoV2Config
    from revisit_anything_tpu_torch.models.sam import SamArchConfig
    from revisit_anything_tpu_torch.models.sam.amg import AmgConfig
    from revisit_anything_tpu_torch.pipeline.serve import (SegVLADServer,
                                                           ServingIndex)
    from revisit_anything_tpu_torch.weights import (init_dino, init_sam,
                                                    plant_point_segmenter)
    sam_cfg = SamArchConfig(encoder_dim=320, encoder_depth=2, encoder_heads=4,
                            global_attn_indexes=(1,), image_size=256,
                            window_size=8, decoder_mlp_dim=512,
                            iou_head_hidden=64)
    dino_cfg = DinoV2Config(embed_dim=128, depth=3, num_heads=2,
                            ffn="swiglu", pretrain_grid=(16, 16))
    gen = torch.Generator(device=dev).manual_seed(seed)
    sam = init_sam(sam_cfg, gen, dev, torch.bfloat16)
    plant_point_segmenter(sam, gen)
    dino = init_dino(dino_cfg, gen, dev, torch.bfloat16)
    rng = np.random.default_rng(seed)
    n_img, per_image, c, pca = 50, 10, 8, 32
    db = rng.standard_normal((n_img * per_image, pca)).astype(np.float32)
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    index = ServingIndex(
        centers=rng.standard_normal((c, 128)).astype(np.float32),
        pca_mean=np.zeros(c * 128, np.float32),
        pca_components=(rng.standard_normal((pca, c * 128)) * 0.05
                        ).astype(np.float32),
        pca_variance=np.ones(pca, np.float32), pca_whiten=True, db=db,
        db_image_ids=np.repeat(np.arange(n_img), per_image),
        num_ref_images=n_img, order=3)
    return SegVLADServer(
        sam=sam, dino=dino, index=index, full_hw=(448, 448),
        sam_hw=(224, 224), dino_layer=2, max_masks=32,
        amg=AmgConfig(points_per_side=8, points_per_batch=64,
                      pred_iou_thresh=-1e9, stability_score_thresh=0.0),
        **kw)


def _blob_image(rng, hw=(448, 448)):
    h, w = hw
    img = rng.integers(60, 200, (h, w, 3), dtype=np.uint8)
    yy, xx = np.ogrid[:h, :w]
    for _ in range(8):
        cy, cx = rng.integers(20, h - 20), rng.integers(20, w - 20)
        r = rng.integers(15, 60)
        img[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = rng.integers(0, 255, 3)
    return img


@pytest.mark.gpu
def test_live_database_and_pipelined_queries_on_the_card(cuda):
    """Inserts run the "shared" kernels; pipelined queries on 4 workers
    answer as sequential ones; inserted
    images are retrieved, a removed one is not, and a snapshot restores
    the same answers."""
    from revisit_anything_tpu_torch.pipeline.serve import SegVLADServer
    srv = _small_server(cuda, db_capacity=500 + 4 * 32, insert_chunk=4)
    rng = np.random.default_rng(11)
    imgs = [_blob_image(rng) for _ in range(4)]
    build.reset_counts()
    ids = srv.add_reference_images(imgs)
    assert ids == [50, 51, 52, 53] and srv.num_images == 54
    for k in (build.FLASH_ATTENTION, build.TOKEN_CROSS, build.I2T_UPDATE,
              build.MASK_HEAD, build.RESIZE_FLAGS):
        assert k.launches > 0, k.name
    queries = [np.clip(im.astype(np.int16) + rng.integers(-4, 5, im.shape),
                       0, 255).astype(np.uint8) for im in imgs]
    queries += [_blob_image(rng) for _ in range(4)]
    seq = [srv.query(q) for q in queries]
    for a, b in zip(srv.query_many(queries, workers=4), seq):
        np.testing.assert_array_equal(a, b)
    for iid, top in zip(ids, seq):
        assert iid in top, (iid, top)
    srv.remove_reference_image(ids[0])
    assert ids[0] not in srv.query(queries[0])
    fresh = SegVLADServer(sam=srv.sam, dino=srv.dino,
                          index=srv.snapshot_index(), full_hw=srv.full_hw,
                          sam_hw=srv.sam_hw, dino_layer=2, max_masks=32,
                          amg=srv.amg)
    for q in queries[:3]:
        np.testing.assert_array_equal(fresh.query(q), srv.query(q))


@pytest.mark.gpu
def test_bf16_database_knn_makes_no_f32_copy(cuda):
    """A bf16 database's one-shot kNN (bf16 products into f32 scores)
    allocates the score matrices, not an f32 copy of the database, and
    answers as the streaming tiles and the CPU do."""
    from revisit_anything_tpu_torch.pipeline import query as pq
    rng = np.random.default_rng(3)
    p, d, c, m, pca, nd = 64, 16, 4, 32, 256, 400_000
    desc = rng.standard_normal((p, d)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    masks = rng.random((m, p)) < 0.2
    args = [torch.from_numpy(x) for x in (
        desc, masks, np.eye(m, dtype=bool),
        rng.standard_normal((c, d)).astype(np.float32),
        np.zeros(c * d, np.float32),
        rng.standard_normal((pca, c * d)).astype(np.float32),
        np.ones(pca, np.float32))]
    g = torch.Generator(device=cuda).manual_seed(0)
    db = torch.randn((nd, pca), generator=g, device=cuda)
    db = (db / db.norm(dim=1, keepdim=True)).to(torch.bfloat16)
    ids = torch.arange(nd, device=cuda) // 100
    norms = pq.db_sq_norms(db)
    on_card = [a.to(cuda) for a in args]
    kw = dict(num_ref_images=nd // 100, db_norms=norms)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        one = pq.query_topk_images(*on_card, db, ids, **kw)
        torch.cuda.synchronize()
        grew = torch.cuda.max_memory_allocated() - before
        stream = pq.query_topk_images(*on_card, db, ids, oneshot_cap_bytes=1,
                                      **kw)
        cpu = pq.query_topk_images(*args, db.cpu(), ids.cpu(),
                                   num_ref_images=nd // 100,
                                   db_norms=norms.cpu())
    scores = m * nd * 4
    assert grew < 3 * scores < nd * pca * 4, (grew, scores)
    assert torch.equal(one, stream)
    assert torch.equal(one.cpu(), cpu)


def _offline_sam():
    """A small SAM on the CPU with every "shared" kernel's production
    widths (head dim 80, prompt dim 256), its point segmenter planted."""
    from revisit_anything_tpu_torch.models.sam import SamArchConfig
    from revisit_anything_tpu_torch.weights import (init_sam,
                                                    plant_point_segmenter)
    cfg = SamArchConfig(encoder_dim=320, encoder_depth=2, encoder_heads=4,
                        global_attn_indexes=(1,), image_size=256,
                        window_size=8, decoder_mlp_dim=512,
                        iou_head_hidden=64)
    gen = torch.Generator().manual_seed(3)
    sam = init_sam(cfg, gen, "cpu", torch.bfloat16)
    plant_point_segmenter(sam, gen)
    return sam


@pytest.mark.gpu
@pytest.mark.parametrize("windows", ["plain", "kernel"])
def test_generate_masks_batch_on_the_card_matches_the_cpu(cuda, windows):
    """A batch of two images (one encoder dispatch at B = 2) through the
    kernels keeps the masks the CPU plain path keeps from the same
    weights: the same count an image, 95% of the card's masks matching
    one of the CPU's at IoU > 0.5 (the smoke's agreement measure) and 90%
    at IoU > 0.9. bf16 kernels round differently from their bf16 plain
    versions, so a candidate near the NMS threshold may keep a neighbour
    instead (one of 32 masks an image did on an H100; the smoke's
    ``[window]`` finds plain and kernel windows' masks matched at
    0.992)."""
    import copy

    from revisit_anything_tpu_torch.models.sam.amg import (
        AmgConfig, generate_masks_batch)
    sam = _offline_sam()
    card = copy.deepcopy(sam).to(cuda)
    sam.encoder.window_attention = card.encoder.window_attention = windows
    rng = np.random.default_rng(21)
    imgs = [_blob_image(rng, (224, 224)) for _ in range(2)]
    amg = AmgConfig(points_per_side=8, points_per_batch=64,
                    pred_iou_thresh=-1e9, stability_score_thresh=0.0)
    build.reset_counts()
    got = generate_masks_batch(card, imgs, amg, max_masks=32)
    # with kernel windows the 16x16 global layer (256 tokens) takes the
    # window kernel too; with plain windows it takes flash attention once
    # for the batch's one encode
    encode = (build.WIN_ATTENTION if windows == "kernel"
              else build.FLASH_ATTENTION)
    for k in (encode, build.TOKEN_CROSS, build.I2T_UPDATE, build.MASK_HEAD,
              build.RESIZE_FLAGS):
        assert k.launches > 0, k.name
    assert encode.launches == (2 if windows == "kernel" else 1)
    want = generate_masks_batch(sam, imgs, amg, max_masks=32)
    for g, w in zip(got, want):
        assert len(g) == len(w) > 8
        gm = np.stack([r.segmentation for r in g]).reshape(len(g), -1)
        wm = np.stack([r.segmentation for r in w]).reshape(len(w), -1)
        inter = gm.astype(np.float32) @ wm.T.astype(np.float32)
        best = (inter / (gm.sum(1)[:, None] + wm.sum(1)[None, :] - inter)
                ).max(1)
        assert (best > 0.5).mean() >= 0.95, best
        assert (best > 0.9).mean() >= 0.9, best


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["cosine", "euclidean"])
def test_kmeans_iterations_on_the_card_match_the_cpu(cuda, mode):
    """Lloyd iterations from the same centers: the same labels, centers
    within 1e-5 (true f32 products, whatever the TF32 setting)."""
    from revisit_anything_tpu_torch.ops.kmeans import kmeans_iterate
    rng = np.random.default_rng(22)
    blobs = rng.standard_normal((16, 64)).astype(np.float32) * 2
    x = torch.from_numpy((blobs[rng.integers(0, 16, 20000)]
                          + rng.standard_normal((20000, 64))
                          ).astype(np.float32))
    c0 = x[torch.from_numpy(rng.choice(20000, 16, replace=False))]
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        cg, lg = kmeans_iterate(x.to(cuda), c0.to(cuda), 20, mode)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    cc, lc = kmeans_iterate(x, c0, 20, mode)
    assert torch.equal(lg.cpu(), lc)
    assert (cg.cpu() - cc).abs().max() <= 1e-5


@pytest.mark.gpu
def test_offline_retrieval_ops_on_the_card_match_the_cpu(cuda):
    """pca_apply (1e-5), knn_l2 (distances within 1e-5 relative, the same
    indices wherever the next and previous distances are more than 1e-5
    away) and weighted_borda_predict (the same ids, with planted ties) on
    the card against the CPU."""
    from revisit_anything_tpu_torch.ops.knn import knn_l2
    from revisit_anything_tpu_torch.ops.pca import PCAParams, pca_apply
    from revisit_anything_tpu_torch.retrieval.matching import (
        weighted_borda_predict)
    rng = np.random.default_rng(23)
    t = torch.from_numpy
    x = t(rng.standard_normal((3000, 2048)).astype(np.float32))
    params = PCAParams(t(rng.standard_normal(2048).astype(np.float32)),
                       t(rng.standard_normal((256, 2048)).astype(
                           np.float32)),
                       t(rng.random(256).astype(np.float32) + 0.5), True)
    on = PCAParams(*(a.to(cuda) for a in params[:3]), True)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        y_card = pca_apply(x.to(cuda), on).cpu()
        db = x[:2500] / x[:2500].norm(dim=1, keepdim=True)
        q = db[::50] + 0.05 * t(rng.standard_normal((50, 2048)).astype(
            np.float32))
        d_card, i_card = knn_l2(q.to(cuda), db.to(cuda), 200)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    y = pca_apply(x, params)
    assert ((y_card - y).abs().max() / y.abs().max()) <= 1e-5
    d, i = knn_l2(q, db, 200)
    assert ((d_card.cpu() - d).abs().max() / d.abs().max()) <= 1e-5
    gap = d.diff(dim=1).abs() > 1e-5 * d.abs().max()
    apart = torch.ones_like(i, dtype=torch.bool)
    apart[:, 1:] &= gap
    apart[:, :-1] &= gap
    assert torch.equal(i_card.cpu()[apart], i[apart])
    assert apart.float().mean() > 0.5

    n_q, n_ref = 50, 500
    q_ids = t(np.repeat(np.arange(n_q), 40))
    sims = t(rng.integers(0, 9, (n_q * 40, 50)).astype(np.float32) / 8.0)
    matches = t(rng.integers(0, 2500, (n_q * 40, 50)))
    ref_ids = t(np.repeat(np.arange(n_ref), 5))
    args = (sims, matches, q_ids, ref_ids)
    got = weighted_borda_predict(*(a.to(cuda) for a in args), n_q, n_ref)
    want = weighted_borda_predict(*args, n_q, n_ref)
    assert torch.equal(got.cpu(), want)
