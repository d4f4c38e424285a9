"""The CUDA kernel entries (in bf16, and their f32 forms) against their plain PyTorch versions on the card (marked
``gpu``; they skip where there is no CUDA device), plus the port's
import and dispatch contract, which holds everywhere.

This file imports no JAX, so the card's machine (which has none) runs it:
``python -m pytest tests/test_torch_kernels.py -m gpu --noconftest``.
"""

import ctypes
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from revisit_anything_tpu_torch.kernels import build
from revisit_anything_tpu_torch.kernels.probs_compare import (
    PROBS_F32_MOVED, bf16_ulps)
from revisit_anything_tpu_torch.kernels.tail_compare import (
    TAIL_F32_MOVED, TAIL_F32_MOVED_REL, moved_positions)
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


SAM_TOOL_MODULES = (
    "native", "models.sam.predictor", "models.sam.export", "datasets",
    "datasets.gt", "datasets.images", "datasets.aerial",
    "datasets.msls_prep", "datasets.vladbuff_val")


BACKBONE_TRAINING_MODULES = (
    "hub", "models.dinov1", "models.cosplace_vit", "models.resnet",
    "ops.posembed", "ops.resize", "training.aggregators", "training.losses",
    "training.train", "training.data", "training.checkpoint",
    "training.validation", "training.vladbuff", "retrieval.analysis")


CLI_MESH_MODULES = (
    "cli", "__main__", "parallel", "parallel.mesh", "parallel.data_parallel",
    "parallel.distributed", "parallel.sharded_knn", "utils",
    "utils.profiling", "utils.seeding", "retrieval.cluster_analysis",
    "parallel.collectives", "dryrun")


def test_port_imports_without_jax_or_nvcc():
    """The serving path, the fifteen modules of the offline pipeline,
    SAM's tools and the dataset loaders, the other backbones, the hub and
    training, the CLI, the mesh paths, profiling, seeding and the cluster
    analysis, the sharded train step and the multi-device dry run import
    on a machine with neither JAX in use nor nvcc (the
    kernels build at their first CUDA launch, ``native/maskops.cpp`` at
    its first call), and load none of h5py, PIL, cv2, sklearn,
    matplotlib, imageio, optax, orbax, transformers or pandas (the card's
    machine lacks some of them: they are imported where a function needs
    them)."""
    mods = ["pipeline.serve", "weights", "models.sam.convert",
            *OFFLINE_MODULES, *SAM_TOOL_MODULES, *BACKBONE_TRAINING_MODULES,
            *CLI_MESH_MODULES]
    code = ("import sys; " + "; ".join(
        f"import revisit_anything_tpu_torch.{m}" for m in mods) + "; "
            "from revisit_anything_tpu_torch.training.train import ("
            "make_sharded_train_step, param_sharding_rules, shard_model); "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'revisit_anything_tpu.')) or "
            "m.split('.')[0] in ('h5py', 'PIL', 'cv2', 'sklearn', "
            "'matplotlib', 'imageio', 'optax', 'orbax', 'transformers', "
            "'pandas')]; "
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
    assert len(build.KERNELS) == 25
    assert len({k.entry for k in build.KERNELS}) == 25
    for k in build.KERNELS:
        assert os.path.exists(os.path.join(REPO, k.source)), k.source
        path, line = k.replaces.split(":")
        with open(os.path.join(REPO, path)) as f:
            assert "pallas_call" in f.readlines()[int(line) - 1]


def test_smoke_phases_time_each_function():
    """``kernels.smoke_phases`` wraps a module's own functions in place
    (``chip_smoke.py``'s [phases] line): each adds its calls' wall
    seconds, a nested call of the same function adds nothing again, what
    the module imported stays as it was, and the line lists the longest
    first."""
    import time
    from revisit_anything_tpu_torch.kernels import smoke_phases
    ns = {"__name__": "a_smoke", "time": time}
    exec("def inner(n):\n"
         "    time.sleep(0.02)\n"
         "    return inner(n - 1) if n else 0\n"
         "def outer():\n"
         "    time.sleep(0.05)\n"
         "    return inner(2)\n", ns)
    seconds = {}
    smoke_phases.time_functions(ns, seconds)
    assert ns["time"] is time
    assert ns["outer"]() == 0
    assert set(seconds) == {"inner", "outer"}
    assert 0.06 <= seconds["inner"] < seconds["outer"]
    assert seconds["outer"] >= 0.11
    line = smoke_phases.report(seconds, least=0.0)
    assert line.index("outer") < line.index("inner")


def test_winattn_variants_patch_the_kernel_source():
    """Every variant of ``kernels.winattn_variants``, of B11's bf16 and f32
    forms, still finds the lines it replaces in ``win_attention.cu`` (the
    tool runs only on the card)."""
    from revisit_anything_tpu_torch.kernels import winattn_variants as wv
    base = wv._SRC.read_text()
    for name, (_, reps) in (*wv.VARIANTS.items(), *wv.F32_VARIANTS.items()):
        text = wv._source(reps)
        assert (text == base) == (not reps), name


def test_maskhead_variants_patch_the_kernel_source():
    """Every variant of ``kernels.maskhead_variants``, K3's, B6's, K3
    f32's and B6 f32's, still finds the lines it replaces in
    ``mask_head.cu`` (the tool runs only on the card)."""
    from revisit_anything_tpu_torch.kernels import maskhead_variants as mv
    base = mv._SRC.read_text()
    for name, (_, reps) in (*mv.VARIANTS.items(),
                            *mv.PROBS_VARIANTS.items(),
                            *mv.F32_VARIANTS.items(),
                            *mv.PROBS_F32_VARIANTS.items()):
        text = mv._source(reps)
        assert (text == base) == (not reps), name


def test_i2t_variants_patch_the_kernel_source():
    """Every variant of ``kernels.i2t_variants``, of K5's bf16 and f32
    forms, still finds the lines it replaces in ``i2t_update.cu`` (the tool
    runs only on the card)."""
    from revisit_anything_tpu_torch.kernels import i2t_variants as iv
    base = iv._SRC.read_text()
    for name, (_, reps) in (*iv.VARIANTS.items(), *iv.F32_VARIANTS.items()):
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


def test_probs_compare_stamps_the_f32_walk_loop():
    """``probs_compare --f32 --phases`` finds the f32 walk's tile loop in
    ``walk_f32.cuh`` and stamps it once at the top and once after each
    statement of its body, the products among them (the probe runs only
    on the card)."""
    from revisit_anything_tpu_torch.kernels import probs_compare as pc
    f, header, idx = pc._LOOPS[0]
    text = (build._CSRC / f).read_text()
    out, labels = pc._stamp(text, header, idx)
    assert out.count("rat_stamps[") == len(labels) + 1
    for call in ("rebuild<true", "scores<", "context("):
        assert any(call in label for label in labels), call
    assert out.replace(" " * 4 + pc._stamp_line(idx) + "\n", "").replace(
        "    int ns = 0;\n", "") == text


def test_probs_compare_walk_variants_patch_the_source():
    """Every setting of ``probs_compare --f32 --variants`` still finds the
    lines of ``walk_f32.cuh`` it replaces, and all but the build as it
    stands change the source (the timing runs only on the card)."""
    from revisit_anything_tpu_torch.kernels import probs_compare as pc
    text = (build._CSRC / "walk_f32.cuh").read_text()
    for name, reps in pc.WALK_VARIANTS.items():
        assert (pc._patched(text, reps) == text) == (not reps), name


def test_tail_variants_stamp_pass_b_loop():
    """``tail_variants``' phase probe stamps bf16 B3's pass B loop through
    the same rewrite (``kernels.stamps``): a stamp at the top and after
    each statement of the loop body, the products and the barriers among
    them, within the probe buffer's 32 stamps a tile, and nothing else of
    the source changed (the probe runs only on the card)."""
    from revisit_anything_tpu_torch.kernels import tail_variants as tv
    out, labels = tv._probe_source()
    assert out.count("clock64()") == len(labels) + 1 <= 32
    for call in ("rebuild_tc<false>(", "scores_tc(", "context_tc(",
                 "__syncthreads();"):
        assert any(call in label for label in labels), call
    line = tv.stamps.stamp("(m0 / BM)", tv.TILES,
                           "reinterpret_cast<long long*>(pr.c2m)", 32,
                           "WARPS")
    assert out.replace(" " * 4 + line + "\n", "").replace(
        "    int ns = 0;\n", "") == tv._SRC.read_text()


def _flash_inputs(cuda, b, n, dh, bias, seed=0, dtype=torch.bfloat16):
    g = torch.Generator(device=cuda).manual_seed(seed)
    bf = dtype
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


def _token_inputs(cuda, b, n, m, lead, pe, seed=1, dtype=torch.bfloat16):
    g = torch.Generator(device=cuda).manual_seed(seed)
    bf = dtype
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
# 1024 and ragged last key tiles (M = 1000, 1032); multi-crop AMG's 256
# prompts (a layer-1 crop's 16x16 grid), shared and per prompt.
TOKEN_CASES = [(True, 16, 7, 4096), (False, 16, 7, 4096),
               (True, 5, 7, 4096), (True, 20, 7, 1024), (True, 5, 8, 1000),
               (True, 4, 7, 1032), (False, 5, 8, 1024), (False, 3, 7, 1000),
               (True, 256, 7, 4096), (False, 256, 7, 4096)]


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


# K1 in f32: its products are three TF32 passes of split operands (each
# ~2^-21 of the product, the tensor core's sums in another order) and its
# exponentials ex2.approx; relative to the output's scale
F32_REL = 1e-5


# (batch, heads, N, Dh): DINOv1 ViT-S/8 at AnyLoc's settings (224x298,
# stride 4: N 4016), the shortest sequence DINO sends to K1, DINOv2-g's
# length at head dim 80, one key past a 64-row tile, ragged row tiles
F32_CASES = [(8, 6, 4016, 64), (1, 1, 1025, 64), (2, 1, 1531, 80),
             (1, 2, 65, 64), (2, 3, 200, 80)]


# and q, k x 2 (scores of std ~4, where one TF32 pass would be ~1e-3
# off), at a length whose Vᵀ rows are padded past N
F32_SCALED_CASE = (2, 3, 1025, 64)


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,n,dh,scale", [
    *(pytest.param(*c, 1.0, id="-".join(map(str, c))) for c in F32_CASES),
    pytest.param(*F32_SCALED_CASE, 2.0, id="2-3-1025-64-qk-x2")])
def test_flash_kernel_f32_matches_plain(cuda, b, h, n, dh, scale):
    g = torch.Generator(device=cuda).manual_seed(n)
    q, k, v = (torch.randn((b, h, n, dh), generator=g, device=cuda)
               for _ in range(3))
    q, k = q * scale, k * scale
    before = (build.FLASH_ATTENTION_F32.launches,
              build.FLASH_ATTENTION.launches)
    got = att.attend(q, k, v)
    want = att.attend_reference(q, k, v)
    again = att.attend(q, k, v)
    torch.cuda.synchronize()
    assert (build.FLASH_ATTENTION_F32.launches,
            build.FLASH_ATTENTION.launches) == (before[0] + 2, before[1])
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _rel_err(got, want) < F32_REL
    assert torch.equal(got, again)


@pytest.mark.gpu
def test_flash_kernel_refuses_grad_mode_and_other_dtypes(cuda):
    """K1 has no backward: under grad mode an input that requires grad
    raises (bf16 and f32); under no_grad or inference_mode it launches.
    f16 is not built; an f32 bias launches K1 f32 with the bias, and a
    bias it was not built for (side > 64, N != side²) raises."""
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn((1, 2, 1024, 64), generator=g, device=cuda)
               for _ in range(3))
    for dtype in (torch.float32, torch.bfloat16):
        qg = q.clone().to(dtype).requires_grad_(True)
        with pytest.raises(RuntimeError, match="no backward"):
            att.attend(qg, k.to(dtype), v.to(dtype))
    qg = q.clone().requires_grad_(True)
    before = build.FLASH_ATTENTION_F32.launches
    with torch.no_grad():
        a = att.attend(qg, k, v)
    with torch.inference_mode():
        b = att.attend(qg, k, v)
    torch.cuda.synchronize()
    assert build.FLASH_ATTENTION_F32.launches == before + 2
    assert torch.equal(a, b)
    with pytest.raises(ValueError):
        att.attend(q.half(), k.half(), v.half())
    bh = torch.zeros((1, 2, 1024, 32), device=cuda)
    before = (build.FLASH_ATTENTION_F32_BIAS.launches,
              build.FLASH_ATTENTION_F32.launches)
    with torch.no_grad():
        got = att.attend(q, k, v, bh, bh, side=32)
    torch.cuda.synchronize()
    assert (build.FLASH_ATTENTION_F32_BIAS.launches,
            build.FLASH_ATTENTION_F32.launches) == (before[0] + 1, before[1])
    assert _rel_err(got, att.attend_reference(q, k, v, bh, bh, side=32)
                    ) < F32_REL
    q65 = torch.randn((1, 2, 65 * 65, 64), generator=g, device=cuda)
    b65 = torch.zeros((1, 2, 65 * 65, 65), device=cuda)
    with pytest.raises(ValueError, match="side <= 64"):
        att.attend(q65, q65, q65, b65, b65, side=65)
    with pytest.raises(ValueError, match="side <= 64"):
        att.attend(q, k, v, bh[..., :31], bh[..., :31], side=31)


@pytest.mark.gpu
def test_dinov1_extraction_on_the_card_matches_the_cpu(cuda):
    """A DINOv1 f32 extraction at 1,288 tokens (136x160 at stride 4, head
    dim 64): K1 f32 in each block before the facet's, against the same
    model on the CPU (plain attention), within 1e-4 of the scale."""
    from revisit_anything_tpu_torch.models import dinov2 as dn
    from revisit_anything_tpu_torch.pipeline.extract import (
        dinov1_dense_features)
    from revisit_anything_tpu_torch.weights import init_dino
    cfg = dn.DinoV2Config(embed_dim=128, depth=3, num_heads=2, patch_size=8,
                          layerscale=False, pretrain_grid=(4, 4))
    cpu_model = init_dino(cfg, torch.Generator().manual_seed(0), "cpu",
                          torch.float32)
    gpu_model = init_dino(cfg, torch.Generator().manual_seed(0), "cpu",
                          torch.float32).to(cuda)
    imgs = np.random.default_rng(1).integers(0, 256, (2, 136, 160, 3),
                                             dtype=np.uint8)
    kw = dict(stride=4, layer=2, facet="key", load_size=136)
    before = build.FLASH_ATTENTION_F32.launches
    got = dinov1_dense_features(gpu_model, cfg, imgs, **kw)
    torch.cuda.synchronize()
    assert build.FLASH_ATTENTION_F32.launches == before + 2
    want = dinov1_dense_features(cpu_model, cfg, imgs, **kw)
    assert got.shape == want.shape == (2, 128, 136, 160)
    assert _rel_err(got.cpu(), want) < 1e-4


@pytest.mark.gpu
def test_train_step_on_the_card_matches_the_cpu(cuda):
    """Three VLAD-BuFF SGD steps of a small model on the card and on the
    CPU from the same weights and batches (TF32 off): losses within 1e-4
    relative and parameters within 1e-5 of each tensor's scale (the
    card's backward sums in another order; SGD's update is linear in the
    gradient, where AdamW's first steps move a parameter by ±lr whatever
    the size of its gradient, so a near-zero gradient's sign would decide
    it); the frozen blocks bit-identical on both."""
    import copy

    from revisit_anything_tpu_torch.models import dinov2 as dn
    from revisit_anything_tpu_torch.training import train as tr
    cfg = tr.VPRTrainConfig(backbone=dn.DinoV2Config(
        embed_dim=64, depth=3, num_heads=2, pretrain_grid=(4, 4)),
        num_trainable_blocks=2, clusters=8, optimizer="sgd", lr=0.05)
    cpu = tr.create_train_state(cfg, seed=0, device="cpu")
    start = copy.deepcopy(cpu.model)
    card = tr.create_train_state(cfg, model=copy.deepcopy(cpu.model).to(cuda))
    rng = np.random.default_rng(2)
    labels = np.repeat(np.arange(4), 4).astype(np.int64)
    for _ in range(3):
        base = 0.3 * rng.standard_normal((4, 56, 56, 3))
        imgs = (base[labels] + rng.standard_normal((16, 56, 56, 3))
                ).astype(np.float32)
        lc = tr.train_step(cpu, cfg, torch.from_numpy(imgs),
                           torch.from_numpy(labels))
        lg = tr.train_step(card, cfg, torch.from_numpy(imgs),
                           torch.from_numpy(labels))
        assert abs(lg.item() - lc.item()) <= 1e-4 * abs(lc.item())
    for (name, a), (_, b), (_, s) in zip(card.model.named_parameters(),
                                         cpu.model.named_parameters(),
                                         start.named_parameters()):
        assert _rel_err(a.detach().cpu(), b.detach()) < 1e-5, name
        if name.startswith("backbone.blocks.0."):
            assert torch.equal(a.cpu(), s) and torch.equal(b, s), name


@pytest.mark.gpu
def test_sharded_step_on_a_1x1_nccl_mesh_matches_train_step(cuda):
    """The sharded step on a 1x1 mesh (an NCCL group of one process, this
    one) against ``train_step`` from the same weights and batches on the
    card: three SGD steps, losses and parameters within 1e-5 relative
    (the NetVLAD softmax and global norm in another order), the frozen
    blocks bit for bit."""
    import copy

    import torch.distributed as dist

    from revisit_anything_tpu_torch.dryrun import free_port
    from revisit_anything_tpu_torch.models import dinov2 as dn
    from revisit_anything_tpu_torch.parallel import make_mesh
    from revisit_anything_tpu_torch.training import train as tr
    cfg = tr.VPRTrainConfig(backbone=dn.DinoV2Config(
        embed_dim=64, depth=3, num_heads=2, pretrain_grid=(4, 4)),
        num_trainable_blocks=2, clusters=8, optimizer="sgd", lr=0.05)
    one = tr.create_train_state(cfg, seed=0, device=cuda)
    start = copy.deepcopy(one.model)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        step_fn, sharded = tr.make_sharded_train_step(
            make_mesh((1, 1), ("data", "model"), devices=[cuda]), cfg,
            tr.create_train_state(cfg, model=copy.deepcopy(start)))
        rng = np.random.default_rng(2)
        labels = np.repeat(np.arange(4), 4).astype(np.int64)
        for _ in range(3):
            base = 0.3 * rng.standard_normal((4, 56, 56, 3))
            imgs = (base[labels] + rng.standard_normal((16, 56, 56, 3))
                    ).astype(np.float32)
            lo = tr.train_step(one, cfg, torch.from_numpy(imgs),
                               torch.from_numpy(labels))
            ls = step_fn(sharded, imgs, labels)
            assert abs(ls.item() - lo.item()) <= 1e-5 * abs(lo.item())
        got, _ = sharded.state_dicts()
    finally:
        dist.destroy_process_group()
    for (name, a), (_, s) in zip(one.model.named_parameters(),
                                 start.named_parameters()):
        assert _rel_err(got[name], a.detach()) < 1e-5, name
        if name.startswith("backbone.blocks.0."):
            assert torch.equal(got[name], s), name


def _win_inputs(cuda, b, side, heads, hd, seed=9, dtype=torch.bfloat16):
    g = torch.Generator(device=cuda).manual_seed(seed)
    bf = dtype
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


def _i2t_inputs(cuda, shared, b, m, seed=4, far=False, dtype=torch.bfloat16):
    """K5's operands; ``far``: head 0's logits sit ~500 above head 1's
    (q_0 and k_0 near +8, q_1 near -8), so a softmax shifted by the row's
    max over all heads would underflow head 1 to 0/0."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    bf = dtype

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
# is that half alone; b 256 is a multi-crop AMG crop's grid; far: head 0's logits ~500 above head 1's, where only
# a softmax shifted per head keeps head 1 from 0/0.
I2T_CASES = [(shared, b, m, False) for shared in (True, False)
             for b in (1, 3, 16, 256) for m in (64, 192, 4096)] + [
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


def _mask_head_inputs(cuda, np_, gg, m, d=256, seed=2, dtype=torch.bfloat16):
    g = torch.Generator(device=cuda).manual_seed(seed)
    bf = dtype

    def rnd(*shape, s=1.0, off=0.0):
        return (torch.randn(shape, generator=g, device=cuda) * s + off).to(bf)

    return (rnd(np_, gg, d), rnd(np_, m, d // 8, s=0.5),
            rnd(d, d, s=0.1), rnd(d // 4, s=0.1), rnd(d // 4, s=0.1, off=1.0),
            rnd(d // 4, s=0.1), rnd(d // 4, d // 2, s=0.1), rnd(d // 8, s=0.1))


# (prompts, gg, content, mask tokens): content a whole number of 64-row
# items (3136), a ragged last item (3130) and less than one item (37),
# each at M 1, 3 and 4 and at 1 prompt (most CTAs idle) and 8; then
# content = gg, where the last item reads past the tensor (zero-filled);
# multi-crop AMG's crops of a 240x320 image (gh 52 and 51 rows, 256
# prompts), and their single-mask decode.
MASK_HEAD_CASES = [(np_, 4096, content, m) for np_ in (1, 8)
                   for content in (3136, 3130, 37) for m in (1, 3, 4)] + [
    (2, 3130, 3130, 3), (3, 37, 37, 4), (256, 4096, 3328, 3),
    (256, 4096, 3264, 3), (256, 4096, 3328, 1)]


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
# pixels above and all below every threshold; multi-crop AMG's crops of
# a 240x320 image (SAM frames 820/815/824 x 1024, gh 52/51/52) at 256
# prompts
RESIZE_CASES = [
    ((240, 320), 16, 3, None, 1024), ((240, 320), 16, 1, None, 1024),
    ((240, 320), 8, 2, None, 1024), ((240, 320), 8, 4, None, 1024),
    ((240, 320), 301, 3, None, 1024), ((256, 256), 16, 3, None, 1024),
    ((320, 240), 16, 3, None, 1024), ((333, 250), 16, 1, None, 1024),
    ((224, 224), 16, 3, None, 256), ((600, 800), 4, 3, None, 1024),
    ((2000, 3000), 2, 3, None, 1024),
    ((240, 320), 4, 3, 20.0, 1024), ((240, 320), 4, 3, -20.0, 1024),
    ((161, 201), 256, 3, None, 1024), ((160, 201), 256, 3, None, 1024),
    ((161, 200), 256, 3, None, 1024),
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


# ---------------------------------------------------------------------------
# The f32 forms of the default SAM path's kernels (K1 with the bias, K2,
# K5, K3, K4): each against its plain version in f32 with TF32 off,
# within F32_REL of the output's scale (K4: flags equal but where the
# plain logit lies within F32_REL of its scale from a threshold).

F32_BIAS_CASES = [(1, 4096, 80), (1, 4096, 64), (2, 196, 80), (2, 1024, 64),
                  (1, 256, 80), (2, 64, 80)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,dh", F32_BIAS_CASES)
def test_flash_kernel_f32_bias_matches_plain(cuda, b, n, dh):
    """K1 f32 with the decomposed bias: SAM ViT-H's global layer (side
    64), head dim 64, sides 14, 32, 16 (the smoke's small SAM) and 8."""
    args, side = _flash_inputs(cuda, b, n, dh, True, dtype=torch.float32)
    before = (build.FLASH_ATTENTION_F32_BIAS.launches,
              build.FLASH_ATTENTION_F32.launches,
              build.FLASH_ATTENTION.launches)
    got = att.attend(*args, side=side)
    want = att.attend_reference(*args, side=side)
    again = att.attend(*args, side=side)
    torch.cuda.synchronize()
    assert (build.FLASH_ATTENTION_F32_BIAS.launches,
            build.FLASH_ATTENTION_F32.launches,
            build.FLASH_ATTENTION.launches) == (before[0] + 2, before[1],
                                                before[2])
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _rel_err(got, want) < F32_REL
    assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("b,dh", [(2, 80), (1, 64)])
def test_flash_kernel_f32_bias_side_64_scaled(cuda, b, dh):
    """K1 f32 at side 64 (bias_h staged in shared memory, bias_w in
    registers) with q, k x 2 and the bias x 4 (sharper softmaxes, bias
    terms that dominate the scores), over two batches of two heads (each
    (batch, head) its own bias rows), against the plain version."""
    (q, k, v, bh, bw), side = _flash_inputs(cuda, b, 4096, dh, True, seed=8,
                                            dtype=torch.float32)
    args = (q * 2.0, k * 2.0, v, bh * 4.0, bw * 4.0)
    got = att.attend(*args, side=side)
    want = att.attend_reference(*args, side=side)
    torch.cuda.synchronize()
    assert _rel_err(got, want) < F32_REL


# K2 f32's cases: TOKEN_CASES (their ids as before), then q and kvt x 2
# (scores of std ~4, where one TF32 pass would miss by ~1e-3) shared and
# per prompt, and a shared k|v over 150 prompts (1,050 stacked rows: the
# last CTA's 128 rows are ragged)
TOKEN_F32_CASES = [
    *(pytest.param(*c, 1.0, id="-".join(map(str, c))) for c in TOKEN_CASES),
    pytest.param(True, 64, 7, 4096, 2.0, id="True-64-7-4096-x2"),
    pytest.param(False, 16, 7, 4096, 2.0, id="False-16-7-4096-x2"),
    pytest.param(True, 150, 7, 4096, 1.0, id="True-150-7-4096")]


@pytest.mark.gpu
@pytest.mark.parametrize("shared,b,n,m,scale", TOKEN_F32_CASES)
def test_token_cross_kernel_f32_matches_plain(cuda, shared, b, n, m, scale):
    q, kvt, pe, vb = _token_inputs(cuda, b, n, m, 1 if shared else b,
                                   pe=True, dtype=torch.float32)
    args = (q * scale, kvt * scale, pe, vb)
    before = (build.TOKEN_CROSS_F32.launches, build.TOKEN_CROSS.launches)
    got = att.token_cross_attend_kv(*args, 8)
    want = att.token_cross_attend_kv_reference(*args, 8)
    torch.cuda.synchronize()
    assert (build.TOKEN_CROSS_F32.launches,
            build.TOKEN_CROSS.launches) == (before[0] + 1, before[1])
    assert got.dtype == torch.float32
    assert got.shape == want.shape == (b, n, 128)
    assert _rel_err(got, want) < F32_REL


# B10 f32's cases: TOKEN_CASES (both schedules, n 7 and 8, ragged M), then
# q and kᵀ x 2 (scores of std ~4, where one TF32 pass would miss by ~1e-3)
# shared at n 7 and per prompt at n 8
TOKEN_SPLIT_F32_CASES = [
    *(pytest.param(*c, 1.0, id="-".join(map(str, c))) for c in TOKEN_CASES),
    pytest.param(True, 64, 7, 4096, 2.0, id="True-64-7-4096-x2"),
    pytest.param(False, 16, 8, 4096, 2.0, id="False-16-8-4096-x2")]


@pytest.mark.gpu
@pytest.mark.parametrize("shared,b,n,m,scale", TOKEN_SPLIT_F32_CASES)
def test_token_cross_split_kernel_f32_matches_plain(cuda, shared, b, n, m,
                                                    scale):
    """B10 f32 (K2 f32's kernel without pe and v bias) against its plain
    version in f32."""
    q, kt, vt = _token_inputs(cuda, b, n, m, 1 if shared else b, pe=False,
                              seed=8, dtype=torch.float32)
    args = (q * scale, kt * scale, vt)
    before = (build.TOKEN_CROSS_SPLIT_F32.launches,
              build.TOKEN_CROSS_SPLIT.launches)
    got = att.token_cross_attend(*args, 8)
    want = att.token_cross_attend_reference(*args, 8)
    torch.cuda.synchronize()
    assert (build.TOKEN_CROSS_SPLIT_F32.launches,
            build.TOKEN_CROSS_SPLIT.launches) == (before[0] + 1, before[1])
    assert got.dtype == torch.float32
    assert got.shape == want.shape == (b, n, 128)
    assert _rel_err(got, want) < F32_REL


# B11 f32's cases: WIN_CASES (SAM ViT-H's windowed layer and one window of
# it, head dim 64, side 16, N = 25, sides 20 and 31 at both head dims: K
# and V stream through the ring at every side), then q x 4 (scores of std
# ~4, where one TF32 pass would miss by ~1e-3) at the served window and at
# side 16 with head dim 64
WIN_F32_CASES = [
    *(pytest.param(*c, 1.0, id="-".join(map(str, c))) for c in WIN_CASES),
    pytest.param(4, 14, 4, 80, 4.0, id="4-14-4-80-q-x4"),
    pytest.param(2, 16, 2, 64, 4.0, id="2-16-2-64-q-x4")]


@pytest.mark.gpu
@pytest.mark.parametrize("b,side,heads,hd,scale", WIN_F32_CASES)
def test_win_attention_kernel_f32_matches_plain(cuda, b, side, heads, hd,
                                                scale):
    """B11 f32 against its plain version in f32, from the SAM shape to N =
    961, twice on the same inputs (bit for bit)."""
    qkv, bh, bw = _win_inputs(cuda, b, side, heads, hd, dtype=torch.float32)
    qkv[..., :heads * hd] *= scale
    before = (build.WIN_ATTENTION_F32.launches, build.WIN_ATTENTION.launches)
    got = wa.windowed_attend(qkv, bh, bw, heads, side)
    want = wa.windowed_attend_reference(qkv, bh, bw, heads, side)
    again = wa.windowed_attend(qkv, bh, bw, heads, side)
    torch.cuda.synchronize()
    assert (build.WIN_ATTENTION_F32.launches,
            build.WIN_ATTENTION.launches) == (before[0] + 2, before[1])
    assert got.dtype == torch.float32
    assert got.shape == want.shape == (b, side * side, heads * hd)
    assert _rel_err(got, want) < F32_REL
    assert torch.equal(got, again)


# K5 f32's cases: I2T_CASES (their ids as before), then the branch and the
# token keys x 4 (sharper softmaxes; one TF32 pass would miss by ~5e-4) on
# the shared branch and per prompt
I2T_F32_CASES = [
    *(pytest.param(*c, 1.0, id="-".join(map(str, c))) for c in I2T_CASES),
    pytest.param(True, 16, 4096, False, 4.0, id="True-16-4096-x4"),
    pytest.param(False, 16, 4096, False, 4.0, id="False-16-4096-x4")]


@pytest.mark.gpu
@pytest.mark.parametrize("shared,b,m,far,scale", I2T_F32_CASES)
def test_i2t_update_kernel_f32_matches_plain(cuda, shared, b, m, far, scale):
    args = list(_i2t_inputs(cuda, shared, b, m, seed=5 if far else 4,
                            far=far, dtype=torch.float32))
    args[0], args[2] = args[0] * scale, args[2] * scale
    before = (build.I2T_UPDATE_F32.launches, build.I2T_UPDATE.launches)
    keys, kvt = att.i2t_update(*args, 8, 1e-6)
    want_keys, want_kvt = att.i2t_update_reference(*args, 8, 1e-6)
    torch.cuda.synchronize()
    assert (build.I2T_UPDATE_F32.launches,
            build.I2T_UPDATE.launches) == (before[0] + 1, before[1])
    assert keys.dtype == kvt.dtype == torch.float32
    assert keys.shape == (b, m, 256) and kvt.shape == (b, 256, m)
    # logits near +-500 (far) carry f32 rounding of ulp(500) = 3e-5 into
    # each exponent, on both sides
    tol = 20 * F32_REL if far else F32_REL
    assert _rel_err(keys, want_keys) < tol
    assert _rel_err(kvt, want_kvt) < tol


@pytest.mark.gpu
def test_i2t_update_kernel_f32_shared_branch_is_the_repeated_branch(cuda):
    """K5 f32 on a shared [1, M, 256] branch (q once a position block,
    kept for every prompt) and on the same branch repeated to [B, M, 256]
    (q a prompt) gives the same keys and kvT, bit for bit."""
    args = list(_i2t_inputs(cuda, True, 5, 4096, dtype=torch.float32))
    keys, kvt = att.i2t_update(*args, 8, 1e-6)
    args[0] = args[0].expand(5, -1, -1).contiguous()
    keys_b, kvt_b = att.i2t_update(*args, 8, 1e-6)
    torch.cuda.synchronize()
    assert torch.equal(keys, keys_b) and torch.equal(kvt, kvt_b)


@pytest.mark.gpu
def test_i2t_update_f32_scratch_is_the_kernels(cuda):
    """The wrapper allocates the scratch K5 f32 takes (its weight split,
    layer 1's q)."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert (att.i2t_f32_scratch(cuda)
            == build.load().rat_i2t_update_f32_scratch(sms))


@pytest.mark.gpu
@pytest.mark.parametrize("np_,gg,content,m", MASK_HEAD_CASES)
def test_mask_head_kernel_f32_matches_plain(cuda, np_, gg, content, m):
    args = _mask_head_inputs(cuda, np_, gg, m, dtype=torch.float32)
    before = (build.MASK_HEAD_F32.launches, build.MASK_HEAD.launches)
    got = mh.fused_mask_head(*args, eps=1e-6, content=content)
    want = mh.upscale_masks_blocks(args[0][:, :content], *args[1:], eps=1e-6)
    torch.cuda.synchronize()
    assert (build.MASK_HEAD_F32.launches,
            build.MASK_HEAD.launches) == (before[0] + 1, before[1])
    assert got.dtype == torch.float32
    assert got.shape == want.shape == (np_, content, 16, m)
    assert _rel_err(got, want) < F32_REL


@pytest.mark.gpu
@pytest.mark.parametrize("content,m", [(3130, 1), (3130, 4), (37, 3)])
def test_mask_head_kernel_f32_scaled_keys(cuda, content, m):
    """K3 f32 with the keys x 8 (conv1's products far from the weights'
    scale, where one TF32 pass would miss by ~1e-4) at contents that are
    not a whole number of 64-position items, M 1, 4 and 3."""
    args = list(_mask_head_inputs(cuda, 8, 4096, m, seed=9,
                                  dtype=torch.float32))
    args[0] = args[0] * 8.0
    got = mh.fused_mask_head(*args, eps=1e-6, content=content)
    want = mh.upscale_masks_blocks(args[0][:, :content], *args[1:], eps=1e-6)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (8, content, 16, m)
    assert _rel_err(got, want) < F32_REL


@pytest.mark.gpu
def test_mask_head_kernel_f32_is_bitwise_repeatable(cuda):
    """Two launches of K3 f32 on the same inputs give the same bits."""
    args = _mask_head_inputs(cuda, 8, 4096, 3, dtype=torch.float32)
    first, second = (mh.fused_mask_head(*args, eps=1e-6, content=3130)
                     for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.gpu
def test_mask_head_f32_scratch_is_the_kernels(cuda):
    """The wrapper allocates the scratch K3 f32 takes (its weight split)."""
    assert mh.mask_head_f32_scratch() == build.load().rat_mask_head_f32_scratch()


@pytest.mark.gpu
@pytest.mark.parametrize("orig_hw,np_,m,const,side", RESIZE_CASES)
def test_resize_kernel_f32_matches_plain(cuda, orig_hw, np_, m, const, side):
    x, whd, wwd, grid = _resize_inputs(cuda, orig_hw, np_, m, const=const,
                                       side=side)
    x = x.float() + 0.01 * torch.randn(
        x.shape, generator=torch.Generator(device=cuda).manual_seed(1),
        device=cuda)
    taps = tuple(t.to(cuda) for t in mr.resize_taps(whd, wwd, torch.float32))
    before = (build.RESIZE_FLAGS_F32.launches, build.RESIZE_FLAGS.launches)
    flags, rowst, colany = mr.fused_resize_flags(x, whd, wwd, 0.0, 1.0,
                                                 grid, taps=taps)
    want = mr.resize_flags_reference(x, whd, wwd, 0.0, 1.0, grid)
    torch.cuda.synchronize()
    assert (build.RESIZE_FLAGS_F32.launches,
            build.RESIZE_FLAGS.launches) == (before[0] + 1, before[1])
    near = mr.near_threshold(mr.resize_logits_reference(x, whd, wwd, grid),
                             (-1.0, 0.0, 1.0), F32_REL)
    assert not bool(((flags != want) & ~near).any())
    own_rowst, own_colany = mr.flag_stats(flags)
    assert torch.equal(rowst, own_rowst)
    assert torch.equal(colany, own_colany)


@pytest.mark.gpu
def test_f32_kernels_dispatch_on_dtype(cuda):
    """The wrappers with an f32 form (the five of the default SAM path,
    the window kernel, B10, B7, B8, B6 and B3 in its three modes) send
    bf16 CUDA tensors to the bf16 kernels, f32 ones to the f32 kernels,
    and raise on f16. B7 and B8 pick by their token vectors' dtype, B6 by
    img0's, B3 by the token state's; their P stays bf16, and B7's output
    is bf16 at every dtype. B3's probability mode on f32 is one launch of
    the f32 entry that also serves its keys mode."""
    flash, side = _flash_inputs(cuda, 1, 256, 80, True)
    token = _token_inputs(cuda, 4, 7, 1024, 1, pe=True)
    split = _token_inputs(cuda, 4, 7, 1024, 4, pe=False)
    win = _win_inputs(cuda, 2, 14, 2, 80)
    i2t = _i2t_inputs(cuda, True, 4, 128)
    head = _mask_head_inputs(cuda, 2, 128, 3)
    x, whd, wwd, grid = _resize_inputs(cuda, (240, 320), 2, 3)
    pr = _probs_inputs(cuda, b=4, m=128)
    hp = _mask_head_probs_args(cuda, 4, 3, gg=128)
    tail = _tail_args(cuda, 4, 128, True)
    calls = {
        (build.FLASH_ATTENTION, build.FLASH_ATTENTION_F32_BIAS):
            lambda c: att.attend(*c(flash), side=side),
        (build.TOKEN_CROSS, build.TOKEN_CROSS_F32):
            lambda c: att.token_cross_attend_kv(*c(token), 8),
        (build.TOKEN_CROSS_SPLIT, build.TOKEN_CROSS_SPLIT_F32):
            lambda c: att.token_cross_attend(*c(split), 8),
        (build.WIN_ATTENTION, build.WIN_ATTENTION_F32):
            lambda c: wa.windowed_attend(*c(win), 2, 14),
        (build.I2T_UPDATE, build.I2T_UPDATE_F32):
            lambda c: att.i2t_update(*c(i2t), 8, 1e-6),
        (build.MASK_HEAD, build.MASK_HEAD_F32):
            lambda c: mh.fused_mask_head(*c(head), eps=1e-6),
        (build.RESIZE_FLAGS, build.RESIZE_FLAGS_F32):
            lambda c: mr.fused_resize_flags(*c((x,)), whd, wwd, 0.0, 1.0,
                                            grid),
        (build.I2T_PROBS, build.I2T_PROBS_F32):
            lambda c: dpr.i2t_probs(None, *c((pr["tok_k"],)), 8, layer=2,
                                    recon=c((pr["img0"],)) + (pr["p1"],)
                                    + c((pr["c1"], pr["peqt"], pr["w"],
                                         pr["rows"]))),
        (build.T2I_PROBS, build.T2I_PROBS_F32):
            lambda c: dpr.t2i_from_probs(
                *c((pr["q"], pr["img0"])), pr["p1"], *c((pr["c1"],)),
                pr["p2"], *c((pr["c2"], pr["w"], pr["w_v"], pr["peqt"],
                              pr["rows"], pr["v_bias"])), 8),
        (build.MASK_HEAD_PROBS, build.MASK_HEAD_PROBS_F32):
            lambda c: mh.fused_mask_head_probs(
                *c(hp[:1]), hp[1], *c(hp[2:3]), hp[3], *c(hp[4:]),
                content=120),
        (build.DECODE_TAIL, build.DECODE_TAIL_F32):
            lambda c: dfu.decode_tail_fused(tail[0], *c(tail[1:10]),
                                            *tail[10:]),
        (build.DECODE_TAIL_LOGITS, build.DECODE_TAIL_LOGITS_F32):
            lambda c: dfu.decode_tail_fused(tail[0], *c(tail[1:10]), 8,
                                            mask_head=True, content=100),
    }

    def cast(dtype):
        return lambda args: tuple(None if a is None else a.to(dtype)
                                  for a in args)

    for (k_bf16, k_f32), call in calls.items():
        for dtype, kernel in ((torch.bfloat16, k_bf16),
                              (torch.float32, k_f32)):
            build.reset_counts()
            out = call(cast(dtype))
            torch.cuda.synchronize()
            counts = {k.name: k.launches for k in build.KERNELS if k.launches}
            assert counts == {kernel.name: 1}, counts
            first = out[0] if isinstance(out, tuple) else out
            if k_bf16 is build.I2T_PROBS:
                assert first.dtype == torch.bfloat16
            else:
                assert first.dtype in (dtype, torch.uint8)
        with pytest.raises(ValueError, match="not built|float16"):
            call(cast(torch.float16))
    build.reset_counts()
    out = dfu.decode_tail_fused(tail[0], *cast(torch.float32)(tail[1:10]), 8)
    torch.cuda.synchronize()
    counts = {k.name: k.launches for k in build.KERNELS if k.launches}
    assert counts == {build.DECODE_TAIL_F32.name: 1}, counts
    assert [o.dtype for o in out] == [torch.float32, torch.bfloat16,
                                      torch.bfloat16, torch.float32]


@pytest.mark.gpu
@pytest.mark.parametrize("windows", ["plain", "kernel"])
def test_generate_masks_batch_f32_on_the_card_matches_the_cpu(cuda, windows):
    """An f32 SAM (the JAX package's default dtype) on two images through
    the f32 kernels, and no bf16 kernel, keeps the masks the CPU's f32
    plain path keeps from the same weights: the same count an image and
    every mask at IoU >= 0.95 with one of the CPU's. With kernel windows
    the windowed layer and the 16x16 global layer take B11 f32 (2
    launches) in K1 f32's place."""
    import copy

    from revisit_anything_tpu_torch.models.sam.amg import (
        AmgConfig, generate_masks_batch)
    sam = _offline_sam(torch.float32)
    card = copy.deepcopy(sam).to(cuda)
    sam.encoder.window_attention = card.encoder.window_attention = windows
    rng = np.random.default_rng(21)
    imgs = [_blob_image(rng, (224, 224)) for _ in range(2)]
    amg = AmgConfig(points_per_side=8, points_per_batch=64,
                    pred_iou_thresh=-1e9, stability_score_thresh=0.0)
    build.reset_counts()
    got = generate_masks_batch(card, imgs, amg, max_masks=32)
    encode = (build.WIN_ATTENTION_F32 if windows == "kernel"
              else build.FLASH_ATTENTION_F32_BIAS)
    f32 = (encode, build.TOKEN_CROSS_F32, build.I2T_UPDATE_F32,
           build.MASK_HEAD_F32, build.RESIZE_FLAGS_F32)
    counts = {k.name: k.launches for k in build.KERNELS if k.launches}
    assert sorted(counts) == sorted(k.name for k in f32), counts
    assert encode.launches == (2 if windows == "kernel" else 1)
    want = generate_masks_batch(sam, imgs, amg, max_masks=32)
    for g, w in zip(got, want):
        assert len(g) == len(w) > 8
        gm = np.stack([r.segmentation for r in g]).reshape(len(g), -1)
        wm = np.stack([r.segmentation for r in w]).reshape(len(w), -1)
        inter = gm.astype(np.float32) @ wm.T.astype(np.float32)
        best = (inter / (gm.sum(1)[:, None] + wm.sum(1)[None, :] - inter)
                ).max(1)
        assert (best >= 0.95).all(), best


def _probs_inputs(cuda, b=16, m=4096, seed=5, dtype=torch.bfloat16):
    """Inputs of the probability-factored decode kernels at the serving
    widths (D 256, DA 128, 8 heads, 7 tokens) for ``b`` prompts: P bf16,
    every other tensor in ``dtype``."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    bf = torch.bfloat16

    def rnd(*shape, s=1.0, off=0.0):
        return (torch.randn(shape, generator=g, device=cuda) * s + off).to(
            dtype)

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
                v_bias=rnd(128, s=0.1), rows=rows.to(dtype))


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
@pytest.mark.parametrize("layer,b,m,ln_scale", PROBS_CASES)
def test_i2t_probs_kernel_f32_matches_plain(cuda, layer, b, m, ln_scale):
    """B7 f32 (f32 q1st, token keys, img0, C1, pe, W_q and rows; P1 bf16)
    against its plain version in f32 with TF32 off: its bf16 P within one
    ulp everywhere, moved in at most PROBS_F32_MOVED of its elements."""
    x = _large_branch(_probs_inputs(cuda, b=b, m=m, dtype=torch.float32),
                      ln_scale, 1)
    recon = (x["img0"], x["p1"], x["c1"], x["peqt"], x["w"], x["rows"])
    kw = dict(layer=layer, recon=recon if layer == 2 else None)
    q1st = x["q1st"] if layer == 1 else None
    before = build.I2T_PROBS_F32.launches
    got = dpr.i2t_probs(q1st, x["tok_k"], 8, **kw)
    want = dpr.i2t_probs_reference(q1st, x["tok_k"], 8, **kw)
    torch.cuda.synchronize()
    assert build.I2T_PROBS_F32.launches == before + 1
    assert got.dtype == want.dtype == torch.bfloat16
    assert got.shape == want.shape == (b, 56, m)
    if ln_scale > 1.0 and layer == 2:
        keys1 = dpr.recon_branch(x["img0"], [x["p1"]], [x["c1"]], x["rows"],
                                 1e-6)
        assert keys1.abs().max().item() > 65504
    ulps, moved = bf16_ulps(got, want)
    assert ulps <= 1.0
    assert moved <= PROBS_F32_MOVED


@pytest.mark.gpu
@pytest.mark.parametrize("depth,b,m,ln_scale", PROBS_CASES)
def test_t2i_from_probs_kernel_f32_matches_plain(cuda, depth, b, m, ln_scale):
    """B8 f32 (f32 q, img0, C, pe, weights and rows; P bf16) within
    F32_REL of its plain version in f32 with TF32 off; the output f32."""
    x = _large_branch(_probs_inputs(cuda, b=b, m=m, dtype=torch.float32),
                      ln_scale, depth)
    p2, c2 = (x["p2"], x["c2"]) if depth == 2 else (None, None)
    args = (x["q"], x["img0"], x["p1"], x["c1"], p2, c2, x["w"], x["w_v"],
            x["peqt"], x["rows"], x["v_bias"], 8)
    before = build.T2I_PROBS_F32.launches
    got = dpr.t2i_from_probs(*args)
    want = dpr.t2i_from_probs_reference(*args)
    torch.cuda.synchronize()
    assert build.T2I_PROBS_F32.launches == before + 1
    assert got.dtype == want.dtype == torch.float32
    assert got.shape == want.shape == (b, 7, 128)
    if ln_scale > 1.0:
        ps, cs = [x["p1"], x["p2"]][:depth], [x["c1"], x["c2"]][:depth]
        keys = dpr.recon_branch(x["img0"], ps, cs, x["rows"], 1e-6)
        assert keys.abs().max().item() > 65504
    assert torch.isfinite(got).all()
    assert _rel_err(got, want) < F32_REL


def _f32_walk(x, walk):
    """One f32 walk on inputs ``x``: B7 f32 layer 2 ("b7") or B8 f32 at
    depth 1 or 2 ("b8-1", "b8-2")."""
    if walk == "b7":
        recon = (x["img0"], x["p1"], x["c1"], x["peqt"], x["w"], x["rows"])
        return dpr.i2t_probs(None, x["tok_k"], 8, layer=2, recon=recon)
    deep = walk == "b8-2"
    return dpr.t2i_from_probs(x["q"], x["img0"], x["p1"], x["c1"],
                              x["p2"] if deep else None,
                              x["c2"] if deep else None, x["w"], x["w_v"],
                              x["peqt"], x["rows"], x["v_bias"], 8)


@pytest.mark.gpu
@pytest.mark.parametrize("walk", ["b7", "b8-1", "b8-2"])
def test_f32_walks_are_bitwise_repeatable_and_permute_with_prompts(cuda,
                                                                   walk):
    """The f32 walks (two warpgroups a prompt, their online-softmax states
    merged in a fixed order) give the same bits from call to call, and a
    prompt's output does not depend on where it sits in the batch."""
    x = _probs_inputs(cuda, b=12, m=512, dtype=torch.float32)
    first, again = _f32_walk(x, walk), _f32_walk(x, walk)
    perm = torch.arange(11, -1, -1, device=cuda)
    xp = dict(x, **{k: x[k][perm] for k in ("tok_k", "q", "p1", "p2", "c1",
                                              "c2")})
    moved = _f32_walk(xp, walk)
    torch.cuda.synchronize()
    assert torch.equal(first, again)
    assert torch.equal(moved, first[perm])


@pytest.mark.gpu
@pytest.mark.parametrize("where", ["odd-tiles", "even-tiles", "first-half"])
def test_t2i_from_probs_kernel_f32_merges_its_softmax_states(cuda, where):
    """B8 f32 at both depths where the scores peak in one warpgroup's
    16-position tiles only (odd or even tiles: the pe term 3x larger
    there) or in the first half of the positions: the merge of the two
    warpgroups' states, one of them scaled far down, within F32_REL of the
    plain version."""
    x = _probs_inputs(cuda, b=16, m=1024, dtype=torch.float32)
    tile = torch.arange(1024, device=cuda) // 16
    sel = {"odd-tiles": tile % 2 == 1, "even-tiles": tile % 2 == 0,
           "first-half": tile < 32}[where]
    x["peqt"] = torch.where(sel, x["peqt"] * 3.0, x["peqt"])
    for depth in (1, 2):
        p2, c2 = (x["p2"], x["c2"]) if depth == 2 else (None, None)
        args = (x["q"], x["img0"], x["p1"], x["c1"], p2, c2, x["w"],
                x["w_v"], x["peqt"], x["rows"], x["v_bias"], 8)
        got = dpr.t2i_from_probs(*args)
        want = dpr.t2i_from_probs_reference(*args)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        assert _rel_err(got, want) < F32_REL


@pytest.mark.gpu
@pytest.mark.parametrize("klimit", [32, 480, 512])
def test_t2i_probs_f32_keys_stores_the_depth2_rebuild(cuda, klimit):
    """rat_t2i_probs_f32_keys (B3 f32's final walk) stores keys2, the
    depth-2 rebuild, for the positions below klimit into [b, klimit, D]
    (within F32_REL of the plain rebuild's scale: the rebuild is exact up
    to summation order) and writes nothing past it; its attention output
    is the depth-2 walk's without the store, bit for bit."""
    b, m = 8, 512
    x = _probs_inputs(cuda, b=b, m=m, dtype=torch.float32)
    args = (x["q"], x["img0"], x["p1"], x["c1"], x["p2"], x["c2"], x["w"],
            x["w_v"], x["peqt"], x["rows"], x["v_bias"], 8)
    ptrs = [None if a is None else build.operand(*a).data_ptr()
            for a in dpr.t2i_operands(*args)]
    out = torch.empty((b, 7, 128), device=cuda)
    keys = torch.full((b * klimit + 32, 256), 7.0, device=cuda)   # [b, klimit, D] + 32 rows
    lib = build.load()
    err = lib.rat_t2i_probs_f32_keys(
        *ptrs, out.data_ptr(), keys.data_ptr(), b, m, klimit, 1e-6,
        torch.cuda.current_stream().cuda_stream)
    assert err == 0
    want = dpr.recon_branch(x["img0"], [x["p1"], x["p2"]],
                            [x["c1"], x["c2"]], x["rows"], 1e-6)
    attend = dpr.t2i_from_probs(*args)
    torch.cuda.synchronize()
    got = keys[:b * klimit].view(b, klimit, 256)
    assert _rel_err(got, want[:, :klimit]) < F32_REL
    assert (keys[b * klimit:] == 7.0).all()
    assert torch.equal(out, attend)


@pytest.mark.gpu
def test_probs_split_decodes_an_f32_sam_on_f32_kernels(cuda):
    """An f32 SAM's "probs_split" decode runs on the f32 kernels alone (K2
    f32 once, B7 f32 and B8 f32 twice each, B6 f32 once) and gives finite
    f32 masks within 1e-2 of their scale of the same decode with those
    four swapped for their plain f32 versions (TF32 off). B7's P is bf16 in
    both, and where a probability rounds the other way (one bf16 ulp,
    2^-8 of it, in at most PROBS_F32_MOVED of P) a logit moves by at most
    ~2^-8 of its scale; the other kernels are within 1e-5."""
    from revisit_anything_tpu_torch.models.sam import decoder
    sam = _offline_sam(torch.float32).to(cuda)
    cfg = sam.cfg
    g, d = cfg.grid, cfg.prompt_dim
    gen = torch.Generator(device=cuda).manual_seed(8)
    emb, pe = (torch.randn((g, g, d), generator=gen, device=cuda)
               for _ in range(2))
    sparse = torch.randn((64, 2, d), generator=gen, device=cuda)
    dense = torch.randn((1, g, g, d), generator=gen, device=cuda)

    def run():
        with torch.inference_mode():
            return decoder.decode_masks(sam.decoder, cfg, emb, pe, sparse,
                                        dense, decode="probs_split")

    build.reset_counts()
    masks, iou = run()
    torch.cuda.synchronize()
    counts = {k.name: k.launches for k in build.KERNELS if k.launches}
    assert counts == {build.TOKEN_CROSS_F32.name: 1,
                      build.I2T_PROBS_F32.name: 2,
                      build.T2I_PROBS_F32.name: 2,
                      build.MASK_HEAD_PROBS_F32.name: 1}, counts
    assert masks.dtype == iou.dtype == torch.float32
    assert torch.isfinite(masks).all() and torch.isfinite(iou).all()
    plain = {"token_cross_attend_kv": att.token_cross_attend_kv_reference,
             "i2t_probs": dpr.i2t_probs_reference,
             "t2i_from_probs": dpr.t2i_from_probs_reference,
             "fused_mask_head_probs": mh.mask_head_probs_reference}
    kept = {name: getattr(decoder, name) for name in plain}
    try:
        for name, fn in plain.items():
            setattr(decoder, name, fn)
        build.reset_counts()
        want, want_iou = run()
        torch.cuda.synchronize()
        assert not any(k.launches for k in build.KERNELS)
    finally:
        for name, fn in kept.items():
            setattr(decoder, name, fn)
    assert masks.shape == want.shape
    assert _rel_err(masks, want) < 1e-2
    assert _rel_err(iou, want_iou) < 1e-2


@pytest.mark.gpu
@pytest.mark.parametrize("decode", ["fused_tail_keys", "fused_tail_logits",
                                    "fused_tail_probs"])
def test_fused_tail_decodes_an_f32_sam_on_f32_kernels(cuda, decode):
    """An f32 SAM's "fused_tail_keys", "fused_tail_logits" and
    "fused_tail_probs" decodes run on the f32 kernels alone (K2 f32 once,
    then B3 f32 in keys mode and K3 f32, the B3 f32 logits entry, or B3
    f32 in probability mode and B6 f32) and give finite f32 masks within
    1e-2 of their scale of the same decode with the tail (and B6) swapped
    for their plain f32 versions (TF32 off): P1 and P2 are bf16 in both,
    and where one rounds the other way a logit moves by ~2^-8 of its
    scale at that position (tail_compare.TAIL_F32_MOVED's note)."""
    from revisit_anything_tpu_torch.models.sam import decoder
    sam = _offline_sam(torch.float32).to(cuda)
    cfg = sam.cfg
    g, d = cfg.grid, cfg.prompt_dim
    gen = torch.Generator(device=cuda).manual_seed(8)
    emb, pe = (torch.randn((g, g, d), generator=gen, device=cuda)
               for _ in range(2))
    sparse = torch.randn((64, 2, d), generator=gen, device=cuda)
    dense = torch.randn((1, g, g, d), generator=gen, device=cuda)

    def run():
        with torch.inference_mode():
            return decoder.decode_masks(sam.decoder, cfg, emb, pe, sparse,
                                        dense, decode=decode)

    # the form's kernels that have a plain version swapped in below, and
    # the one after them that keeps running (K3 f32 after the keys mode)
    swapped, after = {
        "fused_tail_keys": ((build.DECODE_TAIL_F32,), (build.MASK_HEAD_F32,)),
        "fused_tail_logits": ((build.DECODE_TAIL_LOGITS_F32,), ()),
        "fused_tail_probs": ((build.DECODE_TAIL_F32,
                              build.MASK_HEAD_PROBS_F32), ())}[decode]
    build.reset_counts()
    masks, iou = run()
    torch.cuda.synchronize()
    counts = {k.name: k.launches for k in build.KERNELS if k.launches}
    assert counts == {k.name: 1 for k in (build.TOKEN_CROSS_F32, *swapped,
                                          *after)}, counts
    assert masks.dtype == iou.dtype == torch.float32
    assert torch.isfinite(masks).all() and torch.isfinite(iou).all()
    plain = {"decode_tail_fused": dfu.decode_tail_reference}
    if decode == "fused_tail_probs":
        plain["fused_mask_head_probs"] = mh.mask_head_probs_reference
    kept = {name: getattr(decoder, name) for name in plain}
    try:
        for name, fn in plain.items():
            setattr(decoder, name, fn)
        build.reset_counts()
        want, want_iou = run()
        torch.cuda.synchronize()
        assert not any(k.launches for k in swapped)
    finally:
        for name, fn in kept.items():
            setattr(decoder, name, fn)
    assert masks.shape == want.shape
    assert _rel_err(masks, want) < 1e-2
    assert _rel_err(iou, want_iou) < 1e-2


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_probs_kernels_permute_with_their_prompts(cuda, dtype):
    """Permuting the prompts permutes B7's (both layers) and B8's (both
    depths) outputs bit for bit, in bf16 and in f32: a CTA reads its own
    prompt's token rows, P and C only."""
    b = 24
    x = _probs_inputs(cuda, b=b, m=256, dtype=dtype)
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


def _mask_head_probs_args(cuda, np_, m, seed=6, dtype=torch.bfloat16,
                          ln_scale=1.0, gg=4096):
    """B6's arguments at the serving widths (gg 4096) for ``np_`` prompts
    and ``m`` mask tokens: P bf16, every other tensor in ``dtype``; the
    branch LayerNorm scales of both layers x ``ln_scale`` (``_large_branch``)."""
    x = _large_branch(_probs_inputs(cuda, b=np_, m=gg, dtype=dtype), ln_scale,
                      2)
    g = torch.Generator(device=cuda).manual_seed(seed)

    def rnd(*shape, s=1.0, off=0.0):
        return (torch.randn(shape, generator=g, device=cuda) * s + off).to(
            dtype)

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


# B6 f32: MASK_HEAD_PROBS_CASES at the branch LayerNorm's usual scale, and
# both branch LayerNorm scales x 2^15, so that the rebuilt keys pass fp16's
# largest value 65504 (they reach the head as f32, split into TF32 there)
MASK_HEAD_PROBS_F32_CASES = [
    pytest.param(*getattr(case, "values", case), 1.0,
                 id=getattr(case, "id", None))
    for case in MASK_HEAD_PROBS_CASES] + [
    pytest.param(8, 3130, 3, 32768.0, id="3130-large-branch")]


@pytest.mark.gpu
@pytest.mark.parametrize("np_,content,m,ln_scale", MASK_HEAD_PROBS_F32_CASES)
def test_mask_head_probs_kernel_f32_matches_plain(cuda, np_, content, m,
                                                  ln_scale):
    """B6 f32 (f32 img0, C, rows, weights and hypernetwork rows; P bf16)
    within F32_REL of its plain version in f32 with TF32 off; the output
    f32."""
    args = _mask_head_probs_args(cuda, np_, m, dtype=torch.float32,
                                 ln_scale=ln_scale)
    before = (build.MASK_HEAD_PROBS_F32.launches,
              build.MASK_HEAD_PROBS.launches)
    got = mh.fused_mask_head_probs(*args, content=content)
    want = mh.mask_head_probs_reference(*args, content=content)
    torch.cuda.synchronize()
    assert (build.MASK_HEAD_PROBS_F32.launches,
            build.MASK_HEAD_PROBS.launches) == (before[0] + 1, before[1])
    assert got.dtype == want.dtype == torch.float32
    assert got.shape == want.shape == (np_, content, 16, m)
    if ln_scale > 1.0:
        keys = dpr.recon_branch(args[0], [args[1], args[3]],
                                [args[2], args[4]], args[5], 1e-6)
        assert keys.abs().max().item() > 65504
    assert torch.isfinite(got).all()
    assert _rel_err(got, want) < F32_REL


@pytest.mark.gpu
def test_mask_head_probs_kernel_f32_is_bitwise_repeatable(cuda):
    """Two launches of B6 f32 on the same inputs give the same bits."""
    args = _mask_head_probs_args(cuda, 8, 3, dtype=torch.float32)
    first, second = (mh.fused_mask_head_probs(*args, content=3130)
                     for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.gpu
def test_mask_head_probs_f32_scratch_is_the_kernels(cuda):
    """The wrapper allocates the scratch B6 f32 takes (the weight split,
    then a keys tile a warpgroup) for the card's CTAs."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    lib = build.load()
    for n_ctas in (1, sms):
        assert (mh.mask_head_probs_f32_scratch(n_ctas)
                == lib.rat_mask_head_probs_f32_scratch(n_ctas))


@pytest.mark.gpu
def test_mask_head_probs_mixed_dtypes_raise(cuda):
    """B6 casts no activation: an f32 img0 beside bf16 C, or a bf16 img0
    beside f32 hypernetwork rows, raises before any launch."""
    f32 = _mask_head_probs_args(cuda, 4, 3, dtype=torch.float32, gg=128)
    bf = _mask_head_probs_args(cuda, 4, 3, gg=128)
    build.reset_counts()
    with pytest.raises(ValueError, match="c1m: expected torch.float32"):
        mh.fused_mask_head_probs(*f32[:2], bf[2], *f32[3:])
    with pytest.raises(ValueError, match="hyper: expected torch.bfloat16"):
        mh.fused_mask_head_probs(*bf[:6], f32[6], *bf[7:])
    assert not any(k.launches for k in build.KERNELS)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_mask_head_probs_kernel_permutes_with_its_prompts(cuda, dtype):
    """Permuting the prompts permutes B6's output bit for bit, in bf16 and
    in f32: an item reads its own prompt's P and C only (bf16: the 64-row
    boxes' rows 56-63 are zeros, never the next prompt's rows 0-7)."""
    args = _mask_head_probs_args(cuda, 133, 3, dtype=dtype)
    perm = torch.randperm(133, generator=torch.Generator().manual_seed(0))
    perm = perm.to(cuda)
    per_prompt = (1, 2, 3, 4, 6)              # p1, c1, p2, c2, hyper
    shuffled = tuple(a[perm] if i in per_prompt else a
                     for i, a in enumerate(args))
    base = mh.fused_mask_head_probs(*args, content=3130)
    got = mh.fused_mask_head_probs(*shuffled, content=3130)
    torch.cuda.synchronize()
    assert torch.equal(got, base[perm])


def serving_decoder(device, seed=0, dtype=torch.bfloat16):
    """A SAM ViT-H mask decoder (prompt dim 256, 8 heads, MLP 2048), bf16
    by default, with seeded random weights: N(0, 0.05²), LayerNorm scales
    1 + N(0, 0.05²)."""
    from revisit_anything_tpu_torch.models.sam import SAM_VIT_H
    from revisit_anything_tpu_torch.models.sam.decoder import MaskDecoder
    dec = MaskDecoder(SAM_VIT_H, dtype=dtype, device=device)
    g = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for name, p in dec.named_parameters():
            x = torch.randn(p.shape, generator=g, device=device) * 0.05
            p.copy_(x + 1.0 if name.endswith("scale") else x)
    return dec


def _tail_args(cuda, b, m, emit_keys, seed=7, dtype=torch.bfloat16):
    """Decode-tail inputs for ``b`` prompts over ``m`` positions, a
    decoder and activations in ``dtype``."""
    x = _probs_inputs(cuda, b=b, m=m, dtype=dtype)
    g = torch.Generator(device=cuda).manual_seed(seed)
    dec = serving_decoder(cuda, dtype=dtype)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=cuda).to(dtype)

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


def _assert_tail_f32_close(got, want, trailing):
    """keys2 or the logits per position within the criterion of
    tail_compare.TAIL_F32_MOVED's note; the reading prints (pytest -s)."""
    share, worst = moved_positions(got, want, trailing, F32_REL)
    print(f"[tail f32] {share:.3e} of the positions beyond F32_REL, the "
          f"largest {worst:.3e} of the scale")
    assert share <= TAIL_F32_MOVED and worst <= TAIL_F32_MOVED_REL, (
        share, worst)


def _large_tail(dec, ln_scale):
    """Both branch LayerNorm scales of ``dec`` times ``ln_scale`` and the
    query-side weights that score the branch (the layer-2 token -> image
    keys', the layer-2 image -> token queries', the final attention's
    keys') divided by it, all exact at a power of two: the branch grows
    by ``ln_scale`` and its scores keep their usual size (at 2^15 times
    it a softmax over them is one hot and flips at near-ties, PERF.md
    §6)."""
    with torch.no_grad():
        for layer in dec.layers[:2]:
            layer.norm4.scale.mul_(ln_scale)
        for w in (dec.layers[1].t2i.k.w, dec.layers[1].i2t.q.w,
                  dec.final_attn.k.w):
            w.div_(ln_scale)


@pytest.mark.gpu
@pytest.mark.parametrize("b,m,ln_scale", [
    pytest.param(16, 4096, 1.0, id="16-4096"),
    pytest.param(140, 4096, 1.0, id="140-4096"),
    pytest.param(16, 96, 1.0, id="16-96"),
    pytest.param(16, 256, 32768.0, id="16-256-large-branch")])
def test_decode_tail_kernel_f32_matches_plain(cuda, b, m, ln_scale):
    """B3 f32 in keys mode (f32 activations, weights and rows; P1, P2
    bf16 inside) against its plain version in f32 with TF32 off: the
    token state within F32_REL, keys2 as tail_compare.TAIL_F32_MOVED's
    note says; f32 outputs; one counted launch. At the serving shape,
    past the card's 132 SMs, at M = 96 (three tiles: the online softmax
    rescales across tiles) and with both branch LayerNorm scales x 2^15
    (keys2 past fp16's 65504, which the walks' fp16 planes hold times a
    power of two)."""
    args = _tail_args(cuda, b, m, True, dtype=torch.float32)
    _large_tail(args[0], ln_scale)
    before = build.DECODE_TAIL_F32.launches
    with torch.inference_mode():
        got = dfu.decode_tail_fused(*args)
        want = dfu.decode_tail_reference(*args)
    torch.cuda.synchronize()
    assert build.DECODE_TAIL_F32.launches == before + 1
    assert got[0].dtype == got[1].dtype == torch.float32
    assert got[1].shape == want[1].shape == (b, m, 256)
    if ln_scale > 1.0:
        assert want[1].abs().max().item() > 65504
    assert torch.isfinite(got[0]).all() and torch.isfinite(got[1]).all()
    assert _rel_err(got[0], want[0]) < F32_REL
    _assert_tail_f32_close(got[1], want[1], 1)


@pytest.mark.gpu
@pytest.mark.parametrize("b,m,ln_scale", [
    pytest.param(16, 4096, 1.0, id="16-4096"),
    pytest.param(140, 4096, 1.0, id="140-4096"),
    pytest.param(16, 96, 1.0, id="16-96"),
    pytest.param(16, 256, 32768.0, id="16-256-large-branch")])
def test_decode_tail_probs_kernel_f32_matches_plain(cuda, b, m, ln_scale):
    """B3 f32 in probability mode against its plain version in f32 with
    TF32 off, at the keys mode's cases: P1 and P2 bf16 within one bf16
    ulp, moved in at most PROBS_F32_MOVED of their elements (B7 f32's
    criterion); C2 and the token state f32 within F32_REL; the JAX
    kernel's shapes; one counted launch of the f32 entry."""
    args = _tail_args(cuda, b, m, False, dtype=torch.float32)
    _large_tail(args[0], ln_scale)
    before = build.DECODE_TAIL_F32.launches
    with torch.inference_mode():
        got = dfu.decode_tail_fused(*args)
        want = dfu.decode_tail_reference(*args)
        keys2 = dfu.decode_tail_reference(*args[:-1], True)[1]
    torch.cuda.synchronize()
    assert build.DECODE_TAIL_F32.launches == before + 1
    assert len(got) == len(want) == 4
    assert [o.dtype for o in got] == [torch.float32, torch.bfloat16,
                                      torch.bfloat16, torch.float32]
    assert [tuple(o.shape) for o in got] == [tuple(o.shape) for o in want] \
        == [(b, 7, 256), (b, 56, m), (b, 56, m), (b, 56, 256)]
    if ln_scale > 1.0:
        assert keys2.abs().max().item() > 65504
    for o in got:
        assert torch.isfinite(o.float()).all()
    for p, pw in zip(got[1:3], want[1:3]):
        ulps, moved = bf16_ulps(p, pw)
        print(f"[tail f32 probs] P {moved:.3e} of the elements moved, by "
              f"at most {ulps:.3f} ulp")
        assert ulps <= 1.0 and moved <= PROBS_F32_MOVED, (ulps, moved)
    assert _rel_err(got[0], want[0]) < F32_REL
    assert _rel_err(got[3], want[3]) < F32_REL


@pytest.mark.gpu
@pytest.mark.parametrize("outputs", [("keys2", "p1", "p2", "c2m"),
                                     ("keys2", "c2m"), ("p1", "p2"), ()])
def test_decode_tail_f32_refuses_mixed_outputs(cuda, outputs):
    """The f32 entry takes keys2 alone (keys mode) or P1, P2 and C2
    together without keys2 (probability mode): any other mix of outputs
    is refused before any launch, and its counter does not move."""
    args = _tail_args(cuda, 2, 128, True, dtype=torch.float32)
    dec, acts, b, m = args[0], args[1:10], 2, 128
    ins = {name: build.operand(name, x, dt, shape) for name, x, dt, shape
           in dfu.tail_operands(dec, *acts, 8)}
    f32 = dict(device=cuda, dtype=torch.float32)
    outs = dict(qout=torch.empty((b, 7, 256), **f32),
                work=torch.empty(b * dfu.tail_f32_scratch(m), device=cuda,
                                 dtype=torch.uint8),
                keys2=torch.empty((b, m, 256), **f32),
                p1=torch.empty((b, 56, m), device=cuda, dtype=torch.bfloat16),
                p2=torch.empty((b, 56, m), device=cuda, dtype=torch.bfloat16),
                c2m=torch.empty((b, 56, 256), **f32))
    ptrs = {name: x.data_ptr() for name, x in ins.items()}
    ptrs.update((name, outs[name].data_ptr())
                for name in ("qout", "work", *outputs))
    params = dfu.TailParams(*(ptrs.get(n) for n in dfu._TAIL_POINTERS),
                            b, m, dec.layers[1].lin1.w.shape[1], m, 0, 1e-6)
    build.reset_counts()
    with pytest.raises(RuntimeError, match="cudaError 1$"):
        build.DECODE_TAIL_F32.launch(ctypes.addressof(params))
    torch.cuda.synchronize()
    assert not any(k.launches for k in build.KERNELS)


@pytest.mark.gpu
@pytest.mark.parametrize("content", [3136, 4096, 3100, 20])
def test_decode_tail_logits_kernel_f32_matches_plain(cuda, content):
    """B3 f32 in logits mode at 140 prompts (more than the card's 132
    SMs), at content a multiple of 32, not one (K3 f32 reads keys2's rows
    up to the next multiple) and below one tile, against its plain
    version in f32 (TF32 off): the token state within F32_REL, the logits
    per position as tail_compare.TAIL_F32_MOVED's note says; one counted
    launch, K3 f32's counter unmoved."""
    b = 140
    args = _tail_args(cuda, b, 4096, False, seed=10,
                      dtype=torch.float32)[:-1]
    before = build.DECODE_TAIL_LOGITS_F32.launches
    head_before = build.MASK_HEAD_F32.launches
    with torch.inference_mode():
        got = dfu.decode_tail_fused(*args, mask_head=True, content=content)
        want = dfu.decode_tail_reference(*args, mask_head=True,
                                         content=content)
    torch.cuda.synchronize()
    assert build.DECODE_TAIL_LOGITS_F32.launches == before + 1
    assert build.MASK_HEAD_F32.launches == head_before
    assert got[1].dtype == torch.float32
    assert got[1].shape == want[1].shape == (b, content, 16, 3)
    assert torch.isfinite(got[1]).all()
    assert _rel_err(got[0], want[0]) < F32_REL
    _assert_tail_f32_close(got[1], want[1], 2)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["keys", "logits", "probs"])
def test_decode_tail_f32_kernels_permute_with_their_prompts(cuda, mode):
    """Permuting the prompts permutes B3 f32's outputs bit for bit in
    its three modes (the logits mode at a content that is not a multiple
    of 32): every launch of the entry reads a prompt's own tokens, keys,
    C1 and work rows only."""
    b = 24
    args = _tail_args(cuda, b, 256, mode == "keys", dtype=torch.float32)
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
    for a, w in zip(got, base):
        assert torch.equal(a, w[perm])


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["keys", "logits", "probs"])
def test_decode_tail_f32_kernels_are_bitwise_repeatable(cuda, mode):
    """Two launches of B3 f32 on the same inputs give the same bits."""
    args = _tail_args(cuda, 16, 512, mode == "keys", dtype=torch.float32)
    kw = dict(mask_head=True, content=480) if mode == "logits" else {}
    with torch.inference_mode():
        first, second = (dfu.decode_tail_fused(*args, **kw)
                         for _ in range(2))
    torch.cuda.synchronize()
    for a, w in zip(first, second):
        assert torch.equal(a, w)


@pytest.mark.gpu
def test_decode_tail_f32_scratch_is_the_kernels(cuda):
    """The wrapper allocates the work B3 f32 takes a prompt, in its keys
    and logits modes and in its probability mode."""
    lib = build.load()
    for m in (96, 4096):
        assert dfu.tail_f32_scratch(m) == lib.rat_decode_tail_f32_scratch(m)
        assert (dfu.tail_f32_scratch(m, probs=True)
                == lib.rat_decode_tail_f32_probs_scratch())


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


def _offline_sam(dtype=torch.bfloat16):
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
    sam = init_sam(cfg, gen, "cpu", dtype)
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
def test_multicrop_generate_masks_on_the_card_matches_the_cpu(cuda):
    """Multi-crop AMG (crop_n_layers=1, 4 points a side in the crops,
    small-region post-processing at 20 px) through the kernels keeps the
    masks the CPU plain path keeps from the same weights: within one
    record of the CPU's count, 95% of the card's masks matching one of
    the CPU's at IoU > 0.5 and 90% at IoU > 0.9 (the batch test's
    measure; the crop-edge and cross-crop filters add thresholds that a
    bf16 rounding can cross), each inside its crop box."""
    import copy

    from revisit_anything_tpu_torch.models.sam.amg import (AmgConfig,
                                                           generate_masks)
    sam = _offline_sam()
    card = copy.deepcopy(sam).to(cuda)
    img = _blob_image(np.random.default_rng(23), (224, 224))
    amg = AmgConfig(points_per_side=8, points_per_batch=64,
                    pred_iou_thresh=-1e9, stability_score_thresh=0.0,
                    crop_n_layers=1, crop_n_points_downscale_factor=2,
                    min_mask_region_area=20)
    build.reset_counts()
    got = generate_masks(card, img, amg, max_masks=32)
    assert build.FLASH_ATTENTION.launches == 5          # one encode a crop
    for k in (build.TOKEN_CROSS, build.I2T_UPDATE, build.MASK_HEAD,
              build.RESIZE_FLAGS):
        assert k.launches > 0, k.name
    assert build.RESIZE_FLAGS.launches == 5
    want = generate_masks(sam, img, amg, max_masks=32)
    assert abs(len(got) - len(want)) <= 1 and len(want) > 8
    assert len({r.crop_box for r in got}) > 1
    gm = np.stack([r.segmentation for r in got]).reshape(len(got), -1)
    wm = np.stack([r.segmentation for r in want]).reshape(len(want), -1)
    inter = gm.astype(np.float32) @ wm.T.astype(np.float32)
    best = (inter / (gm.sum(1)[:, None] + wm.sum(1)[None, :] - inter)
            ).max(1)
    assert (best > 0.5).mean() >= 0.95, best
    assert (best > 0.9).mean() >= 0.9, best
    for r in got:
        x0, y0, w, h = r.crop_box
        ys, xs = np.nonzero(r.segmentation)
        assert xs.min() >= x0 and xs.max() < x0 + w
        assert ys.min() >= y0 and ys.max() < y0 + h


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


@pytest.mark.gpu
def test_set_image_of_a_large_image_on_the_card_matches_the_cpu(cuda):
    """A 1200x1600 image, larger than the small SAM's 256 frame (PIL's host
    downscale to 192x256), through ``SamPredictor.set_image`` on the card
    and on the CPU from the same bf16 weights: K1 once (the one global
    layer), the embedding within BF16_REL of its scale."""
    import copy

    from revisit_anything_tpu_torch.models.sam.predictor import SamPredictor
    sam = _offline_sam()
    card = SamPredictor(copy.deepcopy(sam).to(cuda))
    cpu = SamPredictor(sam)
    img = _blob_image(np.random.default_rng(31), (1200, 1600))
    build.reset_counts()
    card.set_image(img)
    assert build.FLASH_ATTENTION.launches == 1
    assert sum(k.launches for k in build.KERNELS) == 1
    cpu.set_image(img)
    assert card._input_hw == cpu._input_hw == (192, 256)
    emb = card.get_image_embedding()
    assert emb.is_cuda and bool(torch.isfinite(emb).all())
    assert _rel_err(emb.cpu(), cpu.get_image_embedding()) <= BF16_REL


@pytest.mark.gpu
def test_sharded_knn_over_the_card_twice_matches_knn_l2(cuda):
    """A mesh that lists the card twice: two shards of an uneven database,
    the one-device kNN's distances (within 1e-5) and index sets."""
    from revisit_anything_tpu_torch.ops.knn import knn_l2
    from revisit_anything_tpu_torch.parallel import make_mesh, sharded_knn_l2
    mesh = make_mesh(devices=[cuda, cuda])
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((37, 64), generator=g, device=cuda)
    db = torch.randn((10007, 64), generator=g, device=cuda)
    sq, idx = sharded_knn_l2(q, db, 50, mesh)
    sq1, idx1 = knn_l2(q, db, 50)
    assert sq.is_cuda and int(idx.max()) < 10007
    torch.testing.assert_close(sq, sq1, rtol=1e-5, atol=1e-5)
    assert torch.equal(idx.sort(1).values, idx1.sort(1).values)


@pytest.mark.gpu
def test_row_sharded_server_on_the_card_matches_one_device(cuda):
    """The database in two shards on the card: after inserts and a removal
    every query answers as the one-device server's, the sharded queries,
    counted on their own, launch the kernels the one-device queries
    launch as many times, and the snapshots agree."""
    from revisit_anything_tpu_torch.parallel import make_mesh
    kw = dict(db_capacity=500 + 3 * 32, insert_chunk=4)
    one = _small_server(cuda, mesh=None, **kw)
    two = _small_server(cuda, mesh=make_mesh(devices=[cuda, cuda]), **kw)
    assert two.sharded and not one.sharded
    rng = np.random.default_rng(12)
    imgs = [_blob_image(rng) for _ in range(3)]
    assert one.add_reference_images(imgs) == two.add_reference_images(imgs)
    one.remove_reference_image(51)
    two.remove_reference_image(51)
    queries = imgs + [_blob_image(rng) for _ in range(2)]
    build.reset_counts()
    want = [one.query(q) for q in queries]
    counts_one = {k.name: k.launches for k in build.KERNELS}
    build.reset_counts()
    got = [two.query(q) for q in queries]
    counts_two = {k.name: k.launches for k in build.KERNELS}
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    for k in (build.FLASH_ATTENTION, build.TOKEN_CROSS, build.I2T_UPDATE,
              build.MASK_HEAD, build.RESIZE_FLAGS):
        assert counts_two[k.name] > 0, k.name
    assert counts_two == counts_one
    a, b = one.snapshot_index(), two.snapshot_index()
    np.testing.assert_array_equal(a.db, b.db)
    np.testing.assert_array_equal(a.db_image_ids, b.db_image_ids)
