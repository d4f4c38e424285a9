"""The port's CLI commands whose JAX counterparts draw random weights of
their own (counterpart of ``tests/test_cli_train.py`` and of
``tests/test_cli.py::test_cli_extract_dinov1``): ``train``, ``extract
--method DINOV1``, ``add-pca`` and ``extract --multihost``. JAX's
``jax.random`` draws cannot be reproduced, so each command's output is
held to the port's library functions on the same seeded weights and
inputs (exactly: the same computation in the same order), besides the
JAX tests' own checks (losses printed, checkpoints written, resume,
best-R1 retention, feature shapes)."""

import json
import os
import socket

import h5py
import numpy as np
import pytest
import torch
from PIL import Image

from revisit_anything_tpu_torch import cli as pcli
from revisit_anything_tpu_torch.models import dinov2 as pdn
from tests.test_torch_cli import CPU, _common, _patch_toy, _run
from tests.test_torch_cli import toy  # noqa: F401 (fixture)

torch.set_float32_matmul_precision("highest")

TINY = pdn.DinoV2Config(embed_dim=32, depth=2, num_heads=2, ffn="mlp",
                        pretrain_grid=(4, 4))
TRAIN = ["--batch-places", "2", "--image-size", "56", "56",
         "--num-trainable-blocks", "1", "--clusters", "4", *CPU]


def _places(root, rng, n_places=4):
    for p in range(n_places):
        d = root / "city0" / f"p{p:03d}"
        d.mkdir(parents=True)
        for i in range(4):
            Image.fromarray(rng.integers(0, 255, (56, 56, 3),
                                         dtype=np.uint8)).save(d / f"{i}.jpg")


def test_cli_train_runs_and_checkpoints(tmp_path, monkeypatch):
    """Two steps, a checkpoint, then a resume to step 3; the printed first
    loss is the library's train_step loss on the same seeded state and
    first batch."""
    from revisit_anything_tpu_torch.training.data import (PlacesBatcher,
                                                          discover_places)
    from revisit_anything_tpu_torch.training.train import (
        VPRTrainConfig, create_train_state, train_step)
    _places(tmp_path / "data", np.random.default_rng(0))
    monkeypatch.setitem(pdn.CONFIGS, "dinov2_vitb14", TINY)
    ckpt_dir = str(tmp_path / "ckpts")
    argv = ["train", "--train-root", str(tmp_path / "data"), "--ckpt-dir",
            ckpt_dir, *TRAIN, "--log-every", "1"]
    out = _run(pcli.main, argv + ["--steps", "2", "--ckpt-every", "2"])
    assert "loss" in out
    assert any(d.startswith("step_") for d in os.listdir(ckpt_dir))

    cfg = VPRTrainConfig(backbone=TINY, num_trainable_blocks=1, clusters=4,
                         total_steps=2, warmup_steps=1)
    state = create_train_state(cfg, seed=0, device="cpu")
    places = discover_places(str(tmp_path / "data"), min_images=4)
    images, labels = next(iter(PlacesBatcher(places, (56, 56), 2, 4,
                                             seed=0)))
    loss = float(train_step(state, cfg, torch.from_numpy(images),
                            torch.from_numpy(labels)))
    assert f"step 1: loss {loss:.4f}" in out

    out = _run(pcli.main, argv + ["--steps", "3", "--resume",
                                  "--ckpt-every", "10"])
    assert "resumed" in out and "step 3:" in out
    assert "step_00000003" in os.listdir(ckpt_dir)


def test_cli_train_validation_and_best_ckpt(tmp_path, monkeypatch):
    """--val-root: in-training recalls, best-R1 retention and the JSONL
    metric stream."""
    rng = np.random.default_rng(1)
    _places(tmp_path / "data", rng)
    val = tmp_path / "val"
    (val / "ref").mkdir(parents=True)
    (val / "query").mkdir()
    refs = [rng.integers(0, 255, (56, 56, 3), dtype=np.uint8)
            for _ in range(5)]
    for i, im in enumerate(refs):
        Image.fromarray(im).save(val / "ref" / f"r{i:02d}.png")
    for i in range(3):
        q = np.clip(refs[i].astype(int) + rng.integers(-8, 8, (56, 56, 3)),
                    0, 255).astype(np.uint8)
        Image.fromarray(q).save(val / "query" / f"q{i:02d}.png")
    np.save(val / "gt.npy", np.array([[0], [1], [2]], dtype=object),
            allow_pickle=True)
    monkeypatch.setitem(pdn.CONFIGS, "dinov2_vitb14", TINY)
    ckpt_dir = str(tmp_path / "ckpts")
    log = str(tmp_path / "train.jsonl")
    out = _run(pcli.main, ["train", "--train-root", str(tmp_path / "data"),
                           "--ckpt-dir", ckpt_dir, "--steps", "2", *TRAIN,
                           "--log-every", "1", "--ckpt-every", "2",
                           "--val-root", str(val), "--val-every", "1",
                           "--log-file", log])
    assert "best checkpoint" in out
    assert os.path.exists(os.path.join(ckpt_dir, "best"))
    with open(os.path.join(ckpt_dir, "best_metric.json")) as f:
        assert json.load(f)["monitor"] == "val/R1"
    rows = [json.loads(line) for line in open(log)]
    assert any("val/R1" in r for r in rows)
    assert any("loss" in r for r in rows)


def test_cli_extract_dinov1(toy, monkeypatch):  # noqa: F811
    """--method DINOV1: seeded ViT-S/8 key-facet features upsampled to the
    dataset resolution (the reference wrapper's default), or the strided
    grid with --no-dinov1-upsample; each the library's
    dinov1_dense_features of the same model and images."""
    from revisit_anything_tpu_torch.models import dinov1 as d1
    from revisit_anything_tpu_torch.pipeline.extract import (
        _resize_cv2_bilinear, dinov1_dense_features, load_image_rgb)
    from revisit_anything_tpu_torch.weights import init_dino
    _patch_toy(monkeypatch)
    wd = str(toy["tmp"] / "p_dinov1")
    argv = ["extract", *_common(toy, wd), "--method", "DINOV1",
            "--dinov1-model", "dino_vits8", "--dino-stride", "8", *CPU]
    _run(pcli.main, argv)
    out = os.path.join(wd, "AmsterTime_r_dinoV1_112.h5")
    model = init_dino(d1.VIT_S8, torch.Generator().manual_seed(0), "cpu",
                      torch.float32)
    paths = sorted(os.path.join(toy["data_root"], "AmsterTime", "new", f)
                   for f in os.listdir(os.path.join(toy["data_root"],
                                                    "AmsterTime", "new")))
    imgs = np.stack([_resize_cv2_bilinear(load_image_rgb(p), (112, 112))
                     for p in paths])
    for upsample, shape in ((True, (1, 384, 112, 112)),
                            (False, (1, 384, 28, 28))):
        if not upsample:
            _run(pcli.main, argv + ["--no-dinov1-upsample", "--force"])
        want = dinov1_dense_features(model, d1.VIT_S8, imgs, stride=8,
                                     upsample=upsample).numpy()
        with h5py.File(out) as f:
            assert len(f) == 5
            for i, p in enumerate(paths):
                arr = f[os.path.basename(p)]["ift_dino"][()]
                assert arr.shape == shape
                np.testing.assert_array_equal(arr, want[i:i + 1])


def test_cli_add_pca(tmp_path):
    """add-pca: one wpca{n} tree a count, the library's whitened PCA of the
    same descriptors, sliced."""
    from revisit_anything_tpu_torch.training import vladbuff as vb
    from revisit_anything_tpu_torch.training.aggregators import netvlad_init
    from revisit_anything_tpu_torch.training.train import VPRModel
    from revisit_anything_tpu_torch.weights import init_dino
    rng = np.random.default_rng(2)
    imgs = tmp_path / "imgs"
    imgs.mkdir()
    for i in range(12):
        Image.fromarray(rng.integers(0, 255, (56, 56, 3),
                                     dtype=np.uint8)).save(imgs / f"{i}.png")
    gen = torch.Generator().manual_seed(0)
    model = VPRModel(init_dino(TINY, gen, "cpu", torch.float32),
                     netvlad_init(gen, 32, 4, True, device="cpu"))
    src = vb.save_vladbuff_params(str(tmp_path / "vb.npy"), model)
    template = str(tmp_path / "wpca{n}.npy")
    pdn.CONFIGS["tiny_test"] = TINY
    try:
        out = _run(pcli.main, ["add-pca", "--checkpoint", src, "--backbone",
                               "tiny_test", "--images-root", str(imgs),
                               "--num-pcs", "3", "6", "--image-size", "56",
                               "56", "--batch-size", "5", "--out-template",
                               template, *CPU])
    finally:
        del pdn.CONFIGS["tiny_test"]
    assert "fitted on 12 descriptors" in out
    descs = pcli._global_descriptors(
        sorted(str(p) for p in imgs.iterdir()), vb.global_descriptor,
        vb.load_vladbuff_params(src, TINY, device="cpu"), TINY, (56, 56), 5,
        torch.device("cpu"))
    full = vb.fit_wpca(descs, 6)
    for n in (3, 6):
        tree = np.load(template.format(n=n), allow_pickle=True).item()
        np.testing.assert_array_equal(tree["wpca"]["w"],
                                      full["w"][:n].numpy())
        np.testing.assert_array_equal(tree["wpca"]["b"],
                                      full["b"][:n].numpy())


def test_cli_extract_multihost_one_process(toy, monkeypatch):  # noqa: F811
    """--multihost with torchrun's environment for one process: joins a
    gloo group, owns every image, writes .part0 files."""
    import torch.distributed as dist
    _patch_toy(monkeypatch)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for k, v in (("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", str(port)),
                 ("WORLD_SIZE", "1"), ("RANK", "0")):
        monkeypatch.setenv(k, v)
    wd = str(toy["tmp"] / "p_multihost")
    try:
        out = _run(pcli.main, ["extract", *_common(toy, wd), "--method",
                               "DINO", "--checkpoint", toy["dino_ckpt"],
                               "--layer", "1", "--multihost", *CPU])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert "multihost: process 0/1, 5 refs / 3 queries" in out
    for tag in ("r", "q"):
        assert os.path.exists(os.path.join(
            wd, f"AmsterTime_{tag}_dino_112.h5.part0"))
