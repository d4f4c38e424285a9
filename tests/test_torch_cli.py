"""The port's CLI against the JAX CLI on the toy environment of
``tests/test_cli.py`` (counterpart of its 13 tests; the two training
tests are in ``tests/test_torch_cli_train.py``), every port command run
with ``--device cpu``.

Where a JAX command takes a checkpoint flag, both CLIs run from one
seeded checkpoint file in a layout both read (SAM's original layout,
DINOv2's hub layout, a VLAD-BuFF Lightning checkpoint), and their
printed Recall@K, query JSON, serve lines and AMG records match. The
vocabulary and the PCA are fitted from random draws that differ between
the packages (``jax.random`` cannot be reproduced), so both evaluate
from the JAX CLI's vocabulary and PCA files, and the port's ``vocab`` and
``pca`` commands are held to the port's library functions. Where the
JAX command can only draw random weights of its own (``extract`` of
DINOv1, ``query`` without checkpoints), the port's output is held to
the port's library on the same seeded weights.

Tolerances: dense features and index rows rtol 1e-4 of their scale (f32
both sides, summation order only); recalls, ids, masks and JSON
exactly; predicted IoU and stability 1e-4."""

import contextlib
import io
import json
import os
import pickle
import shutil

import h5py
import numpy as np
import pytest
import torch
from PIL import Image

from revisit_anything_tpu import cli as jcli
from revisit_anything_tpu import config as jconfig
from revisit_anything_tpu.io import MaskRecord, write_image_masks
from revisit_anything_tpu.models import dinov2 as jdn
from revisit_anything_tpu.models.sam import SAM_REGISTRY as J_SAMS
from revisit_anything_tpu.models.sam import SamArchConfig as JSamCfg
from revisit_anything_tpu_torch import cli as pcli
from revisit_anything_tpu_torch import config as pconfig
from revisit_anything_tpu_torch.models import dinov2 as pdn
from revisit_anything_tpu_torch.models.sam import SAM_REGISTRY as P_SAMS
from revisit_anything_tpu_torch.models.sam import SamArchConfig as PSamCfg
from tests.test_torch_convert import (dino_hub_state_dict,
                                      sam_original_state_dict)

torch.set_float32_matmul_precision("highest")

CPU = ["--device", "cpu"]
REL = 1e-4
SAM_KW = dict(encoder_dim=32, encoder_depth=2, encoder_heads=2,
              global_attn_indexes=(1,), image_size=128, patch_size=16,
              window_size=4, prompt_dim=32, decoder_heads=4,
              decoder_mlp_dim=64, iou_head_hidden=16)
DINO_KW = dict(embed_dim=32, depth=2, num_heads=2, ffn="mlp",
               pretrain_grid=(8, 8))
AMG = ["--points-per-side", "6", "--points-per-batch", "36",
       "--pred-iou-thresh=-1e9", "--stability-score-thresh", "0.0"]
EXP_RAW, EXP_PCA, EXP_ANYLOC = ("exp7_global_SegLoc_VLAD_o3",
                                "exp0_global_SegLoc_VLAD_PCA_o3",
                                "exp1_global_Anyloc")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)


def _run(main, argv) -> str:
    """One CLI call's standard output."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


def _line(out, prefix):
    return next(ln for ln in out.splitlines() if ln.startswith(prefix))


def _common(root, workdir=None):
    return ["--dataset", "AmsterTime", "--workdir",
            workdir or root["workdir"], "--data-root", root["data_root"]]


def _patch_toy(mp):
    """The toy AmsterTime entry, and tiny SAM / DINOv2 configs under the
    CLI's default names, in both packages."""
    kw = dict(name="AmsterTime", data_subpath_ref="new",
              data_subpath_query="old",
              masks_h5_ref="AmsterTime_new_masks.h5",
              masks_h5_query="AmsterTime_old_masks.h5",
              dino_h5_ref="AmsterTime_r_dino_112.h5",
              dino_h5_query="AmsterTime_q_dino_112.h5",
              map_vlad_cluster="AmsterTime", domain_vlad_cluster="urban",
              sam_at_half_res=False)
    for cfg, dn, sams, sam_cfg in (
            (jconfig, jdn, J_SAMS, JSamCfg), (pconfig, pdn, P_SAMS,
                                              PSamCfg)):
        mp.setitem(cfg.DATASETS, "AmsterTime", cfg.DatasetConfig(
            size=cfg.ImageSize(112, 112), **kw))
        for name in ("dinov2_vitg14", "dinov2_vits14"):
            mp.setitem(dn.CONFIGS, name, dn.DinoV2Config(**DINO_KW))
        for name in ("vit_h", "vit_b"):
            mp.setitem(sams, name, sam_cfg(**SAM_KW))


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """The toy environment, two seeded checkpoints, and the JAX CLI's
    artifacts and printed results made from them once."""
    tmp = tmp_path_factory.mktemp("toy")
    rng = np.random.default_rng(0)
    root = {"data_root": str(tmp / "data"), "workdir": str(tmp / "jax_wd"),
            "cache": str(tmp / "cache"), "tmp": tmp}
    os.makedirs(root["workdir"])
    db_imgs = []
    for sub, n in (("new", 5), ("old", 3)):
        d = tmp / "data" / "AmsterTime" / sub
        d.mkdir(parents=True)
        for i in range(n):
            if sub == "new":
                img = rng.integers(0, 255, (112, 112, 3), dtype=np.uint8)
                db_imgs.append(img)
            else:
                img = np.clip(db_imgs[i].astype(int)
                              + rng.integers(-10, 10, (112, 112, 3)),
                              0, 255).astype(np.uint8)
            Image.fromarray(img).save(d / f"im_{i:02d}.png")
    for name, n in (("AmsterTime_new_masks.h5", 5),
                    ("AmsterTime_old_masks.h5", 3)):
        with h5py.File(os.path.join(root["workdir"], name), "w") as f:
            for i in range(n):
                recs = []
                for _ in range(4):
                    m = np.zeros((112, 112), bool)
                    cy, cx = rng.integers(20, 90, 2)
                    m[cy - 15:cy + 15, cx - 15:cx + 15] = True
                    recs.append(MaskRecord(m, int(m.sum()), (0, 0, 0, 0),
                                           0.9, np.zeros((1, 2)), 0.96,
                                           (0, 0, 112, 112)))
                write_image_masks(f, f"im_{i:02d}.png", recs)
    root["sam_ckpt"] = str(tmp / "sam.pth")
    torch.save(sam_original_state_dict(PSamCfg(**SAM_KW), 3),
               root["sam_ckpt"])
    root["dino_ckpt"] = str(tmp / "dino.pth")
    torch.save(dino_hub_state_dict(pdn.DinoV2Config(**DINO_KW), 4),
               root["dino_ckpt"])
    # the port's working copy, before the JAX CLI writes its artifacts
    root["port_wd"] = str(tmp / "port_wd")
    shutil.copytree(root["workdir"], root["port_wd"])

    with pytest.MonkeyPatch.context() as mp:
        _patch_toy(mp)
        cache = ["--cache-root", root["cache"]]
        jrun = lambda *a: _run(jcli.main, list(a))  # noqa: E731
        jrun("extract", *_common(root), "--method", "DINO", "--checkpoint",
             root["dino_ckpt"], "--layer", "1")
        jrun("vocab", *_common(root), "--clusters", "8", "--domain",
             "urban", *cache)
        # 4 components: the toy bank has rank 4 (order-3 supersegments
        # of 4 masks are the whole image, so 5 distinct rows), and
        # whitening a zero-variance component would amplify f32 noise
        jrun("pca", *_common(root), "--experiment", EXP_PCA, "--dim", "4",
             *cache)
        root["index"] = str(tmp / "index_jax.npz")
        jrun("build-index", *_common(root), "--experiment", EXP_PCA, *cache,
             "--output", root["index"])
        root["jax"] = {
            exp: jrun("evaluate", *_common(root), "--experiment", exp,
                      *cache, *(("--save-results", "--save-descriptors")
                                if exp == EXP_RAW else ()))
            for exp in (EXP_RAW, EXP_PCA, EXP_ANYLOC)}
        with open(os.path.join(root["workdir"], "results", "global",
                               f"{EXP_RAW}_AmsterTime",
                               "results.pkl"), "rb") as f:
            root["jax_payload"] = pickle.load(f)
        yield root


@pytest.fixture
def env(toy, monkeypatch):
    _patch_toy(monkeypatch)
    return toy


def _port_workdir(env, name):
    """A fresh copy of the port's working directory (masks only)."""
    wd = str(env["tmp"] / name)
    shutil.copytree(env["port_wd"], wd)
    return wd


def _jax_workdir(env, name):
    """A copy of the JAX CLI's working directory (its h5 files, PCA)."""
    wd = str(env["tmp"] / name)
    shutil.copytree(env["workdir"], wd)
    return wd


def _extract_dino(env, wd):
    return _run(pcli.main, ["extract", *_common(env, wd), "--method",
                            "DINO", "--checkpoint", env["dino_ckpt"],
                            "--layer", "1", *CPU])


def test_cli_extract_vocab_evaluate(env):
    """Port extraction from the JAX CLI's DINOv2 checkpoint: its h5
    features; port vocab: the port library's centres; port evaluate with
    the JAX CLI's vocabulary: the JAX CLI's Recall@1..5."""
    from revisit_anything_tpu_torch.io.vocab import load_cluster_centers
    from revisit_anything_tpu_torch.pipeline.vocabulary import (
        fit_vocabulary_from_h5)
    wd = _port_workdir(env, "p_extract")
    _extract_dino(env, wd)
    name = "AmsterTime_r_dino_112.h5"
    with h5py.File(os.path.join(wd, name)) as fp, \
            h5py.File(os.path.join(env["workdir"], name)) as fj:
        assert sorted(fp) == sorted(fj) and len(fp) == 5
        for k in fp:
            assert _rel(fp[k]["ift_dino"][()], fj[k]["ift_dino"][()]) <= REL

    cache_p = str(env["tmp"] / "cache_p")
    _run(pcli.main, ["vocab", *_common(env, wd), "--clusters", "8",
                     "--cache-root", cache_p, "--domain", "urban", *CPU])
    vocab = os.path.join(cache_p, "vocabulary", "dinov2_vitg14",
                         "l31_value_c32", "urban", "c_centers.pt")
    h5 = os.path.join(wd, name)
    want = fit_vocabulary_from_h5(h5, [f"im_{i:02d}.png" for i in range(5)],
                                  num_clusters=8, device="cpu")
    np.testing.assert_array_equal(load_cluster_centers(vocab), want)

    out = _run(pcli.main, ["evaluate", *_common(env, wd), "--experiment",
                           EXP_RAW, "--cache-root", env["cache"],
                           "--save-results", *CPU])
    assert _line(out, "Recall@1..5") == _line(env["jax"][EXP_RAW],
                                              "Recall@1..5")
    assert "retrieval.knn" in out and "agg.vlad" in out
    results = os.path.join(wd, "results", "global",
                           f"{EXP_RAW}_AmsterTime")
    with open(os.path.join(results, "recalls.json")) as f:
        assert json.load(f)["recalls"][0] >= 0.5


def test_cli_anyloc_branch(env):
    wd = _port_workdir(env, "p_anyloc")
    _extract_dino(env, wd)
    out = _run(pcli.main, ["evaluate", *_common(env, wd), "--experiment",
                           EXP_ANYLOC, "--cache-root", env["cache"], *CPU])
    for prefix in ("Recall@1..5", "1%-recall"):
        assert _line(out, prefix) == _line(env["jax"][EXP_ANYLOC], prefix)


def test_cli_unknown_dataset():
    with pytest.raises(KeyError):
        pcli.main(["extract", "--dataset", "nope", "--method", "DINO",
                   *CPU])


def test_cli_refuses_a_missing_card(env, monkeypatch):
    """The default device is the card; without one the CLI stops, it does
    not run on the CPU instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        pcli.main(["extract", *_common(env, _port_workdir(env, "p_card")),
                   "--method", "DINO"])


def test_cli_pca_then_pca_evaluate(env):
    """Port pca: the port library's fit on the same banks; port evaluate
    with the JAX CLI's PCA file: the JAX CLI's recalls."""
    from revisit_anything_tpu_torch.io.vocab import load_cluster_centers
    from revisit_anything_tpu_torch.ops.pca import load_pca_npz
    from revisit_anything_tpu_torch.pipeline.aggregate import (
        compute_segment_vlads)
    from revisit_anything_tpu_torch.pipeline.vocabulary import (
        fit_pca_from_vlads)
    wd = _jax_workdir(env, "p_pca")
    npz = os.path.join(wd, "AmsterTime_r_fitted_pca_model_order3.pkl.npz")
    out = _run(pcli.main, ["evaluate", *_common(env, wd), "--experiment",
                           EXP_PCA, "--cache-root", env["cache"], *CPU])
    assert _line(out, "Recall@1..5") == _line(env["jax"][EXP_PCA],
                                              "Recall@1..5")
    os.remove(npz)
    out = _run(pcli.main, ["pca", *_common(env, wd), "--experiment",
                           EXP_PCA, "--cache-root", env["cache"], "--dim",
                           "8", *CPU])
    assert "wrote" in out
    centers = load_cluster_centers(os.path.join(
        env["cache"], "vocabulary", "dinov2_vitg14", "l31_value_c32",
        "urban", "c_centers.pt"))
    keys = [f"im_{i:02d}.png" for i in range(5)]
    bank = compute_segment_vlads(
        os.path.join(wd, "AmsterTime_new_masks.h5"),
        os.path.join(wd, "AmsterTime_r_dino_112.h5"), keys, centers, 3,
        (112, 112), (112, 112), progress=False, device="cpu")
    want = fit_pca_from_vlads(bank, num_components=8, device="cpu")
    got = load_pca_npz(npz, device="cpu")
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_cli_extract_skips_existing(env):
    wd = _port_workdir(env, "p_skip")
    _extract_dino(env, wd)
    assert "skipping" in _extract_dino(env, wd)


def test_cli_save_descriptors(env):
    """results.pkl with the segment descriptors: the JAX CLI's payload
    from the same h5 files and vocabulary."""
    wd = _jax_workdir(env, "p_desc")
    _run(pcli.main, ["evaluate", *_common(env, wd), "--experiment", EXP_RAW,
                     "--cache-root", env["cache"], "--save-results",
                     "--save-descriptors", *CPU])
    with open(os.path.join(wd, "results", "global",
                           f"{EXP_RAW}_AmsterTime", "results.pkl"),
              "rb") as f:
        payload = pickle.load(f)
    want = env["jax_payload"]
    assert payload["segFtVLAD1"].shape == want["segFtVLAD1"].shape
    assert payload["segFtVLAD1"].shape[1] == 8 * 32
    for k in ("segFtVLAD1", "segFtVLAD2"):
        assert _rel(payload[k], want[k]) <= REL
    for k in ("imInds1", "imInds2", "matches"):
        np.testing.assert_array_equal(payload[k], want[k])
    assert payload["recalls"] == want["recalls"]


def _vladbuff_checkpoint(path, rng, cfg):
    from tests.test_vladbuff import synth_hub_state_dict
    sd = {f"backbone.model.{k}": v
          for k, v in synth_hub_state_dict(cfg, rng).items()}
    c, d = 4, cfg.embed_dim
    sd["aggregator.conv.weight"] = torch.from_numpy(
        rng.standard_normal((c, d, 1, 1)).astype(np.float32))
    sd["aggregator.centroids"] = torch.from_numpy(
        rng.standard_normal((c, d)).astype(np.float32))
    torch.save({"state_dict": sd}, path)


def test_cli_evaluate_global(env, monkeypatch):
    """The same VLAD-BuFF checkpoint through both CLIs: the same
    recalls line."""
    from tests.test_vladbuff import TINY
    monkeypatch.setattr(jdn, "VIT_B14", TINY)
    monkeypatch.setattr(pdn, "VIT_B14", pdn.DinoV2Config(
        **{f: getattr(TINY, f) for f in ("embed_dim", "depth", "num_heads",
                                         "ffn", "pretrain_grid")}))
    ckpt = str(env["tmp"] / "vb.ckpt")
    _vladbuff_checkpoint(ckpt, np.random.default_rng(0), TINY)
    argv = ["evaluate-global", *_common(env), "--checkpoint", ckpt,
            "--model", "vladbuff", "--batch-size", "4"]
    got = _run(pcli.main, argv + CPU)
    want = _run(jcli.main, argv)
    assert "R@1" in got and _line(got, "[AmsterTime]") == _line(
        want, "[AmsterTime]")


def test_cli_evaluate_global_benchmark(tmp_path, monkeypatch):
    """--benchmark st_lucia: npy-listed image sets and UTM gt, both CLIs
    from one checkpoint."""
    from tests.test_vladbuff import TINY
    monkeypatch.setattr(jdn, "VIT_B14", TINY)
    monkeypatch.setattr(pdn, "VIT_B14", pdn.DinoV2Config(
        **{f: getattr(TINY, f) for f in ("embed_dim", "depth", "num_heads",
                                         "ffn", "pretrain_grid")}))
    rng = np.random.default_rng(1)
    gt_root, data_root = tmp_path / "gt", tmp_path / "imgs"
    (gt_root / "st_lucia").mkdir(parents=True)
    (data_root / "db").mkdir(parents=True)
    (data_root / "q").mkdir()
    names = {}
    for sub, n in (("db", 6), ("q", 2)):
        names[sub] = []
        for i in range(n):
            name = f"{sub}/@{100 + i}@200@{sub}{i}.png"
            Image.fromarray(rng.integers(0, 255, (56, 56, 3),
                                         dtype=np.uint8)).save(
                data_root / name)
            names[sub].append(name)
    np.save(gt_root / "st_lucia" / "st_lucia_dbImages.npy",
            np.array(names["db"]))
    np.save(gt_root / "st_lucia" / "st_lucia_qImages.npy",
            np.array(names["q"]))
    ckpt = str(tmp_path / "vb.ckpt")
    _vladbuff_checkpoint(ckpt, rng, TINY)
    argv = ["evaluate-global", "--benchmark", "st_lucia", "--gt-root",
            str(gt_root), "--data-root", str(data_root), "--checkpoint",
            ckpt, "--model", "vladbuff", "--image-size", "56", "56",
            "--batch-size", "4"]
    got = _run(pcli.main, argv + CPU)
    assert _line(got, "[st_lucia]") == _line(_run(jcli.main, argv),
                                             "[st_lucia]")


def _query_argv(env, index, image, ckpts=True):
    argv = ["query", "--index", index, "--image", image, "--topk", "3",
            "--layer", "1", *AMG]
    if ckpts:
        argv += ["--sam-checkpoint", env["sam_ckpt"], "--dino-checkpoint",
                 env["dino_ckpt"]]
    return argv


def test_cli_build_index_and_query(env):
    """Port build-index from the JAX CLI's artifacts: its index; port
    query from the two checkpoints: the JAX CLI's JSON."""
    wd = _jax_workdir(env, "p_index")
    index = str(env["tmp"] / "index_port.npz")
    _run(pcli.main, ["build-index", *_common(env, wd), "--experiment",
                     EXP_PCA, "--cache-root", env["cache"], "--output",
                     index, *CPU])
    got, want = np.load(index), np.load(env["index"])
    assert sorted(got.files) == sorted(want.files)
    for k in got.files:
        if got[k].dtype.kind == "f":
            assert _rel(got[k], want[k]) <= REL, k
        else:
            np.testing.assert_array_equal(got[k], want[k])
    q_img = os.path.join(env["data_root"], "AmsterTime", "old", "im_00.png")
    out = json.loads(_run(pcli.main, _query_argv(env, index, q_img)
                          + CPU).splitlines()[-1])
    jout = json.loads(_run(jcli.main, _query_argv(env, env["index"], q_img)
                           ).splitlines()[-1])
    assert out == jout
    assert 1 <= len(out["image_ids"]) <= 3
    assert all(m.endswith(".png") for m in out["matches"])


def test_cli_build_index_then_query(env):
    """query with seeded weights (no checkpoint flag): the port library's
    SegVLADServer on the same seeded weights and index gives the same
    ids (the JAX CLI's random weights cannot be drawn here)."""
    from revisit_anything_tpu_torch.models.sam.amg import AmgConfig
    from revisit_anything_tpu_torch.pipeline.extract import load_image_rgb
    from revisit_anything_tpu_torch.pipeline.serve import (SegVLADServer,
                                                           ServingIndex)
    from revisit_anything_tpu_torch.weights import init_dino, init_sam
    q_img = os.path.join(env["data_root"], "AmsterTime", "old", "im_00.png")
    out = json.loads(_run(pcli.main, _query_argv(
        env, env["index"], q_img, ckpts=False) + CPU).splitlines()[-1])
    assert out["query"] == q_img
    assert 1 <= len(out["image_ids"]) <= 3
    assert all(0 <= i < 5 for i in out["image_ids"])
    assert len(out["matches"]) == len(out["image_ids"])
    g = lambda s: torch.Generator().manual_seed(s)  # noqa: E731
    srv = SegVLADServer(
        sam=init_sam(PSamCfg(**SAM_KW), g(0), "cpu", torch.float32),
        dino=init_dino(pdn.DinoV2Config(**DINO_KW), g(1), "cpu",
                       torch.float32),
        index=ServingIndex.from_npz(env["index"]), full_hw=(112, 112),
        sam_hw=(112, 112), dino_layer=1, top_images=3,
        amg=AmgConfig(points_per_side=6, points_per_batch=36,
                      pred_iou_thresh=-1e9, stability_score_thresh=0.0))
    top = srv.query(load_image_rgb(q_img))
    assert out["image_ids"] == top[top >= 0].tolist()


def test_cli_amg_standalone(env, tmp_path):
    """amg from one SAM checkpoint: the JAX CLI's masks and metadata."""
    src = tmp_path / "in"
    src.mkdir()
    rng = np.random.default_rng(2)
    for i in range(2):
        Image.fromarray(rng.integers(0, 255, (60, 100, 3),
                                     dtype=np.uint8)).save(src / f"i{i}.png")
    (src / "notes.txt").write_text("not an image")
    argv = ["amg", "--input", str(src), "--checkpoint", env["sam_ckpt"],
            "--points-per-side", "6", "--points-per-batch", "36",
            "--pred-iou-thresh", "-1000000", "--stability-score-thresh", "0"]
    out = _run(pcli.main, argv + ["--output", str(tmp_path / "p")] + CPU)
    assert "Could not load" in out
    _run(jcli.main, argv + ["--output", str(tmp_path / "j")])
    for i in range(2):
        d, dj = tmp_path / "p" / f"i{i}", tmp_path / "j" / f"i{i}"
        assert sorted(os.listdir(d)) == sorted(os.listdir(dj))
        pngs = [f for f in os.listdir(d) if f.endswith(".png")]
        assert len(pngs) >= 1
        for f in pngs:
            np.testing.assert_array_equal(np.asarray(Image.open(d / f)),
                                          np.asarray(Image.open(dj / f)))
        rows = (d / "metadata.csv").read_text().splitlines()
        jrows = (dj / "metadata.csv").read_text().splitlines()
        assert rows[0] == jrows[0] and rows[0].startswith("id,area,bbox_x0")
        assert len(rows) == len(pngs) + 1 == len(jrows)
        for r, jr in zip(rows[1:], jrows[1:]):
            a, b = r.split(","), jr.split(",")
            assert a[:8] == b[:8] and a[10:] == b[10:]
            for x, y in zip(a[8:10], b[8:10]):
                assert abs(float(x) - float(y)) <= 1e-4


def test_cli_serve_loop(env, monkeypatch, tmp_path):
    """The persistent serve command (query / add / remove / snapshot /
    errors / quit) from the two checkpoints: the JAX CLI's lines and
    snapshot."""
    q0 = os.path.join(env["data_root"], "AmsterTime", "old", "im_00.png")
    q1 = os.path.join(env["data_root"], "AmsterTime", "old", "im_01.png")
    argv = ["serve", "--index", env["index"], "--layer", "1", "--topk", "3",
            "--db-capacity", "400", "--sam-checkpoint", env["sam_ckpt"],
            "--dino-checkpoint", env["dino_ckpt"], *AMG]
    lines = {}
    for name, main, extra in (("port", pcli.main, CPU),
                              ("jax", jcli.main, [])):
        snap = str(tmp_path / f"{name}.npz")
        script = "\n".join([f"query {q0}", f"add {q1}", f"query {q1}",
                            "remove 5", f"snapshot {snap}", "bogus cmd",
                            "query /nonexistent.png", "quit"]) + "\n"
        monkeypatch.setattr("sys.stdin", io.StringIO(script))
        lines[name] = [json.loads(ln) for ln in
                       _run(main, argv + extra).strip().splitlines()]
    got, want = lines["port"], lines["jax"]
    assert got[0]["ready"] is True and got[0]["images"] == 5
    assert got[0] == want[0]
    assert got[1]["query"] == q0 and len(got[1]["image_ids"]) >= 1
    assert got[2] == {"added": q1, "image_id": 5}
    assert got[4] == {"removed": 5}
    assert "error" in got[6] and "error" in got[7]
    for i in range(1, 6):
        if i == 5:
            assert got[i] == {"snapshot": str(tmp_path / "port.npz")}
            continue
        assert got[i] == want[i]
    assert len(got) == len(want) == 8
    zp, zj = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    assert int(zp["num_ref_images"]) == int(zj["num_ref_images"]) == 6
    for k in ("db_image_ids", "image_keys"):
        np.testing.assert_array_equal(zp[k], zj[k])
    assert _rel(zp["db"], zj["db"]) <= REL
