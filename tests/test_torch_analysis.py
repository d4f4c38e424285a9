"""The analysis tools, profiling, seeding and the workdir configuration
against the JAX package on the CPU: ``retrieval/analysis.py``'s six
functions, ``retrieval/cluster_analysis.py`` (cluster usage, triplet
margins and ranks, cosine maps, t-SNE, the plot and HTML writers),
``utils/seeding.py``, ``utils/profiling.py`` and
``config.WorkdirConfig``. Host numpy on both sides: equal results, but
for the margins and cosine maps (float64 on both sides, rtol 1e-12) and
the hard assignment (f32 products in another order: equal labels on
these inputs, whose top-2 similarities are far apart)."""

import csv
import os
import random
import re

import numpy as np
import pytest
import torch
from PIL import Image

from revisit_anything_tpu import config as jconfig
from revisit_anything_tpu.retrieval import analysis as jan
from revisit_anything_tpu.retrieval import cluster_analysis as jca
from revisit_anything_tpu.utils import profiling as jprof
from revisit_anything_tpu.utils import seeding as jseed
from revisit_anything_tpu_torch import config as pconfig
from revisit_anything_tpu_torch.retrieval import analysis as pan
from revisit_anything_tpu_torch.retrieval import cluster_analysis as pca_
from revisit_anything_tpu_torch.utils import profiling as pprof
from revisit_anything_tpu_torch.utils import seeding as pseed


def _preds_gt(seed, n_q=12, n_db=20):
    rng = np.random.default_rng(seed)
    preds = [rng.permutation(n_db)[:5] for _ in range(n_q)]
    gt = [list(rng.choice(n_db, int(rng.integers(0, 3)), replace=False))
          for _ in range(n_q)]
    gt[0] = [int(preds[0][0])]               # a top-1 hit
    gt[1] = list(preds[1])                    # every prediction right
    return preds, gt


@pytest.mark.parametrize("seed", [0, 1])
def test_triplets_and_margins_match_jax(seed):
    preds, gt = _preds_gt(seed)
    trips = pan.create_triplets(preds, gt)
    assert trips == jan.create_triplets(preds, gt)
    assert all(isinstance(v, int) for t in trips for v in t)
    assert 1 not in [t[0] for t in trips]    # no wrong prediction
    rng = np.random.default_rng(seed + 10)
    q = rng.standard_normal((12, 16)).astype(np.float32)
    db = rng.standard_normal((20, 16)).astype(np.float32)
    np.testing.assert_array_equal(pan.calc_margins(q, db, trips),
                                  jan.calc_margins(q, db, trips))


def test_seg_area_covered_matches_jax():
    masks = np.random.default_rng(2).random((6, 30, 40)) < 0.3
    assert pan.seg_area_covered(masks) == jan.seg_area_covered(masks)


def test_compare_method_predictions_matches_jax():
    pb, gt = _preds_gt(3)
    pm, _ = _preds_gt(4)
    rows = pan.compare_method_predictions(pb, pm, gt)
    assert rows == jan.compare_method_predictions(pb, pm, gt)
    assert len(rows) == sum(len(g) > 0 for g in gt)


@pytest.mark.parametrize("heights", [(40, 40, 40), (40, 60, 30)])
def test_match_grid_matches_jax(heights):
    rng = np.random.default_rng(5)
    imgs = [rng.integers(0, 256, (h, 50, 3), dtype=np.uint8)
            for h in heights]
    got = pan.match_grid(imgs[0], imgs[1:], [True, False])
    np.testing.assert_array_equal(
        got, jan.match_grid(imgs[0], imgs[1:], [True, False]))
    assert got.dtype == np.uint8 and got.shape[0] == min(heights) + 8


def test_save_prediction_analysis_matches_jax(tmp_path):
    rng = np.random.default_rng(6)
    paths = []
    for i in range(6):
        p = str(tmp_path / f"im{i}.png")
        Image.fromarray(rng.integers(0, 256, (30 + i, 40, 3),
                                     dtype=np.uint8)).save(p)
        paths.append(p)
    gt = [[0], [1], [2], [3]]
    pb = [[0, 1], [5, 1], [2, 0], [4, 3]]
    pm = [[1, 0], [1, 5], [2, 0], [3, 4]]
    rows = pan.compare_method_predictions(pb, pm, gt)
    out = {}
    for name, mod in (("port", pan), ("jax", jan)):
        out[name] = mod.save_prediction_analysis(
            rows, paths[:4], paths, pb, pm, str(tmp_path / name))
    assert out["port"][1] == out["jax"][1] == 3
    with open(out["port"][0]) as a, open(out["jax"][0]) as b:
        assert list(csv.reader(a)) == list(csv.reader(b))
    for sub in ("correct", "incorrect"):
        names = sorted(os.listdir(tmp_path / "port" / sub))
        assert names == sorted(os.listdir(tmp_path / "jax" / sub))
        for n in names:
            np.testing.assert_array_equal(
                np.asarray(Image.open(tmp_path / "port" / sub / n)),
                np.asarray(Image.open(tmp_path / "jax" / sub / n)))


@pytest.mark.parametrize("per_image", [False, True])
def test_cluster_usage_matches_jax(per_image):
    rng = np.random.default_rng(7)
    centers = rng.standard_normal((6, 16)).astype(np.float32)
    # descriptors near a centre each: the top-2 similarities far apart
    lab = rng.integers(0, 6, 200)
    desc = centers[lab] + 0.05 * rng.standard_normal((200, 16))
    desc = (desc / np.linalg.norm(desc, axis=1, keepdims=True)).astype(
        np.float32)
    img = rng.integers(0, 5, 200) if per_image else None
    got = pca_.cluster_usage(desc, centers, img, device="cpu")
    np.testing.assert_array_equal(got, jca.cluster_usage(desc, centers, img))
    assert got.sum() == 200 and got.shape[1] == 6


def test_cluster_margins_ranks_and_cosine_match_jax():
    rng = np.random.default_rng(8)
    q, p, n = (rng.standard_normal((8, 12)) for _ in range(3))
    m = pca_.triplet_margin(q, p, n)
    np.testing.assert_allclose(m, jca.triplet_margin(q, p, n), rtol=1e-12)
    ra, rb = pca_.rank_clusters(m), pca_.rank_clusters(m[::-1].copy())
    np.testing.assert_array_equal(ra, jca.rank_clusters(m))
    shifts, cluster = pca_.cluster_rank_difference(ra, rb)
    jshifts, jcluster = jca.cluster_rank_difference(ra, rb)
    np.testing.assert_array_equal(shifts, jshifts)
    assert cluster == jcluster
    a = rng.standard_normal((5, 7))
    a[2] = 0.0                                   # a zero row: similarity 0
    b = rng.standard_normal((4, 7))
    np.testing.assert_allclose(pca_.pairwise_cosine(a, b),
                               jca.pairwise_cosine(a, b), rtol=1e-12)


def test_tsne_embed_matches_jax():
    """The same sklearn call on the same subsample (this machine has
    sklearn; the card's has not, and there the function raises)."""
    x = np.random.default_rng(9).standard_normal((40, 8)).astype(np.float32)
    got, gi = pca_.tsne_embed(x, perplexity=5.0, max_points=30)
    want, wi = jca.tsne_embed(x, perplexity=5.0, max_points=30)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (30, 2)


def test_plot_and_html_writers_write_their_files(tmp_path):
    rng = np.random.default_rng(10)
    img = rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)
    assign = {"a": rng.random((5, 16)), "b": rng.random((5, 16))}
    written = [
        pca_.save_tsne_plot(rng.standard_normal((20, 2)),
                            rng.integers(0, 3, 20), str(tmp_path / "t.png")),
        pca_.save_cluster_overlay(img, assign["a"], 2,
                                  str(tmp_path / "o.png")),
        pca_.save_cluster_panel(img, assign, 1, str(tmp_path / "p.png"),
                                w_burst=rng.random(16) + 0.5,
                                self_dis=rng.random((4, 4))),
        pca_.save_distance_histograms(rng.random(30), rng.random(30),
                                      str(tmp_path / "h.png"), "x"),
        pca_.save_cluster_gif(img, assign, str(tmp_path), "g"),
    ]
    for path in written:
        assert path is not None and os.path.getsize(path) > 0
    assert not [f for f in os.listdir(tmp_path) if f.startswith("_frame")]


def test_interactive_tsne_html_fixes_and_matches_jax_points(tmp_path):
    """The same document as the JAX writer's but for the three fixes: the
    tooltip placed on the first hover, points inset by their radius
    inside the frame, the legend spaced by the label's length."""
    rng = np.random.default_rng(11)
    exists = tmp_path / "exists.png"
    exists.write_bytes(b"")
    groups = [("queries", "red", rng.standard_normal((3, 2)),
               [str(exists), "<b>raw</b>", "missing.png"]),
              ("a long positive label", "green",
               rng.standard_normal((2, 2)), ["x.png", "y.png"])]
    kw = dict(width=300, height=260, point_radius=5)
    got = open(pca_.save_interactive_tsne_html(
        [("panel", groups)], str(tmp_path / "p.html"), **kw)).read()
    want = open(jca.save_interactive_tsne_html(
        [("panel", groups)], str(tmp_path / "j.html"), **kw)).read()
    tips = re.compile(r'data-tt="([^"]*)"')
    assert tips.findall(got) == tips.findall(want)
    assert "Image not found: missing.png" in got
    enter = got[got.index('"mouseenter"'):got.index('"mousemove"')]
    assert "tip.style.left" in enter and "tip.style.top" in enter
    margin, title_h, legend_h = 40, 28, 24
    plot_w = kw["width"] - 2 * margin
    plot_h = kw["height"] - 2 * margin - legend_h - title_h
    circles = re.findall(r'<circle cx="([\d.]+)" cy="([\d.]+)" r="5" '
                         r'fill="[^"]*" class="rat-pt"', got)
    assert len(circles) == 5
    for cx, cy in circles:
        assert margin + 5 - 0.05 <= float(cx) <= margin + plot_w - 5 + 0.05
        assert title_h + 5 - 0.05 <= float(cy) <= title_h + plot_h - 5 + 0.05
    legend = [float(x) for x in re.findall(r'<text x="([\d.]+)" y="[\d.]+" '
                                           r'class="rat-legend"', got)]
    assert legend[1] - legend[0] >= 7.5 * len("queries")
    with pytest.raises(ValueError):
        pca_.save_interactive_tsne_html(
            [("p", [("g", "red", np.zeros((2, 2)), ["one"])])],
            str(tmp_path / "bad.html"))


@pytest.mark.parametrize("seed", [0, 42])
def test_seed_everything_gives_the_jax_stream(seed):
    gen = pseed.seed_everything(seed)
    a = (gen.standard_normal(5), random.random(), np.random.random(),
         torch.rand(3))
    jgen = jseed.seed_everything(seed)
    b = (jgen.standard_normal(5), random.random(), np.random.random())
    np.testing.assert_array_equal(a[0], b[0])
    assert a[1] == b[1] and a[2] == b[2]
    pseed.seed_everything(seed)
    assert torch.equal(torch.rand(3), a[3])


def test_stage_timer_reports_as_jax(monkeypatch, tmp_path):
    """Stages timed on one fake clock: the same summary, report table and
    JSON dump as the JAX timer's."""
    ticks = iter(np.arange(0.0, 100.0, 0.25))

    def clock():
        return float(next(ticks))

    monkeypatch.setattr(pprof.time, "perf_counter", clock)
    timers = (pprof.StageTimer(), jprof.StageTimer())
    for t in timers:
        for name in ("sam.load", "sam.generate", "sam.load", "dino.forward"):
            with t.stage(name):
                clock()
    assert timers[0].summary() == timers[1].summary()
    assert timers[0].report() == timers[1].report()
    assert timers[0].report().splitlines()[0].split() == [
        "stage", "total_s", "count", "mean_ms"]
    timers[0].dump_json(str(tmp_path / "a.json"))
    timers[1].dump_json(str(tmp_path / "b.json"))
    assert open(tmp_path / "a.json").read() == open(tmp_path / "b.json").read()
    assert isinstance(pprof.stage_timer(), pprof.StageTimer)
    assert pprof.stage_timer() is pprof.stage_timer()


def test_trace_writes_a_profile_and_none_is_a_no_op(tmp_path):
    with pprof.trace(None):
        torch.ones(3).sum()
    d = tmp_path / "trace"
    with pprof.trace(str(d)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(d)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")


def test_workdir_config_reads_the_environment_when_made(monkeypatch):
    monkeypatch.setenv("RAT_DATA_ROOT", "d0")
    monkeypatch.setenv("RAT_WORKDIR", "w0")
    monkeypatch.setenv("RAT_CACHE_ROOT", "c0")
    a = pconfig.WorkdirConfig()
    monkeypatch.setenv("RAT_CACHE_ROOT", "c1")
    b = pconfig.WorkdirConfig()
    assert (a.data_root, a.workdir, a.cache_root) == ("d0", "w0", "c0")
    assert b.cache_root == "c1"
    for fine in (False, True):
        assert b.vocab_path("urban", fine) == jconfig.WorkdirConfig(
            cache_root="c1").vocab_path("urban", fine)
    monkeypatch.delenv("RAT_CACHE_ROOT")
    assert pconfig.WorkdirConfig().cache_root == "./cache"
