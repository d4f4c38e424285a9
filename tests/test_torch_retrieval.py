"""Port parity of the offline retrieval stages: configuration tree, h5 and
vocabulary files, mask geometry, whole-image VLAD, PCA (fit, apply, files),
kNN, rank fusion, Recall@K and the SegLoc and AnyLoc evaluation stages,
each against the JAX package on the same seeded inputs."""

import dataclasses
import pickle

import h5py
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from revisit_anything_tpu import config as jcfg
from revisit_anything_tpu.io import h5io as jio
from revisit_anything_tpu.io import vocab as jvocab
from revisit_anything_tpu.ops import knn as jknn
from revisit_anything_tpu.ops import masks as jmasks
from revisit_anything_tpu.ops import pca as jpca
from revisit_anything_tpu.ops import vlad as jvlad
from revisit_anything_tpu.pipeline import aggregate as jagg
from revisit_anything_tpu.pipeline import evaluate as jev
from revisit_anything_tpu.pipeline import vocabulary as jvoc
from revisit_anything_tpu.retrieval import matching as jmatch
from revisit_anything_tpu.retrieval import recall as jrec
from revisit_anything_tpu_torch import config as pcfg
from revisit_anything_tpu_torch.io import h5io as pio
from revisit_anything_tpu_torch.io import vocab as pvocab
from revisit_anything_tpu_torch.ops import knn as pknn
from revisit_anything_tpu_torch.ops import masks as pmasks
from revisit_anything_tpu_torch.ops import pca as ppca
from revisit_anything_tpu_torch.ops import vlad as pvlad
from revisit_anything_tpu_torch.pipeline import aggregate as pagg
from revisit_anything_tpu_torch.pipeline import evaluate as pev
from revisit_anything_tpu_torch.pipeline import vocabulary as pvoc
from revisit_anything_tpu_torch.pipeline.query import pca_tuple
from revisit_anything_tpu_torch.retrieval import matching as pmatch
from revisit_anything_tpu_torch.retrieval import recall as prec

torch.set_float32_matmul_precision("highest")
CPU = "cpu"
T = torch.from_numpy


def test_config_tree_matches_jax():
    assert list(pcfg.DATASETS) == list(jcfg.DATASETS)
    for name, d in jcfg.DATASETS.items():
        p = pcfg.get_dataset(name)
        assert dataclasses.asdict(p) == dataclasses.asdict(d), name
        assert p.sam_size.hw == d.sam_size.hw
        assert p.size.patch_grid == d.size.patch_grid
        for v in ("domain", "map"):
            assert p.vocab_id(v) == d.vocab_id(v)
    assert list(pcfg.EXPERIMENTS) == list(jcfg.EXPERIMENTS)
    for name, e in jcfg.EXPERIMENTS.items():
        assert (dataclasses.asdict(pcfg.get_experiment(name))
                == dataclasses.asdict(e))
    assert (dataclasses.asdict(pcfg.RetrievalConfig())
            == dataclasses.asdict(jcfg.RetrievalConfig()))
    for k in ("PATCH_SIZE", "NUM_CLUSTERS", "DINO_G_DIM", "VLAD_DIM",
              "PCA_DIM", "KNN_TOPK", "BORDA_TOPK", "RECALL_TOPK"):
        assert getattr(pcfg, k) == getattr(jcfg, k), k
    assert pcfg.PLACES17_HW == (480, 640)
    assert pcfg.PLACES17_SAM_HW == (240, 320)
    with pytest.raises(KeyError):
        pcfg.get_dataset("nowhere")


def test_h5_helpers_match_jax(tmp_path):
    """Keys natural-sorted, counts, stacked masks and the FastSAM-style
    segmentation-only records, read from one file by both packages."""
    rng = np.random.default_rng(1)
    path = str(tmp_path / "m.h5")
    recs = [pio.MaskRecord(rng.random((6, 9)) < 0.4, 5, (1, 2, 3, 4), 0.5,
                           np.ones((1, 2)), 0.75, (0, 0, 9, 6))
            for _ in range(12)]
    with h5py.File(path, "w") as f:
        for key in ("img_10", "img_2", "img_1"):
            pio.write_image_masks(f, key, recs[:11])
        f.create_group("bare/masks/0").create_dataset(
            "segmentation", data=recs[0].segmentation)
    with h5py.File(path) as f:
        assert pio.list_image_keys(f) == jio.list_image_keys(f)
        assert pio.list_image_keys(f)[:3] == ["bare", "img_1", "img_2"]
        assert pio.count_masks(f) == jio.count_masks(f) == 34
        for key in ("img_2", "bare"):
            np.testing.assert_array_equal(pio.read_all_masks_bool(f, key),
                                          jio.read_all_masks_bool(f, key))
            for a, b in zip(pio.read_image_masks(f, key, min_area=3),
                            jio.read_image_masks(f, key, min_area=3)):
                assert dataclasses.asdict(a).keys() == \
                    dataclasses.asdict(b).keys()
                assert (a.area, a.bbox, a.predicted_iou, a.crop_box) == (
                    b.area, b.bbox, b.predicted_iou, b.crop_box)


def test_h5_functions_need_h5py_only_when_called(monkeypatch):
    import builtins
    real = builtins.__import__

    def no_h5py(name, *a, **k):
        if name == "h5py":
            raise ImportError("no h5py here")
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_h5py)
    with pytest.raises(ImportError, match="needs the h5py package"):
        pio.open_h5("x.h5")


@pytest.mark.parametrize("ext", [".pt", ".npy", ".npz"])
def test_vocabulary_files_cross_read(tmp_path, ext):
    centers = np.random.default_rng(2).standard_normal((4, 6)).astype(
        np.float32)
    path = str(tmp_path / f"sub/c_centers{ext}")
    if ext == ".npz":
        import os
        os.makedirs(os.path.dirname(path))
        np.savez(path, c_centers=centers)
    else:
        pvocab.save_cluster_centers(path, centers)
    np.testing.assert_array_equal(jvocab.load_cluster_centers(path), centers)
    np.testing.assert_array_equal(pvocab.load_cluster_centers(path), centers)


def test_mask_geometry_matches_jax():
    rng = np.random.default_rng(3)
    masks = rng.random((5, 7, 9)) < 0.3
    masks[2] = False
    np.testing.assert_array_equal(pmasks.mask_centroids(masks),
                                  jmasks.mask_centroids(masks))
    np.testing.assert_array_equal(
        pmasks.masks_to_boxes(T(masks)).numpy(),
        np.asarray(jmasks.masks_to_boxes(jnp.asarray(masks))))


def test_global_vlad_matches_jax():
    rng = np.random.default_rng(4)
    desc = rng.standard_normal((50, 16)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    centers = rng.standard_normal((5, 16)).astype(np.float32)
    np.testing.assert_allclose(
        pvlad.global_vlad(T(desc), T(centers)).numpy(),
        np.asarray(jvlad.global_vlad(jnp.asarray(desc), jnp.asarray(centers))),
        atol=1e-6)


def _spectrum_data(rng, n=600, d=96, rank=24):
    """Low-rank data with a decaying spectrum plus noise."""
    basis = rng.standard_normal((rank, d))
    coef = rng.standard_normal((n, rank)) * np.geomspace(20, 1, rank)
    return (coef @ basis + 0.05 * rng.standard_normal((n, d))
            + 3.0).astype(np.float32)


def _max_sine(a, b):
    """Largest principal angle's sine between the row spaces of a and b."""
    qa, _ = np.linalg.qr(np.asarray(a, np.float64).T)
    qb, _ = np.linalg.qr(np.asarray(b, np.float64).T)
    cos = np.linalg.svd(qa.T @ qb, compute_uv=False)
    return float(np.sqrt(max(0.0, 1.0 - cos.min() ** 2)))


def test_pca_fit_matches_jax_and_sklearn():
    """Randomized fits of both packages (different random projections) and
    sklearn's exact one: explained variance within 1e-3 relative on the
    leading components, and the leading 90% of the components spanning
    the same subspace."""
    from sklearn.decomposition import PCA
    x = _spectrum_data(np.random.default_rng(5))
    k, lead = 20, 18
    got = ppca.pca_fit(T(x), k, whiten=True)
    want = jpca.pca_fit(jnp.asarray(x), k, whiten=True)
    sk = PCA(k, whiten=True, svd_solver="full").fit(x.astype(np.float64))
    ev = got.explained_variance.numpy()
    for ref in (np.asarray(want.explained_variance), sk.explained_variance_):
        np.testing.assert_allclose(ev[:lead], ref[:lead], rtol=1e-3)
    comps = got.components.numpy()
    for ref in (np.asarray(want.components), sk.components_):
        assert _max_sine(comps[:lead], ref[:lead]) < 1e-3
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(want.mean),
                               rtol=1e-6, atol=1e-6)
    # signs fixed the same way: each component's largest entry positive
    rows = np.arange(k)
    assert (comps[rows, np.abs(comps).argmax(1)] > 0).all()
    full = ppca.pca_fit_full(T(x))
    jfull = jpca.pca_fit_full(jnp.asarray(x))
    np.testing.assert_allclose(full.explained_variance.numpy()[:lead],
                               np.asarray(jfull.explained_variance)[:lead],
                               rtol=1e-3)
    assert _max_sine(full.components.numpy()[:lead],
                     np.asarray(jfull.components)[:lead]) < 1e-3


@pytest.mark.parametrize("whiten", [True, False])
def test_pca_apply_matches_jax_and_serving(whiten):
    """Given the same parameters the projections agree to 1e-5, and the
    serving tail takes the port's PCAParams."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((40, 32)).astype(np.float32)
    mean, comps = x.mean(0), rng.standard_normal((8, 32)).astype(np.float32)
    ev = rng.random(8).astype(np.float32) + 0.5
    got = ppca.pca_apply(T(x), ppca.PCAParams(T(mean), T(comps), T(ev),
                                              whiten)).numpy()
    want = np.asarray(jpca.pca_apply(jnp.asarray(x), jpca.PCAParams(
        jnp.asarray(mean), jnp.asarray(comps), jnp.asarray(ev), whiten)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    tup = pca_tuple(ppca.PCAParams(T(mean), T(comps), T(ev), whiten))
    assert tup[3] is whiten and tup[1].shape == (8, 32)


def test_pca_files_cross_read(tmp_path):
    """npz written by either package, and an sklearn pickle, load in
    both."""
    from sklearn.decomposition import PCA
    x = _spectrum_data(np.random.default_rng(7), n=200, d=24, rank=6)
    sk = PCA(4, whiten=True).fit(x)
    pkl = tmp_path / "pca.pkl"
    pkl.write_bytes(pickle.dumps(sk))
    got = ppca.load_sklearn_pca_pickle(str(pkl), device=CPU)
    np.testing.assert_allclose(ppca.pca_apply(T(x), got).numpy(),
                               sk.transform(x), rtol=1e-4, atol=1e-4)
    want = jpca.load_sklearn_pca_pickle(str(pkl))
    ppca.save_pca_npz(str(tmp_path / "p.npz"), got)
    jpca.save_pca_npz(str(tmp_path / "j.npz"), want)
    for params in (jpca.load_pca_npz(str(tmp_path / "p.npz")),
                   ppca.load_pca_npz(str(tmp_path / "j.npz"), device=CPU)):
        for field in ("mean", "components", "explained_variance"):
            np.testing.assert_array_equal(
                np.asarray(getattr(params, field)),
                getattr(got, field).numpy())
        assert bool(params.whiten) is True


@pytest.mark.parametrize("nq,nd,k", [(7, 50, 5), (3, 300, 200), (4, 20, 50)])
def test_knn_matches_jax(nq, nd, k):
    rng = np.random.default_rng(nq * nd)
    db = rng.standard_normal((nd, 24)).astype(np.float32)
    q = db[rng.integers(0, nd, nq)] + 0.1 * rng.standard_normal(
        (nq, 24)).astype(np.float32)
    for pfn, jfn in ((pknn.knn_l2, jknn.knn_l2),
                     (pknn.knn_inner_product, jknn.knn_inner_product)):
        s, i = pfn(T(q), T(db), k, db_tile=64)
        js, ji = jfn(jnp.asarray(q), jnp.asarray(db), k)
        assert s.shape == (nq, min(k, nd))
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5,
                                   atol=1e-4)


def test_knn_ties_take_the_lower_row_first():
    """Duplicate database rows tie exactly: the lower row comes first, in
    one tile and across tiles, as in JAX's lax.top_k."""
    rng = np.random.default_rng(9)
    base = rng.standard_normal((6, 8)).astype(np.float32)
    db = np.concatenate([base, base[::-1], base])        # rows tie in 3s
    q = base[:3] + 0.01
    for tile in (4, 64):
        s, i = pknn.knn_l2(T(q), T(db), 6, db_tile=tile)
        _, ji = jknn.knn_l2(jnp.asarray(q), jnp.asarray(db), 6)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        assert (i[:, 0] < i[:, 1]).all()


def _recall_inputs(rng, nq=12, nr=30):
    preds = [rng.permutation(nr)[:5] for _ in range(nq)]
    gt = [list(rng.choice(nr, rng.integers(0, 4), replace=False))
          for _ in range(nq)]
    for i in range(0, nq, 3):             # plant some hits
        if gt[i]:
            preds[i][i % 5] = gt[i][0]
    return preds, gt


def test_recall_metrics_match_jax():
    preds, gt = _recall_inputs(np.random.default_rng(10))
    for n in (1, 3, 5):
        assert prec.calc_recall(preds, gt, n) == jrec.calc_recall(preds, gt,
                                                                  n)
    assert prec.calculate_map(preds, gt) == jrec.calculate_map(preds, gt)
    ret = np.stack(preds)
    for n_db in (30, 250, 1000):
        assert (prec.one_percent_recall(ret, gt, n_db, 5)
                == jrec.one_percent_recall(ret, gt, n_db, 5))
    with pytest.raises(ValueError):
        prec.calc_recall(preds[:3], gt, 5)


def test_top_k_recall_matches_jax():
    rng = np.random.default_rng(11)
    db = rng.standard_normal((40, 16)).astype(np.float32)
    q = db[::2][:12] + 0.3 * rng.standard_normal((12, 16)).astype(np.float32)
    gt = [[2 * i] if i % 4 else [] for i in range(24)]
    for metric in ("l2", "ip"):
        got = prec.top_k_recall(T(db), T(q), gt, 5, metric=metric,
                                return_one_percent=True, sub_sample_qu=2)
        want = jrec.top_k_recall(jnp.asarray(db), jnp.asarray(q), gt, 5,
                                 metric=metric, return_one_percent=True,
                                 sub_sample_qu=2)
        assert got[0] == want[0] and got[2] == want[2]
        np.testing.assert_array_equal(got[1], np.asarray(want[1]))


METHODS = ("max_sim", "max_seg", "max_seg_sim", "max_seg_topk",
           "max_seg_topk_wt_borda_Im", "max_seg_topk_wt_borda",
           "max_seg_topk_borda", "max_seg_topk_avg", "max_seg_topk_avg_sim",
           "max_seg_topk_borda_Im", "max_seg_topk_avg_Im",
           "max_seg_topk_avg_sim_Im")


def _match_inputs(rng, n_q=5, per_q=6, n_db=60, r=10, n_ref=12):
    matches = rng.integers(0, n_db, (n_q * per_q, r))
    sims = 2.0 - rng.random((n_q * per_q, r)).astype(np.float32)
    ranges = [np.arange(i * per_q, (i + 1) * per_q) for i in range(n_q)]
    im_inds_ref = np.sort(rng.integers(0, n_ref, n_db))
    return matches, sims, ranges, im_inds_ref


@pytest.mark.parametrize("method", METHODS)
def test_host_rank_fusion_matches_jax(method):
    m, s, ranges, ref = _match_inputs(np.random.default_rng(12))
    got = pmatch.get_matches_host(m, s, ranges, ref, n=5, method=method)
    want = jmatch.get_matches_host(m, s, ranges, ref, n=5, method=method)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    ga = pmatch.get_matches_for_single_image_pair(m, s, ranges, top=7)
    wa = jmatch.get_matches_for_single_image_pair(m, s, ranges, top=7)
    for a, b in zip(ga, wa):
        np.testing.assert_array_equal(a, b)


def test_device_borda_matches_jax_with_planted_ties():
    """Dyadic similarities make image scores tie exactly; the lower image
    id ranks first and unfilled ranks are -1, as in JAX; a query image
    without segments predicts -1 throughout."""
    rng = np.random.default_rng(13)
    n_q, n_ref, r = 4, 9, 6
    q_ids = np.array([0, 0, 0, 1, 1, 3, 3, 3])           # image 2: none
    sims = rng.integers(0, 5, (len(q_ids), r)).astype(np.float32) / 4.0
    sims[3:5] = 0.5                       # query 1: every sim equal
    ref_ids = np.repeat(np.arange(n_ref), 4)
    matches = rng.integers(0, len(ref_ids), (len(q_ids), r))
    matches[5:, :] = np.array([0, 4, 8, 12, 16, 20])      # images 0-5 tie
    sims[5:, :] = 0.75
    args = (sims, matches, q_ids, ref_ids)
    got = pmatch.weighted_borda_predict(*map(T, args), n_q, n_ref, n=5)
    want = jmatch.weighted_borda_predict(*map(jnp.asarray, args), n_q,
                                         n_ref, n=5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got[2] == -1).all()
    assert got[3].tolist() == [0, 1, 2, 3, 4]


def _banks(rng, n_db=10, per=5, dim=48, n_q=5):
    """Database segment bank of unit rows and query banks of noisy copies
    of images 1, 3, ...; the last query image has no segments."""
    db = rng.standard_normal((n_db * per, dim)).astype(np.float32)
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    db_ids = np.repeat(np.arange(n_db), per)
    targets = [(2 * i + 1) % n_db for i in range(n_q)]
    rows, ids = [], []
    for qi, t in enumerate(targets[:-1]):
        q = db[db_ids == t][:per - 1] + 0.2 * rng.standard_normal(
            (per - 1, dim)).astype(np.float32)
        rows.append(q / np.linalg.norm(q, axis=1, keepdims=True))
        ids += [qi] * (per - 1)

    def mk(pkg, d, i, n):
        return pkg.SegmentBank(d, np.asarray(i, np.int64), num_images=n)

    desc_q = np.concatenate(rows)
    return ({"jax": mk(jagg, db, db_ids, n_db),
             "port": mk(pagg, db, db_ids, n_db)},
            {"jax": mk(jagg, desc_q, ids, n_q),
             "port": mk(pagg, desc_q, ids, n_q)},
            [[t] for t in targets])


@pytest.mark.parametrize("use_pca", [False, True])
@pytest.mark.parametrize("voting", [True, False])
def test_segloc_retrieval_matches_jax(use_pca, voting):
    """Device and host voting, with and without the same PCA: equal
    predictions, recalls and mAP."""
    db, q, gt = _banks(np.random.default_rng(14))
    jp = pp = None
    if use_pca:
        jp = jvoc.fit_pca_from_vlads(db["jax"], num_components=12)
        pp = ppca.PCAParams(*(T(np.asarray(a)) for a in jp[:3]), jp.whiten)
    kw = dict(map_calculate=True, device_voting=voting, knn_topk=30,
              borda_topk=20)
    want = jev.run_segloc_retrieval(db["jax"], q["jax"], gt, pca=jp,
                                    mesh=None, **kw)
    got = pev.run_segloc_retrieval(db["port"], q["port"], gt, pca=pp,
                                   device=CPU, **kw)
    assert got.recalls == want.recalls and got.map_value == want.map_value
    assert len(got.predictions) == len(want.predictions) == len(gt)
    for a, b in zip(got.predictions, want.predictions):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(got.matches, want.matches)
    np.testing.assert_allclose(got.sims, want.sims, atol=1e-4)
    if not use_pca:
        assert got.recalls[0] == 0.8     # the segment-less query misses


def test_anyloc_retrieval_matches_jax():
    rng = np.random.default_rng(15)
    db = rng.standard_normal((150, 32)).astype(np.float32)
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    q = db[10:40:3] + 0.3 * rng.standard_normal((10, 32)).astype(np.float32)
    gt = [[10 + 3 * i] for i in range(10)] + [[0]]        # one extra gt row
    want = jev.run_anyloc_retrieval(db, q, gt)
    got = pev.run_anyloc_retrieval(db, q, gt, device=CPU)
    assert got.recalls == want.recalls
    assert got.one_percent_recall == want.one_percent_recall
    np.testing.assert_array_equal(got.matches, want.matches)
    np.testing.assert_allclose(got.sims, want.sims, atol=1e-4)


def test_vocabulary_and_pca_fit_stages_run_seeded():
    """fit_vocabulary and fit_pca_from_vlads (with the ≤ max_segments
    sample the JAX package draws) are deterministic for a seed; the PCA
    sample fits the same rows as JAX's, so the leading variances agree."""
    rng = np.random.default_rng(16)
    descs = rng.standard_normal((300, 16)).astype(np.float32)
    a = pvoc.fit_vocabulary(descs, 4, seed=1, num_iters=5, device=CPU)
    b = pvoc.fit_vocabulary(T(descs), 4, seed=1, num_iters=5, device=CPU)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (4, 16)
    x = _spectrum_data(rng, n=500, d=40, rank=10)
    bank = pagg.SegmentBank(x, np.zeros(len(x), np.int64))
    got = pvoc.fit_pca_from_vlads(bank, num_components=8, max_segments=300,
                                  device=CPU)
    want = jvoc.fit_pca_from_vlads(jagg.SegmentBank(x, bank.image_indices),
                                   num_components=8, max_segments=300)
    np.testing.assert_allclose(got.explained_variance.numpy()[:6],
                               np.asarray(want.explained_variance)[:6],
                               rtol=1e-3)
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(want.mean),
                               atol=1e-5)
