"""Port parity of the dataset loaders (``revisit_anything_tpu_torch.
datasets``) with the JAX package's: ``get_gt`` for every dataset on
synthetic files written from a seed, the radius positives (scipy's
kd-tree in the port, sklearn in the JAX package) with points exactly at
the radius, image listings, the aerial, MSLS-preparation and VLAD-BuFF
loaders. Positives are compared as sorted sets (the port returns each
query's indices sorted)."""

import os
import pickle

import numpy as np
import pytest

from revisit_anything_tpu import config as jcfg
from revisit_anything_tpu.datasets import aerial as jaer
from revisit_anything_tpu.datasets import gt as jgt
from revisit_anything_tpu.datasets import images as jimg
from revisit_anything_tpu.datasets import msls_prep as jmsls
from revisit_anything_tpu.datasets import vladbuff_val as jvb
from revisit_anything_tpu_torch import config as pcfg
from revisit_anything_tpu_torch.datasets import aerial as paer
from revisit_anything_tpu_torch.datasets import gt as pgt
from revisit_anything_tpu_torch.datasets import images as pimg
from revisit_anything_tpu_torch.datasets import msls_prep as pmsls
from revisit_anything_tpu_torch.datasets import vladbuff_val as pvb


def _same_positives(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(np.asarray(g).tolist()) == sorted(
            np.asarray(w).tolist())


def _utm_names(rng, n, tag):
    xy = rng.uniform(0, 200, (n, 2)).round(1)
    return [f"{tag}/@{x}@{y}@{tag}{i:03d}.jpg" for i, (x, y) in
            enumerate(xy)]


def _camera(rot_rows, xyz):
    return "h\nh\nh\nh\n" + rot_rows + "0 0 0\n" + \
        " ".join(str(v) for v in xyz) + "\n640 480\n"


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """Every dataset's ground-truth files, made from one seed."""
    root = tmp_path_factory.mktemp("datasets")
    rng = np.random.default_rng(0)
    # Baidu: camera files with rotations about z, some 3-4-5 triangles
    # apart so a database camera sits exactly at the 10 m radius
    for sub, n in (("training_gt", 30), ("query_gt", 8)):
        d = root / "baidu" / sub
        d.mkdir(parents=True)
        xyz = rng.uniform(0, 40, (n, 3)).round(1)
        if sub == "training_gt":
            xyz[0] = (6.0, 8.0, 0.0)
        else:
            xyz[0] = (0.0, 0.0, 0.0)
        for i in range(n):
            a = np.deg2rad(rng.uniform(-60, 60))
            rot = (f"{np.cos(a)} {-np.sin(a)} 0\n{np.sin(a)} {np.cos(a)} 0\n"
                   "0 0 1\n")
            (d / f"img_{i}.camera").write_text(_camera(rot, xyz[i]))
    # MSLS: SALAD-style npy files over two cities and a third
    cities = ["cph", "sf", "zurich"]
    db = np.array([f"train_val/{cities[i % 3]}/database/db_{i}.jpg"
                   for i in range(24)])
    q_all = np.array([f"train_val/{cities[i % 3]}/query/q_{i}.jpg"
                      for i in range(15)])
    q_idx = np.arange(0, 15, 2)
    p_idx = np.empty(len(q_idx), dtype=object)
    for k in range(len(q_idx)):
        p_idx[k] = rng.choice(24, size=rng.integers(1, 6), replace=False)
    msls = root / "msls_npy_files"
    msls.mkdir()
    np.save(msls / "msls_val_dbImages.npy", db)
    np.save(msls / "msls_val_qImages.npy", q_all)
    np.save(msls / "msls_val_qIdx.npy", q_idx)
    np.save(msls / "msls_val_pIdx.npy", p_idx, allow_pickle=True)
    # Pitts30k: UTM in the npy image names, one query 25 m from a
    # database image along a 7-24-25 triangle
    pitts = root / "pitts" / "pitts30k" / "images" / "test"
    pitts.mkdir(parents=True)
    pdb = _utm_names(rng, 40, "db") + ["db/@107.0@124.0@edge.jpg"]
    pq = _utm_names(rng, 10, "q") + ["q/@100.0@100.0@edge.jpg"]
    np.save(pitts / "database.npy", np.array(pdb))
    np.save(pitts / "queries.npy", np.array(pq))
    # InsideOut: GPS pickles at 50 m
    io_dir = root / "InsideOut"
    io_dir.mkdir()
    with open(io_dir / "gps_db_correct.pkl", "wb") as f:
        pickle.dump(rng.uniform(0, 300, (30, 2)).tolist()
                    + [[30.0, 40.0]], f)
    with open(io_dir / "gps_q_new.pkl", "wb") as f:
        pickle.dump(rng.uniform(0, 300, (6, 2)).tolist() + [[0.0, 0.0]], f)
    # VPAir: the gt npy of (query, positives) pairs
    vp = root / "VPAir"
    vp.mkdir()
    entries = np.empty(5, dtype=object)
    for i in range(5):
        entries[i] = (i, list(rng.choice(50, size=3, replace=False)))
    np.save(vp / "vpair_gt.npy", entries, allow_pickle=True)
    return root


@pytest.fixture(scope="module")
def sfxl_paths():
    rng = np.random.default_rng(1)
    refs = _utm_names(rng, 50, "ref") + ["ref/@3.0@4.0@edge.jpg"]
    qs = _utm_names(rng, 12, "q") + ["q/@-12.0@-5.0@edge.jpg"]
    return refs, qs


@pytest.mark.parametrize("dataset", ["baidu", "mslsSF", "mslsCPH", "pitts",
                                     "SFXL", "InsideOut", "17places",
                                     "AmsterTime", "VPAir", "unknown"])
def test_get_gt_matches_jax(data_root, sfxl_paths, dataset):
    refs, qs = sfxl_paths
    kw = dict(ref_paths=refs, query_paths=qs)
    want = jgt.get_gt(dataset, str(data_root), **kw)
    got = pgt.get_gt(dataset, str(data_root), **kw)
    if want is None:
        assert got is None
        return
    _same_positives(got, want)
    assert any(len(p) for p in got)
    if dataset in ("baidu", "pitts", "SFXL", "InsideOut"):
        # the planted point exactly at the radius is a positive
        edge_q = 0 if dataset == "baidu" else len(got) - 1
        edge_db = {"baidu": 0, "pitts": 40, "SFXL": 50, "InsideOut": 30}
        assert edge_db[dataset] in got[edge_q].tolist()
        assert all(np.all(np.diff(p) > 0) for p in got)


def test_baidu_angular_filter_matches_jax(data_root):
    for thresh in (5.0, 20.0, 45.0):
        _same_positives(
            pgt.get_gt("baidu", str(data_root), baidu_ang_thresh=thresh),
            jgt.get_gt("baidu", str(data_root), baidu_ang_thresh=thresh))


def test_get_gt_raises_as_jax_does(data_root):
    for dataset in ("SFXL", "17places", "AmsterTime"):
        with pytest.raises(ValueError):
            jgt.get_gt(dataset, str(data_root))
        with pytest.raises(ValueError):
            pgt.get_gt(dataset, str(data_root))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_radius_positives_match_jax_and_brute_force(seed):
    """scipy's kd-tree against sklearn's radius_neighbors (the JAX
    package) and a brute-force distance matrix, with database points
    planted exactly at the radius (3-4-5 triangles, distance 5)."""
    rng = np.random.default_rng(seed)
    db = rng.uniform(0, 60, (400, 2)).round(2)
    q = rng.uniform(0, 60, (50, 2)).round(2)
    q[:10] = q[:10].round(0)                    # exact in binary
    db[:10] = q[:10] + np.array([3.0, 4.0])
    got = pgt.radius_positives(db, q, 5.0)
    _same_positives(got, jgt.radius_positives(db, q, 5.0))
    d2 = ((q[:, None, :] - db[None, :, :]) ** 2).sum(-1)
    for i, g in enumerate(got):
        assert g.dtype == np.int64
        assert g.tolist() == np.flatnonzero(d2[i] <= 25.0).tolist()
    assert all(i in got[i].tolist() for i in range(10))


def test_pose_and_utm_parsers_match_jax(data_root):
    cam = str(data_root / "baidu" / "training_gt" / "img_3.camera")
    np.testing.assert_array_equal(pgt.parse_camera_pose(cam),
                                  jgt.parse_camera_pose(cam))
    for a, b in zip(pgt.parse_camera_pose_rot(cam),
                    jgt.parse_camera_pose_rot(cam)):
        np.testing.assert_array_equal(a, b)
    names = ["img@123.5@678.25@x.jpg", "a@-10.0@20.0@.png"]
    np.testing.assert_array_equal(pgt.utm_from_paths(names),
                                  jgt.utm_from_paths(names))
    for name in ("train_val/cph/query/LDPdkYSQGgUsflOXmFS2gw.jpg",
                 "train_val/sf/db/a.jpg", "x/y.jpg"):
        assert pgt.msls_city_of(name) == jgt.msls_city_of(name)


def test_list_dataset_images_matches_jax(tmp_path):
    """Natural sort, no extension filter, directories skipped."""
    ds = jcfg.get_dataset("17places")
    assert pcfg.get_dataset("17places").data_subpath_ref == \
        ds.data_subpath_ref
    rng = np.random.default_rng(3)
    for sub in (ds.data_subpath_ref, ds.data_subpath_query):
        d = tmp_path / ds.name / sub
        d.mkdir(parents=True)
        (d / "nested").mkdir()
        for i in rng.permutation(25):
            ext = (".jpg", ".png", ".tif", ".txt")[i % 4]
            (d / f"img{i}{ext}").write_bytes(b"x")
    want = jimg.list_dataset_images(ds, str(tmp_path))
    got = pimg.list_dataset_images(pcfg.get_dataset("17places"),
                                   str(tmp_path))
    assert got == want
    assert len(got[0]) == len(got[1]) == 25


def test_aerial_dataset_matches_jax(tmp_path):
    root = tmp_path / paer.VARIANTS["Tartan_GNSS_test_rotated"]
    for sub, n in (("reference_images", 12), ("query_images", 4)):
        (root / sub).mkdir(parents=True)
        for i in range(n):
            (root / sub / f"{i}.png").write_bytes(b"x")
    rng = np.random.default_rng(4)
    rows = ["query_ind," + ",".join(f"top_{k}_ref_ind" for k in range(1, 6))]
    for i in range(4):
        rows.append(f"{i}," + ",".join(
            str(v) for v in rng.choice(12, 5, replace=False)))
    (root / "gt_matches.csv").write_text("\n".join(rows) + "\n")
    want = jaer.AerialDataset.from_root(str(tmp_path),
                                        "Tartan_GNSS_test_rotated")
    got = paer.AerialDataset.from_root(str(tmp_path),
                                       "Tartan_GNSS_test_rotated")
    assert got.get_image_paths() == want.get_image_paths()
    assert got.get_positives() == want.get_positives()
    assert (got.database_num, got.queries_num) == (12, 4)
    with pytest.raises(NotImplementedError):
        paer.AerialDataset.from_root(str(tmp_path), "nope")


def test_msls_prep_matches_jax(data_root, tmp_path):
    gt_root = str(data_root / "msls_npy_files")
    for city in ("cph", "sf"):
        assert (pmsls.city_image_lists(gt_root, city)
                == jmsls.city_image_lists(gt_root, city))
    raw = tmp_path / "raw"
    raw.mkdir()
    db, q = pmsls.city_image_lists(gt_root, "cph")
    for name in db[::2] + q:
        (raw / os.path.basename(name)).write_bytes(b"x")
    got = pmsls.filter_city_images(gt_root, "cph", str(raw),
                                   str(tmp_path / "out_p"))
    want = jmsls.filter_city_images(gt_root, "cph", str(raw),
                                    str(tmp_path / "out_j"))
    assert got == want == (len(db[::2]), len(q))
    assert sorted(os.listdir(tmp_path / "out_p" / "database")) == sorted(
        os.listdir(tmp_path / "out_j" / "database"))
    assert pmsls.EXPECTED_COUNTS == jmsls.EXPECTED_COUNTS
    assert pmsls.verify_counts("cph", *pmsls.EXPECTED_COUNTS["cph"])
    with pytest.raises(ValueError):
        pmsls.verify_counts("sf", 1, 2, strict=True)


@pytest.fixture
def vladbuff_root(tmp_path):
    rng = np.random.default_rng(5)
    sub = tmp_path / "st_lucia"
    sub.mkdir()
    np.save(sub / "st_lucia_dbImages.npy",
            np.array(_utm_names(rng, 30, "ref")))
    np.save(sub / "st_lucia_qImages.npy", np.array(_utm_names(rng, 6, "q")))
    nord = tmp_path / "Nordland"
    nord.mkdir()
    np.save(nord / "Nordland_dbImages.npy",
            np.array([f"db/{i}.png" for i in range(10)]))
    np.save(nord / "Nordland_qImages.npy",
            np.array([f"q/{i}.png" for i in range(3)]))
    gt = np.empty(3, dtype=object)
    for i in range(3):
        gt[i] = np.array([i, i + 1])
    np.save(nord / "Nordland_gt.npy", gt, allow_pickle=True)
    mt = tmp_path / "msls_test"
    mt.mkdir()
    np.save(mt / "msls_test_dbImages.npy", np.array(["a.jpg", "b.jpg"]))
    np.save(mt / "msls_test_qImages.npy", np.array(["c.jpg"]))
    mv = tmp_path / "msls_val"
    mv.mkdir()
    np.save(mv / "msls_val_qImages.npy",
            np.array([f"q{i}.jpg" for i in range(5)]))
    np.save(mv / "msls_val_qIdx.npy", np.array([1, 3]))
    pidx = np.empty(2, dtype=object)
    pidx[0], pidx[1] = np.array([0, 2]), np.array([1])
    np.save(mv / "msls_val_pIdx.npy", pidx, allow_pickle=True)
    return tmp_path


@pytest.mark.parametrize("name", ["st_lucia", "nordland", "msls_test"])
def test_vladbuff_val_matches_jax(vladbuff_root, name):
    want = jvb.load_vladbuff_val(name, gt_root=str(vladbuff_root))
    got = pvb.load_vladbuff_val(name, gt_root=str(vladbuff_root))
    assert (got.db_images, got.q_images) == (want.db_images, want.q_images)
    assert got.images == want.images
    if want.ground_truth is None:
        assert got.ground_truth is None
    else:
        _same_positives(got.ground_truth, want.ground_truth)
    assert pvb.REGISTRY == jvb.REGISTRY


def test_vladbuff_msls_val_and_missing_files(vladbuff_root):
    root = str(vladbuff_root)
    for mod in (jvb, pvb):
        with pytest.raises(FileNotFoundError):
            mod.load_msls_val(gt_root=root)
        with pytest.raises(KeyError):
            mod.load_vladbuff_val("nope", gt_root=root)
        with pytest.raises(FileNotFoundError):
            mod.load_vladbuff_val("sped", gt_root=root)
    np.save(vladbuff_root / "msls_val" / "msls_val_dbImages.npy",
            np.array([f"d{i}.jpg" for i in range(4)]))
    want = jvb.load_msls_val(gt_root=root)
    got = pvb.load_msls_val(gt_root=root)
    assert (got.db_images, got.q_images) == (want.db_images, want.q_images)
    _same_positives(got.ground_truth, want.ground_truth)
