"""Ground truth per dataset, on the host (counterpart of
``revisit_anything_tpu/datasets/gt.py``; the reference's gt.py:10-79
dispatch and its loaders): Baidu .camera poses with 10 m radius
positives, MSLS from SALAD's npy files with per-city natural-sort
re-indexing, Pitts30k / SF-XL UTM from file names at 25 m, InsideOut GPS
pickles at 50 m, 17places index ± 15, AmsterTime identity, VPAir's gt
npy.

Radius positives come from ``scipy.spatial.cKDTree`` (inclusive at the
radius, as sklearn's ``radius_neighbors`` is), each query's indices
sorted.
"""

from __future__ import annotations

import os
import pickle
from typing import List, Optional, Sequence

import numpy as np

from revisit_anything_tpu_torch.io.h5io import _natural_key, natsorted_keys


def radius_positives(db_coords: np.ndarray, query_coords: np.ndarray,
                     radius: float) -> List[np.ndarray]:
    """Per query, the database indices within ``radius`` (distance ≤
    radius; func_vpr.py get_positives :1656-1669), sorted, int64."""
    from scipy.spatial import cKDTree
    tree = cKDTree(np.asarray(db_coords, dtype=np.float64))
    hits = tree.query_ball_point(np.asarray(query_coords, dtype=np.float64),
                                 r=radius, return_sorted=True)
    return [np.asarray(h, dtype=np.int64) for h in hits]


def _floats(line: str) -> np.ndarray:
    return np.array(line.split(), dtype=float)


def parse_camera_pose(path: str) -> np.ndarray:
    """Camera centre [x, y, z] of a Baidu .camera file: its second-to-last
    line (baidu_dataloader.py get_cop_pose :55-73)."""
    with open(path) as f:
        lines = f.readlines()
    return _floats(lines[-2])


def parse_camera_pose_rot(path: str):
    """(centre [x, y, z], zyx Euler angles in degrees [3]) of a Baidu
    .camera file, whose lines 4-6 hold the 3x3 rotation."""
    from scipy.spatial.transform import Rotation
    with open(path) as f:
        lines = f.readlines()
    rot = np.stack([_floats(lines[i]) for i in (4, 5, 6)])
    return (_floats(lines[-2]),
            Rotation.from_matrix(rot).as_euler("zyx", degrees=True))


def angular_filter_positives(positives: List[np.ndarray],
                             db_euler: np.ndarray, q_euler: np.ndarray,
                             ang_thresh: float) -> List[np.ndarray]:
    """Keep the radius positives whose mean absolute Euler-angle
    difference is below ``ang_thresh`` degrees (baidu_dataloader.py
    use_ang_positives :160-196)."""
    out = []
    for i, pos in enumerate(positives):
        keep = [j for j in np.asarray(pos)
                if np.mean(np.abs(q_euler[i] - db_euler[j])) < ang_thresh]
        out.append(np.asarray(keep, dtype=np.int64))
    return out


def utm_from_paths(paths: Sequence[str]) -> np.ndarray:
    """UTM (easting, northing) from '@'-delimited file names
    (func_vpr.py get_utm :1647-1653)."""
    return np.array([(float(p.split("@")[1]), float(p.split("@")[2]))
                     for p in paths])


def _baidu_gt(data_root: str, dist_thresh: float = 10.0,
              ang_thresh: Optional[float] = None) -> List[np.ndarray]:
    """Baidu positives within ``dist_thresh`` metres and, with
    ``ang_thresh`` (degrees), within that mean Euler-angle difference."""
    base = os.path.join(data_root, "baidu")

    def poses(sub):
        files = natsorted_keys(os.listdir(os.path.join(base, sub)))
        both = [parse_camera_pose_rot(os.path.join(base, sub, f))
                for f in files]
        return (np.stack([b[0] for b in both]),
                np.stack([b[1] for b in both]))

    db_xyz, db_euler = poses("training_gt")
    q_xyz, q_euler = poses("query_gt")
    positives = radius_positives(db_xyz, q_xyz, dist_thresh)
    if ang_thresh is None:
        return positives
    return angular_filter_positives(positives, db_euler, q_euler,
                                    ang_thresh)


def _vpair_gt(data_root: str) -> List[np.ndarray]:
    gt = np.load(os.path.join(data_root, "VPAir", "vpair_gt.npy"),
                 allow_pickle=True)
    return [np.asarray(entry[1]) for entry in gt]


def msls_city_of(name) -> Optional[str]:
    """The reference's city of an MSLS image (MapillaryDatasetVal.py
    :137-154): 'cph' is tested first, since a random image key can
    contain 'sf'."""
    s = str(name)
    if "cph" in s:
        return "cph"
    if "sf" in s:
        return "sf"
    return None


def _msls_gt(city: str, gt_root: str) -> List[np.ndarray]:
    """MSLS val ground truth from SALAD's npy files, filtered to a city and
    re-indexed to the natural-sorted image lists
    (MapillaryDatasetVal.py:31-180)."""
    db_images = np.load(os.path.join(gt_root, "msls_val_dbImages.npy"))
    q_idx = np.load(os.path.join(gt_root, "msls_val_qIdx.npy"))
    q_images = np.load(os.path.join(gt_root, "msls_val_qImages.npy"))[q_idx]
    p_idx = np.load(os.path.join(gt_root, "msls_val_pIdx.npy"),
                    allow_pickle=True)

    db_sel = [i for i, p in enumerate(db_images) if msls_city_of(p) == city]
    q_sel = [i for i, p in enumerate(q_images) if msls_city_of(p) == city]
    db_old2new = {old: new for new, old in enumerate(db_sel)}
    db_city = [str(db_images[i]) for i in db_sel]
    q_city = [str(q_images[i]) for i in q_sel]
    gt_city = [[db_old2new[j] for j in p_idx[i] if j in db_old2new]
               for i in q_sel]

    db_order = sorted(range(len(db_city)),
                      key=lambda i: _natural_key(db_city[i]))
    q_order = sorted(range(len(q_city)),
                     key=lambda i: _natural_key(q_city[i]))
    db_pos = {old: new for new, old in enumerate(db_order)}
    return [np.asarray(sorted(db_pos[j] for j in gt_city[i]))
            for i in q_order]


def get_gt(dataset: str, data_root: str,
           ref_paths: Optional[Sequence[str]] = None,
           query_paths: Optional[Sequence[str]] = None,
           msls_gt_root: Optional[str] = None,
           baidu_ang_thresh: Optional[float] = None) -> Optional[List]:
    """Ground truth of ``dataset`` (the reference's gt.py:10-79
    dispatch): per query its positive database indices; None for a
    dataset without one. ``baidu_ang_thresh``: Baidu's optional
    orientation filter in degrees (off by default, as in the
    reference)."""
    if dataset == "baidu":
        return _baidu_gt(data_root, ang_thresh=baidu_ang_thresh)
    if dataset in ("mslsSF", "mslsCPH"):
        city = "sf" if dataset == "mslsSF" else "cph"
        root = msls_gt_root or os.path.join(data_root, "msls_npy_files")
        return _msls_gt(city, root)
    if dataset == "pitts":
        base = os.path.join(data_root, "pitts", "pitts30k", "images", "test")
        db = np.load(os.path.join(base, "database.npy"))
        q = np.load(os.path.join(base, "queries.npy"))
        return radius_positives(utm_from_paths(db), utm_from_paths(q), 25)
    if dataset == "SFXL":
        if ref_paths is None or query_paths is None:
            raise ValueError("SFXL needs ref/query paths (UTM in filenames)")
        return radius_positives(utm_from_paths(ref_paths),
                                utm_from_paths(query_paths), 25)
    if dataset == "InsideOut":
        base = os.path.join(data_root, "InsideOut")
        with open(os.path.join(base, "gps_db_correct.pkl"), "rb") as f:
            utm_db = pickle.load(f)
        with open(os.path.join(base, "gps_q_new.pkl"), "rb") as f:
            utm_q = pickle.load(f)
        return radius_positives(np.asarray(utm_db), np.asarray(utm_q), 50)
    if dataset == "17places":
        if query_paths is None:
            raise ValueError("17places needs query paths (index gt)")
        rad = 15
        return [list(np.arange(i - rad, i + rad + 1))
                for i in range(len(query_paths))]
    if dataset == "AmsterTime":
        if ref_paths is None:
            raise ValueError("AmsterTime needs ref paths (identity gt)")
        return [[i] for i in range(len(ref_paths))]
    if dataset == "VPAir":
        return _vpair_gt(data_root)
    return None
