"""MSLS raw-data preparation (counterpart of
``revisit_anything_tpu/datasets/msls_prep.py``; the reference's
msls_data_clean scripts, README.md:7-36: CPH 12556 db / 498 q, SF 6315
db / 242 q). An image belongs to a city's evaluation subset iff it is in
that city's natural-sorted db or query list of SALAD's npy files.
"""

from __future__ import annotations

import os
import shutil
from typing import List, Tuple

import numpy as np

from revisit_anything_tpu_torch.datasets.gt import msls_city_of
from revisit_anything_tpu_torch.io.h5io import _natural_key

EXPECTED_COUNTS = {"cph": (12556, 498), "sf": (6315, 242)}


def city_image_lists(gt_root: str, city: str) -> Tuple[List[str], List[str]]:
    """(db names, query names) of a city, natural-sorted."""
    db_images = np.load(os.path.join(gt_root, "msls_val_dbImages.npy"))
    q_idx = np.load(os.path.join(gt_root, "msls_val_qIdx.npy"))
    q_images = np.load(os.path.join(gt_root, "msls_val_qImages.npy"))[q_idx]
    db = sorted((str(p) for p in db_images if msls_city_of(p) == city),
                key=_natural_key)
    q = sorted((str(p) for p in q_images if msls_city_of(p) == city),
               key=_natural_key)
    return db, q


def filter_city_images(gt_root: str, city: str, raw_root: str,
                       out_root: str, copy: bool = True) -> Tuple[int, int]:
    """Copy a city's evaluation subset (``database/`` and ``query/``) out
    of a raw MSLS dump; returns (n_db, n_q) found."""
    db, q = city_image_lists(gt_root, city)
    counts = []
    for sub, names in (("database", db), ("query", q)):
        out_dir = os.path.join(out_root, sub)
        os.makedirs(out_dir, exist_ok=True)
        n = 0
        for name in names:
            src = os.path.join(raw_root, os.path.basename(name))
            if not os.path.exists(src):
                src = os.path.join(raw_root, name)
            if os.path.exists(src):
                if copy:
                    shutil.copy2(src, os.path.join(
                        out_dir, os.path.basename(name)))
                n += 1
        counts.append(n)
    return counts[0], counts[1]


def verify_counts(city: str, n_db: int, n_q: int,
                  strict: bool = False) -> bool:
    """Compare the counts with the reference's (printed; ``strict``
    raises on a mismatch)."""
    exp_db, exp_q = EXPECTED_COUNTS[city]
    ok = (n_db, n_q) == (exp_db, exp_q)
    status = "MATCH" if ok else "MISMATCH"
    print(f"[msls:{city}] db {n_db}/{exp_db} q {n_q}/{exp_q} -> {status}")
    if strict and not ok:
        raise ValueError(
            f"msls {city} counts {n_db}/{n_q} != expected {exp_db}/{exp_q}")
    return ok
