"""VLAD-BuFF benchmark validation sets (counterpart of
``revisit_anything_tpu/datasets/vladbuff_val.py``; the reference's
VLAD-BuFF/dataloaders/val/*.py). Image lists ship as npy files; ground
truth is one of:

- "npy": a pickled object array of positive db indices a query
  (Nordland, SPED, Pittsburgh);
- "utm": UTM from the file names ("...@east@north@...") with a radius
  query (AmsterTime, StLucia, Tokyo247, Sfsm);
- "msls": qIdx / pIdx npy pairs (:func:`load_msls_val`);
- "none": held-out test sets without public ground truth (msls_test).

The npy root is the caller's ``gt_root``, else ``$VLADBUFF_GT_ROOT``,
else ``VLAD-BuFF/datasets`` under the working directory.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import numpy as np

from revisit_anything_tpu_torch.datasets.gt import (radius_positives,
                                                    utm_from_paths)

DEFAULT_GT_ROOT = os.environ.get("VLADBUFF_GT_ROOT",
                                 os.path.join("VLAD-BuFF", "datasets"))

# name → (subdir, db stem, q stem, gt mode[, radius])
REGISTRY = {
    "nordland": ("Nordland", "Nordland_dbImages.npy",
                 "Nordland_qImages.npy", ("npy", "Nordland_gt.npy")),
    "sped": ("SPED", "SPED_dbImages.npy", "SPED_qImages.npy",
             ("npy", "SPED_gt.npy")),
    "pitts30k_val": ("Pittsburgh", "pitts30k_val_dbImages.npy",
                     "pitts30k_val_qImages.npy",
                     ("npy", "pitts30k_val_gt.npy")),
    "pitts30k_test": ("Pittsburgh", "pitts30k_test_dbImages.npy",
                      "pitts30k_test_qImages.npy",
                      ("npy", "pitts30k_test_gt.npy")),
    "pitts250k_test": ("Pittsburgh", "pitts250k_test_dbImages.npy",
                       "pitts250k_test_qImages.npy",
                       ("npy", "pitts250k_test_gt.npy")),
    "amstertime": ("amstertime", "amstertime_dbImages.npy",
                   "amstertime_qImages.npy", ("utm", 25.0)),
    "st_lucia": ("st_lucia", "st_lucia_dbImages.npy",
                 "st_lucia_qImages.npy", ("utm", 25.0)),
    "tokyo247": ("tokyo247", "tokyo247_dbImages.npy",
                 "tokyo247_qImages.npy", ("utm", 25.0)),
    "sfsm": ("sfsm", "sfsm_dbImages.npy", "sfsm_qImages.npy",
             ("utm", 25.0)),
    "msls_test": ("msls_test", "msls_test_dbImages.npy",
                  "msls_test_qImages.npy", ("none",)),
}


@dataclasses.dataclass
class VladBuffValSet:
    name: str
    db_images: List[str]            # image paths relative to dataset root
    q_images: List[str]
    ground_truth: Optional[List[np.ndarray]]   # positives per query

    @property
    def num_references(self) -> int:
        return len(self.db_images)

    @property
    def num_queries(self) -> int:
        return len(self.q_images)

    @property
    def images(self) -> List[str]:
        """References then queries, the evaluation's descriptor order."""
        return list(self.db_images) + list(self.q_images)


def load_vladbuff_val(name: str,
                      gt_root: Optional[str] = None) -> VladBuffValSet:
    """One benchmark set's image lists and ground truth."""
    if name not in REGISTRY:
        raise KeyError(f"unknown benchmark {name!r}; known: "
                       f"{sorted(REGISTRY)}")
    gt_root = gt_root or DEFAULT_GT_ROOT
    subdir, db_npy, q_npy, gt_spec = REGISTRY[name]
    base = os.path.join(gt_root, subdir)
    db = [str(s) for s in np.load(os.path.join(base, db_npy),
                                  allow_pickle=True)]
    q = [str(s) for s in np.load(os.path.join(base, q_npy),
                                 allow_pickle=True)]
    mode = gt_spec[0]
    if mode == "npy":
        gt_path = os.path.join(base, gt_spec[1])
        if not os.path.exists(gt_path):
            raise FileNotFoundError(
                f"{name} ground truth not found: {gt_path} (the VLAD-BuFF "
                "gt npy files go into the gt root; only 'none'-mode sets "
                "have no ground truth)")
        gt = list(np.load(gt_path, allow_pickle=True))
    elif mode == "utm":
        gt = radius_positives(utm_from_paths(db), utm_from_paths(q),
                              gt_spec[1])
    elif mode == "none":
        gt = None
    else:
        raise ValueError(mode)
    return VladBuffValSet(name, db, q, gt)


def load_msls_val(gt_root: Optional[str] = None,
                  npy_dir: str = "msls_val") -> VladBuffValSet:
    """MSLS val from SALAD's qIdx / pIdx npy files (MapillaryDataset.py):
    the indexed query images and each one's positive db indices."""
    gt_root = gt_root or DEFAULT_GT_ROOT
    base = os.path.join(gt_root, npy_dir)
    q = [str(s) for s in np.load(os.path.join(base, "msls_val_qImages.npy"),
                                 allow_pickle=True)]
    q_idx = np.load(os.path.join(base, "msls_val_qIdx.npy"))
    p_idx = np.load(os.path.join(base, "msls_val_pIdx.npy"),
                    allow_pickle=True)
    db_path = os.path.join(base, "msls_val_dbImages.npy")
    if not os.path.exists(db_path):
        raise FileNotFoundError(
            f"msls_val database list not found: {db_path} (the ground "
            "truth indexes its positions; msls_val_dbImages.npy goes "
            "beside qIdx / pIdx / qImages)")
    db = [str(s) for s in np.load(db_path, allow_pickle=True)]
    queries = [q[i] for i in q_idx]
    gt = [np.asarray(p, dtype=np.int64) for p in p_idx]
    return VladBuffValSet("msls_val", db, queries, gt)
