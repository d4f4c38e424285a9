"""Tartan GNSS aerial dataset (counterpart of
``revisit_anything_tpu/datasets/aerial.py``; the reference's
dataloaders/aerial_dataloader.py:63-162): four named variants map onto
folder names; reference and query images are natural-sorted listings of
``reference_images`` / ``query_images``; ``gt_matches.csv``'s columns
top_1_ref_ind..top_5_ref_ind give each query's five soft positives.
"""

from __future__ import annotations

import csv
import dataclasses
import os
from typing import List

from revisit_anything_tpu_torch.io.h5io import natsorted_keys

VARIANTS = {
    "Tartan_GNSS_rotated": "gnss_train_rotated",
    "Tartan_GNSS_notrotated": "gnss_train_notrotated",
    "Tartan_GNSS_test_notrotated": "test_40_midref_rot0",
    "Tartan_GNSS_test_rotated": "test_40_midref_rot90",
}


@dataclasses.dataclass
class AerialDataset:
    db_paths: List[str]
    query_paths: List[str]
    soft_positives_per_query: List[List[int]]

    @property
    def database_num(self) -> int:
        return len(self.db_paths)

    @property
    def queries_num(self) -> int:
        return len(self.query_paths)

    def get_image_paths(self) -> List[str]:
        return list(self.db_paths) + list(self.query_paths)

    def get_positives(self) -> List[List[int]]:
        return self.soft_positives_per_query

    @classmethod
    def from_root(cls, datasets_folder: str,
                  dataset_name: str = "Tartan_GNSS_rotated"
                  ) -> "AerialDataset":
        if dataset_name not in VARIANTS:
            raise NotImplementedError(f"Dataset: {dataset_name}")
        root = os.path.join(datasets_folder, VARIANTS[dataset_name])
        db_dir = os.path.join(root, "reference_images")
        q_dir = os.path.join(root, "query_images")
        db = [os.path.join(db_dir, p)
              for p in natsorted_keys(os.listdir(db_dir))]
        q = [os.path.join(q_dir, p)
             for p in natsorted_keys(os.listdir(q_dir))]
        positives: List[List[int]] = []
        with open(os.path.join(root, "gt_matches.csv")) as f:
            for row in csv.DictReader(f):
                positives.append([int(row[f"top_{k}_ref_ind"])
                                  for k in range(1, 6)])
        return cls(db, q, positives)
