"""Dataset image listing in natural sort order (counterpart of
``revisit_anything_tpu/datasets/images.py``)."""

from __future__ import annotations

import os
from typing import List, Tuple

from revisit_anything_tpu_torch.config import DatasetConfig
from revisit_anything_tpu_torch.io.h5io import natsorted_keys

# the training loader's GSV-Cities directory scan (not gt-indexed, so a
# whitelist is safe there); the gt-indexed list_images is unfiltered
IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".tif",
              ".tiff", ".webp", ".ppm")


def list_images(directory: str) -> List[str]:
    """Every regular file of ``directory``, natural-sorted and unfiltered
    (the reference's ``natsorted(os.listdir())``,
    place_rec_SAM_DINO.py:114): ground-truth positives index this full
    listing, so a filter would shift every later index."""
    names = [f for f in os.listdir(directory)
             if not os.path.isdir(os.path.join(directory, f))]
    return [os.path.join(directory, f) for f in natsorted_keys(names)]


def list_dataset_images(ds: DatasetConfig,
                        data_root: str) -> Tuple[List[str], List[str]]:
    """(reference paths, query paths) of a dataset, natural-sorted."""
    ref_dir = os.path.join(data_root, ds.name, ds.data_subpath_ref)
    q_dir = os.path.join(data_root, ds.name, ds.data_subpath_query)
    return list_images(ref_dir), list_images(q_dir)
