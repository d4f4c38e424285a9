"""HDF5 artifacts in the JAX package's (and the reference's) schema
(counterpart of ``revisit_anything_tpu/io/h5io.py``).

Mask files:
    <image_key>/masks/<j>/segmentation   bool [h, w]
    <image_key>/masks/<j>/area           scalar
    <image_key>/masks/<j>/bbox           [4] XYWH
    <image_key>/masks/<j>/predicted_iou  scalar
    <image_key>/masks/<j>/point_coords   [1, 2]
    <image_key>/masks/<j>/stability_score scalar
    <image_key>/masks/<j>/crop_box       [4]

Dense-feature files:
    <image_key>/ift_dino                 float32 [1, D, dh, dw]

Writes use plain ``str(j)`` mask keys; reads natural-sort them (h5py
iterates lexicographically). ``h5py`` is imported only by
:func:`open_h5`, the one place this package opens a file, so the package
imports where ``h5py`` is not installed; there the stages that read or
write h5 files raise ``ImportError`` and the per-image functions still
run.
"""

from __future__ import annotations

import dataclasses
import re
from typing import List, Sequence

import numpy as np


@dataclasses.dataclass
class MaskRecord:
    """One automatic-mask-generator output record."""
    segmentation: np.ndarray          # bool [h, w]
    area: int
    bbox: Sequence[float]             # XYWH
    predicted_iou: float
    point_coords: np.ndarray          # [1, 2]
    stability_score: float
    crop_box: Sequence[float]         # XYWH


def open_h5(path: str, mode: str = "r"):
    """``h5py.File(path, mode)``; a clear ImportError without h5py."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError(f"reading or writing the h5 artifact {path!r} "
                          "needs the h5py package") from e
    return h5py.File(path, mode)


_NUM_RE = re.compile(r"(\d+)")


def _natural_key(s: str):
    return [int(p) if p.isdigit() else p for p in _NUM_RE.split(s)]


def natsorted_keys(keys) -> List[str]:
    return sorted(keys, key=_natural_key)


def list_image_keys(h5) -> List[str]:
    """Image keys in natural order ('img_2' before 'img_10'), the order of
    the ground-truth rows."""
    return natsorted_keys(h5.keys())


def read_image_masks(h5, image_key: str, min_area: int = 0,
                     segmentation_only: bool = False) -> List[MaskRecord]:
    """All masks of one image in natural key order; ``min_area`` drops
    masks of area ≤ it. Files with only ``segmentation`` (FastSAM-style)
    take the area from it and zeros for the other fields."""
    group = h5[f"{image_key}/masks"]
    records: List[MaskRecord] = []
    for k in natsorted_keys(group.keys()):
        g = group[k]
        seg = None
        if "area" in g:
            area = int(g["area"][()])
        else:
            seg = g["segmentation"][()].astype(bool)
            area = int(seg.sum())
        if min_area and area <= min_area:
            continue
        if seg is None:
            seg = g["segmentation"][()].astype(bool)
        if segmentation_only:
            records.append(MaskRecord(seg, area, (0, 0, 0, 0), 0.0,
                                      np.zeros((1, 2)), 0.0, (0, 0, 0, 0)))
            continue

        def field(name, default, conv):
            return conv(g[name][()]) if name in g else default

        records.append(MaskRecord(
            segmentation=seg, area=area,
            bbox=field("bbox", (0, 0, 0, 0),
                       lambda v: tuple(np.asarray(v).tolist())),
            predicted_iou=field("predicted_iou", 0.0, float),
            point_coords=field("point_coords", np.zeros((1, 2)), np.asarray),
            stability_score=field("stability_score", 0.0, float),
            crop_box=field("crop_box", (0, 0, 0, 0),
                           lambda v: tuple(np.asarray(v).tolist()))))
    return records


def write_image_masks(h5, image_key: str,
                      records: Sequence[MaskRecord]) -> None:
    """Write records under <image_key>/masks/<j>/<field>."""
    base = h5.require_group(image_key).require_group("masks")
    for j, rec in enumerate(records):
        g = base.require_group(str(j))
        g.create_dataset("segmentation", data=rec.segmentation.astype(bool),
                         compression="gzip")
        g.create_dataset("area", data=rec.area)
        g.create_dataset("bbox", data=np.asarray(rec.bbox))
        g.create_dataset("predicted_iou", data=rec.predicted_iou)
        g.create_dataset("point_coords", data=np.asarray(rec.point_coords))
        g.create_dataset("stability_score", data=rec.stability_score)
        g.create_dataset("crop_box", data=np.asarray(rec.crop_box))


def read_dino_features(h5, image_key: str) -> np.ndarray:
    """Dense features [1, D, dh, dw] float32 of one image."""
    return h5[image_key]["ift_dino"][()]


def write_dino_features(h5, image_key: str, features: np.ndarray) -> None:
    """Write [1, D, dh, dw] float32 under <image_key>/ift_dino."""
    g = h5.require_group(image_key)
    g.create_dataset("ift_dino", data=np.asarray(features, dtype=np.float32))


def read_all_masks_bool(h5, image_key: str) -> np.ndarray:
    """Stacked bool [M, h, w] segmentations of one image ([0, 1, 1] for
    none)."""
    recs = read_image_masks(h5, image_key, segmentation_only=True)
    if not recs:
        return np.zeros((0, 1, 1), dtype=bool)
    return np.stack([r.segmentation for r in recs])


def count_masks(h5) -> int:
    """Mask count over all images of a file."""
    total = 0
    for key in h5.keys():
        grp = h5[key]
        if "masks" in grp:
            total += len(grp["masks"].keys())
    return total
