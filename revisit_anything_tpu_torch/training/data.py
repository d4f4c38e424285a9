"""Training data: GSV-Cities-style place sampling on the host.

Counterpart of ``revisit_anything_tpu/training/data.py``:
``discover_places`` (:28), ``discover_places_gsv`` (:46, the shipped CSV
layout), ``PlacesBatcher`` (:99) and ``prefetch`` (:143). Each batch is
``places_per_batch`` places of ``img_per_place`` views, labels the place
index, normalized by ``dinov2.preprocess``. The numpy ``default_rng``
draws are the JAX package's, so both give the same batches from the same
seed and loader. Images load with PIL and resize with cv2, both imported
in the loader.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Dict, Iterator, List, Tuple

import numpy as np

from revisit_anything_tpu_torch.datasets.images import IMAGE_EXTS
from revisit_anything_tpu_torch.models.dinov2 import preprocess


def discover_places(root: str, min_images: int = 4) -> Dict[str, List[str]]:
    """city/place_id/image layout → {"city/place": [image paths]}."""
    places: Dict[str, List[str]] = {}
    for city in sorted(os.listdir(root)):
        city_dir = os.path.join(root, city)
        if not os.path.isdir(city_dir):
            continue
        for place in sorted(os.listdir(city_dir)):
            pdir = os.path.join(city_dir, place)
            if not os.path.isdir(pdir):
                continue
            imgs = [os.path.join(pdir, f) for f in sorted(os.listdir(pdir))
                    if f.lower().endswith(IMAGE_EXTS)]
            if len(imgs) >= min_images:
                places[f"{city}/{place}"] = imgs
    return places


def discover_places_gsv(root: str, cities: List[str] = None,
                        min_img_per_place: int = 4) -> Dict[str, List[str]]:
    """GSV-Cities as shipped (``root/Dataframes/<City>.csv`` plus
    ``root/Images/<city_id>/``) → {zero-filled prefixed place id: [image
    paths]}, the reference loader's grouping: city ``i`` offsets its place
    ids by ``i·10⁵``, places with fewer than ``min_img_per_place`` images
    are dropped, and each filename is rebuilt from its row's fields as
    ``str()`` of the parsed value (pandas, imported here)."""
    import pandas as pd

    df_dir = os.path.join(root, "Dataframes")
    if cities is None:
        cities = sorted(os.path.splitext(f)[0] for f in os.listdir(df_dir)
                        if f.lower().endswith(".csv"))
    places: Dict[str, List[str]] = {}
    for ci, city in enumerate(cities):
        df = pd.read_csv(os.path.join(df_dir, f"{city}.csv"))
        for row in df.itertuples(index=False):
            pl_id = int(row.place_id)
            pid = pl_id + ci * 10 ** 5
            name = "_".join([
                str(row.city_id),
                str(pl_id % 10 ** 5).zfill(7),
                str(row.year).zfill(4),
                str(row.month).zfill(2),
                str(row.northdeg).zfill(3),
                str(row.lat), str(row.lon),
                str(row.panoid)]) + ".jpg"
            path = os.path.join(root, "Images", str(row.city_id), name)
            places.setdefault(str(pid).zfill(7), []).append(path)
    return {k: v for k, v in places.items()
            if len(v) >= min_img_per_place}


class PlacesBatcher:
    """Yields (images [B, H, W, 3] float32 normalized, labels [B] int32)
    with B = places_per_batch · img_per_place."""

    def __init__(self, places: Dict[str, List[str]],
                 image_hw: Tuple[int, int] = (224, 224),
                 places_per_batch: int = 16,
                 img_per_place: int = 4,
                 seed: int = 0,
                 loader=None):
        self.place_keys = sorted(places)
        self.places = places
        self.image_hw = image_hw
        self.places_per_batch = places_per_batch
        self.img_per_place = img_per_place
        self.rng = np.random.default_rng(seed)
        self._loader = loader or self._load_image

    def _load_image(self, path: str) -> np.ndarray:
        import cv2

        from revisit_anything_tpu_torch.pipeline.extract import (
            load_image_rgb)
        img = load_image_rgb(path)
        return cv2.resize(img, (self.image_hw[1], self.image_hw[0]),
                          interpolation=cv2.INTER_LINEAR)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        order = self.rng.permutation(len(self.place_keys))
        for s in range(0, len(order) - self.places_per_batch + 1,
                       self.places_per_batch):
            sel = order[s:s + self.places_per_batch]
            imgs, labels = [], []
            for li, pi in enumerate(sel):
                paths = self.places[self.place_keys[pi]]
                take = self.rng.choice(len(paths), self.img_per_place,
                                       replace=len(paths) <
                                       self.img_per_place)
                for t in take:
                    imgs.append(self._loader(paths[t]))
                    labels.append(li)
            batch = preprocess(np.stack(imgs), patch_multiple=True)
            yield batch, np.asarray(labels, np.int32)


def prefetch(iterator, depth: int = 2):
    """Run ``iterator`` on a thread ``depth`` items ahead, so image
    decoding overlaps the device's steps. A worker's exception (a corrupt
    image) is raised in the consumer."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    sentinel = object()

    def worker():
        try:
            for item in iterator:
                q.put(item)
            q.put(sentinel)
        except BaseException as e:           # noqa: BLE001 — re-raised
            q.put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is sentinel:
            return
        if isinstance(item, BaseException):
            raise item
        yield item
