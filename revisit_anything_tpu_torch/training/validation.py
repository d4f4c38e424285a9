"""In-training validation: held-out reference/query recalls.

Counterpart of ``revisit_anything_tpu/training/validation.py``:
``ValidationSet`` with ``from_directory`` (``ref/``, ``query/``,
``gt.npy``) and ``run_validation`` (:81), which returns Recall@1/5/10
through ``retrieval.analysis.get_validation_recalls``. Descriptors are
the whole model's (``train.model_forward``), references then queries,
images resized with the reference's cv2 bilinear (the port's exact
copy) and normalized by ``dinov2.preprocess``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class ValidationSet:
    """One held-out set: reference images, query images, and each
    query's positive reference indices."""
    name: str
    ref_paths: List[str]
    query_paths: List[str]
    gt: List[Sequence[int]]
    image_hw: Tuple[int, int] = (224, 224)

    @classmethod
    def from_directory(cls, root: str,
                       image_hw: Tuple[int, int] = (224, 224),
                       name: Optional[str] = None) -> "ValidationSet":
        """Layout: <root>/ref/*.{jpg,png}, <root>/query/*.{jpg,png},
        <root>/gt.npy (object array: positive ref indices per query;
        unpickled, so only sets this pipeline wrote)."""
        def listdir(sub):
            d = os.path.join(root, sub)
            return [os.path.join(d, f) for f in sorted(os.listdir(d))
                    if f.lower().endswith((".jpg", ".jpeg", ".png"))]
        gt = np.load(os.path.join(root, "gt.npy"), allow_pickle=True)
        return cls(name=name or os.path.basename(os.path.abspath(root)),
                   ref_paths=listdir("ref"), query_paths=listdir("query"),
                   gt=[list(map(int, g)) for g in gt], image_hw=image_hw)


def _descriptors(model, cfg, paths: Sequence[str],
                 image_hw: Tuple[int, int], batch_size: int) -> torch.Tensor:
    from revisit_anything_tpu_torch.models import dinov2 as dn
    from revisit_anything_tpu_torch.pipeline.extract import (
        _resize_cv2_bilinear, load_image_rgb)
    from revisit_anything_tpu_torch.training.train import model_forward
    dev = next(model.parameters()).device
    out = []
    for s in range(0, len(paths), batch_size):
        imgs = np.stack([
            _resize_cv2_bilinear(load_image_rgb(p),
                                 (image_hw[1], image_hw[0]))
            for p in paths[s:s + batch_size]])
        x = torch.from_numpy(dn.preprocess(imgs)).to(dev)
        with torch.no_grad():
            out.append(model_forward(model, cfg, x))
    return torch.cat(out) if out else torch.zeros((0, 1), device=dev)


def run_validation(model, cfg, val_set: ValidationSet,
                   k_values: Sequence[int] = (1, 5, 10),
                   batch_size: int = 16,
                   print_results: bool = True) -> Dict[int, float]:
    """Whole-model descriptors of the references, then of the queries,
    and their kNN recalls at ``k_values``, on the model's device."""
    from revisit_anything_tpu_torch.retrieval.analysis import (
        get_validation_recalls)
    refs = _descriptors(model, cfg, val_set.ref_paths, val_set.image_hw,
                        batch_size)
    queries = _descriptors(model, cfg, val_set.query_paths,
                           val_set.image_hw, batch_size)
    return get_validation_recalls(refs, queries, val_set.gt,
                                  k_values=k_values,
                                  dataset_name=val_set.name,
                                  print_results=print_results)
