"""The VLAD-BuFF validation recalls (counterpart of
``revisit_anything_tpu/retrieval/analysis.py`` ``get_validation_recalls``
:65, on the port's ``ops.knn.knn_l2``). The rest of the JAX module
(triplets, margins, coverage, match grids) waits for the CLI and
analysis slice."""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from revisit_anything_tpu_torch.ops.knn import knn_l2


def get_validation_recalls(db_desc, query_desc, gt: Sequence[Sequence[int]],
                           k_values: Sequence[int] = (1, 5, 10, 15, 20, 25),
                           dataset_name: str = "",
                           print_results: bool = True,
                           device="cuda") -> Dict[int, float]:
    """Top-k L2 search of whole-image descriptors, Recall@k for each k.
    Tensors are searched where they lie, numpy arrays on ``device``.
    Queries with an empty gt stay in the denominator as misses."""
    def tensor(x):
        if isinstance(x, torch.Tensor):
            return x
        return torch.from_numpy(np.asarray(x, np.float32)).to(device)

    db = tensor(db_desc)
    queries = tensor(query_desc).to(db.device)
    kmax = max(k_values)
    _, idx = knn_l2(queries, db, min(kmax, len(db)))
    idx = idx.cpu().numpy()
    correct = np.zeros(len(k_values))
    for qi, gt_q in enumerate(gt[:len(idx)]):
        gt_set = set(int(g) for g in gt_q)
        hits = [int(p) in gt_set for p in idx[qi]]
        for ki, k in enumerate(k_values):
            if any(hits[:k]):
                correct[ki] += 1
    recalls = {k: float(c) / max(len(idx), 1)
               for k, c in zip(k_values, correct)}
    if print_results:
        row = " | ".join(f"R@{k}: {v * 100:.2f}" for k, v in recalls.items())
        print(f"[{dataset_name}] {row}")
    return recalls
