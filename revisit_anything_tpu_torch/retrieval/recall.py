"""Recall@K, mAP and 1%-recall (counterpart of
``revisit_anything_tpu/retrieval/recall.py``: ``calc_recall``,
``calculate_map``, ``one_percent_recall`` as numpy copies, and
``top_k_recall`` over the port's kNN)."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from revisit_anything_tpu_torch.ops.knn import knn_inner_product, knn_l2


def calc_recall(preds: Sequence[Sequence[int]],
                gt: Sequence[Sequence[int]],
                n: int) -> List[float]:
    """Cumulative first-hit Recall@1..n over queries with non-empty gt,
    exactly mirroring func_vpr.py:396-422."""
    if len(preds) < len(gt):
        # the reference indexes pred[i] over range(len(gt)) and would
        # IndexError; a silent zip-truncation here would shrink the
        # denominator and inflate recall (each query needs a prediction
        # row, empty or not)
        raise ValueError(
            f"preds covers {len(preds)} queries but gt has {len(gt)}")
    hits = [0] * n
    num_eval = 0
    for pred_i, gt_i in zip(preds, gt):
        if len(gt_i) == 0:
            continue
        num_eval += 1
        gt_set = set(int(g) for g in gt_i)
        for j, p in enumerate(pred_i[:n]):
            if int(p) in gt_set:
                hits[j] += 1
                break
    if num_eval == 0:
        return [0.0] * n
    return (np.cumsum(hits) / float(num_eval)).tolist()


def calculate_map(preds: Sequence[Sequence[int]],
                  gt: Sequence[Sequence[int]]) -> float:
    """Mean average precision over queries (func_vpr.py:360-392).

    Empty-gt queries contribute AP=0 and stay in the denominator —
    the reference averages `calculate_ap` over ALL queries
    (func_vpr.py:391-392)."""
    ap_sum = 0.0
    num_eval = 0
    for pred_i, gt_i in zip(preds, gt):
        num_eval += 1
        gt_set = set(int(g) for g in gt_i)
        hits = 0
        precision_sum = 0.0
        for rank, p in enumerate(pred_i, start=1):
            if int(p) in gt_set:
                hits += 1
                precision_sum += hits / rank
        ap_sum += precision_sum / hits if hits else 0.0
    return ap_sum / max(1, num_eval)


def one_percent_recall(retrieved: np.ndarray,
                       gt: Sequence[Sequence[int]],
                       n_db: int,
                       k: int) -> float:
    """1%-recall: hit within the top max(round(n_db/100), 1) retrievals,
    capped at the k neighbors actually retrieved; empty-gt queries are
    skipped (func_vpr.py get_recall :852,855-878). Shared by
    ``top_k_recall`` and ``pipeline.evaluate.run_anyloc_retrieval``."""
    threshold = min(max(int(round(n_db / 100.0)), 1), k)
    hits, num_eval = 0, 0
    for qi, gt_q in enumerate(list(gt)[:len(retrieved)]):
        if len(gt_q) == 0:
            continue
        num_eval += 1
        if set(int(r) for r in retrieved[qi][:threshold]) \
                & set(int(g) for g in gt_q):
            hits += 1
    return hits / max(num_eval, 1)


def top_k_recall(db_desc: torch.Tensor, query_desc: torch.Tensor,
                 gt: Sequence[Sequence[int]], k: int = 5,
                 metric: str = "l2", return_one_percent: bool = False,
                 sub_sample_db: int = 1, sub_sample_qu: int = 1,
                 norm_descs: bool = True) -> Tuple[List[float], np.ndarray]:
    """Image-level Recall@1..k by kNN over whole-image descriptors on the
    tensors' device ("l2" or inner product), both sides L2-normalized
    first by default.

    Recall@K divides by all queries (empty-gt queries are misses); the
    1%-recall skips them. With ``[::stride]`` sub-sampled descriptors and
    a ``gt`` over the full sets, retrieved ids are scaled by
    ``sub_sample_db`` and query i reads ``gt[i * sub_sample_qu]``; the
    returned indices stay in the sub-sampled database.

    Returns (recalls, indices [Nq, k]), and the 1%-recall with
    ``return_one_percent``."""
    if norm_descs:
        db_desc = db_desc / torch.linalg.vector_norm(
            db_desc, dim=-1, keepdim=True).clamp(min=1e-12)
        query_desc = query_desc / torch.linalg.vector_norm(
            query_desc, dim=-1, keepdim=True).clamp(min=1e-12)
    search = knn_l2 if metric == "l2" else knn_inner_product
    idx = search(query_desc, db_desc, k)[1].cpu().numpy()
    gt_eval = [gt[i * sub_sample_qu] for i in range(len(idx))]
    scaled = idx * sub_sample_db
    recalls = calc_recall([row.tolist() for row in scaled], gt_eval, k)
    # calc_recall divides by the queries with a gt: rescale to all
    num_eval = sum(1 for g in gt_eval if len(g) > 0)
    if len(idx):
        recalls = [r * num_eval / len(idx) for r in recalls]
    if not return_one_percent:
        return recalls, idx
    pct = one_percent_recall(scaled, gt_eval, int(db_desc.shape[0]), k)
    return recalls, idx, pct
