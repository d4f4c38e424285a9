"""Retrieval and evaluation: segment banks → (PCA) → kNN → weighted Borda
→ Recall@K, and AnyLoc's whole-image branch.

Counterpart of ``revisit_anything_tpu/pipeline/evaluate.py``
(``RetrievalResult``, ``apply_pca_in_batches``, ``run_segloc_retrieval``,
``run_anyloc_retrieval``). ``run_segloc_retrieval``'s ``mesh`` (JAX
:64-96): with several devices the kNN's database rows are sharded over
them (``parallel.sharded_knn_l2``). Its stages go to
``utils.profiling.stage_timer()``: ``retrieval.pca``, ``retrieval.knn``,
``retrieval.vote``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from revisit_anything_tpu_torch.config import (BORDA_TOPK, KNN_TOPK,
                                               RECALL_TOPK)
from revisit_anything_tpu_torch.ops.knn import knn_l2
from revisit_anything_tpu_torch.ops.pca import PCAParams, pca_apply
from revisit_anything_tpu_torch.parallel import resolve_mesh, sharded_knn_l2
from revisit_anything_tpu_torch.pipeline.aggregate import SegmentBank
from revisit_anything_tpu_torch.retrieval.matching import (
    get_matches_host, weighted_borda_predict)
from revisit_anything_tpu_torch.retrieval.recall import (calc_recall,
                                                         calculate_map,
                                                         one_percent_recall)
from revisit_anything_tpu_torch.utils.profiling import stage_timer


@dataclasses.dataclass
class RetrievalResult:
    recalls: List[float]
    predictions: List[np.ndarray]
    matches: np.ndarray          # [n_query_segs, K] db segment ids
    sims: np.ndarray             # [n_query_segs, K] squared L2 (faiss conv.)
    map_value: Optional[float] = None
    # AnyLoc branch only: a hit within the top max(n_db/100, 1) neighbours
    one_percent_recall: Optional[float] = None


def _normalize_rows(x: np.ndarray) -> np.ndarray:
    """Row L2 normalization."""
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def apply_pca_in_batches(bank: SegmentBank, pca: PCAParams,
                         batch_rows: int = 50000) -> SegmentBank:
    """A segment bank projected on the PCA's device, ``batch_rows`` rows
    at a time."""
    dev = pca.mean.device
    out = []
    for s in range(0, len(bank.descriptors), batch_rows):
        rows = torch.as_tensor(bank.descriptors[s:s + batch_rows], device=dev)
        out.append(pca_apply(rows, pca).cpu().numpy())
    return SegmentBank(np.concatenate(out) if out else bank.descriptors,
                       bank.image_indices, num_images=bank.num_images)


def run_segloc_retrieval(db_bank: SegmentBank, query_bank: SegmentBank,
                         gt: Sequence[Sequence[int]],
                         pca: Optional[PCAParams] = None,
                         knn_topk: int = KNN_TOPK,
                         borda_topk: int = BORDA_TOPK,
                         recall_topk: int = RECALL_TOPK,
                         map_calculate: bool = False,
                         device_voting: bool = True,
                         device="cuda", mesh="auto") -> RetrievalResult:
    """SegLoc retrieval: kNN of the query segments over the database
    segments, weighted Borda voting over database images, Recall@1..k.

    With ``pca`` (on its own device) the descriptors are projected and
    row-normalized before the L2 search; raw VLADs are unit-norm already.
    ``device_voting``: the Borda sums on ``device``
    (:func:`weighted_borda_predict`), else the per-query host loop
    (:func:`get_matches_host`); the two predict the same images. Query
    images of ``gt`` without segments count as misses. ``mesh``: a mesh
    of several devices shards the kNN's database over them ("auto": every
    card, when ``device`` is one; None: ``device`` alone)."""
    timer = stage_timer()
    db = db_bank.descriptors
    q = query_bank.descriptors
    if pca is not None:
        with timer.stage("retrieval.pca"):
            db = apply_pca_in_batches(db_bank, pca).descriptors
            q = apply_pca_in_batches(query_bank, pca).descriptors
        db, q = _normalize_rows(db), _normalize_rows(q)

    mesh = resolve_mesh(mesh, device)
    with timer.stage("retrieval.knn"):
        if mesh is not None and mesh.size > 1:
            sq_l2, matches = sharded_knn_l2(q, db, knn_topk, mesh)
            sq_l2, matches = sq_l2.to(device), matches.to(device)
        else:
            sq_l2, matches = knn_l2(torch.as_tensor(q, device=device),
                                    torch.as_tensor(db, device=device),
                                    knn_topk)
        sims_dev = 2.0 - sq_l2[:, :borda_topk]
        m50_dev = matches[:, :borda_topk]
        sq_l2, matches = sq_l2.cpu().numpy(), matches.cpu().numpy()

    derived = (int(query_bank.image_indices.max()) + 1
               if len(query_bank.image_indices) else 0)
    n_q = max(len(gt), query_bank.num_images or 0, derived)
    with timer.stage("retrieval.vote"):
        if device_voting:
            n_r = int(db_bank.image_indices.max()) + 1
            preds_arr = weighted_borda_predict(
                sims_dev, m50_dev,
                torch.as_tensor(query_bank.image_indices, device=device),
                torch.as_tensor(db_bank.image_indices, device=device), n_q,
                n_r, n=recall_topk)
            preds = list(preds_arr.cpu().numpy())
        else:
            ranges = query_bank.seg_ranges
            ranges += [np.zeros((0,), np.int64)
                       for _ in range(n_q - len(ranges))]
            preds = get_matches_host(matches[:, :borda_topk],
                                     2.0 - sq_l2[:, :borda_topk], ranges,
                                     db_bank.image_indices, n=recall_topk,
                                     method="max_seg_topk_wt_borda_Im")
    recalls = calc_recall(preds, gt, recall_topk)
    map_value = calculate_map(preds, gt) if map_calculate else None
    return RetrievalResult(recalls, preds, matches, sq_l2, map_value)


def run_anyloc_retrieval(db_vlads: np.ndarray, query_vlads: np.ndarray,
                         gt: Sequence[Sequence[int]],
                         recall_topk: int = RECALL_TOPK,
                         device="cuda") -> RetrievalResult:
    """AnyLoc baseline: whole-image VLAD kNN, Recall@1..k and the
    reference's 1%-recall (the gt rows past the query count are never
    read)."""
    sq_l2, matches = knn_l2(torch.as_tensor(query_vlads, device=device),
                            torch.as_tensor(db_vlads, device=device),
                            recall_topk)
    matches = matches.cpu().numpy()
    preds = list(matches)
    recalls = calc_recall(preds, list(gt)[:len(preds)], recall_topk)
    one_pct = one_percent_recall(matches, gt, len(db_vlads), recall_topk)
    return RetrievalResult(recalls, preds, matches, sq_l2.cpu().numpy(),
                           one_percent_recall=one_pct)
