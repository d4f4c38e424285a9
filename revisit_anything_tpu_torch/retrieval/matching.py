"""Segment matches → image predictions (rank fusion).

Counterpart of ``revisit_anything_tpu/retrieval/matching.py``. The
production method, ``max_seg_topk_wt_borda_Im``: per query image, the
similarities are min-max normalized (over the whole sims matrix), each
matched database segment adds its normalized similarity to its database
image's bin (weighted Borda count), and the top-n images are predicted.

- :func:`weighted_borda_predict` (:242): one scatter-add over (query
  image × database image) bins and a ranking, on the tensors' device.
- :func:`get_matches_host` (:112) with its helpers (:28-110) and
  :func:`get_matches_for_single_image_pair`: the per-query host
  reference of every fusion method, numpy copies of the JAX package's.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch


def first_k_unique(values: Sequence[int], k: int) -> List[int]:
    """First K unique values, order-preserving (func_vpr.py:50-59)."""
    seen = set()
    out = []
    for v in values:
        if v not in seen:
            seen.add(v)
            out.append(v)
            if len(out) == k:
                break
    return out


def _weighted_borda_rank(pairs) -> List[int]:
    """Indices sorted by accumulated score, desc; insertion-order tie-break
    (func_vpr.py:61-77 dict semantics)."""
    scores = {}
    for index, score in pairs:
        scores[index] = scores.get(index, 0.0) + score
    return sorted(scores.keys(), key=lambda i: scores[i], reverse=True)


# The reference calls merge_ranked_lists / average_rank_method /
# average_similarity_scores (func_vpr.py:128,137,173,191,200,236) but never
# defines them anywhere in the tree — those get_matches branches raise
# NameError if exercised. We implement the standard rank-fusion semantics
# the names and call sites imply, keeping the surrounding branch structure
# (per-rank column lists, bincount tails) identical to the reference.

def merge_ranked_lists(*ranked_lists) -> List[int]:
    """Classic Borda-count merge: item at rank r in a list of length L
    scores L - r; items absent from a list score 0 there. Sorted by total
    score desc, insertion-order tie-break."""
    scores = {}
    for lst in ranked_lists:
        n = len(lst)
        for r, idx in enumerate(lst):
            idx = int(idx)
            scores[idx] = scores.get(idx, 0) + (n - r)
    return sorted(scores.keys(), key=lambda i: scores[i], reverse=True)


def average_rank_method(*ranked_lists) -> List[int]:
    """Mean-rank merge: items sorted by their average 0-based rank over the
    lists they appear in, ascending (best rank first)."""
    rank_sum = {}
    count = {}
    for lst in ranked_lists:
        for r, idx in enumerate(lst):
            idx = int(idx)
            rank_sum[idx] = rank_sum.get(idx, 0) + r
            count[idx] = count.get(idx, 0) + 1
    return sorted(rank_sum.keys(), key=lambda i: rank_sum[i] / count[i])


def average_similarity_scores(*ranked_lists_with_scores) -> List[int]:
    """Like weighted_borda_count but averaging an item's scores over its
    appearances instead of summing; sorted desc."""
    score_sum = {}
    count = {}
    for lst in ranked_lists_with_scores:
        for idx, score in lst:
            idx = int(idx)
            score_sum[idx] = score_sum.get(idx, 0.0) + score
            count[idx] = count.get(idx, 0) + 1
    return sorted(score_sum.keys(),
                  key=lambda i: score_sum[i] / count[i], reverse=True)


def _bincount_top(seg_ids: np.ndarray, im_inds_ref: np.ndarray,
                  n: int) -> np.ndarray:
    """The shared get_matches tail: bincount matched segments' image ids,
    return the top-n images by vote count (func_vpr.py:129-131 pattern:
    ``segIdx[flip(argsort(bincount[segIdx])[-n:])]``).

    kind="stable" like every other method here: the reference's default
    introsort leaves vote TIES in an unspecifiable order, so exact tie
    parity is impossible — a deterministic stable order is the
    documented deviation (README known deviations)."""
    counts = np.bincount(im_inds_ref[np.asarray(seg_ids, dtype=np.int64)])
    nonzero = np.where(counts > 0)[0]
    return nonzero[np.flip(np.argsort(counts[nonzero], kind="stable")[-n:])]


def get_matches_host(matches: np.ndarray,
                     sims: np.ndarray,
                     seg_range_query: Sequence[np.ndarray],
                     im_inds_ref: np.ndarray,
                     n: int = 5,
                     method: str = "max_seg_topk_wt_borda_Im"
                     ) -> List[np.ndarray]:
    """Host rank fusion over per-segment kNN results.

    Args:
      matches: [n_query_segs, R] database segment indices per query segment.
      sims: [n_query_segs, R] similarity scores (2 - L2², higher better).
      seg_range_query: per query image, the row indices of its segments.
      im_inds_ref: [n_db_segs] database image id per database segment.
      n: predictions per query image.
    """
    preds: List[np.ndarray] = []
    sims_max = float(np.max(sims))
    sims_min = float(np.min(sims))
    denom = (sims_max - sims_min) or 1.0

    for rows in seg_range_query:
        m = matches[rows]            # [S, R]
        s = sims[rows]               # [S, R]
        if method == "max_sim":
            order = np.flip(np.argsort(s.ravel(), kind="stable")[-50:])
            pred = im_inds_ref[m.ravel()[order]]
            preds.append(np.array(first_k_unique(pred.tolist(), n)))
        elif method == "max_seg":
            # top-n db images by segment-vote count, rank-1 matches only
            # (func_vpr.py:91-100)
            counts = np.bincount(im_inds_ref[m[:, 0]])
            nonzero = np.where(counts > 0)[0]
            top = nonzero[np.flip(
                np.argsort(counts[nonzero], kind="stable")[-n:])]
            preds.append(top)
        elif method == "max_seg_sim":
            # top-6 by vote count, re-ranked by each image's best similarity
            # (func_vpr.py:102-120)
            counts = np.bincount(im_inds_ref[m[:, 0]])
            nonzero = np.where(counts > 0)[0]
            cand = nonzero[np.flip(
                np.argsort(counts[nonzero], kind="stable")[-6:])]
            best = [np.max(s[:, 0][im_inds_ref[m[:, 0]] == c])
                    for c in cand]
            preds.append(cand[np.flip(np.argsort(best, kind="stable"))][:n])
        elif method == "max_seg_topk":
            counts = np.bincount(im_inds_ref[m.ravel()])
            nonzero = np.where(counts > 0)[0]
            top = nonzero[np.flip(np.argsort(counts[nonzero], kind="stable")[-n:])]
            preds.append(top)
        elif method == "max_seg_topk_wt_borda_Im":
            norm_s = (s - sims_min) / denom
            # Rank-major iteration (transpose) matches the reference's
            # per-rank ranked-lists construction (func_vpr.py:207-224).
            pairs = []
            ids = im_inds_ref[m]
            for rank in range(m.shape[1]):
                pairs.extend(zip(ids[:, rank].tolist(),
                                 norm_s[:, rank].tolist()))
            ranked = _weighted_borda_rank(pairs)
            preds.append(np.array(ranked[:n]))
        elif method == "max_seg_topk_wt_borda":
            # weighted Borda over SEGMENT ids, then top-n images by vote
            # count of the ranked segments (func_vpr.py:145-161)
            norm_s = (s - sims_min) / denom
            pairs = []
            for rank in range(m.shape[1]):
                pairs.extend(zip(m[:, rank].tolist(),
                                 norm_s[:, rank].tolist()))
            ranked = _weighted_borda_rank(pairs)
            preds.append(_bincount_top(ranked, im_inds_ref, n))
        elif method == "max_seg_topk_borda":
            # per-rank segment columns merged by Borda count, bincount tail
            # (func_vpr.py:126-134)
            ranked = merge_ranked_lists(*m.T.tolist())
            preds.append(_bincount_top(ranked, im_inds_ref, n))
        elif method == "max_seg_topk_avg":
            # mean-rank merge of segment columns (func_vpr.py:135-143)
            ranked = average_rank_method(*m.T.tolist())
            preds.append(_bincount_top(ranked, im_inds_ref, n))
        elif method == "max_seg_topk_avg_sim":
            # average normalized similarity per segment (func_vpr.py:162-178)
            norm_s = (s - sims_min) / denom
            pair_lists = [list(zip(m[:, r].tolist(), norm_s[:, r].tolist()))
                          for r in range(m.shape[1])]
            ranked = average_similarity_scores(*pair_lists)
            preds.append(_bincount_top(ranked, im_inds_ref, n))
        elif method == "max_seg_topk_borda_Im":
            # Borda merge directly over per-rank IMAGE-id columns
            # (func_vpr.py:190-198)
            ranked = merge_ranked_lists(*[im_inds_ref[m[:, r]].tolist()
                                          for r in range(m.shape[1])])
            preds.append(np.array(ranked[:n]))
        elif method == "max_seg_topk_avg_Im":
            # mean-rank merge over image-id columns (func_vpr.py:199-207)
            ranked = average_rank_method(*[im_inds_ref[m[:, r]].tolist()
                                           for r in range(m.shape[1])])
            preds.append(np.array(ranked[:n]))
        elif method == "max_seg_topk_avg_sim_Im":
            # average normalized similarity per image (func_vpr.py:225-243)
            norm_s = (s - sims_min) / denom
            pair_lists = [list(zip(im_inds_ref[m[:, r]].tolist(),
                                   norm_s[:, r].tolist()))
                          for r in range(m.shape[1])]
            ranked = average_similarity_scores(*pair_lists)
            preds.append(np.array(ranked[:n]))
        else:
            raise NotImplementedError(f"method {method!r}")
    return preds


def get_matches_for_single_image_pair(matches: np.ndarray,
                                      sims: np.ndarray,
                                      seg_range_query,
                                      top: int = 50):
    """Single query/reference image-pair qualitative analysis
    (func_vpr.py:247-315, max_sim branch — the only live one there):
    the query's segment rows sorted by similarity desc, with the matched
    database segment ids in the same order.

    Returns (sorted_query_segment_indices, sorted_db_segment_indices).
    """
    rows = seg_range_query[0]
    order = np.flip(np.argsort(sims[rows].ravel())[-top:])
    seg_idx, rank_idx = np.unravel_index(order, sims[rows].shape)
    return seg_idx, matches[rows][seg_idx, rank_idx]


def weighted_borda_predict(sims: torch.Tensor, matches: torch.Tensor,
                           query_img_ids: torch.Tensor,
                           ref_img_ids: torch.Tensor,
                           num_query_images: int, num_ref_images: int,
                           n: int = 5) -> torch.Tensor:
    """The production fusion (max_seg_topk_wt_borda_Im) on the tensors'
    device.

    sims, matches [n_query_segs, R]: similarities (2 − L2²) and database
    segment ids; query_img_ids [n_query_segs]; ref_img_ids [n_db_segs].
    Returns [num_query_images, n] database image ids, best first: a query
    whose scores are all 0 (every sim equal to the global minimum) ranks
    by match count; never-matched images fill no rank (−1); a query image
    without segments predicts −1 throughout.

    Equal scores rank the lower image id first, as ``lax.top_k`` does (a
    stable sort: ``torch.topk`` promises no order among ties on the
    card). The bins sum in f64 and are then rounded to f32: on the card
    the scatter-add's order varies from run to run, which in f32 could
    move a sum by an ulp."""
    if num_query_images * num_ref_images >= 2 ** 31:
        raise ValueError(
            f"dense Borda bin space {num_query_images}x{num_ref_images} "
            "exceeds int32 indexing; use get_matches_host at this scale")
    sims = sims.float()
    s_min, s_max = sims.min(), sims.max()
    norm = (sims - s_min) / torch.clamp(s_max - s_min, min=1e-30)
    ref_ids = ref_img_ids.long()[matches.long()]
    flat_bins = (query_img_ids.long()[:, None] * num_ref_images
                 + ref_ids).reshape(-1)
    nbins = num_query_images * num_ref_images
    dev = sims.device
    scores = torch.zeros(nbins, dtype=torch.float64, device=dev).index_add_(
        0, flat_bins, norm.reshape(-1).double()).float()
    scores = scores.reshape(num_query_images, num_ref_images)
    counts = torch.zeros(nbins, device=dev).index_add_(
        0, flat_bins, torch.ones(flat_bins.shape[0], device=dev))
    counts = counts.reshape(num_query_images, num_ref_images)
    has_score = scores.amax(1, keepdim=True) > 0.0
    ranked = torch.where(has_score, scores, counts)
    ranked = torch.where(counts > 0.0, ranked,
                         torch.full_like(ranked, float("-inf")))
    vals, top = torch.sort(ranked, dim=1, descending=True, stable=True)
    k = min(n, num_ref_images)
    top = torch.where(torch.isneginf(vals[:, :k]), -1, top[:, :k])
    seg_counts = torch.zeros(num_query_images, device=dev).index_add_(
        0, query_img_ids.long(), torch.ones(sims.shape[0], device=dev))
    return torch.where((seg_counts > 0.0)[:, None], top, -1)
