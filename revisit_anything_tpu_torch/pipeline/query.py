"""Retrieval tail of one query: dense features + masks → segment VLAD →
PCA → row-normalized rows → kNN (one-shot below a score-matrix cap,
streaming tiles above it) → weighted Borda → top image ids.

Counterpart of ``revisit_anything_tpu/pipeline/query.py``
(``query_segment_rows`` :56, ``query_topk_images`` :82, ``pca_tuple``
:199, ``DB_GUARD``), and ``query_topk_images_sharded``: the same answer
from a database split over a mesh's devices (the JAX package's jit
propagates the database's sharding through the same function).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from revisit_anything_tpu_torch.config import (BORDA_TOPK, KNN_TOPK,
                                               RECALL_TOPK)
from revisit_anything_tpu_torch.ops.knn import DB_TILE, _knn_scores, dot_f32
from revisit_anything_tpu_torch.ops.vlad import l2_normalize, segment_vlad
from revisit_anything_tpu_torch.parallel import merge_candidates

# Magnitude of database guard rows (padding, removed entries): their kNN
# score q·d − ||d||²/2 is hugely negative, so they never surface, and
# their sims fall far below the [−2, 2] range of row-normalized vectors.
DB_GUARD = 1e6


def _segment_rows(desc, patch_masks, adjacency, centers, pca_mean,
                  pca_components, pca_variance,
                  whiten: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """PCA-projected, row-normalized segment descriptors [M, dim] and
    validity flags [M] (a row is valid if its mask has any patch)."""
    flat = segment_vlad(desc, centers, patch_masks, adjacency)
    proj = (flat - pca_mean) @ pca_components.T
    if whiten:
        proj = proj / torch.sqrt(pca_variance)
    proj = l2_normalize(proj, -1)
    return proj, patch_masks.any(1)


def query_segment_rows(desc, patch_masks, adjacency, centers, pca_mean,
                       pca_components, pca_variance, whiten: bool = True,
                       guard_value: float = DB_GUARD):
    """Database-insertable rows for ONE image: invalid (padding) rows are
    replaced by guard vectors. Returns (rows [M, dim] f32, valid [M])."""
    proj, valid = _segment_rows(desc, patch_masks, adjacency, centers,
                                pca_mean, pca_components, pca_variance,
                                whiten)
    rows = torch.where(valid[:, None], proj,
                       torch.full_like(proj, guard_value))
    return rows, valid


def db_sq_norms(db: torch.Tensor) -> torch.Tensor:
    """[Nd] f32 squared row norms (guard rows get huge norms), computed
    65,536 rows at a time so a bf16 database never has a whole f32
    copy."""
    chunk = 65536
    out = torch.empty(db.shape[0], device=db.device)
    for start in range(0, db.shape[0], chunk):
        rows = db[start:start + chunk].float()
        out[start:start + chunk] = (rows * rows).sum(1)
    return out


def _knn_topk(proj: torch.Tensor, db: torch.Tensor, norms: torch.Tensor,
              k: int, db_tile: int, oneshot_cap_bytes: int):
    """The top-``k`` scores q·d − ‖d‖²/2 of each row of ``proj`` over
    ``db`` and their rows: one [M, Nd] f32 score matrix while it fits
    ``oneshot_cap_bytes``, else the streaming merge over ``db_tile``-row
    tiles."""
    nd = db.shape[0]
    if proj.shape[0] * nd * 4 <= oneshot_cap_bytes:
        s = dot_f32(proj, db)
        return torch.topk(s.sub_(0.5 * norms[None, :]), k, dim=1)
    return _knn_scores(proj, db, norms, k, min(db_tile, max(128, nd)))


def _vote(proj: torch.Tensor, valid: torch.Tensor, scores: torch.Tensor,
          ref_ids: torch.Tensor, num_ref_images: int,
          top_images: int) -> torch.Tensor:
    """Weighted Borda over the matches (``scores`` [M, k], their image ids
    ``ref_ids`` [M, k]) → the top image ids, −1 for unfilled ranks."""
    q_norms = (proj * proj).sum(1, keepdim=True)
    sims = 2.0 - (q_norms - 2.0 * scores)
    # guard hits (sims < −4) and invalid query rows stay out of the
    # min-max normalization and vote zero
    real = (sims > -4.0) & valid[:, None]
    inf = sims.new_full((), float("inf"))
    s_min = torch.where(real, sims, inf).min()
    s_max = torch.where(real, sims, -inf).max()
    norm_s = (sims - s_min) / torch.clamp(s_max - s_min, min=1e-30)
    norm_s = torch.where(real, norm_s, torch.zeros_like(norm_s))
    ref_ids = ref_ids.reshape(-1).long()
    votes = torch.zeros(num_ref_images, device=sims.device).index_add_(
        0, ref_ids, norm_s.reshape(-1))
    cnt = torch.zeros(num_ref_images, device=sims.device).index_add_(
        0, ref_ids, real.float().reshape(-1))
    # never-matched bins must not fill the ranking
    ranked = torch.where(cnt > 0, votes, -inf)
    vals, top = torch.topk(ranked, min(top_images, num_ref_images))
    return torch.where(torch.isneginf(vals), torch.full_like(top, -1), top)


def query_topk_images(desc: torch.Tensor, patch_masks: torch.Tensor,
                      adjacency: Optional[torch.Tensor],
                      centers: torch.Tensor, pca_mean: torch.Tensor,
                      pca_components: torch.Tensor,
                      pca_variance: torch.Tensor, db: torch.Tensor,
                      db_image_ids: torch.Tensor, num_ref_images: int,
                      knn_topk: int = KNN_TOPK, borda_topk: int = BORDA_TOPK,
                      top_images: int = RECALL_TOPK, db_tile: int = DB_TILE,
                      whiten: bool = True,
                      db_norms: Optional[torch.Tensor] = None,
                      oneshot_cap_bytes: int = 256 * 1024 * 1024
                      ) -> torch.Tensor:
    """One query image → its top database image ids (−1 for ranks no
    image fills).

    desc [P, D] L2-normalized patch descriptors; patch_masks [M, P] bool
    (padding rows all-false); adjacency [M, M] bool or None; db [Nd, dim]
    row-normalized database segments (f32 or bf16) with image ids
    db_image_ids [Nd]; db_norms optional precomputed [Nd] squared norms.
    The vote reads the top min(knn_topk, borda_topk) matches of each
    segment: from one [M, Nd] f32 score matrix while it fits
    ``oneshot_cap_bytes``, else from a streaming merge over ``db_tile``-row
    tiles (``ops.knn._knn_scores``; ``ops.knn.DB_TILE`` gives the
    tile's measurement)."""
    proj, valid = _segment_rows(desc, patch_masks, adjacency, centers,
                                pca_mean, pca_components, pca_variance,
                                whiten)
    k = min(knn_topk, borda_topk, db.shape[0])
    norms = db_norms.float() if db_norms is not None else db_sq_norms(db)
    scores, idx = _knn_topk(proj, db, norms, k, db_tile, oneshot_cap_bytes)
    return _vote(proj, valid, scores, db_image_ids[idx], num_ref_images,
                 top_images)


def query_topk_images_sharded(desc: torch.Tensor, patch_masks: torch.Tensor,
                              adjacency: Optional[torch.Tensor],
                              centers: torch.Tensor, pca_mean: torch.Tensor,
                              pca_components: torch.Tensor,
                              pca_variance: torch.Tensor,
                              shards: Sequence[Tuple[torch.Tensor,
                                                     torch.Tensor,
                                                     torch.Tensor]],
                              num_rows: int, num_ref_images: int,
                              knn_topk: int = KNN_TOPK,
                              borda_topk: int = BORDA_TOPK,
                              top_images: int = RECALL_TOPK,
                              db_tile: int = DB_TILE, whiten: bool = True,
                              oneshot_cap_bytes: int = 256 * 1024 * 1024
                              ) -> torch.Tensor:
    """:func:`query_topk_images` over a database whose rows are split into
    ``shards`` (db, image ids, squared norms), each on its own device:
    every shard's top matches by the same kNN, merged on the query's
    device by ``parallel.merge_candidates`` (stable: equal scores keep
    shard order), then the same vote. ``num_rows``: the database's rows
    without the shard padding (k = min(knn_topk, borda_topk,
    ``num_rows``), as on one device)."""
    proj, valid = _segment_rows(desc, patch_masks, adjacency, centers,
                                pca_mean, pca_components, pca_variance,
                                whiten)
    k = min(knn_topk, borda_topk, num_rows)
    scores, ids = [], []
    for db, db_ids, norms in shards:
        s, idx = _knn_topk(proj.to(db.device), db, norms,
                           min(k, db.shape[0]), db_tile, oneshot_cap_bytes)
        scores.append(s)
        ids.append(db_ids[idx])
    scores, ref_ids = merge_candidates(scores, ids, k, proj.device)
    return _vote(proj, valid, scores, ref_ids, num_ref_images, top_images)


def pca_tuple(pca) -> Tuple[object, object, object, bool]:
    """PCA parameters (``mean``, ``components``, ``explained_variance``,
    ``whiten``) → the (mean, components, variance, whiten) arguments of
    the query tail."""
    return (pca.mean, pca.components, pca.explained_variance,
            bool(pca.whiten))
