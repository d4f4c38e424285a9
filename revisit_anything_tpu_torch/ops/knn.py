"""Exact brute-force kNN over a database on the device: the serving
query's streaming top-k merge (counterpart of
``revisit_anything_tpu/ops/knn.py`` ``_knn_scores`` :30).

A bf16 database meets the query rounded to bf16 and the products
accumulate in f32 (bf16 products are exact in f32), with no f32 copy of
the database: on the card one mixed-dtype product (``torch.mm(...,
out_dtype=torch.float32)``); the CPU, which has no such product, casts
a tile at a time.
"""

from __future__ import annotations

from typing import Tuple

import torch


def dot_f32(query: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """query [Nq, dim] f32 · db [Nd, dim]ᵀ → [Nq, Nd] f32 scores. A bf16
    ``db`` takes the query rounded to bf16 (the JAX package's bf16 x
    bf16 → f32 products)."""
    if db.dtype == torch.float32:
        return query.float() @ db.T
    q = query.to(db.dtype)
    if db.is_cuda:
        return torch.mm(q, db.T, out_dtype=torch.float32)
    return q.float() @ db.float().T


def _knn_scores(query: torch.Tensor, db: torch.Tensor,
                db_norms: torch.Tensor, k: int,
                db_tile: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Streaming top-k of score = q·d − 0.5‖d‖² (``db_norms`` = ‖d‖²) or
    plain q·d (``db_norms`` = 0), over tiles of ``db_tile`` rows. Returns
    (scores [Nq, k] f32, indices [Nq, k] int64), best first.

    The JAX version pads the database to whole tiles with rows whose
    norms are +inf (they never surface); here the last tile is simply
    shorter, which selects the same rows without copying the database."""
    nq, nd = query.shape[0], db.shape[0]
    best_s = torch.full((nq, k), float("-inf"), device=query.device)
    best_i = torch.zeros((nq, k), dtype=torch.int64, device=query.device)
    for start in range(0, nd, db_tile):
        stop = min(start + db_tile, nd)
        s = dot_f32(query, db[start:stop])
        s.sub_(0.5 * db_norms[None, start:stop])
        # the merged top-k can only take a tile's own top-k
        tile_s, tile_i = torch.topk(s, min(k, stop - start), dim=1)
        cand_s = torch.cat([best_s, tile_s], dim=1)
        cand_i = torch.cat([best_i, tile_i + start], dim=1)
        best_s, pos = torch.topk(cand_s, k, dim=1)
        best_i = torch.gather(cand_i, 1, pos)
    return best_s, best_i
