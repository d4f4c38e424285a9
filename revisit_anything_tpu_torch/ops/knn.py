"""Exact brute-force kNN over a database on the device: the serving
query's streaming top-k merge, and the offline stages' ``knn_l2`` and
``knn_inner_product`` (counterpart of ``revisit_anything_tpu/ops/knn.py``
``_knn_scores`` :30, ``knn_l2`` :79, ``knn_inner_product`` :103).

A bf16 database meets the query rounded to bf16 and the products
accumulate in f32 (bf16 products are exact in f32), with no f32 copy of
the database: on the card one mixed-dtype product (``torch.mm(...,
out_dtype=torch.float32)``); the CPU, which has no such product, casts
a tile at a time.
"""

from __future__ import annotations

import contextlib
from typing import Tuple

import torch

# database rows a streaming tile, for the serving query and the offline
# kNN alike. The JAX default, 8,192 rows, is a TPU size: on one H100
# (80GB HBM3, 700 W) a 600k-row bf16 database took 16.6-36.5 ms in tiles
# of 8,192 and 3.5 ms in tiles of 131,072 (64 MiB of scores at 128
# segments; chip_smoke.py [stream-knn]); the offline f32 kNN of 2,048
# segments over 6,144 rows of 49,152 took as long in six tiles of 1,024
# as in one (~27 ms, chip_smoke.py [offline])
DB_TILE = 131072


@contextlib.contextmanager
def f32_products():
    """f32 matrix products on the card in true f32 inside the block,
    whatever the process's setting (TF32 would flip kmeans labels and kNN
    orders; the JAX package computes these at ``Precision.HIGHEST``).
    Reads and restores the cuBLAS setting through its per-backend
    property (``torch.get_float32_matmul_precision`` raises once a
    process has mixed the legacy ``allow_tf32`` flags with the new API).
    The setting is process-wide, so the block also holds other threads'
    products to f32. CPU products are f32 unless the process lowered
    ``torch.set_float32_matmul_precision`` itself."""
    matmul = torch.backends.cuda.matmul
    prev = matmul.fp32_precision
    matmul.fp32_precision = "ieee"
    try:
        yield
    finally:
        matmul.fp32_precision = prev


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


def topk_lower_index_first(x: torch.Tensor, k: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries of each row, best first, and among equal
    entries the lower index first (``lax.top_k``'s order; ``torch.topk``
    promises none on the card): a stable sort of the row."""
    vals, idx = torch.sort(x, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    return torch.topk(x, k, dim=1)


def _knn_scores(query: torch.Tensor, db: torch.Tensor,
                db_norms: torch.Tensor, k: int, db_tile: int,
                select=_topk) -> Tuple[torch.Tensor, torch.Tensor]:
    """Streaming top-k of score = q·d − 0.5‖d‖² (``db_norms`` = ‖d‖²) or
    plain q·d (``db_norms`` = 0), over tiles of ``db_tile`` rows. Returns
    (scores [Nq, k] f32, indices [Nq, k] int64), best first; k ≤ Nd.
    ``select`` takes a row-wise top-k: with
    :func:`topk_lower_index_first`, equal scores keep the lower row first
    (earlier tiles sit before a tile in the merge).

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
        tile_s, tile_i = select(s, min(k, stop - start))
        cand_s = torch.cat([best_s, tile_s], dim=1)
        cand_i = torch.cat([best_i, tile_i + start], dim=1)
        best_s, pos = select(cand_s, k)
        best_i = torch.gather(cand_i, 1, pos)
    return best_s, best_i


def knn_l2(query: torch.Tensor, db: torch.Tensor, k: int,
           db_tile: int = DB_TILE) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact L2 kNN in f32, faiss ``IndexFlatL2.search`` conventions:
    (squared L2 [Nq, k] ascending, indices [Nq, k]); k is narrowed to
    min(k, Nd). Runs on the tensors' device."""
    query, db = query.float(), db.float()
    k = min(k, db.shape[0])
    with f32_products():
        scores, idx = _knn_scores(query, db, (db * db).sum(1), k, db_tile,
                                  topk_lower_index_first)
    sq_l2 = (query * query).sum(1, keepdim=True) - 2.0 * scores
    return sq_l2, idx


def knn_inner_product(query: torch.Tensor, db: torch.Tensor, k: int,
                      db_tile: int = DB_TILE
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact max-inner-product search (faiss ``IndexFlatIP``): (dot
    products [Nq, k] descending, indices)."""
    query, db = query.float(), db.float()
    k = min(k, db.shape[0])
    norms = torch.zeros(db.shape[0], device=db.device)
    with f32_products():
        return _knn_scores(query, db, norms, k, db_tile,
                           topk_lower_index_first)
