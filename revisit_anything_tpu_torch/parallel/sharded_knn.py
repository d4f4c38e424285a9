"""Exact kNN with the database rows sharded over a mesh.

Counterpart of ``revisit_anything_tpu/parallel/sharded_knn.py``
``sharded_knn_l2`` (:24-69): each device holds ⌈Nd/d⌉ database rows,
runs the streaming top-k of ``ops.knn`` over them, and the per-shard
candidates are merged on the mesh's first device by a stable top-k
(``lax.top_k``'s order: among equal scores the lower position, so the
lower global row, first). O(k·d) candidates a query cross devices, never
the score matrix.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from revisit_anything_tpu_torch.ops.knn import (DB_TILE, _knn_scores,
                                                f32_products,
                                                topk_lower_index_first)
from revisit_anything_tpu_torch.parallel.mesh import Mesh


def merge_candidates(scores: Sequence[torch.Tensor],
                     payloads: Sequence[torch.Tensor], k: int, device
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-shard candidates ([Nq, k_s] scores, best first, and a payload
    of the same shape: global row or image id) → the best ``k`` over all
    shards on ``device``, stable: equal scores keep shard order. Returns
    (scores [Nq, k], payloads [Nq, k])."""
    s = torch.cat([t.to(device) for t in scores], dim=1)
    p = torch.cat([t.to(device) for t in payloads], dim=1)
    top_s, pos = topk_lower_index_first(s, k)
    return top_s, torch.gather(p, 1, pos)


def _tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)


def sharded_knn_l2(query, db, k: int, mesh: Mesh, axis: str = "data",
                   db_tile: int = DB_TILE
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact L2 kNN, ``db`` [Nd, dim] sharded over ``axis``: (squared L2
    [Nq, k] ascending, global row indices [Nq, k]) on the mesh's first
    device, faiss ``IndexFlatL2`` conventions, k narrowed to min(k, Nd).
    Each shard is padded to ⌈Nd/d⌉ rows with zero rows whose norms are
    +inf (shard and global padding never surface); products in true f32
    as ``ops.knn.knn_l2``."""
    devs = mesh.axis_devices(axis)
    nd = db.shape[0]
    k = min(k, nd)
    rows = -(-nd // len(devs))
    tile = min(db_tile, max(128, rows))
    scores, indices = [], []
    with f32_products():
        for i, dev in enumerate(devs):
            base = i * rows
            shard = _tensor(db[base:base + rows], dev)
            n_real = shard.shape[0]
            if n_real < rows:
                shard = torch.cat([shard, shard.new_zeros(
                    (rows - n_real, shard.shape[1]))])
            norms = (shard * shard).sum(1)
            norms[n_real:] = float("inf")
            s, idx = _knn_scores(_tensor(query, dev), shard, norms,
                                 min(k, rows), tile, topk_lower_index_first)
            scores.append(s)
            indices.append(idx + base)
    top_s, top_i = merge_candidates(scores, indices, k, devs[0])
    q = _tensor(query, devs[0])
    sq_l2 = (q * q).sum(1, keepdim=True) - 2.0 * top_s
    return sq_l2, top_i
