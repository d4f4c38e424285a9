"""SuperSegment adjacency: Delaunay graph over mask centroids, order-K
power. Host-side numpy/scipy copy of ``revisit_anything_tpu/ops/
adjacency.py`` ``delaunay_adjacency`` (it must stay bit-compatible)."""

from __future__ import annotations

import numpy as np
from scipy.spatial import Delaunay, QhullError


def delaunay_adjacency(centroids: np.ndarray, order: int = 1) -> np.ndarray:
    """Order-K boolean adjacency [M, M] of the Delaunay graph with
    self-loops over centroids [M, 2] (x, y). M <= 3 or a degenerate
    triangulation falls back to every row connecting to masks [0, 1]
    ([0] when M == 1), as the reference does."""
    m = len(centroids)
    adj = np.zeros((m, m), dtype=np.float32)

    tri = None
    if m > 3:
        try:
            tri = Delaunay(centroids)
        except QhullError:
            try:
                tri = Delaunay(centroids, qhull_options="QJ")
            except QhullError:
                tri = None

    if tri is not None:
        indptr, indices = tri.vertex_neighbor_vertices
        for v in range(m):
            nbrs = np.unique(np.concatenate(
                ([v], indices[indptr[v]:indptr[v + 1]])))
            adj[v, nbrs] = 1.0
        power = adj.copy()
        for _ in range(order - 1):
            power = power @ adj
        return power.astype(bool)

    nbr_list = [0, 1] if m > 1 else [0]
    adj[:, nbr_list] = 1.0
    return adj.astype(bool)
