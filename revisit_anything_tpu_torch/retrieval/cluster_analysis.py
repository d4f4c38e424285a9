"""Cluster and descriptor-space analysis (counterpart of
``revisit_anything_tpu/retrieval/cluster_analysis.py``, the surface of
the reference's VLAD-BuFF/cluster_analysis.py).

Provides: 2-D t-SNE embedding of descriptors, per-image cluster usage
histograms from hard assignments, per-cluster triplet margins + the
cross-method cluster-rank-difference analysis (the HoPD burstiness
diagnostic), pairwise cosine-similarity maps, headless-safe plot
writers (t-SNE scatter, HoD distance histograms, per-cluster
soft-assignment overlays and the 2-row per-cluster diagnostic panel),
and the interactive tooltip scatter (``save_interactive_tsne_html`` —
the reference's mpld3 figure rebuilt as a dependency-free standalone
SVG+JS document).

``cluster_usage`` runs the port's ``ops.vlad.hard_assignment`` on a
device (the card unless the caller asks for the CPU); the rest is host
numpy. sklearn (``tsne_embed``), matplotlib, imageio and PIL are
imported inside the functions that use them: the card's machine has no
sklearn, so ``tsne_embed`` raises ``ImportError`` there. The
interactive scatter places its tooltip on the first hover, keeps the
points inside the plot frame and spaces the legend by the label's
length at its font size (the JAX copy does none of the three).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def tsne_embed(descriptors: np.ndarray, perplexity: float = 30.0,
               seed: int = 0, max_points: int = 5000):
    """[N, D] → ([M, 2] t-SNE embedding, [M] selected indices), where
    M = min(N, max_points) (sklearn backend, subsampled like the
    reference's sampling). The indices let callers subset per-descriptor
    labels/colors to the embedded rows."""
    from sklearn.manifold import TSNE
    x = np.asarray(descriptors, np.float32)
    idx = np.arange(len(x))
    if len(x) > max_points:
        idx = np.sort(np.random.default_rng(seed).choice(
            len(x), max_points, replace=False))
        x = x[idx]
    if len(x) < 2:
        return np.zeros((len(x), 2), np.float32), idx
    # sklearn requires perplexity < n_samples; a fixed lower clamp of 2
    # raised for exactly the degenerate inputs it was meant to protect
    perplexity = min(perplexity, max(1.0, (len(x) - 1) / 3.0))
    pts = TSNE(n_components=2, perplexity=perplexity,
               random_state=seed, init="pca").fit_transform(x)
    return pts, idx


def cluster_usage(descriptors: np.ndarray, centers: np.ndarray,
                  image_indices: Optional[Sequence[int]] = None,
                  device="cuda") -> np.ndarray:
    """Hard-assignment histograms: [n_images (or 1), n_clusters] counts of
    descriptors per cluster (the reference's per-cluster composition
    analysis); the assignment on ``device`` in true f32."""
    import torch

    from revisit_anything_tpu_torch.ops.knn import f32_products
    from revisit_anything_tpu_torch.ops.vlad import hard_assignment

    def tensor(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
            device)

    with f32_products():
        labels = hard_assignment(tensor(descriptors),
                                 tensor(centers)).cpu().numpy()
    c = centers.shape[0]
    if image_indices is None:
        return np.bincount(labels, minlength=c)[None]
    image_indices = np.asarray(image_indices)
    n_img = int(image_indices.max()) + 1
    out = np.zeros((n_img, c), np.int64)
    np.add.at(out, (image_indices, labels), 1)
    return out


def save_tsne_plot(points_2d: np.ndarray, labels: Optional[np.ndarray],
                   out_path: str) -> Optional[str]:
    """Scatter plot of a t-SNE embedding colored by label; returns the
    path, or None when matplotlib is unavailable (headless-safe)."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return None
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.scatter(points_2d[:, 0], points_2d[:, 1], s=4,
               c=labels if labels is not None else None, cmap="tab20")
    ax.set_title("t-SNE of segment descriptors")
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def triplet_margin(query: np.ndarray, positive: np.ndarray,
                   negative: np.ndarray) -> np.ndarray:
    """Per-cluster triplet margin ‖q−n‖ − ‖q−p‖ over [C, D_c] per-cluster
    VLAD blocks (compute_triplet_margin,
    VLAD-BuFF/cluster_analysis.py:295-298). Positive margin = the cluster
    separates the negative further than the positive."""
    query = np.asarray(query, np.float64)
    return (np.linalg.norm(query - np.asarray(negative, np.float64), axis=1)
            - np.linalg.norm(query - np.asarray(positive, np.float64),
                             axis=1))


def rank_clusters(margins: np.ndarray) -> np.ndarray:
    """Cluster ids ordered by ascending margin (rank_clusters, :301-302):
    rank 0 = the cluster that discriminates WORST."""
    return np.argsort(np.asarray(margins))


def cluster_rank_difference(ranks_a: np.ndarray, ranks_b: np.ndarray):
    """Per-cluster rank shift between two methods' margin rankings
    (compute_cluster_rank_difference, :305-308).

    Returns (shifts, cluster): ``shifts[i]`` = rank of ``ranks_b[i]``'s
    cluster under method B minus its rank under method A (iterated in
    method-B order, as the reference does), and ``cluster`` = the id with
    the maximum shift — the cluster method A demotes hardest relative to
    B (the VLAD-BuFF-vs-NetVLAD burstiness diagnostic)."""
    ra, rb = list(np.asarray(ranks_a)), list(np.asarray(ranks_b))
    shifts = [rb.index(c) - ra.index(c) for c in rb]
    return np.asarray(shifts), int(rb[int(np.argmax(shifts))])


def pairwise_cosine(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[N, M] cosine-similarity map between row sets (the quantitative
    core of the reference's ``cs`` heatmaps, :657-705). Zero rows map to
    zero similarity instead of NaN."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    na = np.linalg.norm(a, axis=1, keepdims=True)
    nb = np.linalg.norm(b, axis=1, keepdims=True)
    na[na == 0] = 1.0
    nb[nb == 0] = 1.0
    return (a / na) @ (b / nb).T


def _mpl():
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        return plt
    except Exception:
        return None


def _grid_side(n: int) -> int:
    s = int(round(float(np.sqrt(n))))
    assert s * s == n, f"soft-assign rows must be square grids, got {n}"
    return s


def save_cluster_overlay(image_rgb: np.ndarray, soft_assign: np.ndarray,
                         cluster: int, out_path: str,
                         alpha: float = 0.35,
                         title: Optional[str] = None) -> Optional[str]:
    """One cluster's soft-assignment map overlaid on the image — the
    reference's per-cluster dump loop (cluster_analysis.py:113-146: image
    resized to the assignment grid, ``imshow`` overlay at alpha, colorbar,
    axes off). ``soft_assign``: [C, P] with P a square grid. Returns the
    path, or None when matplotlib is unavailable (headless-safe)."""
    plt = _mpl()
    if plt is None:
        return None
    w = _grid_side(soft_assign.shape[1])
    from PIL import Image
    img = Image.fromarray(np.asarray(image_rgb)).resize((w, w))
    fig, ax = plt.subplots(figsize=(10, 6))
    ax.imshow(img)
    ax.set_title(title if title is not None else f"Cluster: {cluster}")
    im = ax.imshow(np.asarray(soft_assign)[cluster].reshape(w, w),
                   aspect="auto", alpha=alpha)
    fig.colorbar(im)
    ax.axis("off")
    fig.savefig(out_path, bbox_inches="tight", pad_inches=0)
    plt.close(fig)
    return out_path


def save_cluster_panel(image_rgb: np.ndarray, assigns, cluster: int,
                       out_path: str, w_burst: Optional[np.ndarray] = None,
                       self_dis: Optional[np.ndarray] = None,
                       title: str = "") -> Optional[str]:
    """The reference's 2x6 per-(image, cluster) diagnostic panel
    (cluster_analysis.py:149-247), pure matplotlib: row 1 = the original
    image, one soft-assignment overlay per method (``assigns``: ordered
    dict/map name → [C, P]), the 1/w_burst map, and the selfDis heatmap;
    row 2 = ``visualize_pixel_intensities`` bar plots (:284-290) of each
    row-1 map. Unused slots are blanked like the reference's None
    branches. Returns the path, or None when matplotlib is unavailable."""
    plt = _mpl()
    if plt is None:
        return None
    names = list(assigns)
    cols = max(6, 2 + len(names) + (w_burst is not None)
               + (self_dis is not None))
    fig, axes = plt.subplots(2, cols, figsize=(5 * cols, 6))
    if title:
        fig.suptitle(title, fontsize=16)

    first = assigns[names[0]]
    w = _grid_side(first.shape[1])
    from PIL import Image
    img_resized = np.asarray(
        Image.fromarray(np.asarray(image_rgb)).resize((w, w)))

    def intensities(data, ax):
        vals = np.asarray(data).ravel()
        ax.bar(range(len(vals)), vals)
        ax.set_xlabel("Pixel Index")
        ax.set_ylabel("Intensity")
        if len(vals) and float(np.max(vals)) > 0:
            ax.set_ylim([0, float(np.max(vals))])

    axes[0, 0].imshow(np.asarray(image_rgb))
    axes[0, 0].axis("off")
    col = 1
    for name in names:
        m = np.asarray(assigns[name])[cluster].reshape(w, w)
        axes[0, col].set_title(f"{name}: SA, Cluster: {cluster}")
        axes[0, col].imshow(img_resized)
        im = axes[0, col].imshow(m, aspect="auto", alpha=0.75)
        fig.colorbar(im, ax=axes[0, col])
        intensities(m, axes[1, col])
        col += 1
    if w_burst is not None:
        wb = 1.0 / np.asarray(w_burst, np.float64)
        wb = wb.reshape(_grid_side(wb.size), -1)
        axes[0, col].set_title("1/w_burst")
        axes[0, col].imshow(img_resized)
        im = axes[0, col].imshow(wb, aspect="auto", alpha=0.75)
        fig.colorbar(im, ax=axes[0, col])
        intensities(wb, axes[1, col])
        col += 1
    if self_dis is not None:
        axes[0, col].set_title(f"selfDis: {np.asarray(self_dis).shape}")
        im = axes[0, col].imshow(np.asarray(self_dis), aspect="auto")
        fig.colorbar(im, ax=axes[0, col])
        col += 1
    for c in range(col, cols):
        axes[0, c].axis("off")
    axes[1, 0].axis("off")
    for c in range(col, cols):
        axes[1, c].axis("off")
    fig.tight_layout()
    fig.savefig(out_path)
    plt.close(fig)
    return out_path


def save_cluster_gif(image_rgb: np.ndarray, assigns, out_dir: str,
                     prefix: str = "clusters",
                     duration: float = 0.1) -> Optional[str]:
    """All-cluster animation: one panel frame per cluster assembled into a
    GIF (the reference's clusterNo=None branch, cluster_analysis.py:
    250-262, imageio writer + per-frame cleanup). Returns the gif path,
    or None when matplotlib/imageio are unavailable."""
    plt = _mpl()
    if plt is None:
        return None
    try:
        import imageio.v2 as imageio
    except Exception:
        try:
            import imageio
        except Exception:
            return None
    import os
    names = list(assigns)
    n_clusters = np.asarray(assigns[names[0]]).shape[0]
    frames = []
    for c in range(n_clusters):
        p = os.path.join(out_dir, f"_frame_{c}.png")
        if save_cluster_panel(image_rgb, assigns, c, p,
                              title=f"Cluster: {c}") is None:
            return None
        frames.append(p)
    gif_path = os.path.join(out_dir, f"{prefix}.gif")
    with imageio.get_writer(gif_path, mode="I", duration=duration) as wr:
        for p in frames:
            wr.append_data(imageio.imread(p))
            os.remove(p)
    return gif_path


def save_distance_histograms(dist_pos: np.ndarray, dist_neg: np.ndarray,
                             out_path: str, title: str = "") -> Optional[str]:
    """HoD-style histogram of query–positive vs query–negative distances
    (HoD, :311-368; one panel per call — the reference's two-method
    side-by-side is two calls). Returns the path, or None when matplotlib
    is unavailable (headless-safe)."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return None
    fig, ax = plt.subplots(figsize=(7.5, 7))
    ax.hist(np.asarray(dist_pos), bins=30, alpha=0.5, color="g",
            label="Query-Positive Distances")
    ax.hist(np.asarray(dist_neg), bins=30, alpha=0.5, color="r",
            label="Query-Negative Distances")
    ax.legend()
    ax.set_title(f"Histogram of Distances {title}".rstrip())
    ax.set_xlabel("Distance")
    ax.set_ylabel("Frequency")
    fig.tight_layout()
    fig.savefig(out_path)
    plt.close(fig)
    return out_path


def save_interactive_tsne_html(panels, out_path: str, *,
                               width: int = 700, height: int = 620,
                               point_radius: int = 5,
                               tooltip_width: int = 300) -> str:
    """Interactive t-SNE scatter with per-point hover image tooltips —
    the reference's mpld3 figure (VLAD-BuFF/cluster_analysis.py:511-601
    and :780-858: side-by-side method panels, query/positive/negative
    point sets in r/g/b, ``PointHTMLTooltip`` labels of
    ``<img src=... width=300>``, saved via ``mpld3.save_html``), rebuilt
    as a SELF-CONTAINED static SVG+JS document with no rendering
    dependency at all (no mpld3, no matplotlib, no server).

    ``panels``: sequence of ``(title, groups)``; each group is
    ``(label, css_color, points_2d [N,2], tooltips)`` where ``tooltips``
    gives one entry per point — an image path (rendered as the
    reference's ``<img width=300>``; a path missing at write time renders
    the reference's ``Image not found: <path>`` fallback,
    cluster_analysis.py:544-547) or a raw HTML snippet (detected by a
    leading ``<``). Paths are embedded verbatim, so callers keep the
    reference's relative-path convention (:595-601). Returns
    ``out_path``.
    """
    import html as _html
    import os as _os

    def _tooltip_html(tt) -> str:
        tt = str(tt)
        if tt.lstrip().startswith("<"):
            return tt
        if _os.path.exists(tt):
            return f'<img src="{_html.escape(tt, quote=True)}" ' \
                   f'width="{tooltip_width}">'
        return f"Image not found: {_html.escape(tt)}"

    margin, legend_h, title_h = 40, 24, 28
    plot_w = width - 2 * margin
    plot_h = height - 2 * margin - legend_h - title_h
    # points are placed inside the frame inset by their radius, so no
    # circle crosses the frame into the title band or the next panel
    inner_w, inner_h = plot_w - 2 * point_radius, plot_h - 2 * point_radius
    svgs = []
    for title, groups in panels:
        pts_all = [np.asarray(p, np.float64).reshape(-1, 2)
                   for _, _, p, _ in groups]
        stacked = (np.concatenate([p for p in pts_all if len(p)], axis=0)
                   if any(len(p) for p in pts_all)
                   else np.zeros((1, 2)))
        lo, hi = stacked.min(axis=0), stacked.max(axis=0)
        span = np.maximum(hi - lo, 1e-12)
        parts = [f'<svg width="{width}" height="{height}" '
                 f'class="rat-panel" '
                 f'xmlns="http://www.w3.org/2000/svg">',
                 f'<text x="{width // 2}" y="{title_h - 8}" '
                 f'text-anchor="middle" class="rat-title">'
                 f'{_html.escape(str(title))}</text>',
                 f'<rect x="{margin}" y="{title_h}" width="{plot_w}" '
                 f'height="{plot_h}" class="rat-frame"/>']
        legend_x = margin
        for label, color, pts, tooltips in groups:
            pts = np.asarray(pts, np.float64).reshape(-1, 2)
            if len(tooltips) != len(pts):
                raise ValueError(
                    f"group {label!r}: {len(tooltips)} tooltips for "
                    f"{len(pts)} points")
            color = _html.escape(str(color), quote=True)
            for (x, y), tt in zip(pts, tooltips):
                sx = margin + point_radius + (x - lo[0]) / span[0] * inner_w
                # SVG y grows downward; data y grows upward.
                sy = (title_h + plot_h - point_radius
                      - (y - lo[1]) / span[1] * inner_h)
                parts.append(
                    f'<circle cx="{sx:.1f}" cy="{sy:.1f}" '
                    f'r="{point_radius}" fill="{color}" class="rat-pt" '
                    f'data-tt="{_html.escape(_tooltip_html(tt), quote=True)}"/>')
            ly = title_h + plot_h + legend_h
            parts.append(f'<circle cx="{legend_x + 6}" cy="{ly}" r="5" '
                         f'fill="{color}"/>')
            parts.append(f'<text x="{legend_x + 16}" y="{ly + 4}" '
                         f'class="rat-legend">'
                         f'{_html.escape(str(label))}</text>')
            # ~0.62 em a character of the 12px sans-serif legend font
            legend_x += 26 + int(np.ceil(7.5 * len(str(label))))
        parts.append('</svg>')
        svgs.append("\n".join(parts))

    doc = f"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>t-SNE scatter</title>
<style>
body {{ font-family: sans-serif; margin: 8px; }}
.rat-panel {{ display: inline-block; vertical-align: top; }}
.rat-frame {{ fill: none; stroke: #888; }}
.rat-title {{ font-size: 15px; }}
.rat-legend {{ font-size: 12px; }}
.rat-pt {{ cursor: pointer; opacity: 0.85; }}
.rat-pt:hover {{ stroke: #000; stroke-width: 1.5; }}
#rat-tip {{ position: fixed; display: none; pointer-events: none;
  background: #fff; border: 1px solid #444; padding: 4px;
  z-index: 10; max-width: {tooltip_width + 20}px; }}
</style></head><body>
{"".join(svgs)}
<div id="rat-tip"></div>
<script>
var tip = document.getElementById("rat-tip");
document.querySelectorAll(".rat-pt").forEach(function (c) {{
  c.addEventListener("mouseenter", function (e) {{
    tip.innerHTML = c.getAttribute("data-tt");
    tip.style.left = (e.clientX + 10) + "px";
    tip.style.top = (e.clientY + 10) + "px";
    tip.style.display = "block";
  }});
  c.addEventListener("mousemove", function (e) {{
    tip.style.left = (e.clientX + 10) + "px";
    tip.style.top = (e.clientY + 10) + "px";
  }});
  c.addEventListener("mouseleave", function () {{
    tip.style.display = "none";
  }});
}});
</script></body></html>
"""
    with open(out_path, "w") as fh:
        fh.write(doc)
    return out_path
