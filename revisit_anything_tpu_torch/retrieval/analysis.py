"""Analysis tools: triplets, margins, segment coverage, match grids, the
comparison of two methods' predictions, and the VLAD-BuFF validation
recalls.

Counterpart of ``revisit_anything_tpu/retrieval/analysis.py``
(:21-195): ``create_triplets``, ``calc_margins``, ``seg_area_covered``,
``get_validation_recalls`` (on the port's ``ops.knn.knn_l2``),
``match_grid``, ``compare_method_predictions`` and
``save_prediction_analysis``. Host numpy but for the recalls' kNN; cv2
and PIL are imported inside the functions that draw.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from revisit_anything_tpu_torch.ops.knn import knn_l2


def create_triplets(preds: Sequence[Sequence[int]],
                    gt: Sequence[Sequence[int]]
                    ) -> List[Tuple[int, int, int]]:
    """(query, positive, hardest negative) triplets from predictions
    (func_vpr.py:1553-1570): the negative is the best-ranked wrong
    prediction, the positive the first gt hit in the predictions (the
    first gt entry when none hits); queries without gt or without a
    wrong prediction give none."""
    triplets = []
    for q, (pred_q, gt_q) in enumerate(zip(preds, gt)):
        if len(gt_q) == 0:
            continue
        gt_set = set(int(g) for g in gt_q)
        neg = next((int(p) for p in pred_q if int(p) not in gt_set), None)
        pos = next((int(p) for p in pred_q if int(p) in gt_set),
                   int(gt_q[0]))
        if neg is not None:
            triplets.append((q, pos, neg))
    return triplets


def calc_margins(query_desc: np.ndarray, db_desc: np.ndarray,
                 triplets: Sequence[Tuple[int, int, int]]) -> np.ndarray:
    """Each triplet's similarity margin sim(q, pos) − sim(q, neg), inner
    products as the reference's calc_margins_global
    (func_vpr.py:1610-1629)."""
    margins = []
    for q, pos, neg in triplets:
        sp = float(np.dot(query_desc[q], db_desc[pos]))
        sn = float(np.dot(query_desc[q], db_desc[neg]))
        margins.append(sp - sn)
    return np.asarray(margins)


def seg_area_covered(masks: np.ndarray) -> list:
    """Each mask's area over the image's (func_vpr.py segAreaCovered
    :1631-1645: a flat list, one entry a mask, not the union)."""
    return [float(np.asarray(m).mean()) for m in masks]


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


def match_grid(query_image: np.ndarray,
               pred_images: Sequence[np.ndarray],
               correct: Sequence[bool],
               border: int = 4) -> np.ndarray:
    """A match strip: the query (yellow border) and then each prediction
    (green border when correct, red when not), at the smallest height
    (cv2 resize), as one RGB uint8 image."""
    def with_border(img, color):
        out = np.full((img.shape[0] + 2 * border,
                       img.shape[1] + 2 * border, 3), color, np.uint8)
        out[border:-border, border:-border] = img
        return out

    h = min(im.shape[0] for im in [query_image, *pred_images])

    def fit(im):
        if im.shape[0] != h:
            import cv2
            w = int(im.shape[1] * h / im.shape[0])
            im = cv2.resize(im, (w, h))
        return im

    panels = [with_border(fit(query_image), (255, 255, 0))]
    for im, ok in zip(pred_images, correct):
        panels.append(with_border(fit(im),
                                  (0, 200, 0) if ok else (220, 0, 0)))
    hmax = max(p.shape[0] for p in panels)
    padded = [np.pad(p, ((0, hmax - p.shape[0]), (0, 0), (0, 0)))
              for p in panels]
    return np.concatenate(padded, axis=1)


def compare_method_predictions(preds_baseline, preds_method, gt):
    """Per-query top-1 comparison of two methods (VLAD-BuFF
    predictions.py:120-231): a dict a query with gt (QueryIndex,
    BaselineCorrect, MethodCorrect, CorrectedByYourMethod,
    BrokenByYourMethod)."""
    rows = []
    for qi, gt_q in enumerate(gt):
        if len(gt_q) == 0:
            continue
        gt_set = set(int(g) for g in gt_q)
        b_ok = int(preds_baseline[qi][0]) in gt_set
        m_ok = int(preds_method[qi][0]) in gt_set
        rows.append({
            "QueryIndex": qi,
            "BaselineCorrect": b_ok,
            "MethodCorrect": m_ok,
            "CorrectedByYourMethod": (not b_ok) and m_ok,
            "BrokenByYourMethod": b_ok and (not m_ok),
        })
    return rows


def save_prediction_analysis(rows, query_paths, db_paths, preds_baseline,
                             preds_method, out_dir,
                             baseline_name="baseline",
                             method_name="method",
                             max_images: int = 50):
    """predictions.py's artifacts (:232-313): ``prediction_analysis.csv``
    and, for at most ``max_images`` queries one method corrects or
    breaks, a 3-panel strip (query | baseline top-1 | method top-1, the
    winner's border green) under ``correct/`` or ``incorrect/``. Returns
    (csv path, strips written)."""
    import csv as csvmod
    import os

    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    csv_path = os.path.join(out_dir, "prediction_analysis.csv")
    with open(csv_path, "w", newline="") as f:
        wr = csvmod.DictWriter(f, fieldnames=list(rows[0].keys()) if rows
                               else ["QueryIndex"])
        wr.writeheader()
        wr.writerows(rows)

    n_grids = 0
    for sub in ("correct", "incorrect"):
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)
    for row in rows:
        if not (row["CorrectedByYourMethod"] or row["BrokenByYourMethod"]):
            continue
        if n_grids >= max_images:
            break
        qi = row["QueryIndex"]
        corrected = row["CorrectedByYourMethod"]
        q_img = np.asarray(Image.open(query_paths[qi]).convert("RGB"))
        b_img = np.asarray(Image.open(
            db_paths[int(preds_baseline[qi][0])]).convert("RGB"))
        m_img = np.asarray(Image.open(
            db_paths[int(preds_method[qi][0])]).convert("RGB"))
        grid = match_grid(q_img, [b_img, m_img],
                          [not corrected, corrected])
        sub = "correct" if corrected else "incorrect"
        name = (f"{baseline_name}_vs_{method_name}_"
                f"{'corrected' if corrected else 'broken'}_q{qi}.png")
        Image.fromarray(grid).save(os.path.join(out_dir, sub, name))
        n_grids += 1
    return csv_path, n_grids
