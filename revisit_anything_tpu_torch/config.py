"""Dimensional constants the serving slice reads.

Counterpart of ``revisit_anything_tpu/config.py``; only the constants the
query path uses are carried (the dataset/experiment tree is not ported yet).
"""

from __future__ import annotations

PATCH_SIZE = 14                 # DINOv2 patch size; patch grid = desired // 14
NUM_CLUSTERS = 32               # VLAD vocabulary size
DINO_G_DIM = 1536               # DINOv2 ViT-g/14 feature dim (value facet)
PCA_DIM = 1024                  # whitened PCA output dim
KNN_TOPK = 200                  # retrieval candidates per query segment
BORDA_TOPK = 50                 # candidates used for weighted Borda voting
RECALL_TOPK = 5                 # Recall@1..5 reported

# 17places: DINO at the dataset's 'desired' size, SAM at half of it.
PLACES17_HW = (480, 640)
PLACES17_SAM_HW = (240, 320)
