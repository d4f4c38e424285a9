"""Dimensional constants, the nine datasets and the nine experiments.

Counterpart of ``revisit_anything_tpu/config.py``: the constants, and
``ImageSize``, ``DatasetConfig``, ``ExperimentConfig``,
``RetrievalConfig``, ``DATASETS``, ``EXPERIMENTS``, ``get_dataset`` and
``get_experiment`` (:144-238), field for field, and ``WorkdirConfig``
(:120-141): the filesystem roots, from the ``RAT_*`` environment
variables when the object is made.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

PATCH_SIZE = 14                 # DINOv2 patch size; patch grid = desired // 14
NUM_CLUSTERS = 32               # VLAD vocabulary size
DINO_G_DIM = 1536               # DINOv2 ViT-g/14 feature dim (value facet)
VLAD_DIM = NUM_CLUSTERS * DINO_G_DIM        # 49152
DINO_B_NV_DIM = 768             # fine-tuned DINOv2-B/14 + NetVLAD feature dim
VLAD_DIM_FINETUNED = NUM_CLUSTERS * DINO_B_NV_DIM  # 24576
PCA_DIM = 1024                  # whitened PCA output dim
KNN_TOPK = 200                  # retrieval candidates per query segment
BORDA_TOPK = 50                 # candidates used for weighted Borda voting
RECALL_TOPK = 5                 # Recall@1..5 reported


@dataclasses.dataclass(frozen=True)
class ImageSize:
    """Target (height, width) an image stage resizes to."""
    height: int
    width: int

    @property
    def hw(self) -> Tuple[int, int]:
        return (self.height, self.width)

    @property
    def patch_grid(self) -> Tuple[int, int]:
        """DINOv2 patch grid (dh, dw) = floor(size / 14)."""
        return (self.height // PATCH_SIZE, self.width // PATCH_SIZE)

    def half(self) -> "ImageSize":
        """SAM extraction resolution: half of the DINO resolution."""
        return ImageSize(self.height // 2, self.width // 2)


@dataclasses.dataclass(frozen=True)
class DatasetConfig:
    """One VPR dataset: artifact names, image locations, resolution and
    vocabulary ids."""
    name: str
    size: ImageSize
    data_subpath_ref: str
    data_subpath_query: str
    masks_h5_ref: str
    masks_h5_query: str
    dino_h5_ref: str
    dino_h5_query: str
    dino_nv_h5_ref: str = ""
    dino_nv_h5_query: str = ""
    map_vlad_cluster: str = ""
    domain_vlad_cluster: str = ""
    # SAM masks are made at half the DINO resolution for every dataset
    # except AmsterTime
    sam_at_half_res: bool = True

    @property
    def sam_size(self) -> ImageSize:
        return self.size.half() if self.sam_at_half_res else self.size

    def vocab_id(self, vocab_vlad: str) -> str:
        """'domain' or 'map' vocabulary id."""
        if vocab_vlad == "domain":
            return self.domain_vlad_cluster
        if vocab_vlad == "map":
            return self.map_vlad_cluster
        raise ValueError(f"vocab_vlad must be 'domain' or 'map', got "
                         f"{vocab_vlad!r}")


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    """One retrieval experiment: method, SuperSegment order, PCA on/off."""
    name: str
    global_method: str            # "SegLoc" | "AnyLoc"
    min_area: int = 0
    order: int = 0                # SuperSegment A^K order; 0 disables adjacency
    pca: bool = False
    results_pkl_suffix: str = ""
    pca_model_pkl: str = ""
    pca_model_pkl_map: str = ""


@dataclasses.dataclass(frozen=True)
class RetrievalConfig:
    """Knobs of the retrieval and voting stage."""
    knn_topk: int = KNN_TOPK
    borda_topk: int = BORDA_TOPK
    recall_topk: int = RECALL_TOPK
    match_method: str = "max_seg_topk_wt_borda_Im"


@dataclasses.dataclass(frozen=True)
class WorkdirConfig:
    """Filesystem roots: datasets, the artifact workdir and the vocabulary
    cache. The environment (``RAT_DATA_ROOT``, ``RAT_WORKDIR``,
    ``RAT_CACHE_ROOT``) is read when the object is made, not at import.
    Without it the roots are the CLI's defaults, relative to the working
    directory (the JAX package's are absolute paths of its own machine).
    """
    data_root: str = dataclasses.field(
        default_factory=lambda: os.environ.get("RAT_DATA_ROOT", "./data"))
    workdir: str = dataclasses.field(
        default_factory=lambda: os.environ.get("RAT_WORKDIR", "./workdir"))
    cache_root: str = dataclasses.field(
        default_factory=lambda: os.environ.get("RAT_CACHE_ROOT", "./cache"))

    def vocab_path(self, vocab_id: str, finetuned: bool = False) -> str:
        """The cluster-centre file in the reference's cache layout,
        ``vocabulary/dinov2_vitg14/l31_value_c32/{id}/c_centers.pt``
        (vlad_c_centers_pt_gen.py:148-150), ``NVFinetuned`` after the id
        for the fine-tuned vocabulary."""
        suffix = "NVFinetuned" if finetuned else ""
        return os.path.join(
            self.cache_root, "vocabulary", "dinov2_vitg14", "l31_value_c32",
            f"{vocab_id}{suffix}", "c_centers.pt")


def _ds(name: str, h: int, w: int, sub_r: str, sub_q: str,
        map_c: str, domain_c: str, sam_half: bool = True,
        masks_r: Optional[str] = None, masks_q: Optional[str] = None,
        dino_r: Optional[str] = None, dino_q: Optional[str] = None,
        ) -> DatasetConfig:
    mask_tag, dino_tag = str(w // 2), str(w)
    return DatasetConfig(
        name=name,
        size=ImageSize(h, w),
        data_subpath_ref=sub_r,
        data_subpath_query=sub_q,
        masks_h5_ref=masks_r or f"{name}_r_masks_{mask_tag}.h5",
        masks_h5_query=masks_q or f"{name}_q_masks_{mask_tag}.h5",
        dino_h5_ref=dino_r or f"{name}_r_dino_{dino_tag}.h5",
        dino_h5_query=dino_q or f"{name}_q_dino_{dino_tag}.h5",
        dino_nv_h5_ref=f"{name}_r_dinoNV_{dino_tag}.h5",
        dino_nv_h5_query=f"{name}_q_dinoNV_{dino_tag}.h5",
        map_vlad_cluster=map_c,
        domain_vlad_cluster=domain_c,
        sam_at_half_res=sam_half,
    )


# The nine reference datasets.
DATASETS: Dict[str, DatasetConfig] = {d.name: d for d in [
    _ds("baidu", 480, 640, "training_images_undistort",
        "query_images_undistort", "baidu", "indoor"),
    _ds("17places", 480, 640, "ref", "query", "17places", "indoor"),
    _ds("SFXL", 512, 512, "database", "queries", "SFXL", "urban"),
    _ds("InsideOut", 480, 640, "ref_images", "query_images", "InsideOut",
        "urban"),
    _ds("mslsSF", 480, 640, "database", "query", "mslsSF", "urban"),
    _ds("mslsCPH", 480, 640, "database", "query", "mslsCPH", "urban"),
    _ds("VPAir", 600, 800, "reference_views", "queries", "VPAir", "aerial"),
    _ds("pitts", 480, 640, "pitts30k/images/test/database",
        "pitts30k/images/test/queries", "pitts", "urban",
        masks_r="pitts30k_r_masks.h5", masks_q="pitts30k_q_masks.h5",
        dino_r="pitts30k_r_dino_640.h5", dino_q="pitts30k_q_dino_640.h5"),
    _ds("AmsterTime", 256, 256, "new", "old", "AmsterTime", "urban",
        sam_half=False,
        masks_r="AmsterTime_new_masks.h5", masks_q="AmsterTime_old_masks.h5",
        dino_r="AmsterTime_r_dino_256.h5", dino_q="AmsterTime_q_dino_256.h5"),
]}

# 17places: DINO at the dataset's 'desired' size, SAM at half of it.
PLACES17_HW = DATASETS["17places"].size.hw
PLACES17_SAM_HW = DATASETS["17places"].sam_size.hw


def _segloc_exp(name: str, order: int, pca: bool, suffix: str,
                pca_pkl: str = "", pca_pkl_map: str = "") -> ExperimentConfig:
    return ExperimentConfig(
        name=name, global_method="SegLoc", min_area=0, order=order, pca=pca,
        results_pkl_suffix=suffix, pca_model_pkl=pca_pkl,
        pca_model_pkl_map=pca_pkl_map)


# The nine reference experiments.
EXPERIMENTS: Dict[str, ExperimentConfig] = {e.name: e for e in [
    _segloc_exp("exp0_global_SegLoc_VLAD_PCA_o3", order=3, pca=True,
                suffix="_results_exp11_global_SegLoc_VLAD_PCA_o3.pkl",
                pca_pkl="_r_fitted_pca_model_order3.pkl",
                pca_pkl_map="_r_fitted_pca_model_order3_map.pkl"),
    ExperimentConfig(name="exp1_global_Anyloc", global_method="AnyLoc",
                     min_area=0,
                     results_pkl_suffix="_results_exp1_global_Anyloc_VLAD.pkl"),
    _segloc_exp("exp4_global_SegLoc_VLAD_o0", order=0, pca=False,
                suffix="_results_exp4_global_SegLoc_VLAD_o0.pkl"),
    _segloc_exp("exp8_global_SegLoc_VLAD_PCA_o0", order=0, pca=True,
                suffix="results_exp8_global_SegLoc_VLAD_PCA_o0.pkl",
                pca_pkl="_r_fitted_pca_model_order0.pkl"),
    _segloc_exp("exp5_global_SegLoc_VLAD_o1", order=1, pca=False,
                suffix="_results_exp5_global_SegLoc_VLAD_o1.pkl"),
    _segloc_exp("exp9_global_SegLoc_VLAD_PCA_o1", order=1, pca=True,
                suffix="_results_exp9_global_SegLoc_VLAD_PCA_o1.pkl",
                pca_pkl="_r_fitted_pca_model_order1.pkl"),
    _segloc_exp("exp6_global_SegLoc_VLAD_o2", order=2, pca=False,
                suffix="_results_exp6_global_SegLoc_VLAD_o2.pkl"),
    _segloc_exp("exp10_global_SegLoc_VLAD_PCA_o2", order=2, pca=True,
                suffix="_results_exp10_global_SegLoc_VLAD_PCA_o2.pkl",
                pca_pkl="_r_fitted_pca_model_order2.pkl"),
    _segloc_exp("exp7_global_SegLoc_VLAD_o3", order=3, pca=False,
                suffix="_results_exp7_global_SegLoc_VLAD_o3.pkl"),
]}


def get_dataset(name: str) -> DatasetConfig:
    try:
        return DATASETS[name]
    except KeyError:
        raise KeyError(f"Unknown dataset {name!r}; known: {sorted(DATASETS)}")


def get_experiment(name: str) -> ExperimentConfig:
    try:
        return EXPERIMENTS[name]
    except KeyError:
        raise KeyError(f"Unknown experiment {name!r}; known: "
                       f"{sorted(EXPERIMENTS)}")
