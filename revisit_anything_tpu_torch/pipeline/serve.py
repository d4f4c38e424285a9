"""Online serving: raw query image → top-k database images, on one device,
over a live database.

Counterpart of ``revisit_anything_tpu/pipeline/serve.py``:
``ServingIndex`` (+``from_npz``), ``SegVLADServer`` with ``query``
(:555), pipelined ``query_many`` (:577), ``add_reference_images`` (:587),
``remove_reference_image`` (:683) and ``snapshot_index`` (:696), the
database updates ``_db_insert`` (:88), ``_compact_insert_many`` (:100)
and ``_db_remove`` (:134), and the device stages
``_sam_preprocess_fused`` (:141; in ``models/sam/amg.py``, which the
offline extraction shares), ``_select_masks_centroids`` (:170),
``_dino_desc_device`` (:210) and the host ``_adjacency`` (:517).

Per query: one uint8 upload; SAM preprocess → encode → AMG decode batches
→ thresholds/NMS/top-``kmax`` select → mask→patch pooling, and the DINO
dense features, all on the device; one small readback (centroids) for the
host Qhull Delaunay adjacency; the retrieval tail on the device; one
readback of the top ids. The query path's constants (normalization,
rel-pos indices, resize matrices, DINOv2's resized position table) are
built on the device once, so the image and the adjacency are the only
host→device copies of a query.

With ``db_capacity`` the database is padded to a fixed row capacity with
guard rows, and images are added (the same device front as a query, then
one database copy a chunk) and removed (their rows become guard rows) on
the live server. The (db, ids, norms) triple is swapped through one
attribute once the new state is complete on the device, so a query reads
either the old or the new database, never a mix. ``query_many`` runs
queries on worker threads (``PIPELINE_WORKERS``). Single device (the
sharded database waits for the multi-GPU slice).
"""

from __future__ import annotations

import dataclasses
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from revisit_anything_tpu_torch.config import (BORDA_TOPK, KNN_TOPK,
                                               RECALL_TOPK)
from revisit_anything_tpu_torch.models import dinov2 as dn
from revisit_anything_tpu_torch.models.layers import device_constant
from revisit_anything_tpu_torch.models.sam import Sam
from revisit_anything_tpu_torch.models.sam.amg import (
    AmgConfig, _decode_batch, _keep_order, _sam_preprocess_fused,
    prompt_points, resize_longest_side)
from revisit_anything_tpu_torch.models.sam.prompt import (
    dense_positional_embedding)
from revisit_anything_tpu_torch.ops.adjacency import delaunay_adjacency
from revisit_anything_tpu_torch.ops.masks import (mask_pool_matrices,
                                                  pool_masks_to_patch_grid)
from revisit_anything_tpu_torch.ops.resize import bilinear_weight_matrix
from revisit_anything_tpu_torch.pipeline.query import (DB_GUARD,
                                                       db_sq_norms,
                                                       query_segment_rows,
                                                       query_topk_images)


# The database updates make a new (db, ids) pair and leave the old one
# intact: a query in flight on another thread keeps answering from the
# state it read (JAX does not donate the database for the same reason).
# One database copy per call.

def _db_insert(db: torch.Tensor, db_ids: torch.Tensor, rows: torch.Tensor,
               cursor: int, image_id: int):
    """One image's segment rows written at ``cursor``. Guard rows in
    ``rows`` keep the image's id: they can never be retrieved."""
    n = rows.shape[0]
    db, db_ids = db.clone(), db_ids.clone()
    db[cursor:cursor + n] = rows.to(db.dtype)
    db_ids[cursor:cursor + n] = image_id
    return db, db_ids


def _compact_insert_many(db: torch.Tensor, db_ids: torch.Tensor,
                         rows: torch.Tensor, n_kept: torch.Tensor,
                         image_ids: torch.Tensor, cursor: int):
    """Batched insert: a chunk of images' row blocks compacted and written
    with one database copy.

    ``rows`` [B, kmax, dim], per image its kept rows first, then guards;
    ``n_kept`` [B]; ``image_ids`` [B]. Row j of the stacked block belongs
    to image i = searchsorted(cumsum(n_kept), j, right) at k = j − the
    exclusive cumsum; rows past the chunk's total are guard rows (the
    next insert overwrites them) and take ``image_ids[0]``, as in JAX."""
    b, kmax, dim = rows.shape
    cum = torch.cumsum(n_kept, 0)
    off = cum - n_kept
    j = torch.arange(b * kmax, device=rows.device)
    i = torch.searchsorted(cum, j, right=True)
    i_c = i.clamp(max=b - 1)
    k = j - off[i_c]
    valid = (i < b) & (k < n_kept[i_c])
    flat = i_c * kmax + torch.where(valid, k, torch.zeros_like(k))
    stacked = rows.reshape(b * kmax, dim)[flat].masked_fill(
        ~valid[:, None], DB_GUARD)
    ids = torch.where(valid, image_ids[i_c], image_ids[0])
    db, db_ids = db.clone(), db_ids.clone()
    db[cursor:cursor + b * kmax] = stacked.to(db.dtype)
    db_ids[cursor:cursor + b * kmax] = ids.to(db_ids.dtype)
    return db, db_ids


def _db_remove(db: torch.Tensor, db_ids: torch.Tensor,
               image_id: int) -> torch.Tensor:
    """An image's rows turned into guard rows (its votes drop to zero)."""
    return db.masked_fill((db_ids == image_id)[:, None], DB_GUARD)


def _select_masks_centroids(masks: torch.Tensor, iou: torch.Tensor,
                            stab: torch.Tensor, boxes: torch.Tensor,
                            valid: torch.Tensor, amg: AmgConfig, kmax: int):
    """Filter + NMS + top-``kmax`` gather, keeping masks on the device.

    Returns (masks [kmax, h, w] bool in IoU-descending NMS-keep order,
    padding rows all-false; stats [2·kmax+1] f32 = centroid (x, y) pairs
    then the kept count — one array, one readback)."""
    k_take = min(kmax, int(iou.shape[0]))
    order, n_kept = _keep_order(iou, stab, boxes, valid, amg, k_take)

    sel = masks[order]
    if k_take < kmax:
        sel = torch.nn.functional.pad(sel, (0, 0, 0, 0, 0, kmax - k_take))
    row_valid = torch.arange(kmax, device=sel.device) < n_kept
    sel = sel & row_valid[:, None, None]

    h, w = sel.shape[1], sel.shape[2]
    m = sel.float()
    total = m.sum((1, 2))
    cy = torch.einsum("khw,h->k", m, torch.arange(h, device=m.device).float())
    cx = torch.einsum("khw,w->k", m, torch.arange(w, device=m.device).float())
    denom = total.clamp(min=1.0)
    cents = torch.stack([cx / denom, cy / denom], dim=1)
    stats = torch.cat([cents.reshape(-1), n_kept.reshape(1).float()])
    return sel, stats


def _dino_desc_device(model: dn.DinoV2, cfg: dn.DinoV2Config,
                      img_u8: torch.Tensor, layer: int,
                      crop: Tuple[int, int, int, int],
                      facet: str = "value") -> torch.Tensor:
    """uint8 [H, W, 3] → L2-normalized dense descriptors [P, D] f32
    (ImageNet normalize, centre crop to patch multiples, bf16 input)."""
    top, left, hn, wn = crop
    x = img_u8.float() / 255.0
    mean = device_constant(("imagenet_mean",), x.device,
                           lambda: dn.IMAGENET_MEAN)
    std = device_constant(("imagenet_std",), x.device, lambda: dn.IMAGENET_STD)
    x = (x - mean) / std
    x = x[top:top + hn, left:left + wn][None].to(torch.bfloat16)
    d = dn.extract_dense(model, cfg, x, layer, facet)[0].float()
    return d / torch.linalg.vector_norm(d, dim=1, keepdim=True).clamp(
        min=1e-12)


@dataclasses.dataclass
class ServingIndex:
    """Prebuilt retrieval state. Arrays may be numpy or torch tensors
    (a tensor already on the serving device is used in place)."""
    centers: object                # [C, D] VLAD vocabulary
    pca_mean: object               # [C·D]
    pca_components: object         # [pca_dim, C·D]
    pca_variance: object           # [pca_dim]
    pca_whiten: bool
    db: object                     # [Nd, pca_dim] normalized db segments
    db_image_ids: object           # [Nd]
    num_ref_images: int
    order: int = 3
    db_dtype: str = "float32"

    @classmethod
    def from_npz(cls, path) -> "ServingIndex":
        """Load the build-index npz (a path or an opened np.load)."""
        z = path if hasattr(path, "files") else np.load(path)
        ids = z["db_image_ids"]
        if "num_ref_images" in z:
            n_ref = int(z["num_ref_images"])
        else:
            n_ref = int(ids.max()) + 1 if len(ids) else 0
        return cls(centers=z["centers"], pca_mean=z["pca_mean"],
                   pca_components=z["pca_components"],
                   pca_variance=z["pca_variance"],
                   pca_whiten=bool(z["pca_whiten"]), db=z["db"],
                   db_image_ids=ids, num_ref_images=n_ref,
                   order=int(z["order"]),
                   db_dtype=(str(z["db_dtype"]) if "db_dtype" in z
                             else "float32"))




# Worker threads of ``query_many`` and of ``add_reference_images``'s
# fronts by default. A query issues ~3,700 launches from Python, and the
# host, not the card, sets its pace; threads that launch at once contend
# for the interpreter's lock. On one H100 (chip_smoke.py [pipeline], 8
# full-width queries): 1 worker 11.3 queries/s, as sequential queries;
# 2 workers 10.0, 3 8.3, 4 6.0 (each on a CUDA stream of its own; on one
# shared stream 4 workers ran as fast within the runs' spread, so the
# workers share the default stream).
PIPELINE_WORKERS = 1


def _to_device(x, device, dtype=None) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    return t.to(device=device, dtype=dtype)


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class SegVLADServer:
    """Persistent online-query server for one (models, index) pair on one
    device.

    Args:
      sam, dino: the port's models (``Sam``, ``DinoV2``) on the serving
        device.
      full_hw: the dataset's query resolution (queries arrive at it).
      sam_hw: SAM extraction resolution (half of full_hw in the reference
        datasets).
      dino_layer, dino_facet: the DINOv2 block and facet the descriptors
        come from ("query", "key", "value" or "token").
      max_masks: static mask capacity; masks beyond it (post-NMS,
        IoU-descending) are dropped.
      knn_topk, borda_topk: kNN depth and Borda depth of the vote (it
        reads the top min of the two matches of each segment).
      db_capacity: database rows to allocate for incremental inserts
        (``add_reference_images``); None keeps the index as it is.
      max_ref_images: Borda bins (image ids) with ``db_capacity``; by
        default the index's images plus one per free row.
      insert_chunk: images per database copy in ``add_reference_images``.
    """

    def __init__(self, *, sam: Sam, dino: dn.DinoV2, index: ServingIndex,
                 full_hw: Tuple[int, int], sam_hw: Tuple[int, int],
                 amg: Optional[AmgConfig] = None, dino_layer: int = 31,
                 dino_facet: str = "value", max_masks: int = 128,
                 knn_topk: int = KNN_TOPK, borda_topk: int = BORDA_TOPK,
                 top_images: int = RECALL_TOPK,
                 db_capacity: Optional[int] = None,
                 max_ref_images: Optional[int] = None,
                 insert_chunk: int = 16):
        if dino_facet not in dn.FACETS:
            raise ValueError(f"dino_facet {dino_facet!r} not in {dn.FACETS}")
        self.sam = sam
        self.sam_cfg = sam.cfg
        self.dino = dino
        self.dino_cfg = dino.cfg
        self.device = sam.encoder.pos_embed.device
        dev = self.device
        self.amg = amg or AmgConfig()
        self.full_hw = tuple(full_hw)
        self.sam_hw = tuple(sam_hw)
        self.dino_layer = dino_layer
        self.dino_facet = dino_facet
        self.kmax = max_masks
        self.knn_topk = knn_topk
        self.borda_topk = borda_topk
        self.top_images = top_images
        self.order = index.order
        self.num_ref_images = int(index.num_ref_images)
        self._insert_chunk = max(1, int(insert_chunk))

        fh, fw = self.full_hw
        sh, sw = self.sam_hw
        s = self.sam_cfg.image_size
        self.input_hw = resize_longest_side(sh, sw, s)
        # composed resize matrices: full res → SAM half res → S frame
        rh = (bilinear_weight_matrix(self.input_hw[0], sh)
              @ bilinear_weight_matrix(sh, fh))
        rw = (bilinear_weight_matrix(self.input_hw[1], sw)
              @ bilinear_weight_matrix(sw, fw))
        self._rh = torch.from_numpy(rh).to(dev)
        self._rw = torch.from_numpy(rw).to(dev)

        hn, wn = (fh // 14) * 14, (fw // 14) * 14
        top, left = dn.center_crop_offsets(fh, fw, hn, wn)
        self._crop = (top, left, hn, wn)

        # AMG point grid in the S frame (apply_coords scaling), padded to
        # whole batches; padding prompts are invalid candidates
        bsz = self.amg.points_per_batch
        pts, _, valid = prompt_points(self.amg.points_per_side,
                                      self.input_hw, self.sam_hw, bsz)
        self._pts = torch.from_numpy(pts).to(dev)
        self._valid = torch.from_numpy(np.repeat(valid, 3)).to(dev)
        self._bsz = bsz

        pool_a, pool_b = mask_pool_matrices(self.sam_hw, self.full_hw)
        self._pool_a = torch.from_numpy(pool_a).to(dev)
        self._pool_b = torch.from_numpy(pool_b).to(dev)

        f32 = torch.float32
        self._centers = _to_device(index.centers, dev, f32)
        self._pca_mean = _to_device(index.pca_mean, dev, f32)
        self._pca_comps = _to_device(index.pca_components, dev, f32)
        self._pca_var = _to_device(index.pca_variance, dev, f32)
        self._whiten = bool(index.pca_whiten)
        self._db_dtype = str(index.db_dtype)
        db = _to_device(index.db, dev, getattr(torch, self._db_dtype))
        db_ids = _to_device(index.db_image_ids, dev, torch.int64)

        # incremental mode: the database padded to a fixed row capacity
        # with guard rows; inserts write at the cursor
        self._cursor = None
        if db_capacity is not None:
            n = db.shape[0]
            if db_capacity < n:
                raise ValueError(f"db_capacity {db_capacity} < existing "
                                 f"database rows {n}")
            if (max_ref_images is not None
                    and max_ref_images < index.num_ref_images):
                # ids >= max_ref_images would fall out of the vote: in the
                # database, costing kNN work, but never retrievable
                raise ValueError(
                    f"max_ref_images {max_ref_images} < the index's "
                    f"existing {index.num_ref_images} image ids")
            self._cursor = n
            self._capacity = int(db_capacity)
            self.num_ref_images = int(
                max_ref_images if max_ref_images is not None
                else index.num_ref_images + (db_capacity - n))
            self._next_image_id = int(index.num_ref_images)
            db = torch.cat([db, torch.full((db_capacity - n, db.shape[1]),
                                           DB_GUARD, dtype=db.dtype,
                                           device=dev)])
            db_ids = torch.cat([db_ids, torch.zeros(db_capacity - n,
                                                    dtype=db_ids.dtype,
                                                    device=dev)])
        # queries read (db, ids, norms) through this one attribute; inserts
        # and removals build a new triple and swap it under the lock
        self._db_state = (db, db_ids, db_sq_norms(db))
        self._mutate_lock = threading.Lock()

        with torch.inference_mode():
            self._image_pe = dense_positional_embedding(
                sam.prompt, self.sam_cfg)[0]
        self._publish()

    # ----- device stages -----

    def _amg_device(self, img_dev: torch.Tensor):
        """Image → (masks [kmax, sh, sw] bool, stats [2·kmax+1])."""
        batched = _sam_preprocess_fused(img_dev, self._rh, self._rw,
                                        self.sam_cfg.image_size)
        emb = self.sam.encoder(batched)[0]
        outs = [_decode_batch(self.sam, self.sam_cfg, emb, self._image_pe,
                              self._pts[s:s + self._bsz], self.input_hw,
                              self.sam_hw, self.amg)
                for s in range(0, self._pts.shape[0], self._bsz)]
        masks, iou, stab, boxes = (torch.cat(t) for t in zip(*outs))
        return _select_masks_centroids(masks, iou, stab, boxes, self._valid,
                                       self.amg, self.kmax)

    def _front(self, img_dev: torch.Tensor):
        """(patch_masks [kmax, P] bool, stats, desc [P, D] f32)."""
        masks, stats = self._amg_device(img_dev)
        pm = pool_masks_to_patch_grid(masks, self._pool_a, self._pool_b)
        desc = _dino_desc_device(self.dino, self.dino_cfg, img_dev,
                                 self.dino_layer, self._crop,
                                 self.dino_facet)
        return pm, stats, desc

    def _adjacency(self, stats_np: np.ndarray) -> Tuple[np.ndarray, int]:
        n = int(stats_np[-1])
        adj = np.zeros((self.kmax, self.kmax), dtype=bool)
        if n > 0 and self.order > 0:
            cents = stats_np[:2 * self.kmax].reshape(self.kmax, 2)[:n]
            adj[:n, :n] = delaunay_adjacency(cents.astype(np.float64),
                                             self.order)
        elif n > 0:
            adj[:n, :n] = np.eye(n, dtype=bool)
        return adj, n

    def _check_image(self, img: np.ndarray) -> None:
        if tuple(img.shape[:2]) != self.full_hw:
            raise ValueError(f"expected {self.full_hw}, got {img.shape[:2]}:"
                             " resize on the host first")

    def _publish(self) -> None:
        """Wait until the work queued on this thread's stream is done, so
        what it made (a new database, an image's rows) is complete before
        threads on other streams read it."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    # ----- database state -----

    @property
    def num_images(self) -> int:
        """Image ids in use (not the Borda bin capacity, which includes
        the headroom for inserts)."""
        return int(self._next_image_id if self._cursor is not None
                   else self.num_ref_images)

    @property
    def _db(self) -> torch.Tensor:
        return self._db_state[0]

    @property
    def _db_ids(self) -> torch.Tensor:
        return self._db_state[1]

    @property
    def _db_norms(self) -> torch.Tensor:
        """[Nd] f32 squared row norms, recomputed once per database swap."""
        return self._db_state[2]

    # ----- public API -----

    def query(self, img_uint8: np.ndarray) -> np.ndarray:
        """One query image (uint8 RGB at full_hw) → top image ids."""
        self._check_image(img_uint8)
        with torch.inference_mode():
            img_dev = torch.from_numpy(np.ascontiguousarray(img_uint8)).to(
                self.device)
            patch_masks, stats, desc = self._front(img_dev)
            adj, _ = self._adjacency(stats.cpu().numpy())
            # one load: a consistent triple, held until the readback below
            # has waited for every kernel that reads it
            db, db_ids, db_norms = self._db_state
            top = query_topk_images(
                desc, patch_masks, torch.from_numpy(adj).to(self.device),
                self._centers, self._pca_mean, self._pca_comps,
                self._pca_var, db, db_ids,
                num_ref_images=self.num_ref_images, knn_topk=self.knn_topk,
                borda_topk=self.borda_topk, top_images=self.top_images,
                whiten=self._whiten, db_norms=db_norms)
            return top.cpu().numpy()

    def query_many(self, imgs: Sequence[np.ndarray],
                   workers: int = PIPELINE_WORKERS) -> List[np.ndarray]:
        """Pipelined queries, answers in order: ``workers`` threads, so
        the host phases (the readbacks, the Delaunay) of one query can
        overlap the device work of the others (see ``PIPELINE_WORKERS``
        for what that gains today). Kernel launch counts are exact under
        threads (``kernels.build.Kernel.launch`` counts under a lock)."""
        for img in imgs:
            self._check_image(img)
        with ThreadPoolExecutor(max_workers=workers) as pool:
            return list(pool.map(self.query, imgs))

    # ----- incremental index updates (db_capacity mode) -----

    def _image_rows(self, img: np.ndarray):
        """One image's device front, host Delaunay and segment rows:
        (rows [kmax, dim] f32, kept rows first then guards; kept count).
        Reads no database state, so it pipelines."""
        with torch.inference_mode():
            img_dev = torch.from_numpy(np.ascontiguousarray(img)).to(
                self.device)
            pm, stats, desc = self._front(img_dev)
            adj, n_kept = self._adjacency(stats.cpu().numpy())
            rows, _ = query_segment_rows(
                desc, pm, torch.from_numpy(adj).to(self.device),
                self._centers, self._pca_mean, self._pca_comps,
                self._pca_var, whiten=self._whiten)
            self._publish()
        return rows, n_kept

    def add_reference_images(self,
                             imgs: Sequence[np.ndarray]) -> List[int]:
        """Extract and insert new database images on the live server (no
        rebuild): each runs the query's device front (on
        ``PIPELINE_WORKERS`` threads); each chunk of ``insert_chunk``
        images is compacted and written with one database copy and one
        state swap. Queries in flight keep answering from the state they
        read. Returns the assigned image ids. Requires ``db_capacity``."""
        if self._cursor is None:
            raise ValueError("incremental inserts need SegVLADServer("
                             "db_capacity=...)")
        for img in imgs:
            self._check_image(img)
        ids: List[int] = []
        # inserts serialize: two unsynchronized cursor updates would write
        # the same row block
        with self._mutate_lock:
            pos = 0
            while pos < len(imgs):
                room = (self._capacity - self._cursor) // self.kmax
                if room < 1:
                    raise RuntimeError(
                        f"serving index capacity exhausted "
                        f"({self._cursor}+{self.kmax} > {self._capacity})")
                room = min(room, self.num_ref_images - self._next_image_id)
                if room < 1:
                    raise RuntimeError("image-id (Borda bin) capacity "
                                       "exhausted: raise max_ref_images")
                chunk = imgs[pos:pos + min(room, self._insert_chunk)]
                with ThreadPoolExecutor(PIPELINE_WORKERS) as pool:
                    prepped = list(pool.map(self._image_rows, chunk))
                kept = [k for _, k in prepped]
                chunk_ids = list(range(self._next_image_id,
                                       self._next_image_id + len(chunk)))
                with torch.inference_mode():
                    db, db_ids = _compact_insert_many(
                        self._db, self._db_ids,
                        torch.stack([r for r, _ in prepped]),
                        torch.tensor(kept, device=self.device),
                        torch.tensor(chunk_ids, device=self.device),
                        self._cursor)
                    state = (db, db_ids, db_sq_norms(db))
                    self._publish()
                # one swap: queries see the old or the new triple
                self._db_state = state
                self._cursor += sum(kept)
                ids.extend(chunk_ids)
                self._next_image_id += len(chunk)
                pos += len(chunk)
        return ids

    def remove_reference_image(self, image_id: int) -> None:
        """Drop a database image from retrieval: its rows become guard
        rows (zero votes, never in any top-k). Rows are not reclaimed:
        capacity is append-only; rebuild the index to compact."""
        if self._cursor is None:
            raise ValueError("incremental removal needs SegVLADServer("
                             "db_capacity=...)")
        with self._mutate_lock:
            with torch.inference_mode():
                db = _db_remove(self._db, self._db_ids, image_id)
                state = (db, self._db_ids, db_sq_norms(db))
                self._publish()
            self._db_state = state

    def snapshot_index(self, path: Optional[str] = None,
                       image_keys: Optional[Sequence[str]] = None
                       ) -> ServingIndex:
        """The current database, inserts and removals included, as a
        ``ServingIndex`` of numpy arrays (compacted: guard rows dropped).
        With ``path``, also writes the npz that ``ServingIndex.from_npz``
        of either package and the query CLI read. ``image_keys``: display
        names by image id, ``image_<id>`` by default."""
        with self._mutate_lock:
            db_dev, ids_dev = self._db_state[:2]
            n = (self._cursor if self._cursor is not None
                 else ids_dev.shape[0])
            db = _numpy(db_dev[:n].float())
            db_ids = _numpy(ids_dev[:n]).astype(np.int32)
            # the true image-id bound, not the Borda bins: persisting the
            # headroom would grow it on every snapshot/restore cycle
            n_images = self.num_images
        live = np.all(db < DB_GUARD / 2, axis=1)
        db, db_ids = db[live], db_ids[live]
        idx = ServingIndex(
            centers=_numpy(self._centers), pca_mean=_numpy(self._pca_mean),
            pca_components=_numpy(self._pca_comps),
            pca_variance=_numpy(self._pca_var), pca_whiten=self._whiten,
            db=db, db_image_ids=db_ids, num_ref_images=n_images,
            order=self.order, db_dtype=self._db_dtype)
        if path is not None:
            if image_keys is None:
                image_keys = [f"image_{i}" for i in range(n_images)]
            # rows persist as f32; db_dtype keeps the device storage choice.
            # Not compressed: unit-norm f32 rows do not shrink, and
            # compressing them is slow; np.load reads either form.
            np.savez(
                path, db=db, db_dtype=np.asarray(self._db_dtype),
                db_image_ids=db_ids,
                image_keys=np.asarray(list(image_keys), dtype=str),
                num_ref_images=np.asarray(n_images),
                centers=idx.centers, pca_mean=idx.pca_mean,
                pca_components=idx.pca_components,
                pca_variance=idx.pca_variance,
                pca_whiten=np.asarray(bool(idx.pca_whiten)),
                order=np.asarray(self.order),
                mask_h=np.asarray(self.sam_hw[0]),
                mask_w=np.asarray(self.sam_hw[1]),
                dino_h=np.asarray(self.full_hw[0]),
                dino_w=np.asarray(self.full_hw[1]))
        return idx
