"""Command-line pipeline driver: the reference's stage scripts as one CLI,
on the port.

    python -m revisit_anything_tpu_torch extract --dataset D --method SAM|DINO
        (= place_rec_SAM_DINO.py)
    python -m revisit_anything_tpu_torch vocab --dataset D --domain indoor
        (= vlad_c_centers_pt_gen.py)
    python -m revisit_anything_tpu_torch pca --dataset D --experiment E
        (= place_rec_pca.py)
    python -m revisit_anything_tpu_torch evaluate --dataset D --experiment E
        --vocab-vlad domain|map [--save-results]
        (= place_rec_main.py)
    ... amg | build-index | query | serve | train | add-pca | evaluate-global

Counterpart of ``revisit_anything_tpu/cli.py``: the same eleven commands,
flag for flag, plus ``--device`` (default ``cuda``; the CPU only when
asked, ``--device cpu``: a missing card is an error, never a reason to
run on the CPU). Each command calls the port's library. Every model runs
in f32, the JAX CLI's dtype, on the card as on the CPU (SAM's kernels on
the default decoder path have f32 forms). Without a checkpoint flag the
weights are seeded random (``weights.init_*``: SAM from seed 0, DINOv2
from seed 1, as the JAX CLI takes ``PRNGKey(0)`` / ``PRNGKey(1)``; the
draws themselves differ).

Stage artifacts (h5/pt/npz/pkl) live under --workdir with the reference's
filenames. The h5 commands (``extract``, ``vocab``, ``pca``,
``evaluate``, ``build-index``) need ``h5py``, which the card's machine
lacks. The JAX CLI's TPU pieces are not carried over: parameter packing
(``pack_host`` / ``packed_init``), the compile cache and the
``jax.profiler`` plumbing (``--trace-dir`` writes a ``torch.profiler``
trace instead).
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import sys

import numpy as np
import torch

SAM_VARIANTS = ["vit_h", "vit_l", "vit_b"]
DINO_MODELS = ["dinov2_vitg14", "dinov2_vitl14", "dinov2_vitb14",
               "dinov2_vits14"]


def _add_common(p, dataset_required=True):
    p.add_argument("--dataset", required=dataset_required, default=None)
    p.add_argument("--workdir", default=os.environ.get("RAT_WORKDIR",
                                                       "./workdir"))
    p.add_argument("--data-root", default=os.environ.get("RAT_DATA_ROOT",
                                                         "./data"))


def _add_device(p):
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda; cpu only "
                        "when asked)")


def _device(args) -> torch.device:
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device here "
                         "(pass --device cpu to run on the CPU)")
    return dev


def _gen(dev: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(seed)


def _sam(cfg, checkpoint, dev, seed=0):
    from revisit_anything_tpu_torch.models.sam.convert import (
        load_sam_checkpoint)
    from revisit_anything_tpu_torch.weights import init_sam
    if checkpoint:
        return load_sam_checkpoint(checkpoint, cfg, dtype=torch.float32,
                                   device=dev)
    return init_sam(cfg, _gen(dev, seed), dev, torch.float32)


def _dino(cfg, checkpoint, dev, seed=1, dtype=None):
    from revisit_anything_tpu_torch.models import dinov2 as dn
    from revisit_anything_tpu_torch.weights import init_dino
    dtype = dtype or torch.float32
    if checkpoint:
        return dn.load_checkpoint(checkpoint, cfg, dtype=dtype, device=dev)
    return init_dino(cfg, _gen(dev, seed), dev, dtype)


def cmd_extract(args):
    from revisit_anything_tpu_torch.config import get_dataset
    from revisit_anything_tpu_torch.datasets.images import (
        list_dataset_images)
    from revisit_anything_tpu_torch.models import dinov2 as dn
    from revisit_anything_tpu_torch.models.sam import SAM_REGISTRY
    from revisit_anything_tpu_torch.pipeline.extract import (
        extract_dino_features, extract_sam_masks)

    ds = get_dataset(args.dataset)
    dev = _device(args)
    refs, queries = list_dataset_images(ds, args.data_root)
    os.makedirs(args.workdir, exist_ok=True)
    if getattr(args, "multihost", False):
        # one process a host (or card): each owns a contiguous shard of the
        # image lists and writes .part<rank> files, merged offline; a mesh
        # of its local cards splits each batch further
        from revisit_anything_tpu_torch.parallel import (
            host_shard, initialize_multihost, process_info)
        initialize_multihost()
        refs = refs[host_shard(len(refs))]
        queries = queries[host_shard(len(queries))]
        rank, world = process_info()[:2]
        print(f"multihost: process {rank}/{world}, {len(refs)} refs / "
              f"{len(queries)} queries on this host")
        shard_suffix = f".part{rank}"
    else:
        shard_suffix = ""
    sets = {"r": refs, "q": queries}

    def _skip(out_path):
        if os.path.exists(out_path) and not args.force:
            print(f"exists, skipping (use --force to redo): {out_path}")
            return True
        return False

    def outputs(name_r, name_q):
        for tag, paths in sets.items():
            out = os.path.join(args.workdir,
                               (name_r if tag == "r" else name_q)
                               + shard_suffix)
            if not _skip(out):
                yield paths, [os.path.basename(p) for p in paths], out

    if args.method == "SAM":
        if not args.checkpoint:
            print("WARNING: no --checkpoint; using random SAM weights",
                  file=sys.stderr)
        sam = _sam(SAM_REGISTRY[args.sam_variant], args.checkpoint, dev)
        for paths, keys, out in outputs(ds.masks_h5_ref, ds.masks_h5_query):
            extract_sam_masks(paths, keys, out, sam, ds.sam_size.hw)
            print(f"wrote {out}")
        from revisit_anything_tpu_torch.utils.profiling import stage_timer
        print(stage_timer().report())
    elif args.method == "DINONV":
        # SegVLAD-FineT backbone extraction (place_rec_DINO_finetuned.py):
        # DINOv2-B + NetVLAD checkpoint, 768-d dense features, full res
        from revisit_anything_tpu_torch.pipeline.extract import (
            extract_dinonv_features_to_h5)
        from revisit_anything_tpu_torch.training.vladbuff import (
            load_vladbuff_checkpoint)
        if not args.checkpoint:
            raise SystemExit("--method DINONV requires --checkpoint "
                             "(DnV2_NV/last.ckpt)")
        cfg = dn.VIT_B14
        model = load_vladbuff_checkpoint(args.checkpoint, cfg, device=dev)
        for paths, keys, out in outputs(ds.dino_nv_h5_ref,
                                        ds.dino_nv_h5_query):
            extract_dinonv_features_to_h5(paths, keys, out, model, cfg,
                                          ds.size.hw)
            print(f"wrote {out}")
    elif args.method == "DINOSALAD":
        # DINO-SALAD backbone extraction: channel-normalized 768-d dense
        # features
        from revisit_anything_tpu_torch.pipeline.extract import (
            extract_dinosalad_features_to_h5)
        from revisit_anything_tpu_torch.training.vladbuff import (
            load_dinosalad_checkpoint)
        if not args.checkpoint:
            raise SystemExit("--method DINOSALAD requires --checkpoint "
                             "(dino_salad.ckpt)")
        cfg = dn.VIT_B14
        model = load_dinosalad_checkpoint(args.checkpoint, cfg, device=dev)
        for paths, keys, out in outputs(
                ds.dino_nv_h5_ref.replace("dinoNV", "dinoSALAD"),
                ds.dino_nv_h5_query.replace("dinoNV", "dinoSALAD")):
            extract_dinosalad_features_to_h5(paths, keys, out, model, cfg,
                                             ds.size.hw)
            print(f"wrote {out}")
    elif args.method == "DINOV1":
        # the legacy DINOv1 collection flow (DINO/collect_dino_features.py
        # :32-109): stride-patched ViT facet features at layer 11, f32
        from revisit_anything_tpu_torch.models import dinov1 as d1
        from revisit_anything_tpu_torch.pipeline.extract import (
            extract_dinov1_features_to_h5)
        cfg = d1.CONFIGS[args.dinov1_model]
        if args.checkpoint:
            model = d1.load_checkpoint(args.checkpoint, cfg, device=dev)
        else:
            print("WARNING: no --checkpoint; using random DINOv1 weights",
                  file=sys.stderr)
            model = _dino(cfg, None, dev, seed=0, dtype=torch.float32)
        # None defaults = the method's own; an explicit flag always wins
        layer = args.layer if args.layer is not None else 11
        facet = args.facet if args.facet is not None else "key"
        for paths, keys, out in outputs(
                ds.dino_h5_ref.replace("dino", "dinoV1"),
                ds.dino_h5_query.replace("dino", "dinoV1")):
            extract_dinov1_features_to_h5(
                paths, keys, out, model, cfg, ds.size.hw,
                stride=args.dino_stride, layer=layer, facet=facet,
                binned=args.dinov1_binned, upsample=args.dinov1_upsample)
            print(f"wrote {out}")
    elif args.method == "DINO":
        if not args.checkpoint:
            print("WARNING: no --checkpoint; using random DINO weights",
                  file=sys.stderr)
        dino = _dino(dn.CONFIGS[args.dino_model], args.checkpoint, dev,
                     seed=0)
        for paths, keys, out in outputs(ds.dino_h5_ref, ds.dino_h5_query):
            extract_dino_features(
                paths, keys, out, dino, ds.size.hw,
                layer=args.layer if args.layer is not None else 31,
                facet=args.facet if args.facet is not None else "value")
            print(f"wrote {out}")
    else:
        raise SystemExit(f"unknown method {args.method}")


def _image_keys(h5_path):
    from revisit_anything_tpu_torch.io.h5io import list_image_keys, open_h5
    with open_h5(h5_path) as f:
        return list_image_keys(f)


def cmd_vocab(args):
    from revisit_anything_tpu_torch.config import WorkdirConfig, get_dataset
    from revisit_anything_tpu_torch.io.vocab import save_cluster_centers
    from revisit_anything_tpu_torch.pipeline.vocabulary import (
        fit_vocabulary_from_h5)

    ds = get_dataset(args.dataset)
    dev = _device(args)
    dino_name = ds.dino_nv_h5_ref if args.finetuned else ds.dino_h5_ref
    dino_h5 = os.path.join(args.workdir, dino_name)
    centers = fit_vocabulary_from_h5(dino_h5, _image_keys(dino_h5),
                                     num_clusters=args.clusters, device=dev)
    vocab_id = args.domain or ds.map_vlad_cluster
    out = WorkdirConfig(cache_root=args.cache_root).vocab_path(
        vocab_id, finetuned=args.finetuned)
    save_cluster_centers(out, centers)
    print(f"wrote {out} {centers.shape}")


def _load_banks(args, exp, ds, centers, dev):
    from revisit_anything_tpu_torch.pipeline.aggregate import (
        compute_segment_vlads)

    finetuned = getattr(args, "finetuned", False)
    dino_r = ds.dino_nv_h5_ref if finetuned else ds.dino_h5_ref
    dino_q = ds.dino_nv_h5_query if finetuned else ds.dino_h5_query
    banks = {}
    for tag, masks_name, dino_name in (
            ("r", ds.masks_h5_ref, dino_r),
            ("q", ds.masks_h5_query, dino_q)):
        masks_h5 = os.path.join(args.workdir, masks_name)
        dino_h5 = os.path.join(args.workdir, dino_name)
        keys = _image_keys(dino_h5)
        banks[tag] = (compute_segment_vlads(
            masks_h5, dino_h5, keys, centers, exp.order, ds.sam_size.hw,
            ds.size.hw, device=dev), keys)
    return banks


def _load_centers(args, ds):
    from revisit_anything_tpu_torch.config import WorkdirConfig
    from revisit_anything_tpu_torch.io.vocab import load_cluster_centers
    vocab_id = ds.vocab_id(args.vocab_vlad)
    path = WorkdirConfig(cache_root=args.cache_root).vocab_path(
        vocab_id, finetuned=getattr(args, "finetuned", False))
    return load_cluster_centers(path)


def _pca_paths(args, exp):
    """(reference pkl path, npz path) of the experiment's PCA model: one
    naming rule for ``pca``, ``evaluate`` and ``build-index``."""
    suffix = (exp.pca_model_pkl if args.vocab_vlad == "domain"
              else exp.pca_model_pkl_map) or f"_pca_order{exp.order}.pkl"
    pkl = os.path.join(args.workdir, f"{args.dataset}{suffix}")
    return pkl, pkl + ".npz"


def _load_pca(args, exp, dev):
    """The npz when there is one, else the reference's sklearn pickle."""
    from revisit_anything_tpu_torch.ops.pca import (load_pca_npz,
                                                    load_sklearn_pca_pickle)
    pkl, npz = _pca_paths(args, exp)
    return (load_pca_npz(npz, device=dev) if os.path.exists(npz)
            else load_sklearn_pca_pickle(pkl, device=dev))


def cmd_pca(args):
    from revisit_anything_tpu_torch.config import get_dataset, get_experiment
    from revisit_anything_tpu_torch.ops.pca import save_pca_npz
    from revisit_anything_tpu_torch.pipeline.vocabulary import (
        fit_pca_from_vlads)

    ds = get_dataset(args.dataset)
    exp = get_experiment(args.experiment)
    dev = _device(args)
    centers = _load_centers(args, ds)
    banks = _load_banks(args, exp, ds, centers, dev)
    params = fit_pca_from_vlads(banks["r"][0], num_components=args.dim,
                                device=dev)
    _, out = _pca_paths(args, exp)
    save_pca_npz(out, params)
    print(f"wrote {out}")


def cmd_evaluate(args):
    from revisit_anything_tpu_torch.utils.profiling import trace
    with trace(args.trace_dir):
        _cmd_evaluate(args)


def _cmd_evaluate(args):
    from revisit_anything_tpu_torch.config import get_dataset, get_experiment
    from revisit_anything_tpu_torch.datasets import get_gt
    from revisit_anything_tpu_torch.datasets.images import (
        list_dataset_images)
    from revisit_anything_tpu_torch.pipeline.aggregate import (
        global_vlads_from_h5)
    from revisit_anything_tpu_torch.pipeline.evaluate import (
        run_anyloc_retrieval, run_segloc_retrieval)
    from revisit_anything_tpu_torch.utils.profiling import stage_timer

    ds = get_dataset(args.dataset)
    exp = get_experiment(args.experiment)
    dev = _device(args)
    centers = _load_centers(args, ds)

    try:
        refs, queries = list_dataset_images(ds, args.data_root)
    except FileNotFoundError:
        refs = queries = None
    gt = get_gt(args.dataset, args.data_root, refs, queries)

    # the gt check comes before the aggregation: recalls against a
    # missing gt would read as an all-zero regression after minutes of
    # compute
    if gt is None:
        raise SystemExit("gt unavailable; cannot evaluate")
    if exp.global_method == "AnyLoc":
        vlads = {}
        for tag, dino_name in (("r", ds.dino_h5_ref),
                               ("q", ds.dino_h5_query)):
            path = os.path.join(args.workdir, dino_name)
            vlads[tag] = global_vlads_from_h5(path, _image_keys(path),
                                              centers, device=dev)
        res = run_anyloc_retrieval(vlads["r"], vlads["q"], gt, device=dev)
    else:
        banks = _load_banks(args, exp, ds, centers, dev)
        pca = _load_pca(args, exp, dev) if exp.pca else None
        res = run_segloc_retrieval(banks["r"][0], banks["q"][0], gt,
                                   pca=pca, device=dev)

    print("Recall@1..5:", res.recalls)
    if res.one_percent_recall is not None:
        print("1%-recall:", res.one_percent_recall)
    print(stage_timer().report())
    if args.save_results:
        out_dir = os.path.join(args.workdir, "results", "global",
                               f"{args.experiment}_{args.dataset}")
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "results.pkl"), "wb") as f:
            payload = {"recalls": res.recalls, "sims": res.sims,
                       "matches": res.matches,
                       "predictions": res.predictions}
            if args.save_descriptors and exp.global_method == "SegLoc":
                # the reference's segFtVLAD1/2 pickles (place_rec_main.py
                # :292-305, :357-370)
                payload["segFtVLAD1"] = banks["r"][0].descriptors
                payload["segFtVLAD2"] = banks["q"][0].descriptors
                payload["imInds1"] = banks["r"][0].image_indices
                payload["imInds2"] = banks["q"][0].image_indices
            pickle.dump(payload, f)
        with open(os.path.join(out_dir, "recalls.json"), "w") as f:
            json.dump({"recalls": res.recalls}, f)
        print(f"results saved to {out_dir}")


def cmd_train(args):
    """VPR metric-learning training (the VLAD-BuFF train.py equivalent):
    GSV-Cities-style places → DINOv2 backbone + NetVLAD-AntiBurst →
    MultiSimilarity loss, on the port's trainer (f32; ``torch.save``
    checkpoints)."""
    from revisit_anything_tpu_torch.models import dinov2 as dn
    from revisit_anything_tpu_torch.training.checkpoint import (
        latest_checkpoint, restore_train_state, save_best_state,
        save_train_state)
    from revisit_anything_tpu_torch.training.data import (PlacesBatcher,
                                                          discover_places,
                                                          discover_places_gsv,
                                                          prefetch)
    from revisit_anything_tpu_torch.training.train import (
        VPRTrainConfig, create_train_state, train_step)
    from revisit_anything_tpu_torch.training.validation import (
        ValidationSet, run_validation)

    dev = _device(args)
    if (args.lr_sched == "multistep" and args.steps_per_epoch == 0
            and max(args.milestones) < 1000):
        # the reference steps its scheduler every batch (VLAD-BuFF
        # vpr_model.py:230-233 overrides optimizer_step)
        print("WARNING: multistep milestones are in STEPS (the reference "
              "steps its scheduler per batch — vpr_model.py:233 overrides "
              "optimizer_step); "
              f"milestones {args.milestones} will decay the LR within the "
              "first steps — set --steps-per-epoch to use epoch units",
              file=sys.stderr)
    cfg = VPRTrainConfig(backbone=dn.CONFIGS[args.backbone],
                         num_trainable_blocks=args.num_trainable_blocks,
                         clusters=args.clusters,
                         antiburst=not args.no_antiburst,
                         lr=args.lr, total_steps=args.steps,
                         warmup_steps=max(1, args.steps // 20),
                         imgs_per_place=args.img_per_place,
                         optimizer=args.optimizer,
                         lr_sched=args.lr_sched,
                         milestones=tuple(args.milestones),
                         gamma=args.gamma, momentum=args.momentum,
                         steps_per_epoch=args.steps_per_epoch,
                         cosine_t_max=args.cosine_t_max)
    state = create_train_state(cfg, seed=args.seed, device=dev)

    ckpt = latest_checkpoint(args.ckpt_dir)
    if ckpt and args.resume:
        restore_train_state(ckpt, state)
        print(f"resumed from {ckpt} at step {state.step}")

    if os.path.isdir(os.path.join(args.train_root, "Dataframes")):
        # GSV-Cities as distributed: per-city DataFrame CSVs + flat
        # Images/ folders (GSVCitiesDataset.py:57-100)
        places = discover_places_gsv(
            args.train_root, cities=args.cities or None,
            min_img_per_place=args.img_per_place)
    else:
        places = discover_places(args.train_root,
                                 min_images=args.img_per_place)
    print(f"{len(places)} places")
    batcher = PlacesBatcher(places, image_hw=tuple(args.image_size),
                            places_per_batch=args.batch_places,
                            img_per_place=args.img_per_place,
                            seed=args.seed)

    val_set = None
    if args.val_root:
        val_set = ValidationSet.from_directory(
            args.val_root, image_hw=tuple(args.image_size))
        print(f"validation set {val_set.name}: {len(val_set.ref_paths)} "
              f"refs / {len(val_set.query_paths)} queries")

    def log(record):
        if args.log_file:
            with open(args.log_file, "a") as lf:
                lf.write(json.dumps(record) + "\n")

    def maybe_validate(s):
        """Held-out recalls, and the best-R1 checkpoint (the
        pitts30k_val/R1 monitor, VLAD-BuFF train.py:383-392)."""
        recalls = run_validation(state.model, cfg, val_set)
        log({"step": s, **{f"{val_set.name}/R{k}": v
                           for k, v in recalls.items()}})
        best = save_best_state(args.ckpt_dir, state, recalls[1],
                               f"{val_set.name}/R1")
        if best:
            print(f"best checkpoint ({val_set.name}/R1="
                  f"{recalls[1]:.4f}): {best}")

    done = False
    while not done:
        for images, labels in prefetch(iter(batcher)):
            loss = float(train_step(state, cfg, torch.from_numpy(images),
                                    torch.from_numpy(labels)))
            s = state.step
            if s % args.log_every == 0:
                print(f"step {s}: loss {loss:.4f}", flush=True)
                log({"step": s, "loss": loss})
            if val_set is not None and (s % args.val_every == 0
                                        or s >= args.steps):
                maybe_validate(s)
            if s % args.ckpt_every == 0 or s >= args.steps:
                path = save_train_state(args.ckpt_dir, state)
                print(f"checkpoint: {path}")
            if s >= args.steps:
                done = True
                break


def _global_descriptors(paths, desc_fn, model, cfg, hw, batch_size, dev):
    """Whole-image descriptors of images resized to ``hw`` (cv2 bilinear),
    ``batch_size`` a forward → [N, dim] f32 on ``dev``."""
    from revisit_anything_tpu_torch.models import dinov2 as dn
    from revisit_anything_tpu_torch.pipeline.extract import (
        _resize_cv2_bilinear, load_image_rgb)
    out = []
    for s in range(0, len(paths), batch_size):
        imgs = np.stack([
            _resize_cv2_bilinear(load_image_rgb(p), (hw[1], hw[0]))
            for p in paths[s:s + batch_size]])
        x = torch.from_numpy(dn.preprocess(imgs)).to(dev)
        with torch.inference_mode():
            out.append(desc_fn(model, cfg, x).float())
    return torch.cat(out)


def cmd_add_pca(args):
    """Bake whitened PCA into a VLAD-BuFF checkpoint (the add_pca.py flow,
    add_pca.py:389-600): global descriptors over a sample image set, one
    fit at the largest --num-pcs, one ``wpca{n}`` tree a count."""
    import glob as globmod

    from revisit_anything_tpu_torch.models import dinov2 as dn
    from revisit_anything_tpu_torch.models.layers import tree_module
    from revisit_anything_tpu_torch.training.vladbuff import (
        fit_wpca, global_descriptor, load_vladbuff_checkpoint,
        load_vladbuff_params, save_vladbuff_params)

    dev = _device(args)
    cfg = dn.CONFIGS[args.backbone]
    model = (load_vladbuff_params(args.checkpoint, cfg, device=dev)
             if args.checkpoint.endswith(".npy")
             else load_vladbuff_checkpoint(args.checkpoint, cfg, device=dev))
    if hasattr(model, "wpca"):
        del model.wpca            # fit on the raw descriptor space

    paths = sorted(globmod.glob(os.path.join(args.images_root, "**", "*"),
                                recursive=True))
    paths = [p for p in paths
             if p.lower().endswith((".jpg", ".jpeg", ".png"))]
    paths = paths[:args.num_samples]
    if not paths:
        raise SystemExit(f"no images under {args.images_root}")
    descs = _global_descriptors(paths, global_descriptor, model, cfg,
                                tuple(args.image_size), args.batch_size, dev)
    print(f"fitted on {len(descs)} descriptors of dim {descs.shape[1]}")

    # one eigendecomposition at the largest count, sliced per count (the
    # reference's current_u = u[:, :n], add_pca.py:546-578): each
    # component's whitening scale is its own eigenvalue
    wpca_full = fit_wpca(descs, max(args.num_pcs))
    for n in sorted(args.num_pcs):
        model.add_module("wpca", tree_module(
            {"w": wpca_full["w"][:n], "b": wpca_full["b"][:n]}, device=dev))
        out = args.out_template.format(n=n)
        save_vladbuff_params(out, model)
        print(f"wpca{n}: {out}")


def cmd_evaluate_global(args):
    """Whole-image descriptor benchmark (the VLAD-BuFF eval.py
    equivalent): VLAD-BuFF / DINO-SALAD global descriptors + validation
    recalls."""
    from revisit_anything_tpu_torch.config import get_dataset
    from revisit_anything_tpu_torch.datasets import get_gt
    from revisit_anything_tpu_torch.datasets.images import (
        list_dataset_images)
    from revisit_anything_tpu_torch.models import dinov2 as dn
    from revisit_anything_tpu_torch.retrieval.analysis import (
        get_validation_recalls)
    from revisit_anything_tpu_torch.training.vladbuff import (
        global_descriptor, load_dinosalad_checkpoint,
        load_vladbuff_checkpoint, salad_global_descriptor)

    dev = _device(args)
    if getattr(args, "benchmark", None):
        # VLAD-BuFF eval.py benchmark sets (npy image lists + gt)
        from revisit_anything_tpu_torch.datasets.vladbuff_val import (
            load_msls_val, load_vladbuff_val)
        vs = (load_msls_val(args.gt_root) if args.benchmark == "msls_val"
              else load_vladbuff_val(args.benchmark, args.gt_root))
        refs = [os.path.join(args.data_root, p) for p in vs.db_images]
        queries = [os.path.join(args.data_root, p) for p in vs.q_images]
        gt = vs.ground_truth
        if gt is None:
            raise SystemExit(f"{args.benchmark} has no public ground truth")
        hw = tuple(args.image_size)
    else:
        if not args.dataset:
            raise SystemExit("evaluate-global needs --dataset or "
                             "--benchmark")
        ds = get_dataset(args.dataset)
        refs, queries = list_dataset_images(ds, args.data_root)
        gt = get_gt(args.dataset, args.data_root, refs, queries)
        hw = ds.size.hw
        if gt is None:
            raise SystemExit("no ground truth for this dataset")

    cfg = dn.VIT_B14
    if args.model == "vladbuff":
        model = load_vladbuff_checkpoint(args.checkpoint, cfg, device=dev)
        desc_fn = global_descriptor
    else:
        model = load_dinosalad_checkpoint(args.checkpoint, cfg, device=dev)
        desc_fn = salad_global_descriptor
    db = _global_descriptors(refs, desc_fn, model, cfg, hw, args.batch_size,
                             dev)
    q = _global_descriptors(queries, desc_fn, model, cfg, hw,
                            args.batch_size, dev)
    get_validation_recalls(db, q, gt,
                           dataset_name=getattr(args, "benchmark", None)
                           or args.dataset)


def _points_per_batch(args, dev) -> int:
    """--points-per-batch, by default the whole 1024-point grid in one
    decode on the card (the shape the decode kernels serve) and the
    reference's 64 on the CPU (automatic_mask_generator.py:62), where the
    plain decoder holds ~4 MiB of intermediates a prompt."""
    if args.points_per_batch is not None:
        return args.points_per_batch
    return 1024 if dev.type == "cuda" else 64


def _amg_config(args, dev, **extra):
    from revisit_anything_tpu_torch.models.sam.amg import AmgConfig
    return AmgConfig(points_per_side=args.points_per_side,
                     points_per_batch=_points_per_batch(args, dev),
                     pred_iou_thresh=args.pred_iou_thresh,
                     stability_score_thresh=args.stability_score_thresh,
                     **extra)


def cmd_amg(args):
    """Standalone automatic mask generation over an image or a directory
    (the reference's sam/scripts/amg.py): per image, one folder with
    <i>.png binary masks and a metadata.csv of the record fields."""
    from PIL import Image

    from revisit_anything_tpu_torch.models.sam import SAM_REGISTRY
    from revisit_anything_tpu_torch.models.sam.amg import generate_masks
    from revisit_anything_tpu_torch.pipeline.extract import load_image_rgb

    dev = _device(args)
    if not args.checkpoint:
        print("WARNING: no --checkpoint; using random SAM weights",
              file=sys.stderr)
    sam = _sam(SAM_REGISTRY[args.model_type], args.checkpoint, dev)
    amg = _amg_config(args, dev, box_nms_thresh=args.box_nms_thresh,
                      crop_n_layers=args.crop_n_layers,
                      crop_nms_thresh=args.crop_nms_thresh,
                      min_mask_region_area=args.min_mask_region_area)

    if os.path.isdir(args.input):
        targets = [os.path.join(args.input, f)
                   for f in sorted(os.listdir(args.input))
                   if os.path.isfile(os.path.join(args.input, f))]
    else:
        targets = [args.input]
    os.makedirs(args.output, exist_ok=True)

    header = ("id,area,bbox_x0,bbox_y0,bbox_w,bbox_h,point_input_x,"
              "point_input_y,predicted_iou,stability_score,crop_box_x0,"
              "crop_box_y0,crop_box_w,crop_box_h")
    for t in targets:
        try:
            image = load_image_rgb(t)
        except OSError:
            print(f"Could not load '{t}' as an image, skipping...")
            continue
        print(f"Processing '{t}'...")
        records = generate_masks(sam, image, amg)
        base = os.path.splitext(os.path.basename(t))[0]
        out = os.path.join(args.output, base)
        os.makedirs(out, exist_ok=True)
        rows = [header]
        for i, r in enumerate(records):
            Image.fromarray((r.segmentation * 255).astype(np.uint8)).save(
                os.path.join(out, f"{i}.png"))
            cb = r.crop_box                       # XYWH
            rows.append(",".join(map(str, [
                i, r.area, *r.bbox,
                float(r.point_coords[0, 0]), float(r.point_coords[0, 1]),
                r.predicted_iou, r.stability_score,
                cb[0], cb[1], cb[2], cb[3]])))
        with open(os.path.join(out, "metadata.csv"), "w") as f:
            f.write("\n".join(rows))
        print(f"{len(records)} masks -> {out}")


def cmd_build_index(args):
    """Build a serving index: PCA-projected, row-normalized database
    segment descriptors + image ids + the vocabulary and PCA, in one npz
    that ``query`` and ``serve`` read."""
    from revisit_anything_tpu_torch.config import get_dataset, get_experiment
    from revisit_anything_tpu_torch.pipeline.evaluate import (
        _normalize_rows, apply_pca_in_batches)

    ds = get_dataset(args.dataset)
    exp = get_experiment(args.experiment)
    dev = _device(args)
    centers = _load_centers(args, ds)
    banks = _load_banks(args, exp, ds, centers, dev)
    bank = banks["r"][0]
    pca = _load_pca(args, exp, dev)
    db = _normalize_rows(apply_pca_in_batches(bank, pca).descriptors)
    np.savez_compressed(
        args.output,
        db=db.astype(np.float32),
        db_dtype=np.asarray(args.db_dtype),
        db_image_ids=bank.image_indices,
        image_keys=np.asarray(banks["r"][1]),
        centers=centers,
        pca_mean=pca.mean.cpu().numpy(),
        pca_components=pca.components.cpu().numpy(),
        pca_variance=pca.explained_variance.cpu().numpy(),
        pca_whiten=np.asarray(bool(pca.whiten)),
        order=np.asarray(exp.order),
        mask_h=np.asarray(ds.sam_size.height),
        mask_w=np.asarray(ds.sam_size.width),
        dino_h=np.asarray(ds.size.height),
        dino_w=np.asarray(ds.size.width))
    print(f"wrote {args.output}: {db.shape[0]} segments / "
          f"{int(bank.image_indices.max()) + 1} images")


def _build_server(args, db_capacity=None):
    """SegVLADServer from a build-index npz and the model flags (shared by
    the one-shot ``query`` and the persistent ``serve``): the checkpoint
    readers for a ``--*-checkpoint`` flag, seeded weights otherwise.
    Returns (server, image_keys, dino_hw)."""
    from revisit_anything_tpu_torch.models import dinov2 as dn
    from revisit_anything_tpu_torch.models.sam import SAM_REGISTRY
    from revisit_anything_tpu_torch.pipeline.serve import (SegVLADServer,
                                                           ServingIndex)

    dev = _device(args)
    z = np.load(args.index)
    index = ServingIndex.from_npz(z)       # one read of the npz
    sam_cfg = SAM_REGISTRY[args.sam_variant]
    dino_cfg = dn.CONFIGS[args.dino_model]
    if args.layer >= dino_cfg.depth:
        raise SystemExit(f"--layer {args.layer} out of range for "
                         f"{args.dino_model} (depth {dino_cfg.depth})")
    sam = _sam(sam_cfg, args.sam_checkpoint, dev)
    dino = _dino(dino_cfg, args.dino_checkpoint, dev)
    dino_hw = (int(z["dino_h"]), int(z["dino_w"]))
    mask_hw = (int(z["mask_h"]), int(z["mask_w"]))
    server = SegVLADServer(
        sam=sam, dino=dino, index=index, full_hw=dino_hw, sam_hw=mask_hw,
        dino_layer=args.layer, top_images=args.topk,
        amg=_amg_config(args, dev), db_capacity=db_capacity)
    return server, [str(k) for k in z["image_keys"]], dino_hw


def _load_query_image(path, dino_hw):
    from revisit_anything_tpu_torch.pipeline.extract import (
        _resize_cv2_bilinear, load_image_rgb)
    img = load_image_rgb(path)
    if img.shape[:2] != dino_hw:
        img = _resize_cv2_bilinear(img, (dino_hw[1], dino_hw[0]))
    return img


def _top_json(path, top, keys):
    # unfilled ranks are -1 (fewer distinct database images matched than
    # --topk): only real matches are reported
    top = top[top >= 0]
    return json.dumps({"query": path,
                       "matches": [keys[i] if i < len(keys)
                                   else f"image_{int(i)}" for i in top],
                       "image_ids": top.tolist()})


def cmd_query(args):
    """Online query: one image against a prebuilt index through the
    serving pipeline (pipeline/serve.py)."""
    server, keys, dino_hw = _build_server(args)
    top = server.query(_load_query_image(args.image, dino_hw))
    print(_top_json(args.image, top, keys))


def cmd_serve(args):
    """Persistent query loop: the models are built once, then stdin
    commands drive the live server (one JSON line a result):

      query <image-path>     → top-k image ids/keys
      add <image-path>       → extract + insert as a new database image
                               (needs --db-capacity)
      remove <image-id>      → drop an image from retrieval
      snapshot <out.npz>     → persist the live index
      quit                   → exit
    """
    server, keys, dino_hw = _build_server(args,
                                          db_capacity=args.db_capacity)
    print(json.dumps({"ready": True, "images": server.num_images,
                      "hw": list(dino_hw)}), flush=True)
    stream = args._stdin if hasattr(args, "_stdin") else sys.stdin
    for line in stream:
        parts = line.strip().split(None, 1)
        if not parts:
            continue
        cmd, arg = parts[0].lower(), (parts[1] if len(parts) > 1 else "")
        try:
            if cmd == "quit":
                break
            elif cmd == "query":
                top = server.query(_load_query_image(arg, dino_hw))
                print(_top_json(arg, top, keys), flush=True)
            elif cmd == "add":
                (new_id,) = server.add_reference_images(
                    [_load_query_image(arg, dino_hw)])
                while len(keys) < new_id:
                    keys.append(f"image_{len(keys)}")
                keys.append(arg)
                print(json.dumps({"added": arg, "image_id": new_id}),
                      flush=True)
            elif cmd == "remove":
                server.remove_reference_image(int(arg))
                print(json.dumps({"removed": int(arg)}), flush=True)
            elif cmd == "snapshot":
                server.snapshot_index(arg, image_keys=keys)
                print(json.dumps({"snapshot": arg}), flush=True)
            else:
                print(json.dumps({"error": f"unknown command {cmd!r}"}),
                      flush=True)
        except Exception as e:  # keep serving: report the command's error
            print(json.dumps({"error": str(e), "command": cmd}),
                  flush=True)


def _add_model_flags(p):
    """The model, AMG and device flags of ``query`` and ``serve``."""
    p.add_argument("--index", required=True)
    p.add_argument("--topk", type=int, default=5)
    p.add_argument("--sam-variant", default="vit_h", choices=SAM_VARIANTS)
    p.add_argument("--sam-checkpoint", default=None)
    p.add_argument("--dino-model", default="dinov2_vitg14",
                   choices=DINO_MODELS)
    p.add_argument("--dino-checkpoint", default=None)
    p.add_argument("--layer", type=int, default=31)
    # AMG knobs (reference SamAutomaticMaskGenerator defaults,
    # automatic_mask_generator.py:35-87)
    p.add_argument("--points-per-side", type=int, default=32)
    _add_points_per_batch(p)
    p.add_argument("--pred-iou-thresh", type=float, default=0.88)
    p.add_argument("--stability-score-thresh", type=float, default=0.95)
    _add_device(p)


def _add_points_per_batch(p):
    p.add_argument("--points-per-batch", type=int, default=None,
                   help="prompts per decode batch (default: 1024 on the "
                        "card, 64 on the CPU, whose plain decoder holds "
                        "~4 MiB/prompt of intermediates)")


def main(argv=None):
    from revisit_anything_tpu_torch.models import dinov2 as dn

    parser = argparse.ArgumentParser(prog="revisit_anything_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("extract", help="SAM masks / DINO features → h5")
    _add_common(p)
    p.add_argument("--method", required=True,
                   choices=["SAM", "DINO", "DINOV1", "DINONV",
                            "DINOSALAD"])
    p.add_argument("--force", action="store_true",
                   help="regenerate artifacts even if they exist")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--sam-variant", default="vit_h", choices=SAM_VARIANTS)
    p.add_argument("--dino-model", default="dinov2_vitg14",
                   choices=DINO_MODELS)
    p.add_argument("--layer", type=int, default=None,
                   help="facet layer (default: 31 for DINO, 11 for "
                        "DINOV1)")
    p.add_argument("--facet", default=None,
                   help="q/k/v/token facet (default: value for DINO, "
                        "key for DINOV1)")
    p.add_argument("--dinov1-model", default="dino_vits8",
                   choices=["dino_vits8", "dino_vits16", "dino_vitb8",
                            "dino_vitb16"])
    p.add_argument("--dino-stride", type=int, default=4,
                   help="DINOV1 patch-embed stride override "
                        "(dino_wrapper.py dino_strides)")
    p.add_argument("--dinov1-binned", action="store_true",
                   help="GSP log-binned descriptors")
    p.add_argument("--dinov1-upsample",
                   action=argparse.BooleanOptionalAction, default=True,
                   help="bilinear align_corners upsample to dataset "
                        "resolution, as the reference wrapper hard-codes "
                        "(DINO/dino_wrapper.py); --no-dinov1-upsample "
                        "keeps the strided grid")
    p.add_argument("--multihost", action="store_true",
                   help="join the torch.distributed process group "
                        "(torchrun's MASTER_ADDR/MASTER_PORT/WORLD_SIZE/"
                        "RANK) and shard the images per process")
    _add_device(p)
    p.set_defaults(func=cmd_extract)

    p = sub.add_parser("vocab", help="fit VLAD vocabulary (cosine kmeans)")
    _add_common(p)
    p.add_argument("--finetuned", action="store_true",
                   help="fit on dinoNV features (NVFinetuned vocab id)")
    p.add_argument("--clusters", type=int, default=32)
    p.add_argument("--domain", default=None)
    p.add_argument("--cache-root", default="./cache")
    _add_device(p)
    p.set_defaults(func=cmd_vocab)

    p = sub.add_parser("pca", help="fit whitened PCA on ref segment VLADs")
    _add_common(p)
    p.add_argument("--experiment", required=True)
    p.add_argument("--finetuned", action="store_true")
    p.add_argument("--vocab-vlad", default="domain",
                   choices=["domain", "map"])
    p.add_argument("--dim", type=int, default=1024)
    p.add_argument("--cache-root", default="./cache")
    _add_device(p)
    p.set_defaults(func=cmd_pca)

    p = sub.add_parser("evaluate", help="retrieval + Recall@K")
    _add_common(p)
    p.add_argument("--experiment", required=True)
    p.add_argument("--finetuned", action="store_true",
                   help="SegVLAD-FineT path: dinoNV h5s + NVFinetuned vocab")
    p.add_argument("--vocab-vlad", default="domain",
                   choices=["domain", "map"])
    p.add_argument("--save-results", action="store_true")
    p.add_argument("--cache-root", default="./cache")
    p.add_argument("--trace-dir", default=None,
                   help="write a torch.profiler trace of the evaluation")
    p.add_argument("--save-descriptors", action="store_true",
                   help="include segment descriptors in results.pkl "
                        "(the reference's segFtVLAD pickles)")
    _add_device(p)
    p.set_defaults(func=cmd_evaluate)

    p = sub.add_parser("amg", help="standalone automatic mask generation "
                                   "(the sam/scripts/amg.py CLI)")
    p.add_argument("--input", required=True,
                   help="image file or directory")
    p.add_argument("--output", required=True)
    p.add_argument("--model-type", default="vit_h", choices=SAM_VARIANTS)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--points-per-side", type=int, default=32)
    _add_points_per_batch(p)
    p.add_argument("--pred-iou-thresh", type=float, default=0.88)
    p.add_argument("--stability-score-thresh", type=float, default=0.95)
    p.add_argument("--box-nms-thresh", type=float, default=0.7)
    p.add_argument("--crop-n-layers", type=int, default=0)
    p.add_argument("--crop-nms-thresh", type=float, default=0.7)
    p.add_argument("--min-mask-region-area", type=int, default=0)
    _add_device(p)
    p.set_defaults(func=cmd_amg)

    p = sub.add_parser("build-index", help="build a serving index npz from "
                                           "the reference-side artifacts")
    _add_common(p)
    p.add_argument("--experiment", required=True)
    p.add_argument("--vocab-vlad", default="domain",
                   choices=["domain", "map"])
    p.add_argument("--finetuned", action="store_true")
    p.add_argument("--cache-root", default="./cache")
    p.add_argument("--output", required=True)
    p.add_argument("--db-dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="device storage dtype for the database rows; "
                        "bfloat16 halves the serving memory (kNN still "
                        "accumulates f32)")
    _add_device(p)
    p.set_defaults(func=cmd_build_index)

    p = sub.add_parser("query", help="online query: one image vs a "
                                     "prebuilt index")
    p.add_argument("--image", required=True)
    _add_model_flags(p)
    p.set_defaults(func=cmd_query)

    p = sub.add_parser("serve", help="persistent query/insert loop over "
                                     "stdin (one JSON line per result)")
    _add_model_flags(p)
    p.add_argument("--db-capacity", type=int, default=None,
                   help="static row capacity enabling live add/remove/"
                        "snapshot (pipeline/serve.py incremental mode)")
    p.set_defaults(func=cmd_serve)

    p = sub.add_parser("train", help="VPR metric-learning training "
                                     "(VLAD-BuFF train.py equivalent)")
    p.add_argument("--cities", nargs="*", default=None,
                   help="GSV-Cities shipped format: restrict to these "
                        "Dataframes/<City>.csv (default: all)")
    p.add_argument("--train-root", required=True,
                   help="city/place_id/image directory layout")
    p.add_argument("--ckpt-dir", default="./ckpts")
    p.add_argument("--backbone", default="dinov2_vitb14",
                   choices=list(dn.CONFIGS))
    p.add_argument("--num-trainable-blocks", type=int, default=4)
    p.add_argument("--clusters", type=int, default=64)
    p.add_argument("--no-antiburst", action="store_true")
    p.add_argument("--lr", type=float, default=6e-5)
    p.add_argument("--optimizer", default="adamw",
                   choices=["sgd", "adam", "adamw"])
    p.add_argument("--lr-sched", default="linear",
                   choices=["linear", "multistep", "cosine"])
    p.add_argument("--milestones", type=int, nargs="+", default=[5, 10, 15])
    p.add_argument("--gamma", type=float, default=0.3)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--steps-per-epoch", type=int, default=0,
                   help="multistep milestone unit (0: milestones are "
                        "raw steps)")
    p.add_argument("--cosine-t-max", type=int, default=0)
    p.add_argument("--steps", type=int, default=20000)
    p.add_argument("--batch-places", type=int, default=16)
    p.add_argument("--img-per-place", type=int, default=4)
    p.add_argument("--image-size", type=int, nargs=2, default=[224, 224])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=20)
    p.add_argument("--log-file", default=None,
                   help="append JSONL {step, loss} records")
    p.add_argument("--ckpt-every", type=int, default=1000)
    p.add_argument("--val-root", default=None,
                   help="validation dir: ref/ query/ gt.npy — enables "
                        "in-training recalls + best-R1 checkpointing")
    p.add_argument("--val-every", type=int, default=1000)
    p.add_argument("--resume", action="store_true")
    _add_device(p)
    p.set_defaults(func=cmd_train)

    p = sub.add_parser("add-pca", help="bake whitened PCA into a "
                       "VLAD-BuFF checkpoint (add_pca.py flow)")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--backbone", default="dinov2_vitb14")
    p.add_argument("--images-root", required=True)
    p.add_argument("--num-pcs", type=int, nargs="+", default=[8192])
    p.add_argument("--num-samples", type=int, default=10000)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--image-size", type=int, nargs=2, default=[224, 224])
    p.add_argument("--out-template", default="wpca{n}_last.npy")
    _add_device(p)
    p.set_defaults(func=cmd_add_pca)

    p = sub.add_parser("evaluate-global",
                       help="whole-image descriptor recalls "
                            "(VLAD-BuFF eval.py equivalent)")
    _add_common(p, dataset_required=False)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--model", default="vladbuff",
                   choices=["vladbuff", "dinosalad"])
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--benchmark", default=None,
                   help="VLAD-BuFF benchmark set (nordland, sped, "
                        "amstertime, st_lucia, tokyo247, sfsm, "
                        "pitts30k_*, msls_val) instead of --dataset")
    p.add_argument("--gt-root", default=None,
                   help="npy ground-truth root")
    p.add_argument("--image-size", type=int, nargs=2,
                   default=[224, 224])
    _add_device(p)
    p.set_defaults(func=cmd_evaluate_global)

    args = parser.parse_args(argv)
    args.func(args)


if __name__ == "__main__":
    main()
