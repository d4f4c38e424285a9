"""Port parity of VLAD-BuFF training: every aggregator's forward, every
loss and its gradient, the schedules, three train steps (SGD and AdamW)
against three JAX train steps from the same weights and batches with the
frozen leaves bit-identical in both, checkpoint resume, the place
batcher, validation recalls, the WPCA fit and AnyLoc's ``reduce_pca``,
the VLAD-BuFF / DINO-SALAD checkpoint converters. Small models, seeded
numpy inputs, the JAX package on the CPU; f32 throughout."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from revisit_anything_tpu.models import dinov2 as jdn
from revisit_anything_tpu.ops import pca as jpca
from revisit_anything_tpu.training import aggregators as jag
from revisit_anything_tpu.training import data as jdata
from revisit_anything_tpu.training import losses as jls
from revisit_anything_tpu.training import train as jtr
from revisit_anything_tpu.training import validation as jval
from revisit_anything_tpu.training import vladbuff as jvb
from revisit_anything_tpu_torch.models import dinov2 as pdn
from revisit_anything_tpu_torch.models.layers import module_tree
from revisit_anything_tpu_torch.ops import pca as ppca
from revisit_anything_tpu_torch.training import aggregators as pag
from revisit_anything_tpu_torch.training import checkpoint as pck
from revisit_anything_tpu_torch.training import data as pdata
from revisit_anything_tpu_torch.training import losses as pls
from revisit_anything_tpu_torch.training import train as ptr
from revisit_anything_tpu_torch.training import validation as pval
from revisit_anything_tpu_torch.training import vladbuff as pvb
from revisit_anything_tpu_torch.weights import vpr_from_jax_params
from tests.test_vladbuff import synth_hub_state_dict

torch.set_float32_matmul_precision("highest")
CPU = "cpu"
F32_REL = 2e-5       # f32 both sides, sums in another order


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _leaves_equal(tree, ref, path=""):
    """Every leaf of the JAX tree ``ref`` equals ``tree``'s, exactly."""
    if isinstance(ref, dict):
        for k, v in ref.items():
            if v is not None:
                _leaves_equal(tree[k], v, f"{path}{k}.")
    elif isinstance(ref, (list, tuple)):
        assert len(tree) == len(ref), path
        for i, v in enumerate(ref):
            _leaves_equal(tree[i], v, f"{path}{i}.")
    else:
        np.testing.assert_array_equal(np.asarray(tree), np.asarray(ref),
                                      err_msg=path)


# ---------------------------------------------------------------------------
# Aggregators
# ---------------------------------------------------------------------------

D, HH, WW = 16, 6, 8


def _agg_cases():
    k = jax.random.PRNGKey
    return {
        "netvlad_ab": (lambda: jag.netvlad_init(k(0), D, 5, True),
                       jag.netvlad_forward, pag.netvlad_forward),
        "netvlad": (lambda: jag.netvlad_init(k(1), D, 5, False),
                    jag.netvlad_forward, pag.netvlad_forward),
        "netvlad_rot": (lambda: jag.netvlad_init(k(2), D, 5, True, nv_pca=8),
                        jag.netvlad_forward, pag.netvlad_forward),
        "netvlad_fc": (lambda: jag.netvlad_init(k(3), D, 5, True, nv_pca=8,
                                                nv_pca_mode="fc"),
                       jag.netvlad_forward, pag.netvlad_forward),
        "netvlad_mlp": (lambda: jag.netvlad_init(k(4), D, 5, True, nv_pca=8,
                                                 nv_pca_mode="mlp"),
                        jag.netvlad_forward, pag.netvlad_forward),
        "cosplace": (lambda: jag.cosplace_init(k(5), D, 12),
                     jag.cosplace_forward, pag.cosplace_forward),
        "convap": (lambda: jag.convap_init(k(6), D, 12),
                   jag.convap_forward, pag.convap_forward),
        "mixvpr": (lambda: jag.mixvpr_init(k(7), D, HH, WW, 12, 2),
                   jag.mixvpr_forward, pag.mixvpr_forward),
        "rrm": (lambda: jag.rrm_init(k(8), D), jag.rrm_forward,
                pag.rrm_forward),
        "salad": (lambda: jag.salad_init(k(9), D, 5, 8, 12),
                  jag.salad_forward, pag.salad_forward),
        "crn": (lambda: jag.crn_init(k(10), D, 5), jag.crn_forward,
                pag.crn_forward),
    }


@pytest.mark.parametrize("name", list(_agg_cases()))
def test_aggregator_matches_jax(rng, name):
    init, fj, fp = _agg_cases()[name]
    tree = jax.device_get(init())
    if "ab_params" in tree:
        # off the init's (8, 7, 1) so each parameter matters
        tree["ab_params"] = np.asarray([6.0, 5.0, 0.9], np.float32)
    feats = np.abs(rng.standard_normal((3, D, HH, WW))).astype(np.float32)
    want = np.asarray(fj(tree, jnp.asarray(feats)))
    module = pag.from_jax_tree(tree, device=CPU)
    got = fp(module, _t(feats)).numpy()
    assert got.shape == want.shape
    assert _rel(got, want) < F32_REL
    _leaves_equal(module_tree(module), tree)


@pytest.mark.parametrize("pool,kw", [("gem_pool", {}), ("mac_pool", {}),
                                     ("spoc_pool", {}), ("rmac_pool", {}),
                                     ("rmac_pool", {"levels": 2})])
def test_pooled_forms_match_jax(rng, pool, kw):
    for hw in ((6, 8), (9, 5), (7, 7)):
        feats = np.abs(rng.standard_normal((2, D, *hw))).astype(np.float32)
        want = np.asarray(getattr(jag, pool)(jnp.asarray(feats), **kw))
        got = getattr(pag, pool)(_t(feats), **kw).numpy()
        assert _rel(got, want) < 1e-5


def test_salad_needs_more_patches_than_clusters(rng):
    module = pag.salad_init(torch.Generator().manual_seed(0), D, 64,
                            device=CPU)
    with pytest.raises(ValueError):
        pag.salad_forward(module, _t(rng.standard_normal((1, D, 6, 8))))


def test_netvlad_from_cluster_centers_matches_jax(rng):
    centers = rng.standard_normal((5, D)).astype(np.float32)
    desc = rng.standard_normal((50, D)).astype(np.float32)
    for descriptors, alpha in ((desc, None), (None, None), (None, 12.0)):
        want = jax.device_get(jag.netvlad_init_from_cluster_centers(
            jnp.asarray(centers), descriptors, alpha))
        got = module_tree(pag.netvlad_init_from_cluster_centers(
            _t(centers), None if descriptors is None else _t(descriptors),
            alpha))
        assert set(got) == set(want)
        for k in want:
            assert _rel(got[k], want[k]) < 1e-6, k


def test_crn_accumulation_conv_stays_frozen():
    cfg = ptr.VPRTrainConfig(backbone=pdn.DinoV2Config(
        embed_dim=16, depth=2, num_heads=2, pretrain_grid=(2, 2)),
        num_trainable_blocks=1)
    gen = torch.Generator().manual_seed(0)
    from revisit_anything_tpu_torch.weights import init_dino
    model = ptr.VPRModel(init_dino(cfg.backbone, gen, CPU, torch.float32),
                         pag.crn_init(gen, 16, 4, device=CPU))
    mask = ptr._trainable_mask(model, cfg)
    assert not mask["aggregator.crn.acc_w"] and not mask["aggregator.crn.acc_b"]
    assert mask["aggregator.crn.f3.w"] and mask["aggregator.assign_w"]
    assert mask["backbone.blocks.1.qkv.w"] and mask["backbone.norm.scale"]
    assert not mask["backbone.blocks.0.qkv.w"]
    assert not mask["backbone.pos_embed"]


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["MultiSimilarityLoss", "ContrastiveLoss",
                                  "TripletMarginLoss", "NTXentLoss"])
def test_loss_and_gradient_match_jax(rng, name):
    labels = np.repeat(np.arange(4), 3).astype(np.int32)
    emb = rng.standard_normal((12, 10)).astype(np.float32)
    # pull same-place rows together so every term of every loss is live
    emb += 1.5 * rng.standard_normal((4, 10)).astype(np.float32)[labels]
    fj, fp = jls.get_loss(name), pls.get_loss(name)
    want, want_g = jax.value_and_grad(lambda e: fj(e, jnp.asarray(labels)))(
        jnp.asarray(emb))
    e = _t(emb).requires_grad_(True)
    got = fp(e, torch.from_numpy(labels))
    got.backward()
    assert abs(got.item() - float(want)) <= 1e-5 * max(abs(float(want)), 1.0)
    assert _rel(e.grad.numpy(), np.asarray(want_g)) < 1e-4
    with pytest.raises(NotImplementedError):
        pls.get_loss("ArcFace")


def test_miner_masks_match_jax(rng):
    labels = np.repeat(np.arange(3), 4).astype(np.int32)
    emb = rng.standard_normal((12, 6)).astype(np.float32)
    want = jls.multi_similarity_miner_mask(jnp.asarray(emb),
                                           jnp.asarray(labels), 0.1)
    got = pls.multi_similarity_miner_mask(_t(emb), torch.from_numpy(labels),
                                          0.1)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(lr_sched="linear", lin_total_iters=7, lin_end_factor=0.2),
    dict(lr_sched="linear", lin_total_iters=4000),
    dict(lr_sched="multistep", milestones=(2, 5, 5, 9)),
    dict(lr_sched="multistep", milestones=(1, 3), steps_per_epoch=3,
         gamma=0.5),
    dict(lr_sched="cosine", cosine_t_max=10),
    dict(lr_sched="cosine", total_steps=13)])
def test_schedule_matches_optax(kw):
    """Every step 0..N, past the ends and on each boundary."""
    jc, pc = jtr.VPRTrainConfig(**kw), ptr.VPRTrainConfig(**kw)
    fj, fp = jtr.make_schedule(jc), ptr.make_schedule(pc)
    for step in list(range(0, 16)) + [3999, 4000, 4001]:
        want = float(fj(jnp.asarray(step, jnp.int32)))
        assert fp(step) == pytest.approx(want, rel=1e-6, abs=1e-12), step


# ---------------------------------------------------------------------------
# Train steps
# ---------------------------------------------------------------------------

TRAIN_BB = dict(embed_dim=32, depth=3, num_heads=2, pretrain_grid=(2, 2))


def _train_pair(opt, **kw):
    jcfg = jtr.VPRTrainConfig(backbone=jdn.DinoV2Config(**TRAIN_BB),
                              num_trainable_blocks=2, clusters=4,
                              optimizer=opt, **kw)
    pcfg = ptr.VPRTrainConfig(backbone=pdn.DinoV2Config(**TRAIN_BB),
                              num_trainable_blocks=2, clusters=4,
                              optimizer=opt, **kw)
    state = jtr.create_train_state(jcfg, jax.random.PRNGKey(11))
    # copies: the JAX step donates its parameters' buffers
    tree = jax.tree.map(lambda a: np.array(a, copy=True), state.params)
    model = vpr_from_jax_params(tree, pcfg.backbone, device=CPU)
    return jcfg, pcfg, state, tree, ptr.create_train_state(pcfg,
                                                           model=model)


def _batches(rng, n=3):
    labels = np.repeat(np.arange(4), 2).astype(np.int32)
    out = []
    for _ in range(n):
        # views of a place share a weak common image, so the miner finds
        # hard positives and negatives and every step has a gradient
        base = 0.3 * rng.standard_normal((4, 28, 28, 3)).astype(np.float32)
        noise = rng.standard_normal((8, 28, 28, 3)).astype(np.float32)
        out.append((base[labels] + noise, labels))
    return out


@pytest.mark.parametrize("opt,kw,tol", [
    # SGD: the update is linear in the gradient
    ("sgd", dict(lr=0.05, lr_sched="linear", lin_total_iters=2), 1e-5),
    # AdamW divides by sqrt(v) + 1e-8: a gradient entry near eps moves
    # its parameter by up to lr whatever its f32 rounding, so the losses
    # drift more than SGD's
    ("adamw", dict(lr=1e-3, weight_decay=0.1, lr_sched="cosine",
                   cosine_t_max=4), 1e-4)])
def test_three_train_steps_match_jax(rng, opt, kw, tol):
    jcfg, pcfg, jstate, tree0, pstate = _train_pair(opt, **kw)
    params, opt_state, step = jstate.params, jstate.opt_state, jstate.step
    split = TRAIN_BB["depth"] - 2
    for images, labels in _batches(rng):
        params, opt_state, step, jloss = jtr.train_step(
            params, opt_state, step, jcfg, jnp.asarray(images),
            jnp.asarray(labels))
        ploss = ptr.train_step(pstate, pcfg, torch.from_numpy(images),
                               torch.from_numpy(labels))
        assert abs(ploss.item() - float(jloss)) <= tol * abs(float(jloss))
    assert pstate.step == int(step) == 3
    tree = jax.device_get(params)
    got = module_tree(pstate.model)
    mask = ptr._trainable_mask(pstate.model, pcfg)
    # frozen leaves: bit-identical to their start in both packages
    frozen = {"patch_embed": None, "cls_token": None, "pos_embed": None}
    for k in frozen:
        _leaves_equal(tree["backbone"][k], tree0["backbone"][k])
        _leaves_equal(got["backbone"][k], tree0["backbone"][k])
    for i in range(split):
        _leaves_equal(tree["backbone"]["blocks"][i],
                      tree0["backbone"]["blocks"][i])
        _leaves_equal(got["backbone"]["blocks"][i],
                      tree0["backbone"]["blocks"][i])
    assert not any(mask[f"backbone.blocks.{i}.qkv.w"] for i in range(split))
    # the trainable ones moved, alike in both packages
    for part, key in (("aggregator", "assign_w"), ("aggregator", "centroids")):
        a, b = got[part][key], np.asarray(tree[part][key])
        assert not np.array_equal(b, tree0[part][key])
        assert _rel(a - tree0[part][key], b - tree0[part][key]) < 50 * tol
    last = got["backbone"]["blocks"][-1]["fc2"]["w"]
    assert not np.array_equal(last, tree0["backbone"]["blocks"][-1]["fc2"]["w"])


def test_checkpoint_resume_equals_continuing(tmp_path, rng):
    """Save after step 2, restore into a fresh state, step again: the loss
    and every parameter bit for bit as the run that went on; partial
    saves are skipped; best-metric retention keeps the max."""
    _, pcfg, _, tree0, state = _train_pair(
        "adamw", lr=1e-3, lr_sched="linear", lin_total_iters=5)
    batches = _batches(rng, 3)
    for images, labels in batches[:2]:
        ptr.train_step(state, pcfg, torch.from_numpy(images),
                       torch.from_numpy(labels))
    path = pck.save_train_state(str(tmp_path), state)
    assert os.path.basename(path) == "step_00000002"
    (tmp_path / "step_00000009.partial").write_bytes(b"")
    assert pck.latest_checkpoint(str(tmp_path)) == path
    cont = ptr.train_step(state, pcfg, torch.from_numpy(batches[2][0]),
                          torch.from_numpy(batches[2][1]))
    fresh = ptr.create_train_state(pcfg, model=vpr_from_jax_params(
        tree0, pcfg.backbone, device=CPU))
    pck.restore_train_state(path, fresh)
    assert fresh.step == 2
    again = ptr.train_step(fresh, pcfg, torch.from_numpy(batches[2][0]),
                           torch.from_numpy(batches[2][1]))
    assert torch.equal(cont, again)
    for (n, a), (_, b) in zip(state.model.named_parameters(),
                              fresh.model.named_parameters()):
        assert torch.equal(a, b), n
    assert pck.save_best_state(str(tmp_path), state, 0.5, "R1") is not None
    assert pck.save_best_state(str(tmp_path), state, 0.4, "R1") is None
    assert pck.save_best_state(str(tmp_path), state, 0.6, "R1") is not None


def test_create_train_state_with_cluster_init(rng):
    """Seeded weights, the NetVLAD from k-means centers of sample
    descriptors (alpha from their assignment gap), the trainable set."""
    cfg = ptr.VPRTrainConfig(backbone=pdn.DinoV2Config(**TRAIN_BB),
                             num_trainable_blocks=1, clusters=4)
    desc = rng.standard_normal((64, 32)).astype(np.float32)
    state = ptr.create_train_state(cfg, seed=3, init_descriptors=desc,
                                   device=CPU)
    agg = state.model.aggregator
    assert agg.assign_w.shape == (32, 4) and agg.centroids.shape == (4, 32)
    assert agg.ab_params.tolist() == [8.0, 7.0, 1.0]
    n_train = sum(p.numel() for p in state.model.parameters()
                  if p.requires_grad)
    want = sum(p.numel() for g in state.optimizer.param_groups
               for p in g["params"])
    assert n_train == want
    again = ptr.create_train_state(cfg, seed=3, init_descriptors=desc,
                                   device=CPU)
    assert torch.equal(again.model.aggregator.centroids, agg.centroids)


# ---------------------------------------------------------------------------
# Data and validation
# ---------------------------------------------------------------------------


def _png(path, rng, hw=(30, 34)):
    from PIL import Image
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(rng.integers(0, 256, (*hw, 3), dtype=np.uint8)).save(path)


def test_places_batcher_matches_jax(tmp_path, rng):
    for city in ("a", "b"):
        for place in range(3):
            for i in range(2 + place):
                _png(str(tmp_path / city / f"p{place}" / f"{i}.png"), rng)
    (tmp_path / "a" / "p0" / "notes.txt").write_text("x")
    pj = jdata.discover_places(str(tmp_path), min_images=2)
    pp = pdata.discover_places(str(tmp_path), min_images=2)
    assert pj == pp and len(pp) == 6
    kw = dict(image_hw=(28, 28), places_per_batch=2, img_per_place=3,
              seed=5)
    bj = list(jdata.PlacesBatcher(pj, **kw))
    bp = list(pdata.prefetch(iter(pdata.PlacesBatcher(pp, **kw))))
    assert len(bj) == len(bp) == 3
    for (xj, lj), (xp, lp) in zip(bj, bp):
        assert xp.shape == (6, 28, 28, 3)
        np.testing.assert_array_equal(xj, xp)
        np.testing.assert_array_equal(lj, lp)


@pytest.mark.parametrize("kw,n", [({}, 6), ({"min_img_per_place": 5}, 0),
                                  ({"cities": ["London"]}, 3)])
def test_discover_places_gsv_matches_jax(tmp_path, rng, kw, n):
    """GSV-Cities as shipped (CSV dataframes and flat image folders):
    the same places and paths in both packages."""
    from tests.test_train_data import make_gsv_dataset
    root = make_gsv_dataset(tmp_path, rng)
    want = jdata.discover_places_gsv(root, **kw)
    assert pdata.discover_places_gsv(root, **kw) == want
    assert len(want) == n


def test_prefetch_raises_the_workers_error():
    def bad():
        yield 1
        raise OSError("corrupt image")
    it = pdata.prefetch(bad())
    assert next(it) == 1
    with pytest.raises(OSError):
        next(it)


def test_run_validation_matches_jax(tmp_path, rng):
    root = tmp_path / "val"
    for i in range(6):
        _png(str(root / "ref" / f"{i:02d}.png"), rng)
    for i in range(4):
        _png(str(root / "query" / f"{i:02d}.png"), rng)
    np.save(str(root / "gt.npy"),
            np.asarray([[0], [1, 2], [], [5]], dtype=object),
            allow_pickle=True)
    jcfg, pcfg, jstate, tree, pstate = _train_pair("adamw")
    vj = jval.ValidationSet.from_directory(str(root), (28, 28))
    vp = pval.ValidationSet.from_directory(str(root), (28, 28))
    assert (vj.ref_paths, vj.query_paths, vj.gt) == (vp.ref_paths,
                                                     vp.query_paths, vp.gt)
    want = jval.run_validation(jstate.params, jcfg, vj, batch_size=4,
                               print_results=False)
    got = pval.run_validation(pstate.model, pcfg, vp, batch_size=4,
                              print_results=False)
    assert got == want and set(got) == {1, 5, 10}


# ---------------------------------------------------------------------------
# WPCA, reduce_pca, the checkpoint converters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,d", [(200, 16), (12, 64)])   # primal, dual
def test_fit_wpca_matches_jax_up_to_sign(rng, n, d):
    scales = np.geomspace(4.0, 0.2, d).astype(np.float32)
    x = (rng.standard_normal((n, d)) * scales + 0.3).astype(np.float32)
    k = 6
    want = jax.device_get(jvb.fit_wpca(jnp.asarray(x), k))
    got = {kk: v.numpy() for kk, v in pvb.fit_wpca(_t(x), k).items()}
    assert got["w"].shape == (k, d)
    for i in range(k):
        s = np.sign(np.dot(got["w"][i], want["w"][i]))
        assert _rel(s * got["w"][i], want["w"][i]) < 1e-3
        assert abs(s * got["b"][i] - want["b"][i]) <= 1e-3 * max(
            abs(want["b"][i]), 1.0)
    # whitened: the projected training set has unit variance on each axis
    y = x @ got["w"].T + got["b"]
    np.testing.assert_allclose(y.var(0, ddof=1), 1.0, rtol=1e-3)


def test_bake_wpca_and_its_descriptor(rng):
    kw = dict(embed_dim=16, depth=1, num_heads=2, pretrain_grid=(2, 2))
    cfg = pdn.DinoV2Config(**kw)
    gen = torch.Generator().manual_seed(2)
    from revisit_anything_tpu_torch.weights import init_dino
    model = ptr.VPRModel(init_dino(cfg, gen, CPU, torch.float32),
                         pag.netvlad_init(gen, 16, 3, device=CPU))
    imgs = _t(rng.standard_normal((20, 28, 28, 3)))
    with torch.no_grad():
        raw = pvb.global_descriptor(model, cfg, imgs)
        pvb.bake_wpca(model, raw, 5)
        white = pvb.global_descriptor(model, cfg, imgs)
    assert raw.shape == (20, 48) and white.shape == (20, 5)
    np.testing.assert_allclose(white.norm(dim=1).numpy(), 1.0, rtol=1e-5)


@pytest.mark.parametrize("low_factor,fallback,n", [(0.0, 256, 30),
                                                   (0.5, 256, 30),
                                                   (0.5, 6, 10)])
def test_reduce_pca_matches_jax(rng, low_factor, fallback, n):
    d = 8 if n >= 20 else 20
    scales = np.geomspace(3.0, 0.3, d).astype(np.float32)
    train = (rng.standard_normal((n, d)) * scales).astype(np.float32)
    test = (rng.standard_normal((5, d)) * scales).astype(np.float32)
    for whiten in (False, True):
        want = jpca.reduce_pca(train, test, 4, low_factor, fallback, whiten)
        got = ppca.reduce_pca(train, test, 4, low_factor, fallback, whiten,
                              device=CPU)
        for a, b in zip(got, want):
            assert a.shape == b.shape and _rel(a, b) < 1e-4


TINY = dict(embed_dim=32, depth=2, num_heads=2, ffn="mlp",
            pretrain_grid=(4, 4))


def _release_backbone(rng):
    cfg = jdn.DinoV2Config(**TINY)
    return {f"backbone.model.{k}": v.numpy()
            for k, v in synth_hub_state_dict(cfg, rng).items()}


@pytest.mark.parametrize("variant", ["plain", "rot", "fc", "mlp"])
def test_convert_vladbuff_checkpoint_matches_jax(rng, variant):
    """VLAD-BuFF's release layout (with cumulative WPCA_8 / WPCA_16
    layers: the widest is taken) → the same leaves in both packages."""
    sd = _release_backbone(rng)
    c, d = 4, 32
    r = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    sd.update({"aggregator.conv.weight": r(c, d, 1, 1),
               "aggregator.centroids": r(c, d),
               "aggregator.ab_params": r(3),
               "aggregator.WPCA_8.weight": r(8, c * d, 1, 1),
               "aggregator.WPCA_8.bias": r(8),
               "aggregator.WPCA_16.weight": r(16, c * d, 1, 1),
               "aggregator.WPCA_16.bias": r(16)})
    if variant != "plain":
        sd.update({"aggregator.pca_mean": r(d), "aggregator.pca_rot": r(d, d)})
    if variant == "fc":
        sd.update({"aggregator.bottleneck.weight": r(d, d),
                   "aggregator.bottleneck.bias": r(d)})
    if variant == "mlp":
        sd.update({"aggregator.mlp.0.weight": r(d, d),
                   "aggregator.mlp.0.bias": r(d),
                   "aggregator.mlp.2.weight": r(d, d),
                   "aggregator.mlp.2.bias": r(d)})
    want = jax.device_get(jvb.convert_vladbuff_checkpoint(
        sd, jdn.DinoV2Config(**TINY)))
    model = pvb.convert_vladbuff_checkpoint(
        {k: torch.from_numpy(v) for k, v in sd.items()},
        pdn.DinoV2Config(**TINY), device=CPU)
    got = module_tree(model)
    assert set(got["aggregator"]) == set(want["aggregator"])
    assert got["wpca"]["w"].shape == (16, c * d)
    _leaves_equal(got, want)


def test_convert_dinosalad_checkpoint_matches_jax(rng):
    sd = _release_backbone(rng)
    d, m, l, t = 32, 4, 8, 12
    r = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    for name, o, i in (("score.0", 64, d), ("score.3", m, 64),
                       ("cluster_features.0", 64, d),
                       ("cluster_features.3", l, 64)):
        sd[f"aggregator.{name}.weight"] = r(o, i, 1, 1)
        sd[f"aggregator.{name}.bias"] = r(o)
    for name, o, i in (("token_features.0", 64, d),
                       ("token_features.2", t, 64)):
        sd[f"aggregator.{name}.weight"] = r(o, i)
        sd[f"aggregator.{name}.bias"] = r(o)
    sd["aggregator.dust_bin"] = np.asarray(1.5, np.float32)
    want = jax.device_get(jvb.convert_dinosalad_checkpoint(
        sd, jdn.DinoV2Config(**TINY)))
    model = pvb.convert_dinosalad_checkpoint(sd, pdn.DinoV2Config(**TINY),
                                             device=CPU)
    _leaves_equal(module_tree(model), want)
    imgs = rng.standard_normal((2, 112, 112, 3)).astype(np.float32)
    wd = np.asarray(jvb.salad_global_descriptor(want, jdn.DinoV2Config(
        **TINY), jnp.asarray(imgs)))
    with torch.no_grad():
        gd = pvb.salad_global_descriptor(model, pdn.DinoV2Config(**TINY),
                                         _t(imgs)).numpy()
    assert gd.shape == wd.shape == (2, t + l * m) and _rel(gd, wd) < F32_REL
