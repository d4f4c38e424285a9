"""The port's sharded VLAD-BuFF train step (data x tensor parallel on
``torch.distributed``) against the JAX package's
``make_sharded_train_step`` on a (2, 2) mesh of conftest's CPU devices
and against the port's own one-device ``train_step``; the sharding
rules against JAX ``_tp_spec_for`` leaf for leaf; checkpoints across
mesh shapes; and the port's dry run.

Each mesh shape runs in its own gloo group of ``python -c`` processes
that import only the port (one a mesh position, all started at once),
from the JAX package's weights through ``weights.vpr_from_jax_params``
and the batches of ``test_torch_training._batches`` (views of a place
share a weak common image, so the miner finds pairs).

Tolerances: SGD losses and parameters within 1e-5 relative (of the
loss; of each tensor's largest entry), the update being linear in the
gradient; AdamW at the default lr 6e-5, the JAX test's bounds
(``tests/test_training.py:190-194``): losses rtol 1e-4, parameters atol
1e-4 (its first steps move a parameter by ±lr whatever its gradient's
size); gradients of the replicated biases within 1e-5 relative; frozen
leaves bit for bit."""

import json
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

from revisit_anything_tpu.models import dinov2 as jdn
from revisit_anything_tpu.training import train as jtr
from revisit_anything_tpu_torch.dryrun import (dryrun_multichip, free_port,
                                               run_ranks)
from revisit_anything_tpu_torch.models import dinov2 as pdn
from revisit_anything_tpu_torch.parallel import make_mesh
from revisit_anything_tpu_torch.training import train as ptr
from revisit_anything_tpu_torch.weights import vpr_from_jax_params
from tests.test_torch_training import TRAIN_BB, _batches

torch.set_float32_matmul_precision("highest")
CPU = "cpu"
SGD_REL = 1e-5
ADAM_RTOL, ADAM_ATOL = 1e-4, 1e-4
OPT_KW = {"sgd": dict(lr=0.05), "adamw": {}}
SPLIT = TRAIN_BB["depth"] - 2            # frozen blocks
MESHES = ((2, 2), (1, 2), (2, 1))
# (mesh, ffn, optimizer) of every sharded run
JOBS = [(m, "mlp", o) for m in MESHES for o in ("sgd", "adamw")] + [
    (m, "swiglu", "sgd") for m in ((2, 2), (1, 2))]
SAVE_AFTER = 1                           # the (2, 2) AdamW run saves after
#                                          its second step


def _cfgs(ffn, opt):
    bb = dict(TRAIN_BB, ffn=ffn)
    kw = dict(num_trainable_blocks=2, clusters=4, optimizer=opt,
              **OPT_KW[opt])
    return (jtr.VPRTrainConfig(backbone=jdn.DinoV2Config(**bb), **kw),
            ptr.VPRTrainConfig(backbone=pdn.DinoV2Config(**bb), **kw),
            dict(backbone=bb, cfg=kw))


def _jax_tree(ffn):
    jcfg = _cfgs(ffn, "sgd")[0]
    state = jtr.create_train_state(jcfg, jax.random.PRNGKey(11))
    return jax.tree.map(lambda a: np.array(a, copy=True), state.params)


def _flat(tree, prefix=""):
    """{dotted name: leaf} of a nested dict / list tree."""
    items = (tree.items() if isinstance(tree, dict) else enumerate(tree))
    out = {}
    for k, v in items:
        if isinstance(v, (dict, list, tuple)):
            out.update(_flat(v, f"{prefix}{k}."))
        elif v is not None:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


_WORKER = r"""
import json, pickle, sys
import numpy as np, torch
import torch.distributed as dist
from revisit_anything_tpu_torch.dryrun import init_rank
from revisit_anything_tpu_torch.models import dinov2 as dn
from revisit_anything_tpu_torch.parallel import make_mesh
from revisit_anything_tpu_torch.training import checkpoint as ck
from revisit_anything_tpu_torch.training import train as tr
from revisit_anything_tpu_torch.weights import vpr_from_jax_params
torch.set_float32_matmul_precision("highest")
with open(sys.argv[1]) as f:
    spec = json.load(f)
rank = int(sys.argv[2])
dp, tp = spec["mesh"]
init_rank(spec["addr"], "gloo", dp * tp, rank, "cpu")
torch.set_num_threads(1)
mesh = make_mesh((dp, tp), ("data", "model"), devices=["cpu"] * (dp * tp))
with open(spec["inputs"], "rb") as f:
    inputs = pickle.load(f)
for job in spec["jobs"]:
    cfg = tr.VPRTrainConfig(backbone=dn.DinoV2Config(**job["backbone"]),
                            **job["cfg"])
    model = vpr_from_jax_params(inputs["trees"][job["backbone"]["ffn"]],
                                cfg.backbone, device="cpu")
    step_fn, st = tr.make_sharded_train_step(
        mesh, cfg, tr.create_train_state(cfg, model=model))
    if job.get("restore"):
        ck.restore_train_state(job["restore"], st)
    out = {"losses": [], "grads": None}
    for i in job["steps"]:
        images, labels = inputs["batches"][i]
        out["losses"].append(step_fn(st, images, labels).item())
        if out["grads"] is None:
            out["grads"] = {n: p.grad.numpy().copy()
                            for n, p in st.model.named_parameters()
                            if p.requires_grad
                            and n.endswith(("fc1.b", "w12.b"))}
        if i == job.get("save_after"):
            out["saved"] = ck.save_train_state(job["save_dir"], st)
    names = [n for n, p in st.model.named_parameters() if p.requires_grad]
    local = dict(st.model.named_parameters())
    out["moments"] = {names[i]: {k: tuple(v.shape) for k, v in s.items()
                                 if v.dim()}
                      for i, s in st.optimizer.state_dict()["state"].items()}
    out["local_shapes"] = {n: tuple(p.shape) for n, p in local.items()}
    model_sd, opt_sd = st.state_dicts()
    out["params"] = {k: v.numpy().copy() for k, v in model_sd.items()}
    if rank == 0:
        with open(job["out"], "wb") as f:
            pickle.dump(out, f)
dist.destroy_process_group()
"""


def _launch(tmp, mesh, jobs):
    spec = dict(addr=f"tcp://127.0.0.1:{free_port()}", mesh=mesh,
                inputs=str(tmp / "inputs.pkl"), jobs=jobs)
    path = tmp / f"spec_{mesh[0]}x{mesh[1]}_{len(jobs)}.json"
    path.write_text(json.dumps(spec))
    return [[str(path), r] for r in range(mesh[0] * mesh[1])]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every sharded run (all mesh shapes at once, then the (1, 1) resume
    of the (2, 2) checkpoint), the port's one-device runs and JAX's
    sharded ones, from the same weights and batches."""
    tmp = tmp_path_factory.mktemp("sharded")
    trees = {ffn: _jax_tree(ffn) for ffn in ("mlp", "swiglu")}
    batches = _batches(np.random.default_rng(5))
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump({"trees": trees, "batches": batches}, f)

    def job(ffn, opt, mesh, **kw):
        return dict(backbone=_cfgs(ffn, opt)[2]["backbone"],
                    cfg=_cfgs(ffn, opt)[2]["cfg"], steps=[0, 1, 2],
                    out=str(tmp / f"{mesh[0]}x{mesh[1]}_{ffn}_{opt}.pkl"),
                    **kw)

    by_mesh = {m: [] for m in MESHES}
    for mesh, ffn, opt in JOBS:
        extra = {}
        if (mesh, ffn, opt) == ((2, 2), "mlp", "adamw"):
            extra = dict(save_after=SAVE_AFTER, save_dir=str(tmp / "ckpt"))
        by_mesh[mesh].append(job(ffn, opt, mesh, **extra))
    argvs = [a for m in MESHES for a in _launch(tmp, m, by_mesh[m])]
    # every mesh at once: each shape's ranks meet at their own address
    run_ranks(_WORKER, argvs, timeout=300)
    with open(tmp / "2x2_mlp_adamw.pkl", "rb") as f:
        ckpt = pickle.load(f)["saved"]
    resume = dict(job("mlp", "adamw", (1, 1)), steps=[2], restore=ckpt)
    run_ranks(_WORKER, _launch(tmp, (1, 1), [resume]), timeout=300)

    sharded = {}
    for mesh, ffn, opt in JOBS:
        with open(tmp / f"{mesh[0]}x{mesh[1]}_{ffn}_{opt}.pkl", "rb") as f:
            sharded[mesh, ffn, opt] = pickle.load(f)
    with open(tmp / "1x1_mlp_adamw.pkl", "rb") as f:
        resumed = pickle.load(f)

    one = {}
    for ffn, opt in {(f, o) for _, f, o in JOBS}:
        pcfg = _cfgs(ffn, opt)[1]
        model = vpr_from_jax_params(trees[ffn], pcfg.backbone, device=CPU)
        st = ptr.create_train_state(pcfg, model=model)
        rec = {"losses": [], "params": []}
        for images, labels in batches:
            rec["losses"].append(ptr.train_step(
                st, pcfg, torch.from_numpy(images),
                torch.from_numpy(labels)).item())
            rec["params"].append({k: v.numpy().copy() for k, v in
                                  st.model.state_dict().items()})
        one[ffn, opt] = rec

    jmesh = JaxMesh(np.array(jax.devices()[:4]).reshape(2, 2),
                    ("data", "model"))
    jx = {}
    for opt in ("sgd", "adamw"):
        jcfg = _cfgs("mlp", opt)[0]
        state = jtr.create_train_state(jcfg, jax.random.PRNGKey(11))
        params = jax.tree.map(jnp.asarray, trees["mlp"])
        opt_state = jtr.make_optimizer(jcfg, params).init(params)
        step_fn, p, o = jtr.make_sharded_train_step(jmesh, jcfg, params,
                                                    opt_state)
        s, losses = state.step, []
        for images, labels in batches:
            p, o, s, loss = step_fn(p, o, s, jnp.asarray(images),
                                    jnp.asarray(labels))
            losses.append(float(loss))
        jx[opt] = dict(losses=losses, params=_flat(jax.device_get(p)))
    return dict(trees=trees, batches=batches, sharded=sharded, one=one,
                jax=jx, resumed=resumed, ckpt=ckpt)


# ---------------------------------------------------------------------------
# Rules and slicing (no processes)
# ---------------------------------------------------------------------------


def _port_model(ffn):
    return vpr_from_jax_params(_jax_tree(ffn), _cfgs(ffn, "sgd")[1].backbone,
                               device=CPU)


def _jax_specs(tree):
    """{dotted name: tuple(JAX spec)} of every leaf of ``tree``."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [str(getattr(p, "key", getattr(p, "idx", None)))
                for p in path]
        out[".".join(keys)] = tuple(jtr._tp_spec_for(path, leaf))
    return out


@pytest.mark.parametrize("ffn", ["mlp", "swiglu"])
def test_param_sharding_rules_match_jax(ffn):
    """Every parameter's spec is JAX ``_tp_spec_for``'s for its leaf, and
    every AdamW moment's (mu, nu) is its parameter's."""
    tree = _jax_tree(ffn)
    model = vpr_from_jax_params(tree, _cfgs(ffn, "sgd")[1].backbone,
                                device=CPU)
    mesh = make_mesh((2, 2), ("data", "model"), devices=[CPU] * 4)
    specs = ptr.param_sharding_rules(mesh, model)
    want = _jax_specs(tree)
    assert specs == want
    assert specs["backbone.blocks.0." + ("w12.w" if ffn == "swiglu"
                                         else "fc1.w")] == (None, "model")
    assert specs["aggregator.centroids"] == ("model", None)
    jcfg = _cfgs(ffn, "adamw")[0]
    opt_state = jtr.make_optimizer(jcfg, tree).init(
        jax.tree.map(jnp.asarray, tree))
    moments = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(opt_state)[0]:
        keys = [str(getattr(p, "key", getattr(p, "name", getattr(
            p, "idx", None)))) for p in path]
        for m in ("mu", "nu"):
            if m in keys:
                name = ".".join(keys[keys.index(m) + 1:])
                assert tuple(jtr._tp_spec_for(path, leaf)) == specs[name]
                moments += 1
    n_train = sum(ptr._trainable_mask(model, _cfgs(ffn, "adamw")[1]).values())
    assert moments == 2 * n_train


@pytest.mark.parametrize("ffn", ["mlp", "swiglu"])
def test_shard_model_splits_ffn_and_clusters(ffn):
    """Rank m's shards: fc1 / w12 columns (w12's m-th x1 block and m-th
    x2 block, not a contiguous split), fc2 / w3 rows, ``assign_w``
    columns and ``centroids`` rows; the 1-d biases and every other leaf
    whole."""
    model = _port_model(ffn)
    full = dict(model.named_parameters())
    mesh = make_mesh((1, 2), ("data", "model"), devices=[CPU] * 2)
    h = model.backbone.cfg.swiglu_hidden if ffn == "swiglu" else \
        model.backbone.cfg.mlp_hidden
    for m in range(2):
        got = dict(ptr.shard_model(model, mesh, m).named_parameters())
        assert got.keys() == full.keys()
        for name, p in got.items():
            w = full[name].detach()
            if name.endswith("w12.w"):
                hm = h // 2
                want = torch.cat([w[:, m * hm:(m + 1) * hm],
                                  w[:, h + m * hm:h + (m + 1) * hm]], 1)
            elif name.endswith(("fc1.w", "assign_w")):
                want = w.chunk(2, 1)[m]
            elif name.endswith(("fc2.w", "w3.w", "centroids")):
                want = w.chunk(2, 0)[m]
            else:
                want = w
            assert torch.equal(p.detach(), want), name
            assert p.requires_grad == full[name].requires_grad


def test_sharding_refuses_what_it_cannot_split():
    """A "model" size that does not divide the clusters raises, and so
    does a step without a process group of the mesh's size."""
    model = _port_model("mlp")
    with pytest.raises(ValueError):
        ptr.param_sharding_rules(
            make_mesh((1, 3), ("data", "model"), devices=[CPU] * 3), model)
    cfg = _cfgs("mlp", "sgd")[1]
    with pytest.raises(RuntimeError):
        ptr.make_sharded_train_step(
            make_mesh((1, 2), ("data", "model"), devices=[CPU] * 2), cfg,
            ptr.create_train_state(cfg, model=model))


# ---------------------------------------------------------------------------
# Sharded steps
# ---------------------------------------------------------------------------


def _check(got_losses, got_params, want_losses, want_params, opt):
    if opt == "sgd":
        for a, b in zip(got_losses, want_losses):
            assert abs(a - b) <= SGD_REL * abs(b)
        for k, b in want_params.items():
            assert _rel(got_params[k], b) <= SGD_REL, k
    else:
        np.testing.assert_allclose(got_losses, want_losses, rtol=ADAM_RTOL)
        for k, b in want_params.items():
            np.testing.assert_allclose(got_params[k], b, rtol=0,
                                       atol=ADAM_ATOL, err_msg=k)


@pytest.mark.parametrize("job", JOBS, ids=lambda j: "-".join(map(str, j)))
def test_sharded_step_matches_train_step(runs, job):
    """Three steps on the mesh against three one-device steps: losses and
    every parameter (gathered) within the optimizer's bounds; the moments
    stored sliced like their parameters."""
    mesh, ffn, opt = job
    got, want = runs["sharded"][job], runs["one"][ffn, opt]
    _check(got["losses"], got["params"], want["losses"],
           want["params"][-1], opt)
    for name, shapes in got["moments"].items():
        assert set(shapes.values()) == {got["local_shapes"][name]}, name
    if mesh[1] == 2:
        assert got["local_shapes"]["aggregator.centroids"] == (2, 32)


@pytest.mark.parametrize("opt", ["sgd", "adamw"])
def test_sharded_step_matches_jax_sharded_step(runs, opt):
    """The port on a (2, 2) gloo mesh against JAX
    ``make_sharded_train_step`` on a (2, 2) mesh of CPU devices."""
    got, want = runs["sharded"][(2, 2), "mlp", opt], runs["jax"][opt]
    _check(got["losses"], got["params"], want["losses"], want["params"],
           opt)


@pytest.mark.parametrize("job", [j for j in JOBS if j[1:] == ("mlp", "sgd")
                                 or j[1] == "swiglu"],
                         ids=lambda j: "-".join(map(str, j)))
def test_replicated_bias_gradients_match_one_device(runs, job):
    """fc1.b / w12.b stay whole on every rank while their weights are
    split; after the first step's reductions their gradients equal the
    one-device gradients."""
    _, ffn, _ = job
    pcfg = _cfgs(ffn, "sgd")[1]
    model = vpr_from_jax_params(runs["trees"][ffn], pcfg.backbone,
                                device=CPU)
    ptr.create_train_state(pcfg, model=model)
    images, labels = runs["batches"][0]
    ptr.loss_fn(model, pcfg, torch.from_numpy(images),
                torch.from_numpy(labels)).backward()
    want = {n: p.grad.numpy() for n, p in model.named_parameters()
            if p.requires_grad and n.endswith(("fc1.b", "w12.b"))}
    got = runs["sharded"][job]["grads"]
    assert got.keys() == want.keys() and len(want) == 2
    for n, g in want.items():
        assert got[n].shape == g.shape
        assert _rel(got[n], g) <= 1e-5, n


@pytest.mark.parametrize("job", JOBS, ids=lambda j: "-".join(map(str, j)))
def test_frozen_leaves_stay_bit_identical(runs, job):
    """The embedding and the frozen blocks after three sharded steps are
    the starting weights bit for bit; the trainable ones moved."""
    got = runs["sharded"][job]["params"]
    start = _flat(runs["trees"][job[1]])
    frozen = [k for k in start if k.startswith(
        ("backbone.patch_embed", "backbone.cls_token", "backbone.pos_embed"))
        or any(k.startswith(f"backbone.blocks.{i}.") for i in range(SPLIT))]
    assert len(frozen) > 10
    for k in frozen:
        np.testing.assert_array_equal(got[k], start[k], err_msg=k)
    assert not np.array_equal(got["aggregator.assign_w"],
                              start["aggregator.assign_w"])


def test_checkpoint_at_2x2_resumes_at_1x1(runs):
    """The (2, 2) run's checkpoint after two steps is the one-device
    file (same keys and shapes, values within AdamW's bound), and a 1x1
    mesh restored from it takes the third step as the one-device run
    does."""
    ck = torch.load(runs["ckpt"], map_location=CPU, weights_only=True)
    one = runs["one"]["mlp", "adamw"]
    assert ck["step"] == SAVE_AFTER + 1
    assert ck["model"].keys() == one["params"][SAVE_AFTER].keys()
    for k, v in ck["model"].items():
        np.testing.assert_allclose(v.numpy(), one["params"][SAVE_AFTER][k],
                                   rtol=0, atol=ADAM_ATOL, err_msg=k)
    for st in ck["optimizer"]["state"].values():
        assert st["exp_avg"].shape == st["exp_avg_sq"].shape
    got = runs["resumed"]
    _check(got["losses"], got["params"], one["losses"][2:],
           one["params"][2], "adamw")


def test_dryrun_multichip_on_the_cpu(capsys):
    """The dry run's six paths on a 4-entry CPU mesh (four gloo processes
    for the train step, two for the multi-process path)."""
    out = dryrun_multichip(4, device="cpu")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("dryrun_multichip ok: mesh=(2x2) backend=gloo")
    assert out["train"]["mesh"] == (2, 2)
    assert out["multihost"].startswith("ok")
