"""VPR training on one device: the VLAD-BuFF trainer.

Counterpart of ``revisit_anything_tpu/training/train.py``'s unsharded
path: ``VPRTrainConfig`` (:38-62), ``backbone_forward`` (:71),
``model_forward``, the trainable set of ``_trainable_mask`` (:101),
``make_schedule`` (:128), ``make_optimizer`` (:154),
``create_train_state`` (:171), ``loss_fn`` and ``train_step``
(:202-229). A DINOv2 backbone whose first depth − N blocks run under
``torch.no_grad()`` (JAX's ``stop_gradient``) and stay frozen, the last N
blocks and the final norm trainable, NetVLAD(+AntiBurst) on top, the
MultiSimilarity loss and miner.

The machine with the card has no optax, so the schedules are the port's
own functions of the step (optax's formulas, in f32) and the optimizers
are torch's: ``AdamW`` with optax's defaults (β 0.9 / 0.999, eps 1e-8,
decay decoupled and scaled by the scheduled lr) and ``SGD`` (coupled
weight decay, then momentum with no dampening), each given the
scheduled lr before its step. The trainable set is carried as
``requires_grad`` and as the optimizer's parameter list, so frozen
parameters are never written: they stay bit-identical, as the JAX step
leaves them (their gradients are exactly zero there, and ``optax.masked``
adds that zero).

The sharded step (JAX :232-285: ``_tp_spec_for``,
``param_sharding_rules``, ``make_sharded_train_step``) runs SPMD on
``torch.distributed``, one process a position of a ("data", "model")
mesh: the batch split over "data", the FFN hidden dimension and the
NetVLAD clusters over "model" (``parallel.collectives``), the loss on
the global batch, with the one-device step's body. A flash-attention
(K1) length on the card (N >= 1024 tokens) in a trainable block raises,
since K1 has no backward; the trainer's 224x224 crops are 257 tokens.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from revisit_anything_tpu_torch.models import dinov2 as dn
from revisit_anything_tpu_torch.parallel.collectives import (MeshAxis,
                                                            owned_ranges)
from revisit_anything_tpu_torch.training.aggregators import (
    CRN_FROZEN, netvlad_forward, netvlad_init)
from revisit_anything_tpu_torch.training.losses import multi_similarity_loss


@dataclasses.dataclass(frozen=True)
class VPRTrainConfig:
    backbone: dn.DinoV2Config = dn.VIT_B14
    num_trainable_blocks: int = 4          # train.py --num_trainable_blocks
    clusters: int = 64
    antiburst: bool = True
    lr: float = 6e-5                       # train.py --lr
    weight_decay: float = 9.5e-9           # train.py --weight_decay
    warmup_steps: int = 600                # unused by the reference's
    #                                        schedules
    total_steps: int = 20000
    lin_end_factor: float = 0.2            # train.py lr_sched_args
    lin_total_iters: int = 4000
    imgs_per_place: int = 4
    optimizer: str = "adamw"               # sgd | adam | adamw
    momentum: float = 0.9                  # sgd
    lr_sched: str = "linear"               # linear | multistep | cosine
    milestones: tuple = (5, 10, 15)        # multistep (unit: epochs->steps
    steps_per_epoch: int = 0               # 0: milestones are raw steps
    gamma: float = 0.3                     # multistep decay
    cosine_t_max: int = 0                  # cosine; 0 -> total_steps


class VPRModel(nn.Module):
    """The trained model: ``backbone`` (a ``dinov2.DinoV2``) and
    ``aggregator`` (the NetVLAD module), the JAX tree's two halves."""

    def __init__(self, backbone: dn.DinoV2, aggregator: nn.Module):
        super().__init__()
        self.backbone = backbone
        self.aggregator = aggregator


@dataclasses.dataclass
class VPRTrainState:
    model: VPRModel
    optimizer: torch.optim.Optimizer
    step: int

    # what a checkpoint reads and writes (``training/checkpoint.py``);
    # a sharded state gathers and slices here

    def state_dicts(self) -> Tuple[dict, dict]:
        """The model's and the optimizer's state dicts."""
        return self.model.state_dict(), self.optimizer.state_dict()

    def load_state_dicts(self, model_sd: dict, optimizer_sd: dict) -> None:
        self.model.load_state_dict(model_sd)
        self.optimizer.load_state_dict(optimizer_sd)

    @property
    def writes_files(self) -> bool:
        """Whether this process writes the checkpoint files."""
        return True

    def barrier(self) -> None:
        """Wait for every process of the state (one here)."""


def backbone_forward(backbone: dn.DinoV2, cfg: dn.DinoV2Config,
                     images: torch.Tensor, num_trainable: int,
                     tp=None) -> torch.Tensor:
    """[B, H, W, 3] → [B, D, gh, gw] patch features; gradients flow only
    through the last ``num_trainable`` blocks and the final norm. ``tp``
    splits every block's FFN (``dinov2._ffn``)."""
    if num_trainable > cfg.depth:
        raise ValueError(f"num_trainable_blocks {num_trainable} exceeds "
                         f"backbone depth {cfg.depth}")
    split = cfg.depth - num_trainable
    with torch.no_grad():
        x = dn.embed_patches(backbone, cfg, images)
        for blk in backbone.blocks[:split]:
            x = dn._block(x, blk, cfg, tp)
    for blk in backbone.blocks[split:]:
        x = dn._block(x, blk, cfg, tp)
    return dn.patch_features(backbone.norm(x, cfg.eps), cfg,
                             images.shape[1:3])


def model_forward(model: VPRModel, cfg: VPRTrainConfig,
                  images: torch.Tensor, tp=None) -> torch.Tensor:
    """Images → VLAD descriptors [B, clusters·D]; ``tp``: the "model"
    axis of a sharded state (the descriptor is gathered over it)."""
    feats = backbone_forward(model.backbone, cfg.backbone, images,
                             cfg.num_trainable_blocks, tp)
    return netvlad_forward(model.aggregator, feats, tp=tp)


def _trainable_mask(model: VPRModel, cfg: VPRTrainConfig) -> dict:
    """{parameter name: trainable}: the aggregator (but CRN's fixed
    accumulation conv), the last N backbone blocks and the final norm."""
    if cfg.num_trainable_blocks > cfg.backbone.depth:
        raise ValueError(f"num_trainable_blocks {cfg.num_trainable_blocks}"
                         f" exceeds backbone depth {cfg.backbone.depth}")
    split = cfg.backbone.depth - cfg.num_trainable_blocks
    trainable = tuple(f"backbone.blocks.{i}."
                      for i in range(split, cfg.backbone.depth))
    trainable += ("backbone.norm.", "aggregator.")
    frozen = tuple(f"aggregator.crn.{k}" for k in CRN_FROZEN)
    return {name: name.startswith(trainable) and name not in frozen
            for name, _ in model.named_parameters()}


def make_schedule(cfg: VPRTrainConfig) -> Callable[[int], float]:
    """The lr at a step (0-based): "linear" (torch LinearLR: lr →
    lr·lin_end_factor over lin_total_iters steps, constant after, no
    warmup), "multistep" (×gamma at each milestone·unit) or "cosine"
    (cosine decay to 0 over t_max). Each is optax's schedule formula in
    f32, as the JAX trainer evaluates it."""
    f32 = np.float32
    sched = cfg.lr_sched.lower()
    if sched == "linear":
        end = cfg.lr * cfg.lin_end_factor
        span = f32(cfg.lr - end)
        steps = cfg.lin_total_iters

        def linear(step: int) -> float:
            if steps <= 0:
                return float(f32(cfg.lr))
            count = f32(min(max(step, 0), steps))
            frac = f32(1) - count / f32(steps)
            return float(span * frac + f32(end))
        return linear
    if sched == "multistep":
        unit = cfg.steps_per_epoch if cfg.steps_per_epoch > 0 else 1
        bounds = sorted({int(m * unit): f32(cfg.gamma)
                         for m in cfg.milestones}.items())

        def multistep(step: int) -> float:
            v = f32(cfg.lr)
            for threshold, scale in bounds:
                if step >= threshold:
                    v = scale * v
            return float(v)
        return multistep
    if sched == "cosine":
        t_max = f32(cfg.cosine_t_max or cfg.total_steps)
        if not t_max > 0:
            raise ValueError("cosine schedule needs a positive t_max")

        def cosine(step: int) -> float:
            count = min(f32(step), t_max)
            decay = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * count
                                                / t_max, dtype=f32))
            return float(f32(cfg.lr) * decay)
        return cosine
    raise ValueError(f"unknown lr_sched {cfg.lr_sched!r}")


def make_optimizer(cfg: VPRTrainConfig,
                   params: List[nn.Parameter]) -> torch.optim.Optimizer:
    """AdamW for "adamw" and "adam" (the reference's "adam" is AdamW
    too), SGD with momentum for "sgd", over the trainable ``params``; the
    lr is set from :func:`make_schedule` before every step."""
    opt = cfg.optimizer.lower()
    lr0 = make_schedule(cfg)(0)
    if opt == "sgd":
        return torch.optim.SGD(params, lr=lr0, momentum=cfg.momentum,
                               dampening=0.0,
                               weight_decay=cfg.weight_decay)
    if opt in ("adamw", "adam"):
        return torch.optim.AdamW(params, lr=lr0, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=cfg.weight_decay)
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")


def create_train_state(cfg: VPRTrainConfig, seed: int = 0,
                       init_descriptors=None, device="cuda",
                       model: VPRModel = None) -> VPRTrainState:
    """A fresh train state: seeded f32 weights on ``device`` (or the
    given ``model``), the trainable set marked, the optimizer at step 0.

    ``init_descriptors`` [N, D]: sample backbone descriptors for the
    reference's NetVLAD cluster initialization (euclidean k-means, 100
    iterations, then ``netvlad_init_from_cluster_centers``); without
    them the aggregator starts from a seeded random init."""
    if model is None:
        from revisit_anything_tpu_torch.training.aggregators import (
            netvlad_init_from_cluster_centers)
        from revisit_anything_tpu_torch.weights import init_dino
        gen = torch.Generator(device=device).manual_seed(seed)
        backbone = init_dino(cfg.backbone, gen, device, torch.float32)
        if init_descriptors is not None:
            from revisit_anything_tpu_torch.ops.kmeans import kmeans_fit
            x = torch.as_tensor(np.asarray(init_descriptors, np.float32),
                                device=device)
            centers, _ = kmeans_fit(x, cfg.clusters, gen, num_iters=100,
                                    mode="euclidean")
            aggregator = netvlad_init_from_cluster_centers(
                centers, descriptors=x, antiburst=cfg.antiburst)
        else:
            aggregator = netvlad_init(gen, cfg.backbone.embed_dim,
                                      cfg.clusters, cfg.antiburst,
                                      device=device)
        model = VPRModel(backbone, aggregator)
    mask = _trainable_mask(model, cfg)
    for name, p in model.named_parameters():
        p.requires_grad_(mask[name])
    params = [p for name, p in model.named_parameters() if mask[name]]
    return VPRTrainState(model, make_optimizer(cfg, params), 0)


def loss_fn(model: VPRModel, cfg: VPRTrainConfig, images: torch.Tensor,
            labels: torch.Tensor) -> torch.Tensor:
    return multi_similarity_loss(model_forward(model, cfg, images), labels)


def _step_impl(state: VPRTrainState, cfg: VPRTrainConfig,
               loss_of: Callable[[], torch.Tensor],
               reduce_grads: Optional[Callable[[], None]] = None
               ) -> torch.Tensor:
    """The step body the one-device and the sharded steps share (JAX
    ``_step_impl``): the scheduled lr, the loss, its backward,
    ``reduce_grads`` (the sharded step's collectives), the optimizer's
    step on the trainable set."""
    lr = make_schedule(cfg)(state.step)
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    state.optimizer.zero_grad(set_to_none=True)
    loss = loss_of()
    loss.backward()
    if reduce_grads is not None:
        reduce_grads()
    state.optimizer.step()
    state.step += 1
    return loss.detach()


def train_step(state: VPRTrainState, cfg: VPRTrainConfig,
               images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """One optimization step on ``state`` (in place): images [B, H, W, 3]
    f32 (normalized), labels [B] place ids. Returns the loss (before the
    update) and advances ``state.step``."""
    dev = next(state.model.parameters()).device
    images = torch.as_tensor(images, device=dev)
    labels = torch.as_tensor(labels, device=dev)
    return _step_impl(state, cfg,
                      lambda: loss_fn(state.model, cfg, images, labels))


# ---------------------------------------------------------------------------
# Several devices: data x tensor parallel on torch.distributed
# ---------------------------------------------------------------------------

COLUMN = (None, "model")               # JAX P(None, "model")
ROW = ("model", None)                  # JAX P("model", None)
REPLICATED = ()                        # JAX P()
_COLUMN_SUFFIXES = ("fc1.w", "w12.w", "lin1.w", "assign_w")
_ROW_SUFFIXES = ("fc2.w", "w3.w", "lin2.w", "centroids")
# 1-d biases of column-split products: whole on every rank (JAX
# replicates every leaf under 2-d), each rank adding its columns' slice,
# so each rank's gradient covers its own columns only
_SLICED_BIASES = ("fc1.b", "w12.b")


def _tp_spec_for(name: str, shape) -> tuple:
    """JAX ``_tp_spec_for`` (:232-250) by a parameter's name (the JAX
    path with "." for "/"): the ``PartitionSpec``'s entries as a tuple."""
    if len(shape) < 2:
        return REPLICATED
    if name.endswith(_COLUMN_SUFFIXES):
        return COLUMN
    if name.endswith(_ROW_SUFFIXES):
        return ROW
    return REPLICATED


def _halves(name: str) -> int:
    """SwiGLU's fused ``w12`` is [x1 | x2], each half split on its own."""
    return 2 if name.endswith(("w12.w", "w12.b")) else 1


def param_sharding_rules(mesh, model: nn.Module) -> Dict[str, tuple]:
    """{parameter name: spec} (JAX :253-258): fc1 / w12 / lin1 weights
    and ``assign_w`` split by columns over "model" (``COLUMN``), fc2 / w3
    / lin2 weights and ``centroids`` by rows (``ROW``), every other leaf
    replicated (``REPLICATED``). A spec is the JAX ``PartitionSpec``'s
    entries as a tuple; an optimizer moment takes its parameter's. Raises
    where the "model" size does not divide a split dimension."""
    tp = mesh.shape["model"]
    specs = {}
    for name, p in model.named_parameters():
        spec = _tp_spec_for(name, p.shape)
        if spec:
            owned_ranges(p.shape[spec.index("model")], tp, 0, _halves(name))
        specs[name] = spec
    return specs


def _check_shardable(model: VPRModel) -> None:
    agg = model.aggregator
    if not hasattr(agg, "assign_w") or any(
            hasattr(agg, k) for k in ("pca_rot", "bottleneck", "nv_mlp")):
        raise ValueError("the sharded step trains NetVLAD(+AntiBurst) "
                         "without a pre-projection, as create_train_state "
                         "builds it")


def _axis_index(mesh, rank: int) -> Tuple[int, int]:
    """(data index, model index) of ``rank``: rank r owns
    ``mesh.devices.flat[r]``."""
    if tuple(mesh.axis_names) != ("data", "model"):
        raise ValueError(f"a (\"data\", \"model\") mesh, got axes "
                         f"{mesh.axis_names}")
    return divmod(rank, mesh.shape["model"])


def _local(axis: MeshAxis, name: str, spec: tuple,
           t: torch.Tensor) -> torch.Tensor:
    if not spec:
        return t
    return axis.local(t, spec.index("model"), _halves(name))


def _trainable_names(model: nn.Module) -> List[str]:
    """The optimizer's parameters in its order (``create_train_state``)."""
    return [n for n, p in model.named_parameters() if p.requires_grad]


def _map_moments(opt_sd: dict, names: List[str], fn) -> dict:
    """An optimizer state dict with ``fn(name, tensor)`` applied to every
    per-parameter tensor of its state (moments, momentum; the scalar step
    stays)."""
    state = {i: {k: fn(names[i], v) if torch.is_tensor(v) and v.dim() else v
                 for k, v in st.items()}
             for i, st in opt_sd["state"].items()}
    return {"state": state, "param_groups": opt_sd["param_groups"]}


def shard_model(model: VPRModel, mesh, rank: int,
                device=None) -> VPRModel:
    """Rank ``rank``'s copy of a one-device ``model`` on ``device``
    (default ``mesh.devices.flat[rank]``): every split leaf of
    :func:`param_sharding_rules` holds this rank's block along "model"
    (w12's x1 and x2 blocks), every other leaf is whole;
    ``requires_grad`` as in ``model``."""
    _check_shardable(model)
    specs = param_sharding_rules(mesh, model)
    axis = MeshAxis(None, mesh.shape["model"], _axis_index(mesh, rank)[1])
    device = mesh.devices.flat[rank] if device is None else device
    memo = {id(model.backbone._pos_cache): {}}
    for name, p in model.named_parameters():
        t = _local(axis, name, specs[name], p.detach())
        memo[id(p)] = nn.Parameter(t.to(device, copy=True),
                                   requires_grad=p.requires_grad)
    return copy.deepcopy(model, memo)


@dataclasses.dataclass
class ShardedTrainState(VPRTrainState):
    """One rank's part of a train state sharded over a ("data", "model")
    mesh: ``model`` holds this rank's shards (:func:`shard_model`),
    ``optimizer`` steps them (its moments sliced like them), ``data`` and
    ``tp`` are this rank's mesh axes. A checkpoint of it gathers the whole
    state, rank 0 writes it, and a restore slices it, so the file is the
    one-device state's."""
    mesh: object
    rank: int
    data: MeshAxis
    tp: MeshAxis
    specs: Dict[str, tuple]

    @property
    def device(self) -> torch.device:
        return self.mesh.devices.flat[self.rank]

    def _whole(self, name: str, t: torch.Tensor) -> torch.Tensor:
        spec = self.specs.get(name, REPLICATED)
        if not spec:
            return t
        return self.tp.assemble(t, spec.index("model"), _halves(name))

    def _part(self, name: str, t: torch.Tensor) -> torch.Tensor:
        return _local(self.tp, name, self.specs.get(name, REPLICATED), t)

    def state_dicts(self) -> Tuple[dict, dict]:
        """The whole model's and optimizer's state dicts, gathered over
        "model" (a collective: every rank calls it)."""
        model_sd = {k: self._whole(k, v)
                    for k, v in self.model.state_dict().items()}
        names = _trainable_names(self.model)
        return model_sd, _map_moments(self.optimizer.state_dict(), names,
                                      self._whole)

    def load_state_dicts(self, model_sd: dict, optimizer_sd: dict) -> None:
        """Load a whole (one-device) state: each leaf sliced to this
        rank's block."""
        own = self.model.state_dict()
        if set(model_sd) != set(own):
            raise KeyError(f"state dict keys differ: "
                           f"{sorted(set(model_sd) ^ set(own))[:5]}")
        with torch.no_grad():
            for k, v in own.items():
                v.copy_(self._part(k, model_sd[k]))
        self.optimizer.load_state_dict(_map_moments(
            optimizer_sd, _trainable_names(self.model), self._part))

    @property
    def writes_files(self) -> bool:
        return self.rank == 0

    def barrier(self) -> None:
        import torch.distributed as dist
        dist.barrier()

    def reduce_grads(self) -> None:
        """After the backward: each sliced bias's gradient gathered over
        "model" from every rank's own columns, then every trainable
        gradient summed over "data" (one flat all-reduce)."""
        params = [(n, p) for n, p in self.model.named_parameters()
                  if p.requires_grad]
        for n, p in params:
            if n.endswith(_SLICED_BIASES):
                h = _halves(n)
                p.grad = self.tp.assemble(self.tp.local(p.grad, 0, h), 0, h)
        if self.data.size == 1:
            return
        flat = self.data.all_sum_(torch.cat([p.grad.reshape(-1)
                                             for _, p in params]))
        off = 0
        for _, p in params:
            p.grad.copy_(flat[off:off + p.numel()].view_as(p.grad))
            off += p.numel()


def make_sharded_train_step(mesh, cfg: VPRTrainConfig,
                            state: VPRTrainState):
    """The train step over a (dp, tp) ``mesh`` with axes ("data",
    "model"), SPMD: one process a mesh position, rank r owning
    ``mesh.devices.flat[r]`` (data index r // tp, model index r % tp).
    ``torch.distributed`` must be initialized with world size
    ``mesh.size`` (one process is a 1x1 mesh); every process calls this
    with the same one-device ``state``. Returns ``(step_fn,
    sharded_state)``: ``step_fn(sharded_state, images, labels)`` takes
    the global batch (images [B, H, W, 3], labels [B], B divisible by
    dp), runs this rank's B / dp rows, gathers the descriptors over
    "data" so the miner and the loss see the global batch, and returns
    the global loss (JAX :261-285)."""
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_world_size() != mesh.size:
        raise RuntimeError(f"make_sharded_train_step needs "
                           f"torch.distributed initialized with world "
                           f"size {mesh.size} (one process a mesh device)")
    rank = dist.get_rank()
    d, m = _axis_index(mesh, rank)
    dp, tp = mesh.shape["data"], mesh.shape["model"]
    # every process creates every group, in one order
    rows = [dist.new_group([i * tp + j for j in range(tp)])
            for i in range(dp)]
    cols = [dist.new_group([i * tp + j for i in range(dp)])
            for j in range(tp)]
    specs = param_sharding_rules(mesh, state.model)
    local = create_train_state(cfg, model=shard_model(state.model, mesh,
                                                      rank))
    sharded = ShardedTrainState(local.model, local.optimizer, state.step,
                                mesh, rank, MeshAxis(cols[m], dp, d),
                                MeshAxis(rows[d], tp, m), specs)
    sharded.optimizer.load_state_dict(_map_moments(
        state.optimizer.state_dict(), _trainable_names(state.model),
        sharded._part))

    def step_fn(st: ShardedTrainState, images, labels) -> torch.Tensor:
        labels = torch.as_tensor(labels).to(st.device)
        images = torch.as_tensor(images)
        if images.shape[0] % st.data.size:
            raise ValueError(f"a batch of {images.shape[0]} does not split "
                             f"over {st.data.size} data ranks")
        per = images.shape[0] // st.data.size
        mine = images[st.data.rank * per:(st.data.rank + 1) * per].to(
            st.device)

        def loss_of():
            desc = model_forward(st.model, cfg, mine, tp=st.tp)
            return multi_similarity_loss(st.data.gather(desc, 0), labels)
        return _step_impl(st, cfg, loss_of, st.reduce_grads)

    return step_fn, sharded
