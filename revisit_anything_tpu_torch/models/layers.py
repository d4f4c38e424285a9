"""Parameter-holding building blocks shared by the SAM and DINOv2 ports.

Weights keep the JAX package's layout (a dense weight is [in, out]) and
its attribute names, so a JAX parameter tree maps onto the module tree
name for name (:func:`load_tree`). Inference only: every parameter
is created with ``requires_grad=False``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

_CONSTANTS: Dict[tuple, torch.Tensor] = {}


def device_constant(key: tuple, device, make: Callable) -> torch.Tensor:
    """A constant built and uploaded once per (``key``, device).

    ``make()`` returns it on the host (a numpy array or a CPU tensor);
    later calls return the cached copy on ``device``, so a hot path makes
    no host→device copy for it (a copy from pageable memory would
    synchronize the stream). Built outside inference mode, so callers in
    any mode may use it. The cache is shared by the process: each value
    is a pure function of its key, so two callers racing on a miss only
    build it twice. Callers must not write to it."""
    k = (key, torch.device(device))
    t = _CONSTANTS.get(k)
    if t is None:
        with torch.inference_mode(False):
            v = make()
            if not isinstance(v, torch.Tensor):
                v = torch.from_numpy(np.ascontiguousarray(v))
            t = v.to(k[1])
        _CONSTANTS[k] = t
    return t


def load_tree(module: nn.Module, tree, path: str = "") -> None:
    """Copy a nested dict/list tree of arrays into ``module`` by name.

    Dict keys name attributes, list positions index ModuleLists. A None
    leaf requires the module's entry to be None. A key without a
    counterpart, or a shape that differs, raises. Leaves are copied one at a time (cast to the
    entry's dtype on its device), so a tree of views into a checkpoint's
    state dict loads without a second copy of the model on the host."""
    if isinstance(tree, dict):
        for key, sub in tree.items():
            if not hasattr(module, key):
                raise KeyError(f"no port entry for {path + key}")
            child = getattr(module, key)
            if isinstance(child, nn.Module):
                load_tree(child, sub, f"{path}{key}.")
            else:
                _assign(child, sub, path + key)
    elif isinstance(tree, (list, tuple)):
        if len(tree) != len(module):
            raise ValueError(f"{path}: {len(tree)} entries vs "
                             f"{len(module)} in the port")
        for i, sub in enumerate(tree):
            load_tree(module[i], sub, f"{path}{i}.")
    else:
        raise TypeError(f"{path}: unexpected tree node {type(tree)}")


def _assign(target: Optional[torch.Tensor], value, name: str) -> None:
    if value is None or target is None:
        if value is not None or target is not None:
            raise ValueError(f"{name}: None in only one of the trees")
        return
    arr = np.asarray(value, dtype=np.float32)
    if tuple(arr.shape) != tuple(target.shape):
        raise ValueError(f"{name}: shape {arr.shape} vs port "
                         f"{tuple(target.shape)}")
    # a read-only array (a JAX leaf's view) is copied, not wrapped
    src = torch.from_numpy(arr) if arr.flags.writeable else torch.tensor(arr)
    with torch.no_grad():
        target.copy_(src)


def tree_module(tree, *, dtype=torch.float32, device="cuda") -> nn.Module:
    """A module whose attributes mirror a parameter tree (nested dicts of
    arrays or tensors, lists as ``nn.ModuleList``s), leaf for leaf, for
    the parameter sets that have no fixed class (the aggregators, the
    WPCA layer): dict keys become attributes. Parameters are created with
    ``requires_grad=False``."""
    if isinstance(tree, (list, tuple)):
        return nn.ModuleList(tree_module(t, dtype=dtype, device=device)
                             for t in tree)
    module = nn.Module()
    for key, sub in tree.items():
        if isinstance(sub, (dict, list, tuple)):
            module.add_module(key, tree_module(sub, dtype=dtype,
                                               device=device))
        else:
            t = (sub.detach() if isinstance(sub, torch.Tensor) else
                 torch.from_numpy(np.array(sub, dtype=np.float32)))
            module.register_parameter(key, nn.Parameter(
                t.to(device=device, dtype=dtype, copy=True),
                requires_grad=False))
    return module


def module_tree(module: nn.Module):
    """The parameter tree of ``module`` as nested dicts (lists for
    ``nn.ModuleList``s) of f32 numpy arrays: the JAX package's layout for
    the port's modules, whose names follow its trees (entries that are
    None in the module are left out)."""
    if isinstance(module, nn.ModuleList):
        return [module_tree(m) for m in module]
    out = {k: p.detach().to("cpu", torch.float32).numpy()
           for k, p in module.named_parameters(recurse=False)}
    for k, child in module.named_children():
        out[k] = module_tree(child)
    return out


def state_array(sd, key: str) -> np.ndarray:
    """Entry ``key`` of a checkpoint's state dict (tensors or arrays) as
    an f32 numpy array: a view of it where it is already one."""
    v = sd[key]
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", torch.float32).numpy()
    return np.asarray(v, dtype=np.float32)


def linear_leaves(sd, prefix: str) -> dict:
    """A torch Linear's ``weight`` [out, in] and ``bias`` → the tree's
    {w: [in, out] (a transposed view), b: [out] or None}."""
    bias = prefix + ".bias"
    return {"w": state_array(sd, prefix + ".weight").T,
            "b": state_array(sd, bias) if bias in sd else None}


def norm_leaves(sd, prefix: str) -> dict:
    """A torch LayerNorm's ``weight`` and ``bias`` → {scale, bias}."""
    return {"scale": state_array(sd, prefix + ".weight"),
            "bias": state_array(sd, prefix + ".bias")}


def param(*shape: int, dtype: torch.dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class Dense(nn.Module):
    """y = x @ w (rounded to x's dtype) + b — the JAX ``_dense`` order:
    round the product first, then add the bias."""

    def __init__(self, n_in: int, n_out: int, *, bias: bool = True,
                 dtype: torch.dtype, device=None):
        super().__init__()
        self.w = param(n_in, n_out, dtype=dtype, device=device)
        self.b: Optional[nn.Parameter] = (
            param(n_out, dtype=dtype, device=device) if bias else None)

    def nobias(self, x: torch.Tensor) -> torch.Tensor:
        return torch.matmul(x, self.w.to(x.dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.nobias(x)
        return y + self.b if self.b is not None else y


class LayerNorm(nn.Module):
    """LayerNorm over the last axis, computed in f32 from any storage
    dtype and returned in the input's dtype (two-pass variance)."""

    def __init__(self, n: int, *, dtype: torch.dtype, device=None):
        super().__init__()
        self.scale = param(n, dtype=dtype, device=device)
        self.bias = param(n, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, eps: float) -> torch.Tensor:
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, unbiased=False, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps) * self.scale + self.bias
        return y.to(x.dtype)


def mlp(x: torch.Tensor, layers) -> torch.Tensor:
    """Dense stack with ReLU between layers (SAM's MLP heads)."""
    for i, layer in enumerate(layers):
        x = layer(x)
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x
