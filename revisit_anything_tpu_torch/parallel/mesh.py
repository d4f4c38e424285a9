"""Device meshes for the data-parallel paths: the extractors' batches,
the evaluator's sharded kNN and the server's row-sharded database.

Counterpart of ``revisit_anything_tpu/parallel/mesh.py``: ``make_mesh``,
``auto_data_mesh``, ``resolve_mesh``, ``pad_to_multiple``, and
``batch_sharding`` / ``replicated``, which give :meth:`Mesh.split` /
:meth:`Mesh.replicate` over the mesh (the placements JAX's
``NamedSharding`` objects describe). As JAX's single-controller mesh,
one process drives every device of the mesh: a split batch's chunks are
issued back to back, each on its own device (CUDA calls return before
the device finishes, so the devices work at once), and gathered on the
mesh's first device. A mesh lists every CUDA device by default and
raises where there is none; a CPU mesh exists only where the caller
lists its devices (``[torch.device("cpu")] * 8`` in the tests). Entries
that name the same device share one replica of a module.
"""

from __future__ import annotations

import copy
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn


class Mesh:
    """An n-d array of devices with one name an axis (``devices``
    [d0, d1, ...] of ``torch.device``; ``shape`` maps a name to its
    size, as JAX's ``Mesh.shape``)."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.empty(np.shape(devices), dtype=object)
        flat = [torch.device(d) for d in np.asarray(devices,
                                                    dtype=object).ravel()]
        for i, d in enumerate(flat):
            arr.flat[i] = d
        if arr.ndim != len(axis_names):
            raise ValueError(f"{arr.ndim}-d devices, axis names "
                             f"{tuple(axis_names)}")
        self.devices = arr
        self.axis_names = tuple(axis_names)
        # (id(obj), device) → (obj, its weights' signature, replica)
        self._replicas: Dict[tuple, tuple] = {}

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_devices(self, axis: str = "data") -> List[torch.device]:
        """The devices along ``axis``, at index 0 of every other axis: a
        batch split over ``axis`` is replicated over the others, and one
        replica does the work."""
        i = self.axis_names.index(axis)
        index = [0] * self.devices.ndim
        index[i] = slice(None)
        return list(self.devices[tuple(index)])

    def split(self, x: torch.Tensor, axis: str = "data"
              ) -> List[torch.Tensor]:
        """``x``'s leading dimension in equal contiguous chunks, one on
        each device along ``axis`` (the leading size must divide; see
        :func:`pad_to_multiple`)."""
        devs = self.axis_devices(axis)
        if x.shape[0] % len(devs):
            raise ValueError(f"{x.shape[0]} rows do not split over "
                             f"{len(devs)} devices")
        return [c.to(d, non_blocking=True)
                for c, d in zip(x.chunk(len(devs)), devs)]

    def replicate(self, obj, device) -> object:
        """``obj`` (an ``nn.Module`` or a nested dict / list / tuple of
        tensors) on ``device``: ``obj`` itself where its tensors are
        there already, else a copy made once and cached per (``obj``,
        device). The copy is made again when a tensor of ``obj`` has
        been written since (its storage or version counter moved), so a
        weight load or a train step reaches the replicas."""
        device = torch.device(device)
        tensors = _tensors(obj)
        if all(_same_device(t.device, device) for t in tensors):
            return obj
        sig = tuple((t.data_ptr(), t._version) for t in tensors)
        key = (id(obj), device)
        hit = self._replicas.get(key)
        if hit is not None and hit[0] is obj and hit[1] == sig:
            return hit[2]
        with torch.inference_mode(False), torch.no_grad():
            replica = _copy_to(obj, device)
        # the strong reference keeps id(obj) from being reused
        self._replicas[key] = (obj, sig, replica)
        return replica


def _same_device(a: torch.device, b: torch.device) -> bool:
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    idx = lambda d: d.index if d.index is not None else (  # noqa: E731
        torch.cuda.current_device())
    return idx(a) == idx(b)


def _tensors(obj) -> List[torch.Tensor]:
    if isinstance(obj, nn.Module):
        return list(itertools.chain(obj.parameters(), obj.buffers()))
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        return [t for v in obj.values() for t in _tensors(v)]
    if isinstance(obj, (list, tuple)):
        return [t for v in obj for t in _tensors(v)]
    return []


def _copy_to(obj, device):
    if isinstance(obj, nn.Module):
        # parameters and buffers go straight to ``device`` (no second copy
        # where they lie); the rest of the module is copied as it is
        memo = {}
        for t in itertools.chain(obj.parameters(), obj.buffers()):
            c = t.detach().to(device)
            memo[id(t)] = (nn.Parameter(c, requires_grad=t.requires_grad)
                           if isinstance(t, nn.Parameter) else c)
        return copy.deepcopy(obj, memo)
    if isinstance(obj, torch.Tensor):
        return obj.detach().to(device)
    if isinstance(obj, dict):
        return type(obj)((k, _copy_to(v, device)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return type(obj)(_copy_to(v, device) for v in obj)
    return obj


def _cuda_devices() -> List[torch.device]:
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = ("data",),
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over ``devices`` (default: every CUDA device; raises where
    there is none), 1-D by default."""
    if devices is None:
        devices = _cuda_devices()
        if not devices:
            raise RuntimeError("make_mesh: no CUDA device; pass devices= "
                               "for a mesh on the CPU")
    devices = list(devices)
    if shape is None:
        shape = (len(devices),)
    if int(np.prod(shape)) != len(devices):
        raise ValueError(f"mesh shape {shape} != #devices {len(devices)}")
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(shape), axis_names)


def auto_data_mesh(min_devices: int = 2) -> Optional[Mesh]:
    """1-D "data" mesh over every CUDA device, or None below
    ``min_devices``."""
    devices = _cuda_devices()
    if len(devices) < min_devices:
        return None
    return make_mesh((len(devices),), ("data",), devices)


def resolve_mesh(mesh, device=None) -> Optional[Mesh]:
    """A mesh argument normalized: "auto" → :func:`auto_data_mesh` (None
    where ``device``, the caller's model device, is not a CUDA device:
    "auto" never moves a CPU model's work onto cards), None → None, a
    ``Mesh`` → itself."""
    if isinstance(mesh, str):
        if mesh != "auto":
            raise ValueError(f"mesh must be a Mesh, None or 'auto', "
                             f"got {mesh!r}")
        if device is not None and torch.device(device).type != "cuda":
            return None
        return auto_data_mesh()
    return mesh


def batch_sharding(mesh: Mesh, axis: str = "data"):
    """Placement of a batch split over ``axis``: tensor → one chunk on
    each of the axis' devices."""
    return lambda x: mesh.split(x, axis)


def replicated(mesh: Mesh):
    """Placement of a module or tensor tree on every device of the mesh:
    obj → one replica a device (shared where entries name one device)."""
    return lambda obj: [mesh.replicate(obj, d) for d in mesh.devices.flat]


def pad_to_multiple(x, multiple: int, axis: int = 0, value=0):
    """Pad ``axis`` of a numpy array or a tensor to a multiple of
    ``multiple`` with ``value`` (for an even split); returns (padded,
    n_pad)."""
    pad = (-x.shape[axis]) % multiple
    if pad == 0:
        return x, 0
    if isinstance(x, torch.Tensor):
        shape = list(x.shape)
        shape[axis] = pad
        fill = torch.full(shape, value, dtype=x.dtype, device=x.device)
        return torch.cat([x, fill], dim=axis), pad
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return np.pad(x, widths, constant_values=value), pad
