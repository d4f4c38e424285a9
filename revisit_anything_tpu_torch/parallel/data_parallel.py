"""Data-parallel inference over a mesh: the extraction stages (SAM
encoding, DINOv2 dense features) are independent per image.

Counterpart of ``revisit_anything_tpu/parallel/data_parallel.py``
``data_parallel_apply`` (:33-68). JAX shards the batch over the mesh's
data axis and replicates the parameters; here the batch is padded to a
multiple of the axis, split into one chunk a device, each chunk run on
that device's replica (:meth:`Mesh.replicate`: made once per (module,
device) and kept, so the weights are not copied again for every batch:
the host re-upload the JAX code's ``_REPL_PARAMS`` cache exists to
avoid), and the outputs gathered on the mesh's first device.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from revisit_anything_tpu_torch.parallel.mesh import Mesh, pad_to_multiple


def data_parallel_apply(fn: Callable, module_or_params, batch, mesh: Mesh,
                        axis: str = "data", pad_value=0.0):
    """``fn(replica, chunk)`` over ``batch``'s leading dimension split
    across the devices of ``axis``; returns the outputs in batch order
    (the padding dropped): a tensor on the mesh's first device, or a
    numpy array for a numpy ``batch``. ``fn`` returns one tensor with
    the chunk's leading dimension."""
    host = isinstance(batch, np.ndarray)
    devs = mesh.axis_devices(axis)
    x = torch.from_numpy(batch) if host else batch
    n = x.shape[0]
    x, _ = pad_to_multiple(x, len(devs), 0, pad_value)
    chunks = mesh.split(x, axis)
    # issued back to back: each device starts as soon as its chunk is
    # queued, not when the previous device finishes
    outs = [fn(mesh.replicate(module_or_params, d), c)
            for d, c in zip(devs, chunks)]
    out = torch.cat([o.to(devs[0]) for o in outs])[:n]
    return out.cpu().numpy() if host else out
