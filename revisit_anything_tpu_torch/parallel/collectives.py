"""Collectives over one axis of a device mesh, with the backward each
use in the sharded train step needs.

The JAX package's sharded step (``revisit_anything_tpu/training/
train.py:261-285``) is one program over the mesh, and XLA inserts its
collectives. The port runs it SPMD, one process a mesh position on
``torch.distributed``, so the collectives are written out, as Megatron
writes them:

- :meth:`MeshAxis.copy_in` (Megatron's *f*): identity forward, all-reduce
  backward. A replicated tensor enters rank-local work (a column-parallel
  product, this rank's clusters) through it: each rank's gradient of it
  covers only its own part.
- :meth:`MeshAxis.reduce_out` (*g*): all-reduce forward, identity
  backward, after a row-parallel product or a sum over split clusters;
  every rank then computes the same loss from the sum, so one rank's
  gradient of the sum is the whole of it.
- :meth:`MeshAxis.gather`: all-gather forward, this rank's slice
  backward. Every rank computes the same loss from the gathered tensor,
  so a summing backward would multiply the gradient by the axis size.

An axis of one rank communicates nothing (its collectives return their
input). Nothing here imports ``torch.distributed`` at module import.
"""

from __future__ import annotations

from typing import List, Tuple

import torch


def owned_ranges(n: int, size: int, rank: int,
                 halves: int = 1) -> List[Tuple[int, int]]:
    """The [start, stop) ranges of a length-``n`` axis that ``rank`` holds
    when the axis is split into ``size`` equal blocks. With ``halves`` 2
    each half is split on its own (SwiGLU's fused ``w12`` is [x1 | x2]:
    rank m holds the m-th block of x1 and the m-th block of x2, where a
    contiguous split would give one rank all of x1). Raises where
    ``halves · size`` does not divide ``n``."""
    if n % (halves * size):
        raise ValueError(f"an axis of {n} does not split into {size} "
                         f"blocks (x{halves} halves)")
    part = n // halves
    blk = part // size
    return [(h * part + rank * blk, h * part + (rank + 1) * blk)
            for h in range(halves)]


class MeshAxis:
    """One axis of the mesh as this rank sees it: ``group``, the process
    group of the ranks that share every other mesh index (None where only
    the slicing helpers are used), its ``size`` and this rank's index
    ``rank`` along it."""

    def __init__(self, group, size: int, rank: int):
        self.group, self.size, self.rank = group, size, rank

    # -- slicing (no communication) --

    def local(self, x: torch.Tensor, dim: int, halves: int = 1
              ) -> torch.Tensor:
        """This rank's block of ``x`` along ``dim`` (see
        :func:`owned_ranges`)."""
        parts = [x.narrow(dim, a, b - a) for a, b in owned_ranges(
            x.shape[dim], self.size, self.rank, halves)]
        return parts[0] if halves == 1 else torch.cat(parts, dim)

    # -- collectives with their backward (autograd) --

    def copy_in(self, x: torch.Tensor) -> torch.Tensor:
        """Identity; the backward all-reduces (sums) the gradient."""
        return _CopyIn.apply(x, self)

    def reduce_out(self, x: torch.Tensor) -> torch.Tensor:
        """All-reduce (sum); the backward passes the gradient on."""
        return _ReduceOut.apply(x, self)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``dim`` in rank order
        (equal shapes on every rank); the backward takes this rank's
        slice."""
        return _Gather.apply(x, self, dim)

    # -- without autograd --

    def all_max(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise maximum over the axis (a new tensor, no
        gradient)."""
        out = x.detach().clone()
        self._all_reduce(out, "max")
        return out

    def all_sum_(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` over the axis in place (gradients after the
        backward); returns ``x``."""
        self._all_reduce(x, "sum")
        return x

    def all_gather(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``x`` (equal shapes), in rank order."""
        import torch.distributed as dist
        if self.size == 1:
            return [x]
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return parts

    def assemble(self, x: torch.Tensor, dim: int, halves: int = 1
                 ) -> torch.Tensor:
        """The whole tensor from every rank's :meth:`local` block of it:
        the inverse of :meth:`local`, gathered over the axis."""
        parts = self.all_gather(x)
        if halves == 1:
            return torch.cat(parts, dim)
        blk = x.shape[dim] // halves
        return torch.cat([p.narrow(dim, h * blk, blk)
                          for h in range(halves) for p in parts], dim)

    def _all_reduce(self, x: torch.Tensor, op: str) -> None:
        import torch.distributed as dist
        if self.size == 1:
            return
        dist.all_reduce(x, op={"sum": dist.ReduceOp.SUM,
                               "max": dist.ReduceOp.MAX}[op],
                        group=self.group)


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.axis.all_sum_(grad.contiguous().clone()), None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return axis.all_sum_(x.contiguous().clone())

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim, ctx.n = axis, dim, x.shape[dim]
        return torch.cat(axis.all_gather(x), dim)

    @staticmethod
    def backward(ctx, grad):
        return (grad.narrow(ctx.dim, ctx.axis.rank * ctx.n, ctx.n),
                None, None)
