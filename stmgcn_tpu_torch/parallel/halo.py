"""Ring halo exchange over the ``region`` axis.

Counterpart of ``stmgcn_tpu/parallel/halo.py``. For banded graphs (grid
cities, where node ``i`` neighbours only nodes within index distance
``w``), a region-sharded graph convolution needs only ``w`` boundary rows
from each ring neighbour, not the whole node axis. The JAX package writes
that exchange as two ``ppermute`` calls inside ``shard_map``; here it is
one :func:`~stmgcn_tpu_torch.utils.comm.ring_exchange` of point-to-point
sends and receives between the neighbouring ranks of the region line.

:class:`HaloExchange` is its own autograd Function: the backward is the
reverse permute. The cotangent of each received halo goes back to the
rank that owns those rows, which adds it into its boundary rows; the end
ranks' zero halos have no owner and their cotangents are dropped.
"""

from __future__ import annotations

import torch

from stmgcn_tpu_torch.utils import comm

__all__ = ["HaloExchange", "halo_exchange"]


def _pad(x: torch.Tensor, got, halo: int) -> torch.Tensor:
    """A received halo, or zeros at a line's end (non-periodic)."""
    if got is not None:
        return got
    return torch.zeros((halo,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)


class HaloExchange(torch.autograd.Function):
    """``(n_local, ...) -> (halo + n_local + halo, ...)`` over the region
    line of ``mesh`` (module docstring)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, halo: int, mesh, axis: str) -> torch.Tensor:
        ctx.halo, ctx.mesh, ctx.axis = halo, mesh, axis
        # my leading rows are the previous rank's right halo, my trailing
        # rows the next rank's left halo
        from_prev, from_next = comm.ring_exchange(x[:halo], x[-halo:], axis, mesh, what="halo")
        return torch.cat([_pad(x, from_prev, halo), x, _pad(x, from_next, halo)])

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        h = ctx.halo
        # the left halo's cotangent belongs to the previous rank's trailing
        # rows, the right halo's to the next rank's leading rows
        from_prev, from_next = comm.ring_exchange(grad[:h], grad[-h:], ctx.axis, ctx.mesh,
                                                  what="halo-grad")
        dx = grad[h:-h].clone()
        if from_prev is not None:
            dx[:h] += from_prev
        if from_next is not None:
            dx[-h:] += from_next
        return dx, None, None, None


def halo_exchange(x: torch.Tensor, halo: int, mesh, axis: str = "region") -> torch.Tensor:
    """Pad this rank's node-axis block ``x`` (``(n_local, ...)``) with its
    ring neighbours' boundary rows: ``(halo + n_local + halo, ...)``, the
    leading rows the previous rank's last ``halo`` rows, the trailing rows
    the next rank's first ``halo``; the end ranks receive zeros (a banded
    adjacency has no wraparound). Every rank of the line calls it
    together. ``mesh`` None (one device) pads zeros on both sides."""
    if halo <= 0:
        raise ValueError(f"halo must be positive, got {halo}")
    if x.shape[0] < halo:
        raise ValueError(f"shard has {x.shape[0]} rows < halo {halo}")
    if mesh is None or mesh.size(axis) == 1:
        return torch.cat([_pad(x, None, halo), x, _pad(x, None, halo)])
    return HaloExchange.apply(x, halo, mesh, axis)
