"""Autograd across the ``region`` axis: the dense node-row plan.

On a region mesh each rank holds its ``N / region`` node rows of every
node-indexed array (the JAX ``P(..., 'region', ...)`` specs). The JAX
package leaves the dense graph convs to GSPMD, which all-gathers the
signal's node axis for the contraction and reduce-scatters the input
cotangent on the way back; here both are written out, each one call of
:mod:`stmgcn_tpu_torch.utils.comm`:

- :class:`RegionDenseApply`: ``out[..., b, i, k, f] = sum_j A_k[i, j] x[...,
  b, j, f]`` for this rank's rows ``i`` of the supports (a ``(..., K,
  N_local, N)`` row strip). The forward all-gathers ``x``'s node rows over
  ``region`` (in ``x``'s dtype) and multiplies the strip into the whole
  signal (an einsum summed in float32, as the JAX einsum outside any
  Pallas kernel; one per branch, as the one-device conv,
  :func:`~stmgcn_tpu_torch.ops.layers.branchwise_einsum`); the backward multiplies the strip's transpose into the
  cotangent, giving this rank's share of the whole input cotangent, and
  sums the shares over ``region`` keeping this rank's rows (a float32
  :func:`~stmgcn_tpu_torch.utils.comm.reduce_scatter`: over NCCL a
  reduce-scatter, over gloo, which has none, an all-reduce and a cut).
- :class:`RegionSum`: a sum over ``region`` of each rank's partial (the
  gate's node pooling: float64 at float32 compute, float32 under bf16).
  Unlike the branch fusion its backward sums too: what consumes the pooled
  value runs on every rank, but each rank's
  loss reaches it through its own node rows only, so each rank holds a
  share of the cotangent.
"""

from __future__ import annotations

import torch

from stmgcn_tpu_torch.ops.layers import branchwise_einsum
from stmgcn_tpu_torch.utils import comm

__all__ = ["RegionDenseApply", "RegionSum", "node_offset", "region_dense_apply", "region_sum"]


def node_offset(mesh, n_local: int) -> int:
    """The global index of this rank's first node row."""
    return mesh.coords["region"] * n_local


class RegionDenseApply(torch.autograd.Function):
    """The dense region-sharded support product (module docstring);
    ``x``'s node axis is its second last."""

    @staticmethod
    def forward(ctx, strip: torch.Tensor, x: torch.Tensor, mesh, spec: str) -> torch.Tensor:
        ctx.save_for_backward(strip)
        ctx.mesh, ctx.spec, ctx.n_local, ctx.dtype = mesh, spec, x.shape[-2], x.dtype
        ctx.x_dim = x.dim()
        whole = comm.all_gather(x, "region", mesh, dim=x.dim() - 2, what="node-rows")
        return branchwise_einsum(spec, strip, whole)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        (strip,) = ctx.saved_tensors
        lhs, out = ctx.spec.split("->")
        a, x = lhs.split(",")
        # the strip's transpose into the cotangent: this rank's share of the
        # whole input cotangent
        share = branchwise_einsum(f"{a},{out}->{x}", strip, grad)
        if share.dim() > ctx.x_dim:  # a signal shared by every branch
            share = share.sum(dim=0)
        mine = comm.reduce_scatter(share, "region", ctx.mesh, dim=-2, what="node-rows-grad")
        return None, mine.to(ctx.dtype), None, None


def region_dense_apply(strip: torch.Tensor, x: torch.Tensor, mesh, spec: str) -> torch.Tensor:
    """:class:`RegionDenseApply` of ``strip`` into ``x`` by the one-branch
    einsum ``spec`` (its second operand's node axis the second last; a
    leading branch axis on either operand as
    :func:`~stmgcn_tpu_torch.ops.layers.branchwise_einsum`); float32."""
    return RegionDenseApply.apply(strip, x, mesh, spec)


class RegionSum(torch.autograd.Function):
    """``sum over region`` of a float32 partial, forward and backward."""

    @staticmethod
    def forward(ctx, partial: torch.Tensor, mesh) -> torch.Tensor:
        ctx.mesh = mesh
        return comm.all_reduce(partial, "region", mesh, what="node-pool")

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return comm.all_reduce(grad.contiguous(), "region", ctx.mesh,
                               what="node-pool-grad"), None


def region_sum(partial: torch.Tensor, mesh) -> torch.Tensor:
    """:class:`RegionSum` of ``partial`` (float32, or float64 for a sum that
    does not depend on its order) over ``mesh``'s region axis."""
    if partial.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the node pooling sums in float32 or float64, got {partial.dtype}")
    return RegionSum.apply(partial, mesh)
