"""Autograd across ranks: the branch fusion and the gradient sync of a
mesh training step.

The JAX package gets both from GSPMD: the fusion sum over a
branch-sharded axis lowers to a ``psum`` whose transpose XLA derives, and
the gradients of replicated parameters are summed over ``dp``. Here they
are written out, each one call of :mod:`stmgcn_tpu_torch.utils.comm`:

- :class:`BranchFusion`: the forward all-reduces (float32) each rank's
  partial branch sum over ``branch``; **the backward is the identity**.
  The head and the loss run redundantly on every branch rank, so each
  already holds the whole cotangent of the fused features. A summing
  backward (``torch.distributed.nn.functional.all_reduce``'s) would add
  ``branch`` equal copies of it and scale every branch gradient by
  ``branch``.
- :class:`GradSync`: once a step, one flat float32 bucket of every
  gradient, in the parameters' fixed order, all-reduced over ``dp``. Each
  rank's loss is its rows' share of the *global* mean (its error sum over
  the global count of real elements, ``train/step.py`` ``masked_loss``),
  so the summed gradients are the single-device ones; nothing is divided
  by ``dp``. :meth:`GradSync.norm_sq` is the clip's global squared norm:
  the branch-sliced gradients' squares summed over ``branch`` (a 4-byte
  all-reduce), the replicated head's counted once.
"""

from __future__ import annotations

from typing import Sequence

import torch

from stmgcn_tpu_torch.utils import comm

__all__ = ["BranchFusion", "GradSync", "branch_fusion"]


class BranchFusion(torch.autograd.Function):
    """``sum over the branch axis`` of each rank's float32 partial sum,
    forward; the identity, backward (module docstring)."""

    @staticmethod
    def forward(ctx, partial: torch.Tensor, mesh) -> torch.Tensor:
        return comm.all_reduce(partial, "branch", mesh, what="fusion")

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad, None


def branch_fusion(partial: torch.Tensor, mesh) -> torch.Tensor:
    """:class:`BranchFusion` of ``partial`` (float32) over ``mesh``'s
    ``branch`` axis."""
    if partial.dtype != torch.float32:
        raise TypeError(f"the branch fusion sums in float32, got {partial.dtype}")
    return BranchFusion.apply(partial, mesh)


class GradSync:
    """The gradient sync and the global clip norm of one rank's
    parameters (module docstring). ``sharded[i]`` says whether parameter
    i is a branch slice."""

    def __init__(self, mesh, params: Sequence[torch.Tensor], sharded: Sequence[bool]):
        self.mesh = mesh
        self.sharded = list(sharded)
        if len(self.sharded) != len(params):
            raise ValueError(f"{len(params)} parameters but {len(self.sharded)} sharded flags")
        self.numel = sum(p.numel() for p in params)
        self._bucket = None

    @torch.no_grad()
    def reduce(self, grads: Sequence[torch.Tensor]) -> None:
        """Sum ``grads`` over ``dp`` in place: one float32 all-reduce."""
        if self.mesh.dp == 1:
            return
        if self._bucket is None:
            self._bucket = torch.empty(self.numel, dtype=torch.float32, device=grads[0].device)
        torch.cat([g.reshape(-1).float() for g in grads], out=self._bucket)
        summed = comm.all_reduce(self._bucket, "dp", self.mesh, what="grads")
        start = 0
        for g in grads:
            n = g.numel()
            g.copy_(summed[start:start + n].view_as(g))
            start += n

    @torch.no_grad()
    def norm_sq(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """The global squared norm of ``grads``: the branch slices'
        squares summed over ``branch``, the replicated ones' added once."""
        zero = torch.zeros((), dtype=torch.float32, device=grads[0].device)
        part = sum((torch.sum(g * g) for g, s in zip(grads, self.sharded) if s), zero)
        whole = sum((torch.sum(g * g) for g, s in zip(grads, self.sharded) if not s), zero)
        if any(self.sharded):
            part = comm.all_reduce(part.reshape(1), "branch", self.mesh,
                                   what="clip-norm").reshape(())
        return part + whole
