"""Autograd across ranks: the branch fusion and the gradient sync of a
mesh training step.

The JAX package gets both from GSPMD: the fusion sum over a
branch-sharded axis lowers to a ``psum`` whose transpose XLA derives, and
the gradients of replicated parameters are summed over ``dp`` (and
``region``). Here they are written out, each one call of
:mod:`stmgcn_tpu_torch.utils.comm` per axis:

- :class:`BranchFusion`: the forward all-reduces (float32) each rank's
  partial branch sum over ``branch``; **the backward is the identity**.
  The head and the loss run redundantly on every branch rank, so each
  already holds the whole cotangent of the fused features. A summing
  backward (``torch.distributed.nn.functional.all_reduce``'s) would add
  ``branch`` equal copies of it and scale every branch gradient by
  ``branch``.
- :class:`GradSync`: once a step, one flat bucket of every gradient, in
  the parameters' fixed order, summed over the replicas: the ranks that
  hold the same parameters, the ``dp x region`` group (one all-reduce over
  ``dp``, one over ``region`` first on a region mesh). Each rank's loss is
  its rows' share of the *global* mean (its error sum over the global
  count of real elements, ``train/step.py`` ``masked_loss``), so the
  summed gradients are the single-device ones; nothing is divided by the
  group's size. :meth:`GradSync.norm_sq` is the clip's global squared
  norm: the branch-sliced gradients' squares summed over ``branch`` (a
  4-byte all-reduce), the replicated head's counted once, and
:meth:`GradSync.branch_sum` sums the health stats' partials so.
- :func:`world_any` and :func:`world_or`: a flag, or a word of flag bits,
  agreed over every rank, so that every rank takes one decision (the
  divergence guard's, the sanitizers', ``debug_nans``'). The collective
  layer only sums (NCCL has no bitwise or), so a word is unpacked to its
  bits, the bits summed over ``world`` and compared with 0.

**The sum does not depend on its order.** Each rank casts its float32
bucket to float64, the all-reduce sums float64, and the result is cast
back to float32. A float64 holds 53 bits: the sum of a handful of float32
addends (24 bits each) whose binary exponents lie within 29 of one another
is exact in float64, in any order, so the float32 after the cast is the
correctly rounded sum whatever order the transport adds in: NCCL's ring
or tree and gloo's give the same bits. (Addends further apart than that
round in float64, at 2^-53 of the sum, and the cast to float32 hides it
unless the sum sits on a float32 rounding tie.) The bucket's bytes
double; the branch fusion's sum stays float32, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from stmgcn_tpu_torch.utils import comm

__all__ = ["BranchFusion", "GradSync", "REPLICA_AXES", "branch_fusion", "replica_sum",
           "world_any", "world_or"]

#: the axes over which ranks hold the same (unsliced) parameters, in the
#: order their sums run
REPLICA_AXES = ("region", "dp")


def replica_sum(tensor: torch.Tensor, mesh, *, what: str = "") -> torch.Tensor:
    """``tensor`` summed over the ``dp x region`` group: one all-reduce
    over each axis of extent above 1, ``region`` first."""
    for axis in REPLICA_AXES:
        tensor = comm.all_reduce(tensor, axis, mesh, what=what)
    return tensor


def world_any(flag: bool, mesh, *, what: str) -> bool:
    """Whether ``flag`` holds on any rank of the job: a 4-byte all-reduce
    over ``world``, the same answer on every rank."""
    summed = comm.all_reduce(torch.tensor([float(flag)]), "world", mesh, what=what)
    return bool(summed.item() > 0)


def world_or(words: torch.Tensor, bits: int, mesh, *, what: str) -> torch.Tensor:
    """The bitwise or over every rank of ``words`` (integer-valued, each
    below ``2 ** bits``; any float or int dtype): each word's bits summed
    over ``world`` in one all-reduce, then repacked, in ``words``' dtype
    and device."""
    shifts = torch.arange(bits, device=words.device)
    unpacked = (words.to(torch.int64)[..., None] >> shifts) & 1
    summed = comm.all_reduce(unpacked.to(torch.float32), "world", mesh, what=what)
    return ((summed > 0).to(torch.int64) << shifts).sum(-1).to(words.dtype)


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
    i is a branch slice; ``branches`` is the rank's slice of the stacked
    branches (None: it holds them all)."""

    def __init__(self, mesh, params: Sequence[torch.Tensor], sharded: Sequence[bool],
                 branches: Optional[slice] = None):
        self.mesh = mesh
        self.sharded = list(sharded)
        self.branches = branches
        if len(self.sharded) != len(params):
            raise ValueError(f"{len(params)} parameters but {len(self.sharded)} sharded flags")
        self.numel = sum(p.numel() for p in params)
        self._bucket = None

    @torch.no_grad()
    def reduce(self, grads: Sequence[torch.Tensor]) -> None:
        """Sum ``grads`` over the ``dp x region`` group in place: the
        float32 gradients in one float64 bucket, all-reduced, cast back
        (module docstring: the result does not depend on the order)."""
        if self.mesh.dp == 1 and self.mesh.region == 1:
            return
        if self._bucket is None:
            self._bucket = torch.empty(self.numel, dtype=torch.float64, device=grads[0].device)
        torch.cat([g.reshape(-1).to(torch.float64) for g in grads], out=self._bucket)
        summed = replica_sum(self._bucket, self.mesh, what="grads")
        start = 0
        for g in grads:
            n = g.numel()
            g.copy_(summed[start:start + n].view_as(g))  # one rounding to float32
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

    @torch.no_grad()
    def branch_sum(self, values: torch.Tensor, sharded: torch.Tensor) -> torch.Tensor:
        """``values`` (a float32 vector of this rank's partials) with the
        entries where ``sharded`` holds summed over ``branch`` (the branch
        slices' parts, one all-reduce) and the rest kept (the replicated
        parameters', counted once)."""
        part = torch.where(sharded, values, torch.zeros_like(values))
        summed = comm.all_reduce(part, "branch", self.mesh, what="health")
        return summed + torch.where(sharded, torch.zeros_like(values), values)
