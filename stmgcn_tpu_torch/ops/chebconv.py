"""K-support graph convolution over dense, block-sparse or tiled supports.

Counterpart of ``stmgcn_tpu/ops/chebconv.py``. All three convolutions hold
the same parameters — one k-major ``(K*F_in, F_out)`` weight (matching
``torch.cat(support_list, dim=-1)``) and a bias, Xavier-normal and zero —
so trained weights move between them unchanged, and share the projection
tail ``act(stacked @ W + b)``. They differ in how the K propagations run:

- :class:`ChebGraphConv`: ``einsum('kij,bjf->bikf')`` over a dense
  ``([M,] K, N, N)`` stack, or ``einsum('bkij,bjf->bikf')`` over one
  stack per batch row ``([M,] B, K, N, N)`` (fleet serving, whose rows
  belong to different cities; the JAX package computes it outside Pallas
  too), one product per branch
  (:func:`~stmgcn_tpu_torch.ops.layers.branchwise_einsum`);
- :class:`SparseChebGraphConv`: block-CSR supports through the kernels of
  :mod:`~stmgcn_tpu_torch.ops.spmm` (B3/B4 for a
  :class:`~stmgcn_tpu_torch.ops.spmm.BlockSparseStack`, B5 per support
  for a K-tuple of :class:`~stmgcn_tpu_torch.ops.spmm.BlockSparse`), or
  on a region mesh a rank's row strip
  (:class:`~stmgcn_tpu_torch.parallel.sparse.ShardedBlockSparse`: the
  signal's node rows all-gathered, then B3 over the strip for every
  branch at once, B4 for the gradient,
  :func:`~stmgcn_tpu_torch.parallel.sparse.sharded_spmm_apply`);
- :class:`TiledChebGraphConv`: a reordered and condensed plan
  (:mod:`~stmgcn_tpu_torch.ops.tiling`), all branches in one B3 launch;
- :class:`BandedChebGraphConv`: one rank's strip of region-sharded banded
  supports (:class:`~stmgcn_tpu_torch.parallel.banded.BandedSupports`),
  through the ring halo exchange
  (:func:`~stmgcn_tpu_torch.parallel.banded.sharded_banded_apply`);
- :class:`MixedChebGraphConv`: M branches each in its own mode
  (``"banded"`` or ``"dense"``, the JAX loop layout's per-branch convs),
  the K propagations branch by branch and one projection for all M.

Neither block conv has a backend switch: CUDA tensors take the kernels,
CPU tensors their plain versions.

**On a region mesh** (``region_mesh``, set by the model: node rows split
over ``region``) a dense conv holds its rows' strip of the supports, ``(...,
K, N_local, N)``, and its node rows of the signal; the product goes through
:func:`~stmgcn_tpu_torch.parallel.region.region_dense_apply` (the signal's
node rows all-gathered forward, the input cotangent summed over ``region``
backward), the GSPMD plan of the JAX package written out. The projection
is node-wise and runs on the rank's rows alone.

Under a bf16 compute dtype (``compute_dtype``, ``ops/layers.py``) each
conv follows the JAX conv at ``dtype=bfloat16``
(``stmgcn_tpu/ops/chebconv.py``): the signal, weight and bias (and dense
supports) rounded to bf16; the K propagations summed in float32 and
rounded to bf16 (dense: an fp32 einsum of the bf16 values; block-CSR: the
kernels' bf16 forms over the blocks cast to bf16, float32 out); the
projection in float32 with the bias added on the float32 side, then the
activation, then one rounding to bf16 (``_project``).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
from torch import nn

from stmgcn_tpu_torch.ops.layers import (
    accum_matmul,
    branch_view,
    branchwise_einsum,
    promote_dtype,
    new_param,
    xavier_normal,
)
from stmgcn_tpu_torch.ops.spmm import BlockSparseStack, spmm, spmm_stack
from stmgcn_tpu_torch.ops.tiling import TiledBranchSupports, TiledSupports
from stmgcn_tpu_torch.parallel.banded import BandedSupports, sharded_banded_apply
from stmgcn_tpu_torch.parallel.region import region_dense_apply
# the module, not its names: parallel.sparse imports ops.spmm, which loads this package
from stmgcn_tpu_torch.parallel import sparse as sharded_sparse

__all__ = [
    "BandedChebGraphConv",
    "ChebGraphConv",
    "LOOP_MODES",
    "MixedChebGraphConv",
    "SparseChebGraphConv",
    "TiledChebGraphConv",
    "conv_cls",
    "make_conv",
]


def _project(stacked, w, b, activation, dtype=None):
    """Projection / bias / activation tail: ``act(stacked @ w + b)``; under
    a bf16 compute ``dtype``, the product and bias add in float32 and one
    rounding to bf16 at the end."""
    stacked, w, b = promote_dtype(dtype, stacked, w, b)
    out = accum_matmul(stacked, w)
    if b is not None:
        out = out + b.float()
    if activation is not None:
        out = activation(out)
    return out.to(dtype or torch.float32)


def _signal_matrix(x):
    """``([M,] B, N, F)`` -> ``([M,] N, B*F)``: every batch row and
    feature of a node side by side, one product per support."""
    *lead, batch, n_nodes, f_in = x.shape
    return x.transpose(-3, -2).reshape(*lead, n_nodes, batch * f_in)


def _k_major(propagated, batch, f_in):
    """``([M,] K, N, B*F)`` -> ``([M,] B, N, K*F)``, k-major as the dense
    layout."""
    *lead, k, n_nodes, _ = propagated.shape
    return (propagated.reshape(*lead, k, n_nodes, batch, f_in)
            .transpose(-4, -2).flatten(-2))


class ChebGraphConv(nn.Module):
    """Graph convolution over a stack of K dense support matrices.

    Call with ``supports`` ``([M,] K, N, N)``, or ``([M,] B, K, N, N)``
    with one stack per batch row, and a signal ``x`` ``([M,] B, N,
    F_in)``; returns ``([M,] B, N, features)``. With
    ``branches=M`` the parameters carry a leading ``M`` axis and an ``x``
    without one is shared by every branch.
    """

    def __init__(self, n_supports: int, in_features: int, features: int, *,
                 use_bias: bool = True,
                 activation: Optional[Callable] = torch.relu,
                 branches: Optional[int] = None, device=None, generator=None):
        super().__init__()
        self.n_supports = n_supports
        self.features = features
        self.activation = activation
        self.branches = branches
        self.compute_dtype: Optional[torch.dtype] = None
        #: the region mesh this conv's node rows are sharded over (None: the
        #: whole node axis on this rank)
        self.region_mesh = None
        lead = () if branches is None else (branches,)
        fan_in = n_supports * in_features
        self.W = new_param(
            xavier_normal(lead + (fan_in, features), fan_in, features, generator),
            device,
        )
        self.b = new_param(torch.zeros(lead + (features,)), device) if use_bias else None

    def _check_count(self, k: int) -> None:
        if k != self.n_supports:
            raise ValueError(f"expected {self.n_supports} supports, got {k}")

    def project(self, stacked: torch.Tensor) -> torch.Tensor:
        """The shared tail on the k-major ``([M,] B, N, K*F_in)`` stack."""
        w = branch_view(self.W, self.branches, 1)
        b = None if self.b is None else branch_view(self.b, self.branches, 2)
        return _project(stacked, w, b, self.activation, self.compute_dtype)

    def _propagated(self, propagated: torch.Tensor) -> torch.Tensor:
        """A product's float32 result in the compute dtype."""
        return propagated.to(self.compute_dtype or torch.float32)

    def _dense(self, supports: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """The K propagations over dense supports, ``([M,] B, N, K, F)`` in
        the compute dtype; on a region mesh over the rank's row strip."""
        self._check_count(supports.shape[-3])
        supports, x = promote_dtype(self.compute_dtype, supports, x)
        per_row = supports.dim() == 4 + (self.branches is not None)
        spec = "bkij,bjf->bikf" if per_row else "kij,bjf->bikf"
        mesh = self.region_mesh
        if mesh is None:
            return self._propagated(branchwise_einsum(spec, supports, x))
        if per_row:
            raise ValueError("per-row support stacks (fleet serving) do not shard "
                             "over a region mesh")
        return self._propagated(region_dense_apply(supports, x, mesh, spec))

    def forward(self, supports: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        # k-major (B, N, K*F_in)
        return self.project(self._dense(supports, x).flatten(-2))


class SparseChebGraphConv(ChebGraphConv):
    """Graph convolution over K block-sparse supports.

    Same parameters and math as :class:`ChebGraphConv`. Accepted support
    forms, for one branch (``branches=None``):

    - a :class:`~stmgcn_tpu_torch.ops.spmm.BlockSparseStack` — all K
      propagations in one launch of B3;
    - a K-sequence of :class:`~stmgcn_tpu_torch.ops.spmm.BlockSparse` —
      one launch of B5 per support.

    With ``branches=M``: a branch-stacked ``BlockSparseStack`` (one launch
    for every branch), or an M-sequence of the one-branch forms (one launch
    group per branch: each branch's stack has its own block-column count).

    On a region mesh (``region_mesh``): a rank's one-shard
    :class:`~stmgcn_tpu_torch.parallel.sparse.ShardedBlockSparse` strip
    (branch-stacked with ``branches=M``) and the rank's node rows of the
    signal; the propagations are one B3 launch over the strip against the
    all-gathered signal (:func:`~stmgcn_tpu_torch.parallel.sparse.sharded_spmm_apply`).
    """

    def _one_branch(self, supports, x_mat):
        if isinstance(supports, BlockSparseStack):
            self._check_count(supports.n_supports)
            return self._propagated(spmm_stack(supports.astype(x_mat.dtype), x_mat))
        self._check_count(len(supports))
        return torch.stack([self._propagated(spmm(bs.astype(x_mat.dtype), x_mat))
                            for bs in supports])

    def forward(self, supports, x: torch.Tensor) -> torch.Tensor:
        batch, f_in = x.shape[-3], x.shape[-1]
        (x,) = promote_dtype(self.compute_dtype, x)
        x_mat = _signal_matrix(x)
        if isinstance(supports, sharded_sparse.ShardedBlockSparse):
            if supports.branches != self.branches:
                raise ValueError(f"a ShardedBlockSparse strip with branch axis "
                                 f"{supports.branches} for a conv with branches={self.branches}")
            self._check_count(supports.n_supports)
            propagated = self._propagated(
                sharded_sparse.sharded_spmm_apply(supports, x_mat, self.region_mesh))
        elif self.branches is None or isinstance(supports, BlockSparseStack):
            if isinstance(supports, BlockSparseStack) and supports.branches != self.branches:
                raise ValueError(
                    f"a BlockSparseStack with branch axis {supports.branches} for a conv "
                    f"with branches={self.branches}"
                )
            propagated = self._one_branch(supports, x_mat)
        else:
            if not isinstance(supports, Sequence) or len(supports) != self.branches:
                raise ValueError(
                    f"need {self.branches} per-branch support groups, got "
                    f"{len(supports) if isinstance(supports, Sequence) else type(supports)}"
                )
            propagated = torch.stack([
                self._one_branch(s, x_mat if x_mat.dim() == 2 else x_mat[m])
                for m, s in enumerate(supports)
            ])
        return self.project(_k_major(propagated, batch, f_in))


class TiledChebGraphConv(ChebGraphConv):
    """Graph convolution over a reordered and condensed tiled plan.

    Same parameters and math as :class:`ChebGraphConv`. With
    ``branches=M`` it takes the whole
    :class:`~stmgcn_tpu_torch.ops.tiling.TiledSupports` plan (M branches);
    without, one :class:`~stmgcn_tpu_torch.ops.tiling.TiledBranchSupports`.
    The signal permutes into the plan's node order once (one
    ``index_select``), every branch's K propagations run over the stored
    blocks only in one launch of B3 (B4 for the gradient), and the
    projected output permutes back out (one ``index_select``): the
    permutation never touches the contraction.
    """

    def forward(self, supports, x: torch.Tensor) -> torch.Tensor:
        want = TiledBranchSupports if self.branches is None else TiledSupports
        if not isinstance(supports, want):
            raise TypeError(
                f"tiled mode consumes a {want.__name__} (a plan_tiling artifact"
                f"{'' if self.branches is None else ' with every branch'}), "
                f"got {type(supports).__name__}"
            )
        if self.branches is not None and supports.m_graphs != self.branches:
            raise ValueError(f"plan has {supports.m_graphs} branches, conv {self.branches}")
        self._check_count(supports.n_supports)
        batch, n_nodes, f_in = x.shape[-3:]
        if n_nodes != supports.n:
            raise ValueError(f"x has {n_nodes} nodes, plan expects {supports.n}")
        (x,) = promote_dtype(self.compute_dtype, x)
        x_mat = _signal_matrix(x).index_select(-2, supports.perm)
        propagated = self._propagated(spmm_stack(supports.as_stack().astype(x.dtype), x_mat))
        out = self.project(_k_major(propagated, batch, f_in))
        # the node axis back out AFTER the (node-wise) projection
        return out.index_select(-2, supports.inv)


def _banded(conv: ChebGraphConv, supports, x: torch.Tensor) -> torch.Tensor:
    """One branch's K propagations over a rank's banded strip, ``(B,
    N_local, K, F)`` in the compute dtype."""
    if not isinstance(supports, BandedSupports):
        raise TypeError(f"banded mode consumes BandedSupports strips, got "
                        f"{type(supports).__name__}")
    conv._check_count(supports.n_supports)
    if supports.n_shards != 1:
        raise ValueError(f"BandedSupports of {supports.n_shards} shards: a rank applies its own "
                         "strip (MeshPlacement.put(..., 'supports') or .shard(i))")
    if x.shape[-2] != supports.n_local:
        raise ValueError(f"x has {x.shape[-2]} nodes, strips expect {supports.n_local}")
    (x,) = promote_dtype(conv.compute_dtype, x)
    propagated = sharded_banded_apply(supports.strips[0], x, supports.halo, conv.region_mesh)
    return conv._propagated(propagated.permute(1, 2, 0, 3))  # (K, B, N, F) -> (B, N, K, F)


class BandedChebGraphConv(ChebGraphConv):
    """Graph convolution over one rank's strip of region-sharded banded
    supports (``stmgcn_tpu/ops/chebconv.py`` ``BandedChebGraphConv``).

    Same parameters and math as :class:`ChebGraphConv` (trained weights are
    interchangeable); the K propagations run through the halo plan: the
    rank contracts its strip against its node rows and ``halo`` boundary
    rows from each ring neighbour. Call with a one-shard
    :class:`~stmgcn_tpu_torch.parallel.banded.BandedSupports` and the
    rank's ``(B, N_local, F_in)`` signal; one branch (``branches=None``).
    On one device (``region_mesh`` None) a one-shard strip is the whole
    support, its halos zero.
    """

    def forward(self, supports, x: torch.Tensor) -> torch.Tensor:
        if self.branches is not None:
            raise ValueError("BandedChebGraphConv is one branch's conv; M branches take "
                             "MixedChebGraphConv")
        return self.project(_banded(self, supports, x).flatten(-2))


#: the support modes a per-branch (loop layout) model mixes
LOOP_MODES = ("dense", "banded")


class MixedChebGraphConv(ChebGraphConv):
    """M branches, each with its own support mode (``modes``: ``"banded"``
    or ``"dense"`` per branch), the JAX model's loop layout
    (``stmgcn_tpu/models/st_mgcn.py``, ``support_modes``). Same stacked
    parameters as :class:`ChebGraphConv` with ``branches=M``. Call with an
    M-sequence of per-branch supports (a one-shard ``BandedSupports`` or a
    dense ``(K, N, N)`` stack, its row strip ``(K, N_local, N)`` on a region
    mesh) and a signal ``(B, N, F)`` shared by every branch or ``(M, B, N,
    F)``: the propagations run branch by branch, the projection once."""

    def __init__(self, *args, modes=(), **kwargs):
        super().__init__(*args, **kwargs)
        self.modes = tuple(modes)
        bad = sorted(set(self.modes) - set(LOOP_MODES))
        if bad or len(self.modes) != self.branches:
            raise ValueError(f"per-branch modes must be {self.branches} of {LOOP_MODES}, "
                             f"got {self.modes}")

    def forward(self, supports, x: torch.Tensor) -> torch.Tensor:
        if not isinstance(supports, Sequence) or len(supports) != len(self.modes):
            got = len(supports) if isinstance(supports, Sequence) else type(supports).__name__
            raise ValueError(f"need {len(self.modes)} per-branch support groups, got {got}")
        parts = []
        for m, (mode, sup) in enumerate(zip(self.modes, supports)):
            xm = x[m] if x.dim() == 4 else x
            parts.append(_banded(self, sup, xm) if mode == "banded" else self._dense(sup, xm))
        return self.project(torch.stack(parts).flatten(-2))


def conv_cls(mode):
    """The graph-conv class for a support representation: ``"dense" |
    "sparse" | "tiled" | "banded"`` (bools accepted: ``True`` = sparse,
    ``False`` = dense), or a per-branch tuple of :data:`LOOP_MODES`
    (:class:`MixedChebGraphConv`)."""
    if isinstance(mode, bool):
        mode = "sparse" if mode else "dense"
    if isinstance(mode, tuple):
        return MixedChebGraphConv
    classes = {"dense": ChebGraphConv, "sparse": SparseChebGraphConv,
               "tiled": TiledChebGraphConv, "banded": BandedChebGraphConv}
    if mode not in classes:
        raise ValueError(f"support mode must be one of {sorted(classes)}, got {mode!r}")
    return classes[mode]


def make_conv(mode, *args, **kwargs) -> ChebGraphConv:
    """Construct the graph conv for ``mode`` (arguments as
    :class:`ChebGraphConv`'s; a per-branch tuple builds a
    :class:`MixedChebGraphConv` of those modes)."""
    if isinstance(mode, tuple):
        return MixedChebGraphConv(*args, modes=mode, **kwargs)
    return conv_cls(mode)(*args, **kwargs)
