"""Region-sharded block-CSR supports and their product.

Counterpart of ``stmgcn_tpu/parallel/sparse.py``. Each region rank stores
only its **row strip** of every support in uniform block-CSR (``O(nnz /
region)`` memory: the point of sparsity at N = 2,500, where a dense ``(M,
K, N, N)`` stack is the quadratic cost), all-gathers the signal's node
rows over ``region``, and runs ONE launch of kernel B3 over its strip for
every support (and every branch it holds). The batch stays split over
``dp`` throughout.

- :func:`sharded_from_dense` (host numpy, :func:`_sharded_np`): a ``(K, N,
  N)`` stack cut into ``S`` row strips ``(n_local, N)``, each in uniform
  block-CSR with its transpose ``(N, n_local)``, at one ``c_max`` /
  ``c_max_t`` shared by every shard and support, so the stacked arrays are
  uniform (padding slots keep index 0 with zero blocks). The arrays equal
  the JAX package's; the port adds the counts ``nblk`` / ``nblk_t`` of each
  row's real slots, which the kernels use to skip the padding.
- :func:`branch_stack_sparse`: M branches' strips stacked on a leading
  graph axis at the largest block-column width over the branches (the
  form a ``branch`` mesh axis cuts).
- :func:`sharded_spmm_apply` (:class:`ShardedSpmmApply`): forward, the
  node-row all-gather, then B3 on the rank's strip (a ``BlockSparseStack``
  of ``n_local`` rows and ``N`` columns); backward, B4 over the strip's
  transpose gives the strip's column contribution ``A_s^T g_s`` over all
  N (summed over the supports, and over the branches for a shared
  signal), and the partials are summed over ``region``, the rank keeping
  its own rows (a float32 :func:`~stmgcn_tpu_torch.utils.comm.reduce_scatter`:
  the reduce-scatter ``shard_map`` derives from the all-gather in the JAX
  package, written out; over gloo an all-reduce and a cut).

A rank holds its one shard (:meth:`ShardedBlockSparse.shard`); several
one-branch strips of a rank merge into one branch-stacked strip
(:func:`merge_branches`), so all branches take one launch.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from stmgcn_tpu_torch.ops.spmm import (
    TILE,
    BlockSparseStack,
    _assemble_blocks,
    _nbytes,
    _scan_blocks,
    spmm_stack_bwd,
    stack_forward,
)
from stmgcn_tpu_torch.utils import comm

__all__ = ["ShardedBlockSparse", "ShardedSpmmApply", "branch_stack_sparse", "merge_branches",
           "sharded_from_dense", "sharded_spmm_apply"]

#: the array fields of a :class:`ShardedBlockSparse`, forward then transpose
_FIELDS = ("data", "idx", "nblk", "data_t", "idx_t", "nblk_t")


@dataclasses.dataclass
class ShardedBlockSparse:
    """Per-shard row strips of K supports in uniform block-CSR, stacked on a
    leading shard axis: ``data`` ``(S, K, R_loc, C, tile, tile)``, ``idx``
    ``(S, K, R_loc, C)``, ``nblk`` ``(S, K, R_loc)``; the transpose
    structure likewise (each strip's ``(N, n_local)`` transpose, ``R_t =
    ceil(N / tile)`` block rows). The branch-stacked form
    (:func:`branch_stack_sparse`) carries a leading graph axis ``(M, S,
    ...)``; shape properties index from the end so both forms answer.
    Fields are numpy arrays on the host, tensors after :meth:`to`."""

    data: object
    idx: object
    nblk: object
    data_t: object
    idx_t: object
    nblk_t: object
    n: int  # global node count
    tile: int
    #: the shard count of the strips this one was cut from (None: this
    #: form's own ``n_shards``); a rank's one shard keeps it, so its
    #: ``n_local`` stays ``n / region``
    cut_from: int | None = None

    @property
    def n_shards(self) -> int:
        return self.data.shape[-6]

    @property
    def n_supports(self) -> int:
        return self.data.shape[-5]

    @property
    def branch_stacked(self) -> bool:
        return self.data.ndim == 7

    @property
    def branches(self):
        """The leading branch count, or None without that axis."""
        return self.data.shape[0] if self.branch_stacked else None

    @property
    def n_local(self) -> int:
        return self.n // (self.cut_from or self.n_shards)

    @property
    def nbytes(self) -> int:
        """Bytes of the blocks and indices (as the JAX package counts them)."""
        return sum(int(a.nbytes) if isinstance(a, np.ndarray) else _nbytes(a)
                   for a in (self.data, self.idx, self.data_t, self.idx_t))

    def _map(self, fn) -> "ShardedBlockSparse":
        return dataclasses.replace(self, **{f: fn(getattr(self, f)) for f in _FIELDS})

    def shard(self, index: int) -> "ShardedBlockSparse":
        """Shard ``index``'s strip alone (what region rank ``index`` holds),
        its shard axis kept at extent 1; ``n`` stays the global count."""
        if not 0 <= index < self.n_shards:
            raise ValueError(f"shard {index} of {self.n_shards}")
        lead = 1 if self.branch_stacked else 0
        cut = (slice(None),) * lead + (slice(index, index + 1),)
        return dataclasses.replace(self._map(lambda a: a[cut]),
                                   cut_from=self.cut_from or self.n_shards)

    def branch(self, m) -> "ShardedBlockSparse":
        """Branch ``m`` of a branch-stacked form (an int: its one-branch
        strips; a slice: those branches, still stacked: a branch mesh
        rank's)."""
        if not self.branch_stacked:
            raise ValueError("a one-branch ShardedBlockSparse has no branch axis")
        return self._map(lambda a: a[m])

    def to(self, device) -> "ShardedBlockSparse":
        def move(a):
            t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
            return t.to(device).contiguous()

        return self._map(move)

    def stack(self) -> BlockSparseStack:
        """A one-shard strip as the kernels' operand: a ``BlockSparseStack``
        of ``n_local`` rows and ``N`` columns (``(M, K, ...)`` when
        branch-stacked), made once, so its row orders are derived once."""
        return self._stack

    @functools.cached_property
    def _stack(self) -> BlockSparseStack:
        if self.n_shards != 1:
            raise ValueError(f"ShardedBlockSparse of {self.n_shards} shards: a rank applies its "
                             "own strip (MeshPlacement.put(..., 'supports') or .shard(i))")
        axis = 1 if self.branch_stacked else 0
        f = {name: torch.as_tensor(getattr(self, name)).squeeze(axis) for name in _FIELDS}
        return BlockSparseStack(**f, n_rows=self.n_local, n_cols=self.n, tile=self.tile)


def _sharded_np(mats, n_shards: int, tile: int):
    """Host assembly of :func:`sharded_from_dense`'s arrays (numpy), as the
    JAX ``_sharded_np`` (with the counts beside them): one scan per (shard,
    support, direction), one ``c_max`` / ``c_max_t`` over all shards and
    supports, then one assembly pass."""
    mats = np.asarray(mats, dtype=np.float32)
    k, n, n2 = mats.shape
    if n != n2:
        raise ValueError(f"supports must be (K, N, N), got {mats.shape}")
    if n % n_shards:
        raise ValueError(f"N={n} not divisible by {n_shards} shards")
    n_local = n // n_shards
    fwd_scan, bwd_scan = [], []
    for s in range(n_shards):
        rows = slice(s * n_local, (s + 1) * n_local)
        fwd_scan.append([_scan_blocks(mats[ki, rows, :], tile) for ki in range(k)])
        bwd_scan.append([_scan_blocks(np.ascontiguousarray(mats[ki, rows, :].T), tile)
                         for ki in range(k)])

    def occupancy(scans):
        return max(max(int(nz.sum(axis=1).max()), 1) for per in scans for _, nz in per)

    def assemble(scans, width):
        parts = [[_assemble_blocks(b, nz, width, tile) for b, nz in per] for per in scans]
        return tuple(np.stack([np.stack([p[i] for p in per]) for per in parts])
                     for i in range(3))

    data, idx, nblk = assemble(fwd_scan, occupancy(fwd_scan))
    data_t, idx_t, nblk_t = assemble(bwd_scan, occupancy(bwd_scan))
    return data, idx, nblk, data_t, idx_t, nblk_t, n


def sharded_from_dense(mats, n_shards: int, tile: int = TILE) -> ShardedBlockSparse:
    """Split dense ``(K, N, N)`` supports into per-shard block-CSR strips
    (host numpy; every shard and support at one block-column width)."""
    *arrays, n = _sharded_np(mats, n_shards, tile)
    return ShardedBlockSparse(*arrays, n=n, tile=tile)


def _stack_branches(per) -> dict:
    """One-branch strips' fields (host arrays) stacked on a new leading
    axis, each block-column axis (axis 3 of the one-branch form) padded to
    the widest branch's: zero blocks at index 0, padding slots past every
    row's count."""
    out = {}
    for name in _FIELDS:
        arrays = [np.asarray(getattr(p, name)) for p in per]
        if not name.startswith("nblk"):
            width = max(a.shape[3] for a in arrays)
            arrays = [np.pad(a, [(0, 0)] * 3 + [(0, width - a.shape[3])]
                             + [(0, 0)] * (a.ndim - 4)) for a in arrays]
        out[name] = np.stack(arrays)
    return out


def branch_stack_sparse(dense_stack, n_shards: int, tile: int = TILE) -> ShardedBlockSparse:
    """M branches' dense ``(K, N, N)`` supports (a ``(M, K, N, N)`` stack)
    as ONE branch-stacked :class:`ShardedBlockSparse`: each branch keeps its
    own block-CSR content, the block-column axes padded to the largest
    occupancy over the branches so the stacked arrays are uniform (the
    sparse counterpart of :func:`~stmgcn_tpu_torch.parallel.banded.branch_stack`'s
    common halo)."""
    dense_stack = np.asarray(dense_stack, dtype=np.float32)
    per = [sharded_from_dense(dense_stack[m], n_shards, tile)
           for m in range(dense_stack.shape[0])]
    return ShardedBlockSparse(**_stack_branches(per), n=per[0].n, tile=tile)


def merge_branches(strips) -> ShardedBlockSparse:
    """One rank's one-branch strips (host arrays, each one shard, from the
    per-branch routing at ``branch == 1``) merged into one branch-stacked
    strip at their widest block-column counts, so every branch's product
    is one launch; the padding slots lie past each row's count."""
    strips = tuple(strips)
    if any(s.branch_stacked or s.n_shards != 1 for s in strips):
        raise ValueError("merge_branches takes one-shard, one-branch strips")
    first = strips[0]
    if any((s.n, s.tile, s.n_supports) != (first.n, first.tile, first.n_supports)
           for s in strips):
        raise ValueError("strips of differing node counts, tiles or support counts")
    return ShardedBlockSparse(**_stack_branches(strips), n=first.n, tile=first.tile,
                              cut_from=first.cut_from)


class ShardedSpmmApply(torch.autograd.Function):
    """The region-sharded block-CSR product (module docstring): ``x_mat``
    ``(n_local, F)`` shared by every support and branch, or ``(M, n_local,
    F)`` one per branch; returns ``([M,] K, n_local, F)`` float32."""

    @staticmethod
    def forward(ctx, x_mat: torch.Tensor, stack: BlockSparseStack, mesh) -> torch.Tensor:
        ctx.stack, ctx.mesh, ctx.dtype = stack, mesh, x_mat.dtype
        ctx.n_local, ctx.shared = x_mat.shape[-2], x_mat.dim() == 2
        whole = comm.all_gather(x_mat.contiguous(), "region", mesh, dim=x_mat.dim() - 2,
                                what="node-rows") if mesh is not None else x_mat
        return stack_forward(stack.astype(whole.dtype), whole.contiguous())

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        stack = ctx.stack.astype(ctx.dtype)
        # the strip's column contribution over all N (float32)
        share = spmm_stack_bwd(stack, grad.to(ctx.dtype).contiguous(), shared=ctx.shared)
        if ctx.mesh is None:
            return share.to(ctx.dtype), None, None
        mine = comm.reduce_scatter(share, "region", ctx.mesh, dim=-2, what="node-rows-grad")
        return mine.to(ctx.dtype), None, None


def sharded_spmm_apply(strip: ShardedBlockSparse, x_mat: torch.Tensor, mesh) -> torch.Tensor:
    """``out[k, i, f] = sum_j A_k[i, j] x[j, f]`` over this rank's strip
    rows ``i`` (module docstring): ``strip`` the rank's one shard, ``x_mat``
    its node rows of the signal (``(n_local, F)``, or ``(M, n_local, F)``
    for a branch-stacked strip), in float32 or bfloat16; ``mesh`` None is
    one device (a one-shard strip of the whole support). Every rank of the
    region line calls it together. CUDA tensors launch B3 (B4 for the
    gradient), CPU tensors take their plain versions."""
    stack = strip.stack()
    if x_mat.dim() == 3 and stack.branches != x_mat.shape[0]:
        raise ValueError(f"a signal of {x_mat.shape[0]} branches for a strip of "
                         f"{stack.branches}")
    if x_mat.shape[-2] != strip.n_local:
        raise ValueError(f"x has {x_mat.shape[-2]} node rows, the strip {strip.n_local}")
    return ShardedSpmmApply.apply(x_mat, stack, mesh)
