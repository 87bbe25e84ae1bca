"""Offline tiled-sparse support planning: reorder + condense.

Counterpart of ``stmgcn_tpu/ops/tiling.py``. A metro-scale city's
Chebyshev supports are overwhelmingly zero, but a dense ``(M, K, N, N)``
stack multiplies every entry. The plan fixes that offline, on the host, in
numpy, as the JAX package does (copied, not imported, so that a plan here
is array-equal to the JAX one):

1. **Reorder** — one reverse Cuthill-McKee-style BFS permutation over the
   symmetrized union pattern of all M x K supports clusters each row's
   neighbours into few ``(tile, tile)`` blocks;
2. **Condense** — each permuted support's nonzero blocks packed into
   uniform block-CSR (``ops/spmm.py``) at one common block-column count
   for the whole city, so every kernel operand has a static shape.

The :class:`TiledSupports` plan holds the permutation and its inverse and
the forward and pre-transposed block stacks of every branch, as tensors
(``.to(device)`` moves them). The online apply is
:class:`~stmgcn_tpu_torch.ops.chebconv.TiledChebGraphConv`: the signal
permutes in once, all branches' K propagations run as one launch of kernel
B3 over :meth:`TiledSupports.as_stack` (B4 for the gradient), and the
projected output permutes back out. :func:`gathered_tiles_apply` is the
plain version of that apply on one branch, with its prepared backward.

A fleet shape class grows each member's plan to the class rung
(:meth:`TiledSupports.pad_to`: isolated new nodes, all-zero block rows
with no real slots) and widens the block columns to the class's common
width (:meth:`TiledSupports.with_block_cols`: padding slots past every
row's count), so the kernels read only the real slots of a grown plan.

**Sharded plans.** The RCM order that makes blocks dense also makes them
banded, so one branch's plan splits along its block rows into contiguous
shards that need only a ``halo``-block boundary exchange each
(:func:`shard_tiled_plan`, :class:`ShardedTiledBranch`, the JAX
``tiling.py:467-676``); :func:`sharded_gathered_tiles_apply` runs a rank's
shard through kernels B3 and B4 over a halo-local
:class:`~stmgcn_tpu_torch.ops.spmm.BlockSparseStack`, the boundary blocks
riding :func:`~stmgcn_tpu_torch.parallel.halo.halo_exchange`.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from stmgcn_tpu_torch.ops.spmm import (
    TILE,
    BlockCSRApply,
    BlockSparseStack,
    _assemble_blocks,
    spmm_stack_bwd,
    stack_forward,
    _moved,
    _nbytes,
    _scan_blocks,
    spmm_stack_bwd_reference,
    spmm_stack_reference,
)

__all__ = [
    "ShardedTiledBranch",
    "StackedPlans",
    "TiledBranchSupports",
    "TiledSupports",
    "gathered_tiles_apply",
    "plan_tiling",
    "rcm_permutation",
    "shard_tiled_plan",
    "sharded_gathered_tiles_apply",
]


def rcm_permutation(pattern: np.ndarray) -> np.ndarray:
    """Reverse-Cuthill-McKee-style BFS ordering of a sparsity pattern.

    ``pattern`` is a boolean ``(N, N)`` adjacency (symmetrized inside —
    bandwidth is a property of the symmetric closure). Components are
    seeded from their minimum-degree node and BFS levels visit neighbors
    in ascending-degree order; the final order is reversed (the RCM
    refinement — same bandwidth, better profile). Pure numpy, no scipy.

    Returns ``perm`` (int32): new position ``p`` holds original node
    ``perm[p]``, i.e. ``A_reordered = A[perm][:, perm]``.
    """
    pattern = np.asarray(pattern)
    if pattern.ndim != 2 or pattern.shape[0] != pattern.shape[1]:
        raise ValueError(f"pattern must be square (N, N), got {pattern.shape}")
    sym = (pattern != 0) | (pattern.T != 0)
    np.fill_diagonal(sym, False)
    n = sym.shape[0]
    deg = sym.sum(axis=1)
    order = np.empty(n, dtype=np.int64)
    visited = np.zeros(n, dtype=bool)
    pos = 0
    for start in np.argsort(deg, kind="stable"):
        if visited[start]:
            continue
        visited[start] = True
        order[pos] = start
        head, pos = pos, pos + 1
        while head < pos:
            u = order[head]
            head += 1
            nbrs = np.flatnonzero(sym[u] & ~visited)
            if nbrs.size:
                nbrs = nbrs[np.argsort(deg[nbrs], kind="stable")]
                visited[nbrs] = True
                order[pos : pos + nbrs.size] = nbrs
                pos += nbrs.size
    return order[::-1].astype(np.int32)


@dataclasses.dataclass
class TiledBranchSupports:
    """One branch's slice of a :class:`TiledSupports` plan (K supports)."""

    perm: torch.Tensor  # (N,) int32 — x_reordered = x[perm]
    inv: torch.Tensor  # (N,) int32 — y = y_reordered[inv]
    data: torch.Tensor  # (K, R, C, tile, tile) f32
    idx: torch.Tensor  # (K, R, C) int32
    nblk: torch.Tensor  # (K, R) int32 — each row's leading nonzero slots
    data_t: torch.Tensor  # (K, R, C_t, tile, tile) f32
    idx_t: torch.Tensor  # (K, R, C_t) int32
    nblk_t: torch.Tensor  # (K, R) int32
    n: int
    tile: int

    @property
    def n_supports(self) -> int:
        return self.data.shape[0]

    def as_stack(self) -> BlockSparseStack:
        """This branch's blocks as the kernels' operand (square N x N in the
        *permuted* node order — callers permute the signal); made once, so
        its row order is derived once."""
        return self._stack

    @functools.cached_property
    def _stack(self) -> BlockSparseStack:
        return BlockSparseStack(
            data=self.data, idx=self.idx, nblk=self.nblk, data_t=self.data_t,
            idx_t=self.idx_t, nblk_t=self.nblk_t, n_rows=self.n, n_cols=self.n, tile=self.tile,
        )

    def to(self, device) -> "TiledBranchSupports":
        return _moved(self, device)


@dataclasses.dataclass
class TiledSupports:
    """One city's tiled-sparse support plan: all M graphs x K supports.

    ``data``/``idx`` carry a leading ``(M, K, ...)`` pair with ONE common
    block-column count across every support (and one for the transposes),
    so all branches run in one kernel launch (:meth:`as_stack`); ``nblk``
    (``nblk_t``) counts each block row's leading nonzero slots, the rest
    being padding that the kernels skip. Indexing
    (``plan[m]``) yields one branch's view. Occupancy accounting is derived
    on demand (:meth:`tile_stats`), never stored.
    """

    perm: torch.Tensor  # (N,) int32
    inv: torch.Tensor  # (N,) int32
    data: torch.Tensor  # (M, K, R, C, tile, tile) f32
    idx: torch.Tensor  # (M, K, R, C) int32
    nblk: torch.Tensor  # (M, K, R) int32
    data_t: torch.Tensor  # (M, K, R, C_t, tile, tile) f32
    idx_t: torch.Tensor  # (M, K, R, C_t) int32
    nblk_t: torch.Tensor  # (M, K, R) int32
    n: int
    tile: int

    @property
    def m_graphs(self) -> int:
        return self.data.shape[0]

    @property
    def n_supports(self) -> int:
        return self.data.shape[1]

    @property
    def block_rows(self) -> int:
        return self.data.shape[2]

    @property
    def block_cols(self) -> int:
        return self.data.shape[3]

    @property
    def nbytes(self) -> int:
        return _nbytes(self.data, self.idx, self.data_t, self.idx_t)

    def __len__(self) -> int:
        return self.m_graphs

    def __getitem__(self, m: int) -> TiledBranchSupports:
        if not isinstance(m, (int, np.integer)):
            raise TypeError(f"branch index must be an int, got {type(m)!r}")
        return TiledBranchSupports(
            perm=self.perm, inv=self.inv, data=self.data[m], idx=self.idx[m],
            nblk=self.nblk[m], data_t=self.data_t[m], idx_t=self.idx_t[m],
            nblk_t=self.nblk_t[m], n=self.n, tile=self.tile,
        )

    def as_stack(self) -> BlockSparseStack:
        """Every branch's blocks as one branch-stacked kernel operand; made
        once, so its row order is derived once."""
        return self._stack

    @functools.cached_property
    def _stack(self) -> BlockSparseStack:
        return BlockSparseStack(
            data=self.data, idx=self.idx, nblk=self.nblk, data_t=self.data_t,
            idx_t=self.idx_t, nblk_t=self.nblk_t, n_rows=self.n, n_cols=self.n, tile=self.tile,
        )

    def to(self, device) -> "TiledSupports":
        return _moved(self, device)

    def pad_to(self, n_new: int) -> "TiledSupports":
        """Grow to a rung of ``n_new`` nodes (fleet shape classes), as the
        JAX plan's ``pad_to``: the new nodes are isolated (an identity tail
        on the permutation), and block rows added once the rung crosses a
        tile boundary hold zero blocks at index 0 with no real slots
        (``nblk`` and ``nblk_t`` 0)."""
        if n_new < self.n:
            raise ValueError(f"cannot shrink a plan: n={self.n} -> {n_new}")
        if n_new == self.n:
            return self
        grow = -(-n_new // self.tile) - self.block_rows
        tail = torch.arange(self.n, n_new, dtype=self.perm.dtype, device=self.perm.device)

        def rows(a):
            pad = torch.zeros(a.shape[:2] + (grow,) + a.shape[3:], dtype=a.dtype,
                              device=a.device)
            return torch.cat([a, pad], dim=2)

        return TiledSupports(
            perm=torch.cat([self.perm, tail]), inv=torch.cat([self.inv, tail]),
            data=rows(self.data), idx=rows(self.idx), nblk=rows(self.nblk),
            data_t=rows(self.data_t), idx_t=rows(self.idx_t), nblk_t=rows(self.nblk_t),
            n=n_new, tile=self.tile,
        )

    def with_block_cols(self, c: int, c_t: int) -> "TiledSupports":
        """Widen the block-column axes to ``c`` (forward) and ``c_t``
        (transposed), as the JAX plan's ``with_block_cols``: a fleet class
        holds its members' plans at one width. The new slots are padding
        (zero blocks at index 0); ``nblk``/``nblk_t`` keep their counts."""
        if c < self.block_cols or c_t < self.data_t.shape[3]:
            raise ValueError(
                f"cannot narrow block columns: ({self.block_cols}, "
                f"{self.data_t.shape[3]}) -> ({c}, {c_t})"
            )

        def cols(a, width):
            pad = torch.zeros(a.shape[:3] + (width - a.shape[3],) + a.shape[4:],
                              dtype=a.dtype, device=a.device)
            return torch.cat([a, pad], dim=3)

        return dataclasses.replace(
            self, data=cols(self.data, c), idx=cols(self.idx, c),
            data_t=cols(self.data_t, c_t), idx_t=cols(self.idx_t, c_t),
        )

    def tile_stats(self) -> dict:
        """Occupancy accounting.

        ``blocks_kept`` counts truly-nonzero forward blocks (``nblk``'s sum);
        ``blocks_dense_equivalent`` is what a dense padded plan would
        carry (``M * K * R * R``); their ratio is the density that bounds
        the support-apply FLOP win (``flops_ratio`` uses the *stored*
        ``C / R`` — what the kernels actually execute, padding included).
        """
        r = self.block_rows
        kept = int(self.nblk.sum())
        dense_eq = self.m_graphs * self.n_supports * r * r
        return {
            "n": self.n,
            "tile": self.tile,
            "block_rows": r,
            "block_cols": self.block_cols,
            "blocks_kept": kept,
            "blocks_dense_equivalent": dense_eq,
            "density": kept / dense_eq,
            "flops_ratio": self.block_cols / r,
            "nbytes": int(self.nbytes),
            "dense_nbytes": int(self.m_graphs * self.n_supports * self.n * self.n * 4),
        }


class StackedPlans:
    """Same-shape :class:`TiledSupports` plans (a fleet shape class's grown
    members) stacked on a leading member axis, one of them selected by a
    device slot inside a step, as the JAX fleet superstep takes its
    member's plan leaf by leaf (``jnp.take`` over the member axis).

    The kernels' derived operands of each member — its row orders and, for
    each dtype in ``dtypes``, its cast blocks (``BlockSparseStack.astype``)
    — are stacked beside the plans, so a selected plan carries them and
    derives nothing on first use: inside a CUDA-graph capture a cache
    filled lazily would hold memory the capture never wrote."""

    FIELDS = ("perm", "inv", "data", "idx", "nblk", "data_t", "idx_t", "nblk_t")

    def __init__(self, plans, dtypes=()):
        plans = list(plans)
        first = plans[0]
        for p in plans:
            if (p.n, p.tile) != (first.n, first.tile) or any(
                    getattr(p, f).shape != getattr(first, f).shape for f in self.FIELDS):
                raise ValueError("stacked plans must share every shape (grow them with "
                                 "pad_to and with_block_cols first)")
        self.n, self.tile = first.n, first.tile
        stacks = [p.as_stack() for p in plans]
        self._fields = {f: torch.stack([getattr(p, f) for p in plans]) for f in self.FIELDS}
        self._fields["row_order"] = torch.stack([s.row_order for s in stacks])
        self._fields["row_order_t"] = torch.stack([s.row_order_t for s in stacks])
        self._dtypes = tuple(d for d in dtypes if d != first.data.dtype)
        for d in self._dtypes:
            casts = [s.astype(d) for s in stacks]
            self._fields[f"data {d}"] = torch.stack([c.data for c in casts])
            self._fields[f"data_t {d}"] = torch.stack([c.data_t for c in casts])

    def __len__(self) -> int:
        return self._fields["perm"].shape[0]

    def select(self, slot: torch.Tensor) -> TiledSupports:
        """The plan of the member at ``slot`` (an int ``(1,)`` tensor on
        the plans' device), with its kernel operands in place."""
        f = {k: v.index_select(0, slot)[0] for k, v in self._fields.items()}
        plan = TiledSupports(**{k: f[k] for k in self.FIELDS}, n=self.n, tile=self.tile)
        stack = plan.as_stack()
        orders = {"row_order": f["row_order"], "row_order_t": f["row_order_t"]}
        stack.__dict__.update(orders)
        casts = stack.__dict__.setdefault("_casts", {})
        for d in self._dtypes:
            casts[d] = dataclasses.replace(stack, data=f[f"data {d}"], data_t=f[f"data_t {d}"])
            casts[d].__dict__.update(orders)
        return plan


def plan_tiling(dense, tile: int = TILE) -> TiledSupports:
    """Plan one city's tiled supports from its dense ``(M, K, N, N)`` stack.

    Offline, numpy-only: RCM-style permutation over the symmetrized union
    pattern of all M x K supports (one ordering for the whole city — the
    signal permutes once, not per branch), then block condensation of
    each permuted support at one common block-column count.
    """
    dense = np.asarray(dense, dtype=np.float32)
    if dense.ndim != 4 or dense.shape[2] != dense.shape[3]:
        raise ValueError(f"supports must be dense (M, K, N, N), got {dense.shape}")
    if tile < 1:
        raise ValueError(f"tile must be >= 1, got {tile}")
    m_graphs, k, n, _ = dense.shape
    union = np.any(dense != 0.0, axis=(0, 1))
    perm = rcm_permutation(union)
    inv = np.argsort(perm).astype(np.int32)
    permuted = dense[:, :, perm][:, :, :, perm]

    fwd_scan = [[_scan_blocks(permuted[mi, ki], tile) for ki in range(k)]
                for mi in range(m_graphs)]
    bwd_scan = [[_scan_blocks(np.ascontiguousarray(permuted[mi, ki].T), tile)
                 for ki in range(k)] for mi in range(m_graphs)]

    def width(scans):
        return max(max(int(nz.sum(axis=1).max()), 1) for row in scans for _, nz in row)

    def assemble(scans, c):
        """``(data, idx, nblk)``, each stacked to ``(M, K, ...)``."""
        parts = [[_assemble_blocks(b, nz, c, tile) for b, nz in row] for row in scans]
        return tuple(torch.from_numpy(np.stack([np.stack([p[i] for p in row]) for row in parts]))
                     for i in range(3))

    data, idx, nblk = assemble(fwd_scan, width(fwd_scan))
    data_t, idx_t, nblk_t = assemble(bwd_scan, width(bwd_scan))
    return TiledSupports(
        perm=torch.from_numpy(perm), inv=torch.from_numpy(inv), data=data, idx=idx,
        nblk=nblk, data_t=data_t, idx_t=idx_t, nblk_t=nblk_t, n=n, tile=tile,
    )


def gathered_tiles_apply(branch: TiledBranchSupports, x_mat: torch.Tensor) -> torch.Tensor:
    """``out[k] = A_k @ x`` through the plain gathered-tiles contraction —
    the plain version of kernels B3/B4 on one branch, on any device.

    ``x_mat`` is the *permuted* ``(N, F)`` signal; returns ``(K, N, F)``.
    **Prepared backward**: instead of autograd's scatter-add transpose of
    the gather, the gradient runs the same gathered-tiles shape over the
    pre-transposed blocks the plan already holds: ``dx = sum_k A_k^T @
    g_k``. Gradients flow to ``x_mat`` only (the supports are constants).
    """
    stack = branch.as_stack()
    return BlockCSRApply.apply(
        x_mat, functools.partial(spmm_stack_reference, stack),
        functools.partial(spmm_stack_bwd_reference, stack, shared=True))


@dataclasses.dataclass
class ShardedTiledBranch:
    """One branch's tiled plan split along its permuted block-row axis into
    ``S`` contiguous shards (the JAX ``ShardedTiledBranch``): ``data``
    ``(S, K, r_loc, C, tile, tile)``, ``idx`` ``(S, K, r_loc, C)``
    **halo-local** (global block column ``j`` of shard ``s`` stored as ``j
    - s*r_loc + halo``, clamped into the halo-extended range for padding
    slots), ``nblk`` ``(S, K, r_loc)`` each row's real slots; the
    prepared-transpose stacks likewise at their own ``halo_t``. Numpy on
    the host (:func:`shard_tiled_plan`), tensors after :meth:`to`."""

    data: object
    idx: object
    nblk: object
    data_t: object
    idx_t: object
    nblk_t: object
    halo: int
    halo_t: int
    n: int
    tile: int

    @property
    def n_shards(self) -> int:
        return self.data.shape[0]

    @property
    def n_supports(self) -> int:
        return self.data.shape[1]

    @property
    def block_rows_local(self) -> int:
        return self.data.shape[2]

    _FIELDS = ("data", "idx", "nblk", "data_t", "idx_t", "nblk_t")

    def shard(self, index: int) -> "ShardedTiledBranch":
        """Shard ``index`` alone (what region rank ``index`` holds), its
        shard axis kept at extent 1."""
        return dataclasses.replace(
            self, **{f: getattr(self, f)[index:index + 1] for f in self._FIELDS})

    def to(self, device) -> "ShardedTiledBranch":
        def move(a):
            t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
            return t.to(device).contiguous()

        return dataclasses.replace(self, **{f: move(getattr(self, f)) for f in self._FIELDS})

    def stacks(self) -> tuple:
        """A one-shard plan as the kernels' two operands: the forward stack
        (``r_loc * tile`` rows over the ``(r_loc + 2*halo) * tile`` rows of
        the halo-extended signal) and the backward one (its transposed
        fields give ``r_loc * tile`` rows of the input gradient from the
        ``(r_loc + 2*halo_t) * tile`` rows of the halo-extended cotangent);
        made once, so their row orders are derived once."""
        return self._stacks

    @functools.cached_property
    def _stacks(self) -> tuple:
        if self.n_shards != 1:
            raise ValueError(f"ShardedTiledBranch of {self.n_shards} shards: a rank applies "
                             "its own shard (.shard(i))")
        f = {name: torch.as_tensor(getattr(self, name))[0] for name in self._FIELDS}
        r, t = self.block_rows_local, self.tile
        fwd = BlockSparseStack(**f, n_rows=r * t, n_cols=(r + 2 * self.halo) * t, tile=t)
        bwd = BlockSparseStack(**f, n_rows=(r + 2 * self.halo_t) * t, n_cols=r * t, tile=t)
        return fwd, bwd


def _block_halo(data, idx) -> int:
    """Largest block distance ``|column - row|`` over the truly nonzero
    blocks: the boundary depth a contiguous block-row shard imports
    (padding slots do not count)."""
    data, idx = np.asarray(data), np.asarray(idx)
    nz = np.any(data != 0.0, axis=(-1, -2))  # (K, R, C)
    rows = np.arange(idx.shape[1], dtype=np.int64)[None, :, None]
    dist = np.abs(idx.astype(np.int64) - rows)
    return int(dist[nz].max(initial=0))


def shard_tiled_plan(branch: TiledBranchSupports, n_shards: int) -> ShardedTiledBranch:
    """Split one branch's tiled plan into ``n_shards`` contiguous block-row
    shards with halo-local column indices (host numpy, as
    :func:`plan_tiling`; the JAX ``shard_tiled_plan``). Raises when the
    block rows do not divide into ``n_shards`` (``pad_to`` a divisible
    rung first) or when the plan's block bandwidth exceeds a shard's block
    rows (the ring exchange reaches the adjacent shards only)."""
    data, idx, nblk = (np.asarray(getattr(branch, f)) for f in ("data", "idx", "nblk"))
    data_t, idx_t, nblk_t = (np.asarray(getattr(branch, f))
                             for f in ("data_t", "idx_t", "nblk_t"))
    r = idx.shape[1]
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if r % n_shards:
        raise ValueError(f"{r} block rows not divisible by n_shards={n_shards} — "
                         "pad_to a divisible rung first")
    r_loc = r // n_shards
    # halo_exchange needs 1 <= halo <= r_loc
    halo = max(_block_halo(data, idx), 1)
    halo_t = max(_block_halo(data_t, idx_t), 1)
    over = max(halo, halo_t)
    if over > r_loc:
        raise ValueError(
            f"block bandwidth {over} exceeds the {r_loc} block rows per shard at "
            f"n_shards={n_shards} — the ring halo exchange only reaches adjacent shards; "
            "use fewer shards or a larger tile")

    def split(d, i, c, h):
        rows = [slice(s * r_loc, (s + 1) * r_loc) for s in range(n_shards)]
        ds = np.stack([d[:, sl] for sl in rows])
        loc = np.stack([i[:, sl].astype(np.int64) - s * r_loc + h for s, sl in enumerate(rows)])
        return ds, np.clip(loc, 0, r_loc + 2 * h - 1).astype(np.int32), np.stack(
            [c[:, sl] for sl in rows])

    data_s, idx_s, nblk_s = split(data, idx, nblk, halo)
    data_ts, idx_ts, nblk_ts = split(data_t, idx_t, nblk_t, halo_t)
    return ShardedTiledBranch(data=data_s, idx=idx_s, nblk=nblk_s, data_t=data_ts,
                              idx_t=idx_ts, nblk_t=nblk_ts, halo=halo, halo_t=halo_t,
                              n=branch.n, tile=branch.tile)


class ShardedTilesApply(torch.autograd.Function):
    """A rank's shard of :func:`sharded_gathered_tiles_apply`: forward, the
    signal's boundary blocks exchanged with the ring neighbours, then B3
    over the halo-local forward stack; backward, the cotangent's boundary
    blocks exchanged at ``halo_t``, then B4 over the halo-local transposed
    stack."""

    @staticmethod
    def forward(ctx, x_loc: torch.Tensor, sharded: ShardedTiledBranch, mesh, axis: str):
        from stmgcn_tpu_torch.parallel.halo import halo_exchange

        fwd, bwd = sharded.stacks()
        ctx.bwd, ctx.halo_t, ctx.mesh, ctx.axis = bwd, sharded.halo_t, mesh, axis
        ctx.dtype, t = x_loc.dtype, sharded.tile
        r, f = sharded.block_rows_local, x_loc.shape[-1]
        blocks = halo_exchange(x_loc.reshape(r, t, f), sharded.halo, mesh, axis)
        return stack_forward(fwd.astype(x_loc.dtype), blocks.reshape(-1, f).contiguous())

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        from stmgcn_tpu_torch.parallel.halo import halo_exchange

        bwd, t = ctx.bwd, ctx.bwd.tile
        k, rows, f = grad.shape
        # block rows lead for the exchange: (r_loc, K, t, F)
        g = grad.to(ctx.dtype).reshape(k, rows // t, t, f).transpose(0, 1)
        g = halo_exchange(g.contiguous(), ctx.halo_t, ctx.mesh, ctx.axis)
        g = g.transpose(0, 1).reshape(k, -1, f).contiguous()
        dx = spmm_stack_bwd(bwd.astype(ctx.dtype), g, shared=True)
        return dx.to(ctx.dtype), None, None, None


def sharded_gathered_tiles_apply(sharded: ShardedTiledBranch, x_loc: torch.Tensor, mesh,
                                 axis: str = "region") -> torch.Tensor:
    """This rank's shard of the JAX ``sharded_gathered_tiles_apply``:
    ``sharded`` the rank's one shard (:meth:`ShardedTiledBranch.shard`),
    ``x_loc`` its ``(r_loc * tile, F)`` rows of the *permuted* signal
    (zero-padded past ``n`` to the plan's block rows); returns ``(K, r_loc
    * tile, F)`` float32. No node-axis gather: each rank exchanges
    ``halo`` boundary blocks with its ring neighbours (``halo_t`` for the
    gradient), and its product is one launch of B3 (the gradient one of
    B4) over the halo-local stacks on CUDA tensors, their plain versions on
    CPU ones. Every rank of the line calls it together; ``mesh`` None is
    one device (zero halos)."""
    r, t = sharded.block_rows_local, sharded.tile
    if x_loc.dim() != 2 or x_loc.shape[0] != r * t:
        raise ValueError(f"x_loc must be ({r * t}, F) (the shard's {r} block rows of "
                         f"{t}), got {tuple(x_loc.shape)}")
    return ShardedTilesApply.apply(x_loc.contiguous(), sharded, mesh, axis)
