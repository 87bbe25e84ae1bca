"""Which slice of each array a rank holds on a ``(dp, region, branch)``
mesh.

Counterpart of ``stmgcn_tpu/parallel/placement.py``. The JAX package
places every array with a ``NamedSharding`` and GSPMD slices it; here
each rank is a process of its own and keeps only its slice, by the same
array kinds (``placement.py:1-44`` of the JAX package):

- ``state`` (parameters, optimizer moments; a ``state_dict``-keyed dict):
  replicated, except that leaves of the branch-stacked ``branches`` module
  are sliced on their leading M axis by the rank's ``branch`` coordinate
  (the JAX ``P('branch', ...)``);
- ``supports``: a dense ``(M, K, N, N)`` stack, a branch-stacked form
  (:class:`~stmgcn_tpu_torch.parallel.banded.BandedSupports` or
  :class:`~stmgcn_tpu_torch.parallel.sparse.ShardedBlockSparse` with a
  leading M axis), or a tuple of M per-branch forms: sliced on M by the
  branch coordinate (``P('branch', ...)``); on a region mesh each dense
  stack keeps the rank's output-node rows, ``(..., K, N_local, N)``
  (``P(None, None, 'region', None)``), and each strip form the rank's one
  shard (its shard axis over ``region``). A rank's one-branch block-CSR
  strips merge into one branch-stacked strip
  (:func:`~stmgcn_tpu_torch.parallel.sparse.merge_branches`), so its
  branches take one kernel launch;
- ``x``, ``y``, ``mask``: split contiguously on the batch axis over
  ``dp``, as ``P('dp')`` splits (rank ``i`` of the ``dp`` axis holds rows
  ``[i * B/dp, (i + 1) * B/dp)``); ``index`` ``(B,)`` likewise, and
  ``index``/``mask_block`` ``(S, B)`` blocks on their second axis; on a
  region mesh the node axis of ``x`` ``(B, T, N, C)`` and ``y`` ``(B, N, C)``
  / ``(B, H, N, C)`` is split over ``region`` too, contiguously as the
  batch is (rank ``j`` of the region axis holds nodes ``[j * N/region, (j
  + 1) * N/region)``); a ``(B, N)`` mask keeps its batch rows and all
  nodes (the loss reads the whole mask's count);
- ``series`` ``(T, N, C)``: its node rows over ``region`` (whole without
  one); ``replicated``: whole on every rank.

:meth:`MeshPlacement.check_divisibility` raises with the JAX messages.
"""

from __future__ import annotations

from stmgcn_tpu_torch.parallel.manifest import CollectiveDecl

__all__ = ["AGREED_FLAGS", "BRANCH_FUSION", "CHECKPOINT_AGREEMENT", "DP_GRAD_SYNC",
           "GSPMD_REGION", "HALO_EXCHANGE", "MeshPlacement", "sharded_names"]

#: collective signature of the data-parallel placement: gradients (one
#: bucket a step) and the step's loss summed over ``dp`` — the
#: plan-defining op of every ``dp > 1`` training step
DP_GRAD_SYNC = (
    CollectiveDecl("all-reduce", "dp", required=True,
                   reason="gradient + loss-mean psum over the batch axis"),
)

#: collective signature of dense region sharding: each graph conv's
#: node-axis contraction all-gathers the signal over ``region``
GSPMD_REGION = (
    CollectiveDecl("all-gather", "region", required=True,
                   reason="node-axis signal gather in the dense graph convs"),
)

#: collective signature of branch model parallelism: the branch-fusion
#: sum (and the global clip norm's squares) is an ``all-reduce`` over
#: ``branch``
BRANCH_FUSION = (
    CollectiveDecl("all-reduce", "branch", required=True,
                   reason="branch-fusion psum / replicated-param grad sync"),
)

#: collective signature of the halo plan: boundary rows ride a permute
#: over the ring (``stmgcn_tpu/parallel/banded.py``)
HALO_EXCHANGE = (
    CollectiveDecl("collective-permute", "region", required=True,
                   reason="±1 ring halo exchange of boundary signal rows "
                   "(halo_exchange) — the op that replaces GSPMD's full "
                   "node-axis gather"),
)

#: collective signature of the trainer's agreed decisions: the sanitizers'
#: flag words (``train.checks``) and ``debug_nans``' finite flags, a word's
#: bits or a flag summed over every rank, so that every rank raises at one
#: step (and the divergence guard's flag, outside a step's program) —
#: declared only when one of them is on
AGREED_FLAGS = (
    CollectiveDecl("all-reduce", "world", required=False,
                   reason="a flag (or a flag word's bits) summed over every rank: one "
                   "decision on every rank"),
)

#: collective signature of a checkpoint read or write on a mesh: the lead's
#: outcome (a read's file or a write's status byte, or its error)
#: broadcast to every rank as its length, then its bytes, so that a failure
#: raises on every rank (``Trainer._lead_read``, ``Trainer._agree_write``);
#: one agreement per read, synchronous write or asynchronous flush
CHECKPOINT_AGREEMENT = (
    CollectiveDecl("broadcast", "world", required=True, max_count=2,
                   reason="the lead's checkpoint outcome (length, then bytes) on every "
                   "rank: one read, write or flush agreed"),
)

#: the parameters of the branch-stacked module (``STMGCN.branches``)
BRANCH_PREFIX = "branches."


class MeshPlacement:
    """This rank's slices of arrays by kind; the Trainer's ``placement``."""

    KINDS = ("supports", "x", "y", "mask", "state", "series", "index", "mask_block",
             "replicated")

    def __init__(self, mesh):
        self.mesh = mesh

    @property
    def dp(self) -> int:
        return self.mesh.dp

    @property
    def branch(self) -> int:
        return self.mesh.branch

    @property
    def region(self) -> int:
        return self.mesh.region

    def nodes(self, n_nodes: int) -> slice:
        """The node rows this rank holds: its ``region`` coordinate's
        contiguous ``n_nodes / region``."""
        if n_nodes % self.region:
            raise ValueError(f"n_nodes {n_nodes} not divisible by region={self.region}")
        n = n_nodes // self.region
        j = self.mesh.coords["region"]
        return slice(j * n, (j + 1) * n)

    def rows(self, batch_size: int) -> slice:
        """The batch rows this rank holds: its ``dp`` coordinate's
        contiguous ``batch_size / dp``."""
        if batch_size % self.dp:
            raise ValueError(f"batch_size {batch_size} not divisible by dp={self.dp}")
        n = batch_size // self.dp
        i = self.mesh.coords["dp"]
        return slice(i * n, (i + 1) * n)

    def branches(self, m_graphs: int) -> slice:
        """The stacked branches this rank holds: its ``branch``
        coordinate's contiguous ``m_graphs / branch``."""
        if m_graphs % self.branch:
            raise ValueError(f"m_graphs {m_graphs} not divisible by branch={self.branch}")
        n = m_graphs // self.branch
        i = self.mesh.coords["branch"]
        return slice(i * n, (i + 1) * n)

    def put(self, value, kind: str):
        """This rank's slice of ``value`` of array ``kind`` (a tensor or
        numpy array; a dict of them for ``state``; a tensor or a tuple of
        per-branch forms for ``supports``)."""
        if kind not in self.KINDS:
            raise ValueError(f"unknown array kind {kind!r}; known: {sorted(self.KINDS)}")
        if kind == "replicated":
            return value
        if kind == "series":
            return value[:, self.nodes(value.shape[1])] if self.region > 1 else value
        if kind == "state":
            return self.state_slice(value)
        if kind == "supports":
            return self._supports(value)
        if kind in ("index", "mask_block") and value.ndim == 2:
            return value[:, self.rows(value.shape[1])]
        value = value[self.rows(value.shape[0])]
        if self.region > 1 and kind in ("x", "y"):
            axis = value.ndim - 2  # the node axis of (B, T, N, C), (B, N, C), (B, H, N, C)
            index = [slice(None)] * value.ndim
            index[axis] = self.nodes(value.shape[axis])
            value = value[tuple(index)]
        return value

    def _supports(self, value):
        """This rank's supports: its branches of a stacked form or of a
        tuple of per-branch forms, then its node rows of each."""
        from stmgcn_tpu_torch.parallel.banded import BandedSupports
        from stmgcn_tpu_torch.parallel.sparse import ShardedBlockSparse, merge_branches

        if isinstance(value, (tuple, list)):
            forms = tuple(value[self.branches(len(value))]) if self.branch > 1 else tuple(value)
            placed = tuple(self._rows(v) for v in forms)
            if placed and all(isinstance(p, ShardedBlockSparse) for p in placed):
                return merge_branches(placed)  # every branch in one launch
            return placed
        if self.branch > 1:
            if isinstance(value, (BandedSupports, ShardedBlockSparse)):
                if value.branch_stacked:
                    lead = value.strips if isinstance(value, BandedSupports) else value.data
                    value = value.branch(self.branches(lead.shape[0]))
            elif hasattr(value, "shape"):  # a stack on its leading M axis
                value = value[self.branches(value.shape[0])]
        return self._rows(value)

    def _rows(self, value):
        """This rank's node rows of one support form: a dense stack's row
        strip, a strip form's own shard (a block-CSR one at ``region ==
        1`` too: its one shard)."""
        from stmgcn_tpu_torch.parallel.banded import BandedSupports
        from stmgcn_tpu_torch.parallel.sparse import ShardedBlockSparse

        if isinstance(value, (BandedSupports, ShardedBlockSparse)):
            if value.n_shards != self.region:
                raise ValueError(f"{type(value).__name__} of {value.n_shards} shards on a mesh "
                                 f"of region={self.region}")
            return value.shard(self.mesh.coords["region"])
        if self.region == 1:
            return value
        if not hasattr(value, "shape") or value.ndim not in (3, 4):
            raise ValueError("supports on a region mesh must be dense (M, K, N, N) or (K, N, "
                             "N) stacks, BandedSupports or ShardedBlockSparse strips; got "
                             f"{type(value).__name__}")
        return value[..., self.nodes(value.shape[-2]), :]

    def state_slice(self, state: dict) -> dict:
        """A mesh-free ``state_dict``'s slice on this rank: the branch
        parameters' leading M axis cut by the branch coordinate."""
        if self.branch == 1:
            return dict(state)
        return {k: (v[self.branches(v.shape[0])] if k.startswith(BRANCH_PREFIX) else v)
                for k, v in state.items()}

    def state_gather(self, state: dict, what: str = "state") -> dict:
        """The inverse of :meth:`state_slice`: the branch parameters'
        slices all-gathered over ``branch`` (every rank calls it), the rest
        as they are: the mesh-free layout checkpoints hold."""
        if self.branch == 1:
            return dict(state)
        from stmgcn_tpu_torch.utils import comm

        return {k: (comm.all_gather(v.detach(), "branch", self.mesh, what=what)
                    if k.startswith(BRANCH_PREFIX) else v) for k, v in state.items()}

    def check_divisibility(self, batch_size: int, n_nodes: int,
                           m_graphs: int | None = None) -> None:
        dp, region, branch = self.mesh.dp, self.mesh.region, self.mesh.branch
        if batch_size % dp:
            raise ValueError(f"batch_size {batch_size} not divisible by dp={dp}")
        if n_nodes % region:
            raise ValueError(f"n_nodes {n_nodes} not divisible by region={region}")
        if branch > 1 and m_graphs is not None and m_graphs % branch:
            raise ValueError(f"m_graphs {m_graphs} not divisible by branch={branch}")


def sharded_names(names, branch: int) -> list:
    """Which of ``names`` (``state_dict`` keys) are branch-sliced on a mesh
    with ``branch`` ranks on that axis."""
    return [branch > 1 and n.startswith(BRANCH_PREFIX) for n in names]
